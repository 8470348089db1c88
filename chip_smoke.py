#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and no phase's error is
caught:

  1. device   -- require CUDA, print the card's name and power limit;
  2. build    -- compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. kernels  -- hold each kernel against its plain PyTorch version and time
                 it (device time per call: ``graph_ms``, CUDA-graph replays;
                 eager time beside it): ``int8_matmul`` (every variant that
                 takes a shape, bit-equal, at the main path's shapes and at
                 ``INT8_RAGGED``; beside its dp4a variant and ``torch._int_mm``,
                 cold L2 at the decode and LM-head rows); ``grouped_matmul``
                 int8 and W4A8 in every variant (mma, stream, dp4a), bit-equal
                 at the M3ViT-S and OLMoE-1B-7B decode / prefill shapes and at
                 ``GROUPED_RAGGED``, timed in the chosen variant beside dp4a
                 (cold L2 at decode); the f32 mode in every variant (mma,
                 stream: 3xTF32, bit-equal to each other; fma: the first
                 port's tiles) within atol = rtol = 1e-5 at the M3ViT-S and
                 OLMoE calibration, decode and prefill shapes and at
                 ``GROUPED_RAGGED``, timed in the chosen variant beside fma
                 (cold L2 at decode) and bounded at the f32 FMA and the
                 3xTF32 rates; each timed call alone one device kernel;
                 ``streaming_attention`` with ``lm_attention`` on the
                 same vision inputs; every LM mode of ``lm_attention`` at the
                 OLMoE-1B-7B shapes, at head dims 112 and 100, and at hd 256
                 (gemma2-2b's decode over bf16 and int8 caches of 512 rows
                 and over a wrapped 4096-row ring, its f32 prefill with the
                 window, of 4160 tokens where it masks, its int8 ring
                 prefill; gemma-7b's decode and prefill beside SDPA) and 192
                 (nemotron's), at phase 12's path shapes (zamba2-7b's f32
                 prefill of 4 x 512 over its 576-row cache and a decode row,
                 hd 112; seamless-m4t-medium's non-causal encoder over 4 x
                 1024 frames, its cross-attention of a 16-token prompt and of
                 a decode row over the memory, Sq != Sk, and its decoder's
                 causal self-attention at prefill and decode, hd 64), each
                 hd <= 128 row's time printed beside
                 ``PERF_MD_LM_ATTENTION_MS``
                 (exact-score inputs within 1e-5; with Gaussian q the
                 ``quant_bits=0`` rows within ``GAUSSIAN_QB0_TOL``, the
                 ``quant_bits=4`` rows no more rows over 1e-4 than
                 ``PARENT_GAUSSIAN_OVER``; at the decode shapes the tile
                 schedule bit-equal to the decode schedule; a call alone one
                 device kernel; ``scaled_dot_product_attention`` timed
                 beside each ``quant_bits=0`` row, the fp admission's
                 ``packed_prefill_f32`` beside SDPA with its block-diagonal
                 causal mask); the vision case of
                 ``streaming_attention`` (its Gaussian rows over 1e-4 no more
                 than ``PARENT_VISION_GAUSSIAN_OVER``) at M3ViT-S and at
                 ``VISION_EDGES``; ``selective_scan`` at the
                 falcon-mamba-7b prefill shapes ``SCAN_PATH`` (groups of 1,
                 4 and 8 prompts of 256 tokens, each taking one of
                 ``scan_layout``'s layouts; bf16 too), at ``SCAN_SHAPES``
                 (N 4..64, bf16 operands), in every layout of the states
                 variant forced and at ``SCAN_WIDE`` (h_last bit-equal, f32
                 y within atol = rtol = 1e-5), timed at B 1, 4 and 8 beside
                 the first port's lane variant and its plain version, and
                 each layout timed for B 1..8 beside ``scan_layout``'s
                 pick; ``rmsnorm`` at the OLMoE and
                 falcon-mamba widths (rows alone bit-equal to the same rows
                 among more), timed beside ``F.rms_norm``;
  4. serving  -- full-width M3ViT-S (``configs/moe_vit.py:CONFIG``): seeded fp
                 init on the card, calibration on 2 batches of 2, PTQ to the
                 int8 tree, ``VisionEngine(buckets=(1, 4, 8))``, its three
                 programs captured as CUDA graphs by ``warmup()`` (capture
                 time and graph pool printed; each graph's kernel nodes by
                 family equal to the launches its capture counted and to one
                 forward's), serving 24 requests; every kernel's launch
                 count must grow by exactly its per-forward count times the
                 dispatched batches (replays add what their capture
                 counted), every int8_matmul and integer grouped_matmul call
                 go through variant 1 or 2, ``retraces`` stays 0, and the
                 same 24 requests in batches of 8 give the
                 ``aot_warmup=False`` engine's classes and probabilities bit
                 for bit;
  5. e2e      -- one batch of 4 through ``forward`` on the card and on a CPU
                 copy of the same tree (plain versions): free-running logits
                 printed, then every block and the head teacher-forced from
                 the card's input and gated;
  6. profile  -- one int8 forward at B=8, then one dispatch of 8 images
                 through the eager engine's program and the graph engine's:
                 wall and enqueue time, device time of every kernel launched
                 (torch.profiler, which sees the kernels of a replayed
                 graph), busy share; exactly one device kernel per
                 int8_matmul, grouped_matmul and attention call (here and in
                 phases 7 and 8);
  7. lm       -- full-width OLMoE-1B-7B (``configs/olmoe_1b_7b.py``): seeded
                 fp init on the card, calibration on 2 batches of 2 x 32
                 tokens, PTQ to the int8 tree and to the W4A8 tree. The fp
                 tree is first served as ``launch/serve.py`` serves it
                 without ``--quantized`` (``_serve_lm_fp``: f32 weights,
                 bf16 K/V cache, ``quant_bits=0``, the same engine, programs
                 and requests as below): launches 0 / 32 / 16 / 65 a
                 forward, the grouped calls all f32 (stream in a tick, mma
                 in an admission), ``retraces`` 0, every request completes,
                 every step teacher-forced against ``prefill``: the served
                 engine (bf16 cache) within ``LM_FP_TF_LIMITS``, the same
                 engine with an f32 cache every token within
                 ``LM_FP_TF_TOL`` of the argmax; the ``aot_warmup=False``
                 engine bit-equal; its tick and
                 admission profiled as below; then the fp tree and its
                 engines are freed. Each quantized tree is served by
                 ``ServeEngine(batch_slots=8, max_len=512)``, its decode
                 tick and 20 packed admissions (5 buckets x 4 prompt counts)
                 captured as CUDA graphs by ``warmup()`` (gated as in phase
                 4), 16 seeded requests of 16-256 prompt tokens and 32 new
                 tokens. Gates: launches grow by exactly 81 / 32 / 16 / 65
                 (int8_matmul / grouped / lm_attention / rmsnorm) per packed
                 admission and per decode tick, every int8_matmul and
                 grouped_matmul call on variant 1 (mma) or 2 (stream),
                 ``retraces`` 0; every request completes; every request's
                 step-0 logits bit-equal to ``prefill`` of its prompt alone;
                 teacher-forced, the engine's logits of every request at 9
                 of its 32 steps match ``prefill`` over the same prefix
                 within ``LM_TF_LIMITS``; ``_first_pack_dependence`` finds
                 no op whose rows differ between a pack and a prefill alone;
                 the same requests served again, and served by the
                 ``aot_warmup=False`` engine, give bit-equal tokens and
                 logits; the expert combine of 8 tokens equals theirs among
                 512, and so does the RMSNorm of 8 rows. Printed: the worst
                 request served alone. Then one decode tick and one
                 512-token packed admission are profiled, eager and as graph
                 replays;
  8. ssm      -- the OLMoE trees and engines freed (at most 1 GB of the
                 earlier phases may stay allocated), full-width falcon-mamba-7b
                 (``configs/falcon_mamba_7b.py``, seeded f32 init on the card,
                 28 GB) served by
                 ``ServeEngine(batch_slots=8, max_len=512)`` through the grouped
                 same-length admission path: 16 seeded requests with prompts
                 of 64, 128 or 256 tokens and 32 new tokens. Gates: the scan
                 launches exactly 64 times per grouped prefill dispatch and
                 never in a decode tick, RMSNorm 65 times a forward, no other
                 kernel is launched, every
                 request completes, and the engine's logits at every step of
                 every request match ``forward`` over the same prefix within
                 ``SSM_TF_LIMIT``, the ``aot_warmup=False`` engine serves
                 bit-equal tokens and logits, and the first wave served
                 again with TF32 matmuls or with a bf16 conv history fails
                 that gate. The decode tick is a captured graph (its
                 per-length prefill stays eager; ``retraces`` 0). One decode
                 tick, eager and as a graph replay, and one grouped prefill
                 of 8 x 256 tokens are profiled.
  9. cluster  -- ``ServingCluster`` over the engines above, both replicas on
                 the one card sharing one copy of the weights (``data_ptr``
                 equal; each replica its own cache, graph pool and capture
                 stream), run in two parts while the full-width trees are
                 alive. Vision, after phase 6: two M3ViT-S int8
                 ``VisionEngine`` replicas (buckets 1, 4, 8), warmed by
                 ``cluster.warmup()`` (every program a captured graph),
                 a burst of 48 seeded requests pumped with ``step()``
                 while any is queued or in flight, then ``flush()``; gates: each request delivered once (``on_done``),
                 completed, its top-5 classes equal to the phase-4 engine's
                 on the same burst and its probabilities within
                 ``CLUSTER_VISION_PROB_TOL``, both replicas served,
                 ``retraces`` 0, launches per batch exact. LM, after phase 7:
                 two OLMoE-1B-7B int8 ``ServeEngine`` replicas and one
                 standby (8 slots, max_len 512) on phase 7's 16 requests,
                 a clean run (tokens of every request identical to phase 7's
                 engine, no eviction, both replicas served, launches per
                 forward exact) and a chaos run (``FaultConfig(inject=True,
                 kill_schedule=((1, CLUSTER_KILL_STEP, "dead"),))``, a kill
                 mid-decode: exactly one ``replica_evicted``, the standby
                 promoted, ``cluster_redispatched`` >= 1, every ``on_done``
                 once with status ``completed``, every request's tokens,
                 re-dispatched ones included, identical to phase 7's).
                 Printed beside the card's name and power limit: capture
                 time and graph pool per replica, the cluster's frames/s and
                 tokens/s against the single engine's, the host time of a
                 cluster ``step()`` outside the replicas, and the time from
                 eviction to backfill and to the last re-dispatched
                 completion.
 obs.  observe -- serving observability, at full width on the trees above
                 (``phase_observe_vision`` after phase 9's vision part,
                 ``phase_observe_lm`` after its LM part). A second engine
                 with ``trace.enable`` (graphs on, annotations off): on
                 phase 4's M3ViT-S int8 tree, 29 requests in batches of 8,
                 8, 8, 4 and 1 beside phase 4's engine on the same batches
                 (classes and probabilities bit-equal); on phase 7's
                 OLMoE-1B-7B int8 tree, phase 7's 16 requests (tokens
                 identical to phase 7's untraced engine). Each: launches per
                 forward exact, ``retraces`` 0, every request's timeline
                 valid with its service phases summing to its latency,
                 nothing dropped, the Chrome trace written to
                 ``build/observe/`` and valid, a cost row for every program
                 and every served program's ``mfu``, ``hbm_util`` and
                 ``roofline_frac`` in (0, ``OBSERVE_RATIO_MAX``] against
                 the H100's peaks, the memory row read from the device
                 (params <= watermark <= limit), ``/metrics`` on
                 127.0.0.1 with every program's step histogram and
                 ``/healthz`` ok; the OLMoE decode tick's and M3ViT-S
                 ``classify|b=8``'s step p50 (CUDA events the graph
                 records at its first and last node) at least 0.98x a
                 profiled replay's kernel time and at most 1.15x its
                 device span (``OBSERVE_TICK_RATIO``,
                 ``_check_step_time``). Then one eager
                 OLMoE step with ``annotate_kernels``: its
                 ``record_function`` ranges per wrapper equal the
                 wrapper's launches. Printed: traced vs untraced tok/s and
                 the program rows;
 ep.   expert_parallel -- expert parallelism at full width over an EP mesh
                 whose slots all name ``cuda:0`` (``launch/mesh.py``,
                 ``distributed/expert_parallel.py``). The grouped kernel at
                 a slot's shapes (E/n experts, worst-case capacity, the
                 padding rows in the last group), every variant bit-equal to
                 the plain version, timed (``_ep_grouped_rows``). Vision
                 (``phase_ep_vision``, after the vision observe phase):
                 ``VisionEngine``s over 4 and 16 slots on phase 4's tree
                 serve phase 4's 24 requests: classes, probabilities and
                 ``expert_tokens`` bit-equal to phase 4's engine,
                 ``retraces`` 0, launches a batch exact (grouped n x 12),
                 graph nodes equal, every per-slot weight operand 16 / n
                 experts; a dispatch of 8 profiled at 1, 4 and 16 slots.
                 GShard (``phase_ep_gshard``, in phase 7 while the fp tree
                 lives): eager 512-token forwards through
                 ``impl="gshard"``, TF32 off: at ``capacity_factor`` 4.0
                 every expert keeps min(load, capacity) slots; at capacity
                 = 512 none drops and the logits are within
                 ``EP_GSHARD_REL`` of the grouped path's. LM (``phase_ep_lm``, after the LM observe
                 phase) on phase 7's int8 tree: a ``ServeEngine`` over 4
                 slots (packed path, graphs) on phase 7's 16 requests:
                 tokens identical to phase 7's, teacher-forced logits
                 bit-equal to the single path's ``prefill``, launches a
                 forward exact (grouped 4 x 32), ``retraces`` 0, per-slot
                 operands of 16 experts; the tick and the 512-token
                 admission profiled at 1 (phase 7), 2 and 4 slots; one
                 eager W4A8 forward at 2 slots bit-equal to the single path;
                 ``ServingCluster(devices=["cuda:0"] * 8, standby=1)``: one
                 replica over 4 slots and a standby over 4 more, the same
                 tokens, every request delivered once, an eviction
                 backfilled (the watchdog's step times and their margin to
                 the stall rule printed); an engine over ``cuda:0`` and
                 ``cuda:1`` refused (``NotImplementedError``). Printed: device
                 time, kernels and tok/s a step by slot count, the
                 allocator's peak during each part;
 tune. autotune -- the kernel autotuner (``kernels/autotune.py``) at full
                 width, in three parts, each on a table in a fresh temporary
                 directory; before the LM observe phase no part uses the
                 profiler (that phase's step-time gate reads a profiled
                 replay's span, which moves with the profiler's history).
                 Vision (``phase_autotune_vision``, after the EP vision
                 phase) on phase 4's M3ViT-S int8 tree, a tuned
                 ``VisionEngine``, a second on the same table and a third
                 from the table reloaded from disk, each serving phase 4's
                 24 requests. LM: a tuned packed engine over the fp tree
                 right after phase 7's fp serve, while the tree lives; at
                 the end of phase 7 (after its EP part) tuned engines over
                 the int8 and W4A8 trees, an ``aot_warmup=False`` int8
                 engine on the same table and one from the reloaded table,
                 and an engine over 4 EP slots on the int8 tree. Dense, at
                 the end of phase 10, tuned
                 grouped-path engines over the gemma2-2b fp and int8 trees
                 (the hd-256 decode keys meet ``decode`` against ``tile``),
                 and the int8 tree's second engine and reloaded table.
                 Every sweep holds each candidate to the rule's pick's bits.
                 Gates: each tuned engine's classes and probabilities, or
                 tokens, equal to the untuned engine's of its phase;
                 launches a forward exact; every program a graph whose
                 nodes equal its launches; ``retraces`` 0; the tables'
                 ``misses`` and ``untakeable`` 0; the second engine and the
                 reloaded table sweep nothing and the reloaded entries
                 equal the saved ones; no sweep inside a graph capture.
                 Printed: every key's candidates' device ms, the rule's and
                 the tuned pick, the keys where they differ, each part's
                 sweep time, and the steps (dispatch of 8, tick, 512-token
                 admission) tuned beside untuned: graph replays timed by
                 their own events (``_replay_ms``) for the vision and fp
                 parts, profiled (``_profile``) after the observe phase;
 10. dense   -- the falcon-mamba tree freed, full-width gemma2-2b
                 (``configs/gemma2_2b.py``: 26 layers in 13 local(4096) /
                 global pairs, 8 heads of 256 over 4 KV heads, softcaps,
                 sandwich norms, tied 256k embedding; seeded f32 init,
                 10.46 GB), calibrated on 2 batches of 2 x 32 tokens and
                 PTQ'd to the int8 tree. (a) The fp tree served as
                 ``launch/serve.py`` serves it (bf16 K/V, the local layers'
                 in a ring, ``quant_bits=0``; 8 slots, max_len 512, phase
                 7's 16 requests) through the grouped admission path (a
                 ring takes no packed prefill) and the captured tick:
                 exactly 0 / 26 / 105 launches (int8_matmul / lm_attention
                 / rmsnorm) a prefill and a tick, graph nodes equal,
                 ``retraces`` 0, the ``aot_warmup=False`` engine's tokens
                 and logits bit-equal, teacher-forced against ``prefill``
                 within ``DENSE_FP_TF_LIMITS``, and an f32-cache control
                 within ``DENSE_TF_TOL`` at every step. (b) The int8 tree
                 (int8 ring cache, 4-bit attention): 156 / 26 / 105, every
                 int8_matmul on variant 1 or 2, every token prefill's argmax
                 over its prefix. (c) The ring wrapping: an f32-cache
                 engine of 2 slots over 4608 rows (ring 4096), prompts of
                 4100 (wraps in the prefill's roll) and 4060 (wraps in
                 decode) tokens, 64 new each, every step within
                 ``DENSE_TF_TOL`` of one teacher-forced pass over the whole
                 sequence. (d) One fp and one int8 tick (8 slots at fill
                 300) profiled as graph replays beside the fp tick's byte
                 bound.
 12. families -- after phase 10, before phase 11: the gemma2 trees freed,
                 the model families the reference drives through their model
                 API alone (its engine serves neither), at full width with
                 seeded f32 weights on the card, each freed before the next.
                 zamba2-7b (``configs/zamba2_7b.py``: 81 Mamba-2 layers, one
                 shared attention block after every 6th, 13 applications,
                 27 GB): 4 prompts of 512 tokens, ``prefill`` into 576 rows,
                 32 greedy ``decode_step``s at a scalar index; exactly 13
                 ``lm_attention`` and 108 ``rmsnorm`` launches a prefill, a
                 decode step and a forward. seamless-m4t-medium
                 (``configs/seamless_m4t_medium.py``: 12 + 12 layers,
                 LayerNorm, 3.5 GB): 4 utterances of 1024 Gaussian frames,
                 decoder prompts of 16 tokens, ``prefill`` into 48 rows, 32
                 greedy decode steps; 36 ``lm_attention`` launches a prefill
                 and a forward, 24 a decode step. Gates, each model: every
                 emitted token's logit within ``LM_FP_TF_TOL`` of the
                 argmax of one teacher-forced ``forward`` over the prompt
                 and the tokens before it (the median and p90 relative logit
                 error printed); the attention launches of the runs tallied
                 by phase-3 row, every row launched. seamless, calibrated on
                 2 batches of 2 utterances: the fold-only PTQ tree's logits
                 within ``FOLD_REL_TOL`` of std(logits) of the fp tree's.
                 One decode step and the prefill of each profiled, eager:
                 device time, top kernels, one device kernel a gated call.
 11. train   -- last, after every serving phase, so it cannot move their
                 gates, and under ``torch.use_deterministic_algorithms(True)``
                 (``train.trainer.deterministic_mode``). (a) Full-width
                 M3ViT-S, seeded fp params, one pipeline batch of 64: step-0
                 loss and gradients with the kernels and again with their
                 plain versions on the card (``_plain_kernels``), and the
                 plain ones again at ``TRAIN_CONTROLS`` copies of the params
                 perturbed by ``TRAIN_CONTROL_EPS`` (the step-0 gradient's
                 own conditioning): the loss and every leaf within the larger
                 of ``TRAIN_LOSS_REL`` / ``TRAIN_GRAD_REL`` and
                 ``TRAIN_CONTROL_FACTOR`` times the controls' (the k bias,
                 zero in exact arithmetic, under ``TRAIN_NOISE`` of the
                 global norm on both sides), every leaf with a nonzero plain
                 gradient nonzero with the kernels; the worst leaves
                 printed. (b) ``Trainer``
                 through ``launch/train.py``'s ``main``: 40 steps at batch 64,
                 lr ``TRAIN_LR``, the default 10 warm-up steps; the mean loss
                 of the last 5 steps at least ``TRAIN_LOSS_DROP`` below the
                 first 5's; step device time, images/s, peak memory and the
                 launches a step printed. (c) Two runs of 3 steps from one
                 state bit-equal; 10 steps straight bit-equal in every param
                 and optimizer leaf to 5, a checkpoint, a fresh ``Trainer``
                 restoring it and 5 more; a preemption requested at step 3
                 drains at step 4 with a checkpoint. (d) Full-width
                 OLMoE-1B-7B at 2 layers, batch 4 x 256 through
                 ``impl="gshard"``: (a)'s gates on its step-0 gradients, and
                 one ``build_train_step`` update, finite. (e) One M3ViT-S
                 step profiled: every device kernel by name and count.
                 Every weight-gradient launch of (b) on its ``mma`` variant.
                 Phase 3 holds the weight-gradient kernel in both variants
                 (``mma``: 3xTF32, heaviest group first; ``fma``: the
                 first design) against its plain version at
                 M3ViT-S's fc1 and fc2 training shapes (64 x 197 x 2 = 25216
                 rows over 16 experts, one empty, one skewed; atol = rtol =
                 1e-4, two calls bit-equal, empty groups zero, ``mma``'s
                 error against an f64 plain version no larger than
                 ``fma``'s) and at ragged widths, timed beside each other,
                 the plain per-group loop and ``torch._grouped_mm`` (its
                 device time from a profiler trace of eager calls); and the f32 grouped kernel at the
                 shapes of the expert layers' dx (``torch._grouped_mm``
                 beside it, as beside every f32 grouped row).
 13. train_ssm -- after phase 11, deterministic: the selective scan's
                 backward kernel in both variants (``saved``,
                 ``csrc/selective_scan_bwd.cu``; ``recompute``, the first
                 design) against ``ref.selective_scan_bwd_ref`` at
                 ``SCAN_BWD_SHAPES`` (N 4 to 512, one chunk or a ragged last
                 one, with and without dh_last) and at the training shape
                 ``SCAN_BWD_TRAIN`` (each output within ``SCAN_BWD_TOL`` of
                 the plain version relative to its largest value, dA and dD
                 bit-equal there, two calls bit-equal, ``saved`` from the
                 forward kernel's states bit-equal to its call alone; the
                 forward kernel saving the states: y and h_last bit-equal
                 to the serving kernel's, h_last to the plain version's;
                 device time by graph replay of ``saved`` alone and from
                 the states, beside ``recompute`` in the same run (alone at
                 most half of it), the forward kernel with and without the
                 states, the plain version's time and the bound; the
                 layout's warps an SM). Then
                 full-width falcon-mamba-7b (remat, AdamW, f32) cut to
                 ``TRAIN_SSM_LAYERS`` of 64 layers:
                 (a) step-0 gradients at 2 x ``TRAIN_SSM_GATE_SEQ`` tokens
                 with the kernels against the plain versions (phase 11's
                 rule, every leaf held to the relative bound); (b) the same
                 batch on a mesh of 2 pod slots of ``cuda:0`` with
                 ``grad_compress``: the updated params bit-equal to the
                 composition written out in ``_pod_step_check``; (c) two
                 ``Trainer`` runs of ``TRAIN_SSM_STEPS`` steps at 2 x 4096
                 tokens: every loss finite, the last below the first, the
                 runs bit-equal; step device time, tokens/s, peak memory;
                 (d) one step profiled: the scan forward's and backward's
                 share of its device time.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the card's name and power limit, and the line before that
holds the ``{"kernels": [...]}`` record (the int8_matmul and grouped rows
name the variant they timed, the attention rows the schedule). A row's
``ms`` is device time per call over CUDA-graph replays (``graph_ms``), warm
caches unless a ``cold_ms`` stands beside it; the plain versions are
CUDA-event times of eager calls (``rmsnorm``'s: graph replays).
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1979e12  # dense tensor-core int8
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # dense tensor-core tf32
REPLACES = {
    "int8_matmul": "src/repro/kernels/int8_matmul.py:53",
    "grouped_matmul": "src/repro/kernels/expert_linear.py:172",
    "streaming_attention": "src/repro/kernels/quant_attention.py:207",
    "lm_attention": "src/repro/kernels/quant_attention.py:207",
    "selective_scan": "src/repro/kernels/selective_scan.py:70",
    "rmsnorm": "src/repro/models/layers.py:21",  # plain XLA, not a Pallas kernel
    # XLA's transpose rule of ragged_dot, not a Pallas kernel
    "grouped_wgrad": "src/repro/kernels/ops.py:233",
    # not a Pallas kernel: the reference differentiates its scan with XLA
    "selective_scan_bwd": "XLA autodiff of src/repro/models/ssm.py:158-177",
}
SOURCES = {
    "int8_matmul": "src/repro_torch/kernels/csrc/int8_matmul.cu",
    "grouped_matmul": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
    "streaming_attention": "src/repro_torch/kernels/csrc/quant_attention.cu",
    "lm_attention": "src/repro_torch/kernels/csrc/lm_attention.cu",
    "selective_scan": "src/repro_torch/kernels/csrc/selective_scan.cu",
    "rmsnorm": "src/repro_torch/kernels/csrc/rmsnorm.cu",
    "grouped_wgrad": "src/repro_torch/kernels/csrc/grouped_wgrad.cu",
    "selective_scan_bwd": "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
    "selective_scan_bwd[recompute]":
        "src/repro_torch/kernels/csrc/selective_scan_bwd_recompute.cu",
}
# kernel launches per int8 forward of M3ViT-S: 6 dense layers x (q, k, v, o,
# fc1, fc2) + 6 MoE layers x (q, k, v, o, gate) + head; 6 MoE layers x (fc1,
# fc2); 12 attention layers; no RMSNorm (M3ViT normalises with LayerNorm)
PER_FORWARD = {"int8_matmul": 67, "grouped_matmul": 12, "streaming_attention": 12,
               "rmsnorm": 0}
# per OLMoE-1B-7B forward of the int8 / W4A8 trees (a packed admission or a
# decode tick): 16 layers x (q, k, v, o, gate) + lm_head; 16 x (fc1, fc2);
# 16 attention layers; 16 x (ln1, ln2, q_norm, k_norm) + final_norm
LM_PER_FORWARD = {"int8_matmul": 81, "grouped_matmul": 32, "lm_attention": 16,
                  "rmsnorm": 65}
# device kernel names of each wrapper's launches (profiles count them)
KERNEL_NAMES = {
    "int8_matmul": ("int8_mma_kernel", "int8_stream_kernel", "int8_matmul_kernel"),
    "grouped_matmul": ("gmm_mma_kernel", "gmm_stream_kernel", "gmm_dp4a_kernel",
                       "gmm_f32_mma_kernel", "gmm_f32_stream_kernel", "gmm_f32_fma_kernel"),
    "streaming_attention": ("quant_attention_kernel",),
    "lm_attention": ("lm_decode_kernel", "lm_tile_kernel"),
    "selective_scan": ("selective_scan_kernel", "selective_scan_save_kernel"),
    "rmsnorm": ("rmsnorm_kernel",),
}
# per forward of the fp tree served as launch/serve.py serves it: the dense
# linears are torch matmuls, the expert linears the f32 grouped mode
LM_FP_PER_FORWARD = {"int8_matmul": 0, "grouped_matmul": 32, "lm_attention": 16,
                     "rmsnorm": 65}
# the fp engine's emitted token may sit this far below the teacher-forced
# argmax of prefill (tests/test_torch_lm.py holds the same gate on the CPU)
LM_FP_TF_TOL = 1e-2
# teacher-forced limits on the served fp engine: median and p90 of the
# per-step relative logit error max |engine - prefill| / max |prefill|, and
# the steps (of 512) whose token sits more than LM_FP_TF_TOL below
# prefill's argmax. Its decode reads the bf16 K/V cache, prefill f32 K/V,
# and 16 random-weight layers with top-8 routing amplify that rounding: an
# H100 read median 8.59e-4, p90 0.0354 and 6 such steps (largest gap
# 0.118); the limits sit 3x above. The same engine with an f32 cache (the
# control) read median 1.04e-6, max 1.43e-6 and every token at the argmax:
# it is held to LM_FP_TF_TOL at every step and to a median of
# LM_FP_CTL_MEDIAN, so a fault (wrong slot, row or position, which moves
# logits by their size) fails either gate
LM_FP_TF_LIMITS = (2.6e-3, 0.11, 18)
LM_FP_CTL_MEDIAN = 1e-5
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_NEW_TOKENS = 8, 512, 16, 32
PROFILE_ATTEMPTS = 5  # traces of one profile, at most, while one is incomplete
# teacher-forced gate, per tree: every request at these steps (the first
# token from the packed prefill, then decode ticks); limits on the median
# and p90 of the per-step max |logit| error against prefill and on the
# number of steps (of 144) whose greedy token differs. Exact: with
# lm_attention's segment-keyed plan a prompt's rows in a pack get the bits
# of a prefill of it alone, and a decode tick's the bits of a prefill's
# last row (both trees read 0 at every step and 144 of 144 tokens on an
# H100). Before the plan the int8 tree read median 0.065, p90 0.166 and 8
# disagreeing steps, gated at 0.15 / 0.4 / 14.
LM_TF_STEPS = (0, 1, 2, 3, 5, 8, 13, 21, 31)
LM_TF_LIMITS = {"int8": (0.0, 0.0, 0), "int4": (0.0, 0.0, 0)}
# falcon-mamba-7b serving: 64 layers, one selective_scan launch each per
# grouped prefill dispatch; 8 slots, 16 requests of 64, 128 or 256 prompt
# tokens and 32 new tokens
SSM_LAYERS, SSM_SLOTS, SSM_MAX_LEN = 64, 8, 512
SSM_REQUESTS, SSM_NEW_TOKENS, SSM_PROMPT_LENS = 16, 32, (64, 128, 256)
# teacher-forced gate: at every step of every request, max |engine logit -
# forward logit| / max |forward logit|, limits on the median and the max
# over all steps. All f32 with no quantizer and no routing: the two differ
# only in the order of f32 sums (matmuls of other shapes, the scan against
# the one-step decode update), but 64 random-weight layers amplify a
# last-bit difference ~1e3-1e4-fold (``tests/test_torch_ssm.py::
# test_deep_decode_is_as_accurate_as_forward``: ~3e-4 on the CPU, and the
# f32 forward as far from f64). An H100 read median 5.34e-4, max 3.92e-3;
# the limits sit 3x above. Two controls of rounding size must fail it
# (``SSM_CONTROLS``), and a fault (wrong slot, state, row or position) moves
# a step's logits by their size.
SSM_TF_LIMIT = (1.6e-3, 1.2e-2)
# the controls: the first admission wave served again with TF32 matmuls
# (10-bit mantissa), and with its conv history rounded to bf16 (the
# reference engine's cache layout)
SSM_CONTROLS = ("tf32 matmuls", "bf16 conv history")
# phase 9: the vision burst (48 requests: every batch on both sides is a full
# 8, so each image's rows meet the same arithmetic and the probabilities are
# expected bit-equal; the gate allows f32 rounding of a probability, 1e-6),
# and the local step of replica 1 at which the chaos run kills it (its 8
# requests are admitted at step 1 and decode 31 more ticks: 16 is mid-decode)
CLUSTER_VISION_REQUESTS, CLUSTER_VISION_PROB_TOL = 48, 1e-6
CLUSTER_KILL_STEP = 16
# observability: every program_perf ratio of a served program in (0, this];
# a served program's step p50 (CUDA events the graph records at its first
# and last node) at least the first multiple of a replay's kernel time in a
# torch.profiler trace, and at most the second of the replay's device span
# there (first kernel start to last kernel end: the gaps between kernels,
# which the events see too, were 12-18% of a replay's kernel time on
# H100s, and served ticks ran 1.12-1.29x it depending on the card)
OBSERVE_RATIO_MAX = 1.05
OBSERVE_TICK_RATIO = (0.98, 1.15)
# fill level of every slot in the profiled tick: the served ticks' fill
# runs from 16 to 288, about 150 on average
OBSERVE_TICK_FILL = 150
# phase 10: full-width gemma2-2b. Per forward (a grouped prefill or a decode
# tick): 26 attention layers; 26 x (ln1, post_ln1, ln2, post_ln2) +
# final_norm RMSNorms; the int8 tree's 26 x (q, k, v, o, wi, wo) linears
# (the tied LM head stays an f32 GEMM)
DENSE_ARCH = "gemma2-2b"
DENSE_FP_PER_FORWARD = {"int8_matmul": 0, "grouped_matmul": 0, "lm_attention": 26,
                        "rmsnorm": 105}
DENSE_INT8_PER_FORWARD = dict(DENSE_FP_PER_FORWARD, int8_matmul=156)
# every step of the f32-cache control within this of prefill's logits (abs)
DENSE_TF_TOL = 1e-3
# the served fp engine (bf16 ring cache) against prefill: limits on the
# median and the max over the 512 steps of max |logit error|. An H100 read
# median 8.84e-3, max 1.23e-2 (every token at prefill's argmax); the
# f32-cache control 7.97e-6 / 1.19e-5. The limits sit 3x above the bf16
# reading; a fault (wrong slot, ring row or position) moves a step's logits
# by their size (~1)
DENSE_FP_TF_LIMITS = (2.7e-2, 3.7e-2)
# the ring-wrap run: one engine of 2 slots over 4608 rows (the local layers'
# ring 4096), a prompt that wraps the ring in its prefill and one that wraps
# it in decode, 64 new tokens each
DENSE_RING_MAX_LEN, DENSE_RING_PROMPTS, DENSE_RING_NEW = 4608, (4100, 4060), 64
# phase 12: the remaining model families at full width, each driven through
# its model API (prefill, then greedy decode steps at a scalar index), as
# the reference drives them (its engine serves neither). zamba2-7b: 81
# Mamba-2 layers and one shared attention block after every 6th (13
# applications); per forward, prefill or decode step 13 lm_attention
# launches and 81 layer norms + 13 x (ln1, ln2) + the final norm RMSNorms
# (the Mamba-2 gated norm is plain torch, as in the reference)
HYBRID_ARCH, HYBRID_BATCH, HYBRID_PROMPT, HYBRID_MAX_LEN = "zamba2-7b", 4, 512, 576
HYBRID_PER_FORWARD = {"int8_matmul": 0, "grouped_matmul": 0, "lm_attention": 13,
                      "rmsnorm": 108}
# seamless-m4t-medium: 4 utterances of 1024 frames, decoder prompts of 16
# tokens, a 48-row self cache; LayerNorm throughout (no RMSNorm launch). A
# prefill: 12 encoder self-attentions, 12 decoder self, 12 cross; a decode
# step: 12 self + 12 cross
ENCDEC_ARCH, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_MAX_LEN = "seamless-m4t-medium", 1024, 16, 48
ENCDEC_PER_PREFILL = {"int8_matmul": 0, "grouped_matmul": 0, "lm_attention": 36, "rmsnorm": 0}
ENCDEC_PER_DECODE = dict(ENCDEC_PER_PREFILL, lm_attention=24)
FAMILY_DECODE_STEPS = 32
# the allocation earlier phases may leave at phase 12's start: their
# returned results hold ~0.9-1.0 GB (0.88 GB at phase 8's start, 1.04 GB
# after phase 10 on an H100), the gemma2 trees that must be gone 4.39 and
# 10.46 GB
FAMILY_LEFT_GB = 2.0
# teacher-forced gate: each emitted token's logit in one forward over the
# prompt and the tokens before it within LM_FP_TF_TOL of that forward's
# argmax; the fold-only tree's logits: max |delta| / std(logits) under
# FOLD_REL_TOL (the reference's tests/test_quant.py rule)
FOLD_REL_TOL = 1e-2
# phase 11: full-width M3ViT-S training. The batch, the Trainer's steps and
# its learning rate (AdamW, warm-up: TrainerConfig's default 10 steps, then
# cosine to 0 at step 40); the loss gate is the reference Trainer test's margin
TRAIN_ARCH, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = "m3vit-small", 64, 40, 1e-3
TRAIN_LOSS_DROP = 0.2
# kernels against plain versions, step-0: the loss's relative error and each
# leaf's ||g_kernel - g_plain|| / ||g_plain||, each held to the larger of a
# floor and TRAIN_CONTROL_FACTOR times the most that TRAIN_CONTROLS copies of
# the params perturbed by TRAIN_CONTROL_EPS (relative, f32 rounding's size)
# move the plain ones. At full width the step-0 gradient is ill-conditioned:
# rounding-sized changes flip expert routings, the attention's row max and
# its 4-bit codes, and on an H100 a 1e-7 perturbation of the input patches
# moved every leaf of M3ViT-S's by 8-19% and the loss by 7.8e-5, the kernels
# theirs by 8-11% and 1.04e-5. A leaf whose gradient is zero in exact
# arithmetic (the attention's k bias: a constant added to a row's scores
# cancels in the softmax) holds rounding noise on both sides, gated at
# TRAIN_NOISE of the global gradient norm instead
TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_NOISE = 1e-5, 1e-3, 1e-4
TRAIN_CONTROLS, TRAIN_CONTROL_EPS, TRAIN_CONTROL_FACTOR = 2, 1e-7, 2.0
# the LM step: full-width OLMoE-1B-7B cut to 2 layers (all 16 with AdamW in
# f32 need ~110 GB), 4 x 256 tokens through impl="gshard"
TRAIN_LM_ARCH, TRAIN_LM_LAYERS, TRAIN_LM_BATCH, TRAIN_LM_SEQ = "olmoe-1b-7b", 2, 4, 256
# the training shapes of the weight-gradient rows: M3ViT-S's routed rows at
# batch 64 (top 2 of 16 experts), one expert empty, one with ~5x the mean
WGRAD_T, WGRAD_G, WGRAD_EMPTY, WGRAD_SKEWED = TRAIN_BATCH * 197 * 2, 16, 3, 7
WGRAD_RAGGED = [(37, 3, 100, 70), (1, 1, 8, 8), (0, 4, 64, 64)]  # (T, G, Din, Dout)
WGRAD_SEED = 13  # the training rows draw their own operands: earlier checks keep theirs
# phase 13: falcon-mamba-7b training. The scan's backward against its plain
# version at (B, S, di, N, with dh_last): S with a ragged last chunk (16
# steps a chunk up to N 128) or within one chunk (no saved states), several
# blocks along di, every (states a thread, lanes) scan_bwd_layout takes (N
# 4, 5, 16, 32, 64, 100, 200, 512); then at the training shape, without
# dh_last as the model calls it
SCAN_BWD_SHAPES = [(2, 12, 64, 16, True), (2, 37, 256, 4, True), (2, 37, 300, 16, False), (2, 37, 300, 16, True),
                   (2, 23, 70, 5, False), (1, 21, 40, 32, True), (1, 50, 130, 64, True),
                   (1, 19, 24, 100, False), (1, 13, 20, 200, True), (1, 9, 10, 512, True)]
SCAN_BWD_TRAIN = (2, 4096, 8192, 16)
SCAN_BWD_SEED = 17
# each output's max |kernel - plain| / max |plain|: dx and ddt sum the n
# terms in another order (a thread's fma chain over 4 states, then lane
# shuffles; torch's sum over N), a few roundings of the terms' size; db and
# dc sum over every channel (8192 at the training shape: per-block warp
# sums, then the blocks in order; torch's reduction), da over the steps and
# rows in the plain version's order but from fma-free products that may
# still round apart; dd is the same torch reduction on both sides
SCAN_BWD_TOL = {"dx": 1e-5, "ddt": 1e-5, "db": 1e-4, "dc": 1e-4, "da": 1e-4, "dd": 0.0}
# f32 operations a (b, t, d, n) state step (see _check_selective_scan_bwd):
# the bound's. The saved variant's compiled walk issues ~62 instructions a
# state step at (4, 4), 31 of them this work (tools/sass_mix.py;
# csrc/selective_scan_bwd.cu's header)
SCAN_BWD_OPS = 20
# the model: full-width falcon-mamba-7b (remat, AdamW, f32) cut to 16 of 64
# layers (AdamW in f32 holds 16 bytes a parameter: ~112 GB at 64 layers,
# ~31 GB at 16), TRAIN_4K's 4096 tokens at global batch 2; the gradient
# gate and the pod step at 2 x 512 tokens, where the plain loop is cheap
TRAIN_SSM_ARCH, TRAIN_SSM_LAYERS, TRAIN_SSM_BATCH = "falcon-mamba-7b", 16, 2
TRAIN_SSM_GATE_SEQ, TRAIN_SSM_STEPS = 512, 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(n_bytes: float, ops: float, ops_per_s: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _fmt_ms(ms) -> str:
    return "n/a" if ms is None else f"{ms:.4f} ms"


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script "
                 "runs only on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, devices {torch.cuda.device_count()}",
          flush=True)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s -> {_build.library_path()}",
          flush=True)
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {log.stem}: {line.strip()}", flush=True)


def graph_ms(fn, n: int = 20, iters: int = 10) -> float:
    """Device time per call of ``fn``: ``n`` calls captured in one CUDA graph
    and replayed, so the host's enqueue time (tens of microseconds a call of
    a Python wrapper) is not counted. Warmed up on the capture stream first
    (build, scratch, shared-memory attributes)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    return time_ms(graph.replay, iters=iters, warmup=2) / n


# ragged int8_matmul shapes that reach every variant and edge: M on both
# sides of 16 (variant 2 / 1), K % 16 != 0 and N % 8 != 0 (variant 3),
# N = 1000 (the M3ViT-S head: 8-byte weight copies, a ragged last tile),
# the widest weight at one row, and an empty x
INT8_RAGGED = ([(m, k, n) for m in (1, 8, 16, 17, 33, 197) for k in (100, 384, 2048)
                for n in (10, 16, 64, 1000, 1001)] + [(1, 2048, 50304), (0, 64, 64)])
# cold-L2 timing: weights rotated over buffers of at least this many bytes
# in all, three times the H100's 50 MB L2
COLD_BYTES = 150e6


def _check_int8_matmul(gen) -> dict:
    """Every variant of int8_matmul that takes a shape, with and without
    bias, bit-equal to ``int8_matmul_ref`` at the main path's shapes and at
    ``INT8_RAGGED``; then the timed rows (``_int8_timing``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.int8_matmul import VARIANTS, choose_variant, int8_matmul, takes

    def operands(M, K, N):
        x = torch.randint(-128, 128, (M, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        xs = torch.rand((), generator=gen, device="cuda") * 0.05 + 1e-3
        ws = torch.rand((N,), generator=gen, device="cuda") * 0.01 + 1e-4
        return x, w, xs, ws

    B = 8
    M = 197 * B
    # M3ViT-S at a batch of 8; then OLMoE-1B-7B at a decode tick (8 slots)
    # and a 512-token packed prefill: q/k/v/o, the router gate, the LM head
    shapes = [(M, 384, 384), (M, 384, 1536), (M, 1536, 384), (M, 384, 16),
              (B, 384, 1000)]
    shapes += [(m, 2048, n) for m in (LM_SLOTS, LM_MAX_LEN) for n in (2048, 64, 50304)]
    checked = {v: 0 for v in VARIANTS}
    for M_, K, N in shapes + INT8_RAGGED:
        x, w, xs, ws = operands(M_, K, N)
        bias = torch.randn((N,), generator=gen, device="cuda")
        for b in (None, bias):
            want = ref.int8_matmul_ref(x, w, xs, ws, b)
            for v in VARIANTS:
                if not takes(v, M_, K, N):
                    continue
                got = int8_matmul(x, w, xs, ws, b, variant=v)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"int8_matmul[{VARIANTS[v]}] {M_}x{K}x{N} bias={b is not None}: "
                        f"not bit-equal, max err {max_err(got, want)}")
                checked[v] += 1
    # an operand off the 16-byte grid takes variant 3, and variant 1 refuses it
    x, w, xs, ws = operands(64, 384, 384)
    x_off = torch.empty(64 * 384 + 1, dtype=torch.int8, device="cuda")[1:].view(64, 384)
    x_off.copy_(x)
    if not torch.equal(int8_matmul(x_off, w, xs, ws), ref.int8_matmul_ref(x, w, xs, ws)):
        raise AssertionError("int8_matmul on a misaligned x: not bit-equal")
    try:
        int8_matmul(x_off, w, xs, ws, variant=1)
    except ValueError:
        pass
    else:
        raise AssertionError("int8_matmul variant 1 took a misaligned x")
    picked = {v: sum(choose_variant(*shape) == v for shape in shapes + INT8_RAGGED)
              for v in VARIANTS}
    print(f"[kernels] int8_matmul bit-equal at {len(shapes) + len(INT8_RAGGED)} shapes "
          f"x 2 (bias): calls by variant {({VARIANTS[v]: n for v, n in checked.items()})}; "
          f"shapes the wrapper gives each {({VARIANTS[v]: n for v, n in picked.items()})}",
          flush=True)
    if min(picked.values()) == 0:
        raise AssertionError("the checked shapes do not reach every int8_matmul variant")

    def timing(label, M_, K, N, cold=False):
        return _int8_timing(label, operands(M_, K, N), cold)

    # dense fc1, the largest int8 call of the M3ViT-S forward
    row = timing("m3vit_fc1", M, 384, 1536)
    row.update(name="int8_matmul", max_abs_err=0.0, tolerance="bit-equal")
    row["more"] = [timing("m3vit_qkvo", M, 384, 384), timing("m3vit_head", B, 384, 1000)]
    row["olmoe"] = [timing(f"{site}_{phase}", m, 2048, n, cold=phase == "decode"
                           or site == "lm_head")
                    for phase, m in (("decode", LM_SLOTS), ("prefill", LM_MAX_LEN))
                    for site, n in (("qkvo", 2048), ("gate", 64), ("lm_head", 50304))]
    return row


def _int8_timing(label, operands, cold: bool) -> dict:
    """Time one int8_matmul shape: the variant the wrapper picks and the
    dp4a variant (the kernel this replaces) as device time per call
    (``graph_ms``), the wrapper's eager time per call, the plain version,
    and ``torch._int_mm`` (the int32 product alone; it takes M > 16 only, so
    for M <= 16 it gets x zero-padded to 32 rows, the padding made outside
    the timed calls). With ``cold``, the chosen and the dp4a variants also
    with the weight rotated over ``COLD_BYTES`` of buffers, so that L2 holds
    none of it when a call starts (as on the path, where each layer's
    weights arrive after the other layers')."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.int8_matmul import VARIANTS, choose_variant, int8_matmul

    x, w, xs, ws = operands
    (M, K), N = x.shape, w.shape[1]
    v = choose_variant(M, K, N)
    nb, bound_by = bound_ms(M * K + K * N + 4 * N + 4 + 4 * M * N, 2.0 * M * N * K,
                            INT8_OPS_PER_S)
    x_lib = x
    if M <= 16:
        x_lib = torch.zeros((32, K), dtype=torch.int8, device="cuda")
        x_lib[:M] = x
    row = {
        "label": label, "shape": [M, K, N], "variant": VARIANTS[v],
        "ms": graph_ms(lambda: int8_matmul(x, w, xs, ws)),
        "dp4a_ms": graph_ms(lambda: int8_matmul(x, w, xs, ws, variant=3)),
        "eager_ms": time_ms(lambda: int8_matmul(x, w, xs, ws)),
        "plain_ms": time_ms(lambda: ref.int8_matmul_ref(x, w, xs, ws), iters=10),
        "bound_ms": nb, "bound_by": bound_by,
        "library_ms": graph_ms(lambda: torch._int_mm(x_lib, w)),
        "library_rows": x_lib.shape[0],
    }
    if cold:
        bufs = [w] + [torch.randint(-127, 128, (K, N), generator=torch.Generator(
            device="cuda").manual_seed(i), device="cuda", dtype=torch.int8)
            for i in range(max(1, math.ceil(COLD_BYTES / (K * N))))]
        for key, var in (("cold_ms", v), ("dp4a_cold_ms", 3)):
            it = iter(range(1 << 30))
            row[key] = graph_ms(lambda: int8_matmul(x, bufs[next(it) % len(bufs)], xs, ws,
                                                    variant=var), n=len(bufs), iters=5)
        del bufs
    print(f"[kernels] int8_matmul {label} {[M, K, N]}: {VARIANTS[v]} {row['ms']:.4f} ms"
          f" (cold {row.get('cold_ms', float('nan')):.4f}), dp4a {row['dp4a_ms']:.4f} ms "
          f"(cold {row.get('dp4a_cold_ms', float('nan')):.4f}), eager {row['eager_ms']:.4f}"
          f" ms, _int_mm ({row['library_rows']} rows) {row['library_ms']:.4f} ms, bound "
          f"{nb:.5f} ms ({bound_by})", flush=True)
    return row


def _routing(gen, T: int, G: int) -> torch.Tensor:
    """Group sizes of T rows over G experts, the last expert left empty."""
    ids = torch.randint(0, max(G - 1, 1), (T,), generator=gen, device="cuda")
    return torch.bincount(ids, minlength=G).to(torch.int32)


# ragged grouped shapes (T, G, Din, Dout, sizes or None for seeded
# routing): Din % 16 != 0 and odd Din (W4A8's pad nibble; dp4a only),
# Dout % 16 == 8 (8-byte weight copies), Dout % 8 != 0 (dp4a only), one
# group holding every row, groups that span several 64-row tiles with
# empty groups between them, more than 16 rows a group at stream's
# threshold, a single group, and T = 0
GROUPED_RAGGED = [
    (40, 4, 100, 64, None), (31, 4, 65, 24, None), (33, 5, 48, 40, None),
    (70, 3, 64, 10, None), (130, 4, 128, 64, [0, 130, 0, 0]),
    (300, 6, 256, 136, [0, 90, 0, 140, 70, 0]), (48, 24, 64, 64, [40] + [0] * 22 + [8]),
    (16, 1, 32, 16, [16]), (0, 8, 64, 64, [0] * 8),
]


def _grouped_operands(gen, T, G, Din, Dout, packed, sizes=None):
    """int8 x, an int8 or nibble-packed stack, per-expert scales, a_scale
    and group sizes (seeded routing unless given)."""
    from repro_torch.core.quant.qtypes import pack_int4

    sizes = (_routing(gen, T, G) if sizes is None
             else torch.tensor(sizes, dtype=torch.int32, device="cuda"))
    x = torch.randint(-128, 128, (T, Din), generator=gen, device="cuda", dtype=torch.int8)
    if packed:
        w = pack_int4(torch.randint(-8, 8, (G, Din, Dout), generator=gen, device="cuda",
                                    dtype=torch.int8))
    else:
        w = torch.randint(-127, 128, (G, Din, Dout), generator=gen, device="cuda",
                          dtype=torch.int8)
    ws = torch.rand((G, Dout), generator=gen, device="cuda") * 0.01 + 1e-4
    a_s = torch.rand((), generator=gen, device="cuda") * 0.05 + 1e-3
    return x, w, sizes, ws, a_s


def _check_grouped_variants(x, w, sizes, ws, a_s, checked: dict) -> None:
    """Every variant that takes the widths, bit-equal to the plain version
    (with and without the scales); counts the calls in ``checked``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_linear import VARIANTS, grouped_matmul, takes

    T, Din = x.shape
    packed = w.dtype == torch.uint8
    plain = ref.grouped_matmul_q4_ref if packed else ref.grouped_matmul_q_ref
    ones = torch.ones_like(ws)
    for w_scale, a_scale in ((ws, a_s), (None, None)):
        want = plain(x, w, sizes, ones if w_scale is None else w_scale, a_scale)
        for v in VARIANTS:
            if not takes(v, Din, w.shape[2]):
                continue
            got = grouped_matmul(x, w, sizes, w_scale=w_scale, a_scale=a_scale, variant=v)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"grouped {'W4A8' if packed else 'int8'}[{VARIANTS[v]}] T={T} "
                    f"G={w.shape[0]} {Din}->{w.shape[2]} scales={w_scale is not None}: not "
                    f"bit-equal, max err {max_err(got, want)}")
            checked[VARIANTS[v]] = checked.get(VARIANTS[v], 0) + 1


GROUPED_F32_SEED = 7  # the f32 grouped operands at the decode, prefill and ragged shapes


def _check_grouped_f32(x, w, sizes, checked: dict) -> float:
    """Every f32 variant that takes the widths within atol = rtol = 1e-5 of
    ``grouped_matmul_ref``, and variants 1 and 2 bit-equal to each other
    (one 3xTF32 chunk arithmetic); counts the calls in ``checked`` and
    returns the largest error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_linear import F32_VARIANTS, grouped_matmul, takes

    T, Din = x.shape
    G, _, Dout = w.shape
    want = ref.grouped_matmul_ref(x, w, sizes)
    got, err = {}, 0.0
    for v in F32_VARIANTS:
        if not takes(v, Din, Dout, f32=True):
            continue
        got[v] = grouped_matmul(x, w, sizes, variant=v)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[v], want, atol=1e-5, rtol=1e-5, msg=lambda m: (
            f"grouped f32[{F32_VARIANTS[v]}] T={T} G={G} {Din}->{Dout}: {m}"))
        err = max(err, max_err(got[v], want))
        checked[F32_VARIANTS[v]] = checked.get(F32_VARIANTS[v], 0) + 1
    if 1 in got and not torch.equal(got[1], got[2]):
        raise AssertionError(f"grouped f32 T={T} G={G} {Din}->{Dout}: mma and stream are not "
                             f"bit-equal, max diff {max_err(got[1], got[2])}")
    return err


def _f32_operands(gen, T, G, Din, Dout, sizes=None):
    """Gaussian x and a stack scaled by 1 / sqrt(Din), so outputs are O(1)."""
    sizes = (_routing(gen, T, G) if sizes is None
             else torch.tensor(sizes, dtype=torch.int32, device="cuda"))
    x = torch.randn((T, Din), generator=gen, device="cuda")
    w = torch.randn((G, Din, Dout), generator=gen, device="cuda") / math.sqrt(max(Din, 1))
    return x, w, sizes


def _check_grouped_matmul(gen) -> list:
    """The int8 mode in every variant, bit-equal, at the M3ViT-S expert
    shapes, the OLMoE-1B-7B decode / prefill shapes and ``GROUPED_RAGGED``;
    the f32 mode in every variant (``_check_grouped_f32``) at the M3ViT-S
    calibration shapes, the OLMoE decode / prefill / calibration shapes and
    ``GROUPED_RAGGED``; then the timed rows (``_grouped_timing``)."""
    from repro_torch.kernels.expert_linear import grouped_matmul

    B, G = 8, 16
    T = 2 * 197 * B  # top-2 routed rows of a batch of 8
    checked: dict = {}
    f32_checked: dict = {}
    # the f32 operands no earlier design drew take their own generator, so
    # ``gen`` reaches the later checks in the state their gates were read in
    fgen = torch.Generator(device="cuda").manual_seed(GROUPED_F32_SEED)
    f32_err, rows = 0.0, {}
    for Din, Dout in ((384, 1536), (1536, 384)):
        x, w, sizes, ws, a_s = _grouped_operands(gen, T, G, Din, Dout, False)
        _check_grouped_variants(x, w, sizes, ws, a_s, checked)
        xf = torch.randn((T, Din), generator=gen, device="cuda")
        wf = torch.randn((G, Din, Dout), generator=gen, device="cuda") / math.sqrt(Din)
        f32_err = max(f32_err, _check_grouped_f32(xf, wf, sizes, f32_checked))
        rows[Din] = (x, w, sizes, ws, a_s, xf, wf)
    for T_, G_, Din, Dout, sz in GROUPED_RAGGED:
        _check_grouped_variants(*_grouped_operands(gen, T_, G_, Din, Dout, False, sz),
                                checked)
        f32_err = max(f32_err, _check_grouped_f32(*_f32_operands(fgen, T_, G_, Din, Dout, sz),
                                                  f32_checked))

    x, w, sizes, ws, a_s, xf, wf = rows[384]  # expert fc1
    int8_row = {"name": "grouped_matmul", "mode": "int8", "max_abs_err": 0.0,
                "tolerance": "bit-equal", "library_ms": None,
                **_grouped_timing("m3vit_fc1", x, w, sizes, ws, a_s), "olmoe": []}
    f32_row = {"name": "grouped_matmul_f32", "mode": "f32",
               "tolerance": "atol=1e-5, rtol=1e-5; mma and stream bit-equal",
               **_grouped_timing("m3vit_fc1", xf, wf, sizes), "olmoe": []}

    # OLMoE-1B-7B, 64 experts, fc1 (2048 -> 2 x 1024) and fc2 (1024 ->
    # 2048), fc1 timed: int8 and f32 at a decode tick (8 slots x top-8 = 64
    # routed rows, cold L2) and a 512-token packed prefill (4096 rows), f32
    # also at a calibration forward (2 x 32 tokens x top-8 = 512 rows)
    G = 64
    for T, label in ((LM_SLOTS * 8, "decode"), (LM_MAX_LEN * 8, "prefill"),
                     (2 * 32 * 8, "calibration")):
        for Din, Dout in ((2048, 2048), (1024, 2048)):
            if label != "calibration":
                x, w, sizes, ws, a_s = _grouped_operands(gen, T, G, Din, Dout, False)
                _check_grouped_variants(x, w, sizes, ws, a_s, checked)
                if Din == 2048:
                    int8_row["olmoe"].append(_grouped_timing(
                        f"{label}_fc1", x, w, sizes, ws, a_s, cold=label == "decode"))
                del x, w
            xf, wf, sizes = _f32_operands(gen if label == "calibration" else fgen,
                                          T, G, Din, Dout)
            f32_err = max(f32_err, _check_grouped_f32(xf, wf, sizes, f32_checked))
            if Din == 2048:
                f32_row["olmoe"].append(_grouped_timing(f"{label}_fc1", xf, wf, sizes,
                                                        cold=label == "decode"))
            del xf, wf
    empty = grouped_matmul(torch.zeros((0, 384), dtype=torch.int8, device="cuda"),
                           rows[384][1], torch.zeros(16, dtype=torch.int32, device="cuda"),
                           w_scale=rows[384][3], a_scale=rows[384][4])
    assert empty.shape == (0, 1536)
    print(f"[kernels] grouped int8 bit-equal, calls by variant {checked} (the path's "
          f"shapes and {len(GROUPED_RAGGED)} ragged ones, with and without scales)",
          flush=True)
    print(f"[kernels] grouped f32 within atol = rtol = 1e-5 (max err {f32_err:.3g}), mma and "
          f"stream bit-equal, calls by variant {f32_checked} (the path's shapes and "
          f"{len(GROUPED_RAGGED)} ragged ones)", flush=True)
    int8_row["checked"] = checked
    f32_row.update(max_abs_err=f32_err, checked=f32_checked)
    return [int8_row, f32_row]


def _grouped_timing(label, x, w, sizes, ws=None, a_s=None, cold=False) -> dict:
    """Time one grouped matmul (int8, W4A8 or f32 by the operands) and its
    plain version, and bound it: each input read once (the weights of the
    experts that got rows only), the output written once, 2 T Din Dout
    operations at the int8 rate, or for f32 at the dense tf32 rate, 3
    passes, as the 3xTF32 variants (``mma``, ``stream``) run them
    (``bound_ms``; the rule's pick is one of these; the f32 FMA rate beside
    it as ``bound_f32_ms``). Device time per call by ``graph_ms``, in the variant the wrapper
    picks and in the first port's tiles (dp4a, f32: fma), each timed call
    alone one device kernel; with ``cold`` also with the expert stack
    rotated over at least ``COLD_BYTES`` of buffers, so that L2 holds none
    of it when a call starts (as on the path, where each layer's experts
    arrive after the other layers')."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_linear import (
        F32_VARIANTS, VARIANTS, choose_variant, grouped_matmul)

    T, Din = x.shape
    G, w_rows, Dout = w.shape
    g_active = int((sizes > 0).sum())
    row = {"label": label, "shape": [T, G, Din, Dout]}
    f32 = x.dtype == torch.float32
    names = F32_VARIANTS if f32 else VARIANTS
    n_bytes = (x.element_size() * T * Din + w.element_size() * g_active * w_rows * Dout
               + 4 * T * Dout)
    if f32:
        plain_fn = lambda: ref.grouped_matmul_ref(x, w, sizes)  # noqa: E731
        nb, by = bound_ms(n_bytes, 3 * 2.0 * T * Din * Dout, TF32_OPS_PER_S)
        nf, byf = bound_ms(n_bytes, 2.0 * T * Din * Dout, F32_OPS_PER_S)
        row.update(bound_f32_ms=nf, bound_f32_by=byf)
        fn = lambda wt=w, var=None: grouped_matmul(x, wt, sizes, variant=var)  # noqa: E731
    else:
        plain = ref.grouped_matmul_q4_ref if w.dtype == torch.uint8 else ref.grouped_matmul_q_ref
        plain_fn = lambda: plain(x, w, sizes, ws, a_s)  # noqa: E731
        nb, by = bound_ms(n_bytes + 4 * G * Dout + 4, 2.0 * T * Din * Dout, INT8_OPS_PER_S)
        fn = lambda wt=w, var=None: grouped_matmul(  # noqa: E731
            x, wt, sizes, w_scale=ws, a_scale=a_s, variant=var)
    v = choose_variant(T, G, Din, Dout, f32=f32)
    old = names[3]
    row.update(variant=names[v], ms=graph_ms(fn), eager_ms=time_ms(fn),
               **{f"{old}_ms": graph_ms(lambda: fn(var=3))})
    for var in (v, 3):
        _one_device_kernel(f"grouped {label} {names[var]}", lambda: fn(var=var))
    if cold:
        n = max(2, math.ceil(COLD_BYTES / (w.numel() * w.element_size())))
        bufs = [w] + [w.roll(i, dims=0) for i in range(1, n)]
        for key, var in (("cold_ms", v), (f"{old}_cold_ms", 3)):
            it = iter(range(1 << 30))
            row[key] = graph_ms(lambda: fn(bufs[next(it) % n], var), n=2 * n, iters=5)
        del bufs
    row.update(plain_ms=time_ms(plain_fn, iters=10), bound_ms=nb, bound_by=by)
    tf32 = ""
    if f32:
        ends = _group_ends(sizes)
        row["library_ms"], note, err, lib_wall = _library_ms(
            lambda: torch._grouped_mm(x, w, offs=ends), plain_fn())
        row.update(library_call="torch._grouped_mm(x, w, offs=ends)", library_max_abs_err=err,
                   library_wall_ms=lib_wall)
        if note:
            row["library_refused"] = note
        tf32 = (f" at 3xTF32, f32 FMA bound {nf:.5f} ms ({byf}), torch._grouped_mm "
                + (f"{row['library_ms']:.4f} ms device (wall {_fmt_ms(lib_wall)}, max err "
                   f"{err:.3g})" if note is None else f"refused ({note})"))
    print(f"[kernels] grouped {'W4A8' if w.dtype == torch.uint8 else x.dtype} {label} "
          f"{row['shape']}: {row['variant']} {row['ms']:.4f} ms (cold "
          f"{row.get('cold_ms', float('nan')):.4f}), {old} {row[f'{old}_ms']:.4f} ms (cold "
          f"{row.get(f'{old}_cold_ms', float('nan')):.4f}), eager {row['eager_ms']:.4f} ms, "
          f"plain {row['plain_ms']:.3f} ms, bound {nb:.5f} ms ({by}){tf32}", flush=True)
    return row


def _check_grouped_w4a8(gen) -> dict:
    """W4A8 at the OLMoE-1B-7B expert fc1 shapes (2048 -> 2 x 1024, 64
    experts): a decode tick (8 slots x top-8 = 64 routed rows) and a full
    512-token packed prefill (4096 rows); fc2 (1024 -> 2048) and
    ``GROUPED_RAGGED`` checked too, every variant bit-equal to
    ``grouped_matmul_q4_ref``."""
    G = 64
    checked: dict = {}
    row = {"name": "grouped_matmul_w4a8", "max_abs_err": 0.0, "tolerance": "bit-equal",
           "library_ms": None}
    for T_, G_, Din, Dout, sz in GROUPED_RAGGED:
        _check_grouped_variants(*_grouped_operands(gen, T_, G_, Din, Dout, True, sz), checked)
    for T, label in ((8 * 8, ""), (512 * 8, "prefill_")):
        for Din, Dout in ((2048, 2048), (1024, 2048)):
            x, w, sizes, ws, a_s = _grouped_operands(gen, T, G, Din, Dout, True)
            _check_grouped_variants(x, w, sizes, ws, a_s, checked)
            if Din == 2048:  # fc1 is timed
                t = _grouped_timing(label or "decode", x, w, sizes, ws, a_s, cold=not label)
                row.update({label + k: v for k, v in t.items() if k != "label"})
    print(f"[kernels] grouped W4A8 bit-equal, calls by variant {checked}", flush=True)
    row["checked"] = checked
    return row


def _visible_pairs(B, Sq, Sk, causal, q_offset, valid, window, qseg, kseg) -> int:
    """(query, key) pairs a head must score: the mask of the plain version."""
    dev = "cuda"
    qpos = q_offset.to(dev)[:, None] + torch.arange(Sq, device=dev)
    kpos = torch.arange(Sk, device=dev)
    ok = (kpos[None, None, :] < valid.to(dev)[:, None, None]).expand(B, Sq, Sk)
    if causal:
        ok = ok & (kpos[None, None, :] <= qpos[:, :, None])
    if window:
        ok = ok & (qpos[:, :, None] - kpos[None, None, :] < window)
    if qseg is not None:
        ok = ok & (qseg[:, :, None] == kseg[:, None, :])
    return int(ok.sum())


# the generator seed of the LM attention rows (``_check_lm_attention``)
LM_ATTENTION_SEED = 0
# rows over 1e-4 with Gaussian q that the previous design of lm_attention.cu
# (one 32-query-row block a head, f32 FMAs from shared memory) gave on an
# H100 on the same inputs: the previous commit's chip_smoke.py run as
# ``_check_lm_attention(torch.Generator(device="cuda").manual_seed(
# LM_ATTENTION_SEED))``, which draws these two rows' inputs in the order
# kept here (0 of 8192 and 0 of 128; PERF.md names the run). A
# quant_bits > 0 row may have no more; the rows it did not run are absent
PARENT_GAUSSIAN_OVER = {"packed_prefill": 0, "decode_int8": 0}
# the vision case's rows over 1e-4 with Gaussian q/k ([8, 197, 6, 64], 4-bit
# codes, of 9456): the count the parent commit's kernel gave on the same
# inputs (its own chip_smoke.py:_check_attention, same seed and draws)
PARENT_VISION_GAUSSIAN_OVER = 0
GAUSSIAN_QB0_TOL = 1e-4  # atol = rtol for the quant_bits=0 rows with Gaussian q
# PERF.md's call times of the hd <= 128 lm_attention rows (ms, graph
# replays on an NVIDIA H100 80GB HBM3 at 700 W), printed beside this
# run's: the hd-256 class must not move them
PERF_MD_LM_ATTENTION_MS = {
    "calibration": 0.00964, "packed_prefill": 0.1065, "decode_int8": 0.0292,
    "decode_bf16": 0.0273, "packed_prefill_f32": 0.0914, "decode_gqa": 0.0301,
    "prefill_gqa": 0.0145, "window": 0.00733, "window_qb4": 0.0105, "softcap": 0.00817,
    "decode_hd112": 0.0786, "prefill_hd112": 0.0716, "prefill_hd100": 0.0351,
    "prefill_hd100_f32": 0.0140}


def _device_work(fn) -> int:
    """Device kernels, memsets and copies one call of ``fn`` enqueues: the
    nodes of a CUDA graph that captures the call (after a warm-up call),
    counted by the CUDA driver API's ``cuGraphGetNodes``."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        fn()
    nodes = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(nodes))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return nodes.value


def _one_device_kernel(label: str, fn) -> int:
    """Gate: one call of a wrapper is exactly one device kernel (no fill,
    cast, memset or work-table launch beside it)."""
    n = _device_work(fn)
    if n != 1:
        raise AssertionError(f"{label}: {n} device kernels, memsets or copies a call, "
                             "expected 1")
    return n


def _graph_kernel_names(graph) -> list:
    """The function names of a captured CUDA graph's kernel nodes, read
    through ``libcuda``: ``cuGraphGetNodes``, ``cuGraphNodeGetType``,
    ``cuGraphKernelNodeGetParams_v2``, ``cuFuncGetName``."""
    import ctypes

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = ([("func", ctypes.c_void_p)]
                    + [(n, ctypes.c_uint) for n in ("gx", "gy", "gz", "bx", "by", "bz", "smem")]
                    + [(n, ctypes.c_void_p) for n in ("params", "extra", "kern", "ctx")])

    cu = ctypes.CDLL("libcuda.so.1")

    def check(err, what):
        if err:
            raise RuntimeError(f"{what} failed: CUresult {err}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int()
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        prm = KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(prm)),
              "cuGraphKernelNodeGetParams_v2")
        name = ctypes.c_char_p()
        if prm.func:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(prm.func)),
                  "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(prm.kern)),
                  "cuKernelGetName")
        names.append(name.value.decode())
    return names


def _check_programs(tag: str, eng, per: dict) -> dict:
    """Gate: every program of a warmed engine is a captured CUDA graph, and
    each graph's kernel nodes of each kernel family (``KERNEL_NAMES``, by
    function name) equal the launches its capture counted, which equal
    ``per`` (one forward's launches; families absent from ``per``: 0), so
    the counts a replay adds are the kernels it runs."""
    nodes = 0
    for key, prog in eng._programs.items():
        if prog.graph is None:
            raise AssertionError(f"[{tag}] program {key} is not a captured graph")
        names = _graph_kernel_names(prog.graph)
        found = {f: sum(any(k in n for k in ks) for n in names)
                 for f, ks in KERNEL_NAMES.items()}
        counted = {f: prog.launches.get(f, 0) for f in KERNEL_NAMES}
        want = {f: per.get(f, 0) for f in KERNEL_NAMES}
        if not found == counted == want:
            raise AssertionError(f"[{tag}] {key}: kernel nodes {found}, launches counted at "
                                 f"capture {counted}, a forward launches {want}")
        nodes += len(names)
    print(f"[{tag}] {len(eng._programs)} captured programs: kernel nodes by family equal "
          f"the launches counted at capture and one forward's {per} (gate); "
          f"{nodes} kernel nodes in all", flush=True)
    return {"programs": len(eng._programs), "kernel_nodes": nodes}


def _warm(tag: str, eng) -> dict:
    """``eng.warmup()`` timed, with the graph pool it leaves (0 for an
    eager engine); gate: ``retraces`` 0."""
    torch.cuda.synchronize()
    reserved, t0 = torch.cuda.memory_reserved(), time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # the allocator's segments in the engine's graph pool, live or cached
    pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if eng._graphs and tuple(seg.get("segment_pool_id", ())) == tuple(eng._pool))
    if eng.metrics.counters.get("retraces", 0):
        raise AssertionError(f"[{tag}] retraces after warmup: {eng.metrics.counters}")
    print(f"[{tag}] warmup: {len(eng._programs)} programs, "
          f"{'captured as CUDA graphs' if eng._graphs else 'eager'}, in {seconds:.2f} s; "
          f"graph pool {pool / 1e6:.1f} MB, reserved memory {reserved / 1e9:.2f} -> "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB", flush=True)
    return {"capture_s": seconds, "pool_bytes": pool, "programs": len(eng._programs)}


def _check_retraces(tag: str, eng) -> None:
    n = eng.metrics.counters.get("retraces", 0)
    print(f"[{tag}] retraces after serving: {n} (gate: 0)", flush=True)
    if n:
        raise AssertionError(f"[{tag}] {n} programs built while serving")


def _eager(cfg):
    """``cfg`` with ``serve.aot_warmup=False``: the engines' eager switch."""
    import dataclasses

    return cfg.replace(serve=dataclasses.replace(cfg.serve, aot_warmup=False))


def _lm_attention_row(name, mode, q, k, v, kw, tol, sdpa=None, gaussian=None) -> dict:
    """Check one LM attention mode against the plain version on inputs
    whose scores are exact in f32 (``tol``), and with Gaussian q
    (``gaussian``): a ``quant_bits=0`` row is gated at ``GAUSSIAN_QB0_TOL``
    (against the plain version on f32 copies of bf16 K/V, which computes
    what the kernel does: the plain version rounds P to bf16 for bf16 V);
    a ``quant_bits > 0`` row counts its rows over 1e-4 (a score on a .5
    code boundary may round the other way when the dot products run in
    another order), gated at the previous design's count where
    ``PARENT_GAUSSIAN_OVER`` has one. Where the decode schedule takes the
    shape, the tile schedule (``schedule=1``) is held against the plain
    version too, and must equal the decode schedule bit for bit, on both
    inputs: the two run one arithmetic, so a served decode step computes
    what a prefill computes for its row. A bf16 K/V row is also held
    within 1e-5 of the plain version on f32 copies of its K/V, on the
    exact-score inputs. Gate: one device kernel a call. Time the kernel (device time per call,
    ``graph_ms``, and eager), the plain version and, for ``quant_bits=0``,
    SDPA (``sdpa``, graph and eager), and bound it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_attention import SCHEDULES, choose_schedule, lm_attention

    plain_kw = {key: val for key, val in kw.items() if key != "segments"}  # a grid hint
    got, want = lm_attention(q, k, v, **kw), ref.flash_attention_ref(q, k, v, **plain_kw)
    torch.cuda.synchronize()
    atol, rtol = tol
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    err = max_err(got, want)
    row = {}
    if k.dtype == torch.bfloat16:
        # the plain version on f32 copies of the bf16 K/V computes what the
        # kernel does (it keeps P in f32): exact-score inputs within 1e-5
        exact = ref.flash_attention_ref(q, k.float(), v.float(), **plain_kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, exact, atol=1e-5, rtol=1e-5)
        row["f32_copy_max_abs_err"] = max_err(got, exact)
        print(f"[kernels] lm_attention[{name}]: against the plain version on f32 copies of "
              f"the bf16 K/V, max err {row['f32_copy_max_abs_err']:.3g} (gate 1e-5)",
              flush=True)
    qb = kw.get("quant_bits", 0)
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    schedule = choose_schedule(Sq, Sk, H, KVH, hd, all(
        t.data_ptr() % 16 == 0 for t in (q, k, v)))
    if schedule == 0:
        tile = lm_attention(q, k, v, schedule=1, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(tile, want, atol=atol, rtol=rtol)
        row["tile_max_abs_err"] = max_err(tile, want)
        if not torch.equal(tile, got):
            raise AssertionError(f"lm_attention[{name}]: the tile schedule is not bit-equal "
                                 f"to the decode schedule, max diff {max_err(tile, got)}")
    if gaussian is not None:
        kp, vp = (k.float(), v.float()) if k.dtype == torch.bfloat16 else (k, v)
        g_got, g_want = lm_attention(gaussian, k, v, **kw), ref.flash_attention_ref(
            gaussian, kp, vp, **plain_kw)
        torch.cuda.synchronize()
        diff = (g_got - g_want).abs().amax(-1)
        over = int((diff > 1e-4).sum())
        parent = PARENT_GAUSSIAN_OVER.get(name)
        row.update(gaussian_max_abs_err=float(diff.max()), gaussian_rows_over=over,
                   gaussian_rows=diff.numel(), parent_rows_over=parent)
        gate = (f"; gate atol = rtol = {GAUSSIAN_QB0_TOL}" if qb == 0 else
                f", gate <= {parent}" if parent is not None else ", not gated")
        print(f"[kernels] lm_attention[{name}], Gaussian q: max err {float(diff.max()):.3g}, "
              f"rows over 1e-4: {over} of {diff.numel()} (previous design: "
              f"{'not run' if parent is None else parent}){gate}", flush=True)
        if qb == 0:
            torch.testing.assert_close(g_got, g_want, atol=GAUSSIAN_QB0_TOL,
                                       rtol=GAUSSIAN_QB0_TOL)
        elif parent is not None and over > parent:
            raise AssertionError(f"lm_attention[{name}]: {over} rows over 1e-4 with "
                                 f"Gaussian q, the previous design {parent}")
        if schedule == 0:
            g_tile = lm_attention(gaussian, k, v, schedule=1, **kw)
            torch.cuda.synchronize()
            same = torch.equal(g_tile, g_got)
            print(f"[kernels] lm_attention[{name}], Gaussian q: tile schedule bit-equal to "
                  f"the decode schedule: {same} (gate; max diff {max_err(g_tile, g_got):.3g})",
                  flush=True)
            if not same:
                raise AssertionError(f"lm_attention[{name}]: with Gaussian q the tile "
                                     "schedule is not bit-equal to the decode schedule")
    off = kw.get("q_offset", 0)
    off = off if isinstance(off, torch.Tensor) else torch.full((B,), off, device="cuda")
    valid = kw.get("kv_valid_len")
    valid = valid if valid is not None else torch.full((B,), Sk, device="cuda")
    qseg = kw.get("q_segment_ids")
    kseg = kw.get("kv_segment_ids", qseg)
    pairs = _visible_pairs(B, Sq, Sk, kw.get("causal", True), off, valid,
                           kw.get("local_window", 0), qseg, kseg)
    live_keys = int(torch.clamp(valid, max=Sk).sum())
    n_bytes = (8 * B * Sq * H * hd + 2 * live_keys * KVH * hd * k.element_size()
               + (8 * live_keys * KVH if "k_scale" in kw else 0)
               + (4 * B * (Sq + Sk) if qseg is not None else 0) + 8 * B)
    nb, by = bound_ms(n_bytes, 4.0 * pairs * (H // KVH) * KVH * hd, F32_OPS_PER_S)
    kernel = lambda: lm_attention(q, k, v, **kw)  # noqa: E731
    row.update({
        "name": f"lm_attention[{name}]", "mode": mode, "shape": [B, Sq, Sk, H, KVH, hd],
        "schedule": SCHEDULES[schedule],
        "quant_bits": qb, "kv_dtype": str(k.dtype).removeprefix("torch."),
        "max_abs_err": err, "tolerance": f"atol={atol}, rtol={rtol}",
        "device_kernels": _one_device_kernel(f"lm_attention[{name}]", kernel),
        "ms": graph_ms(kernel), "eager_ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, **plain_kw), iters=5),
        "bound_ms": nb, "bound_by": by,
        "library_ms": None if sdpa is None else graph_ms(sdpa),
        "library_eager_ms": None if sdpa is None else time_ms(sdpa),
    })
    if schedule == 0:
        row["tile_ms"] = graph_ms(lambda: lm_attention(q, k, v, schedule=1, **kw))
    lib = "" if sdpa is None else (f", SDPA {row['library_ms']:.4f} ms (eager "
                                   f"{row['library_eager_ms']:.4f})")
    tile = "" if schedule else f", tile schedule {row['tile_ms']:.4f} ms"
    print(f"[kernels] lm_attention[{name}] {row['shape']} {mode}: {row['schedule']} "
          f"{row['ms']:.4f} ms (eager {row['eager_ms']:.4f}){lib}{tile}, plain "
          f"{row['plain_ms']:.3f} ms, bound {nb:.5f} ms ({by}), max err {err:.3g}",
          flush=True)
    return row


def _check_lm_attention(gen) -> list:
    """Every LM mode at the OLMoE-1B-7B shapes (16 heads of 128): the
    calibration forward, a 512-token packed prefill over int8 K/V with four
    segments and a pad tail, a decode tick of 8 slots over the int8 cache,
    a decode tick over a bf16 cache; the window / softcap options at a
    small shape; GQA; zamba2-7b's head dim of 112; a head dim of 100 (rows
    that are not whole 16-byte chunks, staged by plain loads, and padded
    dims). q (and fp k) lie on a 1/4 grid and int8 k is integral, so the
    scores are exact in f32 and the codes equal the plain version's.
    ``gen`` draws every input in the previous design's order (so the
    packed-prefill and decode rows meet the inputs ``PARENT_GAUSSIAN_OVER``
    was read on); the Gaussian q of the rows that run had none come from a
    second generator."""
    from repro_torch.models.layers import quantize_kv

    sdpa = torch.nn.functional.scaled_dot_product_attention
    grid = lambda *shape: torch.randint(-3, 4, shape, generator=gen,  # noqa: E731
                                        device="cuda").float() * 0.25
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    extra = torch.Generator(device="cuda").manual_seed(LM_ATTENTION_SEED + 1)
    gauss = lambda *shape: torch.randn(shape, generator=extra, device="cuda")  # noqa: E731
    H, hd, rows = 16, 128, []
    f32_tol, bf16_tol = (1e-5, 1e-5), (5e-3, 0.0)

    # calibration: causal, f32, online softmax (2 x 32 tokens)
    q, k, v = grid(2, 32, H, hd), grid(2, 32, H, hd), randn(2, 32, H, hd)
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    rows.append(_lm_attention_row(
        "calibration", "causal/float32/qb0", q, k, v, dict(causal=True, quant_bits=0),
        f32_tol, sdpa=lambda: sdpa(t(q), t(k), t(v), is_causal=True),
        gaussian=gauss(2, 32, H, hd)))

    # packed prefill: 4 prompts + pad tail in one 512 row, int8 K/V, 4-bit;
    # the grid hint as prefill_packed gives it (prompt slots + the pad tail)
    P = 512
    seg = torch.full((1, P), -1, dtype=torch.int32, device="cuda")
    cursor = 0
    for i, n in enumerate((200, 150, 100, 50)):
        seg[0, cursor:cursor + n] = i
        cursor += n
    k8, ks = quantize_kv(randn(1, P, H, hd))
    v8, vs = quantize_kv(randn(1, P, H, hd))
    kw = dict(causal=True, quant_bits=4, k_scale=ks, v_scale=vs,
              kv_valid_len=torch.full((1,), P, dtype=torch.int32, device="cuda"),
              q_segment_ids=seg, kv_segment_ids=seg, segments=5)
    rows.append(_lm_attention_row("packed_prefill", "causal/int8/qb4/segments",
                                  grid(1, P, H, hd), k8, v8, kw, f32_tol,
                                  gaussian=randn(1, P, H, hd)))

    # decode tick: 8 slots at their own fill levels over the int8 cache
    off = torch.tensor([511, 300, 17, 0, 128, 64, 255, 400], dtype=torch.int32,
                       device="cuda")
    k8, ks = quantize_kv(randn(8, LM_MAX_LEN, H, hd))
    v8, vs = quantize_kv(randn(8, LM_MAX_LEN, H, hd))
    kw = dict(causal=True, q_offset=off, quant_bits=4, k_scale=ks, v_scale=vs,
              kv_valid_len=off + 1)
    rows.append(_lm_attention_row("decode_int8", "causal/int8/qb4/decode",
                                  grid(8, 1, H, hd), k8, v8, kw, f32_tol,
                                  gaussian=randn(8, 1, H, hd)))

    # decode tick over a bf16 cache (the fp tree's serving cache), online
    # softmax: the plain version rounds P to bf16 before P.V, the kernel
    # keeps it f32 (as the Pallas kernel does), hence the bf16 tolerance
    q = grid(8, 1, H, hd)
    kb, vb = grid(8, LM_MAX_LEN, H, hd).bfloat16(), randn(8, LM_MAX_LEN, H, hd).bfloat16()
    mask = (torch.arange(LM_MAX_LEN, device="cuda")[None, :] < (off + 1)[:, None])
    kw = dict(causal=True, q_offset=off, quant_bits=0, kv_valid_len=off + 1)
    rows.append(_lm_attention_row(
        "decode_bf16", "causal/bfloat16/qb0/decode", q, kb, vb, kw, bf16_tol,
        sdpa=lambda: sdpa(t(q.bfloat16()), t(kb), t(vb), attn_mask=mask[:, None, None, :]),
        gaussian=gauss(8, 1, H, hd)))

    # local window and logit softcap (not on the OLMoE path), hd = 64
    S, Hs, W = 64, 4, 16
    q, k, v = grid(2, S, Hs, 64), grid(2, S, Hs, 64), randn(2, S, Hs, 64)
    pos = torch.arange(S, device="cuda")
    wmask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < W)
    rows.append(_lm_attention_row(
        "window", "causal/float32/qb0", q, k, v,
        dict(causal=True, quant_bits=0, local_window=W), f32_tol,
        sdpa=lambda: sdpa(t(q), t(k), t(v), attn_mask=wmask), gaussian=gauss(2, S, Hs, 64)))
    rows.append(_lm_attention_row(
        "window_qb4", "causal/float32/qb4", q, k, v,
        dict(causal=True, quant_bits=4, local_window=W), f32_tol,
        gaussian=gauss(2, S, Hs, 64)))
    rows.append(_lm_attention_row(  # no PyTorch call applies a tanh softcap
        "softcap", "causal/float32/qb0", q, k, v,
        dict(causal=True, quant_bits=0, local_window=W, logit_softcap=30.0), f32_tol,
        gaussian=gauss(2, S, Hs, 64)))

    # GQA (not on the OLMoE path): a decode tick of 4 slots with 4 heads a
    # KV head (the decode schedule's most rows a block), and a causal f32
    # prefill with 4 heads a KV head
    off4 = off[:4]
    k8, ks = quantize_kv(randn(4, LM_MAX_LEN, 8, hd))
    v8, vs = quantize_kv(randn(4, LM_MAX_LEN, 8, hd))
    rows.append(_lm_attention_row(
        "decode_gqa", "causal/int8/qb4/decode/gqa", grid(4, 1, 32, hd), k8, v8,
        dict(causal=True, q_offset=off4, quant_bits=4, k_scale=ks, v_scale=vs,
             kv_valid_len=off4 + 1), f32_tol, gaussian=gauss(4, 1, 32, hd)))
    q, k, v = grid(1, 100, 8, hd), grid(1, 100, 2, hd), randn(1, 100, 2, hd)
    kg, vg = k.repeat_interleave(4, dim=2), v.repeat_interleave(4, dim=2)
    rows.append(_lm_attention_row(
        "prefill_gqa", "causal/float32/qb0/gqa", q, k, v, dict(causal=True, quant_bits=0),
        f32_tol, sdpa=lambda: sdpa(t(q), t(kg), t(vg), is_causal=True),
        gaussian=gauss(1, 100, 8, hd)))

    # zamba2-7b's attention (32 heads of 112, not a configuration the port
    # serves yet): a decode tick over an int8 cache and a 256-token prefill,
    # both on the tile schedule (the decode schedule holds hd = 128)
    Hz, hz = 32, 112
    k8, ks = quantize_kv(randn(8, LM_MAX_LEN, Hz, hz))
    v8, vs = quantize_kv(randn(8, LM_MAX_LEN, Hz, hz))
    rows.append(_lm_attention_row(
        "decode_hd112", "causal/int8/qb4/decode/hd112", grid(8, 1, Hz, hz), k8, v8,
        dict(causal=True, q_offset=off, quant_bits=4, k_scale=ks, v_scale=vs,
             kv_valid_len=off + 1), f32_tol, gaussian=gauss(8, 1, Hz, hz)))
    q, k, v = grid(1, 256, Hz, hz), grid(1, 256, Hz, hz), randn(1, 256, Hz, hz)
    rows.append(_lm_attention_row(
        "prefill_hd112", "causal/float32/qb0/hd112", q, k, v, dict(causal=True, quant_bits=0),
        f32_tol, sdpa=lambda: sdpa(t(q), t(k), t(v), is_causal=True),
        gaussian=gauss(1, 256, Hz, hz)))

    # hd = 100: int8 rows of 100 bytes (plain loads, 12 padded dims) and f32
    # rows of 400 bytes (cp.async, the last three chunks zero-filled)
    k8, ks = quantize_kv(randn(2, 80, 4, 100))
    v8, vs = quantize_kv(randn(2, 80, 4, 100))
    rows.append(_lm_attention_row(
        "prefill_hd100", "causal/int8/qb4/hd100", grid(2, 80, 4, 100), k8, v8,
        dict(causal=True, quant_bits=4, k_scale=ks, v_scale=vs), f32_tol,
        gaussian=gauss(2, 80, 4, 100)))
    q, k, v = grid(2, 80, 4, 100), grid(2, 80, 4, 100), randn(2, 80, 4, 100)
    rows.append(_lm_attention_row(
        "prefill_hd100_f32", "causal/float32/qb0/hd100", q, k, v, dict(causal=True, quant_bits=0),
        f32_tol, sdpa=lambda: sdpa(t(q), t(k), t(v), is_causal=True),
        gaussian=gauss(2, 80, 4, 100)))

    # the fp tree's packed admission: the packed_prefill row's four prompts
    # and pad tail over f32 K/V, online softmax (drawn last, so the rows
    # above keep their inputs); SDPA beside it with the block-diagonal
    # causal mask of the segments
    q, k, v = grid(1, P, H, hd), grid(1, P, H, hd), randn(1, P, H, hd)
    pos = torch.arange(P, device="cuda")
    pmask = (seg[0][:, None] == seg[0][None, :]) & (pos[None, :] <= pos[:, None])
    rows.append(_lm_attention_row(
        "packed_prefill_f32", "causal/float32/qb0/segments", q, k, v,
        dict(causal=True, quant_bits=0, kv_valid_len=torch.full(
            (1,), P, dtype=torch.int32, device="cuda"), q_segment_ids=seg,
             kv_segment_ids=seg, segments=5),
        f32_tol, sdpa=lambda: sdpa(t(q), t(k), t(v), attn_mask=pmask),
        gaussian=gauss(1, P, H, hd)))
    rows += _check_lm_attention_hd256(grid, randn, gauss, off, f32_tol, bf16_tol)
    for row in rows:
        was = PERF_MD_LM_ATTENTION_MS.get(row["name"].removeprefix("lm_attention["
                                                                   ).removesuffix("]"))
        if was is not None:
            row["perf_md_ms"] = was
            print(f"[kernels] {row['name']}: {row['ms']:.4f} ms against PERF.md's {was} "
                  f"({row['ms'] / was:.3f}x)", flush=True)
    return rows


def _check_lm_attention_hd256(grid, randn, gauss, off, f32_tol, bf16_tol) -> list:
    """The head dims above 128 (drawn after every hd <= 128 row, so those
    keep their inputs): gemma2-2b (8 heads of 256 over 4 KV heads, softcap
    50, local window 4096) in every mode its serving path runs -- decode
    over a bf16 and an int8 cache of 512 rows, and over a 4096-row ring
    (the local layers at max_len >= 4096) that has wrapped, q_offset in
    4096..4200, no window; the f32 prefill of 2 x 256 with the window
    argument, and of 4160 tokens, where it masks; the int8 ring prefill
    over fresh K/V with scales and the window -- then gemma-7b's (16 heads
    of 256, no softcap: SDPA computes the same function) decode and
    prefill, and nemotron-4-340b's head dim of 192. Decode rows are held
    bit-equal to the tile schedule (``_lm_attention_row``)."""
    from repro_torch.models.layers import quantize_kv

    sdpa = torch.nn.functional.scaled_dot_product_attention
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    H, KVH, hd, W, cap = 8, 4, 256, 4096, 50.0
    rows = []
    for ring in (False, True):
        Sk = W if ring else LM_MAX_LEN
        q_off = (torch.randint(W, W + 105, (8,), device="cuda", dtype=torch.int32)
                 if ring else off)
        valid = torch.clamp(q_off + 1, max=Sk)
        where = "ring" if ring else "512"
        kb, vb = grid(8, Sk, KVH, hd).bfloat16(), randn(8, Sk, KVH, hd).bfloat16()
        rows.append(_lm_attention_row(
            f"gemma2_decode_bf16_{where}", "causal/bfloat16/qb0/decode", grid(8, 1, H, hd),
            kb, vb, dict(causal=True, q_offset=q_off, quant_bits=0, logit_softcap=cap,
                         kv_valid_len=valid), bf16_tol, gaussian=gauss(8, 1, H, hd)))
        k8, ks = quantize_kv(randn(8, Sk, KVH, hd))
        v8, vs = quantize_kv(randn(8, Sk, KVH, hd))
        rows.append(_lm_attention_row(
            f"gemma2_decode_int8_{where}", "causal/int8/qb4/decode", grid(8, 1, H, hd),
            k8, v8, dict(causal=True, q_offset=q_off, quant_bits=4, logit_softcap=cap,
                         k_scale=ks, v_scale=vs, kv_valid_len=valid), f32_tol,
            gaussian=gauss(8, 1, H, hd)))
        del kb, vb, k8, v8, ks, vs
    for name, S in (("gemma2_prefill_f32", 256), ("gemma2_prefill_f32_4160", 4160)):
        B = 2 if S == 256 else 1
        rows.append(_lm_attention_row(
            name, "causal/float32/qb0", grid(B, S, H, hd), grid(B, S, KVH, hd),
            randn(B, S, KVH, hd), dict(causal=True, quant_bits=0, logit_softcap=cap,
                                       local_window=W), f32_tol,
            gaussian=gauss(B, S, H, hd)))
    k8, ks = quantize_kv(randn(2, 256, KVH, hd))
    v8, vs = quantize_kv(randn(2, 256, KVH, hd))
    rows.append(_lm_attention_row(
        "gemma2_ring_prefill_int8", "causal/int8/qb4", grid(2, 256, H, hd), k8, v8,
        dict(causal=True, quant_bits=4, logit_softcap=cap, local_window=W, k_scale=ks,
             v_scale=vs), f32_tol, gaussian=gauss(2, 256, H, hd)))

    # gemma-7b: 16 heads of 256, one a KV head
    q = grid(8, 1, 16, hd)
    kb, vb = grid(8, LM_MAX_LEN, 16, hd).bfloat16(), randn(8, LM_MAX_LEN, 16, hd).bfloat16()
    mask = torch.arange(LM_MAX_LEN, device="cuda")[None, :] < (off + 1)[:, None]
    rows.append(_lm_attention_row(
        "gemma7b_decode_bf16", "causal/bfloat16/qb0/decode/gemma7b", q, kb, vb,
        dict(causal=True, q_offset=off, quant_bits=0, kv_valid_len=off + 1), bf16_tol,
        sdpa=lambda: sdpa(t(q.bfloat16()), t(kb), t(vb), attn_mask=mask[:, None, None, :]),
        gaussian=gauss(8, 1, 16, hd)))
    q, k, v = grid(1, LM_MAX_LEN, 16, hd), grid(1, LM_MAX_LEN, 16, hd), randn(
        1, LM_MAX_LEN, 16, hd)
    rows.append(_lm_attention_row(
        "gemma7b_prefill_f32", "causal/float32/qb0/gemma7b", q, k, v,
        dict(causal=True, quant_bits=0), f32_tol,
        sdpa=lambda: sdpa(t(q), t(k), t(v), is_causal=True),
        gaussian=gauss(1, LM_MAX_LEN, 16, hd)))

    # nemotron-4-340b's head dim (96 heads of 192 over 8 KV heads there; 16
    # over 2 here): the hd-256 class at a width that is not a power of two
    q, k, v = grid(1, 256, 16, 192), grid(1, 256, 2, 192), randn(1, 256, 2, 192)
    kg, vg = k.repeat_interleave(8, dim=2), v.repeat_interleave(8, dim=2)
    rows.append(_lm_attention_row(
        "prefill_hd192", "causal/float32/qb0/hd192", q, k, v, dict(causal=True, quant_bits=0),
        f32_tol, sdpa=lambda: sdpa(t(q), t(kg), t(vg), is_causal=True),
        gaussian=gauss(1, 256, 16, 192)))
    return rows


# the generator seed of phase 12's attention rows (``_check_lm_attention_families``)
FAMILY_ATTENTION_SEED = 12


def _check_lm_attention_families(gen) -> list:
    """``lm_attention`` at the shapes phase 12's path gives it (f32 K/V,
    ``quant_bits=0``, on its own generator so the rows above keep their
    inputs): zamba2-7b's shared block (32 heads of 112, one KV head each),
    its prefill of 4 x 512 over the 576-row cache and a decode row at the
    scalar index 540; seamless-m4t-medium's (16 heads of 64) non-causal
    encoder self-attention over 4 x 1024 frames, the cross-attention of the
    16-token decoder prompt and of a decode row over the 1024-frame memory
    (Sq != Sk, no mask), and the decoder's causal self-attention, its
    prompt over the 48-row cache and a decode row at index 40. Every row
    beside SDPA on the same inputs (the mask of the cache's valid rows
    where it has one)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    grid = lambda *shape: torch.randint(-3, 4, shape, generator=gen,  # noqa: E731
                                        device="cuda").float() * 0.25
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    extra = torch.Generator(device="cuda").manual_seed(FAMILY_ATTENTION_SEED + 1)
    gauss = lambda *shape: torch.randn(shape, generator=extra, device="cuda")  # noqa: E731
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    f32_tol, rows = (1e-5, 1e-5), []
    B = HYBRID_BATCH

    def cache_mask(Sq, Sk, q_off, valid):
        qpos = q_off + torch.arange(Sq, device="cuda")[:, None]
        kpos = torch.arange(Sk, device="cuda")[None, :]
        return (kpos <= qpos) & (kpos < valid)

    # zamba2: the prefill over the cache (valid 512 of 576 rows), a decode row
    H, hd, L, P = 32, 112, HYBRID_MAX_LEN, HYBRID_PROMPT
    q, k, v = grid(B, P, H, hd), grid(B, L, H, hd), randn(B, L, H, hd)
    valid = torch.full((B,), P, dtype=torch.int32, device="cuda")
    mask = cache_mask(P, L, 0, P)
    rows.append(_lm_attention_row(
        "zamba2_prefill_f32", "causal/float32/qb0", q, k, v,
        dict(causal=True, quant_bits=0, kv_valid_len=valid), f32_tol,
        sdpa=lambda: sdpa(t(q), t(k), t(v), attn_mask=mask), gaussian=gauss(B, P, H, hd)))
    idx = 540
    q = grid(B, 1, H, hd)
    mask = cache_mask(1, L, idx, idx + 1)
    rows.append(_lm_attention_row(
        "zamba2_decode_f32", "causal/float32/qb0/decode", q, k, v,
        dict(causal=True, q_offset=idx, quant_bits=0,
             kv_valid_len=torch.full((B,), idx + 1, dtype=torch.int32, device="cuda")),
        f32_tol, sdpa=lambda: sdpa(t(q), t(k), t(v), attn_mask=mask),
        gaussian=gauss(B, 1, H, hd)))
    del q, k, v

    # seamless: the encoder, the cross-attention at prefill and decode
    H, hd, F, P, L = 16, 64, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_MAX_LEN
    q, k, v = grid(B, F, H, hd), grid(B, F, H, hd), randn(B, F, H, hd)
    rows.append(_lm_attention_row(
        "seamless_encoder_f32", "full/float32/qb0", q, k, v,
        dict(causal=False, quant_bits=0), f32_tol, sdpa=lambda: sdpa(t(q), t(k), t(v)),
        gaussian=gauss(B, F, H, hd)))
    for name, mode, Sq in (("seamless_cross_prefill_f32", "full/float32/qb0", P),
                           ("seamless_cross_decode_f32", "full/float32/qb0/decode", 1)):
        qx = grid(B, Sq, H, hd)
        rows.append(_lm_attention_row(
            name, mode, qx, k, v, dict(causal=False, quant_bits=0), f32_tol,
            sdpa=lambda: sdpa(t(qx), t(k), t(v)), gaussian=gauss(B, Sq, H, hd)))
    del q, k, v
    # the decoder's self-attention over its 48-row cache
    k, v = grid(B, L, H, hd), randn(B, L, H, hd)
    for name, mode, Sq, off in (("seamless_prefill_f32", "causal/float32/qb0", P, 0),
                                ("seamless_decode_f32", "causal/float32/qb0/decode", 1, 40)):
        qs = grid(B, Sq, H, hd)
        mask = cache_mask(Sq, L, off, off + Sq)
        rows.append(_lm_attention_row(
            name, mode, qs, k, v,
            dict(causal=True, q_offset=off, quant_bits=0,
                 kv_valid_len=torch.full((B,), off + Sq, dtype=torch.int32, device="cuda")),
            f32_tol, sdpa=lambda: sdpa(t(qs), t(k), t(v), attn_mask=mask),
            gaussian=gauss(B, Sq, H, hd)))
    return rows


# the vision kernel's edges, on exact-score inputs (B, Sq, Sk, H, KVH, hd,
# quant_bits): hd 16 (the smoke configs') in one key chunk, GQA with Sq !=
# Sk and ragged chunks, hd 100 (padded to 128), hd 30 (plain loads: rows
# not whole 16-byte chunks), 8-bit codes, 16 key chunks, and the longest
# Sk ``fits_in_shared_memory`` admits at hd 64
VISION_EDGES = [(2, 50, 50, 4, 4, 16, 4), (2, 33, 77, 4, 2, 32, 4), (1, 197, 197, 2, 2, 100, 4),
                (1, 40, 65, 2, 2, 30, 4), (2, 70, 130, 2, 2, 64, 8), (1, 64, 1024, 2, 2, 64, 4),
                (1, 20, 1456, 1, 1, 64, 4)]


def _check_attention(gen) -> dict:
    """The vision case of streaming_attention at M3ViT-S ([8, 197, 6, 64],
    4-bit codes): on inputs whose scores are exact in f32 (q, k on a 1/4
    grid: the kernel's and the plain version's codes agree exactly and only
    exp and the P.V sums differ) within atol = rtol = 1e-5, then with
    Gaussian q/k (a score on a .5 code boundary may round the other way
    when the dot products run in another order) no more rows over 1e-4 than
    ``PARENT_VISION_GAUSSIAN_OVER``. Timed: the kernel, lm_attention on the
    same inputs (held to the same gate), the plain version; one device
    kernel a call. Then the kernel at ``VISION_EDGES``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_attention import (
        fits_in_shared_memory,
        lm_attention,
        streaming_attention,
    )

    B, S, H, hd = 8, 197, 6, 64
    grid = lambda *shape: torch.randint(-3, 4, shape, generator=gen,  # noqa: E731
                                        device="cuda").float() * 0.25
    q, k = grid(B, S, H, hd), grid(B, S, H, hd)
    v = torch.randn((B, S, H, hd), generator=gen, device="cuda")
    want = ref.flash_attention_ref(q, k, v, causal=False, quant_bits=4)
    got = streaming_attention(q, k, v, quant_bits=4)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    err = max_err(got, want)
    qn, kn = (torch.randn((B, S, H, hd), generator=gen, device="cuda") for _ in "qk")
    diff = (streaming_attention(qn, kn, v, quant_bits=4)
            - ref.flash_attention_ref(qn, kn, v, causal=False, quant_bits=4)).abs().amax(-1)
    over, g_err = int((diff > 1e-4).sum()), float(diff.max())
    print(f"[kernels] attention, Gaussian q/k: rows over 1e-4: {over} of {diff.numel()} (max "
          f"err {g_err:.3g}); gate: <= {PARENT_VISION_GAUSSIAN_OVER}, the parent kernel's "
          "count on the same inputs", flush=True)
    if over > PARENT_VISION_GAUSSIAN_OVER:
        raise AssertionError(f"streaming_attention: {over} Gaussian rows over 1e-4, the parent "
                             f"kernel {PARENT_VISION_GAUSSIAN_OVER}")
    # the LM kernel computes the same case: held to the same gate and timed
    # on the same inputs
    lm = lm_attention(q, k, v, causal=False, quant_bits=4)
    torch.cuda.synchronize()
    torch.testing.assert_close(lm, want, atol=1e-5, rtol=1e-5)
    n = B * S * H * hd
    nb, by = bound_ms(4 * 4 * n, 2.0 * 2 * B * H * S * S * hd, F32_OPS_PER_S)
    vision = lambda: streaming_attention(q, k, v, quant_bits=4)  # noqa: E731
    lm_fn = lambda: lm_attention(q, k, v, causal=False, quant_bits=4)  # noqa: E731
    row = {
        "name": "streaming_attention", "shape": [B, S, H, hd], "quant_bits": 4,
        "max_abs_err": err, "tolerance": "atol=1e-5, rtol=1e-5 (exact-score inputs)",
        "device_kernels": _one_device_kernel("streaming_attention", vision),
        "ms": graph_ms(vision), "eager_ms": time_ms(vision),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=False,
                                                            quant_bits=4)),
        "bound_ms": nb, "bound_by": by, "library_ms": None,
        "lm_attention_ms": graph_ms(lm_fn), "lm_attention_eager_ms": time_ms(lm_fn),
        "lm_attention_max_abs_err": max_err(lm, want),
        "gaussian_rows_over": over, "gaussian_max_abs_err": g_err,
    }
    print(f"[kernels] vision attention {[B, S, H, hd]} qb4: streaming_attention "
          f"{row['ms']:.4f} ms (eager {row['eager_ms']:.4f}), lm_attention on the same inputs "
          f"{row['lm_attention_ms']:.4f} ms (eager {row['lm_attention_eager_ms']:.4f}), plain "
          f"{row['plain_ms']:.3f} ms, bound {nb:.5f} ms ({by}), max err {err:.3g}", flush=True)
    edge_err = 0.0
    for B_, Sq, Sk, H_, KVH, hd_, qb in VISION_EDGES:
        if not fits_in_shared_memory(Sk, hd_):
            raise AssertionError(f"VISION_EDGES: Sk={Sk}, hd={hd_} does not fit")
        q_, k_ = grid(B_, Sq, H_, hd_), grid(B_, Sk, KVH, hd_)
        v_ = torch.randn((B_, Sk, KVH, hd_), generator=gen, device="cuda")
        out = streaming_attention(q_, k_, v_, quant_bits=qb)
        ok = ref.flash_attention_ref(q_, k_, v_, causal=False, quant_bits=qb)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ok, atol=1e-5, rtol=1e-5)
        edge_err = max(edge_err, max_err(out, ok))
    row["edge_max_abs_err"] = edge_err
    print(f"[kernels] streaming_attention at {len(VISION_EDGES)} edge shapes "
          f"(B, Sq, Sk, H, KVH, hd, bits) {VISION_EDGES}: within 1e-5, max err "
          f"{edge_err:.3g}", flush=True)
    return row


# the scan's shapes beyond the falcon-mamba-7b prefill ([B, S, di, N],
# dtype of x, dt, B, C): state 8 (the smoke config's), the other state
# sizes at a small d_inner, bf16 operands at the path's shape and at a
# padded state, and a ragged d_inner with odd S (plain loads)
SCAN_SHAPES = ([(2, 100, 256, 8, torch.float32)]
               + [(2, 100, 256, n, torch.float32) for n in (4, 12, 32, 64)]
               + [(8, 256, 8192, 16, torch.bfloat16), (2, 100, 256, 12, torch.bfloat16),
                  (3, 37, 250, 5, torch.float32), (3, 37, 250, 5, torch.bfloat16)])
# the falcon-mamba-7b prefill shapes (B, S, dtype) at d_inner 8192, state
# 16: a grouped admission holds 1-8 prompts, so each of scan_layout's three
# layouts there ((4, 4) for B 1, (8, 2) for B 2-5 and 7, (16, 1) for B 6
# and 8) runs on the path; B 4 in bf16 too, and a ragged S = 200
SCAN_PATH = [(1, 256, torch.float32), (4, 256, torch.float32), (4, 256, torch.bfloat16),
             (8, 200, torch.float32), (8, 256, torch.float32)]
SCAN_TIMED = {1: "selective_scan[prefill_1x256]", 4: "selective_scan[prefill_4x256]",
              8: "selective_scan"}
# every (states a thread, lanes a channel) instantiation of the states
# variant, forced, at [2, 37, 256, N] for each padded state size: f32 at N
# = Np, bf16 at N = Np - 3 (padded states); and 16 states a thread with 2
# lanes as scan_layout picks it, at [8, 64, 8192, 32]
SCAN_LAYOUT_NP = (4, 8, 16, 32, 64, 128, 256, 512)
SCAN_WIDE = (8, 64, 8192, 32)


def _scan_operands(gen, B, S, di, N, dtype):
    """dt as the model makes it (softplus), A as Mamba initializes it
    (-(n + 1))."""
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    x, dt = randn(B, S, di), torch.nn.functional.softplus(randn(B, S, di))
    b, c = randn(B, S, N), randn(B, S, N)
    a = -torch.arange(1, N + 1, device="cuda", dtype=torch.float32).expand(di, N).contiguous()
    return (*(t.to(dtype) for t in (x, dt, b, c)), a, randn(di))


def _check_scan_once(args, variant=1, layout=None) -> float:
    """Gate one scan against its plain version: h_last bit-equal, y within
    atol = rtol = 1e-5 (f32; bf16 y is each side's f32 y rounded once to
    bf16, so it may differ by one bf16 step: rtol 2^-7). Returns y's max
    error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.selective_scan import selective_scan

    (y, h) = selective_scan(*args, variant=variant, layout=layout)
    yr, hr = ref.selective_scan_ref(*args)
    torch.cuda.synchronize()
    shape = list(args[0].shape) + [args[2].shape[-1]]
    if not torch.equal(h, hr):
        raise AssertionError(f"selective_scan {shape} {args[0].dtype} layout {layout}: h_last "
                             f"not bit-equal, max err {max_err(h, hr)}")
    rtol = 1e-5 if y.dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(y.float(), yr.float(), atol=1e-5, rtol=rtol)
    return max_err(y.float(), yr.float())


def _check_selective_scan(gen) -> list:
    """The scan at the falcon-mamba-7b prefill shapes ``SCAN_PATH``, then
    ``SCAN_SHAPES``, every layout of the states variant forced at
    ``SCAN_LAYOUT_NP`` and the wide layout at ``SCAN_WIDE``. Every call
    gated by ``_check_scan_once``, the lane variant (the first port's
    kernel) too where it takes the shape. Timed at B 1, 4 and 8 (device
    time, CUDA-graph replays): the states variant, the lane variant on the
    same inputs, the plain version; one device kernel a call. Then each
    layout at d_inner 8192, N 16 for B 1..8, beside ``scan_layout``'s pick.
    A row's ``max_abs_err`` is the f32 y error at its own shape; the bf16
    maximum over every bf16 call stands apart."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.selective_scan import (
        LANE_STATE_DIMS,
        scan_layout,
        scan_layouts,
        selective_scan,
    )

    di, N = 8192, 16
    rows, err, checked = [], {torch.float32: 0.0, torch.bfloat16: 0.0}, 0

    def check(args, variant=1, layout=None) -> float:
        nonlocal checked
        e = _check_scan_once(args, variant, layout)
        err[args[0].dtype] = max(err[args[0].dtype], e)
        checked += 1
        return e

    for B, S, dtype in SCAN_PATH:
        args = _scan_operands(gen, B, S, di, N, dtype)
        y_err = check(args)
        if dtype == torch.float32:
            check(args, variant=2)
        if S != 256 or dtype != torch.float32:
            continue
        nb, by = bound_ms(4 * (3 * B * S * di + 2 * B * S * N + di * N + di + B * di * N),
                          7.0 * B * S * di * N, F32_OPS_PER_S)
        states = lambda: selective_scan(*args)  # noqa: E731
        rows.append({
            "name": SCAN_TIMED[B], "shape": [B, S, di, N], "variant": "states",
            "layout": scan_layout(B, di, N), "max_abs_err": y_err,
            "tolerance": "h_last bit-equal; y atol=1e-5, rtol=1e-5",
            "device_kernels": _one_device_kernel("selective_scan", states),
            "ms": graph_ms(states, n=10), "eager_ms": time_ms(states),
            "lane_ms": graph_ms(lambda: selective_scan(*args, variant=2), n=10),
            "plain_ms": time_ms(lambda: ref.selective_scan_ref(*args), iters=3, warmup=1),
            "bound_ms": nb, "bound_by": by, "library_ms": None})
    for B, S, di_, N_, dtype in SCAN_SHAPES:
        args = _scan_operands(gen, B, S, di_, N_, dtype)
        check(args)
        if dtype == torch.float32 and N_ in LANE_STATE_DIMS:
            check(args, variant=2)
    forced = 0
    for Np in SCAN_LAYOUT_NP:
        for dtype, N_ in ((torch.float32, Np), (torch.bfloat16, max(1, Np - 3))):
            args = _scan_operands(gen, 2, 37, 256, N_, dtype)
            for layout in scan_layouts(N_):
                check(args, layout=layout)
                forced += 1
    B, S, di_, N_ = SCAN_WIDE
    if scan_layout(B, di_, N_) != (16, 2):
        raise AssertionError(f"SCAN_WIDE {SCAN_WIDE} no longer takes 16 states with 2 lanes")
    check(_scan_operands(gen, B, S, di_, N_, torch.float32))
    # each layout at the path's width for every group size an admission makes
    sweep = {}
    for B in range(1, 9):
        args = _scan_operands(gen, B, 256, di, N, torch.float32)
        times = {lay: graph_ms(lambda: selective_scan(*args, layout=lay), n=10)
                 for lay in scan_layouts(N)}
        pick = scan_layout(B, di, N)
        best = min(times, key=times.get)
        sweep[B] = {"ms": {f"{s}x{l}": t for (s, l), t in times.items()},
                    "picked": f"{pick[0]}x{pick[1]}", "fastest": f"{best[0]}x{best[1]}",
                    "picked_over_fastest": times[pick] / times[best]}
        print(f"[kernels] selective_scan layouts at [{B}, 256, {di}, {N}] (states a thread x "
              f"lanes): " + ", ".join(f"{k} {v:.4f} ms" for k, v in sweep[B]["ms"].items())
              + f"; scan_layout picks {sweep[B]['picked']}, fastest {sweep[B]['fastest']} "
              f"(picked / fastest {sweep[B]['picked_over_fastest']:.3f})", flush=True)
    for row in rows:
        row["bf16_max_abs_err"] = err[torch.bfloat16]
        row["bf16_tolerance"] = "h_last bit-equal; y atol=1e-5, rtol=2^-7 (one bf16 step)"
        row["layout_sweep"] = sweep
        print(f"[kernels] selective_scan {row['shape']} (states a thread, lanes a channel "
              f"{row['layout']}): states {row['ms']:.4f} ms (eager {row['eager_ms']:.4f}), "
              f"lane (the first port's kernel, same inputs) {row['lane_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.2f} ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}), "
              f"f32 y max err {row['max_abs_err']:.3g}", flush=True)
    print(f"[kernels] selective_scan: {checked} calls ({forced} with a forced layout, every "
          f"layout of N {SCAN_LAYOUT_NP} in f32 and bf16), h_last bit-equal (gate), y max err "
          f"f32 {err[torch.float32]:.3g}, bf16 {err[torch.bfloat16]:.3g}", flush=True)
    return rows


# RMSNorm at the path's widths (label, rows, D): OLMoE-1B-7B ln1/ln2/final
# at a 512-token prefill and an 8-slot tick, its q/k norms over head dim
# 128 (prefill: 512 tokens x 16 heads), falcon-mamba-7b's ln at an 8 x 256
# grouped prefill and a tick; then edges: D % 4 != 0 (single loads), D = 1,
# D past a multiple of 128
RMS_SHAPES = [("olmoe_ln_prefill", 512, 2048), ("olmoe_ln_decode", 8, 2048),
              ("olmoe_qk_prefill", 8192, 128), ("olmoe_qk_decode", 128, 128),
              ("mamba_ln_prefill", 2048, 4096), ("mamba_ln_decode", 8, 4096)]
RMS_EDGES = [(7, 100), (5, 1), (3, 4100), (9, 6)]


def _check_rmsnorm(gen) -> dict:
    """RMSNorm against its plain version at ``RMS_SHAPES`` and
    ``RMS_EDGES``: f32 x within atol = rtol = 1e-5, bf16 x within one bf16
    step (rtol 2^-7: each side rounds its f32 y once), a bf16 gamma, a
    misaligned x (single loads) and a strided view read in place (one
    device kernel); the first 8 rows alone bit-equal to the
    same rows inside the whole tensor at every path shape (gate). Timed at
    each path shape (device time, CUDA-graph replays) beside the plain
    version and ``torch.nn.functional.rms_norm`` with weight 1 + gamma (the
    one PyTorch call that computes the same function). One device kernel a
    call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.norm import rmsnorm

    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    err, timings = {torch.float32: 0.0, torch.bfloat16: 0.0}, []
    for label, R, D in RMS_SHAPES + [(None, r, d) for r, d in RMS_EDGES]:
        x, gamma = randn(R, D), 0.1 * randn(D)
        for xt, gt in ((x, gamma), (x.bfloat16(), gamma), (x, gamma.bfloat16())):
            got, want = rmsnorm(xt, gt), ref.rmsnorm_ref(xt, gt)
            torch.cuda.synchronize()
            rtol = 1e-5 if xt.dtype == torch.float32 else 2.0**-7
            torch.testing.assert_close(got.float(), want.float(), atol=1e-5, rtol=rtol)
            e = max_err(got.float(), want.float())
            err[xt.dtype] = max(err[xt.dtype], e)
            if xt is x and gt is gamma:
                f32_err = e
        if label is None:
            continue
        if R > LM_SLOTS and not torch.equal(rmsnorm(x[:LM_SLOTS], gamma),
                                            rmsnorm(x, gamma)[:LM_SLOTS]):
            raise AssertionError(f"rmsnorm {[R, D]}: {LM_SLOTS} rows alone differ from the "
                                 "same rows in the whole tensor")
        w1 = 1.0 + gamma
        fn = lambda: rmsnorm(x, gamma)  # noqa: E731
        nb, by = bound_ms(4 * (2 * R * D + D), 4.0 * R * D, F32_OPS_PER_S)
        timings.append({
            "label": label, "shape": [R, D], "device_kernels": _one_device_kernel("rmsnorm", fn),
            "max_abs_err": f32_err, "ms": graph_ms(fn), "eager_ms": time_ms(fn),
            "plain_ms": graph_ms(lambda: ref.rmsnorm_ref(x, gamma)),
            "library_ms": graph_ms(lambda: torch.nn.functional.rms_norm(x, (D,), w1, 1e-6)),
            "bound_ms": nb, "bound_by": by})
        t = timings[-1]
        print(f"[kernels] rmsnorm {label} {[R, D]}: {t['ms']:.4f} ms (eager {t['eager_ms']:.4f}), "
              f"plain {t['plain_ms']:.4f} ms, F.rms_norm {t['library_ms']:.4f} ms, bound "
              f"{nb:.5f} ms ({by})", flush=True)
    # a misaligned x: rows of 2048 starting one element past a 16-byte boundary
    x = torch.empty(LM_MAX_LEN * 2048 + 1, device="cuda")[1:].view(LM_MAX_LEN, 2048)
    x.copy_(randn(LM_MAX_LEN, 2048))
    gamma = 0.1 * randn(2048)
    torch.testing.assert_close(rmsnorm(x, gamma), ref.rmsnorm_ref(x, gamma), atol=1e-5,
                               rtol=1e-5)
    # the falcon-mamba prefill's final norm: the last position of 8 x 256
    # rows, a strided view read in place (one device kernel, no copy)
    last = randn(8, 256, 4096)[:, -1:, :]
    gamma = 0.1 * randn(4096)
    torch.testing.assert_close(rmsnorm(last, gamma), ref.rmsnorm_ref(last, gamma), atol=1e-5,
                               rtol=1e-5)
    _one_device_kernel("rmsnorm (strided rows)", lambda: rmsnorm(last, gamma))
    print(f"[kernels] rmsnorm: f32 / bf16 x / bf16 gamma at {len(RMS_SHAPES) + len(RMS_EDGES)} "
          f"shapes, a misaligned x and strided rows within tolerance (max err: f32 x "
          f"{err[torch.float32]:.3g}, bf16 x {err[torch.bfloat16]:.3g}); {LM_SLOTS} rows alone "
          "bit-equal to the same rows in the whole tensor at every path shape (gate)", flush=True)
    main = timings[0]
    return {"name": "rmsnorm", "tolerance": "f32 atol=1e-5, rtol=1e-5",
            "bf16_max_abs_err": err[torch.bfloat16],
            "bf16_tolerance": "bf16 x atol=1e-5, rtol=2^-7 (one bf16 step)", "more": timings[1:],
            **{k: main[k] for k in ("shape", "max_abs_err", "device_kernels", "ms", "eager_ms",
                                    "plain_ms", "library_ms", "bound_ms", "bound_by")}}


def _wgrad_sizes(T: int, G: int) -> torch.Tensor:
    """M3ViT-S's routed rows over its experts: random loads, expert
    ``WGRAD_EMPTY`` with none, expert ``WGRAD_SKEWED`` with ~5x the mean."""
    rng = np.random.default_rng(11)
    share = rng.uniform(0.5, 1.5, G)
    share[WGRAD_EMPTY], share[WGRAD_SKEWED] = 0.0, 5.0
    sizes = np.floor(T * share / share.sum()).astype(np.int64)
    sizes[0] += T - sizes.sum()
    return torch.tensor(sizes, dtype=torch.int32, device="cuda")


def _library_ms(fn, want: torch.Tensor):
    """Device time of one PyTorch library call (a yardstick the port never
    calls) and its largest error against ``want``: (ms, None, err, wall),
    or (None, the message, None, None) where the card's torch refuses the
    operands. Graph replays where the call can be captured (wall None);
    where it cannot (a call that copies host data, as torch's per-group
    fallback of ``_grouped_mm`` does), the device time of its eager calls
    in a ``torch.profiler`` trace (``_eager_device_ms``), and as ``wall``
    CUDA events over the eager calls, host gaps included."""
    try:
        got = fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError, ValueError) as e:
        return None, f"{type(e).__name__}: {str(e).strip().splitlines()[0][:240]}", None, None
    err = max_err(got.float(), want)
    del got
    try:
        return graph_ms(fn), None, err, None
    except RuntimeError as e:
        print(f"[kernels] library call not capturable ({str(e).splitlines()[0][:120]}): "
              "device time from a profiler trace of eager calls", flush=True)
        torch.cuda.synchronize()
        return _eager_device_ms(fn), None, err, time_ms(fn, iters=10)


def _eager_device_ms(fn, n: int = 10) -> float:
    """Device time per eager call of ``fn``: every kernel and copy it put on
    the device in a ``torch.profiler`` trace of ``n`` calls (after one
    warm-up call), summed, over ``n``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.device_time for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation)
    if us <= 0:
        raise AssertionError("the profiler saw no device time of the library call")
    return us / n / 1e3


def _group_ends(sizes: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(sizes, 0, dtype=torch.int32)


def _wgrad_timing(label, x, dy, sizes, path: bool = False) -> dict:
    """The weight-gradient kernel in each variant that takes the shape
    against its plain version (f32, and f64 for the error), each variant's
    two calls bit-equal and empty groups zero; timed (``graph_ms``) beside
    the plain per-group loop and ``torch._grouped_mm(x.t(), dy, offs=ends)``
    (``_library_ms``); bounded at 2 T Din Dout operations at the rate of the
    chosen variant's arithmetic (mma: three dense tf32 passes; fma: f32
    FMAs; the f32 FMA bound beside it as ``bound_f32_ms``), each input read
    once and dw written once. With
    ``path`` (the training shapes) the rule must pick variant 1, and its
    error against f64 must be no larger than variant 2's."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_linear import (
        WGRAD_VARIANTS, choose_wgrad_variant, grouped_wgrad, wgrad_order, wgrad_takes)

    T, Din = x.shape
    G, Dout = sizes.shape[0], dy.shape[1]
    want = ref.grouped_wgrad_ref(x, dy, sizes)
    want64 = ref.grouped_wgrad_ref(x.double(), dy.double(), sizes)
    chosen = choose_wgrad_variant(Din, Dout)
    if path and WGRAD_VARIANTS[chosen] != "mma":
        raise AssertionError(f"grouped_wgrad {label}: the rule picks {WGRAD_VARIANTS[chosen]}")
    row = {"label": label, "shape": [T, G, Din, Dout], "variant": WGRAD_VARIANTS[chosen],
           "order": wgrad_order(sizes.tolist()),
           "plain_f64_max_abs_err": max_err(want.double(), want64)}
    for v, name in WGRAD_VARIANTS.items():
        if not wgrad_takes(v, Din, Dout):
            continue
        got = grouped_wgrad(x, dy, sizes, variant=v)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4, msg=lambda m: (
            f"grouped_wgrad {name} {label} T={T} G={G} {Din}x{Dout}: {m}"))
        for g in range(G):
            if int(sizes[g]) == 0 and bool(got[g].any()):
                raise AssertionError(f"grouped_wgrad {name} {label}: empty group {g} is not zero")
        if not torch.equal(got, grouped_wgrad(x, dy, sizes, variant=v)):
            raise AssertionError(f"grouped_wgrad {name} {label}: two calls differ")
        prefix = "" if v == chosen else f"{name}_"
        row[f"{prefix}max_abs_err"] = max_err(got, want)
        row[f"{prefix}f64_max_abs_err"] = max_err(got.double(), want64)
        if T:
            _one_device_kernel(f"grouped_wgrad {name} {label}",
                               lambda: grouped_wgrad(x, dy, sizes, variant=v))
            row[f"{prefix}ms"] = graph_ms(lambda: grouped_wgrad(x, dy, sizes, variant=v))
        del got
    if path and row["f64_max_abs_err"] > row["fma_f64_max_abs_err"]:
        raise AssertionError(f"grouped_wgrad {label}: mma's error against f64 "
                             f"{row['f64_max_abs_err']:.3g} exceeds fma's "
                             f"{row['fma_f64_max_abs_err']:.3g}")
    if not T:
        return row
    n_bytes = 4 * (T * Din + T * Dout + G * Din * Dout)
    nf, byf = bound_ms(n_bytes, 2.0 * T * Din * Dout, F32_OPS_PER_S)
    nb, by = (bound_ms(n_bytes, 3 * 2.0 * T * Din * Dout, TF32_OPS_PER_S) if chosen == 1
              else (nf, byf))
    ends = _group_ends(sizes)
    lib_ms, lib_note, lib_err, lib_wall = _library_ms(
        lambda: torch._grouped_mm(x.t(), dy, offs=ends), want)
    row.update(plain_ms=time_ms(lambda: ref.grouped_wgrad_ref(x, dy, sizes), iters=5),
               library_ms=lib_ms, library_wall_ms=lib_wall,
               library_call="torch._grouped_mm(x.t(), dy, offs=ends)",
               library_max_abs_err=lib_err, bound_ms=nb, bound_by=by, bound_f32_ms=nf,
               bound_f32_by=byf)
    if lib_note:
        row["library_refused"] = lib_note
    lib = (f"{lib_ms:.4f} ms device (wall {_fmt_ms(lib_wall)}, max err {lib_err:.3g})"
           if lib_ms is not None else f"refused ({lib_note})")
    was = (f", fma (was) {row['fma_ms']:.4f} ms (vs f64 {row['fma_f64_max_abs_err']:.3g})"
           if "fma_ms" in row else "")
    print(f"[kernels] grouped_wgrad {label} {row['shape']}: {row['variant']} {row['ms']:.4f} "
          f"ms{was}; plain {row['plain_ms']:.3f} ms, torch._grouped_mm {lib}; bound "
          f"{nb:.5f} ms ({by}, {'3xTF32' if chosen == 1 else 'f32 FMA'}), f32 FMA bound "
          f"{nf:.5f} ms ({byf}); max err {row['max_abs_err']:.3g} (vs f64: kernel "
          f"{row['f64_max_abs_err']:.3g}, plain f32 {row['plain_f64_max_abs_err']:.3g})",
          flush=True)
    return row


def _check_grouped_training(gen) -> list:
    """The backward of the expert linears at M3ViT-S's training shapes
    (``WGRAD_T`` routed rows over 16 experts, one empty, one skewed): the
    weight-gradient kernel for fc1 (x [T, 384], dy [T, 1536]) and fc2 (x
    [T, 1536], dy [T, 384]) and at ``WGRAD_RAGGED``; the f32 grouped kernel
    at the dx shapes (dy against the transposed stacks), every variant
    within 1e-5 (``_check_grouped_f32``), timed in the one the rule picks."""
    sizes = _wgrad_sizes(WGRAD_T, WGRAD_G)
    rows, dx = {}, {}
    checked: dict = {}
    for label, Din, Dout in (("m3vit_fc1", 384, 1536), ("m3vit_fc2", 1536, 384)):
        x = torch.randn((WGRAD_T, Din), generator=gen, device="cuda")
        dy = torch.randn((WGRAD_T, Dout), generator=gen, device="cuda") / math.sqrt(WGRAD_T)
        rows[label] = _wgrad_timing(label, x, dy, sizes, path=True)
        w_t = (torch.randn((WGRAD_G, Din, Dout), generator=gen, device="cuda")
               / math.sqrt(Din)).transpose(1, 2).contiguous()
        err = _check_grouped_f32(dy * math.sqrt(WGRAD_T), w_t, sizes, checked)
        dx[label] = dict(_grouped_timing(f"{label}_dx", dy * math.sqrt(WGRAD_T), w_t, sizes),
                         max_abs_err=err)
        del x, dy, w_t
    ragged = [_wgrad_timing(f"ragged_{T}x{G}x{Din}x{Dout}",
                            torch.randn((T, Din), generator=gen, device="cuda"),
                            torch.randn((T, Dout), generator=gen, device="cuda"),
                            _routing(gen, T, G) if T else
                            torch.zeros(G, dtype=torch.int32, device="cuda"))
              for T, G, Din, Dout in WGRAD_RAGGED]
    fc1 = rows["m3vit_fc1"]
    wgrad_row = {"name": "grouped_wgrad", "mode": "f32",
                 "tolerance": "atol=1e-4, rtol=1e-4 in each variant; empty group zero; two "
                              "calls bit-equal; at the path's shapes mma's error against f64 "
                              "no larger than fma's",
                 **fc1, "fc2": rows["m3vit_fc2"], "ragged": ragged}
    dx_row = {"name": "grouped_matmul_f32[dx]", "mode": "f32",
              "tolerance": "atol=1e-5, rtol=1e-5; mma and stream bit-equal",
              **dx["m3vit_fc1"], "fc2": dx["m3vit_fc2"], "checked": checked}
    return [wgrad_row, dx_row]


def phase_kernels() -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [_check_int8_matmul(gen), *_check_grouped_matmul(gen), _check_attention(gen),
            _check_grouped_w4a8(gen),
            *_check_lm_attention(torch.Generator(device="cuda").manual_seed(LM_ATTENTION_SEED)),
            *_check_lm_attention_families(
                torch.Generator(device="cuda").manual_seed(FAMILY_ATTENTION_SEED)),
            *_check_selective_scan(gen), _check_rmsnorm(gen),
            *_check_grouped_training(torch.Generator(device="cuda").manual_seed(WGRAD_SEED))]
    for row in rows:
        row["route"] = "cuda"
        base = row["name"].split("[")[0].removesuffix("_f32").removesuffix("_w4a8")
        row["source"], row["replaces"] = SOURCES[base], REPLACES[base]
        emit({"kernel": row})
    return rows


def _counters():
    from repro_torch.kernels.expert_linear import grouped_matmul
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels.norm import rmsnorm
    from repro_torch.kernels.quant_attention import lm_attention, streaming_attention
    from repro_torch.kernels.selective_scan import selective_scan

    return {"int8_matmul": int8_matmul, "grouped_matmul": grouped_matmul,
            "streaming_attention": streaming_attention, "lm_attention": lm_attention,
            "selective_scan": selective_scan, "rmsnorm": rmsnorm}


def _reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_mode"):
            fn.launches_by_mode = {}


def _read_counts() -> dict:
    """Launch counts per wrapper, and per mode as ``"<wrapper>:<mode>"``."""
    torch.cuda.synchronize()
    out = {}
    for name, fn in _counters().items():
        out[name] = fn.launches
        for mode, n in getattr(fn, "launches_by_mode", {}).items():
            out[f"{name}:{mode}"] = n
    return out


def _check_int8_variants(tag: str, counts: dict) -> None:
    """Every int8_matmul call of a serving run went through variant 1 (mma)
    or 2 (stream), read from the wrapper's per-variant counters."""
    fast = counts.get("int8_matmul:mma", 0) + counts.get("int8_matmul:stream", 0)
    print(f"[{tag}] int8_matmul launches by variant: mma "
          f"{counts.get('int8_matmul:mma', 0)}, stream {counts.get('int8_matmul:stream', 0)}, "
          f"dp4a {counts.get('int8_matmul:dp4a', 0)} (gate: dp4a 0)", flush=True)
    if fast != counts["int8_matmul"] or counts.get("int8_matmul:dp4a", 0):
        raise AssertionError(f"[{tag}] int8_matmul calls off variants 1 and 2: {counts}")


def _check_grouped_variants_used(tag: str, counts: dict) -> None:
    """Every integer grouped_matmul call of a serving run went through
    variant 1 (mma) or 2 (stream), read from the wrapper's counters."""
    by = {v: sum(n for k, n in counts.items() if k.startswith("grouped_matmul:")
                 and k.endswith("/" + v)) for v in ("mma", "stream", "dp4a")}
    integer = counts.get("grouped_matmul:int8", 0) + counts.get("grouped_matmul:w4a8", 0)
    print(f"[{tag}] grouped_matmul integer launches by variant: {by} (gate: dp4a 0)",
          flush=True)
    if by["dp4a"] or by["mma"] + by["stream"] != integer:
        raise AssertionError(f"[{tag}] grouped calls off variants 1 and 2: {counts}")


def phase_serving(smi: str):
    from repro_torch.configs.moe_vit import CONFIG
    from repro_torch.core.quant.ptq import calibrate_model, ptq_model, quantized_config
    from repro_torch.models import init_model_params, synth_patches, tree_bytes
    from repro_torch.serving import VisionEngine, synth_requests

    cfg = CONFIG
    t0 = time.perf_counter()
    params = init_model_params(cfg, seed=0, device="cuda")
    calib = [torch.from_numpy(synth_patches(cfg, 2, seed=s)).cuda() for s in (1, 2)]
    _reset_counts()
    taps = calibrate_model(cfg, params, calib)
    calib_counts = _read_counts()
    qcfg = quantized_config(cfg)
    p_int8 = ptq_model(qcfg, params, taps, materialize="int8")
    torch.cuda.synchronize()
    print(f"[serving] {cfg.name}: fp {tree_bytes(params) / 1e6:.1f} MB -> int8 "
          f"{tree_bytes(p_int8) / 1e6:.1f} MB, init+calibrate+PTQ "
          f"{time.perf_counter() - t0:.1f} s, calibration launches {calib_counts}",
          flush=True)
    if calib_counts["grouped_matmul"] != 2 * PER_FORWARD["grouped_matmul"] \
            or calib_counts["streaming_attention"] != 2 * PER_FORWARD["streaming_attention"]:
        raise AssertionError(f"calibration launches {calib_counts}")
    del params

    eng = VisionEngine(qcfg, p_int8, batch_buckets=(1, 4, 8), max_wait_s=2e-3,
                       device="cuda")
    warm = _warm("serving", eng)
    _check_programs("serving", eng, PER_FORWARD)
    reqs = synth_requests(qcfg, 24, seed=3)
    _reset_counts()
    for r in reqs:
        eng.submit(r)
        eng.step()
    eng.flush()
    counts = _read_counts()
    batches = eng.metrics.counters["batches"]
    for r in reqs:
        assert r.done and r.classes.shape == (5,), r.uid
        assert ((r.classes >= 0) & (r.classes < cfg.num_classes)).all(), r.uid
        assert np.isfinite(r.probs).all() and (np.diff(r.probs) <= 0).all(), r.uid
    for name, per in PER_FORWARD.items():
        if counts[name] != per * batches:
            raise AssertionError(f"{name}: {counts[name]} launches for {batches} "
                                 f"batches, expected {per} per forward")
    _check_int8_variants("serving", counts)
    _check_grouped_variants_used("serving", counts)
    _check_retraces("serving", eng)
    snap = eng.metrics.snapshot()
    lat = snap["latency_ms"]
    print(f"[serving] smoke figure, not a benchmark: {snap['counters']['completed']} "
          f"requests in {batches} batches, {snap['fps']:.1f} FPS, p50 "
          f"{lat['p50']:.2f} ms, p99 {lat['p99']:.2f} ms ({smi}); launches {counts}",
          flush=True)
    # the graph engine against the eager switch: the same 24 requests in the
    # same batches (all queued, then flushed: three of 8) on each
    eager = VisionEngine(_eager(qcfg), p_int8, batch_buckets=(1, 4, 8), max_wait_s=2e-3,
                         device="cuda")
    _warm("serving eager", eager)
    served = {}
    for mode, e in (("graph", eng), ("eager", eager)):
        served[mode] = synth_requests(qcfg, 24, seed=3)
        for r in served[mode]:
            e.submit(r)
        e.flush()
    same = all(np.array_equal(a.classes, b.classes) and np.array_equal(a.probs, b.probs)
               for a, b in zip(served["graph"], served["eager"]))
    print(f"[serving] graph engine vs aot_warmup=False engine, 24 requests in batches of 8: "
          f"classes and probabilities bit-equal {same} (gate)", flush=True)
    if not same:
        raise AssertionError("[serving] the graph engine and the eager engine disagree")
    _check_retraces("serving", eng)
    return qcfg, p_int8, counts, calib_counts, {"graph": eng, "eager": eager, "warmup": warm}


def _olmoe_trees():
    """Full-width OLMoE-1B-7B: the fp tree (seed 0), calibrated on two
    synthetic batches (gate: the calibration's launches), and its int8 and
    W4A8 trees. Returns (cfg, fp params, qcfg, trees, calibration counts)."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant.ptq import calibrate_model, ptq_model, quantized_config
    from repro_torch.models import init_model_params, synth_batch
    from repro_torch.serving import serving_config

    cfg = serving_config(get_config("olmoe-1b-7b"))
    params = init_model_params(cfg, seed=0, device="cuda")
    calib = [torch.from_numpy(synth_batch(cfg, 2, 32, seed=s)).cuda() for s in (1, 2)]
    _reset_counts()
    taps = calibrate_model(cfg, params, calib)
    calib_counts = _read_counts()
    want = {"lm_attention:causal/float32/qb0": 2 * 16, "grouped_matmul:f32": 2 * 32,
            "int8_matmul": 0}
    if any(calib_counts.get(k, 0) != n for k, n in want.items()):
        raise AssertionError(f"calibration launches {calib_counts}, expected {want}")
    qcfg = quantized_config(cfg)
    trees = {m: ptq_model(qcfg, params, taps, materialize=m) for m in ("int8", "int4")}
    return cfg, params, qcfg, trees, calib_counts


def phase_lm(smi: str) -> dict:
    """Full-width OLMoE-1B-7B served from its int8 and W4A8 trees."""
    from repro_torch.models import tree_bytes

    t0 = time.perf_counter()
    cfg, params, qcfg, trees, calib_counts = _olmoe_trees()
    fp_bytes = tree_bytes(params)
    out = {"calib_counts": calib_counts, "runs": {"fp": _serve_lm_fp(cfg, params, smi)}}
    out["gshard"] = _timed(phase_ep_gshard, cfg, params, smi)
    # the autotune phase's LM part: one table for its engines, in a fresh
    # directory outside the checkout; the fp tree's tuned engine while the
    # tree lives (timed without the profiler: the observe gate below reads
    # the profiler's history), the other trees' after the EP part
    tune_dir = tempfile.mkdtemp(prefix="autotune-lm-")
    try:
        out["autotune"] = {"fp": _timed(phase_autotune_lm_fp, cfg, params, out["runs"]["fp"],
                                        tune_dir, smi)}
        del params
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        print(f"[lm] {cfg.name}: fp {fp_bytes / 1e9:.2f} GB -> int8 "
              f"{tree_bytes(trees['int8']) / 1e9:.2f} GB, W4A8 "
              f"{tree_bytes(trees['int4']) / 1e9:.2f} GB; init+calibrate+PTQ "
              f"{time.perf_counter() - t0:.1f} s; calibration launches {calib_counts}",
              flush=True)
        _check_combine_invariance(qcfg)
        for mat, tree in trees.items():
            out["runs"][mat] = _serve_lm(qcfg, tree, mat, smi)
        out["cluster"] = phase_cluster_lm(qcfg, trees["int8"], out["runs"]["int8"], smi)
        out["observe"] = _timed(phase_observe_lm, qcfg, trees["int8"], out["runs"]["int8"],
                                smi)
        out["ep"] = _timed(phase_ep_lm, qcfg, trees, out["runs"]["int8"], smi)
        out["autotune"].update(_timed(phase_autotune_lm, qcfg, trees, out["runs"], tune_dir,
                                      smi))
        out["autotune"]["ep"] = _timed(phase_autotune_lm_ep, qcfg, trees, out["runs"], out["ep"],
                                       tune_dir, smi)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)
    return out


def _serve_lm_fp(cfg, params, smi: str) -> dict:
    """The fp tree served as ``launch/serve.py`` serves it without
    ``--quantized``: ``ServeEngine(serving_config(cfg), params,
    batch_slots=8, max_len=512)``, f32 weights, the bf16 K/V cache,
    ``quant_bits=0``, packed admission; every expert linear through the f32
    mode of ``grouped_matmul``. Gates: exact launches per admission and per
    tick (``LM_FP_PER_FORWARD``, the grouped calls all f32 on the variant
    ``choose_variant`` picks: stream in a tick, mma in an admission),
    ``retraces`` 0, every request completes; teacher-forced against
    ``prefill`` over every prefix, the served engine within
    ``LM_FP_TF_LIMITS`` and the same engine with an f32 K/V cache (the
    control) with every token within ``LM_FP_TF_TOL`` of the argmax; the
    ``aot_warmup=False`` engine's tokens and logits bit-equal. Printed:
    step 0 against ``prefill`` of the prompt alone. Then a tick and a
    512-token admission profiled, eager and as graph replays, and the
    engines freed."""
    from repro_torch.kernels.expert_linear import F32_VARIANTS, choose_variant
    from repro_torch.models import transformer

    tag = "lm fp"
    eng, reqs, wall, counts, warm = _run_engine(cfg, params, tag=tag)
    programs = _check_programs(tag, eng, LM_FP_PER_FORWARD)
    _check_retraces(tag, eng)
    snap = eng.metrics.snapshot()
    c = snap["counters"]
    admissions, ticks = c["prefill_batches"], c["decode_ticks"]
    for name, per in LM_FP_PER_FORWARD.items():
        if counts[name] != per * (admissions + ticks):
            raise AssertionError(f"[{tag}] {name}: {counts[name]} launches for {admissions} "
                                 f"admissions + {ticks} ticks, expected {per} per forward")
    E, k, d = cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model
    tick_v = F32_VARIANTS[choose_variant(LM_SLOTS * k, E, d, d, f32=True)]
    admit_v = F32_VARIANTS[choose_variant(32 * k, E, d, d, f32=True)]  # the smallest bucket
    per = LM_FP_PER_FORWARD["grouped_matmul"]
    want = {"grouped_matmul:f32": counts["grouped_matmul"]}
    want[f"grouped_matmul:f32/{tick_v}"] = per * ticks
    want[f"grouped_matmul:f32/{admit_v}"] = want.get(f"grouped_matmul:f32/{admit_v}", 0) \
        + per * admissions
    got = {key: counts.get(key, 0) for key in want}
    print(f"[{tag}] grouped_matmul launches by mode and variant {got} (gate: all f32, "
          f"{tick_v} in a tick, {admit_v} in an admission)", flush=True)
    if got != want or counts["grouped_matmul"] != sum(
            n for key, n in counts.items() if key.startswith("grouped_matmul:f32/")):
        raise AssertionError(f"[{tag}] grouped launches {counts}, expected {want}")
    for r in reqs:
        if r.status != "completed" or len(r.generated) != LM_NEW_TOKENS:
            raise AssertionError(f"[{tag}] request {r.uid}: {r.status}, "
                                 f"{len(r.generated)} tokens")
    tokens = sum(len(r.generated) for r in reqs)
    lat = snap["latency_ms"]
    replay_ms = _lm_step_ms(eng)  # on the state serving left, as the tuned engine's
    print(f"[{tag}] smoke figure, not a benchmark ({smi}): {len(reqs)} requests, {tokens} "
          f"tokens in {wall:.2f} s = {tokens / wall:.1f} tok/s; latency p50 {lat['p50']:.1f} "
          f"ms, p99 {lat['p99']:.1f} ms; {admissions} admissions ({c['pack_real_tokens']} real "
          f"+ {c['pack_pad_tokens']} pad tokens), {ticks} ticks; launches {counts}", flush=True)

    # teacher-forced, every token of every request against prefill over its
    # prefix, the served engine (bf16 K/V cache) and the same engine with an
    # f32 cache (the control: prefill's own K/V precision)
    tf = _fp_teacher_forced(params, cfg, reqs, tag)
    with _f32_kv_cache():
        ctl_reqs = _run_engine(cfg, params, tag=f"{tag} f32 cache")[1]
    ctl = _fp_teacher_forced(params, cfg, ctl_reqs, f"{tag} f32 cache")
    median, p90, far = LM_FP_TF_LIMITS
    print(f"[{tag}] gates: served engine median <= {median}, p90 <= {p90}, tokens more "
          f"than {LM_FP_TF_TOL} below prefill's argmax <= {far}; f32-cache control: every "
          f"token within {LM_FP_TF_TOL} of the argmax, median <= {LM_FP_CTL_MEDIAN}",
          flush=True)
    if not (tf["median"] <= median and tf["p90"] <= p90 and tf["far"] <= far):
        raise AssertionError(f"[{tag}] teacher-forced logits disagree with prefill")
    if ctl["gap_max"] > LM_FP_TF_TOL or ctl["median"] > LM_FP_CTL_MEDIAN:
        raise AssertionError(f"[{tag}] f32-cache control: an emitted token is "
                             f"{ctl['gap_max']:.3g} below prefill's argmax, median "
                             f"{ctl['median']:.3g}")
    del ctl_reqs

    eager, reqs_e, wall_e, _, _ = _run_engine(cfg, params, tag=f"{tag} eager", eager=True)
    same = all(a.generated == b.generated and all(
        torch.equal(x, y) for x, y in zip(a.step_logits, b.step_logits))
        for a, b in zip(reqs, reqs_e))
    print(f"[{tag}] graph vs aot_warmup=False engine: tokens and logits bit-equal: {same} "
          f"(gate); the same requests in {wall:.2f} s through the graphs, {wall_e:.2f} s "
          f"eager", flush=True)
    if not same:
        raise AssertionError(f"[{tag}] graph vs aot_warmup=False engine: tokens or logits "
                             "differ")
    del reqs_e
    profile = _profile_lm(eng, eager, "fp", smi, LM_FP_PER_FORWARD)
    per_call = {}
    for label, fam, n in (("decode tick", "grouped_matmul", per),
                          ("packed prefill 512", "grouped_matmul", per),
                          ("decode tick", "lm_attention", LM_FP_PER_FORWARD["lm_attention"]),
                          ("packed prefill 512", "lm_attention",
                           LM_FP_PER_FORWARD["lm_attention"])):
        for mode in ("eager", "graph"):
            per_call[f"{fam} a call, {label}, {mode}"] = profile[f"{label}, {mode}"][
                f"{fam}_ms"] / n
    print(f"[{tag}] device ms a call on the path ({smi}): "
          + ", ".join(f"{key} {ms:.4f}" for key, ms in per_call.items()), flush=True)
    del eng, eager
    torch.cuda.empty_cache()
    return {"counts": counts, "counters": c, "tok_s": tokens / wall, "latency_ms": lat,
            "tokens": [list(r.generated) for r in reqs],
            "tok_s_eager": tokens / wall_e, "warmup": warm, "programs": programs,
            "tf": tf, "tf_f32_cache": ctl, "profile": profile, "per_call_ms": per_call,
            "replay_ms": replay_ms}


@contextlib.contextmanager
def _f32_kv_cache():
    """Engines built inside keep an f32 K/V cache (``init_cache``'s default
    dtype taken as f32): the fp control of ``_serve_lm_fp``."""
    from repro_torch.models import transformer

    init = transformer.init_cache
    transformer.init_cache = functools.partial(init, dtype=torch.float32)
    try:
        yield
    finally:
        transformer.init_cache = init


def _fp_teacher_forced(params, cfg, reqs, tag: str) -> dict:
    """Every emitted token of every request against ``prefill`` over its
    prefix: per step the relative logit error max |engine - prefill| / max
    |prefill| and the gap prefill.max() - prefill[token]; step 0 against
    ``prefill`` of the prompt alone, bit for bit (a reading)."""
    from repro_torch.models import transformer

    t0 = time.perf_counter()
    rel, gaps, step0, off = [], [], 0, []
    with torch.inference_mode():
        for r in reqs:
            toks = list(map(int, r.prompt))
            for t, tok in enumerate(r.generated):
                ref = transformer.prefill(params, cfg, torch.tensor([toks], device="cuda"))[0][0, -1]
                got = r.step_logits[t]
                rel.append(float((got - ref).abs().max() / ref.abs().max()))
                gaps.append(float(ref.max() - ref[tok]))
                step0 += t == 0 and torch.equal(got, ref)
                if gaps[-1] > 0:
                    off.append((r.uid, t, round(gaps[-1], 4)))
                toks.append(tok)
    rel, gaps = np.asarray(rel), np.asarray(gaps)
    out = {"median": float(np.median(rel)), "p90": float(np.quantile(rel, 0.9)),
           "max": float(rel.max()), "gap_max": float(gaps.max()),
           "far": int((gaps > LM_FP_TF_TOL).sum()), "off": len(off), "steps": int(rel.size),
           "step0_equal": int(step0)}
    print(f"[{tag}] teacher-forced vs prefill, {rel.size} steps ({time.perf_counter() - t0:.1f}"
          f" s): relative logit error median {out['median']:.3g}, p90 {out['p90']:.3g}, max "
          f"{out['max']:.3g}; tokens below prefill's argmax {len(off)} (more than "
          f"{LM_FP_TF_TOL}: {out['far']}), largest gap {out['gap_max']:.3g}; (request, step, "
          f"gap) {off[:12]}; step-0 logits equal prefill of the prompt alone for {step0} of "
          f"{len(reqs)} requests (a reading)", flush=True)
    return out


def _check_combine_invariance(qcfg) -> None:
    """The expert combine adds a token's rows in the same order whatever
    the batch: 8 tokens combined alone give bit for bit what the same 8
    give among 512 (a decode tick against a packed prefill)."""
    from repro_torch.core.moe.dispatch import grouped_combine, grouped_dispatch

    g = torch.Generator(device="cuda").manual_seed(6)
    E, k, D = qcfg.moe.num_experts, qcfg.moe.top_k, qcfg.d_model
    x = torch.randn((LM_MAX_LEN, D), generator=g, device="cuda")
    experts = torch.argsort(torch.rand((LM_MAX_LEN, E), generator=g, device="cuda"),
                            dim=1)[:, :k].to(torch.int32)
    weights = torch.rand((LM_MAX_LEN, k), generator=g, device="cuda")

    def combine(n):
        d = grouped_dispatch(x[:n], experts[:n], weights[:n], E)
        return grouped_combine(d.x_sorted, d, n)

    few, many = combine(LM_SLOTS), combine(LM_MAX_LEN)[:LM_SLOTS]
    print(f"[lm] expert combine of {LM_SLOTS} tokens alone vs among {LM_MAX_LEN}: "
          f"bit-equal {torch.equal(few, many)} (gate)", flush=True)
    if not torch.equal(few, many):
        raise AssertionError("the expert combine depends on the batch size")


def _lm_requests(vocab: int):
    from repro_torch.serving import Request

    rng = np.random.default_rng(3)
    return [Request(uid=i, prompt=rng.integers(0, vocab, int(n)).astype(np.int32),
                    max_new_tokens=LM_NEW_TOKENS)
            for i, n in enumerate(rng.integers(16, 257, LM_REQUESTS))]


def _run_engine(qcfg, params, prompts=None, tag="lm", eager=False, mesh=None):
    """Serve the seeded requests (or one request per prompt given) on a
    fresh engine (over ``mesh`` where given), warmed (``_warm``): its
    programs captured as CUDA graphs, or with ``eager`` the
    ``aot_warmup=False`` engine; returns (engine, requests, wall seconds,
    launch counts, warmup)."""
    from repro_torch.serving import Request, ServeEngine

    eng = ServeEngine(_eager(qcfg) if eager else qcfg, params, batch_slots=LM_SLOTS,
                      max_len=LM_MAX_LEN, device="cuda", keep_logits=True, mesh=mesh)
    warm = _warm(tag, eng)
    reqs = (_lm_requests(qcfg.vocab_size) if prompts is None else
            [Request(uid=i, prompt=p, max_new_tokens=LM_NEW_TOKENS)
             for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t0, _read_counts(), warm


def _teacher_forced(params, qcfg, r, steps):
    """Max |logit| error of request ``r``'s engine logits at ``steps``
    against ``prefill`` over the same prefix, and how many of those steps
    prefill's greedy token equals the engine's."""
    from repro_torch.models import transformer

    errs, agree = [], 0
    with torch.inference_mode():
        for t in steps:
            toks = list(map(int, r.prompt)) + r.generated[:t]
            ref = transformer.prefill(params, qcfg, torch.tensor([toks], device="cuda"))[0][0, -1]
            errs.append(float((r.step_logits[t] - ref).abs().max()))
            agree += int(int(torch.argmax(ref)) == r.generated[t])
    return np.asarray(errs), agree


def _first_pack_dependence(params, qcfg, prompt, other) -> str:
    """The first op whose output for ``prompt``'s rows differs between a
    packed prefill of [other, prompt] and a packed prefill of ``prompt``
    alone: every RMSNorm, linear, RoPE, K/V quantizer, attention, router
    and expert-combine call of the two runs is recorded in order, and the
    prompt's rows are compared call by call (a diagnostic, not a gate)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers, transformer

    targets = [(layers, "rmsnorm"), (layers, "quant_linear"), (transformer, "quant_linear"),
               (layers, "rope"), (layers, "quantize_kv"), (ops, "attention"),
               (transformer, "route_topk"), (transformer, "grouped_combine")]

    def run(prompts):
        P, n = sum(map(len, prompts)), len(prompts[-1])
        put = lambda a: torch.from_numpy(np.asarray(a, np.int32)).cuda()  # noqa: E731
        calls = []

        def rows(t):
            if not isinstance(t, torch.Tensor) or t.dim() == 0:
                return None
            if t.dim() >= 2 and t.shape[:2] == (1, P):
                return t[0, P - n:].clone()
            return t[P - n:].clone() if t.shape[0] == P else None

        def wrap(name, fn):
            def inner(*a, **kw):
                out = fn(*a, **kw)
                calls.append((name, [rows(o) for o in (out if isinstance(out, tuple)
                                                       else (out,))]))
                return out
            return inner

        saved = [(m, name, getattr(m, name)) for m, name in targets]
        try:
            for m, name, fn in saved:
                setattr(m, name, wrap(name, fn))
            with torch.inference_mode():
                transformer.prefill_packed(
                    params, qcfg, put(np.concatenate(prompts))[None],
                    put(np.concatenate([np.arange(len(p)) for p in prompts])),
                    put(np.concatenate([np.full(len(p), i) for i, p in enumerate(prompts)])),
                    put(np.cumsum([len(p) for p in prompts]) - 1), max_len=P)
        finally:
            for m, name, fn in saved:
                setattr(m, name, fn)
        return calls

    packed, alone = run([other, prompt]), run([prompt])
    for i, ((name, a), (_, b)) in enumerate(zip(packed, alone)):
        for x, y in zip(a, b):
            if x is not None and y is not None and not torch.equal(x, y):
                diff = (x.float() - y.float()).abs()
                return (f"{name} (call {i} of {len(packed)}, output {list(x.shape)} of "
                        f"{x.dtype}): {int((diff > 0).sum())} of {x.numel()} values differ, "
                        f"max {float(diff.max()):.3g}")
    return "none: every recorded op gives the prompt's rows the same bits"


def _serve_lm(qcfg, params, mat: str, smi: str) -> dict:
    from repro_torch.models.layers import rmsnorm

    eng, reqs, wall, counts, warm = _run_engine(qcfg, params, tag=f"lm {mat}")
    programs = _check_programs(f"lm {mat}", eng, LM_PER_FORWARD)
    _check_retraces(f"lm {mat}", eng)
    snap = eng.metrics.snapshot()
    c = snap["counters"]
    forwards = c["prefill_batches"] + c["decode_ticks"]
    for name, per in LM_PER_FORWARD.items():
        if counts[name] != per * forwards:
            raise AssertionError(
                f"[lm {mat}] {name}: {counts[name]} launches for {c['prefill_batches']} "
                f"admissions + {c['decode_ticks']} ticks, expected {per} per forward")
    _check_int8_variants(f"lm {mat}", counts)
    _check_grouped_variants_used(f"lm {mat}", counts)
    grouped_mode = "w4a8" if mat == "int4" else "int8"
    if counts.get(f"grouped_matmul:{grouped_mode}") != counts["grouped_matmul"]:
        raise AssertionError(f"[lm {mat}] grouped launches by mode: {counts}")
    if counts["streaming_attention"] != 0:
        raise AssertionError("the LM path must not reach the vision attention kernel")
    for r in reqs:
        if r.status != "completed" or len(r.generated) != LM_NEW_TOKENS:
            raise AssertionError(f"[lm {mat}] request {r.uid}: {r.status}, "
                                 f"{len(r.generated)} tokens")
    tokens = sum(len(r.generated) for r in reqs)
    lat = snap["latency_ms"]
    print(f"[lm {mat}] smoke figure, not a benchmark ({smi}): {len(reqs)} requests, "
          f"{tokens} tokens in {wall:.2f} s = {tokens / wall:.1f} tok/s; latency p50 "
          f"{lat['p50']:.1f} ms, p99 {lat['p99']:.1f} ms; {c['prefill_batches']} "
          f"admissions ({c['pack_real_tokens']} real + {c['pack_pad_tokens']} pad tokens), "
          f"{c['decode_ticks']} ticks; launches {counts}", flush=True)

    # teacher-forced: the logits behind generated tokens against prefill
    # over the same prefix, for every request (so every admission and
    # every slot) at LM_TF_STEPS. Step 0 comes from the packed prefill:
    # with lm_attention's segment-keyed plan (and RMSNorm, the integer
    # matmuls and the expert combine independent of the batch) a prompt's
    # rows in a pack get the bits of a prefill of it alone (gate: 0)
    tf = {r.uid: _teacher_forced(params, qcfg, r, LM_TF_STEPS) for r in reqs}
    errs = np.concatenate([e for e, _ in tf.values()])
    agree = sum(a for _, a in tf.values())
    hit = sorted(uid for uid, (e, _) in tf.items() if e.max() > 0)
    step0 = max(float(e[LM_TF_STEPS.index(0)]) for e, _ in tf.values())
    print(f"[lm {mat}] step-0 logits of every request (in its pack) vs prefill of its "
          f"prompt alone: max err {step0:.3g} (gate: bit-equal)", flush=True)
    if step0:
        raise AssertionError(f"[lm {mat}] a packed prefill's logits differ from prefill alone")
    median, p90, far = LM_TF_LIMITS[mat]
    print(f"[lm {mat}] teacher-forced logits vs prefill, {len(reqs)} requests x steps "
          f"{list(LM_TF_STEPS)}: max err median {np.median(errs):.3g}, p90 "
          f"{np.quantile(errs, 0.9):.3g}, max {errs.max():.3g} (|logit| max "
          f"{max(float(x.abs().max()) for r in reqs for x in r.step_logits):.3g}); "
          f"requests with a nonzero error {hit}; greedy token agreement "
          f"{agree}/{errs.size}; gate: median <= {median}, p90 <= {p90}, "
          f"disagreeing tokens <= {far}", flush=True)
    if not (np.median(errs) <= median and np.quantile(errs, 0.9) <= p90
            and errs.size - agree <= far):
        raise AssertionError(f"[lm {mat}] teacher-forced logits disagree")
    # RMSNorm of the same rows in a tensor of 8 rows (a decode tick) and of
    # 512 rows (a prefill): bit-equal (gate). Then the first op whose rows
    # differ between a pack [the longest other prompt, the request that
    # strayed most] and a prefill of that request alone
    # (``_first_pack_dependence``; gate: none), and that request served
    # alone (offset 0 of its admission, no other slot busy), printed
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((LM_MAX_LEN, qcfg.d_model), generator=g, device="cuda")
    gamma = 0.1 * torch.randn(qcfg.d_model, generator=g, device="cuda")
    few, many = rmsnorm(x[:LM_SLOTS], gamma), rmsnorm(x, gamma)[:LM_SLOTS]
    print(f"[lm {mat}] RMSNorm of {LM_SLOTS} rows alone vs in {LM_MAX_LEN}: "
          f"{int((few != many).sum())} of {few.numel()} values differ (gate: 0)", flush=True)
    if not torch.equal(few, many):
        raise AssertionError(f"[lm {mat}] RMSNorm depends on the number of rows")
    worst = max(reqs, key=lambda r: tf[r.uid][0].max())
    other = max((r for r in reqs if r.uid != worst.uid), key=lambda r: len(r.prompt))
    first_dep = _first_pack_dependence(params, qcfg, worst.prompt, other.prompt)
    print(f"[lm {mat}] pack [request {other.uid}, request {worst.uid}] vs request "
          f"{worst.uid} alone, first op whose rows differ: {first_dep} (gate: none)",
          flush=True)
    if not first_dep.startswith("none"):
        raise AssertionError(f"[lm {mat}] a pack changes a prompt's rows: {first_dep}")
    solo = _run_engine(qcfg, params, [worst.prompt], tag=f"lm {mat} solo")[1][0]
    solo_errs, _ = _teacher_forced(params, qcfg, solo, range(LM_NEW_TOKENS))
    off = np.flatnonzero(solo_errs)
    solo0 = max_err(solo.step_logits[0], worst.step_logits[0])
    print(f"[lm {mat}] per request (prompt tokens, max err): "
          f"{ {r.uid: (len(r.prompt), round(float(tf[r.uid][0].max()), 4)) for r in reqs} }; "
          f"request {worst.uid} served alone: step-0 logits vs packed {solo0:.3g}, "
          f"teacher-forced max err over all {LM_NEW_TOKENS} steps {solo_errs.max():.3g}, first "
          f"nonzero at step {int(off[0]) if off.size else None}", flush=True)
    # the same requests again on a fresh graph engine (serving is
    # deterministic) and on the aot_warmup=False engine (a replayed graph
    # computes the eager step's bits)
    reqs2 = _run_engine(qcfg, params, tag=f"lm {mat} again")[1]
    eager, reqs_e, wall_e, _, _ = _run_engine(qcfg, params, tag=f"lm {mat} eager", eager=True)
    for label, other_reqs in (("served twice", reqs2), ("graph vs aot_warmup=False engine",
                                                        reqs_e)):
        same = all(a.generated == b.generated and all(
            torch.equal(x, y) for x, y in zip(a.step_logits, b.step_logits))
            for a, b in zip(reqs, other_reqs))
        print(f"[lm {mat}] {label}: tokens and logits bit-equal: {same} (gate)", flush=True)
        if not same:
            raise AssertionError(f"[lm {mat}] {label}: tokens or logits differ")
    print(f"[lm {mat}] smoke figure ({smi}): the same requests in {wall:.2f} s through the "
          f"graphs, {wall_e:.2f} s eager", flush=True)
    del reqs2, reqs_e
    profile = _profile_lm(eng, eager, mat, smi, LM_PER_FORWARD)
    del eng, eager
    torch.cuda.empty_cache()
    return {"counts": counts, "counters": c, "tok_s": tokens / wall, "latency_ms": lat,
            "tokens": [list(r.generated) for r in reqs],
            "tok_s_eager": tokens / wall_e, "warmup": warm, "programs": programs,
            "tf_median": float(np.median(errs)), "tf_max": float(errs.max()),
            "tf_hit": hit, "step0": step0, "step0_pack_vs_solo": solo0,
            "profile": profile}


def _profile_lm(eng, eager, mat: str, smi: str, per: dict) -> dict:
    """Where one decode tick (8 slots at fill level 300) and one packed
    admission of 4 prompts of 128 tokens (the 512-token prefill, the first
    tokens, the merge into slots) spend their time: each engine's program,
    eager and as a graph replay, on the same inputs (``_profile_lm_steps``)."""
    out = {}
    for mode, e in (("eager", eager), ("graph", eng)):
        out.update(_profile_lm_steps(e, f"profile lm {mat}", mode, smi, per))
    return out


def _profile_lm_steps(e, tag: str, mode: str, smi: str, per: dict) -> dict:
    """Engine ``e``'s decode tick (8 slots at fill level 300) and packed
    admission of 4 prompts of 128 tokens profiled (``_profile``; programs
    built here if ``e`` has not built them); ``per``: the launches of a
    forward, one device kernel each (gate)."""
    from repro_torch.serving.programs import own

    P, n = LM_MAX_LEN, LM_MAX_LEN // 4
    pos = np.full(LM_SLOTS, 300, np.int32)
    pack = np.concatenate([np.zeros(P, np.int32), np.arange(P) % n, np.arange(P) // n,
                           np.arange(1, 5) * n - 1, np.arange(4) * n, np.full(4, n),
                           np.arange(4)]).astype(np.int32)
    out = {}
    tick = e._compiled(e._program_key("decode"), e._build_tick)
    admit = e._compiled(e._program_key("packed_prefill", bucket=P, n=4),
                        lambda: e._build_admit(P, 4))
    with torch.inference_mode():
        out[f"decode tick, {mode}"] = _profile(
            tag, f"decode tick, {mode}", smi, 3,
            lambda: own(tick, tick(e._tok, pos)), expect=per)
        out[f"packed prefill 512, {mode}"] = _profile(
            tag, f"packed prefill 512, {mode}", smi, 3,
            lambda: own(admit, admit(pack)), expect=per)
    for label, prof in out.items():
        _check_kernels_per_call(f"{tag} {label}", prof, per)
    return out


def _replay_ms(prog, *inputs, reps: int = 10, before=None) -> float:
    """The median device ms of ``reps`` back-to-back replays of a captured
    program on ``inputs`` (after one warm-up replay), each timed by the
    events its graph records at its first and last node
    (``programs.StepTimer``, as a served step is timed), read after the
    last; no profiler. ``before()`` is enqueued ahead of every replay,
    outside its events (a tick's feed reset: the tick writes its argmax
    into the feed, and its routing follows the feed)."""
    from repro_torch.serving.programs import StepTimer

    timer = StepTimer(torch.device("cuda"))
    marks = [timer.take() for _ in range(reps)]
    with torch.inference_mode():
        for mark in [None] + marks:
            if before is not None:
                before()
            prog(*inputs, mark=mark)
    return float(np.median([timer.seconds(mark) * 1e3 for mark in marks]))


def _lm_step_ms(e, reps: int = 10) -> dict:
    """Engine ``e``'s captured decode tick (8 slots at fill 300) and packed
    admission of 4 prompts of 128 tokens, ``_profile_lm_steps``'s steps
    and inputs, timed without the profiler (``_replay_ms``); the tick's
    feed is set to the same seeded tokens before each replay, and the
    cache and feed are put back after (``_state_kept``), so two engines
    that served the same requests are timed on the same state and nothing
    after sees the timing."""
    P, n = LM_MAX_LEN, LM_MAX_LEN // 4
    pos = np.full(LM_SLOTS, 300, np.int32)
    pack = np.concatenate([np.zeros(P, np.int32), np.arange(P) % n, np.arange(P) // n,
                           np.arange(1, 5) * n - 1, np.arange(4) * n, np.full(4, n),
                           np.arange(4)]).astype(np.int32)
    feed = torch.from_numpy(np.random.default_rng(23).integers(
        0, e.cfg.vocab_size, LM_SLOTS).astype(np.int32)).to(e._tok.device)
    with e._state_kept():
        return {"decode tick": _replay_ms(e._programs[e._program_key("decode")], e._tok, pos,
                                          reps=reps, before=lambda: e._tok.copy_(feed)),
                "packed prefill 512": _replay_ms(
                    e._programs[e._program_key("packed_prefill", bucket=P, n=4)], pack,
                    reps=reps)}


def _profile(tag: str, label: str, smi: str, n: int, fn, expect=None) -> dict:
    """Host wall time per call of ``fn`` with a synchronize, host time to
    enqueue alone, and the device time of every kernel it launched
    (torch.profiler, summed by kernel name; the top 8 printed), over ``n``
    calls after one warm-up call. Each trace records a warm-up step (one
    call) before its active step of ``n`` calls (``torch.profiler.schedule``):
    a window that starts cold lost the first RMSNorm of its first call in
    every trace of some runs on an H100. ``expect`` (family -> launches a
    call): a trace that holds fewer kernels of a family than its wrapper
    launched is incomplete (a launch that returned success ran its kernel,
    so the profiler lost events, as it did for ~1% of a 512-token
    prefill's kernels in some runs on an H100) and is taken again,
    ``PROFILE_ATTEMPTS`` times at most; ``_check_kernels_per_call`` holds
    the last trace to exactly the launches, so a second kernel a call
    still fails."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        enqueue = (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         acc_events=True) as prof:
                fn()
                torch.cuda.synchronize()
                prof.step()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
            by_name: dict = {}
            for ev in prof.events():
                # device work only: the schedule's step marker is also an
                # annotation on the device timeline, spanning the whole step
                if (ev.device_type == torch.autograd.DeviceType.CUDA
                        and not ev.is_user_annotation
                        and not ev.name.startswith("ProfilerStep")):
                    us, calls = by_name.get(ev.name, (0.0, 0))
                    by_name[ev.name] = (us + ev.device_time, calls + 1)
            fam = {}
            for family, names in KERNEL_NAMES.items():
                hits = [(us, c) for name, (us, c) in by_name.items()
                        if any(k in name for k in names)]
                fam[family] = (sum(us for us, _ in hits) / n / 1e3, sum(c for _, c in hits) / n)
            short = {f: fam[f][1] for f, want in (expect or {}).items() if fam[f][1] < want}
            if not short:
                break
            print(f"[{tag}] {label}: trace {attempt} is incomplete ({short} kernels a call "
                  f"against {expect} launched); tracing again", flush=True)
    device_ms = sum(us for us, _ in by_name.values()) / n / 1e3
    kernels = sum(c for _, c in by_name.values()) / n
    print(f"[{tag}] {label} ({smi}): wall {wall * 1e3:.2f} ms, host enqueue "
          f"{enqueue * 1e3:.2f} ms, device kernels {device_ms:.2f} ms (busy share "
          f"{device_ms / (wall * 1e3):.2f}), {kernels:.0f} kernels; "
          + ", ".join(f"{f} {ms:.3f} ms in {k:.0f} kernels" for f, (ms, k) in fam.items()),
          flush=True)
    for kname, (us, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[{tag}] {us / n / 1e3:8.3f} ms {calls // n:5d} x  {kname[:80]}", flush=True)
    return {"wall_ms": wall * 1e3, "enqueue_ms": enqueue * 1e3, "device_ms": device_ms,
            "kernels": kernels, "traces": attempt,
            **{f"{f}_ms": ms for f, (ms, _) in fam.items()},
            **{f"{f}_kernels": k for f, (_, k) in fam.items()}}


def _check_kernels_per_call(tag: str, profile: dict, per: dict) -> None:
    """One device kernel per call of each wrapper in ``per`` (launches per
    forward): no memset, no work-table or offset fill, no second pass."""
    for family, want in per.items():
        if profile[f"{family}_kernels"] != want:
            raise AssertionError(f"[{tag}] {profile[f'{family}_kernels']} {family} device "
                                 f"kernels per forward, expected {want}")
    print(f"[{tag}] one device kernel per call: {per} (gate)", flush=True)


def phase_ssm(smi: str) -> dict:
    """Full-width falcon-mamba-7b served through the grouped same-length
    admission path (see the module docstring, phase 8)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.models import init_model_params, ssm_lm, tree_bytes
    from repro_torch.serving import Request, ServeEngine

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 1e9
    if left > 1.0:  # the OLMoE trees and engines must be gone
        raise AssertionError(f"[ssm] {left:.2f} GB of earlier phases still allocated")
    cfg = get_config("falcon-mamba-7b")
    t0 = time.perf_counter()
    params = init_model_params(cfg, seed=0, device="cuda")
    eng = ServeEngine(cfg, params, batch_slots=SSM_SLOTS, max_len=SSM_MAX_LEN,
                      device="cuda", keep_logits=True)
    warm = _warm("ssm", eng)
    programs = _check_programs("ssm", eng, {"rmsnorm": SSM_LAYERS + 1})
    print(f"[ssm] {cfg.name}: {tree_bytes(params) / 1e9:.2f} GB f32 ({left:.2f} GB "
          f"of earlier phases left on the card); init + warmup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(7)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                    max_new_tokens=SSM_NEW_TOKENS)
            for i, n in enumerate(rng.choice(SSM_PROMPT_LENS, SSM_REQUESTS))]
    c = eng.metrics.counters
    _reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.active or eng.scheduler.depth:
        before, dispatches = selective_scan.launches, c.get("prefill_batches", 0)
        eng.step()
        steps += 1
        grew = selective_scan.launches - before
        if grew != SSM_LAYERS * (c.get("prefill_batches", 0) - dispatches):
            raise AssertionError(f"[ssm] step {steps}: {grew} scan launches for "
                                 f"{c.get('prefill_batches', 0) - dispatches} prefill "
                                 f"dispatches and one decode tick")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    forwards = c["prefill_batches"] + c["decode_ticks"]
    others = {k: n for k, n in counts.items()
              if n and not k.startswith(("selective_scan", "rmsnorm"))}
    if (counts["selective_scan"] != SSM_LAYERS * c["prefill_batches"]
            or counts.get("selective_scan:states", 0) != counts["selective_scan"]
            or counts["rmsnorm"] != (SSM_LAYERS + 1) * forwards or others):
        raise AssertionError(f"[ssm] launches {counts} for {c['prefill_batches']} dispatches "
                             f"and {c['decode_ticks']} ticks")
    for r in reqs:
        if r.status != "completed" or len(r.generated) != SSM_NEW_TOKENS:
            raise AssertionError(f"[ssm] request {r.uid}: {r.status}, "
                                 f"{len(r.generated)} tokens")
    _check_retraces("ssm", eng)
    snap = eng.metrics.snapshot()
    lat = snap["latency_ms"]
    tokens = sum(len(r.generated) for r in reqs)
    print(f"[ssm] smoke figure, not a benchmark ({smi}): {len(reqs)} requests, {tokens} "
          f"tokens in {wall:.2f} s = {tokens / wall:.1f} tok/s; latency p50 "
          f"{lat['p50']:.1f} ms, p99 {lat['p99']:.1f} ms; {c['prefill_batches']} grouped "
          f"prefill dispatches, {c['decode_ticks']} ticks; launches {counts} (gate: "
          f"{SSM_LAYERS} scans per dispatch, 0 per tick, checked at every step; "
          f"{SSM_LAYERS + 1} RMSNorms per forward)", flush=True)

    rel, agree = _ssm_teacher_forced(params, cfg, reqs)
    print(f"[ssm] teacher-forced logits vs forward, {len(reqs)} requests x "
          f"{SSM_NEW_TOKENS} steps: relative max err median {np.median(rel):.3g}, p90 "
          f"{np.quantile(rel, 0.9):.3g}, max {rel.max():.3g}; by step (max over "
          f"requests) {[float(f'{v:.2g}') for v in rel.max(0)]}; greedy token agreement "
          f"{agree}/{rel.size}; gate: median <= {SSM_TF_LIMIT[0]}, max <= "
          f"{SSM_TF_LIMIT[1]}", flush=True)
    if not _ssm_tf_pass(rel):
        raise AssertionError("[ssm] teacher-forced logits disagree")
    # the same requests on the aot_warmup=False engine: bit-equal (gate)
    eager = ServeEngine(_eager(cfg), params, batch_slots=SSM_SLOTS, max_len=SSM_MAX_LEN,
                        device="cuda", keep_logits=True)
    _warm("ssm eager", eager)
    again = [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=SSM_NEW_TOKENS) for r in reqs]
    t0 = time.perf_counter()
    for r in again:
        eager.submit(r)
    eager.run_until_drained()
    torch.cuda.synchronize()
    wall_e = time.perf_counter() - t0
    same = all(a.generated == b.generated and all(
        torch.equal(x, y) for x, y in zip(a.step_logits, b.step_logits))
        for a, b in zip(reqs, again))
    print(f"[ssm] graph engine vs aot_warmup=False engine: tokens and logits bit-equal "
          f"{same} (gate); smoke figure ({smi}): {wall:.2f} s through the graphs, "
          f"{wall_e:.2f} s eager", flush=True)
    if not same:
        raise AssertionError("[ssm] the graph engine and the eager engine disagree")
    del again
    controls = {name: _ssm_control(name, params, cfg, reqs[:SSM_SLOTS])
                for name in SSM_CONTROLS}

    from repro_torch.serving.programs import own

    group = torch.zeros((SSM_SLOTS, SSM_PROMPT_LENS[-1]), dtype=torch.int32, device="cuda")
    host_tok = np.zeros(SSM_SLOTS, np.int32)
    profile = {}
    for mode, e in (("eager", eager), ("graph", eng)):
        tick = e._compiled(e._program_key("decode"), e._build_tick)
        profile[f"decode tick, {mode}"] = _profile(
            "profile ssm", f"decode tick, 8 slots, {mode}", smi, 3,
            lambda: own(tick, tick(host_tok, e.pos)))
    profile["grouped prefill"] = _profile("profile ssm", "grouped prefill, 8 x 256", smi, 2,
                                          lambda: ssm_lm.prefill(params, cfg, group))
    del eng, eager, params
    torch.cuda.empty_cache()
    return {"counts": counts, "counters": dict(c), "tok_s": tokens / wall,
            "tok_s_eager": tokens / wall_e, "warmup": warm, "programs": programs,
            "latency_ms": lat, "tf_max": float(rel.max()), "controls": controls,
            "profile": profile}


def _ssm_teacher_forced(params, cfg, reqs):
    """One forward over each request's prompt and generated tokens gives
    the logits behind every step. Returns (relative max error [requests,
    steps], the number of steps whose greedy token agrees)."""
    from repro_torch.models import forward

    rel, agree = [], 0
    with torch.inference_mode():
        for r in reqs:
            toks = torch.tensor([list(map(int, r.prompt)) + r.generated[:-1]], device="cuda")
            want = forward(params, cfg, toks)[0][0, len(r.prompt) - 1:]
            got = torch.stack(r.step_logits)
            rel.append(((got - want).abs().amax(-1) / want.abs().amax(-1)).cpu().numpy())
            agree += int((want.argmax(-1).cpu() == torch.tensor(r.generated)).sum())
    return np.stack(rel), agree


def _ssm_tf_pass(rel) -> bool:
    return bool(np.median(rel) <= SSM_TF_LIMIT[0] and rel.max() <= SSM_TF_LIMIT[1])


def _ssm_control(name: str, params, cfg, first) -> dict:
    """Serve the first admission wave again with one rounding fault (see
    ``SSM_CONTROLS``) and hold it against the f32 forward: the gate must
    fail it, or it could not see a fault of that size."""
    from repro_torch.models import ssm_lm
    from repro_torch.serving import Request, ServeEngine

    eng = ServeEngine(cfg, params, batch_slots=SSM_SLOTS, max_len=SSM_MAX_LEN,
                      device="cuda", keep_logits=True)
    if name == "bf16 conv history":
        eng.cache = ssm_lm.init_cache(cfg, SSM_SLOTS, SSM_MAX_LEN, device="cuda")
    reqs = [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=SSM_NEW_TOKENS)
            for r in first]
    precision = torch.get_float32_matmul_precision()
    if name == "tf32 matmuls":
        torch.set_float32_matmul_precision("high")
    try:
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
    finally:
        torch.set_float32_matmul_precision(precision)
    rel, agree = _ssm_teacher_forced(params, cfg, reqs)
    print(f"[ssm] control, {name}: {len(reqs)} requests x {SSM_NEW_TOKENS} steps, "
          f"relative max err median {np.median(rel):.3g}, max {rel.max():.3g}; greedy "
          f"token agreement {agree}/{rel.size} (must fail the gate)", flush=True)
    if _ssm_tf_pass(rel):
        raise AssertionError(f"[ssm] the teacher-forced gate passes the control {name!r}")
    return {"median": float(np.median(rel)), "max": float(rel.max()), "agree": agree}


def phase_e2e(qcfg, p_int8) -> None:
    """The int8 forward on the card against the same tree on the CPU (plain
    versions). Free-running, the two drift apart: a score or activation
    that the two paths round on different sides of a code boundary (4-bit
    attention codes, int8 activations) changes a weight or an LSB, a few of
    those change a token's top-2 experts, and twelve random-weight layers
    amplify that into O(1) logit differences. So the gate is teacher-forced:
    every block, and the head, gets the card's input on both sides."""
    from repro_torch.models import forward, synth_patches, vit
    from repro_torch.models.param import tree_to

    x = torch.from_numpy(synth_patches(qcfg, 4, seed=9))
    p_cpu = tree_to(p_int8, "cpu")
    with torch.inference_mode():
        free_card = forward(p_int8, qcfg, x.cuda())[0].cpu()
        free_cpu = forward(p_cpu, qcfg, x)[0]
        top1 = float((free_card.argmax(-1) == free_cpu.argmax(-1)).float().mean())
        print(f"[e2e] free-running int8 logits, card vs CPU: max err "
              f"{max_err(free_card, free_cpu):.3g} (|logit| max "
              f"{float(free_cpu.abs().max()):.3g}), top-1 agreement {top1:.2f} "
              "(not gated)", flush=True)
        h = vit.embed(p_int8, qcfg, x.cuda())
        torch.testing.assert_close(h.cpu(), vit.embed(p_cpu, qcfg, x),
                                   atol=1e-4, rtol=1e-5)
        for (scope, lp), (_, lp_cpu) in zip(vit.layers(p_int8, qcfg),
                                            vit.layers(p_cpu, qcfg)):
            out = vit.block(h, lp, qcfg)[0]
            tok_err = (out.cpu() - vit.block(h.cpu(), lp_cpu, qcfg)[0]).abs().amax(-1)
            median, far = float(tok_err.median()), float((tok_err > 5e-2).float().mean())
            print(f"[e2e] {scope}: per-token max err median {median:.3g}, "
                  f"max {float(tok_err.max()):.3g}, tokens over 5e-2 {far:.4f}",
                  flush=True)
            # a fault moves every token; boundary flips and the expert
            # swaps they cause move a few
            assert median <= 1e-3 and far <= 0.02, scope
            h = out
        logits = vit.head(p_int8, qcfg, h).cpu()
        ref_logits = vit.head(p_cpu, qcfg, h.cpu())
    print(f"[e2e] teacher-forced logits: max err {max_err(logits, ref_logits):.3g}",
          flush=True)
    torch.testing.assert_close(logits, ref_logits, atol=1e-3, rtol=0)


def phase_profile(qcfg, p_int8, smi: str, engines: dict) -> dict:
    """Where one int8 forward at B=8 spends its time, and one dispatch of
    8 images (input copy, forward, outputs) through the eager engine's
    program and through the graph engine's."""
    from repro_torch.models import classify, synth_patches
    from repro_torch.serving.programs import own

    xs = synth_patches(qcfg, 8, seed=4)
    x = torch.from_numpy(xs).cuda()
    prof = _profile("profile", f"{qcfg.name} int8 forward, B=8", smi, 5,
                    lambda: classify(p_int8, qcfg, x), expect=PER_FORWARD)
    _check_kernels_per_call("profile", prof, PER_FORWARD)
    out = {"forward": prof}
    for mode in ("eager", "graph"):
        prog = engines[mode]._compiled(8)
        out[mode] = _profile("profile", f"{qcfg.name} dispatch of 8, {mode}", smi, 5,
                             lambda: own(prog, prog(xs)), expect=PER_FORWARD)
        _check_kernels_per_call(f"profile {mode}", out[mode], PER_FORWARD)
    return out


# ---------------------------------------------------------------------------
# phase 9: the serving cluster
# ---------------------------------------------------------------------------

def _inner(eng):
    """A replica's engine (the chaos wrapper's inner engine, or itself)."""
    return getattr(eng, "inner", eng)


def _tensor_ptrs(tree) -> list:
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _tensor_ptrs(tree[k])]
    return [tree.data_ptr()]


def _check_shared_weights(tag: str, cluster, params) -> None:
    """Gate: every replica's weights are the caller's tensors (``data_ptr``
    equal leaf for leaf), so replicas on one card share one copy, while
    each keeps its own cache (LM) and graph pool (``_cluster_warmup``)."""
    engines = [_inner(e) for e in cluster.engines + cluster._standby]
    want = _tensor_ptrs(params)
    same = all(_tensor_ptrs(e.params) == want for e in engines)
    own_caches = len({id(getattr(e, "cache", e)) for e in engines}) == len(engines)
    print(f"[{tag}] {len(engines)} replicas on {[str(d) for d in cluster.devices]}: "
          f"{len(want)} weight leaves with equal data_ptr in every replica: {same}, a cache "
          f"each: {own_caches} (gate)", flush=True)
    if not (same and own_caches):
        raise AssertionError(f"[{tag}] the replicas do not share one copy of the weights")


def _cluster_warmup(tag: str, cluster, per: dict, smi: str) -> dict:
    """``cluster.warmup()`` with every replica's warmup timed, then each
    replica's graph pool printed; gates: the pools are distinct, every
    program of every replica a captured graph whose kernel nodes equal the
    launches its capture counted and one forward's (``_check_programs``),
    ``retraces`` 0."""
    engines = cluster.engines + cluster._standby
    seconds = {}
    for e in engines:
        def timed(_warmup=e.warmup, _label=cluster._labels[id(e)]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _warmup()
            torch.cuda.synchronize()
            seconds[_label] = time.perf_counter() - t0
        e.warmup = timed
    reserved = torch.cuda.memory_reserved()
    cluster.warmup()
    segments = torch.cuda.memory_snapshot()
    out = {}
    for e in engines:
        del e.warmup
        eng, label = _inner(e), cluster._labels[id(e)]
        pool = sum(seg["total_size"] for seg in segments
                   if tuple(seg.get("segment_pool_id", ())) == tuple(eng._pool))
        _check_programs(f"{tag} {label}", eng, per)
        _check_retraces(f"{tag} {label}", eng)
        out[label] = {"capture_s": seconds[label], "pool_bytes": pool,
                      "programs": len(eng._programs)}
    pools = {tuple(_inner(e)._pool) for e in engines}
    print(f"[{tag}] warmup per replica ({smi}): "
          + "; ".join(f"{k} {v['programs']} graphs captured in {v['capture_s']:.2f} s, pool "
                      f"{v['pool_bytes'] / 1e6:.1f} MB" for k, v in out.items())
          + f"; {len(pools)} distinct pools (gate); reserved memory {reserved / 1e9:.2f} -> "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB", flush=True)
    if len(pools) != len(engines):
        raise AssertionError(f"[{tag}] replicas share a graph pool")
    return out


class _StepTimer:
    """Pumps a cluster with ``step()`` until no request is queued or in
    flight, then ``flush()`` waits for the retirement threads; splits each
    step's host time: the replicas' own ``step()`` calls (timed through
    instance attributes over their methods) and the rest -- the cluster's
    routing, watchdog and bookkeeping (``outside``, seconds a step)."""

    def __init__(self, cluster) -> None:
        self.cluster = cluster
        self.outside: list = []
        self._inside = 0.0
        self._wrapped: set = set()
        # each replica's step() that returned, in order: (replica, seconds),
        # the replicas numbered as they were first stepped
        self.watched: list = []

    def _wrap(self, eng) -> None:
        if id(eng) in self._wrapped:
            return
        k = len(self._wrapped)
        self._wrapped.add(id(eng))

        def step(_step=eng.step):
            t0 = time.perf_counter()
            try:
                _step()
            finally:
                d = time.perf_counter() - t0
                self._inside += d
            self.watched.append((k, d))
        eng.step = step

    def replay(self) -> list:
        """Each replica's step times through a ``ReplicaWatchdog`` of the
        cluster's ``FaultConfig``, as the cluster's own watchdog reads them
        (it times the same ``step()`` calls, and this timer wraps each
        replica before its first): (replica, seconds, EMA before the step or
        None, armed, stall streak after, verdict or None) a step."""
        from repro_torch.serving.faults import ReplicaWatchdog

        f, wds, out = self.cluster.faults, {}, []
        for k, d in self.watched:
            wd = wds.setdefault(k, ReplicaWatchdog(f, label=f"replica{k}"))
            st = wd.state()
            armed = st["step_ema_s"] is not None and st["steps"] + 1 > f.warmup_steps
            verdict = wd.record_step(d)
            out.append((k, d, st["step_ema_s"], armed, wd.state()["consecutive_stalls"],
                        verdict))
        return out

    def watchdog_trace(self) -> str:
        """The step times the watchdogs saw against the stall rule: a step
        counts as a stall over ``stall_threshold`` x the EMA of earlier
        healthy steps (once armed) and over ``stall_floor_s``, or over
        ``step_timeout_s``; ``stall_budget`` stalls in a row evict."""
        f = self.cluster.faults
        if not self.watched:
            return "no step was timed"
        seen = self.replay()
        ms = np.asarray([d for _, d, *_ in seen]) * 1e3
        margins = [max(f.stall_threshold * ema, f.stall_floor_s) - d
                   for _, d, ema, armed, _, _ in seen if armed]
        worst = max(s for *_, s, _ in seen)
        return (f"{len(ms)} steps timed, {ms.size - len(margins)} before the EMA was armed; "
                f"step ms median {np.median(ms):.2f}, p90 {np.quantile(ms, 0.9):.2f}, max "
                f"{ms.max():.2f}; smallest margin to the stall rule (max({f.stall_threshold} x "
                f"EMA, {f.stall_floor_s * 1e3:.0f} ms) - step) "
                f"{(min(margins) * 1e3 if margins else float('nan')):.2f} ms; longest stall "
                f"streak {worst} (evicts at {f.stall_budget}); step ms in order by replica "
                f"{[(k, round(d * 1e3, 3)) for k, d, *_ in seen]}")

    def check_evictions(self, tag: str) -> None:
        """Gate: every eviction in the cluster's ledger is the watchdog's
        stall rule, and the timed steps show it: replayed through the rule,
        a replica's trace reaches ``stall_budget`` stalls in a row at the
        step the eviction names. Any other reason (step errors, OOM) fails."""
        seen, budget = self.replay(), self.cluster.faults.stall_budget
        for ev in self.cluster.health()["evicted"]:
            if ev.get("reason") != "stalled":
                raise AssertionError(f"[{tag}] a replica was evicted for {ev.get('reason')}: "
                                     f"{ev}")
            if not any(v is not None and v["steps"] == ev["steps"]
                       and v["consecutive_stalls"] >= budget for *_, v in seen):
                raise AssertionError(f"[{tag}] eviction {ev} is not {budget} steps over the "
                                     f"stall rule in the timed steps: {self.watchdog_trace()}")

    def run_until_idle(self, max_steps: int = 100_000) -> int:
        c = self.cluster
        for n in range(max_steps):
            if not c.total_load:
                c.flush()
                if not c.idle:
                    raise AssertionError("the cluster is not idle after its flush")
                return n
            for e in c.engines + c._draining:
                self._wrap(e)
            self._inside = 0.0
            t0 = time.perf_counter()
            c.step()
            self.outside.append(time.perf_counter() - t0 - self._inside)
        counters = c.metrics.snapshot()["aggregate"]["counters"]
        raise AssertionError(
            f"requests still queued or in flight after {max_steps} steps: front-end depth "
            f"{c.depth}, active replicas {len(c.engines)} (loads "
            f"{[e.load for e in c.engines]}), draining {len(c._draining)}, standby "
            f"{len(c._standby)}; nonzero counters {({k: v for k, v in counters.items() if v})}; "
            f"eviction ledger {c.health()['evicted']}; watchdog trace: "
            f"{self.watchdog_trace()}")

    def summary(self) -> str:
        us = 1e6 * np.asarray(self.outside)
        return (f"median {np.median(us):.1f} us, p90 {np.quantile(us, 0.9):.1f} us, "
                f"max {us.max():.1f} us over {us.size} steps")


def _delivery(reqs):
    """Give every request an ``on_done`` that counts its deliveries and
    stamps the first on the host clock; returns (counts, stamps)."""
    fired, at = {}, {}

    def on_done(r):
        fired[r.uid] = fired.get(r.uid, 0) + 1
        at.setdefault(r.uid, time.monotonic())

    for r in reqs:
        r.on_done = on_done
    return fired, at


def _check_delivered_once(tag: str, reqs, fired: dict) -> None:
    bad = {r.uid: (fired.get(r.uid, 0), r.status) for r in reqs
           if fired.get(r.uid, 0) != 1 or r.status != "completed"}
    print(f"[{tag}] {len(reqs)} requests, each on_done fired once with status completed: "
          f"{not bad} (gate)", flush=True)
    if bad:
        raise AssertionError(f"[{tag}] deliveries (count, status): {bad}")


def _check_cluster_launches(tag: str, counts: dict, forwards: int, per: dict) -> None:
    """Gate: each kernel launched exactly its per-forward count times the
    forwards every replica ran (retired replicas' included), and every
    int8_matmul and integer grouped call on variant 1 or 2."""
    for name, n in per.items():
        if counts[name] != n * forwards:
            raise AssertionError(f"[{tag}] {name}: {counts[name]} launches for {forwards} "
                                 f"forwards, expected {n} per forward")
    print(f"[{tag}] launches {[counts[k] for k in per]} = {list(per.values())} per forward x "
          f"{forwards} forwards (gate)", flush=True)
    _check_int8_variants(tag, counts)
    _check_grouped_variants_used(tag, counts)


def _release() -> None:
    """Collect a dropped cluster's replicas (their caches and graph pools
    sit in reference cycles) and return their memory."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_cluster_vision(qcfg, p_int8, single, smi: str) -> dict:
    """Phase 9, vision part: two M3ViT-S int8 replicas on the card behind
    one front-end, against phase 4's engine (``single``) on the same burst
    of requests."""
    from repro_torch.serving import ServingCluster, synth_requests

    tag = "cluster vision"
    cluster = ServingCluster(qcfg, p_int8, replicas=2, engine="vision",
                             batch_buckets=(1, 4, 8), max_wait_s=2e-3)
    _check_shared_weights(tag, cluster, p_int8)
    warm = _cluster_warmup(tag, cluster, PER_FORWARD, smi)
    # the single engine on the same burst: all submitted, then drained
    ref = synth_requests(qcfg, CLUSTER_VISION_REQUESTS, seed=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in ref:
        single.submit(r)
    single.flush()
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    reqs = synth_requests(qcfg, CLUSTER_VISION_REQUESTS, seed=5)
    fired, _ = _delivery(reqs)
    timer = _StepTimer(cluster)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        cluster.submit(r)
    steps = timer.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    snap = cluster.metrics.snapshot()
    c = snap["aggregate"]["counters"]
    _check_delivered_once(tag, reqs, fired)
    same = all(np.array_equal(a.classes, b.classes) for a, b in zip(reqs, ref))
    prob_err = max(float(np.abs(a.probs - b.probs).max()) for a, b in zip(reqs, ref))
    print(f"[{tag}] {len(reqs)} requests vs phase 4's engine on the same burst: top-5 "
          f"classes equal {same} (gate), probabilities max abs diff {prob_err:.3g} (gate: <= "
          f"{CLUSTER_VISION_PROB_TOL})", flush=True)
    if not same or prob_err > CLUSTER_VISION_PROB_TOL:
        raise AssertionError(f"[{tag}] the cluster's classes or probabilities differ")
    frames = [rep["counters"].get("frames", 0) for rep in snap["replicas"]]
    print(f"[{tag}] frames by replica {frames} (gate: every replica served), batches "
          f"{c['batches']}, padded frames {c.get('padded_frames', 0)}, retraces "
          f"{c.get('retraces', 0)} (gate: 0)", flush=True)
    if min(frames) == 0 or sum(frames) != len(reqs) or c.get("retraces", 0):
        raise AssertionError(f"[{tag}] replicas served {frames}, counters {c}")
    _check_cluster_launches(tag, counts, c["batches"], PER_FORWARD)
    print(f"[{tag}] smoke figure, not a benchmark ({smi}): {len(reqs)} frames in {wall:.3f} s "
          f"= {len(reqs) / wall:.1f} frames/s through 2 replicas time-sharing the card, vs "
          f"{len(reqs) / single_s:.1f} frames/s through the single engine ({single_s:.3f} s); "
          f"{steps} cluster steps, host time of a step outside the replicas: "
          f"{timer.summary()}", flush=True)
    del cluster, timer
    _release()
    return {"counts": counts, "warmup": warm, "fps": len(reqs) / wall,
            "single_fps": len(reqs) / single_s, "prob_err": prob_err}


def _cluster_lm_run(tag: str, qcfg, params, single: dict, smi: str, faults=None) -> dict:
    """Phase 7's 16 requests, all at once, through two OLMoE-1B-7B int8
    replicas and a standby, pumped by ``_StepTimer`` (``faults``: the chaos
    run's fault model), against phase 7's single engine (``single``)."""
    from repro_torch.serving import EventLog, ServingCluster

    events = EventLog()
    cluster = ServingCluster(qcfg, params, replicas=2, standby=1, engine="lm",
                             batch_slots=LM_SLOTS, max_len=LM_MAX_LEN, events=events,
                             faults=faults)
    _check_shared_weights(tag, cluster, params)
    warm = _cluster_warmup(tag, cluster, LM_PER_FORWARD, smi)
    reqs = _lm_requests(qcfg.vocab_size)
    fired, done_at = _delivery(reqs)
    timer = _StepTimer(cluster)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        cluster.submit(r)
    steps = timer.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    snap = cluster.metrics.snapshot()
    c = snap["aggregate"]["counters"]
    _check_delivered_once(tag, reqs, fired)
    differ = [r.uid for r, want in zip(reqs, single["tokens"]) if r.generated != want]
    print(f"[{tag}] tokens of every request identical to phase 7's single engine: "
          f"{not differ} (gate; differing requests {differ})", flush=True)
    if differ:
        raise AssertionError(f"[{tag}] requests {differ} got other tokens")
    if c.get("retraces", 0):
        raise AssertionError(f"[{tag}] {c['retraces']} programs built while serving")
    _check_cluster_launches(tag, counts, c["prefill_batches"] + c["decode_ticks"],
                            LM_PER_FORWARD)
    served = {cluster._labels[id(e)]: rep["counters"].get("tokens", 0)
              for e, rep in zip(cluster.engines, snap["replicas"])}
    evicted = events.events("replica_evicted")
    replaced = events.events("replica_replaced")
    redispatched = sorted(r.uid for r in reqs if r.redispatched)
    print(f"[{tag}] decode tokens by live replica {served}; events {events.counts()}; "
          f"counters replicas_evicted {c.get('replicas_evicted', 0)}, replicas_replaced "
          f"{c.get('replicas_replaced', 0)}, cluster_redispatched "
          f"{c.get('cluster_redispatched', 0)}, replica_step_errors "
          f"{c.get('replica_step_errors', 0)}; re-dispatched requests {redispatched}",
          flush=True)
    out = {"counts": counts, "warmup": warm, "tok_s": LM_REQUESTS * LM_NEW_TOKENS / wall,
           "steps": steps}
    if faults is None:
        if evicted or c.get("replica_step_errors", 0) or min(served.values()) == 0:
            raise AssertionError(f"[{tag}] an eviction or an idle replica in the clean run: "
                                 f"{events.counts()}, {served}")
        print(f"[{tag}] no eviction, no step error, every replica served (gate)", flush=True)
    else:
        ok = (len(evicted) == 1 and len(replaced) == 1 and evicted[0]["replica"] == "replica1"
              and replaced[0]["replacement"] == "replica2"
              and c.get("cluster_redispatched", 0) >= 1 and cluster.standby_replicas == 0
              and cluster.num_replicas == 2 and not cluster.degraded)
        print(f"[{tag}] one eviction, the standby promoted, >= 1 re-dispatched: {ok} (gate); "
              f"the eviction record {evicted[0] if evicted else None}", flush=True)
        if not ok:
            raise AssertionError(f"[{tag}] eviction events {evicted}, {replaced}, counters {c}")
        backfill = replaced[0]["t"] - evicted[0]["t"]
        recovered = max(done_at[u] for u in redispatched) - evicted[0]["t"]
        print(f"[{tag}] ({smi}) eviction to backfill (standby promoted) {1e6 * backfill:.1f} "
              f"us; eviction to the last re-dispatched request's completion {recovered:.3f} s",
              flush=True)
        out.update(backfill_s=backfill, recovered_s=recovered, redispatched=redispatched)
    print(f"[{tag}] smoke figure, not a benchmark ({smi}): {LM_REQUESTS} requests, "
          f"{LM_REQUESTS * LM_NEW_TOKENS} tokens in {wall:.2f} s = {out['tok_s']:.1f} tok/s "
          f"through 2 replicas time-sharing the card, vs {single['tok_s']:.1f} tok/s through "
          f"phase 7's single engine; {steps} cluster steps, host time of a step outside the "
          f"replicas: {timer.summary()}", flush=True)
    del cluster, timer
    _release()
    return out


def phase_cluster_lm(qcfg, params, single: dict, smi: str) -> dict:
    """Phase 9, LM part: the clean run, then the chaos run (replica 1 killed
    mid-decode), each on a fresh cluster."""
    from repro_torch.configs import FaultConfig

    chaos = FaultConfig(inject=True, kill_schedule=((1, CLUSTER_KILL_STEP, "dead"),))
    return {"clean": _cluster_lm_run("cluster lm", qcfg, params, single, smi),
            "chaos": _cluster_lm_run("cluster lm chaos", qcfg, params, single, smi, chaos)}


# ---------------------------------------------------------------------------
# observability: tracing, the program rows, memory, /metrics
# ---------------------------------------------------------------------------

def _traced_config(cfg, annotate: bool = False):
    import dataclasses

    return cfg.replace(trace=dataclasses.replace(cfg.trace, enable=True,
                                                 annotate_kernels=annotate))


def _get(url: str):
    """GET a local URL, never through a proxy."""
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(url, timeout=10) as r:
        return r.status, r.read().decode()


def _check_observed(tag: str, eng, n_requests: int, smi: str) -> dict:
    """The gates a traced, served engine holds: every request's timeline
    valid and its service phases summing to its latency (within 1e-6 s),
    nothing open, nothing dropped; the exported Chrome trace valid (written
    to ``build/observe/``); a cost row for every program; every served
    program's ``mfu``, ``hbm_util`` and ``roofline_frac`` in (0,
    ``OBSERVE_RATIO_MAX``]; memory read from the device, param bytes <=
    watermark <= limit; ``/metrics`` on 127.0.0.1 with every program's step
    histogram and ``/healthz`` ok. Prints the program rows."""
    from repro_torch.serving import (
        ClusterMetrics,
        MetricsServer,
        validate_chrome_trace,
        validate_request_timelines,
        write_chrome_trace,
    )
    from repro_torch.serving.trace import request_timelines

    tr = eng.tracer
    spans = tr.recorder.spans()
    n = validate_request_timelines(spans)
    gap = max(abs(sum(s.dur for s in tl if s.name != "retire") - tl[-1].attrs["latency_s"])
              for tl in request_timelines(spans).values())
    out_dir = ROOT / "build" / "observe"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{tag.replace(' ', '_')}.json"
    doc = write_chrome_trace(str(path), {tr.label: tr.recorder})
    events = validate_chrome_trace(json.loads(path.read_text()))
    print(f"[{tag}] trace: {n} request timelines valid (gate: {n_requests}), service phases "
          f"vs recorded latency max gap {gap:.3g} s (gate: 1e-6), {tr.open_count()} spans "
          f"open, {tr.recorder.total} recorded, {tr.recorder.dropped} dropped (gate: 0); "
          f"{path.relative_to(ROOT)}: {events} duration events, valid (gate)", flush=True)
    if (n != n_requests or gap > 1e-6 or tr.open_count() or tr.recorder.dropped
            or events != len(spans) or events != len(doc["traceEvents"]) - sum(
                e["ph"] == "M" for e in doc["traceEvents"])):
        raise AssertionError(f"[{tag}] the trace fails its gates")
    m = eng.metrics
    snap = m.snapshot()
    missing = set(eng._programs) - set(m.program_costs)
    perf = snap["program_perf"]
    served = {k: r for k, r in perf.items() if r.get("steps")}
    print(f"[{tag}] {len(eng._programs)} programs, cost rows for all: {not missing} (gate); "
          f"peaks {m.peaks['device_kind']} ({m.peaks['peak_kind']} "
          f"{m.peaks['peak_flops'] / 1e12:.0f} TFLOP/s, HBM {m.peaks['hbm_bw'] / 1e12:.2f} "
          f"TB/s, assumed {m.peaks['assumed']}); program_perf of the {len(served)} served "
          f"programs ({smi}, device time from CUDA events):", flush=True)
    for key, r in served.items():
        print(f"[{tag}]   {key}: {r['steps']} steps, p50 {r['step_p50_ms']:.4f} ms, flops "
              f"{r['flops']:.4g}, hbm bytes {r['hbm_bytes']:.4g}, mfu {r.get('mfu')}, "
              f"hbm_util {r.get('hbm_util')}, achieved {r.get('achieved_hbm_gbps')} GB/s, "
              f"roofline_frac {r.get('roofline_frac')}, bound {r.get('bound')}", flush=True)
    bad = {k: r for k, r in served.items()
           if not all(0 < r.get(f, 0) <= OBSERVE_RATIO_MAX
                      for f in ("mfu", "hbm_util", "roofline_frac"))}
    if missing or not served or bad or m.peaks["assumed"]:
        raise AssertionError(f"[{tag}] program rows fail: missing costs {missing}, out of "
                             f"(0, {OBSERVE_RATIO_MAX}] {bad}, peaks {m.peaks}")
    mem = snap["memory"]
    if not mem or mem.get("source") != "device":
        raise AssertionError(f"[{tag}] memory row {mem}: not read from the device")
    print(f"[{tag}] memory ({mem['source']}): params {mem['param_bytes'] / 1e9:.3f} GB, "
          f"K/V cache {mem['kv_cache_bytes'] / 1e9:.3f} GB, in use "
          f"{mem['bytes_in_use'] / 1e9:.3f} GB, watermark {mem['watermark_bytes'] / 1e9:.3f} "
          f"GB, limit {mem['bytes_limit'] / 1e9:.2f} GB (gate: source device, params <= "
          f"watermark <= limit)", flush=True)
    if not (mem["source"] == "device"
            and mem["param_bytes"] <= mem["watermark_bytes"] <= mem["bytes_limit"]):
        raise AssertionError(f"[{tag}] memory row {mem}")
    cm = ClusterMetrics([m])
    with MetricsServer(cm.export_prometheus, snapshot_fn=cm.snapshot) as srv:
        status, text = _get(srv.url + "/metrics")
        hz_status, hz = _get(srv.url + "/healthz")
    keys = set(snap["step_latency_ms"])
    scraped = {line.split('"')[1] for line in text.splitlines()
               if line.startswith("repro_step_latency_seconds_count{")}
    print(f"[{tag}] /metrics on {srv.url}: HTTP {status}, {len(text.splitlines())} lines, step "
          f"histograms of {len(scraped)} programs (gate: all {len(keys)}); /healthz HTTP "
          f"{hz_status} {hz}", flush=True)
    if status != 200 or scraped != keys or hz_status != 200 or json.loads(hz)["status"] != "ok":
        raise AssertionError(f"[{tag}] the metrics endpoint fails its gates")
    return {"perf": served, "memory": mem, "spans": len(spans)}


def _replay_span(tag: str, label: str, smi: str, fn, n: int = 5) -> dict:
    """A graph replay's device time in a ``torch.profiler`` trace: ``n``
    calls of ``fn``, each synchronised; the replay's device operations are
    those that share its launch's correlation id (the largest such groups,
    one a call). Per replay its span (first start to last end) and its
    kernel time (the summed durations); medians over the calls."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
                torch.cuda.synchronize()
    groups: dict = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()
                and not e.name().startswith("Memcpy HtoD")):
            groups.setdefault(e.correlation_id(), []).append((e.start_ns(), e.end_ns()))
    replays = sorted(groups.values(), key=len)[-n:]
    if len(replays) != n or len(replays[0]) < len(replays[-1]) // 2:
        raise AssertionError(f"[{tag}] {label}: launch sizes {sorted(map(len, groups.values()))}"
                             f" for {n} replays")
    span = float(np.median([max(e for _, e in g) - min(b for b, _ in g) for g in replays])) / 1e6
    busy = float(np.median([sum(e - b for b, e in g) for g in replays])) / 1e6
    print(f"[{tag}] {label} ({smi}): in a profiler trace a replay's kernels take {busy:.4f} ms "
          f"of its device span {span:.4f} ms (busy share {busy / span:.3f}), {len(replays[-1])} "
          f"device operations", flush=True)
    return {"span_ms": span, "kernel_ms": busy}


def _check_step_time(tag: str, key: str, obs: dict, prof: dict) -> dict:
    """Gate: the served program's step p50 (CUDA events its graph records
    at its first and last node) is its device time: at least
    ``OBSERVE_TICK_RATIO[0]`` x the profiled replay's kernel time (not an
    enqueue time) and at most ``OBSERVE_TICK_RATIO[1]`` x its profiled
    device span (no host time inside)."""
    row = obs["perf"][key]
    p50 = row["step_p50_ms"]
    lo, hi = OBSERVE_TICK_RATIO
    out = {"p50_ms": p50, "vs_kernels": p50 / prof["kernel_ms"], "vs_span": p50 / prof["span_ms"],
           **prof}
    print(f"[{tag}] {key}: event-timed step p50 {p50:.4f} ms over {row['steps']} steps = "
          f"{out['vs_kernels']:.3f}x the profiled replay's kernel time (gate: >= {lo}) and "
          f"{out['vs_span']:.3f}x its device span (gate: <= {hi})", flush=True)
    if not (out["vs_kernels"] >= lo and out["vs_span"] <= hi):
        raise AssertionError(f"[{tag}] {key}: step p50 outside its device time: {out}")
    return out


def phase_observe_lm(qcfg, params, single: dict, smi: str) -> dict:
    """Observability on phase 7's OLMoE-1B-7B int8 tree: a second engine
    with ``trace.enable`` (graphs on, annotations off) serves phase 7's 16
    requests; gates: every token equal to phase 7's untraced engine's,
    ``retraces`` 0, launches per forward unchanged, ``_check_observed``,
    and the decode tick's step p50 (device time from CUDA events the graph
    records) against a profiled replay of the tick (``_check_step_time``).
    Then
    one eager step with ``annotate_kernels`` profiled: its
    ``record_function`` ranges per wrapper equal the wrapper's launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.programs import own

    tag = "observe lm"
    eng = ServeEngine(_traced_config(qcfg), params, batch_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                      device="cuda")
    warm = _warm(tag, eng)
    reqs = _lm_requests(qcfg.vocab_size)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    c = eng.metrics.counters
    forwards = c["prefill_batches"] + c["decode_ticks"]
    same = [list(r.generated) for r in reqs] == single["tokens"]
    tokens = sum(len(r.generated) for r in reqs)
    print(f"[{tag}] traced engine, phase 7's {len(reqs)} requests: tokens identical to the "
          f"untraced engine's: {same} (gate); smoke figure ({smi}): {tokens / wall:.1f} tok/s "
          f"traced vs {single['tok_s']:.1f} untraced (phase 7, same requests); launches "
          f"{counts}", flush=True)
    if not same:
        raise AssertionError(f"[{tag}] tracing changed the served tokens")
    for name, per in LM_PER_FORWARD.items():
        if counts[name] != per * forwards:
            raise AssertionError(f"[{tag}] {name}: {counts[name]} launches for {forwards} "
                                 f"forwards, expected {per} per forward")
    _check_retraces(tag, eng)
    obs = _check_observed(tag, eng, len(reqs), smi)
    # the decode tick's event-timed p50 against a profiled replay
    key = eng._program_key("decode")
    tick = eng._programs[key]
    pos = np.full(LM_SLOTS, OBSERVE_TICK_FILL, np.int32)
    prof = _replay_span(tag, f"decode tick at fill {OBSERVE_TICK_FILL}, graph", smi,
                        lambda: own(tick, tick(eng._tok, pos)))
    step = _check_step_time(tag, key, obs, prof)
    del eng, tick
    _release()
    # kernel annotations on an eager step: ranges per wrapper = launches
    from torch.profiler import ProfilerActivity, profile

    eager = ServeEngine(_eager(_traced_config(qcfg, annotate=True)), params,
                        batch_slots=LM_SLOTS, max_len=LM_MAX_LEN, device="cuda")
    try:
        if not ops.kernel_annotations_enabled():
            raise AssertionError(f"[{tag}] annotate_kernels did not turn the ranges on")
        _warm(f"{tag} eager", eager)
        for r in _lm_requests(qcfg.vocab_size)[:LM_SLOTS]:
            eager.submit(r)
        torch.cuda.synchronize()
        _reset_counts()
        with profile(activities=[ProfilerActivity.CPU]) as p:
            eager.step()  # one packed admission and one decode tick
            torch.cuda.synchronize()
        launched = _read_counts()
    finally:
        ops.set_kernel_annotations(False)
    ranges = {}
    for ev in p.events():
        name = ev.name.split("[", 1)[0]
        if "[" in ev.name and name in ("int8_matmul", "grouped_matmul", "attention", "rmsnorm"):
            ranges[name] = ranges.get(name, 0) + 1
    want = {"int8_matmul": launched["int8_matmul"], "grouped_matmul": launched["grouped_matmul"],
            "attention": launched["lm_attention"], "rmsnorm": launched["rmsnorm"]}
    fwd = eager.metrics.counters["prefill_batches"] + eager.metrics.counters["decode_ticks"]
    print(f"[{tag}] eager step ({fwd} forwards) with annotate_kernels: record_function ranges "
          f"{ranges} vs wrapper launches {want} (gate: equal, {LM_PER_FORWARD} a forward)",
          flush=True)
    if ranges != want or any(launched[k] != v * fwd for k, v in LM_PER_FORWARD.items()):
        raise AssertionError(f"[{tag}] annotation ranges {ranges}, launches {launched}")
    eager.evict()  # drains the retirement thread; the rest is not served
    del eager
    _release()
    return {"counts": counts, "tok_s": tokens / wall, "warmup": warm, "tick": step, **obs}


def phase_observe_vision(qcfg, p_int8, single, smi: str) -> dict:
    """Observability on phase 4's M3ViT-S int8 tree: a traced graph engine
    and phase 4's engine (``single``) serve the same requests in the same
    batches (24 queued then flushed: three of 8; then 4; then 1, so each
    bucket 1, 4, 8 runs); gates: classes and probabilities bit-equal,
    ``retraces`` 0, launches per batch exact, ``_check_observed``, and the
    ``classify|b=8`` step p50 against a profiled replay of a dispatch of 8
    (``_check_step_time``)."""
    from repro_torch.models.vit import PATCH_DIM
    from repro_torch.serving import VisionEngine, synth_requests
    from repro_torch.serving.programs import own

    tag = "observe vision"
    eng = VisionEngine(_traced_config(qcfg), p_int8, batch_buckets=(1, 4, 8), max_wait_s=2e-3,
                       device="cuda")
    warm = _warm(tag, eng)
    served = {}
    for label, e in (("untraced", single), ("traced", eng)):
        served[label] = synth_requests(qcfg, 29, seed=7)
        if e is eng:
            _reset_counts()
        for lo, hi in ((0, 24), (24, 28), (28, 29)):
            for r in served[label][lo:hi]:
                e.submit(r)
            e.flush()
    counts = _read_counts()
    same = all(np.array_equal(a.classes, b.classes) and np.array_equal(a.probs, b.probs)
               for a, b in zip(served["untraced"], served["traced"]))
    batches = eng.metrics.counters["batches"]
    print(f"[{tag}] traced vs phase 4's engine, 29 requests in batches of 8, 8, 8, 4, 1: "
          f"classes and probabilities bit-equal {same} (gate); launches {counts}", flush=True)
    if not same:
        raise AssertionError(f"[{tag}] tracing changed the classes or probabilities")
    for name, per in PER_FORWARD.items():
        if counts[name] != per * batches:
            raise AssertionError(f"[{tag}] {name}: {counts[name]} launches for {batches} batches")
    _check_retraces(tag, eng)
    obs = _check_observed(tag, eng, 29, smi)
    prog = eng._programs["classify|b=8"]
    xs = np.zeros((8, qcfg.image_tokens - 1, PATCH_DIM), np.float32)
    prof = _replay_span(tag, "dispatch of 8, graph", smi, lambda: own(prog, prog(xs)))
    step = _check_step_time(tag, "classify|b=8", obs, prof)
    del eng, prog
    _release()
    return {"counts": counts, "warmup": warm, "b8": step, **obs}


# ---------------------------------------------------------------------------
# expert parallelism: an EP mesh's slots on the one card
# ---------------------------------------------------------------------------

EP_VISION_SLOTS = (4, 16)  # M3ViT-S's 16 experts over 4 and 16 slots
EP_LM_SLOTS = 4  # OLMoE-1B-7B's 64 experts over 4 slots (the tick also at 2)
EP_TF_STEPS = (0, 1)  # teacher-forced: the admission's logits and a tick's
EP_GSHARD_TOKENS = 512
# capacity_factor E / k: capacity int(T k f / E) + 1 > T, clipped to T, so
# no expert can overflow
EP_GSHARD_DROPLESS = 64 / 8
EP_GSHARD_REL = 1e-4  # gshard vs grouped logits, relative to the largest |logit|


def _ep_config(cfg):
    import dataclasses

    return cfg.replace(moe=dataclasses.replace(cfg.moe, moe_exec="expert_parallel"))


def _ep_mesh(n: int):
    """An EP mesh of ``n`` slots, every one on ``cuda:0``."""
    from repro_torch.launch.mesh import make_ep_mesh

    return make_ep_mesh(n, devices=["cuda:0"] * n)


@contextlib.contextmanager
def _grouped_mlp_experts():
    """The experts in the weight operands (wi, wo) of every
    ``ops.grouped_mlp`` call made inside (a capture makes its calls)."""
    from repro_torch.kernels import ops

    real, seen = ops.grouped_mlp, []

    def recorded(x, wi, wo, *args, **kw):
        seen.append((wi.shape[0], wo.shape[0]))
        return real(x, wi, wo, *args, **kw)

    ops.grouped_mlp = recorded
    try:
        yield seen
    finally:
        ops.grouped_mlp = real


def _check_local_experts(tag: str, seen: list, n: int, E: int) -> None:
    experts = sorted({e for pair in seen for e in pair})
    print(f"[{tag}] {len(seen)} per-slot grouped MLP calls captured, experts in their weight "
          f"operands {experts} (gate: {E // n} = {E} / {n})", flush=True)
    if experts != [E // n] or not seen or len(seen) % n:
        raise AssertionError(f"[{tag}] per-slot calls saw {experts} experts, {len(seen)} calls")


def _ep_grouped_rows(gen, smi: str) -> list:
    """The grouped kernel at the shapes a slot's call takes on this phase's
    paths: the E/n local experts of one slot, the rows it receives (every
    slot's worst-case capacity C = T_loc k: real rows spread over the
    experts, the padding rows in the last group), int8: bit-equal to the
    plain version in every variant that takes the widths, and timed
    (``_grouped_timing``: its variant beside dp4a, warm and at decode cold,
    the plain version, the bound)."""
    E_lm, k_lm, E_v, k_v = 64, 8, 16, 2
    shapes = []
    for label, T, k, E, n, Din, Dout, cold in (
            ("ep decode fc1, 4 slots", LM_SLOTS, k_lm, E_lm, 4, 2048, 2048, True),
            ("ep admission fc1, 4 slots", LM_MAX_LEN, k_lm, E_lm, 4, 2048, 2048, False),
            ("ep M3ViT-S b=8 fc1, 4 slots", 8 * 197, k_v, E_v, 4, 384, 1536, False),
            ("ep M3ViT-S b=8 fc1, 16 slots", 8 * 197, k_v, E_v, 16, 384, 1536, False)):
        t_loc = -(-T // n)
        rows, real = n * t_loc * k, t_loc * k
        sizes = _routing(gen, real, E // n)
        sizes[-1] += rows - real
        shapes.append((label, rows, E // n, Din, Dout, sizes.tolist(), cold))
    out, checked = [], {}
    for label, T, G, Din, Dout, sizes, cold in shapes:
        x, w, sz, ws, a_s = _grouped_operands(gen, T, G, Din, Dout, False, sizes)
        _check_grouped_variants(x, w, sz, ws, a_s, checked)
        row = _grouped_timing(label, x, w, sz, ws, a_s, cold=cold)
        out.append(row)
    print(f"[ep kernels] grouped int8 at the slots' shapes, every variant bit-equal to the "
          f"plain version: {checked} ({smi})", flush=True)
    return out


def phase_ep_vision(qcfg, p_int8, single, smi: str) -> dict:
    """Expert parallelism, vision part, on phase 4's M3ViT-S int8 tree:
    ``VisionEngine``s over an EP mesh of 4 and of 16 slots on ``cuda:0``,
    graphs on, serve phase 4's 24 requests (batches of 8) beside phase 4's
    engine (``single``); gates: classes, probabilities and ``expert_tokens``
    bit-equal, ``retraces`` 0, launches per batch exact (grouped: n x 12),
    every per-slot call's weight operand 16 / n experts, the graph nodes
    equal to the launches; one dispatch of 8 profiled at 1, 4 and 16
    slots."""
    from repro_torch.models.vit import PATCH_DIM
    from repro_torch.serving import VisionEngine, synth_requests
    from repro_torch.serving.programs import own

    torch.cuda.reset_peak_memory_stats()
    grouped_rows = _ep_grouped_rows(torch.Generator(device="cuda").manual_seed(23), smi)
    E = qcfg.moe.num_experts
    cfg = _ep_config(qcfg)
    before = single.metrics.expert_tokens.copy()
    ref = synth_requests(qcfg, 24, seed=3)
    for r in ref:
        single.submit(r)
    single.flush()
    ref_tokens = single.metrics.expert_tokens - before
    xs = np.zeros((8, qcfg.image_tokens - 1, PATCH_DIM), np.float32)
    prog = single._programs["classify|b=8"]
    out = {"counts": {}, "grouped_rows": grouped_rows, "runs": {1: {"profile": _profile(
        "ep vision 1", "dispatch of 8, graph", smi, 3, lambda: own(prog, prog(xs)),
        expect=PER_FORWARD)}}}
    for n in EP_VISION_SLOTS:
        tag = f"ep vision {n}"
        per = dict(PER_FORWARD, grouped_matmul=n * PER_FORWARD["grouped_matmul"])
        with _grouped_mlp_experts() as seen:
            eng = VisionEngine(cfg, p_int8, batch_buckets=(1, 4, 8), max_wait_s=2e-3,
                               mesh=_ep_mesh(n))
            warm = _warm(tag, eng)
        _check_local_experts(tag, seen, n, E)
        _check_programs(tag, eng, per)
        reqs = synth_requests(qcfg, 24, seed=3)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        batches = eng.metrics.counters["batches"]
        same = all(np.array_equal(a.classes, b.classes) and np.array_equal(a.probs, b.probs)
                   for a, b in zip(reqs, ref))
        tokens_same = np.array_equal(eng.metrics.expert_tokens, ref_tokens)
        print(f"[{tag}] phase 4's 24 requests in {batches} batches vs phase 4's engine: "
              f"classes and probabilities bit-equal {same}, expert_tokens equal {tokens_same} "
              f"(gates); smoke figure ({smi}): {len(reqs) / wall:.1f} frames/s; launches "
              f"{counts}", flush=True)
        if not (same and tokens_same):
            raise AssertionError(f"[{tag}] the EP engine's answers differ from phase 4's")
        for name, want in per.items():
            if counts[name] != want * batches:
                raise AssertionError(f"[{tag}] {name}: {counts[name]} launches for {batches} "
                                     f"batches, expected {want} per forward")
        _check_grouped_variants_used(tag, counts)
        _check_retraces(tag, eng)
        prog = eng._programs["classify|b=8"]
        prof = _profile(tag, "dispatch of 8, graph", smi, 3, lambda: own(prog, prog(xs)),
                        expect=per)
        _check_kernels_per_call(tag, prof, per)
        out["runs"][n] = {"warmup": warm, "fps": len(reqs) / wall, "profile": prof}
        for key, v in counts.items():
            out["counts"][key] = out["counts"].get(key, 0) + v
        del eng, prog
        _release()
    rows = "; ".join(
        f"{n} slot{'s' * (n > 1)} {r['profile']['device_ms']:.3f} ms device, "
        f"{r['profile']['kernels']:.0f} kernels, grouped {r['profile']['grouped_matmul_ms']:.3f} "
        f"ms in {r['profile']['grouped_matmul_kernels']:.0f}" for n, r in out["runs"].items())
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"[ep vision] dispatch of 8 as a graph replay ({smi}): {rows}; allocator peak during "
          f"the phase {out['peak_bytes'] / 1e9:.2f} GB", flush=True)
    return out


def phase_ep_gshard(cfg, params, smi: str) -> dict:
    """The GShard capacity path on phase 7's fp OLMoE-1B-7B tree: eager
    forwards of a 512-token prompt through ``impl="gshard"`` with TF32 off,
    beside the grouped path's forward. At ``capacity_factor`` 4.0 (the
    reference's ``lowering_config``) the random router overloads experts
    and slots drop; gate: every layer keeps min(load, capacity) slots of
    each expert, its load counted from the router on the layer's input. At
    ``EP_GSHARD_DROPLESS`` (capacity = the token count: nothing can drop)
    gates: every slot kept (512 x 8 a layer) and the logits within
    ``EP_GSHARD_REL`` of the grouped path's, relative to its largest
    |logit|."""
    import dataclasses

    from repro_torch.core.moe.dispatch import capacity
    from repro_torch.core.moe.router import route_topk
    from repro_torch.models import synth_batch, transformer

    E, k, T = cfg.moe.num_experts, cfg.moe.top_k, EP_GSHARD_TOKENS
    tokens = torch.from_numpy(synth_batch(cfg, 1, T, seed=9)).cuda()
    layers, real = [], transformer._moe_apply

    def recorded(x, p, c, taps=None):
        y, aux, kept = real(x, p, c, taps=taps)
        e = route_topk(x.reshape(-1, x.shape[-1]), p["gate"], p.get("gate_b"), k
                       ).experts.reshape(-1).long()
        load = torch.zeros(E, dtype=torch.int64, device=x.device)
        layers.append((kept.long(), load.index_add_(0, e, torch.ones_like(e))))
        return y, aux, kept

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    transformer._moe_apply = recorded
    _reset_counts()
    out = {}
    try:
        with torch.inference_mode():
            grouped = transformer.forward(params, cfg, tokens)[0]
            scale = float(grouped.abs().max())
            for factor in (4.0, EP_GSHARD_DROPLESS):
                gcfg = cfg.replace(moe=dataclasses.replace(cfg.moe, impl="gshard",
                                                           capacity_factor=factor))
                layers.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gs = transformer.forward(params, gcfg, tokens)[0]
                torch.cuda.synchronize()
                cap = capacity(T, k, E, factor)
                out[factor] = {
                    "wall_s": time.perf_counter() - t0, "cap": cap,
                    "kept": [int(kept.sum()) for kept, _ in layers],
                    "min_load_cap": all(torch.equal(kept, torch.clamp(load, max=cap))
                                        for kept, load in layers),
                    "rel_err": max_err(gs, grouped) / scale}
    finally:
        transformer._moe_apply = real
        torch.backends.cuda.matmul.allow_tf32 = tf32
    counts = _read_counts()
    for factor, r in out.items():
        print(f"[ep gshard] fp tree, {T}-token prompt, TF32 off, capacity_factor {factor} "
              f"(capacity {r['cap']}): kept slots per layer {r['kept']} of {T * k}, each "
              f"expert's kept slots = min(its load, capacity) in every layer: "
              f"{r['min_load_cap']} (gate); logits vs the grouped path: relative to max "
              f"|logit| {scale:.3g}: {r['rel_err']:.3g}; forward {r['wall_s']:.2f} s wall "
              f"({smi})", flush=True)
    dropless = out[EP_GSHARD_DROPLESS]
    none_dropped = dropless["kept"] == [T * k] * cfg.num_layers
    print(f"[ep gshard] at capacity = {T} tokens: none dropped {none_dropped} (gate), "
          f"relative logit error {dropless['rel_err']:.3g} (gate: <= {EP_GSHARD_REL})",
          flush=True)
    if not (all(r["min_load_cap"] for r in out.values()) and none_dropped
            and dropless["rel_err"] <= EP_GSHARD_REL):
        raise AssertionError("[ep gshard] kept slots or logits off")
    return {"counts": counts, **{f"factor {f}": r for f, r in out.items()}}


def phase_ep_lm(qcfg, trees: dict, single: dict, smi: str) -> dict:
    """Expert parallelism, LM part, on phase 7's OLMoE-1B-7B int8 tree: a
    ``ServeEngine`` over 4 slots on ``cuda:0`` (packed path, graphs on, 8
    slots, max_len 512) serves phase 7's 16 requests (gates: tokens
    identical to phase 7's engine, teacher-forced logits at
    ``EP_TF_STEPS`` bit-equal to the single path's ``prefill``,
    ``retraces`` 0, launches per forward exact with grouped 4 x 32, graph
    nodes equal, per-slot weight operands of 16 experts); the tick and the
    512-token admission profiled at 4 slots and on an engine of 2 slots;
    one eager forward of the W4A8 tree at 2 slots bit-equal to the single
    path; ``ServingCluster(..., devices=["cuda:0"] * 8, standby=1)``: one
    replica over 4 slots and a standby over 4 more, the same tokens, every
    request delivered once, an eviction (the watchdog's stall rule)
    backfilled; a mesh over a second card refused."""
    from repro_torch.launch.mesh import make_ep_mesh
    from repro_torch.models import synth_batch, transformer
    from repro_torch.distributed.expert_parallel import use_ep_mesh
    from repro_torch.serving import EventLog, ServeEngine, ServingCluster

    torch.cuda.reset_peak_memory_stats()
    E = qcfg.moe.num_experts
    cfg, p_int8 = _ep_config(qcfg), trees["int8"]
    n = EP_LM_SLOTS
    tag = f"ep lm {n}"
    per = dict(LM_PER_FORWARD, grouped_matmul=n * LM_PER_FORWARD["grouped_matmul"])
    with _grouped_mlp_experts() as seen:
        eng = ServeEngine(cfg, p_int8, batch_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                          mesh=_ep_mesh(n), keep_logits=True)
        warm = _warm(tag, eng)
    _check_local_experts(tag, seen, n, E)
    _check_programs(tag, eng, per)
    reqs = _lm_requests(qcfg.vocab_size)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    c = eng.metrics.snapshot()["counters"]
    forwards = c["prefill_batches"] + c["decode_ticks"]
    for name, want in per.items():
        if counts[name] != want * forwards:
            raise AssertionError(f"[{tag}] {name}: {counts[name]} launches for {forwards} "
                                 f"forwards, expected {want} per forward")
    _check_int8_variants(tag, counts)
    _check_grouped_variants_used(tag, counts)
    _check_retraces(tag, eng)
    differ = [r.uid for r, want in zip(reqs, single["tokens"]) if r.generated != want]
    errs = np.concatenate([_teacher_forced(p_int8, qcfg, r, EP_TF_STEPS)[0] for r in reqs])
    tokens = sum(len(r.generated) for r in reqs)
    print(f"[{tag}] phase 7's {len(reqs)} requests: tokens identical to phase 7's engine "
          f"{not differ} (gate; differing {differ}); teacher-forced logits at steps "
          f"{list(EP_TF_STEPS)} vs the single path's prefill, max err {errs.max():.3g} "
          f"(gate: bit-equal); smoke figure ({smi}): {tokens / wall:.1f} tok/s vs "
          f"{single['tok_s']:.1f} on one slot (phase 7); launches {counts}", flush=True)
    if differ or errs.max() != 0:
        raise AssertionError(f"[{tag}] the EP engine differs from the single path")
    profiles = {1: {k: single["profile"][k] for k in ("decode tick, graph",
                                                     "packed prefill 512, graph")}}
    profiles[n] = _profile_lm_steps(eng, tag, "graph", smi, per)
    del eng
    _release()
    # two slots: an engine whose tick and 512-token admission are built
    # for the profile alone
    per2 = dict(LM_PER_FORWARD, grouped_matmul=2 * LM_PER_FORWARD["grouped_matmul"])
    eng2 = ServeEngine(cfg, p_int8, batch_slots=LM_SLOTS, max_len=LM_MAX_LEN, mesh=_ep_mesh(2))
    profiles[2] = _profile_lm_steps(eng2, "ep lm 2", "graph", smi, per2)
    del eng2
    _release()
    for step, label, per_step in (("decode tick, graph", "decode tick (8 slots at fill 300)",
                                   LM_SLOTS), ("packed prefill 512, graph",
                                               "512-token packed admission", LM_MAX_LEN)):
        print(f"[ep lm] {label} as a graph replay ({smi}): " + "; ".join(
            f"{k} slot{'s' * (k > 1)} {p[step]['device_ms']:.3f} ms device, "
            f"{p[step]['kernels']:.0f} kernels, {per_step / p[step]['device_ms'] * 1e3:.1f} "
            f"tok/s, grouped {p[step]['grouped_matmul_ms']:.3f} ms in "
            f"{p[step]['grouped_matmul_kernels']:.0f}" for k, p in sorted(profiles.items())),
            flush=True)

    # the W4A8 tree: one eager forward at 2 slots against the single path
    x = torch.from_numpy(synth_batch(qcfg, 2, 64, seed=11)).cuda()
    _reset_counts()
    with torch.inference_mode():
        want = transformer.forward(trees["int4"], qcfg, x)[0]
        with use_ep_mesh(_ep_mesh(2)):
            got = transformer.forward(trees["int4"], cfg, x)[0]
    w4 = _read_counts()
    w4_same = torch.equal(got, want)
    print(f"[ep lm W4A8] eager forward of 2 x 64 tokens at 2 slots vs the single path: "
          f"logits bit-equal {w4_same} (gate); W4A8 grouped launches "
          f"{w4.get('grouped_matmul:w4a8', 0)} (gate: 32 + 2 x 32)", flush=True)
    if not w4_same or w4.get("grouped_matmul:w4a8", 0) != 3 * 32:
        raise AssertionError("[ep lm W4A8] the EP forward differs from the single path")

    # the cluster: one EP replica and one standby, each over n slots of
    # cuda:0 (the device list split into two groups), as phase 9's LM
    # cluster has a standby. The packed engine's step() returns after its
    # enqueue, so the watchdog reads steps of a few ms and, now and then, a
    # step blocked on the device for 50-150 ms; two such steps in a row over
    # the default stall rule (max(8 x EMA, 50 ms)) evict the replica, in the
    # port as in the reference (tests/test_torch_faults.py replays this
    # phase's traces through both). With no standby the cluster then went
    # degraded and never drained; the standby backfills the eviction and the
    # gates below hold as they do without one
    ctag = "ep cluster lm"
    events = EventLog()
    cluster = ServingCluster(cfg, p_int8, devices=["cuda:0"] * (2 * n), standby=1,
                             engine="lm", batch_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                             events=events)
    shape = ([_inner(e).mesh.shape for e in cluster.engines],
             [_inner(e).mesh.shape for e in cluster._standby])
    print(f"[{ctag}] replicas and standby with their meshes: {shape} (gate: one replica "
          f"and one standby, each {{'model': {n}}})", flush=True)
    if shape != ([{"model": n}], [{"model": n}]):
        raise AssertionError(f"[{ctag}] the EP cluster built {shape}")
    _check_shared_weights(ctag, cluster, p_int8)
    cwarm = _cluster_warmup(ctag, cluster, per, smi)
    creqs = _lm_requests(qcfg.vocab_size)
    fired, _ = _delivery(creqs)
    timer = _StepTimer(cluster)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in creqs:
        cluster.submit(r)
    steps = timer.run_until_idle()
    torch.cuda.synchronize()
    cwall = time.perf_counter() - t0
    ccounts = _read_counts()
    cc = cluster.metrics.snapshot()["aggregate"]["counters"]
    _check_delivered_once(ctag, creqs, fired)
    health = cluster.health()
    backfilled = [e["replacement"] for e in events.events("replica_replaced")]
    print(f"[{ctag}] health {health['status']}, evictions {len(health['evicted'])} "
          f"{health['evicted']}, backfilled by {backfilled}, re-dispatched "
          f"{sorted(r.uid for r in creqs if r.redispatched)}; watchdog ({smi}): "
          f"{timer.watchdog_trace()}", flush=True)
    timer.check_evictions(ctag)
    if health["status"] != "ok" or len(backfilled) != len(health["evicted"]):
        raise AssertionError(f"[{ctag}] an eviction was not backfilled: {health}")
    cdiffer = [r.uid for r, want in zip(creqs, single["tokens"]) if r.generated != want]
    print(f"[{ctag}] tokens of every request identical to phase 7's engine: {not cdiffer} "
          f"(gate; differing {cdiffer}); smoke figure ({smi}): "
          f"{LM_REQUESTS * LM_NEW_TOKENS / cwall:.1f} tok/s, {steps} cluster steps, host time "
          f"of a step outside the replica: {timer.summary()}", flush=True)
    if cdiffer or cc.get("retraces", 0):
        raise AssertionError(f"[{ctag}] other tokens or retraces: {cdiffer}, {cc}")
    _check_cluster_launches(ctag, ccounts, cc["prefill_batches"] + cc["decode_ticks"], per)
    watched = [{"replica": k, "ms": d * 1e3, "ema_ms": None if ema is None else ema * 1e3,
                "armed": armed, "streak": streak, "verdict": verdict}
               for k, d, ema, armed, streak, verdict in timer.replay()]
    del cluster, timer
    _release()

    # a mesh over a second card is refused when the engine is built
    try:
        ServeEngine(cfg, p_int8, mesh=make_ep_mesh(2, devices=["cuda:0", "cuda:1"]))
    except NotImplementedError as e:
        refused = str(e)
    else:
        raise AssertionError("[ep lm] an engine over two cards was built")
    print(f"[ep lm] an engine over cuda:0 and cuda:1 raises NotImplementedError (gate): "
          f"{refused}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"[ep lm] allocator peak during the phase {peak / 1e9:.2f} GB", flush=True)
    return {"runs": {"engine": counts, "w4a8": w4, "cluster": ccounts},
            "tok_s": tokens / wall, "profiles": profiles, "warmup": warm,
            "cluster_warmup": cwarm, "peak_bytes": peak, "cluster_health": health,
            "watchdog_steps": watched}


# ---------------------------------------------------------------------------
# autotune: the kernel autotuner at every served engine's warmup
# ---------------------------------------------------------------------------

AUTOTUNE_EP_SLOTS = 4  # the tuned EP engine of the LM part


def _tuned_config(cfg, cache_dir: str, eager: bool = False):
    """``cfg`` with ``autotune.enable`` and its table under ``cache_dir``
    (and, with ``eager``, ``serve.aot_warmup=False``)."""
    from repro_torch.configs import AutotuneConfig

    cfg = cfg.replace(autotune=AutotuneConfig(enable=True, cache_dir=cache_dir))
    return _eager(cfg) if eager else cfg


@contextlib.contextmanager
def _sweeps_watched():
    """Counts the autotuner's sweeps made inside, and those made while a
    CUDA graph was being captured (gate: none)."""
    from repro_torch.kernels import autotune

    real, seen = autotune.sweep_request, {"sweeps": 0, "in_capture": 0}

    def watched(*args, **kw):
        seen["sweeps"] += 1
        seen["in_capture"] += int(torch.cuda.is_current_stream_capturing())
        return real(*args, **kw)

    autotune.sweep_request = watched
    try:
        yield seen
    finally:
        autotune.sweep_request = real


def _tuned(tag: str, cfg, run) -> tuple:
    """``run()`` (which builds and warms a tuned engine of config ``cfg``)
    under watch; returns (its result, the keys it swept, the active
    table). Printed: the keys it swept whose pick differs from the rule's.
    Gates: no sweep inside a graph capture, the table's ``untakeable``
    0."""
    from repro_torch.kernels import autotune

    prev = autotune.active_table()
    n0, s0 = (prev.stats["swept"], prev.sweep_s) if prev is not None else (0, 0.0)
    kind = autotune.device_kind()
    before = set(autotune.TuningTable.load(autotune.table_path(cfg.autotune, kind),
                                           kind).entries)
    before |= set(prev.entries) if prev is not None else set()
    with _sweeps_watched() as seen:
        result = run()
    table = autotune.active_table()
    swept = table.stats["swept"] - (n0 if table is prev else 0)
    sweep_s = table.sweep_s - (s0 if table is prev else 0.0)
    moved = []
    for key in sorted(set(table.entries) - before):
        e = table.entries[key]
        rule = autotune.default_for(autotune.request_from_key(key))
        if e["choice"] != rule:
            moved.append(f"{key}: {rule} {e['candidates'][rule]:.5f} -> {e['choice']} "
                         f"{e['ms']:.5f} ms")
    print(f"[{tag}] autotune at warmup: {swept} keys swept in {seen['sweeps']} sweeps "
          f"({sweep_s:.2f} s), {seen['in_capture']} during a graph capture (gate: 0); "
          f"{autotune.summary()}; picks away from the rule: {moved}", flush=True)
    if seen["in_capture"] or table.stats["untakeable"]:
        raise AssertionError(f"[{tag}] a sweep inside a capture or an untakeable pick: "
                             f"{seen}, {table.stats}")
    return result, swept, table


def _check_table(tag: str, table) -> None:
    """Gates after serving: every kernel call outside the collection found
    its key (``misses`` 0) and every pick took its operands
    (``untakeable`` 0)."""
    s = table.stats
    print(f"[{tag}] table stats {s} (gates: misses 0, untakeable 0)", flush=True)
    if s["misses"] or s["untakeable"]:
        raise AssertionError(f"[{tag}] table misses or untakeable picks: {s}")


def _tune_report(tag: str, table, smi: str) -> dict:
    """Every key's candidates' device ms, the rule's pick and the tuned
    pick, printed; the keys whose picks differ returned."""
    from repro_torch.kernels import autotune

    differ = []
    for key in sorted(table.entries):
        e = table.entries[key]
        rule = autotune.default_for(autotune.request_from_key(key))
        times = ", ".join(f"{c} {ms:.5f}" for c, ms in e["candidates"].items())
        print(f"[{tag}] {key}: {times} ms; rule {rule}, tuned {e['choice']}", flush=True)
        if e["choice"] != rule:
            differ.append({"key": key, "rule": rule, "tuned": e["choice"],
                           "rule_ms": e["candidates"][rule], "tuned_ms": e["ms"]})
    print(f"[{tag}] {len(differ)} of {len(table.entries)} keys tuned away from the rule's "
          f"pick ({smi}): " + "; ".join(
              f"{d['key']}: {d['rule']} {d['rule_ms']:.5f} -> {d['tuned']} "
              f"{d['tuned_ms']:.5f} ms" for d in differ), flush=True)
    return {"keys": len(table.entries), "differ": differ}


def phase_autotune_vision(qcfg, p_int8, single, smi: str) -> dict:
    """Autotune, vision part, on phase 4's M3ViT-S int8 tree: a tuned
    ``VisionEngine`` (buckets 1, 4, 8, graphs on) in a fresh table, a
    second on the same table and a third from the table reloaded from
    disk, each serving phase 4's 24 requests (batches of 8). Gates: classes
    and probabilities bit-equal to phase 4's engine; the first sweeps, the
    second and third sweep nothing, the reloaded entries equal the first's;
    ``misses`` and ``untakeable`` 0; no sweep inside a capture. Printed:
    every key's candidates, the dispatch of 8 as a graph replay tuned and
    untuned (``_replay_ms``: no profiler, so the later observe gate's
    profiler history stays as it was)."""
    from repro_torch.kernels import autotune
    from repro_torch.models.vit import PATCH_DIM
    from repro_torch.serving import VisionEngine, synth_requests

    tag = "autotune vision"
    autotune.deactivate()

    def serve(e):
        reqs = synth_requests(qcfg, 24, seed=3)
        for r in reqs:
            e.submit(r)
        e.flush()
        return reqs

    ref = serve(single)
    xs = np.zeros((8, qcfg.image_tokens - 1, PATCH_DIM), np.float32)
    out = {"replay_ms": {"untuned": _replay_ms(single._programs["classify|b=8"], xs)}}
    with tempfile.TemporaryDirectory() as cache_dir:
        tcfg = _tuned_config(qcfg, cache_dir)
        first = None
        for label in ("first", "second", "reloaded"):
            if label == "reloaded":
                autotune.deactivate()  # a new process: the table from disk
            eng = VisionEngine(tcfg, p_int8, batch_buckets=(1, 4, 8), max_wait_s=2e-3,
                               device="cuda")
            warm, swept, table = _tuned(f"{tag} {label}", tcfg,
                                        lambda: _warm(f"{tag} {label}", eng))
            reqs = serve(eng)
            same = all(np.array_equal(a.classes, b.classes) and np.array_equal(a.probs, b.probs)
                       for a, b in zip(reqs, ref))
            print(f"[{tag} {label}] 24 requests in batches of 8 vs phase 4's engine: classes and "
                  f"probabilities bit-equal {same} (gate); keys swept {swept} (gate: "
                  f"{'> 0' if first is None else '0'})", flush=True)
            if not same or (swept == 0) != (first is not None):
                raise AssertionError(f"[{tag} {label}] other answers, or swept {swept}")
            _check_table(f"{tag} {label}", table)
            _check_retraces(f"{tag} {label}", eng)
            if first is None:
                first = dict(table.entries)
                out["sweep_s"], out["warmup"] = table.sweep_s, warm
                out["replay_ms"]["tuned"] = _replay_ms(eng._programs["classify|b=8"], xs)
            elif label == "reloaded" and table.entries != first:
                raise AssertionError(f"[{tag}] the reloaded table's entries differ")
            del eng
        out["report"] = _tune_report(tag, table, smi)
    autotune.deactivate()
    print(f"[{tag}] dispatch of 8 as a graph replay, device ms from the graph's own events "
          f"({smi}): untuned {out['replay_ms']['untuned']:.3f}, tuned "
          f"{out['replay_ms']['tuned']:.3f}; sweep {out['sweep_s']:.2f} s", flush=True)
    _release()
    return out


def _autotune_lm(tag: str, cfg, params, untuned: dict, cache_dir: str, smi: str,
                 per: dict, *, eager: bool = False, mesh=None, profile=None,
                 swept_zero: bool = False) -> dict:
    """A tuned ``ServeEngine`` (``_run_engine``: 8 slots, max_len 512,
    phase 7's 16 requests; over ``mesh`` where given) on the table under
    ``cache_dir``. Gates: every token equal to the untuned engine's
    (``untuned["tokens"]``), launches ``per`` a forward, (graphs)
    ``retraces`` 0, ``misses`` and ``untakeable`` 0, no sweep inside a capture, and with
    ``swept_zero`` no key swept. ``profile(engine)``: the tuned steps'
    profile."""
    tcfg = _tuned_config(cfg, cache_dir, eager)
    (eng, reqs, wall, counts, warm), swept, table = _tuned(tag, tcfg, lambda: _run_engine(
        tcfg, params, tag=tag, mesh=mesh))
    c = eng.metrics.snapshot()["counters"]
    forwards = c["prefill_batches"] + c["decode_ticks"]
    differ = [r.uid for r, want in zip(reqs, untuned["tokens"]) if r.generated != want]
    wrong = {name: counts.get(name, 0) for name, n in per.items()
             if counts.get(name, 0) != n * forwards}
    tok_s = len(reqs) * LM_NEW_TOKENS / wall
    print(f"[{tag}] phase 7's {len(reqs)} requests: tokens identical to the untuned engine's "
          f"{not differ} (gate; differing {differ}); launches {per} a forward (gate: exact; "
          f"off: {wrong}); keys swept {swept} (gate: {'0' if swept_zero else 'any'}); "
          f"{tok_s:.1f} tok/s ({smi})", flush=True)
    if differ or wrong or (swept_zero and swept):
        raise AssertionError(f"[{tag}] the tuned engine differs: tokens {differ}, launches "
                             f"{wrong}, swept {swept}")
    if not eager:  # an eager engine builds its programs on first use
        _check_programs(tag, eng, per)
        _check_retraces(tag, eng)
    _check_table(tag, table)
    out = {"tok_s": tok_s, "warmup": warm, "swept": swept}
    if profile is not None:
        out["profile"] = profile(eng)
    del eng, reqs
    _release()
    return out


def _print_tuned_steps(tag: str, untuned: dict, tuned: dict, smi: str) -> None:
    """The graph-replay device ms of each profiled step, untuned and tuned."""
    print(f"[{tag}] graph replays ({smi}): " + "; ".join(
        f"{label} untuned {untuned[label]['device_ms']:.3f} ms device, tuned "
        f"{prof['device_ms']:.3f} ms (grouped {untuned[label]['grouped_matmul_ms']:.3f} -> "
        f"{prof['grouped_matmul_ms']:.3f}, lm_attention {untuned[label]['lm_attention_ms']:.3f}"
        f" -> {prof['lm_attention_ms']:.3f})" for label, prof in tuned.items()), flush=True)


def _second_and_reloaded(tag: str, cfg, params, untuned: dict, cache_dir: str, smi: str,
                         per: dict, eager: bool = True) -> dict:
    """The cache-hit gates of a part: a second tuned engine on the same
    table serves the requests again, bit-equal, sweeping nothing (with
    ``eager``, ``aot_warmup=False``, so every kernel call of its serving
    looks its key up; the grouped path's prefill is eager either way);
    then a third from the table reloaded from disk (a new process's
    warmup) sweeps nothing and finds the same entries."""
    from repro_torch.kernels import autotune
    from repro_torch.serving import ServeEngine

    label = f"{tag} second{', eager' if eager else ''}"
    out = {"second": _autotune_lm(label, cfg, params, untuned, cache_dir, smi, per,
                                  eager=eager, swept_zero=True)}
    entries = dict(autotune.active_table().entries)
    autotune.deactivate()
    tcfg = _tuned_config(cfg, cache_dir, eager=True)
    eng = ServeEngine(tcfg, params, batch_slots=LM_SLOTS, max_len=LM_MAX_LEN, device="cuda")
    _, swept, table = _tuned(f"{tag} reloaded", tcfg, lambda: _warm(f"{tag} reloaded", eng))
    same = table.entries == entries
    print(f"[{tag} reloaded] a table reloaded from disk: {len(table.entries)} entries equal to "
          f"the first's {same}, keys swept {swept} (gates: equal, 0)", flush=True)
    if swept or not same:
        raise AssertionError(f"[{tag} reloaded] swept {swept}, entries equal {same}")
    _check_table(f"{tag} reloaded", table)
    del eng
    out["reloaded_swept"] = swept
    return out


def phase_autotune_lm_fp(cfg, params, fp: dict, cache_dir: str, smi: str) -> dict:
    """Autotune, LM part (a), while phase 7's fp OLMoE-1B-7B tree lives: a
    tuned packed engine (f32 grouped calls, bf16 cache) on a fresh table
    under ``cache_dir``, gated against ``_serve_lm_fp``'s engine
    (``_autotune_lm``); its tick and 512-token admission timed as graph
    replays beside the untuned engine's (``_lm_step_ms``: no profiler, so
    the observe phase's profiler history stays as it was)."""
    from repro_torch.kernels import autotune

    tag = "autotune lm fp"
    autotune.deactivate()
    out = _autotune_lm(tag, cfg, params, fp, cache_dir, smi, LM_FP_PER_FORWARD,
                       profile=_lm_step_ms)
    print(f"[{tag}] graph replays, device ms from the graphs' own events ({smi}): " + "; ".join(
        f"{label} untuned {fp['replay_ms'][label]:.3f}, tuned {ms:.3f}"
        for label, ms in out["profile"].items()), flush=True)
    autotune.deactivate()
    return out


def phase_autotune_lm(qcfg, trees: dict, runs: dict, cache_dir: str, smi: str) -> dict:
    """Autotune, LM part (b): tuned packed engines over the int8 and W4A8
    trees on the part's table, gated against phase 7's engines, their tick
    and admission profiled; then the int8 tree's second engine and reloaded
    table (``_second_and_reloaded``)."""
    from repro_torch.kernels import autotune

    out = {}
    for mat in ("int8", "int4"):
        tag = f"autotune lm {mat}"
        out[mat] = _autotune_lm(tag, qcfg, trees[mat], runs[mat], cache_dir, smi,
                                LM_PER_FORWARD, profile=lambda e, tag=tag: _profile_lm_steps(
                                    e, tag, "graph", smi, LM_PER_FORWARD))
        _print_tuned_steps(tag, runs[mat]["profile"], out[mat]["profile"], smi)
    out.update(_second_and_reloaded("autotune lm int8", qcfg, trees["int8"], runs["int8"],
                                    cache_dir, smi, LM_PER_FORWARD))
    autotune.deactivate()
    return out


def phase_autotune_lm_ep(qcfg, trees: dict, runs: dict, ep: dict, cache_dir: str,
                         smi: str) -> dict:
    """Autotune, LM part (c), after the EP phase: a tuned engine over an EP
    mesh of ``AUTOTUNE_EP_SLOTS`` slots on the int8 tree, on the part's
    table reloaded from disk (it sweeps only its per-slot keys), gated
    against phase 7's tokens; its tick and admission profiled beside the
    EP phase's. Then every key of the part's table printed."""
    from repro_torch.kernels import autotune

    n = AUTOTUNE_EP_SLOTS
    tag = f"autotune ep lm {n}"
    per = dict(LM_PER_FORWARD, grouped_matmul=n * LM_PER_FORWARD["grouped_matmul"])
    autotune.deactivate()
    out = _autotune_lm(tag, _ep_config(qcfg), trees["int8"], runs["int8"], cache_dir, smi, per,
                       mesh=_ep_mesh(n), profile=lambda e: _profile_lm_steps(
                           e, tag, "graph", smi, per))
    _print_tuned_steps(tag, ep["profiles"][n], out["profile"], smi)
    table = autotune.active_table()
    out["report"] = _tune_report("autotune lm", table, smi)
    out["sweep_s"] = table.sweep_s
    autotune.deactivate()
    return out


def phase_autotune_dense(cfg, params, qcfg, p_int8, runs: dict, profiles: dict,
                         smi: str) -> dict:
    """Autotune, dense part, inside phase 10: tuned grouped-path engines
    over the gemma2-2b fp and int8 trees on a fresh table (the hd-256
    decode keys meet ``decode`` against ``tile``), gated against phase
    10's engines, each tick profiled beside phase 10's; then the int8
    tree's second engine and reloaded table; every key printed."""
    from repro_torch.kernels import autotune

    autotune.deactivate()
    out = {}
    with tempfile.TemporaryDirectory() as cache_dir:
        for mat, c, p, per in (("fp", cfg, params, DENSE_FP_PER_FORWARD),
                               ("int8", qcfg, p_int8, DENSE_INT8_PER_FORWARD)):
            tag = f"autotune dense {mat}"
            out[mat] = _autotune_lm(tag, c, p, runs[mat], cache_dir, smi, per, profile=lambda e,
                                    mat=mat, per=per: {"decode tick, graph": _profile_dense_tick(
                                        e, f"{mat} tuned", smi, per)})
            _print_tuned_steps(tag, {"decode tick, graph": profiles[mat]}, out[mat]["profile"],
                               smi)
        out.update(_second_and_reloaded("autotune dense int8", qcfg, p_int8, runs["int8"],
                                        cache_dir, smi, DENSE_INT8_PER_FORWARD, eager=False))
        table = autotune.active_table()
        out["report"] = _tune_report("autotune dense", table, smi)
        out["sweep_s"] = table.sweep_s
    autotune.deactivate()
    return out


def phase_dense(smi: str) -> dict:
    """Phase 10: full-width gemma2-2b (``configs/gemma2_2b.py``, 26 layers in
    13 local/global pairs, hd 256, the local layers' K/V in a ring), last, on
    a card the earlier phases have left (see the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant.ptq import calibrate_model, ptq_model, quantized_config
    from repro_torch.models import init_model_params, synth_batch, tree_bytes

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 1e9
    if left > 1.0:  # the falcon-mamba tree and engines must be gone
        raise AssertionError(f"[dense] {left:.2f} GB of earlier phases still allocated")
    cfg = get_config(DENSE_ARCH)
    t0 = time.perf_counter()
    params = init_model_params(cfg, seed=0, device="cuda")
    calib = [torch.from_numpy(synth_batch(cfg, 2, 32, seed=s)).cuda() for s in (1, 2)]
    _reset_counts()
    taps = calibrate_model(cfg, params, calib)
    calib_counts = _read_counts()
    want = {"lm_attention:causal/float32/qb0": 2 * 26, "rmsnorm": 2 * 105, "int8_matmul": 0}
    if any(calib_counts.get(k, 0) != n for k, n in want.items()):
        raise AssertionError(f"[dense] calibration launches {calib_counts}, expected {want}")
    qcfg = quantized_config(cfg)
    p_int8 = ptq_model(qcfg, params, taps, materialize="int8")
    torch.cuda.synchronize()
    fp_bytes = tree_bytes(params)
    print(f"[dense] {cfg.name}: fp {fp_bytes / 1e9:.2f} GB -> int8 "
          f"{tree_bytes(p_int8) / 1e9:.2f} GB (the tied 256k embedding stays f32); "
          f"init+calibrate+PTQ {time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    out = {"calib_counts": calib_counts, "runs": {}}
    fp = _serve_dense(cfg, params, "fp", DENSE_FP_PER_FORWARD, smi)
    out["runs"]["fp"] = fp
    q8 = _serve_dense(qcfg, p_int8, "int8", DENSE_INT8_PER_FORWARD, smi)
    out["runs"]["int8"] = q8
    out["runs"]["ring"] = _dense_ring(cfg, params, smi)
    tick_bound = 1e3 * fp_bytes / HBM_BYTES_PER_S
    out["profile"] = {}
    for mat, run, per in (("fp", fp, DENSE_FP_PER_FORWARD), ("int8", q8, DENSE_INT8_PER_FORWARD)):
        prof = _profile_dense_tick(run.pop("engine"), mat, smi, per)
        out["profile"][mat] = prof
    _release()
    out["autotune"] = _timed(phase_autotune_dense, cfg, params, qcfg, p_int8, out["runs"],
                             out["profile"], smi)
    print(f"[dense] fp tick byte bound {tick_bound:.3f} ms ({fp_bytes / 1e9:.2f} GB of f32 "
          f"weights at {HBM_BYTES_PER_S / 1e12:.2f} TB/s): graph replay "
          f"{out['profile']['fp']['device_ms']:.3f} ms of device time "
          f"({out['profile']['fp']['device_ms'] / tick_bound:.2f}x); lm_attention a call on "
          f"the path: fp {out['profile']['fp']['lm_attention_ms'] / 26:.4f} ms, int8 "
          f"{out['profile']['int8']['lm_attention_ms'] / 26:.4f} ms ({smi})", flush=True)
    del params, p_int8, fp, q8
    _release()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[dense] phase 10 in {out['seconds']:.1f} s ({smi})", flush=True)
    return out


def _dense_teacher_forced(params, cfg, reqs) -> tuple:
    """``_teacher_forced`` at every step of every request: the max |engine
    logit - prefill logit| of each step, and the steps whose token is
    prefill's argmax."""
    runs = [_teacher_forced(params, cfg, r, range(len(r.generated))) for r in reqs]
    return np.concatenate([e for e, _ in runs]), sum(a for _, a in runs)


def _serve_dense(cfg, params, mat: str, per: dict, smi: str) -> dict:
    """Phase 10 (a) and (b): one tree served as ``_run_engine`` serves the
    OLMoE trees (8 slots, max_len 512, the 16 seeded requests of 16-256
    prompt tokens and 32 new), through the grouped admission path (the
    ring cache takes no packed prefill) and the captured tick. Gates:
    every program a graph whose kernel nodes equal its captured launches
    and ``per``; launches exactly ``per`` a grouped prefill and a tick;
    ``retraces`` 0; every request completes; the ``aot_warmup=False``
    engine's tokens and logits bit-equal. fp (bf16 ring cache,
    ``quant_bits=0``): teacher-forced against ``prefill``, the served
    engine within ``DENSE_FP_TF_LIMITS`` and the same engine over an f32
    cache (the control) within ``DENSE_TF_TOL`` at every step. int8 (int8 ring cache,
    4-bit attention): every ``int8_matmul`` on variant 1 or 2, and every
    token prefill's argmax over its prefix, the logits' reading printed."""
    tag = f"dense {mat}"
    eng, reqs, wall, counts, warm = _run_engine(cfg, params, tag=tag)
    if eng._packed or eng.cache["local"]["k"].shape[2] != LM_MAX_LEN:
        raise AssertionError(f"[{tag}] packed {eng._packed}, local ring "
                             f"{tuple(eng.cache['local']['k'].shape)}")
    programs = _check_programs(tag, eng, per)
    _check_retraces(tag, eng)
    c = eng.metrics.snapshot()["counters"]
    forwards = c["prefill_batches"] + c["decode_ticks"]
    for name in KERNEL_NAMES:
        if counts.get(name, 0) != per.get(name, 0) * forwards:
            raise AssertionError(f"[{tag}] {name}: {counts.get(name, 0)} launches for "
                                 f"{c['prefill_batches']} prefills + {c['decode_ticks']} "
                                 f"ticks, expected {per.get(name, 0)} a forward")
    if mat == "int8":
        _check_int8_variants(tag, counts)
    for r in reqs:
        if r.status != "completed" or len(r.generated) != LM_NEW_TOKENS:
            raise AssertionError(f"[{tag}] request {r.uid}: {r.status}, "
                                 f"{len(r.generated)} tokens")
    tokens = sum(len(r.generated) for r in reqs)
    print(f"[{tag}] smoke figure, not a benchmark ({smi}): {len(reqs)} requests, {tokens} "
          f"tokens in {wall:.2f} s = {tokens / wall:.1f} tok/s; {c['prefill_batches']} "
          f"grouped prefills, {c['decode_ticks']} ticks; launches {per} a forward (gate: "
          f"exact), counts {counts}", flush=True)

    eager, reqs_e, wall_e, _, _ = _run_engine(cfg, params, tag=f"{tag} eager", eager=True)
    same = all(a.generated == b.generated and all(
        torch.equal(x, y) for x, y in zip(a.step_logits, b.step_logits))
        for a, b in zip(reqs, reqs_e))
    print(f"[{tag}] graph vs aot_warmup=False engine: tokens and logits bit-equal: {same} "
          f"(gate); {wall:.2f} s through the graph, {wall_e:.2f} s eager ({smi})", flush=True)
    if not same:
        raise AssertionError(f"[{tag}] graph vs aot_warmup=False engine differ")
    del eager, reqs_e
    err, agree = _dense_teacher_forced(params, cfg, reqs)
    out = {"counts": counts, "counters": c, "tok_s": tokens / wall, "tok_s_eager": tokens / wall_e,
           "warmup": warm, "programs": programs, "engine": eng,
           "tokens": [list(r.generated) for r in reqs],
           "tf_max": float(err.max()), "tf_median": float(np.median(err)), "tf_agree": agree}
    print(f"[{tag}] teacher-forced vs prefill, {err.size} steps: max |logit error| median "
          f"{np.median(err):.3g}, p90 {np.quantile(err, 0.9):.3g}, max {err.max():.3g}; "
          f"tokens equal to prefill's argmax {agree}/{err.size}", flush=True)
    if mat == "int8":
        print(f"[{tag}] gate: every token prefill's argmax (the logits' reading is not "
              "gated: the tied LM head is an f32 cuBLAS GEMM at another M)", flush=True)
        if agree != err.size:
            raise AssertionError(f"[{tag}] {err.size - agree} tokens differ from the "
                                 "teacher-forced loop")
        return out
    with _f32_kv_cache():
        ctl_eng, ctl_reqs, _, _, _ = _run_engine(cfg, params, tag=f"{tag} f32 cache")
    ctl_err, ctl_agree = _dense_teacher_forced(params, cfg, ctl_reqs)
    del ctl_eng, ctl_reqs
    out.update(ctl_max=float(ctl_err.max()), ctl_median=float(np.median(ctl_err)),
               ctl_agree=ctl_agree)
    print(f"[{tag}] f32-cache control vs prefill: max |logit error| median "
          f"{np.median(ctl_err):.3g}, max {ctl_err.max():.3g}, tokens at the argmax "
          f"{ctl_agree}/{ctl_err.size}; gates: every step within {DENSE_TF_TOL}; the served "
          f"engine (bf16 cache) median {np.median(err):.3g} <= {DENSE_FP_TF_LIMITS[0]}, max "
          f"{err.max():.3g} <= {DENSE_FP_TF_LIMITS[1]}", flush=True)
    if ctl_err.max() > DENSE_TF_TOL:
        raise AssertionError(f"[{tag}] f32-cache control: a step {ctl_err.max():.3g} from "
                             "prefill's logits")
    if np.median(err) > DENSE_FP_TF_LIMITS[0] or err.max() > DENSE_FP_TF_LIMITS[1]:
        raise AssertionError(f"[{tag}] the served engine's logits disagree with prefill")
    return out


def _dense_ring(cfg, params, smi: str) -> dict:
    """Phase 10 (c): the ring wrapping at full width. One f32-cache engine
    of 2 slots over ``DENSE_RING_MAX_LEN`` rows (local ring 4096): a prompt
    whose prefill wraps the ring (the roll) and one that wraps it in decode,
    64 new tokens each. Gate: every step's logits within ``DENSE_TF_TOL``
    of one teacher-forced pass over the whole sequence (hidden states of
    every position, logits only at the decoded ones)."""
    from repro_torch.models import transformer
    from repro_torch.serving import Request, ServeEngine

    tag = "dense ring"
    with _f32_kv_cache():
        eng = ServeEngine(cfg, params, batch_slots=2, max_len=DENSE_RING_MAX_LEN,
                          device="cuda", keep_logits=True)
    shapes = {k: tuple(v["k"].shape) for k, v in eng.cache.items()}
    if shapes["local"][2] != 4096 or shapes["global"][2] != DENSE_RING_MAX_LEN:
        raise AssertionError(f"[{tag}] cache shapes {shapes}")
    _warm(tag, eng)
    rng = np.random.default_rng(17)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=DENSE_RING_NEW) for i, n in enumerate(DENSE_RING_PROMPTS)]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    errs = []
    with torch.inference_mode():
        for r in reqs:
            P = len(r.prompt)
            toks = torch.tensor([list(map(int, r.prompt)) + r.generated], device="cuda")
            x = transformer._embed_inputs(params, cfg, toks)
            pos = torch.arange(toks.shape[1], dtype=torch.int32, device="cuda")
            x = transformer._run_layers(params, cfg, x, positions=pos)[0]
            ref = transformer.logits_from_hidden(params, cfg, x[0, P - 1:P - 1 + len(r.generated)])
            got = torch.stack(r.step_logits)
            errs.append((got - ref).abs().amax(-1).cpu().numpy())
            del x, ref, got
    err = np.concatenate(errs)
    print(f"[{tag}] cache {shapes}; prompts {DENSE_RING_PROMPTS} (the first wraps the 4096-row "
          f"ring in its prefill, the second in decode), {DENSE_RING_NEW} new tokens each, "
          f"{wall:.2f} s ({smi}); every step vs one teacher-forced pass: max |logit error| "
          f"median {np.median(err):.3g}, max {err.max():.3g} by request "
          f"{[float(f'{e.max():.3g}') for e in errs]} (gate: {DENSE_TF_TOL} at every step)",
          flush=True)
    if err.max() > DENSE_TF_TOL or any(len(r.generated) != DENSE_RING_NEW for r in reqs):
        raise AssertionError(f"[{tag}] ring decode differs from the teacher-forced pass")
    del eng
    _release()
    return {"counts": counts, "tf_max": float(err.max()), "tf_median": float(np.median(err)),
            "wall_s": wall}


def _profile_dense_tick(eng, mat: str, smi: str, per: dict) -> dict:
    """One decode tick of 8 slots at fill 300 as a graph replay: wall,
    device time, busy share, kernels a tick, ``lm_attention``'s device
    time; one device kernel a call of each gated wrapper."""
    from repro_torch.serving.programs import own

    tick = eng._compiled(eng._program_key("decode"), eng._build_tick)
    host_tok = np.zeros(LM_SLOTS, np.int32)
    pos = np.full(LM_SLOTS, 300, np.int32)
    with torch.inference_mode():
        prof = _profile(f"profile dense {mat}", "decode tick, 8 slots at fill 300, graph", smi,
                        3, lambda: own(tick, tick(host_tok, pos)), expect=per)
    _check_kernels_per_call(f"profile dense {mat}", prof, per)
    return prof


# ---------------------------------------------------------------------------
# phase 12: the remaining model families
# ---------------------------------------------------------------------------

FAMILY_ROWS = ("zamba2_prefill_f32", "zamba2_decode_f32", "seamless_encoder_f32",
               "seamless_cross_prefill_f32", "seamless_cross_decode_f32",
               "seamless_prefill_f32", "seamless_decode_f32")


def _attention_role(Sq: int, Sk: int, hd: int, causal: bool) -> str:
    """The phase-3 row (``FAMILY_ROWS``) of an attention call on phase 12's
    path: zamba2's are the hd-112 calls, seamless's the hd-64 ones."""
    if hd == 112:
        return "zamba2_decode_f32" if Sq == 1 else "zamba2_prefill_f32"
    if causal:
        return "seamless_decode_f32" if Sq == 1 else "seamless_prefill_f32"
    if Sq == 1:
        return "seamless_cross_decode_f32"
    return "seamless_encoder_f32" if Sq == Sk else "seamless_cross_prefill_f32"


@contextlib.contextmanager
def _attention_roles(tally: dict):
    """Tally ``lm_attention``'s launches through ``ops.attention`` by row
    (``_attention_role``) while the block runs; their sum is the wrapper's
    own count, which the caller holds it to."""
    from repro_torch.kernels import ops

    inner = ops.lm_attention

    def counted(q, k, v, **kw):
        out = inner(q, k, v, **kw)
        role = _attention_role(q.shape[1], k.shape[1], q.shape[-1], kw.get("causal", True))
        tally[role] = tally.get(role, 0) + 1
        return out

    ops.lm_attention = counted
    try:
        yield tally
    finally:
        ops.lm_attention = inner


def _check_counts(tag: str, counts: dict, per: dict, calls: int) -> None:
    for name in KERNEL_NAMES:
        if counts.get(name, 0) != per.get(name, 0) * calls:
            raise AssertionError(f"[{tag}] {name}: {counts.get(name, 0)} launches in {calls} "
                                 f"calls, expected {per.get(name, 0)} a call")


def _greedy_run(tag: str, mod, params, cfg, tokens, max_len: int, per_prefill: dict,
                per_decode: dict, **front) -> dict:
    """``prefill`` of ``tokens`` [B, P] (and the frontend's input) into
    ``max_len`` rows, then ``FAMILY_DECODE_STEPS`` greedy ``decode_step``s
    at the scalar index P + j, each gated to launch exactly ``per_decode``
    (the prefill ``per_prefill``). Returns the emitted tokens [B, steps + 1],
    the logits behind each [steps + 1, B, V] and the cache."""
    B, P = tokens.shape
    with torch.inference_mode():
        _reset_counts()
        logits, cache = mod.prefill(params, cfg, tokens, max_len=max_len, **front)
        _check_counts(f"{tag} prefill", _read_counts(), per_prefill, 1)
        lg = logits[:, -1]
        toks, lgs = [], []
        _reset_counts()
        for j in range(FAMILY_DECODE_STEPS + 1):
            tok = torch.argmax(lg, dim=-1)
            toks.append(tok)
            lgs.append(lg)
            if j == FAMILY_DECODE_STEPS:
                break
            lg, cache = mod.decode_step(params, cfg, tok[:, None], cache, P + j)
            lg = lg[:, -1]
        _check_counts(f"{tag} decode", _read_counts(), per_decode, FAMILY_DECODE_STEPS)
    return {"tokens": torch.stack(toks, dim=1), "logits": torch.stack(lgs), "cache": cache}


def _family_teacher_forced(tag: str, mod, params, cfg, tokens, run: dict, smi: str,
                           **front) -> dict:
    """One teacher-forced ``forward`` over the prompt and the emitted tokens
    before the last (causal: its row P - 1 + j sees exactly the prefix of
    step j). Gate: every emitted token's logit there within
    ``LM_FP_TF_TOL`` of the row's argmax. Printed: the median and p90 over
    the steps of max |decode logit - forward logit| / max |forward logit|."""
    B, P = tokens.shape
    seq = torch.cat([tokens, run["tokens"][:, :-1].to(tokens.dtype)], dim=1)
    with torch.inference_mode():
        full = mod.forward(params, cfg, seq, **front)[0][:, P - 1:]  # [B, steps + 1, V]
        got = run["logits"].transpose(0, 1)
        rel = ((got - full).abs().amax(-1) / full.abs().amax(-1)).cpu().numpy()  # [B, steps]
        picked = torch.gather(full, -1, run["tokens"][..., None].long())[..., 0]
        gap = (full.amax(-1) - picked).cpu().numpy()
        agree = int((run["tokens"] == full.argmax(-1)).sum())
    out = {"rel_median": float(np.median(rel)), "rel_p90": float(np.quantile(rel, 0.9)),
           "rel_max": float(rel.max()), "gap_max": float(gap.max()), "agree": agree,
           "steps": int(rel.size)}
    print(f"[{tag}] teacher-forced against one forward over the prompt and the tokens ({smi}): "
          f"{rel.size} emitted tokens, relative logit error median {out['rel_median']:.3g}, "
          f"p90 {out['rel_p90']:.3g}, max {out['rel_max']:.3g}; forward's argmax at "
          f"{agree}/{rel.size}, largest gap below it {gap.max():.3g} (gate: "
          f"{LM_FP_TF_TOL} at every token)", flush=True)
    if gap.max() > LM_FP_TF_TOL:
        raise AssertionError(f"[{tag}] an emitted token sits {gap.max():.3g} below the "
                             "teacher-forced argmax")
    return out


def _family_profiles(tag: str, prefill, decode, per_prefill: dict, per_decode: dict,
                     smi: str) -> dict:
    """Eager device time of one decode step and of the prefill, with the top
    kernels (``_profile``), one device kernel a gated call."""
    out = {}
    for label, fn, per in (("decode step", decode, per_decode), ("prefill", prefill, per_prefill)):
        prof = _profile(f"{tag} profile", f"{label}, eager", smi, 3 if label == "decode step"
                        else 1, fn, expect=per)
        _check_kernels_per_call(f"{tag} profile {label}", prof, per)
        out[label.split()[0]] = prof
    return out


def phase_families(smi: str) -> dict:
    """Phase 12: full-width zamba2-7b and seamless-m4t-medium through their
    model API, each freed before the next (see the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant.ptq import calibrate_model, ptq_model
    from repro_torch.models import encdec, hybrid, init_model_params, tree_bytes

    t_phase = time.perf_counter()
    _release()
    left = torch.cuda.memory_allocated() / 1e9
    print(f"[families] {left:.2f} GB of earlier phases left on the card (gate: "
          f"{FAMILY_LEFT_GB})", flush=True)
    if left > FAMILY_LEFT_GB:  # the gemma2 trees and engines must be gone
        raise AssertionError(f"[families] {left:.2f} GB of earlier phases still allocated")
    out = {}
    roles: dict = {}  # lm_attention launches of the runs below by row (not the profiles)

    # zamba2-7b
    tag = "families zamba2"
    cfg = get_config(HYBRID_ARCH)
    t0 = time.perf_counter()
    params = init_model_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(27)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (HYBRID_BATCH, HYBRID_PROMPT))
                              .astype(np.int32)).cuda()
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} Mamba-2 layers, the shared block after every "
          f"{cfg.shared_attn_every}th ({hybrid.n_apps(cfg)} applications), f32 tree "
          f"{tree_bytes(params) / 1e9:.2f} GB, init {time.perf_counter() - t0:.1f} s ({smi})",
          flush=True)
    with _attention_roles(roles):
        t0 = time.perf_counter()
        run = _greedy_run(tag, hybrid, params, cfg, tokens, HYBRID_MAX_LEN, HYBRID_PER_FORWARD,
                          HYBRID_PER_FORWARD)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _reset_counts()
        tf = _family_teacher_forced(tag, hybrid, params, cfg, tokens, run, smi)
        _check_counts(f"{tag} forward", _read_counts(), HYBRID_PER_FORWARD, 1)
    out["zamba2"] = dict(tf, wall_s=wall)
    out["rmsnorm"] = HYBRID_PER_FORWARD["rmsnorm"] * (FAMILY_DECODE_STEPS + 2)  # as gated
    print(f"[{tag}] prefill of {HYBRID_BATCH} x {HYBRID_PROMPT} + {FAMILY_DECODE_STEPS} decode "
          f"steps, eager: {wall:.2f} s; launches a prefill, decode step and forward "
          f"{HYBRID_PER_FORWARD} (gate: exact)", flush=True)
    cache, last = run["cache"], run["tokens"][:, -1:]
    idx = HYBRID_PROMPT + FAMILY_DECODE_STEPS - 1
    out["zamba2"]["profile"] = _family_profiles(
        tag, lambda: hybrid.prefill(params, cfg, tokens, max_len=HYBRID_MAX_LEN),
        lambda: hybrid.decode_step(params, cfg, last, cache, idx),
        HYBRID_PER_FORWARD, HYBRID_PER_FORWARD, smi)
    del params, run, cache
    _release()

    # seamless-m4t-medium
    tag = "families seamless"
    cfg = get_config(ENCDEC_ARCH)
    t0 = time.perf_counter()
    params = init_model_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(28)
    frames = torch.from_numpy(rng.standard_normal(
        (HYBRID_BATCH, ENCDEC_FRAMES, cfg.frontend_dim)).astype(np.float32)).cuda()
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (HYBRID_BATCH, ENCDEC_PROMPT))
                              .astype(np.int32)).cuda()
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name}: {cfg.encoder_layers} + {cfg.decoder_layers} layers, f32 tree "
          f"{tree_bytes(params) / 1e9:.2f} GB, init {time.perf_counter() - t0:.1f} s; "
          f"{HYBRID_BATCH} utterances of {ENCDEC_FRAMES} frames, prompts of {ENCDEC_PROMPT} "
          f"tokens ({smi})", flush=True)
    with _attention_roles(roles):
        t0 = time.perf_counter()
        run = _greedy_run(tag, encdec, params, cfg, tokens, ENCDEC_MAX_LEN, ENCDEC_PER_PREFILL,
                          ENCDEC_PER_DECODE, frontend_embeds=frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _reset_counts()
        tf = _family_teacher_forced(tag, encdec, params, cfg, tokens, run, smi,
                                    frontend_embeds=frames)
        _check_counts(f"{tag} forward", _read_counts(), ENCDEC_PER_PREFILL, 1)
    out["seamless"] = dict(tf, wall_s=wall)
    print(f"[{tag}] prefill + {FAMILY_DECODE_STEPS} decode steps, eager: {wall:.2f} s; "
          f"launches a prefill / forward {ENCDEC_PER_PREFILL}, a decode step "
          f"{ENCDEC_PER_DECODE} (gate: exact)", flush=True)
    cache, last = run["cache"], run["tokens"][:, -1:]
    idx = ENCDEC_PROMPT + FAMILY_DECODE_STEPS - 1
    out["seamless"]["profile"] = _family_profiles(
        tag, lambda: encdec.prefill(params, cfg, tokens, frontend_embeds=frames,
                                    max_len=ENCDEC_MAX_LEN),
        lambda: encdec.decode_step(params, cfg, last, cache, idx),
        ENCDEC_PER_PREFILL, ENCDEC_PER_DECODE, smi)
    # calibration on 2 batches of 2 utterances, then the fold-only tree
    t0 = time.perf_counter()
    calib = [{"tokens": tokens[2 * i:2 * i + 2], "frontend_embeds": frames[2 * i:2 * i + 2]}
             for i in range(2)]
    taps = calibrate_model(cfg, params, calib)
    folded = ptq_model(cfg, params, taps, fold_only=True)
    seq = torch.cat([tokens, run["tokens"][:, :-1].to(tokens.dtype)], dim=1)
    with torch.inference_mode():
        fp = encdec.forward(params, cfg, seq, frontend_embeds=frames)[0]
        got = encdec.forward(folded, cfg, seq, frontend_embeds=frames)[0]
        rel = float((got - fp).abs().max() / fp.std())
    out["seamless"]["fold_rel"] = rel
    print(f"[{tag}] calibration on 2 batches of 2 utterances + the fold-only PTQ tree "
          f"(LayerNorm: r2 != 0, every consumer's bias corrected; {len(taps.stats)} sites) in "
          f"{time.perf_counter() - t0:.1f} s: logits max |delta| / std {rel:.3g} against the "
          f"fp tree's (gate < {FOLD_REL_TOL}) ({smi})", flush=True)
    if not rel < FOLD_REL_TOL:
        raise AssertionError(f"[{tag}] the fold-only tree moves the logits by {rel:.3g} of "
                             "their std")
    del params, folded, run, cache, fp, got, frames
    _release()

    # the tally against the wrapper's gated counts: a prefill, the decode
    # steps and the teacher-forced forward of each model
    want = (HYBRID_PER_FORWARD["lm_attention"] * (FAMILY_DECODE_STEPS + 2)
            + 2 * ENCDEC_PER_PREFILL["lm_attention"]
            + ENCDEC_PER_DECODE["lm_attention"] * FAMILY_DECODE_STEPS)
    print(f"[families] lm_attention launches of the runs by row: {roles} "
          f"({sum(roles.values())} in all, gate {want}; every row launched)", flush=True)
    if sum(roles.values()) != want or any(not roles.get(r) for r in FAMILY_ROWS):
        raise AssertionError(f"[families] lm_attention launches by row {roles}")
    out["roles"] = roles
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[families] phase 12 in {out['seconds']:.1f} s ({smi})", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 11: training
# ---------------------------------------------------------------------------

# device kernel names of the training step's profile (the serving phases'
# families and the weight gradient)
TRAIN_KERNEL_NAMES = dict(KERNEL_NAMES, grouped_wgrad=("grouped_wgrad_mma_kernel",
                                                         "grouped_wgrad_kernel"),
                          selective_scan_bwd=("scan_bwd_walk_kernel", "scan_bwd_sum_kernel",
                                              "scan_bwd_states_kernel", "scan_bwd_kernel",
                                              "scan_bwd_reduce_kernel"))


def _train_counts(reset: bool = False) -> dict:
    """The wrappers' launch counts, the weight-gradient kernel's and the
    scan backward's (read, or with ``reset`` set to 0)."""
    from repro_torch.kernels.expert_linear import grouped_wgrad
    from repro_torch.kernels.selective_scan import selective_scan_bwd

    if reset:
        _reset_counts()
        grouped_wgrad.launches = 0
        grouped_wgrad.launches_by_variant = {}
        selective_scan_bwd.launches = 0
        selective_scan_bwd.launches_by_mode = {}
        return {}
    return dict(_read_counts(), grouped_wgrad=grouped_wgrad.launches,
                selective_scan_bwd=selective_scan_bwd.launches,
                **{f"grouped_wgrad:{v}": n for v, n in grouped_wgrad.launches_by_variant.items()},
                **{f"selective_scan_bwd:{m}": n
                   for m, n in selective_scan_bwd.launches_by_mode.items()})


@contextlib.contextmanager
def _plain_kernels():
    """Every kernel entry of ``kernels/ops.py`` on the training path (the
    grouped f32 mode and its weight gradient, both attention routes,
    RMSNorm, the selective scan and its backward) replaced by its plain
    version, so that CUDA tensors run the plain path on the card through the
    same autograd Functions."""
    from repro_torch.kernels import ops, ref

    saved = {n: getattr(ops, n) for n in ("_gmm_kernel", "_wgrad_kernel", "streaming_attention",
                                          "lm_attention", "_rmsnorm_kernel", "_scan_kernel",
                                          "_scan_bwd_kernel")}
    ops._gmm_kernel = lambda x, w, gs, **kw: ref.grouped_matmul_ref(x, w, gs)
    ops._wgrad_kernel = ref.grouped_wgrad_ref
    ops.streaming_attention = lambda q, k, v, quant_bits: ref.flash_attention_ref(
        q, k, v, causal=False, quant_bits=quant_bits)
    ops.lm_attention = lambda q, k, v, segments=None, schedule=None, **kw: (
        ref.flash_attention_ref(q, k, v, **kw))
    ops._rmsnorm_kernel = ref.rmsnorm_ref
    ops._scan_kernel = lambda *args, save_states=False: ref.selective_scan_ref(*args)
    ops._scan_bwd_kernel = lambda *args, states=None: ref.selective_scan_bwd_ref(*args)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def _flat_leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_leaves(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _perturbed(params, seed: int):
    """Every float leaf times (1 + ``TRAIN_CONTROL_EPS`` N(0, 1)): a
    perturbation at the size of f32 rounding."""
    from repro_torch.models.param import tree_map

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tree_map(lambda p: p * (1 + TRAIN_CONTROL_EPS * torch.randn(
        p.shape, generator=gen, device=p.device)), params)


def _grad_parity(tag: str, cfg, params, batch, smi: str, small_rel: bool = False) -> dict:
    """Gate: step-0 loss and gradients with the kernels against the plain
    versions on the card. The plain gradient is taken again at
    ``TRAIN_CONTROLS`` perturbed copies of the params (``_perturbed``):
    how far rounding-sized input changes move it through the path's
    discrete choices (expert routing, the row max and the 4-bit codes of the
    attention) is the problem's own conditioning. Each leaf's relative
    difference (and the loss's) is held to the larger of ``TRAIN_GRAD_REL``
    (``TRAIN_LOSS_REL``) and ``TRAIN_CONTROL_FACTOR`` times the largest
    control's; the leaves zero in exact arithmetic to ``TRAIN_NOISE`` of
    the global norm; every leaf with a nonzero plain gradient is nonzero
    with the kernels. ``small_rel``: a leaf under the noise floor that is
    not zero in exact arithmetic (every leaf of a model without attention
    biases) is held to the relative rule like the others."""
    from repro_torch.train.train_step import value_and_grad

    _train_counts(reset=True)
    g_k, m_k = value_and_grad(params, cfg, batch)
    counts = _train_counts()
    with _plain_kernels():
        g_p, m_p = value_and_grad(params, cfg, batch)
        controls = [value_and_grad(_perturbed(params, seed), cfg, batch)
                    for seed in range(1, TRAIN_CONTROLS + 1)]
    if _train_counts() != counts:
        raise AssertionError(f"[{tag}] the plain runs launched kernels: {counts} -> "
                             f"{_train_counts()}")
    loss_p = float(m_p["loss"])
    loss_rel = abs(float(m_k["loss"]) - loss_p) / abs(loss_p)
    loss_ctl = max(abs(float(m["loss"]) - loss_p) / abs(loss_p) for _, m in controls)
    gk, gp = _flat_leaves(g_k), _flat_leaves(g_p)
    gc = [_flat_leaves(g) for g, _ in controls]
    norm = {k: float(torch.linalg.vector_norm(v.double())) for k, v in gp.items()}
    total = math.sqrt(sum(n * n for n in norm.values()))

    def rel(a, k):
        return float(torch.linalg.vector_norm(a[k].double() - gp[k].double())) / norm[k]

    rows, noise, detached = [], {}, []
    for k in gp:
        if norm[k] > 0 and not bool(gk[k].any()):
            detached.append(k)
        if norm[k] <= TRAIN_NOISE * total and not (small_rel and norm[k] > 0):
            noise[k] = (norm[k] / total, float(torch.linalg.vector_norm(gk[k].double())) / total)
            continue
        rows.append((rel(gk, k), max(rel(c, k) for c in gc), k))
    over = [(r, c, k) for r, c, k in rows if r > max(TRAIN_GRAD_REL, TRAIN_CONTROL_FACTOR * c)]
    worst = max(rows)
    print(f"[{tag}] step-0 loss kernels {float(m_k['loss'])!r} plain {loss_p!r} (rel "
          f"{loss_rel:.3g}; controls up to {loss_ctl:.3g}); global grad norm {total:.6g}; "
          f"launches {({k: v for k, v in counts.items() if v and ':' not in k})} ({smi})",
          flush=True)
    for r, cr, k in sorted(rows, reverse=True)[:8]:
        print(f"[{tag}]   {k:36s} kernels rel {r:.3g}, controls up to {cr:.3g}", flush=True)
    print(f"[{tag}]   under the noise floor (plain, kernels / global): "
          f"{({k: (f'{a:.2g}', f'{b:.2g}') for k, (a, b) in noise.items()})}", flush=True)
    if detached:
        raise AssertionError(f"[{tag}] zero kernel gradient where the plain one is not: "
                             f"{detached}")
    if loss_rel > max(TRAIN_LOSS_REL, TRAIN_CONTROL_FACTOR * loss_ctl) or over:
        raise AssertionError(f"[{tag}] loss rel {loss_rel:.3g} (controls {loss_ctl:.3g}); "
                             f"leaves over their limit: {over}")
    bad = {k: v for k, v in noise.items() if v[1] > TRAIN_NOISE or not k.endswith("attn/bk")}
    if bad:
        raise AssertionError(f"[{tag}] leaves under the noise floor that should not be "
                             f"(or kernels above it): {bad}")
    by_controls = sum(TRAIN_CONTROL_FACTOR * c > TRAIN_GRAD_REL for _, c, _ in rows)
    print(f"[{tag}] gradient parity: the loss and every leaf within max({TRAIN_LOSS_REL} / "
          f"{TRAIN_GRAD_REL}, {TRAIN_CONTROL_FACTOR} x the controls), none detached; worst "
          f"leaf {worst[2]} {worst[0]:.3g}; the bound of {len(rows) - by_controls} of "
          f"{len(rows)} leaves the flat {TRAIN_GRAD_REL}, of {by_controls} the controls' "
          f"(gate)", flush=True)
    return {"loss": float(m_k["loss"]), "loss_plain": loss_p, "loss_rel": loss_rel,
            "loss_control_rel": loss_ctl, "worst_leaf": worst[2], "worst_rel": worst[0],
            "worst_control_rel": worst[1], "leaves_by_controls": by_controls,
            "leaves": len(rows), "counts": counts}


def _train_step_profile(tag: str, step_fn, state, batch, smi: str,
                        required=("grouped_matmul", "grouped_wgrad", "streaming_attention"),
                        top: int = 0) -> dict:
    """One training step under ``torch.profiler``: every device kernel by
    name and count (the ``top`` slowest names, or all), the hand kernels'
    families beside the launches their wrappers counted in the step; each
    of ``required`` must appear."""
    from torch.profiler import ProfilerActivity, profile

    step_fn(state, batch)  # warm
    torch.cuda.synchronize()
    _train_counts(reset=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_fn(state, batch)
        torch.cuda.synchronize()
    counts = _train_counts()
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation:
            us, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.device_time, n + 1)
    fam = {f: sum(n for name, (_, n) in by_name.items() if any(k in name for k in ks))
           for f, ks in TRAIN_KERNEL_NAMES.items()}
    device_ms = sum(us for us, _ in by_name.values()) / 1e3
    print(f"[{tag}] one step profiled ({smi}): {len(by_name)} kernel names, "
          f"{sum(n for _, n in by_name.values())} kernels, {device_ms:.2f} ms device time; "
          f"hand kernels in the trace {fam}, wrapper launches "
          f"{ {f: counts.get(f, 0) for f in TRAIN_KERNEL_NAMES} }", flush=True)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (us, n) in ranked[:top or len(ranked)]:
        print(f"[{tag}] {us / 1e3:9.3f} ms {n:5d} x  {name[:100]}", flush=True)
    for f in required:
        if fam[f] == 0:
            raise AssertionError(f"[{tag}] no {f} kernel in the profiled step")
    fam_ms = {f: sum(us for name, (us, _) in by_name.items() if any(k in name for k in ks)) / 1e3
              for f, ks in TRAIN_KERNEL_NAMES.items()}
    return {"device_ms": device_ms, "kernels": by_name, "families": fam,
            "family_ms": fam_ms, "counts": counts}


def _leaves_equal(a, b) -> bool:
    from repro_torch.models.param import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _train_determinism(cfg, shape, smi: str) -> dict:
    """Gate: two runs of 3 steps from one state bit-equal; 10 steps straight
    equal to 5, a checkpoint, a fresh Trainer restoring it and 5 more, bit
    for bit in every param and optimizer leaf; a preemption requested at
    step 3 drains at step 4 with a checkpoint. The steps stay inside the
    default 10 warm-up steps, where the schedule does not depend on
    ``total_steps``."""
    from repro_torch.data import SyntheticPipeline
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.train import Trainer, TrainerConfig, build_train_step, init_train_state

    tag = "train determinism"
    opt = make_optimizer("adamw", warmup_cosine(TRAIN_LR, 10, 10))
    step_fn = build_train_step(cfg, shape, None, opt)
    pipe = SyntheticPipeline(cfg, shape, seed=0)
    s0 = init_train_state(cfg, opt, 0, device="cuda")
    runs = []
    for _ in range(2):
        s = s0
        for i in range(3):
            s, _ = step_fn(s, pipe.batch_for_step(i))
        runs.append(s)
    if not (_leaves_equal(runs[0].params, runs[1].params)
            and _leaves_equal(runs[0].opt_state, runs[1].opt_state)):
        raise AssertionError(f"[{tag}] two runs of 3 steps from one state differ")
    del runs, s, s0
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)

    def trainer(total, sub=None, every=1000):
        return Trainer(cfg, shape, None, TrainerConfig(
            total_steps=total, lr=TRAIN_LR, log_every=1000, checkpoint_every=every,
            checkpoint_dir=None if sub is None else str(ckpt / sub), device="cuda"))

    t0 = time.perf_counter()
    straight = trainer(10).run()
    trainer(5, "resume", every=5).run()
    resumed = trainer(10, "resume").run()  # restores step 5, runs 5 more
    if not (int(straight.step) == int(resumed.step) == 10
            and _leaves_equal(straight.params, resumed.params)
            and _leaves_equal(straight.opt_state, resumed.opt_state)):
        raise AssertionError(f"[{tag}] 5 + checkpoint + 5 steps differ from 10 straight")
    del straight, resumed
    pre = trainer(50, "preempt")
    state = pre.run(on_step=lambda step, rec: step == 3 and pre.guard.request())
    if int(state.step) != 4 or pre.ckpt.latest_step() != 4:
        raise AssertionError(f"[{tag}] preemption at step 3: stopped at {int(state.step)}, "
                             f"checkpoint {pre.ckpt.latest_step()}")
    ckpt_bytes = sum(f.stat().st_size for f in (ckpt / "preempt").rglob("*.npy"))
    shutil.rmtree(ckpt, ignore_errors=True)
    print(f"[{tag}] two 3-step runs bit-equal; 10 steps straight = 5 + checkpoint + "
          f"restore + 5, every param and optimizer leaf bit for bit; preemption at step 3 "
          f"drained at step 4 with a checkpoint of {ckpt_bytes / 1e9:.2f} GB (gate; "
          f"{time.perf_counter() - t0:.1f} s, {smi})", flush=True)
    return {"checkpoint_gb": ckpt_bytes / 1e9}


def phase_train(smi: str) -> dict:
    """Phase 11 (see the module docstring): M3ViT-S gradient parity, the
    Trainer through launch/train.py, determinism and resume, the OLMoE
    2-layer step, one profiled step."""
    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.data import SyntheticPipeline, batch_to
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_model_params
    from repro_torch.models.param import tree_leaves
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.train.trainer import deterministic_mode

    deterministic_mode()
    out: dict = {}
    cfg = get_config(TRAIN_ARCH)
    shape = TRAIN_4K.replace(global_batch=TRAIN_BATCH)
    params = init_model_params(cfg, 0, "cuda")
    batch = batch_to(SyntheticPipeline(cfg, shape, seed=0).batch_for_step(0), "cuda")
    out["parity"] = _grad_parity("train m3vit", cfg, params, batch, smi)
    del params

    # (b) the Trainer through launch/train.py's main
    torch.cuda.reset_peak_memory_stats()
    _train_counts(reset=True)
    t0 = time.perf_counter()
    tr = launch_train.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                            "--batch", str(TRAIN_BATCH), "--lr", str(TRAIN_LR)])
    wall = time.perf_counter() - t0
    counts = _train_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in tr.history]
    times = sorted(h["step_time_s"] for h in tr.history[1:])
    step_s = times[len(times) // 2]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items() if v and ":" not in k}
    print(f"[train m3vit] Trainer, {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, lr {TRAIN_LR} "
          f"(10 warm-up steps, cosine): loss first 5 {first:.4f}, last 5 {last:.4f}; losses "
          f"{[round(x, 4) for x in losses]}; step device time median {step_s * 1e3:.2f} ms "
          f"(min {times[0] * 1e3:.2f}, max {times[-1] * 1e3:.2f}), "
          f"{TRAIN_BATCH / step_s:.1f} images/s, peak memory {peak / 1e9:.2f} GB, wall "
          f"{wall:.1f} s; launches a step {per_step} ({smi})", flush=True)
    if not last <= first - TRAIN_LOSS_DROP:
        raise AssertionError(f"[train m3vit] loss fell {first - last:.4f}, expected at least "
                             f"{TRAIN_LOSS_DROP}")
    wgrad_by = {k: v for k, v in counts.items() if k.startswith("grouped_wgrad:")}
    print(f"[train m3vit] grouped_wgrad launches by variant {wgrad_by} (gate: every one of "
          f"the {counts['grouped_wgrad']} on mma)", flush=True)
    if not counts["grouped_wgrad"] or wgrad_by != {"grouped_wgrad:mma": counts["grouped_wgrad"]}:
        raise AssertionError(f"[train m3vit] grouped_wgrad off its mma variant: {counts}")
    out["trainer"] = {"first5": first, "last5": last, "step_ms": step_s * 1e3,
                      "images_per_s": TRAIN_BATCH / step_s, "peak_gb": peak / 1e9,
                      "counts": counts, "steps": TRAIN_STEPS}
    del tr

    # (c) determinism and resume
    out["determinism"] = _train_determinism(cfg, shape, smi)

    # (e) one M3ViT-S step profiled
    opt = make_optimizer("adamw", warmup_cosine(TRAIN_LR, 10, TRAIN_STEPS))
    step_fn = build_train_step(cfg, shape, None, opt)
    state = init_train_state(cfg, opt, 0, device="cuda")
    out["profile"] = _train_step_profile("train m3vit", step_fn, state,
                                         SyntheticPipeline(cfg, shape).batch_for_step(0), smi)
    del state, step_fn
    torch.cuda.empty_cache()

    # (d) the LM step
    lm_cfg = get_config(TRAIN_LM_ARCH).replace(num_layers=TRAIN_LM_LAYERS)
    lm_shape = TRAIN_4K.replace(seq_len=TRAIN_LM_SEQ, global_batch=TRAIN_LM_BATCH)
    lm_params = init_model_params(lm_cfg, 0, "cuda")
    lm_batch = SyntheticPipeline(lm_cfg, lm_shape, seed=0).batch_for_step(0)
    out["lm_parity"] = _grad_parity("train olmoe", lm_cfg, lm_params,
                                    batch_to(lm_batch, "cuda"), smi)
    lm_opt = make_optimizer(lm_cfg.optimizer, warmup_cosine(TRAIN_LR, 1, 10))
    state = init_train_state(lm_cfg, lm_opt, params=lm_params)
    state, metrics = build_train_step(lm_cfg, lm_shape, None, lm_opt)(state, lm_batch)
    finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(
        {"p": state.params, "o": state.opt_state}))
    print(f"[train olmoe] one build_train_step update: loss {float(metrics['loss']):.4f}, "
          f"grad norm {float(metrics['grad_norm']):.4f}, every param and optimizer leaf "
          f"finite: {finite} (gate)", flush=True)
    if not (finite and math.isfinite(float(metrics["loss"]))):
        raise AssertionError("[train olmoe] the update is not finite")
    del state, lm_params
    torch.cuda.empty_cache()
    return out


def _pod_step_check(cfg, shape, params, batch, smi: str) -> dict:
    """Gate: ``build_train_step`` on a mesh of 2 pod slots of ``cuda:0`` with
    ``grad_compress`` updates the params bit for bit as the composition
    written out here: the single-pod gradient of each half of the batch,
    each leaf coded as the reference's cross-pod branch codes it (scale =
    max over the pods of max |g| / 127, + 1e-30; codes clip(round(g /
    scale), -127, 127); their int32 sum; times scale / 2), the global-norm
    clip and the optimizer's update, leaf by leaf (one leaf's AdamW state
    at a time: the card holds the step's params, its state and the
    composition's gradients at once)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.train.train_step import value_and_grad

    tag = "train mamba pod"
    opt = make_optimizer(cfg.optimizer, constant(TRAIN_LR))
    mesh = Mesh(np.array([torch.device("cuda:0")] * 2, dtype=object).reshape(2, 1, 1),
                ("pod", "data", "model"))
    state = init_train_state(cfg, opt, params=params, grad_compress=True)
    _train_counts(reset=True)
    t0 = time.perf_counter()
    new, metrics = build_train_step(cfg, shape, mesh, opt, grad_compress=True)(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _train_counts()
    got = _flat_leaves(new.params)
    residual_kept = _leaves_equal(new.compress.residual, state.compress.residual)
    del new, state
    torch.cuda.empty_cache()
    half = shape.global_batch // 2
    per = [value_and_grad(params, cfg, {k: v[i * half:(i + 1) * half] for k, v in batch.items()})
           for i in range(2)]
    g0, g1 = (_flat_leaves(g) for g, _ in per)
    loss = (per[0][1]["loss"] + per[1][1]["loss"]) / 2
    del per

    def decode(k):
        scale = torch.maximum(torch.amax(torch.abs(g0[k])) / 127.0,
                              torch.amax(torch.abs(g1[k])) / 127.0) + 1e-30
        total = (torch.clamp(torch.round(g0[k] / scale), -127, 127).to(torch.int32)
                 + torch.clamp(torch.round(g1[k] / scale), -127, 127).to(torch.int32))
        return total.to(torch.float32) * (scale / 2)

    grads = {k: decode(k) for k in g0}
    del g0, g1
    norm = torch.sqrt(torch.sum(torch.stack(  # global_norm's order: _flat_leaves'
        [torch.sum(torch.square(g)) for g in grads.values()])))
    clip = torch.clamp(1.0 / torch.clamp(norm, min=1e-12), max=1.0)
    flat_p = _flat_leaves(params)
    step0 = torch.zeros((), dtype=torch.int32, device="cuda")
    differ = []
    for k in list(grads):
        g = {k: (grads.pop(k) * clip).to(torch.float32)}
        want, _ = opt.update(g, opt.init({k: flat_p[k]}), {k: flat_p[k]}, step0)
        if not torch.equal(want[k], got[k]):
            differ.append(k)
    ok = not differ and residual_kept and torch.equal(metrics["grad_norm"], norm) \
        and torch.equal(metrics["loss"], loss)
    print(f"[{tag}] 2 pod slots of cuda:0, grad_compress, {shape.global_batch} x "
          f"{shape.seq_len} tokens: loss {float(metrics['loss']):.6f}, grad norm "
          f"{float(metrics['grad_norm']):.6f}, {wall:.2f} s wall; launches "
          f"{({k: v for k, v in counts.items() if v and ':' not in k})}; updated params bit-equal "
          f"to the written-out composition: {not differ} (differ: {differ[:5]}); metrics equal, "
          f"residuals kept: {ok} (gate; {smi})", flush=True)
    if not ok:
        raise AssertionError(f"[{tag}] the pod step is not its composition: {differ[:5]}, "
                             f"residuals kept {residual_kept}")
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "wall_s": wall, "counts": counts}


def phase_train_ssm(smi: str) -> dict:
    """Phase 13 (see the module docstring): the scan's backward kernel,
    then full-width falcon-mamba-7b cut to ``TRAIN_SSM_LAYERS`` layers:
    gradient parity at ``TRAIN_SSM_GATE_SEQ`` tokens a row, the pod step,
    two ``Trainer`` runs of ``TRAIN_SSM_STEPS`` steps at 2 x 4096 tokens,
    one step profiled."""
    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.data import SyntheticPipeline, batch_to
    from repro_torch.models import init_model_params
    from repro_torch.models.param import tree_leaves
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.trainer import deterministic_mode

    deterministic_mode()
    out: dict = {"row": _check_selective_scan_bwd(
        torch.Generator(device="cuda").manual_seed(SCAN_BWD_SEED))}
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_SSM_ARCH).replace(num_layers=TRAIN_SSM_LAYERS)
    if not (cfg.remat and cfg.optimizer == "adamw"):
        raise AssertionError(f"[train mamba] {TRAIN_SSM_ARCH}: remat {cfg.remat}, optimizer "
                             f"{cfg.optimizer}")
    gate_shape = TRAIN_4K.replace(seq_len=TRAIN_SSM_GATE_SEQ, global_batch=TRAIN_SSM_BATCH)
    params = init_model_params(cfg, 0, "cuda")
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train mamba] {TRAIN_SSM_ARCH} at full width, {TRAIN_SSM_LAYERS} of 64 layers: "
          f"{n_params / 1e9:.3f} B params, {4 * n_params / 1e9:.2f} GB f32", flush=True)
    batch = batch_to(SyntheticPipeline(cfg, gate_shape, seed=0).batch_for_step(0), "cuda")
    out["parity"] = _grad_parity("train mamba", cfg, params, batch, smi, small_rel=True)
    out["pod"] = _pod_step_check(cfg, gate_shape, params, batch, smi)
    del params, batch
    torch.cuda.empty_cache()

    shape = TRAIN_4K.replace(global_batch=TRAIN_SSM_BATCH)
    tokens = shape.global_batch * shape.seq_len
    tc = TrainerConfig(total_steps=TRAIN_SSM_STEPS, lr=TRAIN_LR, warmup_steps=2,
                       log_every=1000, device="cuda")
    runs = []
    for run in range(2):
        torch.cuda.reset_peak_memory_stats()
        _train_counts(reset=True)
        t0 = time.perf_counter()
        tr = Trainer(cfg, shape, None, tc)
        state = tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [h["loss"] for h in tr.history]
        runs.append({"losses": losses, "counts": _train_counts(),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "wall_s": wall,
                     "step_s": sorted(h["step_time_s"] for h in tr.history[1:])})
        if run == 0:
            first = [p.cpu() for p in tree_leaves(state.params)]
            del state, tr
            torch.cuda.empty_cache()
    same = all(torch.equal(a, b.cpu()) for a, b in zip(first, tree_leaves(state.params)))
    same = same and runs[0]["losses"] == runs[1]["losses"]
    del first
    r = runs[0]
    step_s = r["step_s"][len(r["step_s"]) // 2]
    per_step = {k: v / TRAIN_SSM_STEPS for k, v in r["counts"].items() if v and ":" not in k}
    print(f"[train mamba] Trainer, {TRAIN_SSM_STEPS} steps at {shape.global_batch} x "
          f"{shape.seq_len} tokens, lr {TRAIN_LR} (2 warm-up steps, cosine), deterministic: "
          f"losses {[round(x, 4) for x in r['losses']]}; step device time median "
          f"{step_s * 1e3:.2f} ms (min {r['step_s'][0] * 1e3:.2f}, max "
          f"{r['step_s'][-1] * 1e3:.2f}), {tokens / step_s:.1f} tokens/s, peak memory "
          f"{r['peak_gb']:.2f} GB, wall {r['wall_s']:.1f} s; launches a step {per_step}; a "
          f"second run bit-equal in every param and loss: {same} ({smi})", flush=True)
    losses = r["losses"]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"[train mamba] losses not finite or not falling: {losses}")
    if not same:
        raise AssertionError("[train mamba] two runs differ")
    if not (r["counts"]["selective_scan"] and r["counts"]["selective_scan_bwd"]):
        raise AssertionError(f"[train mamba] the scan kernels did not run: {r['counts']}")
    by_mode = {m: r["counts"].get(f"selective_scan_bwd:{m}", 0) for m in ("saved", "recompute")}
    print(f"[train mamba] selective_scan_bwd launches by variant: {by_mode} (gate: every "
          "call on the saved variant)", flush=True)
    if by_mode["saved"] != r["counts"]["selective_scan_bwd"] or by_mode["recompute"]:
        raise AssertionError(f"[train mamba] scan backward calls off the saved variant: {by_mode}")
    prof = _train_step_profile("train mamba", tr.step_fn, state,
                               tr.pipeline.batch_for_step(TRAIN_SSM_STEPS), smi,
                               required=("selective_scan", "selective_scan_bwd", "rmsnorm"),
                               top=15)
    share = {f: prof["family_ms"][f] / prof["device_ms"]
             for f in ("selective_scan", "selective_scan_bwd", "rmsnorm")}
    print(f"[train mamba] profiled step: {prof['device_ms']:.2f} ms device, "
          f"{sum(n for _, n in prof['kernels'].values())} kernels; scan forward "
          f"{prof['family_ms']['selective_scan']:.2f} ms ({100 * share['selective_scan']:.2f}%), "
          f"backward {prof['family_ms']['selective_scan_bwd']:.2f} ms "
          f"({100 * share['selective_scan_bwd']:.2f}%), rmsnorm "
          f"{prof['family_ms']['rmsnorm']:.2f} ms ({smi})", flush=True)
    del state, tr
    torch.cuda.empty_cache()
    out["trainer"] = {"losses": losses, "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
                      "peak_gb": r["peak_gb"], "counts": r["counts"], "steps": TRAIN_SSM_STEPS}
    out["profile"] = {"device_ms": prof["device_ms"], "family_ms": prof["family_ms"],
                      "share": share, "kernels": sum(n for _, n in prof["kernels"].values())}
    return out


SCAN_BWD_NAMES = ("dx", "ddt", "db", "dc", "da", "dd")


def _scan_bwd_errors(got, want) -> dict:
    """Each output's max |got - want| / max |want| (0 where want is 0)."""
    out = {}
    for name, g, w in zip(SCAN_BWD_NAMES, got, want):
        top = float(w.abs().max()) if w.numel() else 0.0
        out[name] = max_err(g, w) / top if top else max_err(g, w)
    return out


def _check_scan_bwd_once(args, dy, dh, bit_equal_da=False) -> dict:
    """Gate each variant of the backward (``BWD_VARIANTS``) against the
    plain version (``SCAN_BWD_TOL``; with ``bit_equal_da`` dA and dD bit
    for bit) and against a second call (bit-equal), and the saved variant
    from the forward kernel's saved states against its call alone
    (bit-equal); the forward kernel saving those states against the serving
    kernel (y and h_last bit-equal; phase 3 holds the serving kernel's y
    to the plain version) and the plain forward (h_last bit-equal). Returns each variant's errors and largest
    absolute error and the plain call's CUDA-event ms."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.selective_scan import (
        BWD_VARIANTS,
        selective_scan,
        selective_scan_bwd,
    )

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = ref.selective_scan_bwd_ref(*args, dy, dh)
    stop.record()
    stop.synchronize()
    shape = list(args[0].shape) + [args[2].shape[-1]]
    out = {"plain_ms": start.elapsed_time(stop)}
    for variant, mode in BWD_VARIANTS.items():
        got = selective_scan_bwd(*args, dy, dh, variant=variant)
        again = selective_scan_bwd(*args, dy, dh, variant=variant)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"selective_scan_bwd ({mode}) {shape}: two calls differ")
        if variant == 1:
            y_s, h_s, states = selective_scan(*args, save_states=True)
            y0, h0 = selective_scan(*args)
            hr = ref.selective_scan_ref(*args)[1]
            if not (torch.equal(y_s, y0) and torch.equal(h_s, h0) and torch.equal(h_s, hr)):
                raise AssertionError(f"selective_scan {shape} saving the states: y or h_last "
                                     "not bit-equal to the serving kernel's, or h_last to "
                                     f"the plain version's (max err {max_err(h_s, hr)})")
            del y_s, h_s, y0, h0, hr
            from_states = selective_scan_bwd(*args, dy, dh, states=states)
            if not all(torch.equal(a, b) for a, b in zip(got, from_states)):
                raise AssertionError(f"selective_scan_bwd (saved) {shape}: from the forward's "
                                     "states differs from the call alone")
            del states, from_states
        errs = _scan_bwd_errors(got, want)
        over = {k: v for k, v in errs.items() if v > SCAN_BWD_TOL[k]}
        if bit_equal_da:
            over |= {k: errs[k] for k in ("da", "dd") if errs[k]}
        if over:
            raise AssertionError(f"selective_scan_bwd ({mode}) {shape} dh_last {dh is not None}: "
                                 f"over SCAN_BWD_TOL{' or dA / dD not bit-equal' * bit_equal_da}"
                                 f": {over} (all {errs})")
        out[mode] = {"errors": errs, "max_abs_err": max(max_err(g, w) for g, w in zip(got, want))}
        del got, again
    return out


def _check_selective_scan_bwd(gen) -> dict:
    """The scan's backward in both variants at ``SCAN_BWD_SHAPES`` and at
    the training shape ``SCAN_BWD_TRAIN`` (``_check_scan_bwd_once``; at the
    training shape dA and dD bit-equal to the plain version too). At the
    training shape, device time by graph replay (and eager) and the device
    work a call enqueues: the saved variant called alone (the forward kernel
    for the states, then the walk: the row's ``ms``) and from the forward's
    saved states (``walk_ms``, the training step's call), the recompute
    variant in the same run (``was_ms``), the forward kernel with and
    without the states; the layout's blocks an SM (the occupancy
    calculator), the workspace bytes
    of each variant, the plain version's time (CUDA events, one call), and
    the bound: the bytes the function must move (x, dt, dy read and dx,
    ddt written, [B, S, di] f32 each; b, c, a, d read and db, dc, da, dd
    written) over 3.35 TB/s, against ``SCAN_BWD_OPS`` f32 operations a
    state step (exp(dt A) and the state update: 5; g's update and carry:
    3; q: 2; the n sums of dx and ddt: 4; da: 2; db and dc: 4) over the f32
    rate. No PyTorch call computes the function (``library_ms`` None)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import (
        BWD_THREADS,
        H100_SMS,
        scan_bwd_layout,
        scan_bwd_smem_bytes,
        scan_bwd_workspace,
        selective_scan,
        selective_scan_bwd,
    )

    checked = {}
    for B, S, di, N, with_dh in SCAN_BWD_SHAPES:
        args = _scan_operands(gen, B, S, di, N, torch.float32)
        dy = torch.randn((B, S, di), generator=gen, device="cuda")
        dh = torch.randn((B, di, N), generator=gen, device="cuda") if with_dh else None
        res = _check_scan_bwd_once(args, dy, dh)
        for mode in ("saved", "recompute"):
            checked[f"{B}x{S}x{di}x{N}{'+dh' if with_dh else ''} {mode}"] = res[mode]["errors"]
    B, S, di, N = SCAN_BWD_TRAIN
    args = _scan_operands(gen, B, S, di, N, torch.float32)
    dy = torch.randn((B, S, di), generator=gen, device="cuda") / math.sqrt(di)
    res = _check_scan_bwd_once(args, dy, None, bit_equal_da=True)
    states = selective_scan(*args, save_states=True)[2]
    alone = lambda: selective_scan_bwd(*args, dy)  # noqa: E731
    walk = lambda: selective_scan_bwd(*args, dy, states=states)  # noqa: E731
    was = lambda: selective_scan_bwd(*args, dy, variant=2)  # noqa: E731
    layout = scan_bwd_layout(N)
    per_sm = _build.library().selective_scan_bwd_blocks_per_sm(*layout)
    blocks = B * -(-di // (BWD_THREADS[1] // layout[1]))
    n_bytes = 4 * (5 * B * S * di + 4 * B * S * N + 2 * di * N + 2 * di)
    nb, by = bound_ms(n_bytes, SCAN_BWD_OPS * B * S * di * N, F32_OPS_PER_S)
    row = {"name": "selective_scan_bwd", "shape": [B, S, di, N], "mode": "f32",
           "variant": "saved", "layout": layout,
           "smem_bytes": scan_bwd_smem_bytes(*layout), "blocks_per_sm": per_sm,
           "warps_per_sm": min(per_sm, -(-blocks // H100_SMS)) * BWD_THREADS[1] // 32,
           "max_abs_err": res["saved"]["max_abs_err"], "errors": res["saved"]["errors"],
           "small_shapes": checked,
           "tolerance": "max |kernel - plain| / max |plain| per output: " + ", ".join(
               f"{k} {v:g}" for k, v in SCAN_BWD_TOL.items())
           + "; dA, dD bit-equal at the training shape; two calls bit-equal",
           "device_work": _device_work(alone), "ms": graph_ms(alone, n=3, iters=5),
           "eager_ms": time_ms(alone, iters=5, warmup=1),
           "walk_device_work": _device_work(walk), "walk_ms": graph_ms(walk, n=3, iters=5),
           "walk_eager_ms": time_ms(walk, iters=5, warmup=1),
           "workspace_bytes": {m: 4 * sum(scan_bwd_workspace(v, B, S, di, N).values())
                               for v, m in ((1, "saved"), (2, "recompute"))},
           "walk_workspace_bytes": 4 * (sum(scan_bwd_workspace(1, B, S, di, N).values())
                                        - scan_bwd_workspace(1, B, S, di, N)["states"]),
           "forward_ms": graph_ms(lambda: selective_scan(*args), n=3, iters=5),
           "forward_states_ms": graph_ms(lambda: selective_scan(*args, save_states=True),
                                         n=3, iters=5),
           "plain_ms": res["plain_ms"], "bound_ms": nb, "bound_by": by, "library_ms": None,
           "route": "cuda", "source": SOURCES["selective_scan_bwd"],
           "replaces": REPLACES["selective_scan_bwd"]}
    row |= {"was_ms": graph_ms(was, n=3, iters=5),
            "was_eager_ms": time_ms(was, iters=5, warmup=1), "was_device_work": _device_work(was)}
    was_row = {"name": "selective_scan_bwd[recompute]", "shape": row["shape"], "mode": "f32",
               "variant": "recompute", "layout": layout, "ms": row["was_ms"],
               "eager_ms": row["was_eager_ms"], "device_work": row["was_device_work"],
               "max_abs_err": res["recompute"]["max_abs_err"],
               "errors": res["recompute"]["errors"],
               "workspace_bytes": row["workspace_bytes"]["recompute"],
               "plain_ms": res["plain_ms"], "bound_ms": nb, "bound_by": by, "library_ms": None,
               "route": "cuda", "source": SOURCES["selective_scan_bwd[recompute]"],
               "replaces": REPLACES["selective_scan_bwd"]}
    del states
    for shape, errs in checked.items():
        print(f"[kernels] selective_scan_bwd {shape}: " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()), flush=True)
    gb = {m: v / 1e9 for m, v in row["workspace_bytes"].items()}
    print(f"[kernels] selective_scan_bwd {row['shape']} saved variant (states a thread, lanes "
          f"{row['layout']}; {row['smem_bytes']} B of shared memory, "
          f"{per_sm} blocks an SM: {row['warps_per_sm']} warps an SM walk together): "
          f"{row['ms']:.4f} ms called alone (eager {row['eager_ms']:.4f}; "
          f"{row['device_work']} device launches a call), {row['walk_ms']:.4f} ms from the "
          f"forward's states (eager {row['walk_eager_ms']:.4f}; {row['walk_device_work']} "
          f"launches: the training step's call); (was) the recompute variant "
          f"{row['was_ms']:.4f} ms (eager {row['was_eager_ms']:.4f}; "
          f"{row['was_device_work']} launches) in the same run, ratio "
          f"{row['ms'] / row['was_ms']:.3f} (gate 0.5); workspace "
          f"{row['walk_workspace_bytes'] / 1e9:.3f} GB from the forward's states, "
          f"{gb['saved']:.3f} alone (was {gb['recompute']:.3f}); the forward kernel "
          f"{row['forward_ms']:.4f} ms, writing "
          f"the states {row['forward_states_ms']:.4f} ms; plain {row['plain_ms']:.1f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}); errors " + ", ".join(
              f"{k} {v:.3g}" for k, v in row["errors"].items())
          + " (recompute: " + ", ".join(
              f"{k} {v:.3g}" for k, v in was_row["errors"].items())
          + f"); {len(SCAN_BWD_SHAPES) + 1} shapes within SCAN_BWD_TOL in both variants, "
          "repeats bit-equal, dA and dD bit-equal at the training shape; the forward saving "
          "the states: y, h_last bit-equal to the serving kernel's (gate)", flush=True)
    if row["ms"] > 0.5 * row["was_ms"]:
        raise AssertionError(f"selective_scan_bwd: the saved variant {row['ms']:.4f} ms is over "
                             f"half the recompute variant's {row['was_ms']:.4f} ms")
    emit({"kernel": row})
    emit({"kernel": was_row})
    return row


def _launches(row: dict, vision: dict, vision_calib: dict, lm: dict, ssm: dict,
              dense: dict, families: dict, train: dict, train_ssm: dict) -> int:
    """A row's launches on the main path: the vision serving run and the
    vision cluster's, and for the modes the LM runs, the three OLMoE serving
    runs (fp, int8, W4A8) and the two LM cluster runs (the fp32 grouped row
    also the calibration forwards, the calibration attention row those
    alone); the scan's, the falcon-mamba serving run; the gemma2 rows',
    the gemma2-2b serving runs (fp, int8, ring wrap), which also add to
    ``int8_matmul`` and ``rmsnorm``; phase 12's attention rows', their
    calls in its runs (a prefill, the decode steps and the teacher-forced
    forward of each model), and its zamba2 runs add to ``rmsnorm``; the
    training rows', the Trainer's 40 steps (the dx row: every f32 grouped
    launch of those steps, forward, recompute and dx); the scan's rows add
    phase 13's first run of 10 falcon-mamba steps (forward and recompute),
    the scan backward's row is that run's backward calls."""
    if row["name"] == "grouped_wgrad":  # the Trainer's launches of the row's variant
        return train["trainer"]["counts"].get(f"grouped_wgrad:{row['variant']}", 0)
    if row["name"] == "grouped_matmul_f32[dx]":
        return train["trainer"]["counts"]["grouped_matmul"]
    if row["name"] == "selective_scan_bwd":
        return train_ssm["trainer"]["counts"]["selective_scan_bwd"]
    runs = ([r["counts"] for r in lm["runs"].values()]
            + [r["counts"] for r in lm["cluster"].values()]
            + list(lm["ep"]["runs"].values()) + [lm["gshard"]["counts"]])
    dense_runs = [r["counts"] for r in dense["runs"].values()]
    name = row["name"]
    role = name.removeprefix("lm_attention[").removesuffix("]")
    if role in FAMILY_ROWS:
        return families["roles"].get(role, 0)
    if name.startswith("lm_attention[gemma2"):
        return sum(c.get("lm_attention:" + row["mode"], 0) for c in dense_runs)
    if name.startswith("selective_scan"):
        return ssm["counts"]["selective_scan"] + train_ssm["trainer"]["counts"]["selective_scan"]
    if name == "rmsnorm":
        return (vision["rmsnorm"] + sum(c["rmsnorm"] for c in runs)
                + ssm["counts"]["rmsnorm"] + sum(c["rmsnorm"] for c in dense_runs)
                + families["rmsnorm"])
    if name == "grouped_matmul_f32":
        return (vision_calib["grouped_matmul"] + lm["calib_counts"]["grouped_matmul:f32"]
                + sum(c.get("grouped_matmul:f32", 0) for c in runs))
    if name == "grouped_matmul":
        return vision["grouped_matmul"] + sum(c.get("grouped_matmul:int8", 0) for c in runs)
    if name == "grouped_matmul_w4a8":
        return sum(c.get("grouped_matmul:w4a8", 0) for c in runs)
    if name == "lm_attention[calibration]":
        return lm["calib_counts"]["lm_attention:causal/float32/qb0"]
    if name.startswith("lm_attention["):
        return sum(c.get("lm_attention:" + row["mode"], 0) for c in runs)
    return (vision[name] + sum(c.get(name, 0) for c in runs)
            + sum(c.get(name, 0) for c in dense_runs))


def _timed(fn, *args):
    """``fn(*args)``, its wall time printed (the run's time budget)."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {fn.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> None:
    smi = _timed(phase_device)
    _timed(phase_build)
    rows = _timed(phase_kernels)
    qcfg, p_int8, counts, calib_counts, engines = _timed(phase_serving, smi)
    _timed(phase_e2e, qcfg, p_int8)
    _timed(phase_profile, qcfg, p_int8, smi, engines)
    vcluster = _timed(phase_cluster_vision, qcfg, p_int8, engines["graph"], smi)
    _timed(phase_observe_vision, qcfg, p_int8, engines["graph"], smi)
    ep_vision = _timed(phase_ep_vision, qcfg, p_int8, engines["graph"], smi)
    counts = {k: counts.get(k, 0) + vcluster["counts"].get(k, 0) + ep_vision["counts"].get(k, 0)
              for k in set(counts) | set(vcluster["counts"]) | set(ep_vision["counts"])}
    _timed(phase_autotune_vision, qcfg, p_int8, engines["graph"], smi)
    del p_int8, engines
    torch.cuda.empty_cache()
    lm = _timed(phase_lm, smi)
    ssm = _timed(phase_ssm, smi)
    dense = _timed(phase_dense, smi)
    families = _timed(phase_families, smi)
    train = _timed(phase_train, smi)
    train_ssm = _timed(phase_train_ssm, smi)
    rows.append(train_ssm["row"])
    for row in rows:
        row["launches"] = _launches(row, counts, calib_counts, lm, ssm, dense, families, train,
                                    train_ssm)
        if row["name"] in ("grouped_wgrad", "grouped_matmul_f32[dx]"):
            row["launches_per_step"] = row["launches"] / TRAIN_STEPS
        if row["name"] == "selective_scan_bwd":
            row["launches_per_step"] = row["launches"] / TRAIN_SSM_STEPS
    for name in ("int8_matmul", "grouped_matmul", "grouped_matmul_w4a8", "grouped_matmul_f32",
                 "lm_attention[packed_prefill]", "lm_attention[decode_int8]",
                 "lm_attention[packed_prefill_f32]", "lm_attention[decode_bf16]",
                 "lm_attention[gemma2_decode_bf16_512]", "lm_attention[gemma2_decode_int8_512]",
                 "lm_attention[gemma2_prefill_f32]", "lm_attention[gemma2_ring_prefill_int8]",
                 "selective_scan", "rmsnorm", "grouped_wgrad", "grouped_matmul_f32[dx]",
                 "selective_scan_bwd",
                 *(f"lm_attention[{r}]" for r in FAMILY_ROWS)):
        row = next(r for r in rows if r["name"] == name)
        if row["launches"] == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} | {"shape": row["shape"]}
                      | {k: row[k] for k in ("variant", "schedule", "fma_ms", "bound_f32_ms",
                                             "walk_ms", "was_ms",
                                             "library_wall_ms",
                                             "bf16_max_abs_err", "f32_copy_max_abs_err",
                                             "f64_max_abs_err", "launches_per_step",
                                             "library_refused")
                         if k in row}
                      for row in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
