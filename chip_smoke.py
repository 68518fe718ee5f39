#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Imports torch and ``torchsnapshot_tpu_torch`` only (no JAX, nothing of the
JAX package). Phases, in order; any failure exits non-zero and prints no
result line:

1. build   - compile every CUDA kernel of the path from ``csrc/`` (nvcc,
             sm_90a), all sources at once (flash_fwd, flash_bwd, digest);
             print each instance's ptxas registers, spills and shared
             memory, and K4's integer instructions from its SASS.
2. kernels - hold each kernel against its plain PyTorch version on the
             card: flash_fwd (o and lse), flash_bwd_dq (dq) and
             flash_bwd_dkv (dk, dv), causal and not, f32 and bf16, D=64
             and D=128, the serving shape and a sequence length that is
             not a multiple of the kernels' 64-row tile; the bf16 forward
             and the bf16 backward also at S = 1, 16, 100, 200, 256 and 512
             with 1 and 32 heads, and twice on the same inputs
             (bit-identical); and the raw backward split with global lse
             and delta over twice the keys, in f32 and in bf16.
3. serve   - the ``entry()`` configuration (vocab 8192, d_model 512, 8
             heads, 4 layers, tokens (4, 256), bf16) answers a few
             requests with ``attn_impl="auto"``; launch counts are read
             across this phase alone; logits are held against
             ``attn_impl="dense"``.
4. checkpoint - Snapshot.take of the params, a progress StateDict and
             RNGState; restore into a zeroed model must be bit-exact and
             answer with bit-identical logits; async_take, overwrite the
             params at once, restore: the pre-overwrite values come back.
5. state   - take and restore about 2 GiB of CUDA tensors (100 MiB f32
             tensors plus bf16), bit-exact; prints the save and restore
             GB/s, and how long an async_take of that state holds the
             caller.
6. train   - ``train_entry()`` at the same configuration takes 5 AdamW
             steps on one batch with ``attn_impl="auto"``; each flash
             kernel must launch 4 times a step; the loss is finite and
             falls; step 1's loss and gradients are held against
             ``attn_impl="dense"``.
7. train checkpoint - under ``torch.use_deterministic_algorithms``: take
             the train state after step 2 with RNGState, run step 3,
             restore into a state from another seed (bit-exact, step and
             count included), run step 3 again: bit-identical loss and
             state. Then async_take, an in-place step at once, restore: the
             values from before that step come back.
8. timing  - (runs after phase 10, before any phase spawns processes
             onto the card) each kernel at the shape of the path (BH=32,
             S=256, D=64, bf16, causal) against its plain version and one
             library call, with its bound from the bytes and operations of
             this run's inputs: the device time of one call
             (``torch.profiler``: the device activities the calls launched,
             over their number; CUDA events where three profiling sessions
             record none, named by each kernel's ``device_timer``; a round
             that reads under the bound is reported invalid and dropped),
             the device time from CUDA events around a CUDA graph of 100
             calls captured once (``graph_ms``; no host launch path in
             it), the SM clock, its maximum and the power draw before and
             after (``sm_clock``), a line of its own where the two device
             timers disagree by more than 2x, and the per-call time with
             the host included (CUDA events around back-to-back calls).
             Phases 10 and 15 time K4's full and partial forms the same
             way.
9. profile - steady-state serving latency and train-step time, each with
             flash and with dense attention, and the device time of one
             traced forward and one traced train step by kernel.
10. digest - (runs after phase 7) K4 (``csrc/digest.cu``, the device
             fingerprint) against its plain version on the card: every
             dtype of the train state plus bf16, f16, int64, f64, uint8,
             int8, bool and torch's float8 types, at 0, 1, 3 and 4,097
             elements and 16,777,216 bytes, aligned and not; the partial
             form on a 3-D piece cut into 4 regions; two launches
             bit-identical; device times of one 16 MiB leaf and of the 26
             state leaves dispatched before one fetch, against the plain
             version and the bound.
11. manager - (runs after phase 10) the production loop at the entry
             configuration: a CheckpointManager (cadence 2, keep_last 2,
             async, incremental, device digests, a preemption watcher) over
             train steps 0-4; a forced save of the unchanged state stages
             and writes nothing and launches K4 once a leaf; a simulated
             SIGTERM makes an emergency save at step 6; retention leaves
             steps 4, 5 and 6; the latest step restores bit-exact through
             its origins in step 4; a restore with device digests into a
             state that holds it reads and copies nothing; three
             async_takes of the unchanged state in turns (device digests,
             host digests, full): caller-blocked time, bytes staged and
             written; one more train step on the restored state is
             bit-identical.
12. io     - (runs after phase 5) the host I/O plane: the native host
             library (g++, ``_native/native.cpp``) built, ``uname -m`` and
             its SSE4.2 probe, CRC32C's check value, native against the
             plain table version on 64 MiB, CRC32C and zlib CRC32 GB/s;
             phase 5's 1.953 GiB state by layer (DtoH into registered
             staging slabs by CUDA events, CRC32C of the slabs, the
             page-cache write through ``FSStoragePlugin``), then takes with
             the defaults, with checksums off and with fsync, each restored
             bit-exact, the staged slabs pinned and the checksums
             ``crc32c:``; the async_take stall with a cold staging pool and
             after ``warmup_staging`` (which returns the state's bytes);
             the peak RSS delta of each of those takes (``RSSProfiler``)
             beside the process memory budget and the staging pool's
             registered (pinned) bytes; the train state after a step
             taken plain, with
             ``compression="zlib"``, with write batching and with both:
             stored bytes and payload files, each restored bit-exact and
             followed by a bit-identical step; a CheckpointManager with
             zlib and device digests writes 0 B for the unchanged state and
             launches K4 once a leaf.
13. stream - (runs after phase 12) streamed writes and reads under the I/O
             governor: three 1 GiB f32 CUDA tensors of (262,144, 1,024), an
             embedding table's master copy and Adam moments, six 512 MiB
             payloads. The io_uring probe and the engine this process can
             open; a buffered base take and restore (the governor's first
             rates); then, 3 rounds in turns, sync takes under the
             governor's election, with a 64 MiB sub-chunk under
             NATIVE_IO=always and =never, and buffered; restores streamed
             (NATIVE_IO=never and =always) and buffered: GB/s, entries
             streamed, the elected sub-chunk, the staging pool's peak bytes
             and the engines opened. Every take records the base's
             checksums, every restore is bit-exact, the pinned runs stream,
             the NATIVE_IO=always runs open io_uring when the probe passed;
             async_take streams nothing; a sub-chunk corrupted at
             ``fs.pread`` (and ``fs.native_pread``) makes the restore raise
             with the destination unchanged; a restore with device digests
             from the environment runs the hash-rate probe (2 K4 launches).
14. workloads - (runs after phase 11) the rest of one process on one
             device, at full width: the MoE transformer (the entry
             configuration with 8 experts, top-2, capacity factor 1.25, aux
             weight 0.01), the SSM LM (vocab 32768, d_model 512, d_state 16,
             4 layers, f32) at (4, 256) tokens and the embedding model (8
             tables of 100,000 x 64, MLP (256, 64)) at a batch of 2,048
             rows. MoE layer 0 in f32 on the card against the CPU (routing
             identical, 1e-5, einsum and sort); the bf16 MoE model with
             flash (auto) against dense attention, the dense forward taking
             the flash forward's routing, on the tokens whose own routing
             agrees, flips printed, and the sort dispatch once; one MoE
             train step launches each flash kernel 4 times; SSM and
             embedding f32 logits on the card within relative L2 1e-5 of
             the CPU; one train step each; forward and train-step ms with a
             traced idle share. Then the three train states through
             CheckpointManager with device digests (one K4 launch a leaf);
             async_restore of the MoE state while the caller queues SSM
             forwards, against a blocking restore and the same forwards:
             the caller's hold, the time to wait() and to the end, bit-exact
             and a bit-identical next step; read_state_dict of it (CPU
             tensors, bit-exact, ms and bytes); a 1 GiB tensor read into a
             CUDA obj_out with memory_budget_bytes of 64 MiB and with none
             (GB/s, staging pool peak); a fenced async_take whose fence is
             gone after the commit.
15. sharded - (runs after phase 14) snapshots across processes, at the
             full width of phase 14's MoE model (its train state built
             from a seed on the CPU by every process). A world of 2
             processes on the one card (both on cuda:0, gloo under the
             DeviceMesh, the port's store for the snapshot's coordination)
             holds every params and Adam-moment leaf as a Shard(0) DTensor
             on a 1-D mesh (FSDP2's layout) and Adam's count and the step
             as Replicate DTensors; it takes the state with device digests
             (the Replicate leaves auto-detected as replicated and striped
             over both ranks) and async_takes it, with every
             torch.distributed and DTensor collective refused, and
             restores it into another layout (Shard(1)) that holds the
             bytes, with device digests and both peer elections at
             always: 0 payload bytes read, and digest_partial_kernel
             launched at least once an elected region. It takes the state
             again with every leaf replicated and restores it into plain
             CUDA tensors directly and under cooperative fan-out
             (COOP_RESTORE=always), in turns (direct, cooperative,
             cooperative, direct): storage bytes (>= 1.8 x the state
             direct, <= 1.2 x cooperative), peer bytes and ms, bit-exact.
             A world of 4 restores the world of 2's snapshot on a 2 x 2
             mesh ([Shard(0), Shard(1)], or [Shard(0), Replicate] for one
             dim) in turns directly and planned (RESHARD=always: storage
             bytes about one copy), then planned with one corrupt bundle
             (exactly one fallback), every local shard bit-exact, and
             takes the planned restore's state. One process restores the three snapshots
             into plain CUDA tensors (bit-exact) and takes one
             deterministic MoE train step from the planned restore's
             state, bit-identical to the step from the seed-built state
             (each flash kernel 4 launches); read_object of one sharded
             leaf into a CUDA tensor and read_state_dict(rank=1),
             bit-exact. K4's partial form on the largest region of the
             zero-byte restore: against its plain version, its times and
             its bound. The figures say that the processes share one card
             and one host.
16. parallel - (runs after phase 15) training across devices at the
             entry configuration's full width (tokens (4, 256), bf16
             compute, f32 params), in gloo worlds of 4 processes that share
             the one card (hops staged through pinned host memory).
             ``entry.dryrun_multichip(4)``: ring attention on a {data 1,
             seq 2, model 2} mesh, one train step, the snapshot round trip
             of the DTensor state into {data 2, seq 1, model 2} (bit-exact)
             and a second step there. Then a world runs ring, zigzag and
             Ulysses on {data 1, seq 2, model 2} and the sharded flash
             (``auto``) on {data 2, model 2}: one forward and one train
             step each, held against the single-process port on the same
             params and tokens (logits max 0.125 / mean 0.01, loss 1/32,
             gradients relative L2 5e-2), with each rank's K1-K3 launches a
             forward and a step equal to what the code implies (the ring
             skips the hops wholly in the future: 4 or 8 by seq rank;
             zigzag 20; Ulysses and sharded flash 4); before each, one
             bf16 layer through the impl's route on each rank's block, at
             the shapes its path launches the kernels (ring hops (BH 16,
             S 128), zigzag halves S 64, Ulysses and sharded flash BH 8),
             against the plain version (dense f32) and against K1-K3 on
             the whole sequence (3e-2 forward, 0.1 gradients); forward and
             step ms (CUDA events, median of 5), the bytes and ms staged
             through the host, and each rank's traced kernel time of a
             step, with the card's busy time summed over the ranks. One
             process restores the world's ring state bit-exact and steps it
             (4 launches of each kernel). The dryrun also runs the
             device-digest round trip of the restored state (an unchanged
             incremental take stages 0 pieces, a restore into the same
             content consumes 0; K4's full form once an owned piece) and
             the GPipe and 1F1B steps on {data 2, pipe 2} (L 4, D 8).
17. mesh   - (runs after phase 16) the mesh workloads in one gloo world of
             4 processes sharing the card: the SSM LM of phase 14 on {data
             1, seq 2, model 2} (tokens (4, 256)), the embedding model of
             phase 14 on {data 2, model 2} (2,048 rows, tables row-sharded
             over all 4 ranks), and GPipe and 1F1B on {data 2, pipe 2} (L 4
             tanh layers of 512, 1,024 rows, 4 microbatches): each held
             against one process on the same seed (logits, loss,
             gradients), forward and step ms (CUDA events, median of 5),
             the bytes staged through the host; each world state taken and
             restored bit-exact in one process.
18. telemetry - (runs after phase 12, on its 1.953 GiB state) takes and
             restores with telemetry off (the default), on
             (``TORCHSNAPSHOT_GPU_TELEMETRY=1``) and with the flight
             recorder off (``TORCHSNAPSHOT_GPU_FLIGHTREC=0``), 3 rounds in
             turns, each bit-exact: the times side by side; the "on" take's
             ``.snapshot_telemetry`` and Chrome trace; a take failed by
             ``faultinject`` leaves its ``.flight/`` dump, whose merged
             timeline names the abort.
19. durability - (runs after phase 11, in a fresh root) the durability
             tier on the entry configuration's train state on the card (26
             leaves, 201,381,896 B, AdamW, deterministic algorithms as in
             phases 7 and 11). (a) With ``TORCHSNAPSHOT_GPU_JOURNAL=1``:
             save(0); a train step and journal_step(1) (every float leaf
             dirty); journal_step of the unchanged state 5 times (0
             records, K4 once a leaf, median ms); one more step, a
             simulated SIGTERM and the manager's journal flush in place of
             the emergency save; a new manager restores base plus replay
             bit-exact, and one more step from each is bit-identical: each
             journal_step's ms, records, bytes and K4 launches, and the
             replay's ms. With ``_JOURNAL_EPOCH_BYTES`` at a quarter of the
             state, a journal step is a full save. (b) Takes with
             ``TORCHSNAPSHOT_GPU_MANIFEST_FORMAT`` json and columnar: the
             metadata's bytes (TSCM begins ``TSCM``), bit-exact restores.
             (c) Takes with a strict ``mirror_url`` on a second root and
             without, 3 rounds in turns (ms); the primary's payload files
             deleted, the restore from the mirror is bit-exact, with its
             ``mirror.failover`` count. (d) ``dedup.consolidate`` of (a)'s
             journaled chain restores bit-exact to the flushed state. (e)
             ``TORCHSNAPSHOT_GPU_GEOREP`` on a third root: save, a step, a
             journal_step; the replication lag before and after the drain,
             the bytes shipped; the primary root deleted,
             ``Snapshot(remote step).restore`` is bit-exact and counts one
             ``dr_replica_restores``.
20. fleet  - (runs after phase 19, in a fresh root) the fleet tier on the
             same train state, taken with ``replicated=["**"]`` on the page
             cache. (a) Seeding: 4 replica processes share the card and one
             store; replica 0 restores onto ``cuda:0`` under
             ``TORCHSNAPSHOT_GPU_SEED_RESTORE=always``, then 1-3 together:
             storage bytes over the state (direct reads would be 4.0 x, the
             bar 1.2 x), bytes from seeders, cache hits, fallbacks, each
             restore's ms; every leaf bit-exact; each replica serves one
             forward (K1 launches counted), logits bit-identical to the
             trainer's. (b) Rolling update: one train step, journal_step
             (K4 on 26 leaves), push_update to the 4 receivers (epochs,
             bytes, ms); every replica's CUDA leaves equal the trainer's; a
             second push ships 0 epochs; a push with the cursor cleared is
             acknowledged as duplicates and applies nothing; after another
             step, a frame corrupted at ``distrib.epoch_push`` is nacked
             before apply (that replica keeps the earlier state) and the
             next push converges every replica. (c) Page-in: restores of
             the state under ``TORCHSNAPSHOT_GPU_LAZY_RESTORE=always`` with
             the hot set ``^train/params/`` against eager restores, in
             turns: time to first inference (the restore's return plus one
             forward on the hot params, K1), ``resident_fraction`` over
             time; after ``wait()`` every leaf bit-exact to the eager
             restore and the next train step bit-identical; a demand-only
             restore records a first-touch order that a second ``auto``
             restore replays. (d) Tenancy: two tenants on one root; B's
             take of A's identical base adds 0 pool bytes; a quota
             refusal raises before any payload I/O (no step directory);
             each tenant's restore bit-exact; a tenant's seeded restore
             reads no store key outside ``tsnap/t/<tenant>/``; the share
             ratio of two concurrent takes at priorities 3:1 (no bar).
21. planes - (runs last, the only phase with
             ``TORCHSNAPSHOT_GPU_AUTOTUNE=auto``; phases 1-20 run
             ``never``) the attribution, autotune, forensics and /metrics
             planes and the cloud plugins. (c) Forensics: 16 quick storage
             writes, then a take whose first payload write ``faultinject``
             holds 1.5 s: a ``forensic.dump`` flight event and a stacks
             record blaming ``storage_write`` at ``storage_plugins/fs.py``;
             a take that aborts leaves its stacks beside its flight ring.
             (a) and (d): a take and a restore of phase 12's 1.953 GiB with
             the bus on while a thread scrapes ``GET /metrics``
             (``TORCHSNAPSHOT_GPU_METRICS_PORT=0``): each category's seconds
             and share, the binding and its GB/s; ``.snapshot_critpath``
             written, ``stage_copy`` non-zero on the take and ``decode`` on
             the restore, ``sched_idle`` under half the wall, the history
             record's binding the take's; a scrape during the take with
             non-zero bytes and the phase, every exposition ending
             ``# EOF``. (b) Autotune: 8 manager saves of the entry train
             state (device digests, 3 leaves changed between saves, every
             payload write delayed 0.2 s so that storage binds), each
             restored bit-exact: each save's elections (value, source), the
             verdict's binding and GB/s, K4 launches; at most one trial a
             save; a ``type="profile"`` record persisted; a fresh process
             opening a manager on the root elects a learned value with
             source ``profile``. (e) The entry train state taken and
             restored through ``s3://`` and ``gs://`` over the in-memory
             clients of ``test_utils`` (multipart and resumable pieces of 8
             MiB), one transient fault on ``s3.put_part`` and one on
             ``gcs.get``: bit-exact, exactly one retry each; bytes, parts,
             ms.
22. cli    - (runs after phase 21) the command line on the card's state:
             the entry train state plus its bf16 serving embedding, taken
             by a CheckpointManager with device digests and every plane on
             (telemetry, the journal, a mirror, georep, the flight
             recorder) as step 0 and, after one train step, step 1, then an
             incremental take of step 1 and one more journaled step. The
             port's ``cli.main`` runs info, ls, cat (the bf16 and an f32
             leaf), verify, fsck (the steps, the mirror's, the remote's),
             diff, deps, stats (and ``--openmetrics``), explain, plan (of
             phase 15's world-of-2 snapshot onto 4 columns), georep-status,
             consolidate, migrate and store-status, and ``python3 -m
             torchsnapshot_tpu_torch info`` runs in a process of its own:
             verify and fsck exit 0 on the clean steps and 1 after one
             flipped payload byte (``checksum-mismatch``); ``fsck
             --repair`` quarantines a planted orphan and truncates a torn
             journal tail; diff of step 1 against its incremental take
             exits 0, across the train step 1, naming exactly the leaves
             the step changed; explain exits ``binding_exit_code``; the
             consolidated snapshot and the migrated reference fixture
             restore onto the card bit-exact, and the fixture migrated back
             loads identically; each command's wall in ms.

Prints the kernels' JSON line, then the card's name and power limit, then
``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# Bars of tests/test_pallas_attention.py: 1e-5 for f32, 3e-2 for bf16 (o;
# the bf16 kernel also rounds P to bf16 for its second product). For bf16
# inputs the scores are f32 sums of exact bf16 products, so the lse is held
# at 1e-4 (summation order, where the scale is applied, exp2 against exp).
O_ATOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
LSE_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
# bf16 logits, flash vs dense: the dense reference rounds its scores to
# bf16 before the softmax, the kernel keeps them in f32. At logits of
# |x| ~ 5 one bf16 step is 1/32, so the bar is four steps on the maximum
# and a tenth of a step on the mean.
LOGITS_MAX_ATOL = 0.125
LOGITS_MEAN_ATOL = 0.01
# f32 dq, dk, dv against the plain version: 1e-4 absolute, the bar of
# tests/test_pallas_attention.py (the f32 kernels do the plain version's
# f32 arithmetic in another summation order).
F32_GRAD_ATOL = 1e-4
# The bf16 backward kernels run on the tensor cores and round P and dS to
# bf16 to be the A operands of their last products (dV = P^T dO,
# dK = scale dS^T Q, dQ = scale dS K); the plain version keeps them in f32.
# _flash_bwd_emul is the plain version with that rounding. Each bf16
# gradient may differ from the plain one by at most twice what the rounding
# alone moves it (the kernel also sums in another order and rounds its own
# f32 results to bf16), plus 1e-5 for entries near zero; the bf16 gradient
# bar of tests/test_pallas_attention.py, 0.1, stays a ceiling on top.
BF16_GRAD_SLACK = 1e-5
BF16_GRAD_CEILING = 0.1
# Train step 1, flash vs dense in bf16. Every matmul and norm output rounds
# to bf16 (a relative step of 2^-8 = 0.0039) and the dense reference also
# rounds its scores to bf16 before the softmax, the kernels do not. Over 4
# layers forward and back that compounds to several steps: each gradient
# leaf is held to a relative L2 error of 5e-2 (about 13 steps), and the
# f32 loss to 1/32, one bf16 step of the logits at |x| ~ 5.
TRAIN_GRAD_REL_L2 = 5e-2
TRAIN_LOSS_ATOL = 1 / 32
TRAIN_STEPS = 5

DEVICE = "cuda"
STATE_F32_TENSORS, F32_TENSOR_BYTES = 19, 100 << 20
STATE_BF16_TENSORS, BF16_TENSOR_BYTES = 2, 50 << 20
N_REQUESTS = 3
# K4 (csrc/digest.cu) does integer work, not memory work: about 72 SASS
# instructions a 4-byte word (phase 1 counts them in this run's build), most
# of them shifts, XORs and multiplies. Its bound is those instructions at the
# most an H100 SXM dispatches: 132 SMs x 4 schedulers x 32 lanes a clock,
# which takes both integer pipes (ALU for shifts and logic, FMA for IMAD)
# busy at once; the clock is the card's maximum SM clock, from nvidia-smi.
DISPATCH_LANES_PER_CLOCK = 132 * 4 * 32
# The dtypes K4 is held on: the train state's (f32, int32) and every word
# stream the kernel has (2-byte, 8-byte, 1-byte, bool, the float8 types).
DIGEST_DTYPES = ("float32", "int32", "bfloat16", "float16", "int64", "float64", "uint8",
                 "int8", "bool", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
                 "float8_e5m2fnuz", "float8_e8m0fnu")
DIGEST_SIZES = (0, 1, 3, 4097)  # elements; and a 16,777,216-byte tensor
DIGEST_LEAF_BYTES = 16 << 20
MANAGER_TAKE_ROUNDS = 3
IO_ROUNDS = 3
CRC_CHECK_BYTES = 64 << 20
CRC32C_CHECK_VALUE = 0xE3069283  # CRC32C of b"123456789" (RFC 3720)
# Phase 13: an embedding table's f32 master copy and its two Adam moments
# (Llama-3-8B's embedding is 128,256 x 4,096, 2.1 GB in f32), each cut by
# the chunking policy into two 512 MiB payloads.
STREAM_NAMES = ("master", "adam_mu", "adam_nu")
STREAM_SHAPE = (262_144, 1_024)
STREAM_ROUNDS = 3
STREAM_PINNED_SUB_CHUNK = 64 << 20
STREAM_POOL_LIMIT_BYTES = 16 << 30
# Phase 14: the MoE transformer (the entry config with 8 experts, top-2),
# the SSM LM and the embedding model at their configs' defaults. A CPU
# rehearsal shrinks the models through the *_CONFIG_KW overrides.
MOE_EXPERTS = 8
MOE_CONFIG_KW: dict = {}
SSM_CONFIG_KW: dict = {}
EMBEDDING_CONFIG_KW: dict = {}
WORKLOAD_TOKENS = (4, 256)
EMBEDDING_BATCH = 2048
MOE_LAYER_ATOL = 1e-5
WORKLOAD_REL_L2 = 1e-5
ASYNC_RESTORE_FORWARDS = 8
READ_BUDGET_BYTES = 64 << 20
SHARDED_SEED = 15
# Phase 16: the entry config at full width in a gloo world of 4 processes
# on the one card. A CPU rehearsal shrinks it through PARALLEL_CONFIG_KW
# and PARALLEL_TOKENS.
PARALLEL_SEED = 16
PARALLEL_CONFIG_KW: dict = {}
PARALLEL_TOKENS = (4, 256)
PARALLEL_CP_MESH = {"data": 1, "seq": 2, "model": 2}
PARALLEL_IMPLS = (("ring", PARALLEL_CP_MESH), ("zigzag", PARALLEL_CP_MESH),
                  ("ulysses", PARALLEL_CP_MESH), ("auto", {"data": 2, "model": 2}))
PARALLEL_ROUNDS = 5
# One layer of each route against the plain version and K1-K3 on the whole
# sequence: (B, S, H, D) bf16, the entry layer's shape; the attention bars
# of ROADMAP (bf16 forward 3e-2, bf16 gradients 0.1).
RING_LAYER_SHAPE = (4, 256, 8, 64)
RING_LAYER_FWD_ATOL = 3e-2
RING_LAYER_GRAD_ATOL = 0.1
PARALLEL_WORLD = "4 processes sharing one card, gloo"
# Phase 17: the mesh workloads, one world of 4.
MESH_SEED = 17
SSM_MESH = {"data": 1, "seq": 2, "model": 2}
EMBEDDING_MESH = {"data": 2, "model": 2}
PIPE_MESH = {"data": 2, "pipe": 2}
PIPE_LAYERS, PIPE_WIDTH, PIPE_ROWS, PIPE_MICRO = 4, 512, 1024, 4
PIPE_LR = 0.01
MESH_ROUNDS = 5
# Bars against one process on the card (f32 everywhere): the SSM LM's
# logits by relative L2 (the JAX package's mesh bar, 2e-4, as a relative
# L2), every path's loss relative 1e-5 and gradients relative L2 1e-2 (the
# SSM LM's log_a gradient sums every position's term with cancellation: a
# full-width CPU rehearsal gave 3.4e-4 there, 1.9e-5 at the narrow width);
# the pipeline's output max |diff| 1e-5.
MESH_LOGITS_REL_L2 = 2e-4
MESH_LOSS_REL = 1e-5
MESH_GRAD_REL_L2 = 1e-2
PIPE_OUT_ATOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(prof) -> list:
    """(name, device us, count) of every device activity (kernels, memsets,
    copies) that a ``torch.profiler`` session recorded."""
    from torch.autograd import DeviceType

    return [
        (e.key, getattr(e, "self_device_time_total", 0.0), e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    ]


# How each device time in the kernels line was taken: "profiler", or
# "cuda events" where three profiling sessions in a row recorded no device
# activity (then the time includes the host's launch path).
DEVICE_TIMERS: list = []


def device_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the time of every device activity
    that ``iters`` calls launched, as ``torch.profiler`` records it, over
    ``iters``. Host time is not in it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # Now and then a profiling session hands back no device activity at
    # all (seen on an H100 after the worlds of processes sharing the card
    # had run): such a session is taken again, up to three in all, and
    # then CUDA events time the calls instead, recorded in DEVICE_TIMERS.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(t for _, t, _ in _device_events(prof))
        if us > 0:
            DEVICE_TIMERS.append("profiler")
            return us / iters / 1e3
        log("[timing] a profiling session recorded no device time")
    log("[timing] three profiling sessions recorded no device time: CUDA events time this "
        "call instead (host launch time included)")
    DEVICE_TIMERS.append("cuda events")
    return cuda_time_ms(fn, iters=iters, warmup=0)


def device_timer_since(start: int) -> str:
    """How the device times taken since ``len(DEVICE_TIMERS) == start``
    were measured."""
    return " and ".join(sorted(set(DEVICE_TIMERS[start:]))) or "not measured"


def time_in_turns(fns, iters: int, rounds: int = 5, timer=cuda_time_ms, floors=None):
    """Median ms per call of each function by ``timer``, timed in
    alternating turns (a b c, c b a, ...) so clock drift favours none of
    them; also returns each function's (min, max) over the rounds.
    ``floors`` ({name: the least time the card could take, ms}): a round
    that reads under its floor is invalid, reported and never kept; a
    function with no valid round gets None."""
    samples = {name: [] for name in fns}
    for r in range(rounds):
        order = list(fns) if r % 2 == 0 else list(reversed(list(fns)))
        for name in order:
            samples[name].append(timer(fns[name], iters=iters))
    medians, spreads = {}, {}
    for name, v in samples.items():
        floor = (floors or {}).get(name)
        valid = [x for x in v if floor is None or x >= floor]
        if len(valid) < len(v):
            log(f"[timing] INVALID: {name} read under its bound {floor * 1e3:.3f} us in "
                f"{len(v) - len(valid)} of {len(v)} rounds "
                f"({', '.join(f'{x * 1e3:.2f}' for x in v if x < floor)} us): dropped")
        medians[name] = statistics.median(valid) if valid else None
        spreads[name] = (min(valid), max(valid)) if valid else (None, None)
    return medians, spreads


# Calls captured once into a CUDA graph and replayed back to back: CUDA
# events around a replay time the device work without the host's launch
# path (20-40 us a call through the Python wrappers).
GRAPH_CALLS = 100
GRAPH_REPLAYS = 5


def graph_time_ms(fn, n: int = GRAPH_CALLS, replays: int = GRAPH_REPLAYS,
                  stream=None) -> float:
    """Device ms of one call of ``fn``: ``n`` calls captured into one CUDA
    graph on ``stream`` (a new side stream by default; a backward must be
    captured on the stream its forward ran on), CUDA events around each
    replay, the median over ``replays`` replays, over ``n``. Raises when
    the calls cannot be captured."""
    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    torch.cuda.synchronize()
    return statistics.median(times)


def graph_times(fns: dict, stream=None) -> dict:
    """``graph_time_ms`` of each function; None (with the reason logged)
    for one whose calls cannot be captured, such as a call that reads a
    result on the host."""
    out = {}
    for name, fn in fns.items():
        try:
            out[name] = graph_time_ms(fn, stream=stream)
        except Exception as e:  # noqa: BLE001 - reported, the profiler's time stands
            torch.cuda.synchronize()
            log(f"[timing] {name}: not captured in a CUDA graph ({type(e).__name__}: "
                f"{str(e).splitlines()[0] if str(e) else ''})")
            out[name] = None
    return out


def sm_clocks() -> str:
    """The SM clock, its maximum and the power draw, as ``nvidia-smi``
    reads them now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cross_check(name: str, profiler_ms, graph_ms, clocks: dict) -> None:
    """Say on a line of its own when the profiler's device time and the
    CUDA graph's event time of one function disagree by more than 2x."""
    if profiler_ms is None or graph_ms is None:
        return
    ratio = max(profiler_ms, graph_ms) / min(profiler_ms, graph_ms)
    if ratio > 2.0:
        log(f"[timing] TIMERS DISAGREE: {name} profiler {profiler_ms * 1e3:.2f} us, CUDA graph "
            f"{graph_ms * 1e3:.2f} us ({ratio:.2f}x); SM clock before {clocks['before']}, "
            f"after {clocks['after']}")


def _us(value) -> str:
    return "invalid" if value is None else f"{value * 1e3:.2f} us"


# Dynamic shared memory of the wgmma kernels by head dim: 64-row bf16
# tiles (5 in the forward, 6 in each backward kernel) and 1024 bytes of
# slack to align them; ptxas reports only the static part.
def _wgmma_dynamic_smem(n_tiles: int, D: int) -> int:
    return n_tiles * 64 * D * 2 + 1024


def _demangle(name: str) -> str:
    filt = shutil.which("c++filt")
    if filt is None:
        return name
    out = subprocess.run([filt, name], capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or name


def phase_build() -> float:
    """Build every source; print each kernel instance's ptxas registers,
    spills and static shared memory, and the wgmma kernels' dynamic.
    Returns K4's SASS instructions per word."""
    from torchsnapshot_tpu_torch.ops import _build

    sources = ["flash_fwd", "flash_bwd", "digest"]
    t0 = time.perf_counter()
    _build.build(sources)
    log(f"[build] {', '.join(sources)} built together in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        for line in _build.build_logs.get(name, "").splitlines():
            if "Compiling entry" in line:
                mangled = line.split("'")[1] if "'" in line else line
                log(f"[build] {name}: {_demangle(mangled).replace('(anonymous namespace)::', '')}")
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}:   {line.strip()}")
    for kernel, n_tiles in (("flash_fwd_wgmma_kernel", 5), ("flash_bwd_dq_wgmma_kernel", 6),
                            ("flash_bwd_dkv_wgmma_kernel", 6)):
        log(f"[build] {kernel}: dynamic shared memory " + ", ".join(
            f"{_wgmma_dynamic_smem(n_tiles, D)} B at D={D}" for D in (64, 128)))
    return _digest_sass()


def _digest_sass() -> float:
    """K4's instructions per 4-byte word, from the SASS of its f32 kernel:
    the 16-byte loop body (from the backward branch's target to the branch)
    over the 4 words it consumes. Prints the body's opcodes by count."""
    from torchsnapshot_tpu_torch.ops import _build

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", _build._target("digest")], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    func = next(f for f in re.split(r"Function : ", out)[1:]
                if f.split(None, 1)[0].endswith("digest_full_kernelILi4EEEvPKhyyPj"))
    code = [(int(a, 16), ins.strip()) for a, ins in re.findall(r"/\*([0-9a-f]{4})\*/\s+([^;]*);", func)]
    load = next(i for i, (_, ins) in enumerate(code) if "LDG.E.128" in ins)
    branch, target = next((i, int(m.group(1), 16)) for i, (a, ins) in enumerate(code)
                          if i > load and (m := re.search(r"BRA 0x([0-9a-f]+)", ins))
                          and int(m.group(1), 16) <= code[load][0])
    body = [ins for a, ins in code[: branch + 1] if a >= target]
    counts = {}
    for ins in body:
        op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].split(".")[0]
        counts[op] = counts.get(op, 0) + 1
    per_word = len(body) / 4
    log(f"[build] digest_full_kernel<4> 16-byte loop: {len(body)} SASS instructions for 4 words, "
        f"{per_word:.2f} a word ("
        + ", ".join(f"{op} {n}" for op, n in sorted(counts.items(), key=lambda kv: -kv[1])) + ")")
    return per_word


def _qkv(shape, dtype, seed, n=3):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=DEVICE).to(dtype) for _ in range(n))


def _max_err(got, want) -> float:
    return max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))


def _flash_bwd_emul(q, k, v, dO, lse, delta, *, causal=True, scale=None):
    """A plain recompute of ``(dq, dk, dv)`` that rounds P and dS to bf16
    before the three products that take them, as the bf16 tensor-core
    kernels do (tests/test_torch_kernels_cuda.py::flash_bwd_emul)."""
    if scale is None:
        scale = q.shape[2] ** -0.5
    s = scale * torch.matmul(q.float(), k.float().transpose(1, 2))
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, torch.full_like(s, -1e30))
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dO.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta[..., None])
    p, ds = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dq = scale * torch.matmul(ds, k.float())
    dk = scale * torch.matmul(ds.transpose(1, 2), q.float())
    dv = torch.matmul(p.transpose(1, 2), dO.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bf16_grad_errors(got, plain, emul) -> list:
    """For each gradient: (max|got - plain|, its bar), the bar being
    ``2 * max|emul - plain| + BF16_GRAD_SLACK`` capped at the ceiling."""
    out = []
    for g, p, e in zip(got, plain, emul):
        rounding = (e.float() - p.float()).abs().max().item()
        bar = min(2 * rounding + BF16_GRAD_SLACK, BF16_GRAD_CEILING)
        out.append((_max_err([g], [p]), bar))
    return out


def _grads_close(got, plain, emul, dtype) -> bool:
    """f32: every gradient within F32_GRAD_ATOL of the plain one; bf16:
    within the bar that ``emul`` (the rounding recompute) sets."""
    if dtype == torch.float32:
        return _max_err(got, plain) <= F32_GRAD_ATOL
    return all(err <= bar for err, bar in _bf16_grad_errors(got, plain, emul))


def phase_kernels() -> dict:
    """Every kernel against its plain version on the card; returns the
    worst error of each."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    shapes = [(32, 256, 64), (16, 256, 128), (8, 200, 64)]
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v, dO = _qkv(shape, dtype, seed=len(shape) + shape[1], n=4)
                o, lse = fa.flash_fwd_cuda(q, k, v, causal=causal)
                o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=causal)
                # The backward from the reference's statistics, as autograd
                # hands them over (delta in f32).
                delta = (dO.float() * o_ref.float()).sum(-1)
                dq = fa.flash_bwd_dq(q, k, v, dO, lse_ref, delta, causal=causal)
                dk, dv = fa.flash_bwd_dkv(q, k, v, dO, lse_ref, delta, causal=causal)
                plain = fa.flash_bwd_reference(q, k, v, dO, lse_ref, delta, causal=causal)
                emul = _flash_bwd_emul(q, k, v, dO, lse_ref, delta, causal=causal)
                torch.cuda.synchronize()
                err_o = _max_err([o], [o_ref])
                err_l = (lse - lse_ref).abs().max().item()
                err_dq = _max_err([dq], plain[:1])
                err_dkv = _max_err([dk, dv], plain[1:])
                ok = (err_o <= O_ATOL[dtype] and err_l <= LSE_ATOL[dtype]
                      and _grads_close([dq, dk, dv], plain, emul, dtype))
                log(
                    f"[kernels] BH,S,D={shape} {str(dtype)[6:]} causal={causal}: "
                    f"flash_fwd max|o-ref|={err_o:.3g} max|lse-ref|={err_l:.3g}; "
                    f"flash_bwd_dq max|dq-ref|={err_dq:.3g}; "
                    f"flash_bwd_dkv max|dk,dv-ref|={err_dkv:.3g} {'ok' if ok else 'FAIL'}"
                )
                if not ok:
                    raise AssertionError(f"a kernel disagrees with its plain version at {shape}")
                worst["flash_fwd"] = max(worst["flash_fwd"], err_o, err_l)
                worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], err_dq)
                worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], err_dkv)

    worst["flash_fwd"] = max(worst["flash_fwd"], _fwd_bf16_sweep())
    err_dq, err_dkv = _bwd_bf16_sweep()
    worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], err_dq)
    worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], err_dkv)
    for dtype in (torch.float32, torch.bfloat16):
        err_dq, err_dkv = _raw_split(dtype)
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], err_dq)
        worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], err_dkv)
    return worst


def _combine(halves):
    """dq summed over the two halves (in f32), dk and dv concatenated."""
    return (
        halves[0][0].float() + halves[1][0].float(),
        torch.cat([halves[0][1], halves[1][1]], 1),
        torch.cat([halves[0][2], halves[1][2]], 1),
    )


def _raw_split(dtype):
    """The raw split, as a ring hop drives it: q against two halves of twice
    the keys, each half given the GLOBAL lse and delta over all of them. dq
    sums over the halves; each half's dk, dv are slices of the whole. f32
    is held to F32_GRAD_ATOL; bf16 to the bar of the same split through
    ``_flash_bwd_emul``. Returns the worst dq and dk/dv errors."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    BH, S, D = 32, 256, 64
    q, dO = _qkv((BH, S, D), dtype, seed=11, n=2)
    k, v = _qkv((BH, 2 * S, D), dtype, seed=12, n=2)
    o, lse = fa.flash_fwd_reference(q, k, v, causal=False)
    delta = (dO.float() * o.float()).sum(-1)
    plain = fa.flash_bwd_reference(q, k, v, dO, lse, delta, causal=False)
    parts = [(k[:, h].contiguous(), v[:, h].contiguous()) for h in (slice(0, S), slice(S, 2 * S))]
    got = _combine([fa.flash_bwd_cuda(q, kh, vh, dO, lse, delta, causal=False) for kh, vh in parts])
    emul = _combine([_flash_bwd_emul(q, kh, vh, dO, lse, delta, causal=False) for kh, vh in parts])
    torch.cuda.synchronize()
    err_dq = _max_err(got[:1], plain[:1])
    err_dkv = _max_err(got[1:], plain[1:])
    ok = _grads_close(got, plain, emul, dtype)
    log(f"[kernels] raw split, q (BH={BH}, S={S}, D={D}) {str(dtype)[6:]} against 2 x {S} keys "
        f"with global lse and delta: max|sum dq-ref|={err_dq:.3g} max|dk,dv-ref|={err_dkv:.3g} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {dtype} raw backward split disagrees with the whole")
    return err_dq, err_dkv


def _bwd_bf16_sweep():
    """The bf16 backward kernels against their plain version, under the bar
    of ``_flash_bwd_emul``, over the sequence lengths their 64-row tiles
    must handle, both head dims, both masks and one or 32 heads; then two
    launches on the same inputs must be bit-identical. Returns the worst
    dq and dk/dv errors."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    dtype, worst_dq, worst_dkv = torch.bfloat16, 0.0, 0.0
    for S in (1, 16, 100, 200, 256, 512):
        for D in (64, 128):
            errs = []
            for causal in (True, False):
                for BH in (1, 32):
                    q, k, v, dO = _qkv((BH, S, D), dtype, seed=S + D + BH, n=4)
                    o, lse = fa.flash_fwd_reference(q, k, v, causal=causal)
                    delta = (dO.float() * o.float()).sum(-1)
                    got = fa.flash_bwd_cuda(q, k, v, dO, lse, delta, causal=causal)
                    plain = fa.flash_bwd_reference(q, k, v, dO, lse, delta, causal=causal)
                    emul = _flash_bwd_emul(q, k, v, dO, lse, delta, causal=causal)
                    torch.cuda.synchronize()
                    case = _bf16_grad_errors(got, plain, emul)
                    if not all(err <= bar for err, bar in case):
                        raise AssertionError(
                            f"flash_bwd bf16 disagrees with its plain version at BH={BH}, S={S}, "
                            f"D={D}, causal={causal}: (max|kernel-plain|, bar) of dq, dk, dv "
                            + ", ".join(f"({e:.3g}, {b:.3g})" for e, b in case)
                        )
                    errs.append(case)
            worst_dq = max(worst_dq, *(c[0][0] for c in errs))
            worst_dkv = max(worst_dkv, *(max(c[1][0], c[2][0]) for c in errs))
            log(f"[kernels] flash_bwd bf16 S={S} D={D}, causal and not, BH 1 and 32: "
                + ", ".join(
                    f"{name} max|err|={max(c[i][0] for c in errs):.3g} "
                    f"(worst err/bar {max(c[i][0] / c[i][1] for c in errs):.2f})"
                    for i, name in enumerate(("dq", "dk", "dv"))
                ) + " ok")
    q, k, v, dO = _qkv((32, 256, 64), dtype, seed=10, n=4)
    o, lse = fa.flash_fwd_cuda(q, k, v)
    delta = (dO.float() * o.float()).sum(-1)
    first = fa.flash_bwd_cuda(q, k, v, dO, lse, delta)
    second = fa.flash_bwd_cuda(q, k, v, dO, lse, delta)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("two launches of flash_bwd bf16 on the same inputs differ")
    log("[kernels] flash_bwd bf16: two launches on the same inputs are bit-identical")
    return worst_dq, worst_dkv


def _fwd_bf16_sweep() -> float:
    """The bf16 forward kernel against its plain version over the sequence
    lengths its 64-row tiles must handle (one row, part of a tile, ragged,
    whole tiles), both head dims, both masks and one or 32 heads; then two
    launches on the same inputs must be bit-identical. Returns the worst
    error."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    dtype, worst = torch.bfloat16, 0.0
    for S in (1, 16, 100, 200, 256, 512):
        for D in (64, 128):
            errs = []
            for causal in (True, False):
                for BH in (1, 32):
                    q, k, v = _qkv((BH, S, D), dtype, seed=S + D + BH)
                    o, lse = fa.flash_fwd_cuda(q, k, v, causal=causal)
                    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=causal)
                    torch.cuda.synchronize()
                    err_o = _max_err([o], [o_ref])
                    err_l = (lse - lse_ref).abs().max().item()
                    if not (err_o <= O_ATOL[dtype] and err_l <= LSE_ATOL[dtype]):
                        raise AssertionError(
                            f"flash_fwd bf16 disagrees with its plain version at BH={BH}, S={S}, "
                            f"D={D}, causal={causal}: max|o-ref|={err_o:.3g} max|lse-ref|={err_l:.3g}"
                        )
                    errs.append((err_o, err_l))
            worst = max(worst, *(max(e) for e in errs))
            log(f"[kernels] flash_fwd bf16 S={S} D={D}, causal and not, BH 1 and 32: "
                f"max|o-ref|={max(e[0] for e in errs):.3g} "
                f"max|lse-ref|={max(e[1] for e in errs):.3g} ok")
    q, k, v = _qkv((32, 256, 64), dtype, seed=9)
    first, second = fa.flash_fwd_cuda(q, k, v), fa.flash_fwd_cuda(q, k, v)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("two launches of flash_fwd bf16 on the same inputs differ")
    log("[kernels] flash_fwd bf16: two launches on the same inputs are bit-identical")
    return worst


def phase_serve(fn, params, cfg):
    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=DEVICE).manual_seed(1)
    requests = [
        torch.randint(0, cfg.vocab_size, (4, 256), generator=g, device=DEVICE)
        for _ in range(N_REQUESTS)
    ]
    fa.flash_fwd.launches = 0
    t0 = time.perf_counter()
    answers = [fn(params, tokens) for tokens in requests]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_fwd.launches
    log(f"[serve] {N_REQUESTS} requests of (4, 256) tokens in {wall * 1e3:.1f} ms; "
        f"flash_fwd launches {launches}")
    if launches != N_REQUESTS * cfg.n_layers:
        raise AssertionError(
            f"expected {N_REQUESTS * cfg.n_layers} flash_fwd launches, got {launches}"
        )
    # A reload can only answer bit-identically if the forward itself is
    # deterministic: answer the first request again and require equality.
    again = fn(params, requests[0])
    if not torch.equal(again, answers[0]):
        q, k, v = _qkv((32, 256, 64), torch.bfloat16, seed=4)
        x, w = _qkv((1024, 512), torch.bfloat16, seed=5)[:2]
        log(
            f"[serve] forward not deterministic: max diff "
            f"{(again.float() - answers[0].float()).abs().max().item()}; "
            f"flash_fwd repeat equal {torch.equal(fa.flash_fwd(q, k, v)[0], fa.flash_fwd(q, k, v)[0])}; "
            f"matmul repeat equal {torch.equal(x @ w.T, x @ w.T)}"
        )
        raise AssertionError("the same request answered twice gave different logits")
    log("[serve] the same request answered twice: bit-identical logits")
    dense_cfg = dataclasses.replace(cfg, attn_impl="dense")
    for tokens, logits in zip(requests, answers):
        if logits.shape != (4, 256, cfg.vocab_size) or not torch.isfinite(logits.float()).all():
            raise AssertionError("serving logits are malformed or not finite")
        ref = T.forward(params, tokens, dense_cfg).float()
        diff = (logits.float() - ref).abs()
        log(f"[serve] logits vs dense: max {diff.max().item():.4f} mean {diff.mean().item():.5f}")
        if diff.max().item() > LOGITS_MAX_ATOL or diff.mean().item() > LOGITS_MEAN_ATOL:
            raise AssertionError("flash logits disagree with dense logits")
    return launches, requests[0], answers[0]


def _zeros_like_params(params):
    return {
        "embed": torch.zeros_like(params["embed"]),
        "layers": {k: torch.zeros_like(v) for k, v in params["layers"].items()},
        "ln_f_scale": torch.zeros_like(params["ln_f_scale"]),
    }


def _leaves(params):
    yield "embed", params["embed"]
    for k, v in params["layers"].items():
        yield f"layers/{k}", v
    yield "ln_f_scale", params["ln_f_scale"]


def phase_checkpoint(fn, params, tokens, logits, root: str) -> None:
    from torchsnapshot_tpu_torch import RNGState, Snapshot, StateDict

    progress = {"step": 7, "requests_served": N_REQUESTS}
    Snapshot.take(
        f"{root}/ckpt",
        {"model": StateDict(params=params), "progress": StateDict(progress), "rng": RNGState()},
    )
    fresh = _zeros_like_params(params)
    fresh_progress = StateDict(step=0, requests_served=0)
    Snapshot(f"{root}/ckpt").restore(
        {"model": StateDict(params=fresh), "progress": fresh_progress, "rng": RNGState()}
    )
    for name, t in _leaves(params):
        got = dict(_leaves(fresh))[name]
        if got.device != t.device or not torch.equal(got, t):
            raise AssertionError(f"restored param {name} differs from the saved one")
    if dict(fresh_progress) != progress:
        raise AssertionError(f"restored progress {dict(fresh_progress)} != {progress}")
    again = fn(fresh, tokens)
    if not torch.equal(again, logits):
        raise AssertionError("restored model's logits are not bit-identical")
    log("[checkpoint] take -> restore into zeros: params bit-exact, logits bit-identical")

    before = {name: t.clone() for name, t in _leaves(params)}
    pending = Snapshot.async_take(f"{root}/async", {"model": StateDict(params=params)})
    for _, t in _leaves(params):
        t.add_(1.0)  # overwrite as soon as async_take returns
    pending.wait()
    fresh = _zeros_like_params(params)
    Snapshot(f"{root}/async").restore({"model": StateDict(params=fresh)})
    for name, t in _leaves(fresh):
        if not torch.equal(t, before[name]):
            raise AssertionError(f"async_take captured a value of {name} written after it returned")
    for _, t in _leaves(params):
        t.sub_(1.0)
    log("[checkpoint] async_take, overwrite at return, restore: pre-overwrite values back")


def _big_state() -> dict:
    """Phase 12's state: about 2 GiB of CUDA tensors from seed 2."""
    g = torch.Generator(device=DEVICE).manual_seed(2)
    state = {}
    for i in range(STATE_F32_TENSORS):
        state[f"f32_{i}"] = torch.randn(F32_TENSOR_BYTES // 4, generator=g, device=DEVICE)
    for i in range(STATE_BF16_TENSORS):
        state[f"bf16_{i}"] = torch.randn(
            BF16_TENSOR_BYTES // 2, generator=g, device=DEVICE
        ).to(torch.bfloat16).reshape(-1, 1024)
    return state


def phase_state(root: str, card: str):
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    state = _big_state()
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot.take(f"{root}/state", {"model": StateDict(state)})
    save_s = time.perf_counter() - t0
    dst = {k: torch.zeros_like(t) for k, t in state.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot(f"{root}/state").restore({"model": StateDict(dst)})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for k, t in state.items():
        if not torch.equal(dst[k], t):
            raise AssertionError(f"2 GiB state: {k} restored wrong")
    log(
        f"[state] {nbytes / 2**30:.3f} GiB in {len(state)} CUDA tensors, bit-exact; "
        f"save {nbytes / save_s / 1e9:.3f} GB/s ({save_s:.3f} s), "
        f"restore {nbytes / restore_s / 1e9:.3f} GB/s ({restore_s:.3f} s) on {card}"
    )
    # The training stall of an async take: the caller is held until every
    # entry is staged in pinned memory; writes finish in the background.
    t0 = time.perf_counter()
    pending = Snapshot.async_take(f"{root}/state_async", {"model": StateDict(state)})
    stall_s = time.perf_counter() - t0
    pending.wait()
    total_s = time.perf_counter() - t0
    log(f"[state] async_take of the same state: returned after {stall_s:.3f} s, "
        f"committed after {total_s:.3f} s on {card}")
    return state


@contextlib.contextmanager
def _env(**values):
    """Set environment variables for the block, then restore them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _payload_files(path: str):
    """(number of payload files, their bytes) under a snapshot."""
    sizes = [os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path)
             for f in fs if f != ".snapshot_metadata"]
    return len(sizes), sum(sizes)


def _gbps(nbytes: int, seconds: float) -> str:
    return f"{nbytes / seconds / 1e9:.3f} GB/s"


def _io_library(card: str) -> None:
    import zlib

    from torchsnapshot_tpu_torch import _native

    if not _native.native_available():
        raise AssertionError("the native host library did not build")
    log(f"[io] native host library {os.path.basename(_native.library_path())} built by g++ "
        f"{' '.join(_native.GXX_FLAGS)}; uname -m {os.uname().machine}; SSE4.2 CRC32C "
        f"(ts_has_hw_crc) {int(_native.has_hw_crc())}; staging slab capabilities seen "
        f"{_native.slab_caps_seen():#x} (1 hugetlb, 2 mlock, 4 pre-faulted, 8 THP)")
    if _native.crc32c(b"123456789") != CRC32C_CHECK_VALUE:
        raise AssertionError("crc32c(b'123456789') is not 0xE3069283")
    g = torch.Generator().manual_seed(3)
    data = torch.randint(0, 256, (CRC_CHECK_BYTES,), dtype=torch.uint8, generator=g).numpy()
    t0 = time.perf_counter()
    plain = _native.crc32c_plain(data)
    plain_s = time.perf_counter() - t0
    if _native.crc32c(data) != plain:
        raise AssertionError("native CRC32C differs from the plain table version")
    rates = {}
    for name, fn in (("crc32c", _native.crc32c), ("zlib crc32", zlib.crc32)):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(data)
            times.append(time.perf_counter() - t0)
        rates[name] = statistics.median(times)
    log(f"[io] crc32c(b'123456789') = 0x{CRC32C_CHECK_VALUE:08X}; {CRC_CHECK_BYTES >> 20} MiB of random bytes: native "
        f"CRC32C equals the plain table version (0x{plain:08x}, plain {plain_s:.1f} s); one thread, "
        f"median of 5: CRC32C {_gbps(CRC_CHECK_BYTES, rates['crc32c'])}, zlib CRC32 "
        f"{_gbps(CRC_CHECK_BYTES, rates['zlib crc32'])} on {card}")


def _io_layers(root: str, state: dict, card: str) -> None:
    """Each layer of a take alone over the same tensors: DtoH into
    registered staging slabs (CUDA events), CRC32C of the slabs (one
    thread), the page-cache write of the slabs through FSStoragePlugin
    (concurrent, as the take's writes are)."""
    from torchsnapshot_tpu_torch._native import crc32c
    from torchsnapshot_tpu_torch.io_preparers.array import pooled_buffer
    from torchsnapshot_tpu_torch.io_types import WriteIO
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    flat = [t.reshape(-1).view(torch.uint8) for t in state.values()]
    nbytes = sum(f.numel() for f in flat)
    slabs = [pooled_buffer(f.numel(), pinned=True) for f in flat]
    if not all(s is not None and s.is_pinned() for s in slabs):
        raise AssertionError("a staging slab is missing or not pinned")
    stream = torch.cuda.Stream()

    def dtoh() -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            start.record(stream)
            for slab, src in zip(slabs, flat):
                slab.copy_(src, non_blocking=True)
            end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    dtoh()
    if not all(torch.equal(slab, src.cpu()) for slab, src in zip(slabs[:2], flat[:2])):
        raise AssertionError("DtoH into a registered slab copied wrong bytes")
    dtoh_s, crc_s, write_s = [], [], []
    storage = FSStoragePlugin(f"{root}/io_layers")

    async def write_all(r: int) -> None:
        await asyncio.gather(*(
            storage.write(WriteIO(path=f"{r}/{i}", buf=memoryview(slab.numpy())))
            for i, slab in enumerate(slabs)))

    loop = asyncio.new_event_loop()
    try:
        for r in range(IO_ROUNDS):
            dtoh_s.append(dtoh())
            t0 = time.perf_counter()
            for slab in slabs:
                crc32c(slab.numpy())
            crc_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            loop.run_until_complete(write_all(r))
            write_s.append(time.perf_counter() - t0)
            shutil.rmtree(f"{root}/io_layers/{r}")
    finally:
        loop.close()
    for name, times in (("DtoH into registered slabs (CUDA events)", dtoh_s),
                        ("CRC32C of the slabs (one thread)", crc_s),
                        ("page-cache write through FSStoragePlugin", write_s)):
        med = statistics.median(times)
        log(f"[io] layer {name}, {nbytes / 2**30:.3f} GiB in {len(flat)} tensors, median of "
            f"{IO_ROUNDS}: {_gbps(nbytes, med)} ({med * 1e3:.1f} ms; range "
            f"{min(times) * 1e3:.1f}-{max(times) * 1e3:.1f} ms) on {card}")


def _io_takes(root: str, state: dict, card: str) -> None:
    """End-to-end takes of the state with the defaults (CRC32C, pool
    warm), with checksums off and with fsync, in turns, each restored
    bit-exact; the staged buffers must be pinned."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.io_preparers.array import ArrayBufferStager, _staging_pool
    from torchsnapshot_tpu_torch.rss_profiler import RSSProfiler
    from torchsnapshot_tpu_torch.scheduler import get_process_memory_budget_bytes

    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    kinds = {"defaults": {}, "TORCHSNAPSHOT_GPU_CHECKSUM=0": {"TORCHSNAPSHOT_GPU_CHECKSUM": "0"},
             "TORCHSNAPSHOT_GPU_FSYNC=1": {"TORCHSNAPSHOT_GPU_FSYNC": "1"}}
    dst = {k: torch.empty_like(t) for k, t in state.items()}
    pinned = []
    stage = ArrayBufferStager._stage_cuda

    async def spy(self, executor):
        host = await stage(self, executor)
        pinned.append(host.is_pinned())
        return host

    samples = {k: [] for k in kinds}
    rss_peaks = {k: [] for k in kinds}
    ArrayBufferStager._stage_cuda = spy
    try:
        for r in range(2):
            for kind in (list(kinds) if r == 0 else list(reversed(list(kinds)))):
                path = f"{root}/io_take"
                with _env(**kinds[kind]):
                    _sync()
                    rss = RSSProfiler(interval_s=0.02)
                    t0 = time.perf_counter()
                    with rss:
                        Snapshot.take(path, {"model": StateDict(state)})
                    take_s = time.perf_counter() - t0
                rss_peaks[kind].append(rss.peak_delta_bytes)
                sums = {c.array.checksum for e in Snapshot(path).metadata.manifest.values()
                        for c in getattr(e, "chunks", None) or []}
                if kind == "TORCHSNAPSHOT_GPU_CHECKSUM=0":
                    ok = sums == {None}
                else:
                    ok = all(c and c.startswith("crc32c:") for c in sums)
                if not ok:
                    raise AssertionError(f"take ({kind}) recorded checksums {sorted(map(str, sums))[:2]}")
                for t in dst.values():
                    t.zero_()
                _sync()
                t0 = time.perf_counter()
                Snapshot(path).restore({"model": StateDict(dst)})
                _sync()
                restore_s = time.perf_counter() - t0
                if any(not torch.equal(dst[k], t) for k, t in state.items()):
                    raise AssertionError(f"take ({kind}) did not restore bit-exact")
                samples[kind].append((take_s, restore_s))
                shutil.rmtree(path)
    finally:
        ArrayBufferStager._stage_cuda = stage
    if not pinned or not all(pinned):
        raise AssertionError(f"{pinned.count(False)} of {len(pinned)} staged buffers were not pinned")
    for kind, rows in samples.items():
        log(f"[io] take of the {nbytes / 2**30:.3f} GiB state, {kind}, 2 rounds in turns: save "
            f"{', '.join(_gbps(nbytes, t) for t, _ in rows)} "
            f"({', '.join(f'{t:.3f}' for t, _ in rows)} s); restore bit-exact at "
            f"{', '.join(_gbps(nbytes, r) for _, r in rows)}; on {card}")
    log(f"[io] every staged buffer of those takes was pinned ({len(pinned)} of {len(pinned)})")
    log("[io] peak RSS delta of each take (RSSProfiler, /proc/self/statm every 20 ms): "
        + "; ".join(f"{kind} {', '.join(f'{p / 2**20:.1f}' for p in peaks)} MiB"
                    for kind, peaks in rss_peaks.items())
        + f"; process memory budget {get_process_memory_budget_bytes() / 2**30:.3f} GiB; "
        f"staging pool registered (pinned) {_staging_pool.registered_bytes / 2**30:.3f} GiB, "
        f"its peak outstanding {_staging_pool.peak_bytes / 2**30:.3f} GiB; {card}")


@contextlib.contextmanager
def _last_ends():
    """The time the last entry finished staging and the last payload write
    finished, while the block runs: ``{"staged": t, "written": t}``."""
    from torchsnapshot_tpu_torch.io_preparers.array import ArrayBufferStager
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    ends = {"staged": 0.0, "written": 0.0}
    stage, write = ArrayBufferStager.stage_buffer, FSStoragePlugin.write

    async def staged(self, executor=None):
        out = await stage(self, executor)
        ends["staged"] = max(ends["staged"], time.perf_counter())
        return out

    async def written(self, write_io):
        await write(self, write_io)
        ends["written"] = max(ends["written"], time.perf_counter())

    ArrayBufferStager.stage_buffer, FSStoragePlugin.write = staged, written
    try:
        yield ends
    finally:
        ArrayBufferStager.stage_buffer, FSStoragePlugin.write = stage, write


def _io_stalls(root: str, state: dict, card: str) -> None:
    """The async_take stall with a cold staging pool and after warmup, and
    when in it the last entry was staged and the last write landed."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict, warmup_staging
    from torchsnapshot_tpu_torch.io_preparers.array import clear_staging_pool

    app = {"model": StateDict(state)}
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    for kind in ("cold pool", "after warmup_staging", "after warmup_staging"):
        gc.collect()
        clear_staging_pool()
        warmed, warm_s = 0, 0.0
        if kind != "cold pool":
            t0 = time.perf_counter()
            warmed = warmup_staging(app)
            warm_s = time.perf_counter() - t0
            if warmed != nbytes:
                raise AssertionError(f"warmup_staging returned {warmed}, not the state's {nbytes} B")
        _sync()
        with _last_ends() as ends:
            t0 = time.perf_counter()
            pending = Snapshot.async_take(f"{root}/io_stall", app)
            stall = time.perf_counter() - t0
            pending.wait()
            total = time.perf_counter() - t0
        shutil.rmtree(f"{root}/io_stall")
        warm = f" (warmup_staging returned {warmed} B in {warm_s:.3f} s)" if warmed else ""
        log(f"[io] async_take of the {nbytes / 2**30:.3f} GiB state, {kind}{warm}: returned after "
            f"{stall:.3f} s, committed after {total:.3f} s; the last entry was staged at "
            f"{ends['staged'] - t0:.3f} s and the last payload written at "
            f"{ends['written'] - t0:.3f} s; on {card}")


def _io_train_state(root: str, card: str) -> int:
    """The train state after a step, taken plain, compressed, batched and
    both; each restores bit-exact and the next step is bit-identical. Then
    a compressed manager with device digests saves the unchanged state:
    0 B written, K4 once a leaf. Returns K4's launches in that save."""
    from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict
    from torchsnapshot_tpu_torch import device_digest as dd
    from torchsnapshot_tpu_torch.entry import train_entry

    def clone(st) -> dict:
        return {p: t.clone() for p, t in _flat(st).items()}

    def same(st, want: dict) -> bool:
        got = _flat(st)
        return got.keys() == want.keys() and all(torch.equal(got[p], want[p]) for p in want)

    torch.use_deterministic_algorithms(True)
    try:
        train_step, (tstate, batch) = train_entry(device=DEVICE, seed=0)
        train_step(tstate, batch)
        saved = clone(tstate)
        raw = sum(t.numel() * t.element_size() for t in saved.values())
        kinds = {"plain": ({}, {}), 'compression="zlib"': ({"compression": "zlib"}, {}),
                 "TORCHSNAPSHOT_GPU_ENABLE_BATCHING=1": ({}, {"TORCHSNAPSHOT_GPU_ENABLE_BATCHING": "1"}),
                 "zlib and batching": ({"compression": "zlib"},
                                       {"TORCHSNAPSHOT_GPU_ENABLE_BATCHING": "1"})}
        taken = {}
        for i, (kind, (kwargs, env)) in enumerate(kinds.items()):
            path = f"{root}/io_train_{i}"
            with _env(**env):
                _sync()
                t0 = time.perf_counter()
                Snapshot.take(path, {"train": StateDict(tstate)}, **kwargs)
                taken[kind] = (path, time.perf_counter() - t0, *_payload_files(path))
        _, loss_ref = train_step(tstate, batch)
        after = clone(tstate)
        for kind, (path, take_s, files, stored) in taken.items():
            _, (fresh, _) = train_entry(device=DEVICE, seed=1)
            holder = StateDict(fresh)
            t0 = time.perf_counter()
            Snapshot(path).restore({"train": holder})
            _sync()
            restore_s = time.perf_counter() - t0
            restored = dict(holder)
            if not same(restored, saved):
                raise AssertionError(f"the train state taken {kind} did not restore bit-exact")
            _, loss = train_step(restored, batch)
            if not torch.equal(loss, loss_ref) or not same(restored, after):
                raise AssertionError(f"the step after the restore of {kind} is not bit-identical")
            log(f"[io] train state ({raw} B raw), {kind}: stored {stored} B ({stored / raw:.4f} "
                f"of raw) in {files} payload files; take {take_s * 1e3:.1f} ms, restore "
                f"{restore_s * 1e3:.1f} ms, bit-exact, next step bit-identical (loss "
                f"{loss.item():.6f}); on {card}")
        if taken['compression="zlib"'][3] >= raw or taken["TORCHSNAPSHOT_GPU_ENABLE_BATCHING=1"][2] >= len(saved):
            raise AssertionError("compression stored no fewer bytes, or batching wrote no fewer files")

        app = {"train": StateDict(tstate)}
        mgr = CheckpointManager(f"{root}/io_manager", incremental=True, device_digests=True,
                                compression="zlib")
        mgr.warmup(app)
        mgr.save(0, app)
        files0, stored0 = _payload_files(mgr.path_for(0))
        with _CheckpointSpies() as spies:
            dd.fingerprint_lanes.launches = 0
            mgr.save(1, app)
            _sync()
            launches = dd.fingerprint_lanes.launches
        log(f"[io] CheckpointManager(compression='zlib', device_digests=True, incremental=True): "
            f"step 0 stored {stored0} B in {files0} files; the unchanged state at step 1 staged "
            f"{spies.staged_bytes} B, wrote {spies.written_bytes} B, K4 launches {launches}")
        if spies.written_bytes or spies.staged_bytes:
            raise AssertionError("the compressed manager wrote payload for an unchanged state")
        if DEVICE == "cuda" and launches != len(saved):
            raise AssertionError(f"expected {len(saved)} K4 launches, got {launches}")
        _, (fresh, _) = train_entry(device=DEVICE, seed=1)
        holder = StateDict(fresh)
        mgr.restore({"train": holder}, step=1)
        if not same(dict(holder), clone(tstate)):
            raise AssertionError("the manager's step 1 did not restore bit-exact")
        log("[io] the manager's step 1 restores bit-exact through its zlib payloads in step 0")
        return launches
    finally:
        torch.use_deterministic_algorithms(False)


def phase_io(root: str, state: dict, card: str) -> int:
    """Phase 12 (see the module docstring). Returns K4's launches."""
    _io_library(card)
    _io_layers(root, state, card)
    _io_takes(root, state, card)
    _io_stalls(root, state, card)
    return _io_train_state(root, card)


def _chunk_checksums(path: str) -> dict:
    from torchsnapshot_tpu_torch import Snapshot

    return {c.array.location: c.array.checksum for e in Snapshot(path).metadata.manifest.values()
            for c in getattr(e, "chunks", None) or []}


def _median_range(values) -> str:
    return f"{statistics.median(values):.3f} ({min(values):.3f}-{max(values):.3f})"


def phase_stream(root: str, card: str) -> dict:
    """Phase 13 (see the module docstring). Returns K4's launches on the
    paths this phase drives."""
    from torchsnapshot_tpu_torch import StateDict
    from torchsnapshot_tpu_torch import scheduler as sched
    from torchsnapshot_tpu_torch.io_preparers.array import _staging_pool, clear_staging_pool

    g = torch.Generator(device=DEVICE).manual_seed(13)
    state = {n: torch.randn(STREAM_SHAPE, generator=g, device=DEVICE) for n in STREAM_NAMES}
    dst = {n: torch.empty_like(t) for n, t in state.items()}
    app = {"embedding": StateDict(state)}
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    gov = sched.reset_io_governor()
    counts = sched.stream_counts
    # The runs below alternate four take and three restore kinds in one
    # process, whose slab sizes (512 MiB entries, 64 MiB and the elected
    # size classes) would not all stay pooled under the default 4 GiB
    # limit; a user runs one kind. Each run prints the slabs it allocated.
    limit = _staging_pool._limit
    _staging_pool._limit = STREAM_POOL_LIMIT_BYTES
    try:
        return _phase_stream(root, card, state, dst, app, nbytes, gov, counts)
    finally:
        # Back to the default limit, and the slabs over it unregistered.
        _staging_pool._limit = limit
        del state, dst, app
        gc.collect()
        clear_staging_pool()


def _phase_stream(root, card, state, dst, app, nbytes, gov, counts) -> dict:
    from torchsnapshot_tpu_torch import Snapshot, StateDict, faultinject, native_io
    from torchsnapshot_tpu_torch import device_digest as dd
    from torchsnapshot_tpu_torch import scheduler as sched
    from torchsnapshot_tpu_torch.integrity import IntegrityError
    from torchsnapshot_tpu_torch.io_preparers.array import _staging_pool

    probe, engine = native_io.probe_result(), native_io.engine_kind()
    why = "" if probe in (0, None) else f" ({os.strerror(-probe) if probe < 0 else probe})"
    log(f"[stream] io_uring probe {probe}{why}; the engine this process can open: "
        f"{engine or 'none (Python pwrite/preadv path)'}")

    def restored_exactly() -> bool:
        return all(torch.equal(dst[n], state[n]) for n in state)

    def restore(path: str, env: dict):
        for t in dst.values():
            t.zero_()
        reads, opened = counts["entries_stream_read"], dict(native_io.opened)
        gc.collect()
        _staging_pool.reset_peak()
        base, misses = _staging_pool.outstanding_bytes, _staging_pool.misses
        with _env(**env):
            _sync()
            t0 = time.perf_counter()
            Snapshot(path).restore({"embedding": StateDict(dst)})
            _sync()
            dt = time.perf_counter() - t0
        if not restored_exactly():
            raise AssertionError(f"the {nbytes >> 30} GiB state did not restore bit-exact ({env})")
        return dt, counts["entries_stream_read"] - reads, _staging_pool.peak_bytes - base, {
            k: native_io.opened[k] - opened.get(k, 0) for k in native_io.opened}, None, \
            _staging_pool.misses - misses

    def take(path: str, env: dict):
        streamed, opened = counts["entries_streamed"], dict(native_io.opened)
        gc.collect()
        _staging_pool.reset_peak()
        base, misses = _staging_pool.outstanding_bytes, _staging_pool.misses
        with _env(**env):
            _sync()
            t0 = time.perf_counter()
            Snapshot.take(path, app)
            dt = time.perf_counter() - t0
        sub = gov.elections.get(("sub_chunk.write", "FSStoragePlugin"), (None, ""))[0]
        return dt, counts["entries_streamed"] - streamed, _staging_pool.peak_bytes - base, {
            k: native_io.opened[k] - opened.get(k, 0) for k in native_io.opened}, sub, \
            _staging_pool.misses - misses

    # The buffered base: teaches the governor a write rate (a cold pool) and,
    # restored, a read rate; every later take must record its checksums.
    base_path = f"{root}/stream_base"
    cold = take(base_path, {"TORCHSNAPSHOT_GPU_STREAM_WRITES": "0"})
    base_sums = _chunk_checksums(base_path)
    if len(base_sums) != 2 * len(STREAM_NAMES) or not all(c and c.startswith("crc32c:") for c in base_sums.values()):
        raise AssertionError(f"the base take recorded {base_sums}")
    first = restore(base_path, {"TORCHSNAPSHOT_GPU_STREAM_READS": "never"})
    log(f"[stream] {nbytes / 2**30:.3f} GiB in {len(state)} CUDA tensors of {STREAM_SHAPE} f32, "
        f"{len(base_sums)} payloads of 512 MiB; first (cold pool, buffered) take "
        f"{_gbps(nbytes, cold[0])} ({cold[0]:.3f} s), buffered restore {_gbps(nbytes, first[0])}; "
        f"the governor measured {gov.measured_rates()} on {card}")

    sub_env = str(STREAM_PINNED_SUB_CHUNK)
    takes = {
        "governor's election": {},
        f"SUB_CHUNK_BYTES={sub_env}, NATIVE_IO=always": {
            "TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES": sub_env, "TORCHSNAPSHOT_GPU_NATIVE_IO": "always"},
        f"SUB_CHUNK_BYTES={sub_env}, NATIVE_IO=never": {
            "TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES": sub_env, "TORCHSNAPSHOT_GPU_NATIVE_IO": "never"},
        "STREAM_WRITES=0 (buffered)": {"TORCHSNAPSHOT_GPU_STREAM_WRITES": "0"},
    }
    restores = {
        "STREAM_READS=always, NATIVE_IO=never": {
            "TORCHSNAPSHOT_GPU_STREAM_READS": "always", "TORCHSNAPSHOT_GPU_NATIVE_IO": "never"},
        "STREAM_READS=always, NATIVE_IO=always": {
            "TORCHSNAPSHOT_GPU_STREAM_READS": "always", "TORCHSNAPSHOT_GPU_NATIVE_IO": "always"},
        "STREAM_READS=never (buffered)": {"TORCHSNAPSHOT_GPU_STREAM_READS": "never"},
    }
    take_rows = {k: [] for k in takes}
    restore_rows = {k: [] for k in restores}
    for r in range(STREAM_ROUNDS):
        order = list(takes) if r % 2 == 0 else list(reversed(list(takes)))
        for kind in order:
            path = f"{root}/stream_take"
            row = take(path, takes[kind])
            if _chunk_checksums(path) != base_sums:
                raise AssertionError(f"the take ({kind}) recorded other checksums than the buffered base")
            shutil.rmtree(path)
            take_rows[kind].append(row)
        order = list(restores) if r % 2 == 0 else list(reversed(list(restores)))
        for kind in order:
            restore_rows[kind].append(restore(base_path, restores[kind]))
    for kind, rows in take_rows.items():
        log(f"[stream] sync take, {kind}, {STREAM_ROUNDS} rounds in turns: "
            f"{_median_range([nbytes / row[0] / 1e9 for row in rows])} GB/s "
            f"({', '.join(f'{row[0]:.3f}' for row in rows)} s); entries streamed "
            f"{[row[1] for row in rows]}; sub-chunk elected {[row[4] for row in rows]} B; "
            f"staging pool peak {[row[2] for row in rows]} B, slabs allocated "
            f"{[row[5] for row in rows]}; engines opened {[row[3] for row in rows]}; on {card}")
    for kind, rows in restore_rows.items():
        log(f"[stream] restore, {kind}, bit-exact, {STREAM_ROUNDS} rounds in turns: "
            f"{_median_range([nbytes / row[0] / 1e9 for row in rows])} GB/s "
            f"({', '.join(f'{row[0]:.3f}' for row in rows)} s); entries streamed "
            f"{[row[1] for row in rows]}; read sub-chunk elected "
            f"{gov.elections.get(('sub_chunk.read', 'FSStoragePlugin'), (None,))[0]} B; staging "
            f"pool peak {[row[2] for row in rows]} B, slabs allocated {[row[5] for row in rows]}; "
            f"engines opened {[row[3] for row in rows]}; on {card}")
    log(f"[stream] governor rates after the runs: {gov.measured_rates()}")
    pinned = take_rows[f"SUB_CHUNK_BYTES={sub_env}, NATIVE_IO=always"]
    if any(row[1] < 1 for row in pinned + take_rows[f"SUB_CHUNK_BYTES={sub_env}, NATIVE_IO=never"]):
        raise AssertionError("a take with a pinned 64 MiB sub-chunk streamed no entry")
    if any(row[1] for row in take_rows["STREAM_WRITES=0 (buffered)"] + restore_rows["STREAM_READS=never (buffered)"]):
        raise AssertionError("a buffered run streamed")
    if any(row[1] != len(base_sums) for kind in restores if "always" in kind for row in restore_rows[kind]):
        raise AssertionError("a restore with STREAM_READS=always did not stream every entry")
    if probe == 0 and (
        any(not row[3].get("uring") for row in pinned)
        or any(not row[3].get("uring") for row in restore_rows["STREAM_READS=always, NATIVE_IO=always"])
    ):
        raise AssertionError("io_uring probed fine, but a NATIVE_IO=always run opened no uring engine")

    # async_take never streams: its consistency point is the end of staging.
    before = dict(counts)
    t0 = time.perf_counter()
    pending = Snapshot.async_take(f"{root}/stream_async", app)
    stall = time.perf_counter() - t0
    pending.wait()
    if dict(counts) != before or _chunk_checksums(f"{root}/stream_async") != base_sums:
        raise AssertionError("async_take streamed, or recorded other checksums")
    shutil.rmtree(f"{root}/stream_async")
    log(f"[stream] async_take of the state streamed nothing (returned after {stall:.3f} s)")

    # One corrupted sub-chunk, the first read (one entry in flight, so no
    # other entry commits first): the restore raises and leaves every
    # destination tensor as it was.
    sites = [("fs.pread", "never")] + ([("fs.native_pread", "always")] if probe == 0 else [])
    for site, native in sites:
        for t in dst.values():
            t.fill_(7.0)
        faultinject.configure(f"{site}@1=corrupt")
        try:
            with _env(TORCHSNAPSHOT_GPU_STREAM_READS="always", TORCHSNAPSHOT_GPU_NATIVE_IO=native,
                      TORCHSNAPSHOT_GPU_IO_CONCURRENCY="1"):
                Snapshot(base_path).restore({"embedding": StateDict(dst)})
            raise AssertionError(f"a sub-chunk corrupted at {site} was restored")
        except IntegrityError as e:
            hits = faultinject.hits().get(site, 0)
            message = str(e)[:80]
        finally:
            faultinject.disable()
        _sync()
        if not all(bool((t == 7.0).all()) for t in dst.values()):
            raise AssertionError(f"a restore that raised on a corrupted sub-chunk ({site}) changed dst")
        log(f"[stream] a sub-chunk corrupted at {site} ({hits} hits): the restore raised "
            f"IntegrityError ({message}...) and left every destination tensor as it was")
    shutil.rmtree(base_path)

    # The hash-rate probe (K4) in a restore with device digests from the
    # environment, once the governor knows a read rate.
    one = {"embedding": StateDict(master=state["master"])}
    digest_path = f"{root}/stream_digest"
    Snapshot.take(digest_path, one, device_digests=True)
    dd._hash_probe_done = False
    gov = sched.reset_io_governor()
    Snapshot(digest_path).restore({"embedding": StateDict(master=dst["master"])})
    probe_launches = []
    real_probe = dd.probe_hash_throughput

    def counted_probe(*args, **kwargs):
        n = dd.fingerprint_lanes.launches
        out = real_probe(*args, **kwargs)
        probe_launches.append(dd.fingerprint_lanes.launches - n)
        return out

    dd.probe_hash_throughput = counted_probe
    try:
        dst["master"].zero_()
        with _env(TORCHSNAPSHOT_GPU_DEVICE_DIGESTS="1"):
            dd.fingerprint_lanes.launches = 0
            Snapshot(digest_path).restore({"embedding": StateDict(master=dst["master"])})
            _sync()
            launches = dd.fingerprint_lanes.launches
    finally:
        dd.probe_hash_throughput = real_probe
    shutil.rmtree(digest_path)
    if not torch.equal(dst["master"], state["master"]):
        raise AssertionError("the restore with device digests from the environment was not bit-exact")
    if len(probe_launches) != 1 or gov.hash_bps() is None or (
        DEVICE == "cuda" and probe_launches[0] != 2
    ):
        raise AssertionError(f"expected one hash probe of 2 K4 launches, got {probe_launches}")
    verify = gov.elections.get(("preverify", "FSStoragePlugin"), (None,))[0]
    log(f"[stream] a restore with TORCHSNAPSHOT_GPU_DEVICE_DIGESTS=1 after a read rate was known: "
        f"the hash probe ran once, {probe_launches[0]} K4 launches; hash rate "
        f"{gov.hash_bps():.6g} B/s against read {gov.read_bps('FSStoragePlugin'):.6g} B/s, preverify "
        f"{verify}; K4 launches in that restore {launches}; bit-exact; on {card}")
    return {"stream: hash-rate probe in a restore": probe_launches[0],
            "stream: preverify fingerprints of that restore": launches - probe_launches[0]}


def _flat(state) -> dict:
    """{logical path: tensor} of a train state, as a snapshot names it."""
    from torchsnapshot_tpu_torch.flatten import flatten

    return flatten(state)[1]


def _launch_counts() -> dict:
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    return {f.__name__: f.launches for f in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)}


def _reset_launch_counts() -> None:
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0


def phase_train(cfg) -> dict:
    """TRAIN_STEPS steps of ``train_entry()``; returns each kernel's
    launches over them."""
    from torchsnapshot_tpu_torch.entry import train_entry
    from torchsnapshot_tpu_torch.models import transformer as T

    train_step, (state, batch) = train_entry(device=DEVICE, seed=0)
    # Step 1's loss and gradients, flash (auto) against dense attention.
    loss_f, grads_f = T.loss_and_grads(state["params"], batch, cfg)
    loss_d, grads_d = T.loss_and_grads(
        state["params"], batch, dataclasses.replace(cfg, attn_impl="dense")
    )
    dl = abs(loss_f.item() - loss_d.item())
    refs = _flat(grads_d)
    rel = {p: ((g - refs[p]).norm() / refs[p].norm()).item() for p, g in _flat(grads_f).items()}
    worst_path = max(rel, key=lambda p: rel[p] if math.isfinite(rel[p]) else math.inf)
    worst = rel[worst_path]
    log(f"[train] step 1 flash vs dense: loss {loss_f.item():.6f} vs {loss_d.item():.6f} "
        f"(|diff| {dl:.3g}, bar {TRAIN_LOSS_ATOL:.4g}); worst gradient rel L2 {worst:.3g} "
        f"at {worst_path} (bar {TRAIN_GRAD_REL_L2})")
    if not (dl <= TRAIN_LOSS_ATOL and worst <= TRAIN_GRAD_REL_L2):
        raise AssertionError("flash and dense attention disagree on step 1's loss or gradients")

    _reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [train_step(state, batch)[1] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    losses = [x.item() for x in losses]
    with torch.no_grad():
        final = T.loss_fn(state["params"], batch, cfg).item()
    log(f"[train] {TRAIN_STEPS} steps of (4, 256) tokens in {wall * 1e3:.1f} ms; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; after step {TRAIN_STEPS}: {final:.4f}; "
        f"launches {launches}")
    want = TRAIN_STEPS * cfg.n_layers
    if any(n != want for n in launches.values()):
        raise AssertionError(f"expected {want} launches of each flash kernel, got {launches}")
    if not all(map(math.isfinite, losses + [final])) or not final < losses[0]:
        raise AssertionError("the training loss is not finite or did not fall")
    if int(state["step"]) != TRAIN_STEPS or int(state["opt_state"][0].count) != TRAIN_STEPS:
        raise AssertionError("step or optimizer count did not advance once per step")
    return launches


def phase_train_checkpoint(root: str) -> None:
    """A resume from a train-state snapshot is bit-identical; async_take
    holds the values from before an in-place step that follows at once."""
    from torchsnapshot_tpu_torch import RNGState, Snapshot, StateDict
    from torchsnapshot_tpu_torch.entry import train_entry
    from torchsnapshot_tpu_torch.models import transformer as T

    def clone(state) -> dict:
        return {p: t.clone() for p, t in _flat(state).items()}

    def same(state, want: dict) -> bool:
        got = _flat(state)
        return got.keys() == want.keys() and all(torch.equal(got[p], want[p]) for p in want)

    torch.use_deterministic_algorithms(True)
    try:
        train_step, (state, batch) = train_entry(device=DEVICE, seed=0)
        for _ in range(2):
            train_step(state, batch)
        Snapshot.take(f"{root}/train", {"train": StateDict(state), "rng": RNGState()})
        saved = clone(state)
        _, loss3 = train_step(state, batch)
        after3 = clone(state)

        _, (fresh, _) = train_entry(device=DEVICE, seed=1)
        holder = StateDict(fresh)
        Snapshot(f"{root}/train").restore({"train": holder, "rng": RNGState()})
        restored = dict(holder)
        if not same(restored, saved):
            raise AssertionError("the restored train state is not bit-exact")
        if not isinstance(restored["opt_state"][0], T.ScaleByAdamState):
            raise AssertionError("the restored optimizer state lost its namedtuple class")
        if int(restored["step"]) != 2 or int(restored["opt_state"][0].count) != 2:
            raise AssertionError("restored step or count is not 2")
        _, loss3_again = train_step(restored, batch)
        if not torch.equal(loss3_again, loss3) or not same(restored, after3):
            raise AssertionError("step 3 after the restore is not bit-identical to step 3")
        log(f"[train checkpoint] take after step 2, restore into seed 1's state: "
            f"{len(saved)} leaves bit-exact (step 2, count 2); step 3 again: loss "
            f"{loss3.item():.6f} and every leaf bit-identical")

        before = clone(state)
        pending = Snapshot.async_take(f"{root}/train_async", {"train": StateDict(state)})
        train_step(state, batch)  # in place, as soon as async_take returns
        pending.wait()
        if same(state, before):
            raise AssertionError("the step after async_take changed nothing")
        _, (fresh, _) = train_entry(device=DEVICE, seed=1)
        holder = StateDict(fresh)
        Snapshot(f"{root}/train_async").restore({"train": holder})
        if not same(dict(holder), before):
            raise AssertionError("async_take captured a value written by the step after it")
        log("[train checkpoint] async_take, an in-place step at once, restore: the "
            "values from before that step are back")
    finally:
        torch.use_deterministic_algorithms(False)


def _bound(nbytes: int, flops: int):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def phase_timing(max_err: dict, card: str) -> list:
    """Phase 8 (see the module docstring). Returns K1-K3's entries of the
    kernels line; ``with_launches`` adds their launch counts."""
    import torch.nn.functional as F

    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    B, H, S, D = 4, 8, 256, 64
    q, k, v, dO = _qkv((B * H, S, D), torch.bfloat16, seed=3, n=4)
    q4, k4, v4, dO4 = (t.reshape(B, H, S, D) for t in (q, k, v, dO))
    o, lse = fa.flash_fwd_cuda(q, k, v, causal=True)
    delta = (dO.float() * o.float()).sum(-1)
    bwd_args = (q, k, v, dO, lse, delta)
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
    # SDPA's forward on the stream the CUDA graphs capture on: its
    # backward runs on the forward's stream, so only there is it captured.
    capture = torch.cuda.Stream()
    capture.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(capture):
        o_sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    torch.cuda.current_stream().wait_stream(capture)
    calls = {
        "flash_fwd": lambda: fa.flash_fwd_cuda(q, k, v, causal=True),
        "flash_fwd_plain": lambda: fa.flash_fwd_reference(q, k, v, causal=True),
        "flash_fwd_library": lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(*bwd_args, causal=True),
        "flash_bwd_dq_plain": lambda: fa.flash_bwd_dq_reference(*bwd_args, causal=True),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(*bwd_args, causal=True),
        "flash_bwd_dkv_plain": lambda: fa.flash_bwd_dkv_reference(*bwd_args, causal=True),
        # SDPA's backward alone, dq, dk and dv in one call: the library
        # yardstick of both backward kernels.
        "flash_bwd_library": lambda: torch.autograd.grad(
            o_sdpa, (qg, kg, vg), dO4, retain_graph=True
        ),
    }
    # Least work: each input read once, each output written once; the
    # causal dots over the S(S+1)/2 attended pairs of each head, 2*D flop
    # per pair each: 2 (q.k, p.v) forward, 3 (q.k, dO.v, ds.k) for dq and
    # 4 (q.k, dO.v, p.dO, ds.q) for dk/dv.
    elt = q.element_size()
    operand = B * H * S * D * elt
    row = B * H * S * 4
    pairs = B * H * (S * (S + 1) // 2)
    work = {
        "flash_fwd": (4 * operand + row, 2 * 2 * D * pairs),
        "flash_bwd_dq": (5 * operand + 2 * row, 3 * 2 * D * pairs),
        "flash_bwd_dkv": (6 * operand + 2 * row, 4 * 2 * D * pairs),
    }
    library = {"flash_fwd": "flash_fwd_library", "flash_bwd_dq": "flash_bwd_library",
               "flash_bwd_dkv": "flash_bwd_library"}
    # Every call computes its kernel's function (SDPA's backward both
    # backward kernels'), so no time of any of them can be under the
    # kernel's bound: a reading under it is invalid.
    floors = {}
    for name, (nbytes, flops) in work.items():
        for key in (name, name + "_plain"):
            floors[key] = _bound(nbytes, flops)[0]
    floors["flash_fwd_library"] = floors["flash_fwd"]
    floors["flash_bwd_library"] = _bound(*(a + b for a, b in zip(work["flash_bwd_dq"],
                                                                  work["flash_bwd_dkv"])))[0]
    clocks = {"before": sm_clocks()}
    # Per-call time with the host included (CUDA events around 100 calls
    # back to back: a call whose host path outlasts its kernel reads as
    # host time), the device time of one call from the profiler, and the
    # device time from CUDA events around a CUDA graph of 100 calls.
    ms, spread = time_in_turns(calls, iters=100)
    timers = len(DEVICE_TIMERS)
    dev, dev_spread = time_in_turns(calls, iters=20, rounds=3, timer=device_time_ms,
                                    floors=floors)
    device_timer = device_timer_since(timers)
    graph = graph_times(calls, stream=capture)
    clocks["after"] = sm_clocks()
    log(f"[timing] SM clock, max SM clock, power draw: before {clocks['before']}; after "
        f"{clocks['after']}")
    for key in calls:
        cross_check(key, dev[key], graph[key], clocks)
    sources = {"flash_fwd": ("flash_fwd.cu", 44), "flash_bwd_dq": ("flash_bwd.cu", 94),
               "flash_bwd_dkv": ("flash_bwd.cu", 146)}
    out = []
    for name, (nbytes, flops) in work.items():
        bound_ms, bound_by = _bound(nbytes, flops)
        lib = library[name]

        def us(key, t=ms, r=spread):
            return f"{t[key] * 1e3:.2f} us ({r[key][0] * 1e3:.2f}-{r[key][1] * 1e3:.2f})"

        def dus(key):
            if dev[key] is None:
                return "invalid (every round under the bound)"
            return us(key, dev, dev_spread)

        log(f"[timing] {name} (BH={B * H}, S={S}, D={D}, bf16, causal), bound "
            f"{bound_ms * 1e3:.3f} us by {bound_by} ({nbytes} B, {flops} flop); device time "
            f"of one call, median of 3 profiled rounds x 20 (range): kernel {dus(name)}, "
            f"plain {dus(name + '_plain')}, library {dus(lib)}; CUDA graph of "
            f"{GRAPH_CALLS} calls, median of {GRAPH_REPLAYS} replays: kernel "
            f"{_us(graph[name])}, plain {_us(graph[name + '_plain'])}, library "
            f"{_us(graph[lib])}; per-call time with the host, "
            f"median of 5 rounds x 100 (range): kernel {us(name)}, plain "
            f"{us(name + '_plain')}, library {us(lib)}; on {card}")
        src, line = sources[name]
        out.append({
            "name": name,
            "route": "cuda",
            "source": f"torchsnapshot_tpu_torch/csrc/{src}",
            "replaces": f"torchsnapshot_tpu/ops/pallas_attention.py:{line}",
            "max_abs_err": max_err[name],
            "ms": ms[name],
            "plain_ms": ms[name + "_plain"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": ms[lib],
            "device_ms": dev[name],
            "plain_device_ms": dev[name + "_plain"],
            "library_device_ms": dev[lib],
            "device_timer": device_timer,
            "graph_ms": graph[name],
            "plain_graph_ms": graph[name + "_plain"],
            "library_graph_ms": graph[lib],
            "sm_clock": clocks,
        })
        if lib == "flash_bwd_library":
            # One SDPA backward does the work of both backward kernels:
            # compare library_ms with the sum of their ms.
            out[-1]["library_covers"] = ["flash_bwd_dq", "flash_bwd_dkv"]
    return out


def with_launches(kernel: dict, launches: dict) -> dict:
    """``kernel`` with its launch count on the main path, summed over the
    paths of ``launches`` ({path: {kernel name: launches}}), after its
    ``replaces`` key."""
    out = {}
    for key, value in kernel.items():
        out[key] = value
        if key == "replaces":
            out["launches"] = sum(counts[kernel["name"]] for counts in launches.values())
            out["launches_by_path"] = {path: counts[kernel["name"]]
                                       for path, counts in launches.items()}
    return out


def _trace(label: str, fn) -> None:
    """Wall time, device busy time and idle share of one traced call of
    ``fn``, and its largest device kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_events(prof)
    busy_us = sum(t for _, t, _ in kernels)
    if busy_us <= 0:
        log(f"[profile] traced {label}: device time not measured (the profiler recorded none)")
        return
    log(f"[profile] traced {label}: wall {wall_us:.0f} us, device busy {busy_us:.0f} us, "
        f"idle share {1 - busy_us / wall_us:.3f}, {sum(c for _, _, c in kernels)} kernels")
    for name, t, count in sorted(kernels, key=lambda k: -k[1])[:8]:
        log(f"[profile]   {t:9.1f} us  x{count:<3d} {name[:90]}")
    for name, t, count in kernels:
        kernel = re.search(r"flash_(fwd|bwd)_\w*kernel", name)
        if kernel:
            log(f"[profile]   the port's {kernel.group(0)}: {t:.1f} us over {count} launches, "
                f"{t / busy_us:.3f} of device busy time")


def _sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _digest_input(name: str, numel: int, gen) -> torch.Tensor:
    dtype = getattr(torch, name)
    raw = torch.randint(0, 256, (numel * dtype.itemsize,), generator=gen, device=DEVICE,
                        dtype=torch.uint8)
    return (raw[:numel] % 2).bool() if dtype == torch.bool else raw.view(dtype)


def phase_digest(instructions_per_word: float, clock_mhz: float, card: str):
    """K4 against its plain version on the card, and its times. Returns the
    worst lane difference and the kernels-line numbers."""
    from torchsnapshot_tpu_torch import device_digest as dd
    from torchsnapshot_tpu_torch.entry import train_entry

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    worst, cases = 0, 0
    names = [n for n in DIGEST_DTYPES if hasattr(torch, n)]
    for name in names:
        itemsize = getattr(torch, name).itemsize
        for numel in DIGEST_SIZES + (DIGEST_LEAF_BYTES // itemsize,):
            t = _digest_input(name, numel, gen)
            views = [t, t[1:]] if numel > 1 else [t]  # t[1:]: an unaligned start
            for v in views:
                kernel = dd._fetch([dd.fingerprint_lanes(v)])[0]
                plain = dd.lanes_reference(v)
                worst = max(worst, *(abs(a - b) for a, b in zip(kernel, plain)))
                nbytes = v.numel() * v.element_size()
                if dd._fold_lanes(kernel, nbytes) != dd._fold_lanes(plain, nbytes):
                    raise AssertionError(
                        f"K4 disagrees with its plain version: {name} x {v.numel()} "
                        f"(kernel lanes {kernel}, plain {plain})")
                cases += 1
    log(f"[digest] K4 vs plain, {len(names)} dtypes ({', '.join(names)}) x {DIGEST_SIZES} "
        f"elements and {DIGEST_LEAF_BYTES} B, aligned and unaligned: {cases} cases, digest "
        f"strings identical (max lane difference {worst})")
    for name in ("float32", "bfloat16", "int64", "bool"):
        piece = _digest_input(name, 24 * 40 * 33, gen).reshape(24, 40, 33)
        full = dd.device_fingerprint(piece)
        groups = []
        for r0, r1 in ((0, 9), (9, 24)):
            for c0, c1 in ((0, 17), (17, 40)):
                region = piece[r0:r1, c0:c1]
                lanes = dd.partial_fetch(dd.partial_dispatch(region, piece.shape, (r0, c0, 0)))
                if lanes != dd.lanes_reference(region.contiguous(), (r0, c0, 0), piece.shape):
                    raise AssertionError(f"K4's partial lanes disagree with the plain version ({name})")
                groups.append(lanes)
        if dd.combine_partials(groups, piece.numel() * piece.element_size()) != full:
            raise AssertionError(f"K4's partial lanes over 4 regions do not add up ({name})")
    log("[digest] partial form: a (24, 40, 33) piece cut into 4 regions, f32, bf16, int64 "
        "and bool: each region's lanes equal the plain version's, their wrapping sum is "
        "the full fingerprint")
    leaf = _digest_input("float32", DIGEST_LEAF_BYTES // 4, gen)
    first, second = dd.fingerprint_lanes(leaf), dd.fingerprint_lanes(leaf)
    _sync()
    if not torch.equal(first, second):
        raise AssertionError("two launches of K4 on the same 16 MiB give different lanes")
    log("[digest] two launches on the same 16 MiB leaf: bit-identical lanes")

    _, (state, _) = train_entry(device=DEVICE, seed=0)
    leaves = list(_flat(state).values())
    state_bytes = sum(t.numel() * t.element_size() for t in leaves)
    calls = {
        "digest": lambda: dd.fingerprint_lanes(leaf),
        "digest_plain": lambda: dd.lanes_reference(leaf),
        "digest_state": lambda: dd._fetch([dd._dispatch(t) for t in leaves]),
    }
    int_ops_per_s = DISPATCH_LANES_PER_CLOCK * clock_mhz * 1e6

    def bound(nbytes: int):
        words = nbytes // 4  # every leaf here is 4-byte: one word an element
        ops_ms = words * instructions_per_word / int_ops_per_s * 1e3
        bytes_ms = (nbytes + 16) / HBM_BYTES_PER_S * 1e3
        return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", words

    leaf_bound, leaf_by, leaf_words = bound(DIGEST_LEAF_BYTES)
    state_bound, state_by, state_words = bound(state_bytes)
    floors = {"digest": leaf_bound, "digest_plain": leaf_bound, "digest_state": state_bound}
    clocks = {"before": sm_clocks()}
    ms, spread = time_in_turns(calls, iters=20)
    timers = len(DEVICE_TIMERS)
    dev, dev_spread = time_in_turns(calls, iters=10, rounds=3, timer=device_time_ms,
                                    floors=floors)
    device_timer = device_timer_since(timers)
    # The plain version and the state's dispatch read their lanes on the
    # host, which a CUDA graph cannot hold: only the kernel is captured.
    graph = graph_times({"digest": calls["digest"]})
    clocks["after"] = sm_clocks()
    log(f"[digest] SM clock, max SM clock, power draw: before {clocks['before']}; after "
        f"{clocks['after']}")
    cross_check("digest", dev["digest"], graph["digest"], clocks)

    def us(key, t, r):
        if t[key] is None:
            return "invalid (every round under the bound)"
        return f"{t[key] * 1e3:.2f} us ({r[key][0] * 1e3:.2f}-{r[key][1] * 1e3:.2f})"

    log(f"[digest] one 16,777,216-byte f32 leaf: bound {leaf_bound * 1e3:.3f} us by {leaf_by} "
        f"({leaf_words} words x {instructions_per_word:.2f} instructions at "
        f"{int_ops_per_s / 1e12:.2f} T/s, {clock_mhz:.0f} MHz; bytes alone "
        f"{(DIGEST_LEAF_BYTES + 16) / HBM_BYTES_PER_S * 1e6:.3f} us); device time of one call, "
        f"median of 3 profiled rounds x 10 (range): K4 {us('digest', dev, dev_spread)}, plain "
        f"{us('digest_plain', dev, dev_spread)}; CUDA graph of {GRAPH_CALLS} calls, median of "
        f"{GRAPH_REPLAYS} replays: K4 {_us(graph['digest'])}; per-call time with the host, "
        f"median of 5 "
        f"rounds x 20: K4 {us('digest', ms, spread)}, plain {us('digest_plain', ms, spread)}; "
        f"on {card}")
    log(f"[digest] the train state, {len(leaves)} leaves, {state_bytes} B, dispatched then one "
        f"fetch: bound {state_bound * 1e3:.3f} us by {state_by}; device time "
        f"{us('digest_state', dev, dev_spread)}, with the host {us('digest_state', ms, spread)} "
        f"on {card}")
    return worst, {
        "ms": ms["digest"], "plain_ms": ms["digest_plain"], "bound_ms": leaf_bound,
        "bound_by": leaf_by, "device_ms": dev["digest"], "plain_device_ms": dev["digest_plain"],
        "state_ms": ms["digest_state"], "state_device_ms": dev["digest_state"],
        "device_timer": device_timer,
        "state_bound_ms": state_bound, "graph_ms": graph["digest"], "sm_clock": clocks,
    }


class _CheckpointSpies:
    """Counts what the checkpoint path does to the card and the disk: the
    tensors and bytes the CUDA staging copy stages, the host-to-device copies
    of restores, the payload paths and bytes written, and the payload reads
    (with the snapshot directory each read went to) and their bytes.
    Patches the port's classes while active; the counts are read and reset
    by the caller."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.staged = self.staged_bytes = self.copied_in = self.written_bytes = 0
        self.read_bytes = 0
        self.reads, self.written = [], []

    def __enter__(self):
        from torchsnapshot_tpu_torch.io_preparers.array import ArrayBufferConsumer, ArrayBufferStager
        from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

        spies = self
        stage_name = "_stage_cuda" if DEVICE == "cuda" else "_stage_cpu"
        stage = getattr(ArrayBufferStager, stage_name)
        copy_in, write, read = (ArrayBufferConsumer._copy_to_cuda, FSStoragePlugin.write,
                                FSStoragePlugin.read)

        async def stage_cuda(self, executor):
            host = await stage(self, executor)
            spies.staged += 1
            spies.staged_bytes += host.numel()
            return host

        def stage_cpu(self):
            host = stage(self)
            spies.staged += 1
            spies.staged_bytes += host.numel()
            return host

        async def copy_to_cuda(self, src, executor):
            spies.copied_in += 1
            return await copy_in(self, src, executor)

        # The commit protocol's files (the metadata and the commit fence)
        # are not payload.
        protocol = (".snapshot_metadata", ".snapshot_fence")

        async def fs_write(self, write_io):
            if write_io.path not in protocol:
                spies.written.append(write_io.path)
                spies.written_bytes += memoryview(write_io.buf).nbytes
            return await write(self, write_io)

        async def fs_read(self, read_io):
            if read_io.path not in protocol:
                spies.reads.append((os.path.realpath(self.root), read_io.path))
            result = await read(self, read_io)
            if read_io.path not in protocol:
                spies.read_bytes += memoryview(read_io.buf).nbytes
            return result

        # The streamed paths (phase 13) count the same way: a streamed
        # entry is staged, written, read and copied in like a buffered one.
        stage_stream, consume_stream = ArrayBufferStager.stage_stream, ArrayBufferConsumer.consume_stream
        write_stream, read_stream = FSStoragePlugin.write_stream, FSStoragePlugin.read_stream

        async def staged_stream(self, executor, sub_chunk_bytes):
            spies.staged += 1
            async for chunk in stage_stream(self, executor, sub_chunk_bytes):
                spies.staged_bytes += memoryview(chunk).nbytes
                yield chunk

        async def consumed_stream(self, stream, executor=None):
            spies.copied_in += int(self.stream is not None)
            return await consume_stream(self, stream, executor)

        async def fs_write_stream(self, stream):
            spies.written.append(stream.path)
            spies.written_bytes += stream.nbytes
            return await write_stream(self, stream)

        async def fs_read_stream(self, read_io, sub_chunk_bytes):
            spies.reads.append((os.path.realpath(self.root), read_io.path))
            stream = await read_stream(self, read_io, sub_chunk_bytes)
            spies.read_bytes += stream.nbytes
            return stream

        self._saved = [(ArrayBufferStager, stage_name, stage),
                       (ArrayBufferConsumer, "_copy_to_cuda", copy_in),
                       (FSStoragePlugin, "write", write), (FSStoragePlugin, "read", read),
                       (ArrayBufferStager, "stage_stream", stage_stream),
                       (ArrayBufferConsumer, "consume_stream", consume_stream),
                       (FSStoragePlugin, "write_stream", write_stream),
                       (FSStoragePlugin, "read_stream", read_stream)]
        setattr(ArrayBufferStager, stage_name, stage_cuda if DEVICE == "cuda" else stage_cpu)
        ArrayBufferConsumer._copy_to_cuda = copy_to_cuda
        FSStoragePlugin.write, FSStoragePlugin.read = fs_write, fs_read
        ArrayBufferStager.stage_stream = staged_stream
        ArrayBufferConsumer.consume_stream = consumed_stream
        FSStoragePlugin.write_stream, FSStoragePlugin.read_stream = fs_write_stream, fs_read_stream
        return self

    def __exit__(self, *exc) -> None:
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)


def _digest_launches() -> int:
    from torchsnapshot_tpu_torch import device_digest as dd

    return dd.fingerprint_lanes.launches


def _origins(path: str) -> set:
    from torchsnapshot_tpu_torch import Snapshot
    from torchsnapshot_tpu_torch.retention import _entry_payloads

    return {o for e in Snapshot(path).metadata.manifest.values() for *_, o in _entry_payloads(e)}


def phase_manager(root: str, card: str) -> dict:
    """The production loop at the entry configuration: a CheckpointManager
    with cadence 2, keep_last 2, async, incremental saves with device
    digests and a preemption watcher drives train steps 0-4; an unchanged
    forced save stages and writes nothing; a simulated preemption makes an
    emergency save; retention leaves steps 4-6; the latest step restores
    bit-exact through its origins and trains on; a restore into a state that
    already holds it reads and copies nothing. Returns K4's launches by
    step of the path."""
    from torchsnapshot_tpu_torch import (CheckpointManager, PreemptionWatcher, Snapshot, StateDict,
                                         simulate_preemption_now)
    from torchsnapshot_tpu_torch.entry import train_entry

    on_card = DEVICE == "cuda"
    torch.use_deterministic_algorithms(True)
    watcher = PreemptionWatcher()
    try:
        train_step, (state, batch) = train_entry(device=DEVICE, seed=0)
        n_leaves = len(_flat(state))
        state_bytes = sum(t.numel() * t.element_size() for t in _flat(state).values())
        app = {"train": StateDict(state)}
        mgr = CheckpointManager(root, save_interval_steps=2, keep_last=2, async_save=True,
                                incremental=True, device_digests=True, preemption=watcher)
        mgr.warmup(app)  # builds K4 and launches it once per leaf, outside the count
        _sync()
        launches = {}
        with _CheckpointSpies() as spies:
            n0 = _digest_launches()
            t0 = time.perf_counter()
            for step in range(5):
                train_step(state, batch)
                mgr.save(step, app)
            mgr.wait()
            launches["steps 0-4 (saves at 0, 2, 4)"] = _digest_launches() - n0
            log(f"[manager] train steps 0-4, saves at 0, 2, 4 ({n_leaves} leaves, {state_bytes} B): "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms; committed {mgr.all_steps()}; staged "
                f"{spies.staged} tensors ({spies.staged_bytes} B), wrote {spies.written_bytes} B")

            spies.reset()
            n0 = _digest_launches()
            t0 = time.perf_counter()
            mgr.save(5, app, force=True)  # the state is unchanged since step 4's save
            blocked = time.perf_counter() - t0
            mgr.wait()
            launches["unchanged save (step 5)"] = n = _digest_launches() - n0
            step4 = os.path.realpath(mgr.path_for(4))
            log(f"[manager] forced save of the unchanged state at step 5: caller blocked "
                f"{blocked * 1e3:.1f} ms; staged {spies.staged} tensors ({spies.staged_bytes} B), "
                f"wrote {spies.written_bytes} B, K4 launches {n}; origins {sorted(_origins(mgr.path_for(5)))}")
            if spies.staged or spies.staged_bytes or spies.written_bytes:
                raise AssertionError("the save of an unchanged state staged or wrote payload")
            if _origins(mgr.path_for(5)) != {step4}:
                raise AssertionError("step 5's entries do not all point at step 4")
            if on_card and n != n_leaves:
                raise AssertionError(f"expected {n_leaves} K4 launches for the unchanged save, got {n}")

            spies.reset()
            n0 = _digest_launches()
            simulate_preemption_now()
            if not mgr.save(6, app) or not watcher.consumed or mgr._pending is not None:
                raise AssertionError("the emergency save at step 6 did not commit synchronously")
            launches["emergency save (step 6)"] = _digest_launches() - n0
            # The root also holds the takes' history (.telemetry_history.jsonl).
            names = sorted(n for n in os.listdir(root) if n.startswith("step_"))
            want = ["step_0000000004", "step_0000000005", "step_0000000006"]
            log(f"[manager] SIGTERM, then save(6): emergency save committed synchronously "
                f"(staged {spies.staged} tensors); retention with keep_last=2 leaves {names}")
            if names != want or mgr.latest_step() != 6:
                raise AssertionError(f"retention left {names}, expected {want}")

            spies.reset()
            saved = {p: t.clone() for p, t in _flat(state).items()}
            _, (fresh, _) = train_entry(device=DEVICE, seed=1)
            holder = StateDict(fresh)
            n0 = _digest_launches()
            if mgr.restore({"train": holder}) != 6:
                raise AssertionError("the manager did not restore the latest step")
            launches["restore of step 6"] = _digest_launches() - n0
            _sync()
            restored = dict(holder)
            if any(not torch.equal(_flat(restored)[p], t) for p, t in saved.items()):
                raise AssertionError("the restore of step 6 is not bit-exact")
            read_roots = {r for r, _ in spies.reads}
            log(f"[manager] restore of step 6 into seed 1's state: {n_leaves} leaves bit-exact; "
                f"{len(spies.reads)} payload reads, all from {sorted(read_roots)}; "
                f"{spies.copied_in} HtoD copies")
            if read_roots != {step4} or len(spies.reads) != n_leaves:
                raise AssertionError("the restore did not read every payload through step 4")

            spies.reset()
            n0 = _digest_launches()
            Snapshot(mgr.path_for(6)).restore({"train": StateDict(restored)}, device_digests=True)
            launches["restore into a matching state"] = n = _digest_launches() - n0
            log(f"[manager] Snapshot(step 6).restore(device_digests=True) into the state that holds "
                f"it: {len(spies.reads)} payload reads, {spies.copied_in} HtoD copies, K4 launches {n}")
            if spies.reads or spies.copied_in:
                raise AssertionError("a restore into a matching destination read or copied payload")
            if on_card and n != n_leaves:
                raise AssertionError(f"expected {n_leaves} K4 launches for the restore, got {n}")
        # The state is still the one step 6 holds: time the three takes on it.
        _time_incremental_takes(root, app, mgr.path_for(6), card)

        _, loss_a = train_step(state, batch)
        _, loss_b = train_step(restored, batch)
        _sync()
        if not torch.equal(loss_a, loss_b) or any(
            not torch.equal(_flat(restored)[p], t) for p, t in _flat(state).items()
        ):
            raise AssertionError("step 7 after the restore is not bit-identical to step 7")
        log(f"[manager] one more step on the restored state: loss {loss_b.item():.6f}, every "
            f"leaf bit-identical to the run that never stopped")
        return launches
    finally:
        watcher.close()
        torch.use_deterministic_algorithms(False)


def _time_incremental_takes(root: str, app: dict, base: str, card: str) -> None:
    """Three takes of an unchanged state, in turns: incremental with device
    digests, incremental with host digests (SHA-256 after the DtoH copy),
    and a full take. For each: the time async_take holds the caller, the
    time to commit, the bytes staged and the bytes written."""
    from torchsnapshot_tpu_torch import Snapshot

    kinds = {
        "device digests": dict(incremental_base=base, device_digests=True),
        "host digests": dict(incremental_base=base, record_digests=True, device_digests=False),
        "full take": dict(device_digests=False),
    }
    samples = {k: [] for k in kinds}
    with _CheckpointSpies() as spies:
        for r in range(MANAGER_TAKE_ROUNDS):
            order = list(kinds) if r % 2 == 0 else list(reversed(list(kinds)))
            for kind in order:
                path = f"{root}/takes/{kind.replace(' ', '_')}_{r}"
                _sync()
                spies.reset()
                t0 = time.perf_counter()
                pending = Snapshot.async_take(path, app, **kinds[kind])
                blocked = time.perf_counter() - t0
                pending.wait()
                total = time.perf_counter() - t0
                samples[kind].append((blocked, total, spies.staged_bytes, spies.written_bytes))
                shutil.rmtree(path, ignore_errors=True)
    for kind, rows in samples.items():
        blocked = [b for b, *_ in rows]
        total = [t for _, t, *_ in rows]
        log(f"[manager] async_take of the unchanged state, {kind}, median of {len(rows)} rounds in "
            f"turns (range): caller blocked {statistics.median(blocked) * 1e3:.1f} ms "
            f"({min(blocked) * 1e3:.1f}-{max(blocked) * 1e3:.1f}), committed "
            f"{statistics.median(total) * 1e3:.1f} ms ({min(total) * 1e3:.1f}-{max(total) * 1e3:.1f}); "
            f"staged {rows[0][2]} B, wrote {rows[0][3]} B; on {card}")


# ----------------------------------------------------------------- phase 14


class _RoutingReplay:
    """Holds the MoE routing fixed between two forwards: in ``record`` mode
    each ``_top2_route`` call's expert ids are kept; in ``replay`` mode the
    next forward's calls take them in order (the gates renormalized from
    that forward's own router probabilities at those experts), and each
    token whose own routing would differ is counted as flipped."""

    def __init__(self) -> None:
        from torchsnapshot_tpu_torch.ops import moe as PM

        self.PM, self.real = PM, PM._top2_route
        self.recorded, self.flipped, self.mode = [], [], "record"

    def __enter__(self):
        self.PM._top2_route = self._route
        return self

    def __exit__(self, *exc) -> None:
        self.PM._top2_route = self.real

    def replay(self) -> None:
        self.mode, self.flipped = "replay", []

    def _route(self, x2, router):
        e1, e2, g1, g2, probs = self.real(x2, router)
        if self.mode == "record":
            self.recorded.append((e1, e2))
            return e1, e2, g1, g2, probs
        f1, f2 = self.recorded[len(self.flipped)]
        self.flipped.append((e1 != f1) | (e2 != f2))
        p1, p2 = probs.gather(1, f1[:, None])[:, 0], probs.gather(1, f2[:, None])[:, 0]
        denom = p1 + p2 + 1e-9
        return f1, f2, p1 / denom, p2 / denom, probs

    def tokens_flipped(self) -> torch.Tensor:
        """(T,) True where any layer's own routing differed."""
        return torch.stack(self.flipped).any(dim=0)


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm())


def _on_cpu(params, dtype=None):
    from torchsnapshot_tpu_torch.models import transformer as T

    cpu = T.params_from_numpy(T.params_to_numpy(params), device="cpu")
    if dtype is None:
        return cpu

    def cast(tree):
        return {k: cast(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(dtype)

    return cast(cpu)


def _f64_config(cfg):
    """``cfg`` computing in f64 where it names a compute dtype."""
    fields = {f.name for f in dataclasses.fields(cfg)}
    return dataclasses.replace(cfg, **{k: torch.float64 for k in ("dtype", "param_dtype")
                                       if k in fields})


def _ssm_layer_check(workload) -> None:
    """Layer 0's SSM mix on the card against the CPU on the model's
    embedded tokens: relative L2 within WORKLOAD_REL_L2 (one layer is well
    conditioned)."""
    from torchsnapshot_tpu_torch.ops.ssm import ssm_mix

    cfg, state, _, batch = workload
    layer = {k: v[0] for k, v in state["params"]["layers"]["ssm"].items()}
    x = state["params"]["embed"].index_select(0, batch["tokens"].reshape(-1))
    x = x.reshape(*batch["tokens"].shape, -1)
    with torch.inference_mode():
        y, h = ssm_mix(layer, x)
        y_cpu, h_cpu = ssm_mix({k: v.cpu() for k, v in layer.items()}, x.cpu())
    rel_y, rel_h = _rel_l2(y, y_cpu), _rel_l2(h, h_cpu)
    log(f"[workloads] SSM layer 0 mix, f32, x {tuple(x.shape)}, state {tuple(h.shape)}: on the "
        f"card against the CPU, relative L2 {rel_y:.3g} (y) and {rel_h:.3g} (h_last), bar "
        f"{WORKLOAD_REL_L2}")
    if not (rel_y <= WORKLOAD_REL_L2 and rel_h <= WORKLOAD_REL_L2):
        raise AssertionError("the SSM layer on the card disagrees with the CPU")


def _time_ms(label: str, fn, iters: int, rounds: int = 3) -> float:
    """Median ms per call (CUDA events, ``rounds`` rounds of ``iters``) and
    one traced call's idle share; on the CPU (a rehearsal) nothing."""
    if DEVICE != "cuda":
        return float("nan")
    ms, spread = time_in_turns({label: fn}, iters=iters, rounds=rounds)
    log(f"[workloads] {label}: {ms[label]:.3f} ms a call, median of {rounds} rounds x {iters} "
        f"(range {spread[label][0]:.3f}-{spread[label][1]:.3f})")
    _trace(label, fn)
    return ms[label]


def _moe_layer_check(params, tokens_shape) -> None:
    """Layer 0's MoE FFN in f32 on the card against the CPU on the same
    inputs: identical routing, outputs within MOE_LAYER_ATOL, both
    dispatches."""
    from torchsnapshot_tpu_torch.ops import moe as PM

    layer = {k: params["layers"][f"moe_{k}"][0].float() for k in ("router", "w_in", "w_out")}
    cpu_layer = {k: v.cpu() for k, v in layer.items()}
    D = layer["router"].shape[0]
    T_ = tokens_shape[0] * tokens_shape[1]
    x = torch.randn((T_, D), generator=torch.Generator().manual_seed(14))
    E = layer["router"].shape[1]
    cap = math.ceil(2 * T_ * _moe_config().moe_capacity_factor / E)
    for dispatch in ("auto", "sort"):
        y, aux = PM.moe_ffn(layer, x.to(DEVICE), dispatch=dispatch)
        y_cpu, aux_cpu = PM.moe_ffn(cpu_layer, x, dispatch=dispatch)
        routes = PM._top2_route(x.to(DEVICE), layer["router"])[:2]
        routes_cpu = PM._top2_route(x, cpu_layer["router"])[:2]
        same = all(torch.equal(a.cpu(), b) for a, b in zip(routes, routes_cpu))
        err = (y.cpu() - y_cpu).abs().max().item()
        log(f"[workloads] MoE layer 0, f32, T={T_}, E={E}, cap={cap}, T*E*cap={T_ * E * cap} "
            f"(auto = {'einsum' if T_ * E * cap <= PM._EINSUM_DISPATCH_MAX_ELEMENTS else 'sort'}), "
            f"dispatch {dispatch}: routing identical to the CPU {same}, max |y - y_cpu| "
            f"{err:.3g} (bar {MOE_LAYER_ATOL}), aux {aux.item():.6f} vs {aux_cpu.item():.6f}")
        if not same or not err <= MOE_LAYER_ATOL or abs(aux.item() - aux_cpu.item()) > 1e-6:
            raise AssertionError("the MoE layer on the card disagrees with the CPU")


def _moe_flash_against_dense(params, tokens, cfg) -> dict:
    """The bf16 MoE model with flash attention (auto) against dense
    attention, the dense forward taking the flash forward's routing; the
    bar on the tokens whose own routing agrees. Returns the launches of
    the flash forward (counts reset just before it)."""
    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.ops import moe as PM

    dense_cfg = dataclasses.replace(cfg, attn_impl="dense")
    with torch.inference_mode(), _RoutingReplay() as routing:
        _reset_launch_counts()
        logits = T.forward(params, tokens, cfg)
        _sync()
        launches = _launch_counts()
        routing.replay()
        dense = T.forward(params, tokens, dense_cfg)
        flipped = routing.tokens_flipped()
        routing.replay()
        limit = PM._EINSUM_DISPATCH_MAX_ELEMENTS
        PM._EINSUM_DISPATCH_MAX_ELEMENTS = 0  # the sort dispatch, once
        try:
            sort = T.forward(params, tokens, cfg)
        finally:
            PM._EINSUM_DISPATCH_MAX_ELEMENTS = limit
    err = (logits.float() - dense.float()).abs().reshape(-1, logits.shape[-1])
    agree = ~flipped.cpu()
    worst, mean = err[agree].max().item(), err[agree].mean().item()
    sort_err = (sort.float() - logits.float()).abs()
    log(f"[workloads] MoE forward, bf16, (4, 256) tokens: flash (auto) against dense with the "
        f"flash forward's routing: {int(flipped.sum())} of {flipped.numel()} tokens route "
        f"otherwise under dense attention (flips); on the {int(agree.sum())} that agree, max "
        f"|diff| {worst:.4g} (bar {LOGITS_MAX_ATOL}), mean {mean:.4g} (bar {LOGITS_MEAN_ATOL}); "
        f"over all tokens max {err.max().item():.4g}; sort dispatch against einsum, same routing: "
        f"max {sort_err.max().item():.4g}, mean {sort_err.mean().item():.4g}; launches {launches}")
    if not (torch.isfinite(logits).all() and worst <= LOGITS_MAX_ATOL and mean <= LOGITS_MEAN_ATOL):
        raise AssertionError("the MoE model's flash forward disagrees with dense attention")
    if not (sort_err.max().item() <= LOGITS_MAX_ATOL and sort_err.mean().item() <= LOGITS_MEAN_ATOL):
        raise AssertionError("the sort dispatch disagrees with the einsum dispatch")
    return launches


def _moe_config():
    """The entry configuration with a top-2 MoE FFN of MOE_EXPERTS experts
    (capacity factor 1.25, aux weight 0.01: the config's defaults)."""
    from torchsnapshot_tpu_torch.entry import ENTRY_CONFIG

    return dataclasses.replace(ENTRY_CONFIG, n_experts=MOE_EXPERTS, **MOE_CONFIG_KW)


def _build_workloads(seed: int):
    """The three models' train states on DEVICE, their train steps and
    batches: {name: (cfg, state, step, batch)}."""
    from torchsnapshot_tpu_torch.models import embedding as PE
    from torchsnapshot_tpu_torch.models import ssm_lm as PL
    from torchsnapshot_tpu_torch.models import transformer as T

    opt = T.make_optimizer()
    gen = torch.Generator().manual_seed(seed)
    out = {}
    moe_cfg = _moe_config()
    state = T.init_state(gen, moe_cfg, opt, DEVICE)
    batch = {n: torch.randint(0, moe_cfg.vocab_size, WORKLOAD_TOKENS, generator=gen).to(DEVICE)
             for n in ("tokens", "targets")}
    out["moe"] = (moe_cfg, state, T.make_train_step(moe_cfg, opt), batch)
    scfg = PL.SSMConfig(**SSM_CONFIG_KW)
    state = PL.init_state(gen, scfg, opt, DEVICE)
    batch = {n: torch.randint(0, scfg.vocab_size, WORKLOAD_TOKENS, generator=gen).to(DEVICE)
             for n in ("tokens", "targets")}
    out["ssm"] = (scfg, state, PL.make_train_step(scfg, opt), batch)
    ecfg = PE.EmbeddingConfig(**EMBEDDING_CONFIG_KW)
    state = PE.init_state(gen, ecfg, opt, DEVICE)
    batch = {
        "dense": torch.randn((EMBEDDING_BATCH, ecfg.n_dense_features), generator=gen),
        "sparse_ids": torch.randint(0, ecfg.rows_per_table, (EMBEDDING_BATCH, ecfg.n_tables),
                                    generator=gen),
        "labels": torch.randint(0, 2, (EMBEDDING_BATCH,), generator=gen).float(),
    }
    out["embedding"] = (ecfg, state, PE.make_train_step(ecfg, opt),
                        {k: v.to(DEVICE) for k, v in batch.items()})
    return out


def _forward(name: str, cfg, params, batch):
    from torchsnapshot_tpu_torch.models import embedding as PE
    from torchsnapshot_tpu_torch.models import ssm_lm as PL
    from torchsnapshot_tpu_torch.models import transformer as T

    with torch.inference_mode():
        if name == "moe":
            return T.forward(params, batch["tokens"], cfg)
        if name == "ssm":
            return PL.forward(params, batch["tokens"], cfg)
        return PE.forward(params, batch["dense"], batch["sparse_ids"], cfg)


def phase_workloads(root: str, card: str):
    """Phase 14 (see the module docstring). Returns (K1-K3 launches by
    path, K4 launches by path)."""
    from torchsnapshot_tpu_torch.io_preparers.array import clear_staging_pool

    on_card = DEVICE == "cuda"
    work = _build_workloads(seed=14)
    n_params = {n: sum(t.numel() for t in _flat(s["params"]).values())
                for n, (_, s, _, _) in work.items()}
    state_bytes = {n: sum(t.numel() * t.element_size() for t in _flat(s).values())
                   for n, (_, s, _, _) in work.items()}
    log(f"[workloads] parameters {n_params}; train-state bytes {state_bytes}; on {card}")

    # MoE transformer: the f32 layer against the CPU, the bf16 model flash
    # against dense, then one train step.
    cfg, state, step, batch = work["moe"]
    _moe_layer_check(state["params"], WORKLOAD_TOKENS)
    serve = _moe_flash_against_dense(state["params"], batch["tokens"], cfg)
    _reset_launch_counts()
    _, loss = step(state, batch)
    _sync()
    train = _launch_counts()
    log(f"[workloads] MoE train step 1: loss {loss.item():.5f}; launches {train}")
    if not math.isfinite(loss.item()):
        raise AssertionError("the MoE train step's loss is not finite")
    if on_card and (serve["flash_fwd"] != cfg.n_layers
                    or any(n != cfg.n_layers for n in train.values())):
        raise AssertionError(f"expected {cfg.n_layers} launches of each flash kernel: "
                             f"forward {serve}, step {train}")

    # SSM LM and embedding model: f32 logits on the card against the CPU
    # with the same weights, then one train step each.
    _ssm_layer_check(work["ssm"])
    for name in ("ssm", "embedding"):
        cfg, state, step, batch = work[name]
        got = _forward(name, cfg, state["params"], batch)
        cpu_batch = {k: v.cpu() for k, v in batch.items()}
        want = _forward(name, cfg, _on_cpu(state["params"]), cpu_batch)
        # The same forward in f64 on the CPU: how far f32 rounding alone
        # moves these logits. Random-weight SSM layers amplify it about
        # tenfold a layer, so the full-width SSM LM's f32 logits sit
        # further than WORKLOAD_REL_L2 from exact (and from the JAX
        # package's f32 logits); the bar is then that distance.
        wide = _forward(name, _f64_config(cfg), _on_cpu(state["params"], torch.float64),
                        {k: v.double() if v.is_floating_point() else v for k, v in cpu_batch.items()})
        rel, cond = _rel_l2(got, want), _rel_l2(want, wide)
        bar = max(WORKLOAD_REL_L2, cond)
        _, loss = step(state, batch)
        log(f"[workloads] {name}: logits {tuple(got.shape)} on the card against the CPU, "
            f"relative L2 {rel:.3g} (bar {bar:.3g}: the larger of {WORKLOAD_REL_L2} and the CPU's "
            f"f32 logits against its f64 ones, {cond:.3g}); train step 1 loss {loss.item():.5f}")
        if not rel <= bar or not math.isfinite(loss.item()):
            raise AssertionError(f"the {name} model on the card disagrees with the CPU")

    times = {}
    for name, (cfg, state, step, batch) in work.items():
        times[f"{name} forward"] = _time_ms(
            f"{name} forward", lambda n=name, c=cfg, s=state, b=batch: _forward(n, c, s["params"], b),
            iters=10)
        times[f"{name} train step"] = _time_ms(
            f"{name} train step", lambda s=state, f=step, b=batch: f(s, b), iters=3)
    try:
        k4 = _workload_checkpoints(root, work, card)
    finally:
        del work
        gc.collect()
        clear_staging_pool()
    return {"moe_serve": serve, "moe_train": train}, k4


def _workload_checkpoints(root: str, work: dict, card: str) -> dict:
    """The train states through CheckpointManager with device digests,
    async_restore of the MoE state under SSM forwards against a blocking
    restore, read_state_dict, a budgeted read_object into CUDA and a fenced
    take. Returns K4's launches by path."""
    from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict
    from torchsnapshot_tpu_torch.snapshot import SNAPSHOT_FENCE_FNAME, SNAPSHOT_METADATA_FNAME

    on_card = DEVICE == "cuda"
    k4 = {}
    paths = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, (_, state, _, _) in work.items():
            mgr = CheckpointManager(f"{root}/{name}", save_interval_steps=1, device_digests=True)
            n_leaves = len(_flat(state))
            before = _digest_launches()
            _sync()
            t0 = time.perf_counter()
            if not mgr.save(int(state["step"]), {"train": StateDict(state)}):
                raise AssertionError(f"the {name} manager did not save")
            mgr.wait()
            took = time.perf_counter() - t0
            key = f"workloads: the {name} train state saved with device digests"
            k4[key] = _digest_launches() - before
            paths[name] = mgr.path_for(int(state["step"]))
            log(f"[workloads] {name} train state: {n_leaves} leaves saved by CheckpointManager with "
                f"device digests in {took * 1e3:.1f} ms, {k4[key]} K4 launches")
            if on_card and k4[key] != n_leaves:
                raise AssertionError("expected one K4 launch a leaf")
            if os.path.exists(os.path.join(paths[name], SNAPSHOT_FENCE_FNAME)):
                raise AssertionError("a committed step kept its commit fence")
        saved = _async_restore_moe(paths["moe"], work, card)
        _read_state_dict_moe(paths["moe"], saved, card)
    finally:
        torch.use_deterministic_algorithms(False)
    _budgeted_read(root, card)

    # A fenced take: the fence is planted before async_take returns and
    # is gone once the commit is in.
    path = f"{root}/fenced"
    pending = Snapshot.async_take(path, {"train": StateDict(work["ssm"][1])})
    planted = os.path.exists(os.path.join(path, SNAPSHOT_FENCE_FNAME)) or pending.done()
    pending.wait()
    gone = not os.path.exists(os.path.join(path, SNAPSHOT_FENCE_FNAME))
    committed = os.path.exists(os.path.join(path, SNAPSHOT_METADATA_FNAME))
    log(f"[workloads] fenced async_take of the SSM state: fence present on return (or already "
        f"committed) {planted}, gone after the commit {gone}, committed {committed}")
    if not (planted and gone and committed):
        raise AssertionError("the commit fence protocol did not hold")
    return k4


def _async_restore_moe(path: str, work: dict, card: str) -> dict:
    """async_restore of the MoE train state while the caller queues SSM
    forwards, against a blocking restore followed by them; bit-exact, and
    the next step bit-identical. Returns the saved leaves."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    cfg, state, step, batch = work["moe"]
    ssm_cfg, ssm_state, _, ssm_batch = work["ssm"]
    saved = {p: t.clone() for p, t in _flat(state).items()}

    def fresh():
        return _build_moe_state(seed=15)

    def ssm_forward():
        return _forward("ssm", ssm_cfg, ssm_state["params"], ssm_batch)

    def same(got) -> bool:
        flat = _flat(got)
        return flat.keys() == saved.keys() and all(torch.equal(flat[p], saved[p]) for p in saved)

    # Blocking restore, then the caller's forwards.
    dst = StateDict(fresh())
    _sync()
    t0 = time.perf_counter()
    Snapshot(path).restore({"train": dst})
    t_restore = time.perf_counter() - t0
    for _ in range(ASYNC_RESTORE_FORWARDS):
        ssm_forward()
    _sync()
    t_blocking = time.perf_counter() - t0
    if not same(dict(dst)):
        raise AssertionError("the blocking restore of the MoE state is not bit-exact")
    del dst

    # async_restore, the same forwards queued while it runs.
    dst = StateDict(fresh())
    _sync()
    t0 = time.perf_counter()
    pending = Snapshot(path).async_restore({"train": dst})
    held = time.perf_counter() - t0
    overlapped = 0
    for _ in range(ASYNC_RESTORE_FORWARDS):
        overlapped += not pending.done()
        ssm_forward()
    pending.wait()
    t_wait = time.perf_counter() - t0
    restored = dict(dst)
    exact = same(restored)  # kernels launched right after wait()
    _sync()
    t_async = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in saved.values())
    log(f"[workloads] MoE train state ({nbytes} B): blocking restore {t_restore * 1e3:.1f} ms "
        f"({nbytes / t_restore / 1e9:.3f} GB/s), then {ASYNC_RESTORE_FORWARDS} SSM forwards: "
        f"{t_blocking * 1e3:.1f} ms in all; async_restore held the caller {held * 1e3:.2f} ms, "
        f"wait() returned after {t_wait * 1e3:.1f} ms with {ASYNC_RESTORE_FORWARDS} SSM forwards "
        f"queued meanwhile ({overlapped} of them before the restore was done), all done after "
        f"{t_async * 1e3:.1f} ms; bit-exact right after wait() {exact}; on {card}")
    if not exact:
        raise AssertionError("async_restore of the MoE state is not bit-exact after wait()")
    # The next step is bit-identical to the one the saved state takes.
    _, loss = step(state, batch)
    after = {p: t.clone() for p, t in _flat(state).items()}
    _, loss_again = step(restored, batch)
    got = _flat(restored)
    if not torch.equal(loss, loss_again) or not all(torch.equal(got[p], after[p]) for p in after):
        raise AssertionError("the step after async_restore is not bit-identical")
    log(f"[workloads] the step after async_restore: loss {loss.item():.6f}, every leaf "
        "bit-identical to the step of the saved state")
    return saved


def _build_moe_state(seed: int):
    from torchsnapshot_tpu_torch.models import transformer as T

    return T.init_state(torch.Generator().manual_seed(seed), _moe_config(), T.make_optimizer(), DEVICE)


def _read_state_dict_moe(path: str, saved: dict, card: str) -> None:
    from torchsnapshot_tpu_torch import Snapshot

    t0 = time.perf_counter()
    sd = Snapshot(path).read_state_dict(key="train")
    took = time.perf_counter() - t0
    flat = _flat(sd)
    nbytes = sum(t.numel() * t.element_size() for t in flat.values() if isinstance(t, torch.Tensor))
    log(f"[workloads] read_state_dict of the MoE train state: {len(flat)} leaves, {nbytes} B of "
        f"CPU tensors in {took * 1e3:.1f} ms ({nbytes / took / 1e9:.3f} GB/s); on {card}")
    if flat.keys() != saved.keys() or not all(
        flat[p].device.type == "cpu" and torch.equal(flat[p], saved[p].cpu()) for p in saved
    ):
        raise AssertionError("read_state_dict is not the saved state as CPU tensors")


def _budgeted_read(root: str, card: str) -> None:
    """One 1 GiB tensor (phase 13's shape) read into a CUDA ``obj_out``
    under a 64 MiB budget and with none, in turns."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.io_preparers.array import _staging_pool

    g = torch.Generator(device=DEVICE).manual_seed(16)
    master = torch.randn(STREAM_SHAPE, generator=g, device=DEVICE)
    path = f"{root}/budget"
    Snapshot.take(path, {"embedding": StateDict(master=master)})
    out = torch.empty_like(master)
    nbytes = master.numel() * master.element_size()
    results = {}
    for budget in (None, READ_BUDGET_BYTES, READ_BUDGET_BYTES, None):
        out.zero_()
        gc.collect()
        _staging_pool.reset_peak()
        base = _staging_pool.outstanding_bytes
        _sync()
        t0 = time.perf_counter()
        Snapshot(path).read_object("0/embedding/master", obj_out=out, memory_budget_bytes=budget)
        _sync()
        took = time.perf_counter() - t0
        if not torch.equal(out, master):
            raise AssertionError(f"read_object with memory_budget_bytes={budget} is not bit-exact")
        results.setdefault(budget, []).append((nbytes / took / 1e9, _staging_pool.peak_bytes - base))
    for budget, runs in results.items():
        log(f"[workloads] read_object of a {nbytes}-byte f32 tensor {STREAM_SHAPE} into CUDA, "
            f"memory_budget_bytes={budget}: " + ", ".join(
                f"{gbps:.3f} GB/s (staging pool peak {peak} B)" for gbps, peak in runs)
            + f"; bit-exact; on {card}")
    peak = max(p for _, p in results[READ_BUDGET_BYTES])
    if DEVICE == "cuda" and _staging_pool.available() and peak > READ_BUDGET_BYTES:
        raise AssertionError(f"a budgeted read held {peak} B of staging, over its budget")


def phase_profile(fn, params, tokens, cfg) -> None:
    """Steady-state serving latency and train-step time (flash and dense
    attention) and where one traced forward's and one traced train step's
    device time goes."""
    from torchsnapshot_tpu_torch.entry import train_entry
    from torchsnapshot_tpu_torch.models import transformer as T

    dense_cfg = dataclasses.replace(cfg, attn_impl="dense")
    ms, spread = time_in_turns(
        {"flash": lambda: fn(params, tokens), "dense": lambda: T.forward(params, tokens, dense_cfg)},
        iters=10,
    )
    log(f"[profile] serving forward, (4, 256) tokens, median of 5 rounds x 10: "
        f"{ms['flash']:.3f} ms with flash_fwd (range {spread['flash'][0]:.3f}-{spread['flash'][1]:.3f}), "
        f"{ms['dense']:.3f} ms with dense attention "
        f"(range {spread['dense'][0]:.3f}-{spread['dense'][1]:.3f})")
    _trace("forward", lambda: fn(params, tokens))

    train_step, (state, batch) = train_entry(device=DEVICE, seed=0)
    dense_step = T.make_train_step(dense_cfg, T.make_optimizer())
    ms, spread = time_in_turns(
        {"flash": lambda: train_step(state, batch), "dense": lambda: dense_step(state, batch)},
        iters=5,
    )
    log(f"[profile] train step, (4, 256) tokens, median of 5 rounds x 5: "
        f"{ms['flash']:.3f} ms with the flash kernels (range {spread['flash'][0]:.3f}-"
        f"{spread['flash'][1]:.3f}), {ms['dense']:.3f} ms with dense attention "
        f"(range {spread['dense'][0]:.3f}-{spread['dense'][1]:.3f})")
    _trace("train step", lambda: train_step(state, batch))


# ------------------------------------------------------- phase 15: sharded


def _sharded_placements(t: torch.Tensor, mesh_ndim: int, flip: bool = False):
    """A train-state leaf's DTensor placements: FSDP2's ``Shard(0)`` on a
    1-D mesh (``Shard(1)`` where ``flip`` and the leaf has two dims); on a
    2 x 2 mesh ``[Shard(0), Shard(1)]`` for two dims or more, else
    ``[Shard(0), Replicate]``; a scalar (Adam's count, the step) is
    ``Replicate`` on every mesh dim, which the take auto-detects as
    replicated."""
    from torch.distributed.tensor import Replicate, Shard

    if t.dim() == 0:
        return [Replicate()] * mesh_ndim
    if mesh_ndim == 1:
        return [Shard(1) if flip and t.dim() >= 2 else Shard(0)]
    return [Shard(0), Shard(1)] if t.dim() >= 2 else [Shard(0), Replicate()]


def _map_state(fn, tree):
    """``tree`` with every tensor leaf ``t`` replaced by ``fn(t)`` (dicts,
    lists, tuples and NamedTuples kept)."""
    if isinstance(tree, dict):
        return {k: _map_state(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map_state(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _to_dtensors(state, mesh, device: str, flip: bool = False, fill=None):
    """The train state as DTensors on ``mesh``: each rank's local shard is
    its box of the full leaf, moved to ``device`` (zeros with ``fill``)."""
    from torch.distributed.tensor import DTensor

    from torchsnapshot_tpu_torch.io_preparers.sharded import shard_boxes

    def leaf(t):
        placements = _sharded_placements(t, mesh.ndim, flip)
        box = shard_boxes(t.shape, mesh.mesh, placements)[mesh.get_rank()]
        local = t[tuple(slice(lo, hi) for lo, hi in box)]
        local = torch.zeros_like(local, device=device) if fill is not None else local.to(device)
        return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return _map_state(leaf, state)


def _locals_match(dstate, state, device: str) -> bool:
    """Every DTensor leaf's local shard is on ``device`` and equals its box
    of the full leaf."""
    from torchsnapshot_tpu_torch.io_preparers.sharded import dtensor_view

    full = _flat(state)
    for path, dt in _flat(dstate).items():
        view = dtensor_view(dt)
        want = full[path][tuple(slice(lo, hi) for lo, hi in view.local_box)]
        if view.local.device.type != device or not torch.equal(view.local.cpu(), want):
            return False
    return True


@contextlib.contextmanager
def _no_collectives():
    """The checkpoint path must call no ``torch.distributed`` collective
    and no DTensor collective: they raise while this is active."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    def refuse(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"the checkpoint path called {name}")
        return fn

    targets = [(dist, n) for n in ("all_reduce", "all_gather", "all_gather_object", "broadcast",
                                   "broadcast_object_list", "barrier", "all_to_all",
                                   "reduce_scatter_tensor", "all_gather_into_tensor")]
    targets += [(DTensor, "full_tensor"), (DTensor, "redistribute")]
    saved = [(obj, n, getattr(obj, n)) for obj, n in targets]
    for obj, n, _ in saved:
        setattr(obj, n, refuse(n))
    try:
        yield
    finally:
        for obj, n, fn in saved:
            setattr(obj, n, fn)


def _sharded_world_setup(rank: int, world: int, mesh_shape, device: str, moe_kw: dict):
    from torch.distributed.device_mesh import init_device_mesh

    if device == "cuda":
        torch.cuda.set_device(0)  # every rank of the world shares the one card
    mesh = init_device_mesh(device, mesh_shape)
    if device == "cuda" and torch.cuda.current_device() != 0:
        raise AssertionError(f"rank {rank}: the DeviceMesh moved this process off device 0")
    state = _build_sharded_reference(moe_kw)
    return mesh, state


def _build_sharded_reference(moe_kw: dict):
    """The MoE train state from SHARDED_SEED, on the CPU. ``moe_kw`` is
    MOE_CONFIG_KW, passed to spawned processes (they import this file
    afresh)."""
    from torchsnapshot_tpu_torch.entry import ENTRY_CONFIG
    from torchsnapshot_tpu_torch.models import transformer as T

    cfg = dataclasses.replace(ENTRY_CONFIG, n_experts=MOE_EXPERTS, **moe_kw)
    return T.init_state(torch.Generator().manual_seed(SHARDED_SEED), cfg, T.make_optimizer(), "cpu")


def _sharded_world2(rank: int, world: int, root: str, device: str, moe_kw: dict) -> dict:
    """Phase 15's world of 2: take (device digests), async_take, and the
    zero-byte restore into another layout that holds the bytes, under the
    spies of the earlier phases."""
    with _CheckpointSpies() as spies:
        return _sharded_world2_run(rank, world, root, device, moe_kw, spies)


def _sharded_world2_run(rank: int, world: int, root: str, device: str, moe_kw: dict,
                        spies: "_CheckpointSpies") -> dict:
    import torch.distributed as dist

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch import device_digest as dd
    from torchsnapshot_tpu_torch.flatten import flatten
    from torchsnapshot_tpu_torch.io_preparers.sharded import (
        ShardedArrayIOPreparer, _overlap, dtensor_view)
    from torchsnapshot_tpu_torch.manifest import ShardedArrayEntry, get_manifest_for_rank

    mesh, state = _sharded_world_setup(rank, world, (world,), device, moe_kw)
    dstate = _to_dtensors(state, mesh, device)
    out = {"boxes_match_locals": _locals_match(dstate, state, device)}

    def synced():
        if device == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        return time.perf_counter()

    # The first take draws cold staging slabs; the second finds them.
    out["take_s"] = []
    for path in ("w2", "w2_warm"):
        dd.fingerprint_lanes.launches = 0
        spies.reset()
        t0 = synced()
        with _no_collectives():
            Snapshot.take(f"{root}/{path}", {"train": StateDict(dstate)}, device_digests=True)
        out["take_s"].append(synced() - t0)
        if path == "w2":
            out["k4_full"] = dd.fingerprint_lanes.launches
            out["written"] = list(spies.written)
    t0 = synced()
    with _no_collectives():
        pending = Snapshot.async_take(f"{root}/w2_async", {"train": StateDict(dstate)})
        out["async_hold_s"] = time.perf_counter() - t0
        pending.wait()
    out["async_s"] = synced() - t0

    # Zero-byte restore: destinations in another layout (Shard(1)), so
    # every piece of a leaf with two dims is cut across the processes.
    held = _to_dtensors(state, mesh, device, flip=True)
    available = get_manifest_for_rank(Snapshot(f"{root}/w2").metadata, rank)
    regions = 0
    for path, leaf in flatten(held, prefix="train")[1].items():
        entry = available.get(path)
        if isinstance(entry, ShardedArrayEntry):
            view = dtensor_view(leaf)
            regions += sum(_overlap(s.offsets, s.sizes, box) is not None
                           for box, _ in ShardedArrayIOPreparer._elected_local_boxes(view)
                           for s in entry.shards)
    spies.reset()
    dd.fingerprint_lanes.partial_launches = 0
    t0 = synced()
    # Both peer elections engage (one flag gather) and find nothing to read.
    with _no_collectives(), _env(TORCHSNAPSHOT_GPU_COOP_RESTORE="always",
                                 TORCHSNAPSHOT_GPU_RESHARD="always"):
        Snapshot(f"{root}/w2").restore({"train": StateDict(held)}, device_digests=True)
    out["zero_s"] = synced() - t0
    out["partial_launches"] = dd.fingerprint_lanes.partial_launches
    out["elected_regions"] = regions
    out["zero_read_bytes"] = spies.read_bytes
    out["zero_reads"] = len(spies.reads)
    out["zero_exact"] = _locals_match(held, state, device)
    del held

    # Cooperative fan-out: every leaf replicated, whole on the card in each
    # rank, read directly and then once in all with the peer forwards.
    with _no_collectives():
        Snapshot.take(f"{root}/w2_repl", {"train": StateDict(_map_state(lambda t: t.to(device), state))},
                      replicated=["**"])
    # In turns (direct, cooperative, cooperative, direct): the first
    # restore of a fresh process finds cold staging slabs.
    for run, mode in enumerate(("never", "always", "always", "never")):
        key = f"coop_{mode}{'' if run < 2 else '_2'}"
        dst = _map_state(lambda t: torch.zeros_like(t, device=device), state)
        out[key] = _peer_restore(
            spies, synced, f"{root}/w2_repl", dst,
            dict(TORCHSNAPSHOT_GPU_COOP_RESTORE=mode, TORCHSNAPSHOT_GPU_RESHARD="never"))
        got, want = _flat(dst), _flat(state)
        out[key]["exact"] = all(
            got[p].device.type == device and torch.equal(got[p].cpu(), want[p]) for p in want)
        del dst, got
    return out


def _peer_restore(spies: "_CheckpointSpies", synced, path: str, dst, env: dict, plan=None) -> dict:
    """One restore of ``path`` into ``dst`` under ``env`` (and the fault
    plan ``plan``) with every collective refused: seconds, the payload
    bytes the fs plugin served, and the peer plane's counts."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict, faultinject
    from torchsnapshot_tpu_torch.fanout import peer_counts

    spies.reset()
    before = peer_counts.copy()
    faultinject.configure(plan)
    t0 = synced()
    try:
        with _no_collectives(), _env(**env):
            Snapshot(path).restore({"train": StateDict(dst)})
    finally:
        faultinject.disable()
    seconds = synced() - t0
    delta = {k: peer_counts[k] - before.get(k, 0) for k in peer_counts}
    return {"s": seconds, "read_bytes": spies.read_bytes,
            "peer_bytes": delta.get("bytes_from_peers", 0),
            "resharded_bytes": delta.get("bytes_resharded_from_peers", 0),
            "fallbacks": delta.get("fanout_fallbacks", 0)}


def _sharded_world4(rank: int, world: int, root: str, device: str, moe_kw: dict) -> dict:
    """Phase 15's world of 4: restore the world of 2's snapshot on a 2 x 2
    mesh directly, then planned, then planned with one corrupt bundle,
    every local shard against its box of the seed-built state; the planned
    restore's state is taken for the main process's train step."""
    with _CheckpointSpies() as spies:
        return _sharded_world4_run(rank, world, root, device, moe_kw, spies)


def _sharded_world4_run(rank: int, world: int, root: str, device: str, moe_kw: dict,
                        spies: "_CheckpointSpies") -> dict:
    import torch.distributed as dist

    from torchsnapshot_tpu_torch import Snapshot, StateDict

    mesh, state = _sharded_world_setup(rank, world, (2, 2), device, moe_kw)

    def synced():
        if device == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        return time.perf_counter()

    out = {}
    planned = None
    # In turns (direct, planned, planned, direct), then the drill.
    runs = (("direct", "never", None), ("planned", "always", None),
            ("planned_2", "always", None), ("direct_2", "never", None),
            ("drill", "always", "reshard.peer_xfer@1=corrupt;seed=5" if rank == 0 else None))
    for name, mode, plan in runs:
        dst = _to_dtensors(state, mesh, device, fill=0.0)
        out[name] = _peer_restore(spies, synced, f"{root}/w2", dst,
                                  dict(TORCHSNAPSHOT_GPU_RESHARD=mode,
                                       TORCHSNAPSHOT_GPU_COOP_RESTORE="never"), plan)
        out[name]["exact"] = _locals_match(dst, state, device)
        if name == "planned":
            planned = dst
    with _no_collectives():
        Snapshot.take(f"{root}/w4_planned", {"train": StateDict(planned)})
    return out


def phase_sharded(root: str, card: str, instructions_per_word: float, clock_mhz: float):
    """Phase 15 (see the module docstring). Returns (K1-K3 launches of the
    train step after the restore, K4 full-form launches by path, the K4
    partial form's kernels-line entry)."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch import device_digest as dd
    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses

    on_card = DEVICE == "cuda"
    cfg = _moe_config()
    state = _build_sharded_reference(MOE_CONFIG_KW)
    flat = _flat(state)
    nbytes = sum(t.numel() * t.element_size() for t in flat.values())
    n_params = sum(t.numel() for t in _flat(state["params"]).values())
    shared = "2 processes share one card and one host: not a fleet's numbers"
    log(f"[sharded] MoE train state (the entry config with {cfg.n_experts} experts, top-2): {n_params} params, {len(flat)} leaves, {nbytes} B; on {card}")

    t_world = time.perf_counter()
    w2 = run_with_subprocesses(_sharded_world2, 2, root, DEVICE, MOE_CONFIG_KW, backend="gloo",
                               timeout=600)
    log(f"[sharded] world of 2 spawned and done in {time.perf_counter() - t_world:.1f} s")
    written = {r: [p for p in w2[r]["written"] if p.startswith("replicated/")] for r in w2}
    cold, warm = (max(w2[r]["take_s"][i] for r in w2) for i in (0, 1))
    hold_s = max(w2[r]["async_hold_s"] for r in w2)
    log(f"[sharded] world of 2 ({shared}): take with device digests {cold * 1e3:.1f} ms "
        f"({nbytes / cold / 1e9:.3f} GB/s) with a cold staging pool, {warm * 1e3:.1f} ms "
        f"({nbytes / warm / 1e9:.3f} GB/s) again; K4 full-form launches by rank "
        f"{[w2[r]['k4_full'] for r in sorted(w2)]}; async_take held the callers "
        f"{hold_s * 1e3:.1f} ms (committed after {max(w2[r]['async_s'] for r in w2) * 1e3:.1f} "
        f"ms); replicated units written by rank {written}; every local shard equals its box "
        f"{all(w2[r]['boxes_match_locals'] for r in w2)}")
    if not all(w2[r]["boxes_match_locals"] for r in w2) or not all(written.values()):
        raise AssertionError("the world of 2's boxes or its replicated striping are wrong")
    if on_card and not all(w2[r]["k4_full"] for r in w2):
        raise AssertionError("the take with device digests launched no digest_full_kernel")
    for r in sorted(w2):
        log(f"[sharded] zero-byte restore on rank {r}: {w2[r]['zero_read_bytes']} payload bytes "
            f"read, digest_partial_kernel launched {w2[r]['partial_launches']} times for "
            f"{w2[r]['elected_regions']} elected regions, {w2[r]['zero_s'] * 1e3:.1f} ms; "
            f"destination unchanged {w2[r]['zero_exact']}")
        if w2[r]["zero_read_bytes"] or w2[r]["zero_reads"] or not w2[r]["zero_exact"] or w2[r]["elected_regions"] < 1:
            raise AssertionError("the zero-byte restore read payload or changed its destination")
        if on_card and w2[r]["partial_launches"] < w2[r]["elected_regions"]:
            raise AssertionError("digest_partial_kernel ran fewer times than there are regions")
    partial_launches = sum(w2[r]["partial_launches"] for r in w2)
    coop_runs = {"direct": "coop_never", "coop": "coop_always", "coop again": "coop_always_2",
                 "direct again": "coop_never_2"}
    _log_peer_restores("world of 2, cooperative fan-out of the state taken replicated=['**']",
                       {kind: [w2[r][key] for r in sorted(w2)] for kind, key in coop_runs.items()},
                       nbytes, "2 processes share one card and one host: not a fleet's numbers")
    coop, direct = ([w2[r][f"coop_{m}{s}"] for r in w2 for s in ("", "_2")] for m in ("always", "never"))
    if not all(x["exact"] for x in coop + direct):
        raise AssertionError("a cooperative or direct restore of the replicated state is not bit-exact")
    if sum(x["read_bytes"] for x in coop) > 2 * 1.2 * nbytes or sum(x["read_bytes"] for x in direct) < 2 * 1.8 * nbytes:
        raise AssertionError("cooperative fan-out did not cut the storage reads to about one copy")
    if any(x["fallbacks"] for x in coop) or not all(x["peer_bytes"] for x in coop):
        raise AssertionError("cooperative fan-out fell back or moved no peer bytes")

    t_world = time.perf_counter()
    w4 = run_with_subprocesses(_sharded_world4, 4, root, DEVICE, MOE_CONFIG_KW, backend="gloo",
                               timeout=600)
    four = "4 processes share one card and one host: not a fleet's numbers"
    log(f"[sharded] world of 2 -> world of 4 on a 2 x 2 mesh ([Shard(0), Shard(1)], "
        f"[Shard(0), Replicate]); world spawned and done in {time.perf_counter() - t_world:.1f} s")
    kinds = ("direct", "planned", "planned_2", "direct_2", "drill")
    _log_peer_restores("world of 2 -> world of 4, planned reshard",
                       {k.replace("_2", " again"): [w4[r][k] for r in sorted(w4)] for k in kinds},
                       nbytes, four)
    runs = {k: [w4[r][k] for r in w4] for k in kinds}
    if not all(x["exact"] for xs in runs.values() for x in xs):
        raise AssertionError("the world of 4 did not restore bit-exact")
    for planned, direct in (("planned", "direct"), ("planned_2", "direct_2")):
        if (sum(x["read_bytes"] for x in runs[planned]) > 1.2 * nbytes
                or sum(x["read_bytes"] for x in runs[direct]) < 1.8 * nbytes):
            raise AssertionError("the planned reshard did not cut the storage reads to about one copy")
        if any(x["fallbacks"] for x in runs[planned]) or not sum(x["resharded_bytes"] for x in runs[planned]):
            raise AssertionError("the planned reshard fell back or moved no peer bytes")
    if sum(x["fallbacks"] for x in runs["drill"]) != 1:
        raise AssertionError("the corrupt bundle did not fall back for exactly that one unit")

    # 2 -> 1 and the planned 2 -> 4: plain tensors on the card (the first
    # restore draws cold staging slabs in this process), then one train
    # step from the planned restore's state and from the original state,
    # bit-identical.
    for path in ("w2", "w2_async", "w4_planned"):
        dst = _map_state(lambda t: torch.zeros_like(t, device=DEVICE), state)
        _sync()
        t0 = time.perf_counter()
        Snapshot(f"{root}/{path}").restore({"train": StateDict(dst)})
        _sync()
        took = time.perf_counter() - t0
        got = _flat(dst)
        exact = all(torch.equal(got[p].cpu(), flat[p]) for p in flat)
        log(f"[sharded] {path}: {'world of 4' if path == 'w4_planned' else 'world of 2'} -> one process (plain tensors on the card): "
            f"{took * 1e3:.1f} ms ({nbytes / took / 1e9:.3f} GB/s; {shared}), bit-exact {exact}")
        if not exact:
            raise AssertionError(f"the world of 2's {path} snapshot did not restore bit-exact")
    opt = T.make_optimizer()
    step = T.make_train_step(cfg, opt)
    gen = torch.Generator().manual_seed(SHARDED_SEED + 1)
    batch = {n: torch.randint(0, cfg.vocab_size, WORKLOAD_TOKENS, generator=gen).to(DEVICE)
             for n in ("tokens", "targets")}
    original = _map_state(lambda t: t.to(DEVICE, copy=True), state)
    torch.use_deterministic_algorithms(True)
    try:
        _, loss_original = step(original, batch)
        _reset_launch_counts()
        _, loss_restored = step(dst, batch)
        _sync()
        launches = _launch_counts()
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = _flat(original), _flat(dst)
    same = torch.equal(loss_original, loss_restored) and all(torch.equal(a[p], b[p]) for p in a)
    log(f"[sharded] one MoE train step from the planned restore's state (w4_planned): loss {loss_restored.item():.6f}, "
        f"bit-identical to the step from the seed-built state {same}; launches {launches}")
    if not same:
        raise AssertionError("the train step after the sharded restore is not bit-identical")
    if on_card and any(n != cfg.n_layers for n in launches.values()):
        raise AssertionError(f"expected {cfg.n_layers} launches of each flash kernel, got {launches}")
    del original

    # Reads: one sharded leaf into a CUDA tensor, and rank 1's state dict.
    name = "params/layers/moe_w_in"
    out = torch.zeros_like(flat[f"/{name}"], device=DEVICE)  # _flat's paths start with "/"
    got = Snapshot(f"{root}/w2").read_object(f"0/train/{name}", obj_out=out)
    sd = _flat(Snapshot(f"{root}/w2").read_state_dict(key="train", rank=1))
    read_ok = got is out and torch.equal(out.cpu(), flat[f"/{name}"])
    sd_ok = sd.keys() == flat.keys() and all(torch.equal(sd[p], flat[p]) for p in flat)
    log(f"[sharded] read_object of {name} {tuple(out.shape)} into a CUDA tensor: bit-exact "
        f"{read_ok}; read_state_dict(rank=1): bit-exact {sd_ok}")
    if not (read_ok and sd_ok):
        raise AssertionError("read_object or read_state_dict of the sharded snapshot is wrong")
    del dst, out, sd

    k4_full = {"sharded: the world of 2's take with device digests": sum(w2[r]["k4_full"] for r in w2)}
    return launches, k4_full, _partial_timing(state, partial_launches, instructions_per_word,
                                              clock_mhz, card)


def _log_peer_restores(what: str, runs: dict, nbytes: int, shared: str) -> None:
    """One line a restore kind: the payload bytes the fs plugin served
    summed over the ranks (and as a multiple of the state's bytes), the
    peer bytes, the fallbacks, the slowest rank's ms, bit-exactness."""
    for kind, per_rank in runs.items():
        read = sum(x["read_bytes"] for x in per_rank)
        peer = sum(x["peer_bytes"] for x in per_rank)
        slowest = max(x["s"] for x in per_rank)
        log(f"[sharded] {what}, {kind}: {read} payload bytes read from storage in all "
            f"({read / nbytes:.3f} x the state's {nbytes} B), {peer} B over the peer channel "
            f"({sum(x['resharded_bytes'] for x in per_rank)} B of them region bundles), "
            f"{sum(x['fallbacks'] for x in per_rank)} fallback(s), {slowest * 1e3:.1f} ms "
            f"(slowest rank; {shared}); bit-exact {[x['exact'] for x in per_rank]}")


def _partial_timing(state, launches: int, instructions_per_word: float, clock_mhz: float,
                    card: str) -> dict:
    """K4's partial form on the largest region of the zero-byte restore:
    a (2, 4, 512, 2048) f32 region of a (2, 8, 512, 2048) piece of
    moe_w_in, at offsets (0, 4, 0, 0). Its lanes against the plain
    version's, its device time and its time with the host, and its bound.
    Returns the kernels-line entry."""
    from torchsnapshot_tpu_torch import device_digest as dd

    piece = state["params"]["layers"]["moe_w_in"][0:2]
    offsets = (0, 4, 0, 0)
    region = piece[:, 4:8].contiguous().to(DEVICE)
    kernel = dd.partial_fetch(dd.partial_dispatch(region, piece.shape, offsets))
    plain = dd.lanes_reference(region, offsets, piece.shape)
    err = max(abs(a - b) for a, b in zip(kernel, plain))
    nbytes = region.numel() * region.element_size()
    words = nbytes // 4
    entry = {
        "name": "device_digest_partial",
        "route": "cuda",
        "source": "torchsnapshot_tpu_torch/csrc/digest.cu",
        "replaces": "torchsnapshot_tpu/device_digest.py:196",
        "launches": launches,
        "max_abs_err": float(err),
        "library_ms": None,
    }
    log(f"[sharded] K4 partial form on a {tuple(region.shape)} f32 region ({nbytes} B) of a "
        f"{tuple(piece.shape)} piece at {offsets}: lanes equal the plain version's "
        f"{kernel == plain} (max difference {err})")
    if kernel != plain:
        raise AssertionError("K4's partial form disagrees with its plain version")
    if DEVICE != "cuda":
        return {**entry, "ms": float("nan"), "plain_ms": float("nan"), "bound_ms": float("nan"),
                "bound_by": "operations"}
    calls = {"partial": lambda: dd.partial_dispatch(region, piece.shape, offsets),
             "partial_plain": lambda: dd.lanes_reference(region, offsets, piece.shape)}
    int_ops_per_s = DISPATCH_LANES_PER_CLOCK * clock_mhz * 1e6
    ops_ms = words * instructions_per_word / int_ops_per_s * 1e3
    bytes_ms = (nbytes + 16) / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    clocks = {"before": sm_clocks()}
    ms, spread = time_in_turns(calls, iters=10, rounds=3)
    timers = len(DEVICE_TIMERS)
    dev, dev_spread = time_in_turns(calls, iters=5, rounds=3, timer=device_time_ms,
                                    floors={"partial": bound_ms, "partial_plain": bound_ms})
    device_timer = device_timer_since(timers)
    graph = graph_times({"partial": calls["partial"]})
    clocks["after"] = sm_clocks()
    cross_check("device_digest_partial", dev["partial"], graph["partial"], clocks)
    log(f"[sharded] K4 partial form: bound {bound_ms * 1e3:.3f} us by {bound_by} ({words} words x "
        f"{instructions_per_word:.2f} instructions at {int_ops_per_s / 1e12:.2f} T/s; bytes alone "
        f"{bytes_ms * 1e3:.3f} us); device time of one call, median of 3 profiled rounds x 5: "
        f"K4 {_us(dev['partial'])} (valid rounds {_us(dev_spread['partial'][0])}-"
        f"{_us(dev_spread['partial'][1])}), plain {_us(dev['partial_plain'])}; CUDA graph of "
        f"{GRAPH_CALLS} calls, median of {GRAPH_REPLAYS} replays: K4 {_us(graph['partial'])}; "
        f"with the host, median of 3 rounds x 10: K4 {ms['partial'] * 1e3:.2f} us, plain "
        f"{ms['partial_plain'] * 1e3:.2f} us; {launches} launches in the zero-byte restore; SM "
        f"clock, max, power before {clocks['before']}, after {clocks['after']}; on {card}")
    return {**entry, "ms": ms["partial"], "plain_ms": ms["partial_plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "device_ms": dev["partial"],
            "plain_device_ms": dev["partial_plain"], "device_timer": device_timer,
            "graph_ms": graph["partial"], "sm_clock": clocks}



# ------------------------------------------------------ phase 16: parallel


def _expected_kernel_calls(impl: str, seq_rank: int, n_seq: int, n_layers: int) -> int:
    """K1 launches of one forward (and of each of K1-K3 in one step) on the
    rank of seq index ``seq_rank``: the ring skips the hops wholly in the
    future (``ops/ring_attention.py``), so it runs ``seq_rank + 1`` hops a
    layer; zigzag runs ``2n + 1`` calls a layer; Ulysses and the sharded
    flash one."""
    per_layer = {"ring": seq_rank + 1, "zigzag": 2 * n_seq + 1}.get(impl, 1)
    return n_layers * per_layer


def _event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _digests(state) -> dict:
    """{logical path: sha256 of the bytes} of every tensor of a state."""
    import hashlib

    out = {}
    for path, t in _flat(state).items():
        t = t.detach().to("cpu").contiguous()
        out[path] = hashlib.sha256(t.reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest()
    return out


def _layer_check(impl: str, mesh, device: str) -> dict:
    """One bf16 attention layer through ``impl``'s route on this rank's
    block of ``mesh``, at the shapes at which its path launches K1-K3
    (``RING_LAYER_SHAPE`` is the entry layer's (B, S, H, D)): ring-flash,
    zigzag-flash (in zigzag layout), Ulysses or, for ``auto``, the flash
    kernels on the rank's batch and heads. Held against the plain version
    on the whole sequence in this process (dense attention in f32) and
    against K1-K3 on the whole sequence: the forward and the gradients of
    ``sum(o * dO)``, as the maxima of the absolute differences."""
    from torchsnapshot_tpu_torch.ops.attention import dense_attention
    from torchsnapshot_tpu_torch.ops.flash_attention import flash
    from torchsnapshot_tpu_torch.ops.ring_attention import zigzag_layout_indices
    from torchsnapshot_tpu_torch.ops.ring_flash import (
        ring_flash_self_attention,
        zigzag_ring_flash_self_attention,
    )
    from torchsnapshot_tpu_torch.ops.ulysses import ulysses_self_attention
    from torchsnapshot_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

    B, S, H, D = RING_LAYER_SHAPE
    gen = torch.Generator().manual_seed(PARALLEL_SEED + 1)
    q, k, v, dO = (torch.randn(RING_LAYER_SHAPE, generator=gen).to(device, torch.bfloat16)
                   for _ in range(4))

    def run(fn, args, dO_):
        args = [t.detach().clone().requires_grad_(True) for t in args]
        o = fn(*args)
        o.backward(dO_)
        return o.detach().float(), [t.grad.float() for t in args]

    f32 = [t.float() for t in (q, k, v)]
    refs = {"plain": run(lambda *a: dense_attention(*a, causal=True), f32, dO.float()),
            "kernels": run(lambda *a: flash(*a, causal=True), (q, k, v), dO)}
    seq = axis_group(mesh, "seq")
    routes = {
        "ring": lambda *a: ring_flash_self_attention(*a, group=seq, causal=True),
        "zigzag": lambda *a: zigzag_ring_flash_self_attention(*a, group=seq),
        "ulysses": lambda *a: ulysses_self_attention(*a, group=seq, causal=True),
        "auto": lambda *a: flash(*a, causal=True),
    }
    n_seq = axis_size(mesh, "seq") if impl != "auto" else 1
    B_l, S_l, H_l = (B // axis_size(mesh, "data"), S // n_seq, H // axis_size(mesh, "model"))
    rd, rs, rm = (axis_rank(mesh, a) for a in ("data", "seq", "model"))
    layout = (zigzag_layout_indices(S, n_seq, device) if impl == "zigzag"
              else torch.arange(S, device=device))
    positions = layout[rs * S_l: (rs + 1) * S_l] if n_seq > 1 else layout

    def block(t):
        t = t[rd * B_l: (rd + 1) * B_l, :, rm * H_l: (rm + 1) * H_l]
        return t.index_select(1, positions).contiguous()

    o, grads = run(routes[impl], [block(t) for t in (q, k, v)], block(dO))
    out = {"shape": (B_l, S_l, H_l, D)}
    for name, (o_ref, g_ref) in refs.items():
        out[f"fwd_{name}"] = (o - block(o_ref)).abs().max().item()
        out[f"grad_{name}"] = max((g - block(r)).abs().max().item() for g, r in zip(grads, g_ref))
    return out


def _parallel_world(rank: int, world: int, root: str, device: str, cfg_kw: dict,
                    tokens_shape) -> dict:
    """Phase 16's world: every impl's forward and train step on its mesh,
    held against the single-process port on the same params and tokens;
    the launches, times and host-staged hops of each; the ring's state
    taken after its steps."""
    from torch.profiler import ProfilerActivity, profile

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.entry import ENTRY_CONFIG, _global_state
    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.parallel import comm, make_mesh, shard_pytree
    from torchsnapshot_tpu_torch.parallel.mesh import axis_rank, axis_size

    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)  # every rank of the world shares the one card
    # A resume from the taken state must be bit-identical (phase 7).
    torch.use_deterministic_algorithms(True)
    cfg = dataclasses.replace(ENTRY_CONFIG, **cfg_kw)
    opt = T.make_optimizer()
    gen = torch.Generator().manual_seed(PARALLEL_SEED)
    full = T.init_state(gen, cfg, opt, "cpu")
    batch = {k: torch.randint(0, cfg.vocab_size, tokens_shape, generator=gen).to(device)
             for k in ("tokens", "targets")}
    params = T.params_from_numpy(T.params_to_numpy(full["params"]), device)
    with torch.no_grad():
        ref_logits = T.forward(params, batch["tokens"], cfg).float()
    ref_loss, ref_grads = T.loss_and_grads(params, batch, cfg)
    ref_grads = _flat(ref_grads)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {}
    for impl, shape in PARALLEL_IMPLS:
        mesh = make_mesh(shape, device=device)
        layer = _layer_check(impl, mesh, device)
        icfg = dataclasses.replace(cfg, attn_impl=impl)
        state = shard_pytree(full, T.state_specs(icfg, full), mesh)
        step = T.make_train_step(icfg, opt, mesh=mesh)

        def forward():
            with torch.no_grad():
                return T.forward(state["params"], batch["tokens"], icfg, mesh=mesh)

        sync()
        _reset_launch_counts()
        comm.staged.clear()
        logits = forward()
        sync()
        fwd_launches, fwd_staged = _launch_counts(), dict(comm.staged)
        diff = (logits.float() - ref_logits).abs()
        _reset_launch_counts()
        comm.staged.clear()
        _, loss = step(state, batch)
        sync()
        step_launches, step_staged = _launch_counts(), dict(comm.staged)
        # Adam's first moment after one step is (1 - b1) * the gradient.
        mu = _flat(_global_state(state, icfg, mesh)["opt_state"][0].mu)
        rel = {p: _rel_l2(m.to(device) / 0.1, ref_grads[p]) for p, m in mu.items()}
        worst = max(rel, key=rel.get)
        res = {
            "mesh": shape, "seq_rank": axis_rank(mesh, "seq"), "n_seq": axis_size(mesh, "seq"),
            "layer": layer,
            "fwd_launches": fwd_launches, "step_launches": step_launches,
            "fwd_staged": fwd_staged, "step_staged": step_staged,
            "logits_max": diff.max().item(), "logits_mean": diff.mean().item(),
            "loss": float(loss), "ref_loss": float(ref_loss),
            "worst_grad": (worst, rel[worst]),
        }
        if on_card:
            fwd_ms = [_event_ms(forward) for _ in range(PARALLEL_ROUNDS)]
            step_ms = [_event_ms(lambda: step(state, batch)) for _ in range(PARALLEL_ROUNDS)]
            res["fwd_ms"], res["step_ms"] = statistics.median(fwd_ms), statistics.median(step_ms)
            # Every rank traces one more step: its own kernels' busy time
            # over its wall time (the card is shared by the world, so the
            # card's busy time is the sum over the ranks).
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(state, batch)
                sync()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy = sum(t for _, t, _ in _device_events(prof))
            res["trace"] = {"wall_us": wall_us, "busy_us": busy}
        if impl == "ring":
            Snapshot.take(f"{root}/ring", {"train": StateDict(state)})
            res["digests"] = _digests(_global_state(state, icfg, mesh))
        out[impl] = res
    return out


def phase_parallel(root: str, card: str):
    """Phase 16 (see the module docstring). Returns the K1-K3 launches of
    the world's forwards and steps, summed over its ranks, and K4's
    launches in the dryrun's device-digest round trip, summed likewise."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.entry import ENTRY_CONFIG, dryrun_multichip
    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses

    on_card = DEVICE == "cuda"
    cfg = dataclasses.replace(ENTRY_CONFIG, **PARALLEL_CONFIG_KW)
    world = f"{PARALLEL_WORLD}, on {card}"
    n_layers = cfg.n_layers

    # The dryrun's step, snapshot round trip into {data 2, seq 1, model 2}
    # and second step, at the entry config's widths.
    t0 = time.perf_counter()
    dry = dryrun_multichip(4, device=DEVICE, cfg=cfg, tokens_shape=PARALLEL_TOKENS,
                           seed=PARALLEL_SEED, timeout=900)
    log(f"[parallel] dryrun_multichip(4) ({world}) in {time.perf_counter() - t0:.1f} s: mesh "
        f"{dry[0]['mesh']} {dry[0]['attn_impl']}, restored into {dry[0]['restore_mesh']}; "
        + "; ".join(f"rank {r}: loss {d['loss']:.5f}, after the restore {d['loss_after_restore']:.5f}, "
                    f"take {d['take_s'] * 1e3:.1f} ms, restore {d['restore_s'] * 1e3:.1f} ms, "
                    f"step launches {d['launches']}" for r, d in sorted(dry.items())))
    for r, d in dry.items():
        want = _expected_kernel_calls("ring", (r // 2) % 2, 2, n_layers) if on_card else 0
        if any(n != want for n in d["launches"].values()):
            raise AssertionError(f"dryrun rank {r}: expected {want} launches each, got {d['launches']}")
        if not (math.isfinite(d["loss"]) and math.isfinite(d["loss_after_restore"])):
            raise AssertionError(f"dryrun rank {r}: a loss is not finite")
        log(f"[parallel] dryrun rank {r}: the device-digest round trip of the restored state "
            f"staged {d['dd_staged']} pieces and consumed {d['dd_consumed']}, K4 launches "
            f"{d['dd_launches']}; the pipeline on {{data 2, pipe 2}} (L 4, D 8, n_micro 4): "
            f"GPipe loss {d['pipeline']['gpipe_loss']:.6f}, 1F1B loss "
            f"{d['pipeline']['1f1b_loss']:.6f}")
        if d["dd_staged"] or d["dd_consumed"] or (on_card and d["dd_launches"] == 0):
            raise AssertionError(f"dryrun rank {r}: the device-digest round trip moved bytes or "
                                 f"launched no K4")
    dd_launches = sum(d["dd_launches"] for d in dry.values())

    t0 = time.perf_counter()
    ranks = run_with_subprocesses(_parallel_world, 4, root, DEVICE, PARALLEL_CONFIG_KW,
                                  PARALLEL_TOKENS, backend="gloo", timeout=900)
    log(f"[parallel] world of 4 ({world}) spawned and done in {time.perf_counter() - t0:.1f} s")
    total = {k: 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    for impl, _ in PARALLEL_IMPLS:
        for r, res in sorted(ranks.items()):
            lc = res[impl]["layer"]
            log(f"[parallel] {impl} rank {r}: one bf16 layer {RING_LAYER_SHAPE} through the "
                f"route on this rank's block {lc['shape']} against the plain version (dense f32) "
                f"on the whole sequence: forward max|diff| {lc['fwd_plain']:.4g}, gradients "
                f"{lc['grad_plain']:.4g}; against K1-K3 on the whole sequence: forward "
                f"{lc['fwd_kernels']:.4g}, gradients {lc['grad_kernels']:.4g} (bars "
                f"{RING_LAYER_FWD_ATOL}, {RING_LAYER_GRAD_ATOL})")
            if not all(lc[f"fwd_{w}"] <= RING_LAYER_FWD_ATOL
                       and lc[f"grad_{w}"] <= RING_LAYER_GRAD_ATOL for w in ("plain", "kernels")):
                raise AssertionError(f"{impl} rank {r}: the route's layer disagrees with the "
                                     f"whole sequence")
    for impl, _ in PARALLEL_IMPLS:
        card_busy = sum(res[impl]["trace"]["busy_us"] for res in ranks.values()) if on_card else 0
        for r, res in sorted(ranks.items()):
            x = res[impl]
            dl = abs(x["loss"] - x["ref_loss"])
            path, worst = x["worst_grad"]
            line = (f"[parallel] {impl} on {x['mesh']} rank {r}: logits max|diff| "
                    f"{x['logits_max']:.4g} mean {x['logits_mean']:.4g} (bars {LOGITS_MAX_ATOL}, "
                    f"{LOGITS_MEAN_ATOL}); loss {x['loss']:.5f} vs {x['ref_loss']:.5f} (bar "
                    f"{TRAIN_LOSS_ATOL:.4g}); worst gradient rel L2 {worst:.3g} at {path} (bar "
                    f"{TRAIN_GRAD_REL_L2}); launches a forward {x['fwd_launches']}, a step "
                    f"{x['step_launches']}; staged through the host a forward "
                    f"{x['fwd_staged'].get('calls', 0)} calls {x['fwd_staged'].get('bytes', 0)} B "
                    f"{x['fwd_staged'].get('ms', 0.0):.2f} ms, a step "
                    f"{x['step_staged'].get('calls', 0)} calls {x['step_staged'].get('bytes', 0)} B "
                    f"{x['step_staged'].get('ms', 0.0):.2f} ms")
            if on_card:
                line += (f"; forward {x['fwd_ms']:.2f} ms, step {x['step_ms']:.2f} ms (CUDA events, "
                         f"median of {PARALLEL_ROUNDS}; {world})")
                t = x["trace"]
                own = f"{1 - t['busy_us'] / t['wall_us']:.3f}" if t["busy_us"] > 0 else "not measured"
                line += (f"; traced step wall {t['wall_us']:.0f} us, this rank's kernels busy "
                         f"{t['busy_us']:.0f} us (this rank's idle share {own}); the card's "
                         f"kernels busy, summed over the {len(ranks)} ranks' traces, "
                         f"{card_busy:.0f} us (the card's idle share over this rank's wall "
                         f"{1 - card_busy / t['wall_us']:.3f})")
            log(line)
            if not (x["logits_max"] <= LOGITS_MAX_ATOL and x["logits_mean"] <= LOGITS_MEAN_ATOL
                    and dl <= TRAIN_LOSS_ATOL and worst <= TRAIN_GRAD_REL_L2):
                raise AssertionError(f"{impl} rank {r}: the mesh path disagrees with one process")
            if on_card:
                want = _expected_kernel_calls(impl, x["seq_rank"], x["n_seq"], n_layers)
                fwd_ok = x["fwd_launches"] == {"flash_fwd": want, "flash_bwd_dq": 0,
                                               "flash_bwd_dkv": 0}
                if not fwd_ok or any(n != want for n in x["step_launches"].values()):
                    raise AssertionError(f"{impl} rank {r}: expected {want} launches a forward "
                                         f"and of each kernel a step")
            for k in total:
                total[k] += x["fwd_launches"][k] + x["step_launches"][k]

    # One process restores the world's ring state bit-exact; the next step
    # runs on it.
    opt = T.make_optimizer()
    state = T.init_state(torch.Generator().manual_seed(PARALLEL_SEED + 2), cfg, opt, DEVICE)
    dst = StateDict(state)
    Snapshot(f"{root}/ring").restore({"train": dst})
    state = dict(dst)
    want = ranks[0]["ring"]["digests"]
    got = _digests(state)
    if got != want:
        bad = sorted(p for p in want if got.get(p) != want[p])
        raise AssertionError(f"the world's ring state did not restore bit-exact: {bad[:5]}")
    gen = torch.Generator().manual_seed(PARALLEL_SEED + 3)
    batch = {k: torch.randint(0, cfg.vocab_size, PARALLEL_TOKENS, generator=gen).to(DEVICE)
             for k in ("tokens", "targets")}
    _reset_launch_counts()
    _, loss = T.make_train_step(cfg, opt)(state, batch)
    _sync()
    launches = _launch_counts()
    log(f"[parallel] one process restored the world's ring state ({len(want)} leaves) bit-exact; "
        f"its next step: loss {loss.item():.5f}, step {int(state['step'])}, launches {launches}")
    if on_card and any(n != n_layers for n in launches.values()):
        raise AssertionError(f"expected {n_layers} launches of each kernel, got {launches}")
    if not math.isfinite(loss.item()):
        raise AssertionError("the step after the restore gave a loss that is not finite")
    return total, dd_launches


def _mesh_timed(fn, on_card: bool) -> dict:
    """Median CUDA-event ms of ``MESH_ROUNDS`` calls of ``fn`` and the
    bytes and ms the last one staged through the host."""
    from torchsnapshot_tpu_torch.parallel import comm

    if not on_card:
        comm.staged.clear()
        fn()
        return {"ms": None, "staged": dict(comm.staged)}
    times = []
    for _ in range(MESH_ROUNDS):
        comm.staged.clear()
        times.append(_event_ms(fn))
    return {"ms": statistics.median(times), "staged": dict(comm.staged)}


def _grad_rel(mu_tree, ref_grads, device: str) -> tuple:
    """(path, relative L2) of the worst gradient, read from Adam's first
    moment after one step (``mu = (1 - b1) * g``)."""
    mu = _flat(mu_tree)
    rel = {p: _rel_l2(m.to(device) / 0.1, ref_grads[p]) for p, m in mu.items()}
    worst = max(rel, key=rel.get)
    return worst, rel[worst]


def _mesh_ssm(root: str, device: str, on_card: bool) -> dict:
    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.models import ssm_lm as PL
    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.parallel import make_mesh
    from torchsnapshot_tpu_torch.parallel.mesh import gather_tree

    mesh = make_mesh(SSM_MESH, device=device)
    cfg, opt = PL.SSMConfig(**SSM_CONFIG_KW), T.make_optimizer()
    gen = torch.Generator().manual_seed(MESH_SEED)
    batch = {n: torch.randint(0, cfg.vocab_size, WORKLOAD_TOKENS, generator=gen).to(device)
             for n in ("tokens", "targets")}
    ref = PL.init_state(torch.Generator().manual_seed(MESH_SEED), cfg, opt, device)
    state = PL.init_state(torch.Generator().manual_seed(MESH_SEED), cfg, opt, mesh=mesh)
    with torch.no_grad():
        ref_logits = PL.forward(ref["params"], batch["tokens"], cfg)
    ref_loss, ref_grads = T.value_and_grad(PL.loss_fn, ref["params"], batch, cfg)
    ref_grads = _flat(ref_grads)
    del ref

    def forward():
        with torch.no_grad():
            return PL.forward(state["params"], batch["tokens"], cfg, mesh=mesh)

    logits_rel = _rel_l2(forward(), ref_logits)
    step = PL.make_train_step(cfg, opt, mesh=mesh)
    _, loss = step(state, batch)
    specs = PL.state_specs(cfg, state)
    worst = _grad_rel(gather_tree(state["opt"][0].mu, specs["opt"][0].mu, mesh), ref_grads, device)
    res = {"mesh": SSM_MESH, "logits_rel_l2": logits_rel, "loss": float(loss),
           "ref_loss": float(ref_loss), "worst_grad": worst,
           "forward": _mesh_timed(forward, on_card),
           "step": _mesh_timed(lambda: step(state, batch), on_card)}
    Snapshot.take(f"{root}/ssm", {"train": StateDict(state)})
    full = gather_tree(state, specs, mesh)
    res["digests"] = _digests(full)
    res["state_bytes"] = sum(t.numel() * t.element_size() for t in _flat(full).values())
    return res


def _embedding_batch(cfg, device: str) -> dict:
    gen = torch.Generator().manual_seed(MESH_SEED + 1)
    batch = {
        "dense": torch.randn((EMBEDDING_BATCH, cfg.n_dense_features), generator=gen),
        "sparse_ids": torch.randint(0, cfg.rows_per_table, (EMBEDDING_BATCH, cfg.n_tables),
                                    generator=gen),
        "labels": torch.randint(0, 2, (EMBEDDING_BATCH,), generator=gen).float(),
    }
    return {k: v.to(device) for k, v in batch.items()}


def _mesh_embedding(root: str, device: str, on_card: bool) -> dict:
    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.models import embedding as PE
    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.parallel import make_mesh
    from torchsnapshot_tpu_torch.parallel.mesh import gather_tree, to_local

    mesh = make_mesh(EMBEDDING_MESH, device=device)
    cfg, opt = PE.EmbeddingConfig(**EMBEDDING_CONFIG_KW), T.make_optimizer()
    batch = _embedding_batch(cfg, device)
    ref = PE.init_state(torch.Generator().manual_seed(MESH_SEED + 1), cfg, opt, device)
    ref_loss, ref_grads = T.value_and_grad(PE.loss_fn, ref["params"], batch, cfg)
    ref_grads = _flat(ref_grads)
    del ref
    state = PE.init_state(torch.Generator().manual_seed(MESH_SEED + 1), cfg, opt, mesh=mesh)

    def forward():
        with torch.no_grad():
            return PE.loss_fn(state["params"], batch, cfg, mesh=mesh)

    fwd_loss = float(forward())
    step = PE.make_train_step(cfg, opt, mesh=mesh)
    _, loss = step(state, batch)
    specs = PE.state_specs(cfg, state)
    worst = _grad_rel(gather_tree(state["opt_state"][0].mu, specs["opt_state"][0].mu, mesh),
                      ref_grads, device)
    res = {"mesh": EMBEDDING_MESH, "fwd_loss": fwd_loss, "loss": float(loss),
           "ref_loss": float(ref_loss), "worst_grad": worst,
           "local_rows": to_local(state["params"]["tables"]["table_0"]).shape[0],
           "forward": _mesh_timed(forward, on_card),
           "step": _mesh_timed(lambda: step(state, batch), on_card)}
    Snapshot.take(f"{root}/embedding", {"train": StateDict(state)})
    full = gather_tree(state, specs, mesh)
    res["digests"] = _digests(full)
    res["state_bytes"] = sum(t.numel() * t.element_size() for t in _flat(full).values())
    return res


def _pipe_params(device: str) -> dict:
    gen = torch.Generator().manual_seed(MESH_SEED + 2)
    L, D = PIPE_LAYERS, PIPE_WIDTH
    return {"w": (torch.randn(L, D, D, generator=gen) * D**-0.5).to(device),
            "b": (torch.randn(L, D, generator=gen) * 0.01).to(device)}


def _pipe_data(device: str):
    gen = torch.Generator().manual_seed(MESH_SEED + 3)
    x = torch.randn(PIPE_ROWS, PIPE_WIDTH, generator=gen).to(device)
    return x, torch.randn(PIPE_ROWS, PIPE_WIDTH, generator=gen).to(device)


def _pipe_layer(layer, h):
    return torch.tanh(h @ layer["w"] + layer["b"])


def _mse(y, t):
    return ((y - t) ** 2).mean()


def _mesh_pipeline(root: str, device: str, on_card: bool) -> dict:
    """GPipe (``pipelined_apply`` with autograd, loss ``mean(out ** 2)``)
    and 1F1B (``pipelined_value_and_grad``, the microbatches' mean MSE)
    on ``PIPE_MESH``, each an SGD step, against one process."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.parallel import make_mesh, shard_pytree
    from torchsnapshot_tpu_torch.parallel.mesh import gather, to_local
    from torchsnapshot_tpu_torch.parallel.pipeline import (
        pipeline_param_sharding,
        pipelined_apply,
        pipelined_value_and_grad,
    )

    mesh = make_mesh(PIPE_MESH, device=device)
    plain = _pipe_params(device)
    x, targets = _pipe_data(device)
    specs = pipeline_param_sharding(plain, mesh)
    params = shard_pytree(plain, specs, mesh)

    # One process: the sequential stack, its GPipe and 1F1B gradients.
    ref = {k: v.clone().requires_grad_(True) for k, v in plain.items()}

    def sequential(p, h):
        for i in range(PIPE_LAYERS):
            h = _pipe_layer({"w": p["w"][i], "b": p["b"][i]}, h)
        return h

    ref_out = sequential(ref, x)
    ref_gpipe = torch.autograd.grad((ref_out ** 2).mean(), list(ref.values()))
    ref_1f1b_loss = torch.stack([_mse(sequential(ref, xm), tm) for xm, tm in zip(
        x.chunk(PIPE_MICRO), targets.chunk(PIPE_MICRO))]).mean()
    ref_1f1b = torch.autograd.grad(ref_1f1b_loss, list(ref.values()))

    def gpipe_forward():
        with torch.no_grad():
            return pipelined_apply(params, x, mesh, layer_fn=_pipe_layer, n_micro=PIPE_MICRO)

    def gpipe_grads():
        for p in params.values():
            p.requires_grad_(True)
        try:
            out = pipelined_apply(params, x, mesh, layer_fn=_pipe_layer, n_micro=PIPE_MICRO)
            loss = (out ** 2).mean()
            return loss, dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        finally:
            for p in params.values():
                p.requires_grad_(False)

    def one_f_one_b():
        return pipelined_value_and_grad(params, x, targets, mesh, layer_fn=_pipe_layer,
                                        loss_fn=_mse, n_micro=PIPE_MICRO)

    def sgd(grads):
        with torch.no_grad():
            for k, g in grads.items():
                to_local(params[k]).sub_(PIPE_LR * to_local(g))

    out_diff = (gpipe_forward() - ref_out.detach()).abs().max().item()
    g_loss, g_grads = gpipe_grads()
    o_loss, o_grads = one_f_one_b()

    def rel(grads, want):
        return max(_rel_l2(gather(to_local(grads[k]), mesh, specs[k]), w)
                   for k, w in zip(plain, want))

    res = {"mesh": PIPE_MESH, "out_max": out_diff,
           "gpipe_loss": float(g_loss),
           "gpipe_ref_loss": float((ref_out.detach() ** 2).mean()),
           "gpipe_grad": rel(g_grads, ref_gpipe),
           "1f1b_loss": float(o_loss), "1f1b_ref_loss": float(ref_1f1b_loss.detach()),
           "1f1b_grad": rel(o_grads, ref_1f1b),
           "forward": _mesh_timed(gpipe_forward, on_card),
           "gpipe_step": _mesh_timed(lambda: sgd(gpipe_grads()[1]), on_card),
           "1f1b_step": _mesh_timed(lambda: sgd(one_f_one_b()[1]), on_card)}
    Snapshot.take(f"{root}/pipe", {"m": StateDict(params=params)})
    res["digests"] = _digests({"params": {k: gather(to_local(v), mesh, specs[k])
                                          for k, v in params.items()}})
    return res


# The sizes phase 17's workers take from the launching process (they import
# this module afresh).
_MESH_SIZES = ("SSM_CONFIG_KW", "EMBEDDING_CONFIG_KW", "EMBEDDING_BATCH", "WORKLOAD_TOKENS",
               "PIPE_WIDTH", "PIPE_ROWS")


def _mesh_world(rank: int, world: int, root: str, device: str, sizes: dict) -> dict:
    """Phase 17's world: the SSM LM, the embedding model and the two
    pipelines, each against one process, timed, and its state taken."""
    globals().update(sizes)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)  # every rank of the world shares the one card
        torch.backends.cuda.matmul.allow_tf32 = False
    return {"ssm": _mesh_ssm(root, device, on_card),
            "embedding": _mesh_embedding(root, device, on_card),
            "pipeline": _mesh_pipeline(root, device, on_card)}


def _fmt_staged(staged: dict) -> str:
    return (f"{staged.get('calls', 0)} calls {staged.get('bytes', 0)} B "
            f"{staged.get('ms', 0.0):.2f} ms")


def _fmt_timed(name: str, t: dict) -> str:
    ms = "not measured" if t["ms"] is None else f"{t['ms']:.2f} ms"
    return f"{name} {ms} (staged through the host {_fmt_staged(t['staged'])})"


def phase_mesh_workloads(root: str, card: str) -> None:
    """Phase 17 (see the module docstring)."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.models import embedding as PE
    from torchsnapshot_tpu_torch.models import ssm_lm as PL
    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses

    world = f"{PARALLEL_WORLD}, on {card}"
    timing = f"CUDA events, median of {MESH_ROUNDS}; {world}"
    t0 = time.perf_counter()
    sizes = {name: globals()[name] for name in _MESH_SIZES}
    ranks = run_with_subprocesses(_mesh_world, 4, root, DEVICE, sizes, backend="gloo",
                                  timeout=900)
    log(f"[mesh] world of 4 ({world}) spawned and done in {time.perf_counter() - t0:.1f} s")
    bad = []
    for r, res in sorted(ranks.items()):
        x = res["ssm"]
        path, worst = x["worst_grad"]
        dl = abs(x["loss"] - x["ref_loss"]) / abs(x["ref_loss"])
        log(f"[mesh] SSM LM on {x['mesh']} rank {r}: logits rel L2 {x['logits_rel_l2']:.3g} "
            f"(bar {MESH_LOGITS_REL_L2}); loss {x['loss']:.6f} vs {x['ref_loss']:.6f} "
            f"(rel {dl:.3g}, bar {MESH_LOSS_REL}); worst gradient rel L2 {worst:.3g} at {path} "
            f"(bar {MESH_GRAD_REL_L2}); {_fmt_timed('forward', x['forward'])}, "
            f"{_fmt_timed('step', x['step'])} ({timing})")
        if not (x["logits_rel_l2"] <= MESH_LOGITS_REL_L2 and dl <= MESH_LOSS_REL
                and worst <= MESH_GRAD_REL_L2):
            bad.append(f"SSM LM rank {r}")
        x = res["embedding"]
        path, worst = x["worst_grad"]
        dl = abs(x["loss"] - x["ref_loss"]) / abs(x["ref_loss"])
        dfl = abs(x["fwd_loss"] - x["ref_loss"]) / abs(x["ref_loss"])
        log(f"[mesh] embedding on {x['mesh']} rank {r}: {x['local_rows']} rows a table on this "
            f"rank; forward loss rel {dfl:.3g}, step loss {x['loss']:.6f} vs {x['ref_loss']:.6f} "
            f"(rel {dl:.3g}, bar {MESH_LOSS_REL}); worst gradient rel L2 {worst:.3g} at {path} "
            f"(bar {MESH_GRAD_REL_L2}); {_fmt_timed('forward', x['forward'])}, "
            f"{_fmt_timed('step', x['step'])} ({timing})")
        if not (dl <= MESH_LOSS_REL and dfl <= MESH_LOSS_REL and worst <= MESH_GRAD_REL_L2):
            bad.append(f"embedding rank {r}")
        x = res["pipeline"]
        dg = abs(x["gpipe_loss"] - x["gpipe_ref_loss"]) / abs(x["gpipe_ref_loss"])
        d1 = abs(x["1f1b_loss"] - x["1f1b_ref_loss"]) / abs(x["1f1b_ref_loss"])
        log(f"[mesh] pipeline on {x['mesh']} rank {r} (L {PIPE_LAYERS}, D {PIPE_WIDTH}, "
            f"{PIPE_ROWS} rows, n_micro {PIPE_MICRO}): GPipe output max |diff| "
            f"{x['out_max']:.3g} (bar {PIPE_OUT_ATOL}), loss rel {dg:.3g}, gradients rel L2 "
            f"{x['gpipe_grad']:.3g}; 1F1B loss rel {d1:.3g}, gradients rel L2 "
            f"{x['1f1b_grad']:.3g} (bars {MESH_LOSS_REL}, {MESH_GRAD_REL_L2}); "
            f"{_fmt_timed('GPipe forward', x['forward'])}, "
            f"{_fmt_timed('GPipe step', x['gpipe_step'])}, "
            f"{_fmt_timed('1F1B step', x['1f1b_step'])} ({timing})")
        if not (x["out_max"] <= PIPE_OUT_ATOL and max(dg, d1) <= MESH_LOSS_REL
                and max(x["gpipe_grad"], x["1f1b_grad"]) <= MESH_GRAD_REL_L2):
            bad.append(f"pipeline rank {r}")
    if bad:
        raise AssertionError(f"mesh paths disagree with one process: {bad}")

    # One process restores each state the world took, bit-exact.
    opt = T.make_optimizer()
    gen = torch.Generator().manual_seed(MESH_SEED + 9)
    targets = {
        "ssm": ("train", PL.init_state(gen, PL.SSMConfig(**SSM_CONFIG_KW), opt, DEVICE)),
        "embedding": ("train", PE.init_state(gen, PE.EmbeddingConfig(**EMBEDDING_CONFIG_KW),
                                             opt, DEVICE)),
        "pipe": ("m", {"params": {k: torch.zeros_like(v)
                                  for k, v in _pipe_params(DEVICE).items()}}),
    }
    for name, (key, dst) in targets.items():
        holder = StateDict(dst)
        t0 = time.perf_counter()
        Snapshot(f"{root}/{name}").restore({key: holder})
        dt = time.perf_counter() - t0
        want = ranks[0]["pipeline" if name == "pipe" else name]["digests"]
        got = _digests(dict(holder))
        if got != want:
            bad = sorted(p for p in want if got.get(p) != want[p])
            raise AssertionError(f"the world's {name} state did not restore bit-exact: {bad[:5]}")
        nbytes = ranks[0].get(name, {}).get("state_bytes")
        size = f"{nbytes} B, " if nbytes else ""
        log(f"[mesh] one process restored the world's {name} state ({size}{len(want)} leaves) "
            f"bit-exact in {dt * 1e3:.1f} ms")


TELEMETRY_MODES = ("off", "on", "flightrec off")
TELEMETRY_ROUNDS = 3


def _telemetry_mode(mode: str) -> None:
    """Set the knobs as a user would (``TORCHSNAPSHOT_GPU_TELEMETRY``,
    ``TORCHSNAPSHOT_GPU_FLIGHTREC``) and have both planes re-read them; no
    mode leaves them as they were."""
    from torchsnapshot_tpu_torch import telemetry
    from torchsnapshot_tpu_torch.telemetry import flightrec

    os.environ.pop("TORCHSNAPSHOT_GPU_TELEMETRY", None)
    os.environ.pop("TORCHSNAPSHOT_GPU_FLIGHTREC", None)
    if mode == "on":
        os.environ["TORCHSNAPSHOT_GPU_TELEMETRY"] = "1"
    elif mode == "flightrec off":
        os.environ["TORCHSNAPSHOT_GPU_FLIGHTREC"] = "0"
    telemetry.refresh_from_env()
    flightrec.refresh_from_env()


def phase_telemetry(root: str, state: dict, card: str) -> None:
    """Phase 18 (see the module docstring)."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict, faultinject, telemetry
    from torchsnapshot_tpu_torch.telemetry import flightrec

    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    app = {"state": StateDict(state)}
    dst = {k: torch.empty_like(v) for k, v in state.items()}
    times = {m: {"take": [], "restore": []} for m in TELEMETRY_MODES}
    kept = {}
    try:
        for r in range(TELEMETRY_ROUNDS):
            for mode in (TELEMETRY_MODES if r % 2 == 0 else TELEMETRY_MODES[::-1]):
                _telemetry_mode(mode)
                ring0 = flightrec.recorded_total()
                path = f"{root}/telemetry_{mode.replace(' ', '_')}_{r}"
                _sync()
                t0 = time.perf_counter()
                Snapshot.take(path, app)
                times[mode]["take"].append(time.perf_counter() - t0)
                for t in dst.values():
                    t.zero_()
                t0 = time.perf_counter()
                Snapshot(path).restore({"state": StateDict(dst)})
                _sync()
                times[mode]["restore"].append(time.perf_counter() - t0)
                if not all(torch.equal(dst[k], v) for k, v in state.items()):
                    raise AssertionError(f"telemetry {mode}: the restore is not bit-exact")
                recorded = flightrec.recorded_total() - ring0
                if (mode == "flightrec off") != (recorded == 0):
                    raise AssertionError(f"telemetry {mode}: {recorded} flight events recorded")
                files = set(os.listdir(path))
                if (telemetry.TELEMETRY_SUMMARY_FNAME in files) != (mode == "on"):
                    raise AssertionError(f"telemetry {mode}: snapshot files {sorted(files)}")
                if r == 0:
                    kept[mode] = path
                else:
                    shutil.rmtree(path)
        on = kept["on"]
        doc = json.load(open(os.path.join(on, telemetry.TELEMETRY_SUMMARY_FNAME)))
        trace_path = os.path.join(on, telemetry.trace_path_for_rank(0))
        trace = json.load(open(trace_path))
        summary = doc["ranks"][0]
        if summary["counters"].get("bytes_written") != nbytes:
            raise AssertionError(f"telemetry: bytes_written {summary['counters']} != {nbytes}")
        hists = sorted(summary.get("histograms", {}))
        spans = {k: v["count"] for k, v in summary["spans"].items()}
        log(f"[telemetry] {nbytes} B state ({len(state)} tensors on {DEVICE}) on {card}: "
            f".snapshot_telemetry {os.path.getsize(os.path.join(on, telemetry.TELEMETRY_SUMMARY_FNAME))}"
            f" B, Chrome trace {os.path.getsize(trace_path)} B with {len(trace['traceEvents'])} "
            f"events; phases {summary['phases']}; spans {spans}; histograms {hists}")
        for mode in TELEMETRY_MODES:
            tk, rs = times[mode]["take"], times[mode]["restore"]
            log(f"[telemetry] {mode:13s}: take " + ", ".join(f"{t * 1e3:.1f}" for t in tk)
                + " ms, restore " + ", ".join(f"{t * 1e3:.1f}" for t in rs)
                + f" ms ({TELEMETRY_ROUNDS} rounds in turns; take GB/s "
                + ", ".join(f"{nbytes / t / 1e9:.2f}" for t in tk) + ")")
        for path in kept.values():
            shutil.rmtree(path)

        # A take that a fault fails leaves the flight dump under .flight/.
        _telemetry_mode("off")
        fault = f"{root}/telemetry_fault"
        faultinject.configure("scheduler.stage@3=permanent")
        try:
            Snapshot.take(fault, app)
        except faultinject.InjectedPermanentError:
            pass
        else:
            raise AssertionError("the faulted take did not fail")
        finally:
            faultinject.disable()
        merged = flightrec.merge_timeline(flightrec.load_dumps(fault))
        aborts = [f for f in merged["findings"] if f["class"] == "abort"]
        log(f"[telemetry] a take failed by scheduler.stage@3=permanent left "
            f"{sorted(os.listdir(os.path.join(fault, '.flight')))} under .flight/: "
            f"{len(merged['events'])} events, findings {[f['class'] for f in merged['findings']]}")
        if not aborts:
            raise AssertionError("the flight dump names no abort")
        shutil.rmtree(fault)
    finally:
        _telemetry_mode("off")


JOURNAL_REPEATS = 5
MIRROR_ROUNDS = 3


def _journal_step_timed(mgr, step: int, app: dict) -> dict:
    """One ``journal_step`` with K4's launch count set to 0 just before it
    and read just after: its ms, the records and bytes it appended."""
    from torchsnapshot_tpu_torch import device_digest as dd
    from torchsnapshot_tpu_torch import journal

    dd.fingerprint_lanes.launches = 0
    _sync()
    t0 = time.perf_counter()
    if not mgr.journal_step(step, app):
        raise AssertionError(f"journal_step({step}) committed nothing")
    _sync()
    ms = (time.perf_counter() - t0) * 1e3
    meta = journal.read_epoch_metas(mgr._journal.dir)[-1]
    return {"ms": ms, "records": meta["records"]["0"], "bytes": mgr._journal.last_bytes,
            "k4": dd.fingerprint_lanes.launches, "epoch": meta["epoch"]}


def phase_durability(root: str, card: str) -> dict:
    """Phase 19 (see the module docstring). Returns K4's launches by step
    of the path."""
    from torchsnapshot_tpu_torch import (CheckpointManager, PreemptionWatcher, Snapshot, StateDict,
                                         georep, journal, simulate_preemption_now)
    from torchsnapshot_tpu_torch import device_digest as dd
    from torchsnapshot_tpu_torch.dedup import consolidate
    from torchsnapshot_tpu_torch.entry import train_entry
    from torchsnapshot_tpu_torch.storage_plugins import mirror as mirror_mod

    on_card = DEVICE == "cuda"

    def clone(st) -> dict:
        return {p: t.clone() for p, t in _flat(st).items()}

    def same(st, want: dict) -> bool:
        got = _flat(st)
        return got.keys() == want.keys() and all(torch.equal(got[p], want[p]) for p in want)

    def restore_fresh(restore) -> tuple:
        """A state from seed 1, restored by ``restore(app)``: (state, ms)."""
        _, (fresh, _) = train_entry(device=DEVICE, seed=1)
        holder = StateDict(fresh)
        _sync()
        t0 = time.perf_counter()
        restore({"train": holder})
        _sync()
        return dict(holder), (time.perf_counter() - t0) * 1e3

    def k4(label: str, fn):
        dd.fingerprint_lanes.launches = 0
        out = fn()
        _sync()
        launches[label] = dd.fingerprint_lanes.launches
        return out

    launches = {}
    torch.use_deterministic_algorithms(True)
    watcher = PreemptionWatcher()
    replay_ms = []
    real_replay = journal.maybe_replay

    def timed_replay(*args, **kwargs):
        _sync()
        t0 = time.perf_counter()
        out = real_replay(*args, **kwargs)
        _sync()
        replay_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    journal.maybe_replay = timed_replay
    try:
        train_step, (state, batch) = train_entry(device=DEVICE, seed=0)
        leaves = _flat(state)
        n_leaves = len(leaves)
        nbytes = sum(t.numel() * t.element_size() for t in leaves.values())
        floats = {p for p, t in leaves.items() if t.is_floating_point()}
        app = {"train": StateDict(state)}
        where = f"{n_leaves} leaves, {nbytes} B on {DEVICE}; {card}"

        # (a) The journal: a base, a step journaled, the unchanged state
        # journaled, one more step flushed by a preemption, then base plus
        # replay in a new manager.
        with _env(TORCHSNAPSHOT_GPU_JOURNAL="1"):
            jroot = f"{root}/journal"
            mgr = CheckpointManager(jroot, save_interval_steps=1000, preemption=watcher)
            _sync()
            t0 = time.perf_counter()
            k4("durability: journal base save(0) and baseline", lambda: mgr.save(0, app))
            base_ms = (time.perf_counter() - t0) * 1e3
            before = clone(state)
            train_step(state, batch)
            changed = {p for p, t in _flat(state).items() if not torch.equal(t, before[p])}
            del before
            first = _journal_step_timed(mgr, 1, app)
            launches["durability: journal_step after a train step"] = first["k4"]
            log(f"[durability] save(0) with TORCHSNAPSHOT_GPU_JOURNAL=1 ({where}): {base_ms:.1f} ms; "
                f"one train step, journal_step(1): {first['ms']:.1f} ms, {first['records']} records, "
                f"{first['bytes']} B appended, K4 launches {first['k4']} ({len(changed)} leaves "
                f"changed, {len(floats)} of them float)")
            if not floats <= changed or first["records"] != len(changed):
                raise AssertionError(f"journal_step(1) appended {first['records']} records; "
                                     f"{len(changed)} leaves changed")
            if on_card and first["k4"] != n_leaves:
                raise AssertionError(f"expected {n_leaves} K4 launches, got {first['k4']}")

            repeats = [_journal_step_timed(mgr, 2 + r, app) for r in range(JOURNAL_REPEATS)]
            launches["durability: journal_step of the unchanged state"] = sum(r["k4"] for r in repeats)
            ms = [r["ms"] for r in repeats]
            log(f"[durability] journal_step of the unchanged state, {JOURNAL_REPEATS} times: median "
                f"{statistics.median(ms):.2f} ms ({', '.join(f'{x:.2f}' for x in ms)}); records "
                f"{[r['records'] for r in repeats]}, bytes {[r['bytes'] for r in repeats]}, K4 "
                f"launches {[r['k4'] for r in repeats]}")
            if any(r["records"] or r["bytes"] for r in repeats):
                raise AssertionError("journal_step of an unchanged state appended records")
            if on_card and any(r["k4"] != n_leaves for r in repeats):
                raise AssertionError(f"expected {n_leaves} K4 launches a journal_step")

            train_step(state, batch)
            flushed = clone(state)
            simulate_preemption_now()
            dd.fingerprint_lanes.launches = 0
            _sync()
            t0 = time.perf_counter()
            saved = mgr.save(2 + JOURNAL_REPEATS, app)
            _sync()
            flush_ms = (time.perf_counter() - t0) * 1e3
            launches["durability: preemption flush"] = dd.fingerprint_lanes.launches
            epochs = journal.committed_epochs(journal.read_epoch_metas(mgr._journal.dir))
            seg = os.path.join(mgr._journal.dir, journal.segment_name(0))
            log(f"[durability] one more step, SIGTERM, save({2 + JOURNAL_REPEATS}): the journal "
                f"flushed epoch {epochs[-1]['epoch']} ({epochs[-1]['records']['0']} records, "
                f"{mgr._journal.last_bytes} B) in {flush_ms:.1f} ms instead of a full save; "
                f"committed steps {mgr.all_steps()}; segment {os.path.getsize(seg)} B over "
                f"{len(epochs)} epochs")
            if saved is not False or not watcher.consumed or mgr.all_steps() != [0]:
                raise AssertionError("the preemption did not flush the journal in place of a save")

            restored, restore_ms = restore_fresh(
                lambda a: k4("durability: restore (replay) and re-arm",
                             lambda: CheckpointManager(jroot, save_interval_steps=1000).restore(a)))
            if not same(restored, flushed):
                raise AssertionError("base plus replay is not bit-exact to the live state")
            _, loss_a = train_step(state, batch)
            _, loss_b = train_step(restored, batch)
            _sync()
            if not torch.equal(loss_a, loss_b) or not same(restored, clone(state)):
                raise AssertionError("the step after the replay is not bit-identical")
            log(f"[durability] a new manager restores step 0 plus {len(epochs)} epochs into seed "
                f"1's state: {restore_ms:.1f} ms, of which the replay {replay_ms[-1]:.1f} ms; "
                f"bit-exact; one more step from each: loss {loss_b.item():.6f}, every leaf "
                f"bit-identical")
            del restored

        # The bound: an epoch over TORCHSNAPSHOT_GPU_JOURNAL_EPOCH_BYTES is
        # a full save.
        with _env(TORCHSNAPSHOT_GPU_JOURNAL="1", TORCHSNAPSHOT_GPU_JOURNAL_EPOCH_BYTES=str(nbytes // 4)):
            bmgr = CheckpointManager(f"{root}/bound", save_interval_steps=1000)
            k4("durability: bound base save", lambda: bmgr.save(0, app))
            train_step(state, batch)
            _sync()
            t0 = time.perf_counter()
            ok = k4("durability: journal_step over the bound", lambda: bmgr.journal_step(1, app))
            bound_ms = (time.perf_counter() - t0) * 1e3
            jdir = os.path.join(bmgr.path_for(0), journal.JOURNAL_DIRNAME)
            log(f"[durability] TORCHSNAPSHOT_GPU_JOURNAL_EPOCH_BYTES={nbytes // 4}: a train step "
                f"later journal_step(1) took a full save in {bound_ms:.1f} ms; committed steps "
                f"{bmgr.all_steps()}, step 0's epochs {len(journal.read_epoch_metas(jdir))}")
            if not ok or bmgr.all_steps() != [0, 1] or journal.read_epoch_metas(jdir):
                raise AssertionError("the epoch bound did not turn the journal step into a full save")
            shutil.rmtree(f"{root}/bound")

        live = clone(state)
        # (b) The columnar manifest against the JSON one.
        meta_bytes, take_ms = {}, {}
        for fmt in ("json", "columnar"):
            path = f"{root}/manifest_{fmt}"
            with _env(TORCHSNAPSHOT_GPU_MANIFEST_FORMAT=fmt):
                _sync()
                t0 = time.perf_counter()
                Snapshot.take(path, app)
                take_ms[fmt] = (time.perf_counter() - t0) * 1e3
            with open(os.path.join(path, ".snapshot_metadata"), "rb") as f:
                raw = f.read()
            meta_bytes[fmt] = len(raw)
            if (raw[:4] == b"TSCM") != (fmt == "columnar"):
                raise AssertionError(f"the {fmt} take wrote metadata starting {raw[:4]!r}")
            got, ms = restore_fresh(lambda a, p=path: Snapshot(p).restore(a))
            if not same(got, live):
                raise AssertionError(f"the {fmt} snapshot did not restore bit-exact")
            log(f"[durability] take with TORCHSNAPSHOT_GPU_MANIFEST_FORMAT={fmt}: metadata "
                f"{meta_bytes[fmt]} B (starts {raw[:4]!r}), take {take_ms[fmt]:.1f} ms, restore "
                f"{ms:.1f} ms, bit-exact")
            shutil.rmtree(path)

        # (c) The mirror: takes with a strict mirror and without, in turns;
        # then the primary loses its payloads and the mirror restores.
        times = {"plain": [], "mirrored": []}
        for r in range(MIRROR_ROUNDS):
            for kind in (("plain", "mirrored") if r % 2 == 0 else ("mirrored", "plain")):
                path = f"{root}/mirror_{kind}_{r}"
                opts = {"mirror_url": f"{root}/mirror_tier_{r}", "mirror_strict": True}
                _sync()
                t0 = time.perf_counter()
                Snapshot.take(path, app, storage_options=opts if kind == "mirrored" else None)
                times[kind].append((time.perf_counter() - t0) * 1e3)
                if r < MIRROR_ROUNDS - 1 or kind == "plain":
                    shutil.rmtree(path)
                    shutil.rmtree(opts["mirror_url"], ignore_errors=True)
        path, mroot = f"{root}/mirror_mirrored_{MIRROR_ROUNDS - 1}", f"{root}/mirror_tier_{MIRROR_ROUNDS - 1}"
        files, stored = _payload_files(path)
        for dirpath, _, names in os.walk(path):
            for name in names:
                if name != ".snapshot_metadata":
                    os.remove(os.path.join(dirpath, name))
        failovers0 = mirror_mod.failover_counts["mirror_failovers"]
        got, ms = restore_fresh(
            lambda a: Snapshot(path, storage_options={"mirror_url": mroot}).restore(a))
        failovers = mirror_mod.failover_counts["mirror_failovers"] - failovers0
        log(f"[durability] takes in turns, {MIRROR_ROUNDS} rounds: plain "
            f"{', '.join(f'{x:.1f}' for x in times['plain'])} ms; with a strict mirror on a second "
            f"root {', '.join(f'{x:.1f}' for x in times['mirrored'])} ms (median "
            f"{statistics.median(times['plain']):.1f} vs {statistics.median(times['mirrored']):.1f}); "
            f"the primary's {files} payload files ({stored} B) deleted: restore onto {DEVICE} "
            f"from the mirror {ms:.1f} ms, bit-exact, mirror.failover count {failovers}")
        if not same(got, live) or failovers < files:
            raise AssertionError(f"the mirror restore failed over {failovers} times for {files} "
                                 "lost payloads, or is not bit-exact")
        shutil.rmtree(path)
        shutil.rmtree(mroot)

        # (d) Consolidate (a)'s journaled chain.
        flat = f"{root}/consolidated"
        t0 = time.perf_counter()
        copied = consolidate(mgr.path_for(0), flat)
        cons_ms = (time.perf_counter() - t0) * 1e3
        got, ms = restore_fresh(lambda a: Snapshot(flat).restore(a))
        log(f"[durability] consolidate of step 0 plus its {len(epochs)} epochs: {copied} payload "
            f"files in {cons_ms:.1f} ms, no journal left; its restore {ms:.1f} ms, bit-exact to "
            f"the flushed state")
        if not same(got, flushed) or os.path.isdir(os.path.join(flat, journal.JOURNAL_DIRNAME)):
            raise AssertionError("the consolidated chain is not bit-exact to the flushed state")
        shutil.rmtree(flat)
        shutil.rmtree(jroot)
        del got, flushed

        # (e) Geo-replication to a third root, then the loss of the primary.
        remote = f"{root}/remote"
        with _env(TORCHSNAPSHOT_GPU_JOURNAL="1", TORCHSNAPSHOT_GPU_GEOREP=remote,
                  TORCHSNAPSHOT_GPU_GEOREP_INTERVAL_S="0.05"):
            shipped0 = georep.counts["georep_bytes_shipped"]
            gmgr = CheckpointManager(f"{root}/geo", save_interval_steps=1000)
            k4("durability: georep save", lambda: gmgr.save(0, app))
            train_step(state, batch)
            k4("durability: georep journal_step", lambda: gmgr.journal_step(1, app))
            lag_before = gmgr._georep.lag_s()
            t0 = time.perf_counter()
            drained = gmgr._georep.drain(120.0)
            drain_ms = (time.perf_counter() - t0) * 1e3
            lag_after = gmgr._georep.lag_s()
            shipped = georep.counts["georep_bytes_shipped"] - shipped0
            gmgr.close()
            if not drained:
                raise AssertionError(f"georep did not drain: {gmgr._georep and gmgr._georep.last_error}")
        live = clone(state)
        shutil.rmtree(f"{root}/geo")  # the region is lost
        dr0 = georep.counts["dr_replica_restores"]
        remote_step = f"{remote}/step_0000000000"
        got, ms = restore_fresh(lambda a: Snapshot(remote_step).restore(a))
        dr = georep.counts["dr_replica_restores"] - dr0
        cursor = georep.read_cursor(remote_step)
        log(f"[durability] TORCHSNAPSHOT_GPU_GEOREP: save(0), a step, journal_step(1): replication "
            f"lag {lag_before * 1e3:.1f} ms before the drain, {lag_after * 1e3:.1f} ms after; drain "
            f"{drain_ms:.1f} ms; {shipped} B shipped; cursor {cursor}; primary deleted: "
            f"Snapshot(remote step).restore onto {DEVICE} {ms:.1f} ms, bit-exact, "
            f"dr_replica_restores {dr}")
        if not same(got, live) or dr != 1:
            raise AssertionError("the geo-replicated restore is not bit-exact, or was not counted")
        shutil.rmtree(remote)
        return launches
    finally:
        journal.maybe_replay = real_replay
        watcher.close()
        torch.use_deterministic_algorithms(False)


FLEET_REPLICAS = 4
FLEET_TTFI_ROUNDS = 2
FLEET_TIMEOUT_S = 600.0
FLEET_HOT = r"^train/params/"
FLEET_STORAGE_BAR = 1.2


def _fleet_digests(state) -> dict:
    """{logical path: sha256 of the leaf's bytes} (non-tensors by repr)."""
    import hashlib

    out = {}
    for path, leaf in _flat(state).items():
        if isinstance(leaf, torch.Tensor):
            raw = leaf.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()
            out[path] = hashlib.sha256(raw.tobytes()).hexdigest()
        else:
            out[path] = repr(leaf)
    return out


def _store_wait(store, key: str, procs=(), timeout: float = FLEET_TIMEOUT_S) -> bytes:
    """Poll ``key`` until it is set; fail if a process of ``procs`` died."""
    deadline = time.monotonic() + timeout
    while not store.check(key):
        dead = [p for p in procs if p.exitcode not in (None, 0)]
        if dead:
            raise AssertionError(f"a fleet process exited with {dead[0].exitcode} before {key}")
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {key}")
        time.sleep(0.01)
    return bytes(store.get(key))


def _resolve_futures(obj):
    """A state tree with every ``pagein.LeafFuture`` replaced by its value."""
    from torchsnapshot_tpu_torch.pagein import LeafFuture

    if isinstance(obj, LeafFuture):
        return obj.result(timeout=FLEET_TIMEOUT_S)
    if isinstance(obj, dict):
        return {k: _resolve_futures(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_resolve_futures(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_resolve_futures(v) for v in obj)
    return obj


def _fleet_replica(rank: int, port: int, root: str, device: str, results) -> None:
    """One serving replica of phase 20 (a spawned process): restore under
    the seeding tier, serve a forward, then apply pushed epochs and answer
    the trainer's checks until told to exit."""
    import traceback

    global DEVICE
    DEVICE = device
    try:
        os.environ["TORCHSNAPSHOT_GPU_SEED_RESTORE"] = "always"
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.use_deterministic_algorithms(True)
        from torchsnapshot_tpu_torch import Snapshot, StateDict, distrib, telemetry
        from torchsnapshot_tpu_torch.dist_store import TCPStore
        from torchsnapshot_tpu_torch.entry import ENTRY_CONFIG, train_entry
        from torchsnapshot_tpu_torch.models import transformer as T
        from torchsnapshot_tpu_torch.ops import flash_attention as fa
        from torchsnapshot_tpu_torch.storage_plugins import fs as fs_mod

        def client():
            return TCPStore("127.0.0.1", port, is_server=False, timeout=60.0)

        distrib.configure_registry(client)
        store = client()
        telemetry.set_enabled(True)
        stored = [0]
        real_read = fs_mod.FSStoragePlugin.read

        async def counted(self, read_io):
            await real_read(self, read_io)
            stored[0] += memoryview(read_io.buf).nbytes

        fs_mod.FSStoragePlugin.read = counted
        _, (state, _) = train_entry(device=device, seed=1)
        holder = StateDict(state)
        if rank > 0:
            _store_wait(store, "p20/seeded")
        _sync()
        t0 = time.perf_counter()
        Snapshot(f"{root}/step_0000000000").restore({"train": holder})
        _sync()
        restore_ms = (time.perf_counter() - t0) * 1e3
        if rank == 0:
            store.set("p20/seeded", b"1")
        counters = telemetry.counters()
        tokens = torch.load(f"{root}/p20_tokens.pt").to(device)
        fa.flash_fwd.launches = 0
        with torch.inference_mode():
            logits = T.forward(holder["params"], tokens, ENTRY_CONFIG)
        _sync()
        report = {
            "restore_ms": restore_ms,
            "storage_bytes": stored[0],
            "bytes_from_seeders": counters.get("bytes_from_seeders", 0),
            "seed_cache_hits": counters.get("seed_cache_hits", 0),
            "fallbacks": counters.get("fanout_fallbacks", 0),
            "depths": sorted(set(distrib.session()._registered.values())),
            "k1": fa.flash_fwd.launches,
            "logits_equal": torch.equal(logits.cpu(), torch.load(f"{root}/p20_logits.pt")),
        }
        with open(f"{root}/p20_digests_0.json") as f:
            report["exact"] = _fleet_digests(holder.data) == json.load(f)
        rx = distrib.UpdateReceiver(client(), {"train": holder}, base_step=0)
        store.set(f"p20/ready/{rank}", json.dumps(report).encode())
        n = 0
        while True:
            cmd = json.loads(_store_wait(store, f"p20/cmd/{n}"))
            if cmd["op"] == "exit":
                break
            _sync()
            with open(cmd["digests"]) as f:
                want = json.load(f)
            store.set(f"p20/res/{n}/{rank}", json.dumps(
                {"equal": _fleet_digests(holder.data) == want, "epochs": rx.epochs_applied}).encode())
            n += 1
        rx.close()
        distrib.reset_session()
        results.put((rank, report))
    except BaseException:  # noqa: BLE001 - reported to the trainer
        results.put((rank, {"error": traceback.format_exc()}))


def phase_fleet(root: str, card: str):
    """Phase 20 (see the module docstring). Returns the flash kernels'
    launches over the phase (the replicas' forwards included) and K4's
    launches by step of the path."""
    import multiprocessing as mp
    import threading

    from torchsnapshot_tpu_torch import (CheckpointManager, Snapshot, StateDict, distrib,
                                         faultinject, pagein, tenancy)
    from torchsnapshot_tpu_torch import device_digest as dd
    from torchsnapshot_tpu_torch.dist_store import TCPStore
    from torchsnapshot_tpu_torch.entry import ENTRY_CONFIG, train_entry
    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.tenancy import admission, pool
    from torchsnapshot_tpu_torch.tenancy.quota import QuotaExceededError

    on_card = DEVICE == "cuda"
    os.makedirs(root)
    torch.use_deterministic_algorithms(True)
    _reset_launch_counts()
    k4 = {}
    server = TCPStore("127.0.0.1", is_server=True, timeout=60.0)

    def client():
        return TCPStore("127.0.0.1", server.port, is_server=False, timeout=60.0)

    store = client()
    procs = []
    replica_k1 = 0
    try:
        distrib.configure_registry(client)
        train_step, (state, batch) = train_entry(device=DEVICE, seed=0)
        app = {"train": StateDict(state)}
        leaves = _flat(state)
        nbytes = sum(t.numel() * t.element_size() for t in leaves.values())
        where = f"{len(leaves)} leaves, {nbytes} B on {DEVICE}; {card}"

        def forward(params):
            with torch.inference_mode():
                return T.forward(params, batch["tokens"], ENTRY_CONFIG)

        def counted_k4(label: str, fn):
            dd.fingerprint_lanes.launches = 0
            out = fn()
            _sync()
            k4[label] = dd.fingerprint_lanes.launches
            return out

        def check(n: int, digests: dict, label: str) -> list:
            path = f"{root}/p20_check_{n}.json"
            with open(path, "w") as f:
                json.dump(digests, f)
            store.set(f"p20/cmd/{n}", json.dumps({"op": "check", "digests": path}).encode())
            out = [json.loads(_store_wait(store, f"p20/res/{n}/{r}", procs))
                   for r in range(FLEET_REPLICAS)]
            log(f"[fleet] check {n} ({label}): replicas equal {[o['equal'] for o in out]}, "
                f"epochs applied {[o['epochs'] for o in out]}")
            return out

        with _env(TORCHSNAPSHOT_GPU_JOURNAL="1"):
            mgr = CheckpointManager(root, save_interval_steps=1000, replicated=["**"])
            counted_k4("fleet: journal base save(0)", lambda: mgr.save(0, app))
            torch.save(batch["tokens"].cpu(), f"{root}/p20_tokens.pt")
            torch.save(forward(state["params"]).cpu(), f"{root}/p20_logits.pt")
            with open(f"{root}/p20_digests_0.json", "w") as f:
                json.dump(_fleet_digests(state), f)

            # (a) Seeding: replica 0 reads storage, 1-3 restore together.
            ctx = mp.get_context("spawn")
            results = ctx.Queue()
            procs = [ctx.Process(target=_fleet_replica,
                                 args=(r, server.port, mgr.root, DEVICE, results))
                     for r in range(FLEET_REPLICAS)]
            for proc in procs:
                proc.start()
            ready = [json.loads(_store_wait(store, f"p20/ready/{r}", procs))
                     for r in range(FLEET_REPLICAS)]
            stored = sum(r["storage_bytes"] for r in ready)
            replica_k1 = sum(r["k1"] for r in ready)
            log(f"[fleet] (a) {FLEET_REPLICAS} replicas restore the replicated state ({where}) under "
                f"TORCHSNAPSHOT_GPU_SEED_RESTORE=always, replica 0 first: storage bytes "
                f"{[r['storage_bytes'] for r in ready]} = {stored / nbytes:.3f} x the state "
                f"(direct reads {FLEET_REPLICAS:.1f} x); bytes_from_seeders "
                f"{[r['bytes_from_seeders'] for r in ready]}; seed_cache_hits "
                f"{[r['seed_cache_hits'] for r in ready]}; fallbacks "
                f"{[r['fallbacks'] for r in ready]}; tree depths {[r['depths'] for r in ready]}; "
                f"restore ms {[round(r['restore_ms'], 1) for r in ready]}; each serves one forward: "
                f"K1 launches {[r['k1'] for r in ready]}, logits bit-identical to the trainer's "
                f"{[r['logits_equal'] for r in ready]}, leaves bit-exact {[r['exact'] for r in ready]}")
            if not all(r["exact"] and r["logits_equal"] for r in ready):
                raise AssertionError("a seeded replica is not bit-exact to the trainer")
            if stored > FLEET_STORAGE_BAR * nbytes:
                raise AssertionError(f"the fleet read {stored / nbytes:.3f} x the state from storage")
            if on_card and any(r["k1"] != ENTRY_CONFIG.n_layers for r in ready):
                raise AssertionError("a replica's forward did not launch K1 once a layer")

            # (b) The rolling update.
            train_step(state, batch)
            _sync()
            t0 = time.perf_counter()
            if not counted_k4("fleet: journal_step(1) before push_update",
                              lambda: mgr.journal_step(1, app)):
                raise AssertionError("journal_step(1) committed no epoch")
            journal_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            out = mgr.push_update()
            push_ms = (time.perf_counter() - t0) * 1e3
            res = check(0, _fleet_digests(state), "after the push")
            log(f"[fleet] (b) a train step, journal_step(1) in {journal_ms:.1f} ms (K4 launches "
                f"{k4['fleet: journal_step(1) before push_update']}), push_update: {out['epochs']} epochs to "
                f"{out['replicas']} replicas, {out['bytes']} B, {out['nacks']} nacks, "
                f"{push_ms:.1f} ms")
            if out["replicas"] != FLEET_REPLICAS or out["nacks"] or not all(
                    r["equal"] and r["epochs"] == 1 for r in res):
                raise AssertionError("the push did not converge every replica")
            if on_card and k4["fleet: journal_step(1) before push_update"] != len(leaves):
                raise AssertionError(f"expected {len(leaves)} K4 launches in journal_step")
            again = mgr.push_update()
            mgr._push_cursor.clear()
            dup = mgr.push_update()
            res = check(1, _fleet_digests(state), "after a duplicated push")
            log(f"[fleet] (b) a second push: {again['epochs']} epochs, {again['bytes']} B; with "
                f"the cursor cleared: {dup['epochs']} epochs acknowledged, {dup['nacks']} nacks, "
                f"applied nothing")
            if again["epochs"] or dup["epochs"] != FLEET_REPLICAS or dup["nacks"] or not all(
                    r["equal"] and r["epochs"] == 1 for r in res):
                raise AssertionError("a repeated push shipped epochs or applied one twice")
            before = _fleet_digests(state)
            train_step(state, batch)
            if not counted_k4("fleet: journal_step(2)", lambda: mgr.journal_step(2, app)):
                raise AssertionError("journal_step(2) committed no epoch")
            after = _fleet_digests(state)
            faultinject.configure("distrib.epoch_push@1=corrupt")
            try:
                bad = mgr.push_update()
            finally:
                faultinject.disable()
            res = check(2, after, "after a push with one corrupted frame")
            stale = [r for r in range(FLEET_REPLICAS) if not res[r]["equal"]]
            held = check(3, before, "the nacked replica holds the earlier state")
            fixed = mgr.push_update()
            res = check(4, after, "after the next push")
            log(f"[fleet] (b) another step and journal_step(2); the first frame of the push "
                f"corrupted: {bad['nacks']} nack, {bad['epochs']} epochs applied elsewhere, "
                f"replica(s) {stale} kept the earlier state; the next push: {fixed['epochs']} "
                f"epoch(s), every replica equal {[r['equal'] for r in res]}")
            if bad["nacks"] != 1 or len(stale) != 1 or not held[stale[0]]["equal"]:
                raise AssertionError("the corrupted frame was not nacked before apply")
            if fixed["epochs"] != 1 or not all(r["equal"] and r["epochs"] == 2 for r in res):
                raise AssertionError("the push after the nack did not converge")
            store.set(f"p20/cmd/5", json.dumps({"op": "exit"}).encode())
            for _ in procs:
                rank, report = results.get(timeout=FLEET_TIMEOUT_S)
                if "error" in report:
                    raise AssertionError(f"replica {rank} failed:\n{report['error']}")
            for proc in procs:
                proc.join(timeout=60)
            mgr.close()

        # (c) Page-in against eager, in turns.
        snap = f"{root}/lazy/step_0000000000"
        Snapshot.take(snap, app)
        live = {p: t.clone() for p, t in _flat(state).items()}

        def restore_into(lazy: bool, hot=None, mode: str = "always"):
            _, (fresh, _) = train_entry(device=DEVICE, seed=1)
            holder = StateDict(fresh)
            env = {"TORCHSNAPSHOT_GPU_LAZY_RESTORE": mode if lazy else "never"}
            with _env(**env):
                _sync()
                t0 = time.perf_counter()
                sess = Snapshot(snap).restore({"train": holder}, hot=hot)
                returned = (time.perf_counter() - t0) * 1e3
                frac = [(returned, sess.resident_fraction() if sess else 1.0)]
                # Hot params are tensors already; a cold one faults here.
                logits = forward(_resolve_futures(holder["params"]))
                _sync()
                ttfi = (time.perf_counter() - t0) * 1e3
                if sess is not None:
                    frac.append((ttfi, sess.resident_fraction()))
                    while not sess.done():
                        time.sleep(0.005)
                        frac.append(((time.perf_counter() - t0) * 1e3, sess.resident_fraction()))
                    sess.wait(timeout=FLEET_TIMEOUT_S)
            return sess, _resolve_futures(dict(holder)), logits, returned, ttfi, frac

        ttfi = {"eager": [], "lazy": []}
        for r in range(FLEET_TTFI_ROUNDS):
            for kind in (("eager", "lazy") if r % 2 == 0 else ("lazy", "eager")):
                sess, got, logits, returned, t, frac = restore_into(kind == "lazy", [FLEET_HOT])
                ttfi[kind].append(t)
                if kind == "lazy":
                    if sess is None:
                        raise AssertionError("the lazy election did not engage")
                    log(f"[fleet] (c) lazy restore round {r}: returned {returned:.1f} ms with "
                        f"resident_fraction {frac[0][1]:.3f}; first forward done at {t:.1f} ms; "
                        f"resident_fraction over time (ms, fraction) "
                        f"{[(round(a, 1), round(b, 3)) for a, b in frac[:: max(1, len(frac) // 8)]]}"
                        f" ... ({frac[-1][0]:.1f}, {frac[-1][1]:.3f}); deferred leaves "
                        f"{len(sess._units)}")
                    lazy_got, lazy_logits = got, logits
                else:
                    eager_got, eager_logits = got, logits
        flat_lazy, flat_eager = _flat(lazy_got), _flat(eager_got)
        if flat_lazy.keys() != flat_eager.keys() or not all(
                torch.equal(flat_lazy[p], flat_eager[p]) for p in flat_eager):
            raise AssertionError("the paged-in state is not bit-exact to the eager restore")
        if not torch.equal(lazy_logits, eager_logits) or not all(
                torch.equal(flat_eager[p], live[p]) for p in live):
            raise AssertionError("the restores disagree with the live state")
        _, loss_lazy = train_step(lazy_got, batch)
        _, loss_eager = train_step(eager_got, batch)
        _sync()
        if not torch.equal(loss_lazy, loss_eager) or not all(
                torch.equal(a, b) for a, b in zip(_flat(lazy_got).values(), _flat(eager_got).values())):
            raise AssertionError("the step after the lazy restore is not bit-identical")
        del lazy_got, eager_got, flat_lazy, flat_eager
        log(f"[fleet] (c) time to first inference (restore + one forward, K1) in turns, "
            f"{FLEET_TTFI_ROUNDS} rounds: eager {[round(x, 1) for x in ttfi['eager']]} ms, lazy "
            f"with hot set {FLEET_HOT!r} {[round(x, 1) for x in ttfi['lazy']]} ms; after wait() "
            f"every leaf bit-exact to the eager restore; the next train step bit-identical "
            f"(loss {loss_lazy.item():.6f})")
        with _env(TORCHSNAPSHOT_GPU_PAGEIN_PREFETCH="0", TORCHSNAPSHOT_GPU_LAZY_RESTORE="always"):
            _, (fresh, _) = train_entry(device=DEVICE, seed=1)
            sess = Snapshot(snap).restore({"train": StateDict(fresh)}, hot=[FLEET_HOT])
            touched = sess.pending_paths()[::-1][:3]
            for path in touched:
                sess.fault(path, timeout=FLEET_TIMEOUT_S)
            sess.wait(timeout=FLEET_TIMEOUT_S)
        sess, got, _, returned, t, _ = restore_into(True, None, mode="auto")
        order = sess.prefetch_order() if sess is not None else []
        log(f"[fleet] (c) a demand-only restore touched {touched}; a second restore under "
            f"LAZY_RESTORE=auto with no hot set engaged {sess is not None}, prefetch order "
            f"starts {order[:3]}, first forward at {t:.1f} ms")
        if order[:3] != touched or not all(torch.equal(a, live[p]) for p, a in _flat(got).items()):
            raise AssertionError("the learned first-touch order was not replayed")
        del got

        # (d) Tenancy: two tenants on one root.
        troot = f"{root}/tenants_root"
        alpha = tenancy.Tenant(id="alpha", priority=3)
        beta = tenancy.Tenant(id="beta", priority=1)
        ma = CheckpointManager(troot, tenant=alpha, incremental=True)
        ma.save(0, app)
        pool_a = pool.pool_bytes(troot)
        mb = CheckpointManager(troot, tenant=beta, incremental=True)
        mb.save(0, app)
        pool_b = pool.pool_bytes(troot) - pool_a
        # Gamma's steps are not swept into the pool (no digests), so they
        # count against its quota, and replicated, so a restore seeds.
        gamma = tenancy.Tenant(id="gamma", quota_bytes=nbytes // 2)
        mg = CheckpointManager(troot, tenant=gamma, replicated=["**"])
        mg.save(0, app)
        try:
            mg.save(1, app)
            refused = False
        except QuotaExceededError:
            refused = True
        left = os.path.exists(mg.path_for(1))

        class Recording:
            def __init__(self, inner):
                self.inner, self.reads, self.writes = inner, set(), set()

            def __getattr__(self, name):
                attr = getattr(self.inner, name)
                if name in ("get", "check", "collect", "wait", "wait_any"):
                    def read(key, *a, **kw):
                        for k in key if isinstance(key, list) else [key]:
                            self.reads.add(k)
                        return attr(key, *a, **kw)
                    return read
                if name in ("set", "add", "delete"):
                    def write(key, *a, **kw):
                        self.writes.add(key)
                        return attr(key, *a, **kw)
                    return write
                return attr

        recorders = {}

        def recorded(tid):
            def factory():
                recorders.setdefault(tid, []).append(Recording(client()))
                return recorders[tid][-1]
            return factory

        exact = {}
        for mgr_t in (ma, mb, mg):
            distrib.reset_session()
            distrib.configure_registry(recorded(mgr_t._tenant.id))
            with _env(TORCHSNAPSHOT_GPU_SEED_RESTORE="always"):
                _, (fresh, _) = train_entry(device=DEVICE, seed=1)
                holder = StateDict(fresh)
                mgr_t.restore({"train": holder})
            exact[mgr_t._tenant.id] = all(torch.equal(a, live[p])
                                          for p, a in _flat(dict(holder)).items())
            del holder, fresh
        reads = {t: set().union(*(r.reads for r in recs)) for t, recs in recorders.items()}
        outside = sorted(k for t, keys in reads.items() for k in keys
                         if not k.startswith(f"tsnap/t/{t}/"))
        shares = {"alpha": [], "beta": []}
        real_scale = admission.AdmissionSession.scale_concurrency

        def scale(self, base):
            shares[self.tenant.id].append(self.share())
            return real_scale(self, base)

        admission.AdmissionSession.scale_concurrency = scale
        errors = []

        def take(tenant, path):
            try:
                with tenancy.activated(tenant):
                    Snapshot.take(path, app)
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        try:
            threads = [threading.Thread(target=take, args=(t, f"{root}/adm_{t.id}"))
                       for t in (alpha, beta)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            adm_ms = (time.perf_counter() - t0) * 1e3
        finally:
            admission.AdmissionSession.scale_concurrency = real_scale
        if errors:
            raise errors[0]
        ratio = (statistics.mean(shares["alpha"]) / statistics.mean(shares["beta"])
                 if shares["alpha"] and shares["beta"] else float("nan"))
        log(f"[fleet] (d) tenants alpha and beta on one root: alpha's take pooled {pool_a} B; "
            f"beta's take of the identical state added {pool_b} B to the pool; gamma (quota "
            f"{nbytes // 2} B) save(1) refused {refused}, step directory left {left}; seeded "
            f"restores bit-exact {exact}; store keys their seeded restores read "
            f"{ {t: len(k) for t, k in reads.items()} }, "
            f"outside each tenant's tsnap/t/<tenant>/ {outside}; two concurrent takes at priorities 3:1 in {adm_ms:.1f} ms: "
            f"admission shares alpha {[round(x, 3) for x in shares['alpha']]}, beta "
            f"{[round(x, 3) for x in shares['beta']]}, ratio {ratio:.3f}")
        if pool_b != 0 or not refused or left or not all(exact.values()) or outside or not reads.get("gamma"):
            raise AssertionError("a tenancy bar failed")
        ma.close()
        mb.close()
        mg.close()
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=30)
        distrib.reset_session()
        distrib.configure_registry(None)
        store.close()
        server.close()
        torch.use_deterministic_algorithms(False)
    launches = _launch_counts()
    launches["flash_fwd"] += replica_k1
    return launches, k4


# ------------------------------------------------------ phase 21: planes

PLANES_PROGRESS_S = "0.05"
PLANES_SCRAPE_S = 0.02
AUTOTUNE_SAVES = 8
AUTOTUNE_CHANGED_LEAVES = 3
# Each payload write of the autotune saves waits this long first (fence,
# metadata and telemetry files do not): storage binds those saves, so the
# closed loop arms its trials.
AUTOTUNE_WRITE_DELAY_S = 0.2
# The saves fingerprint every leaf on the card (K4); a CPU rehearsal turns
# this off, since the plain fingerprint of the state takes seconds there.
AUTOTUNE_DEVICE_DIGESTS = True
FORENSIC_QUICK_OPS = 16
FORENSIC_DELAY_S = 1.5
FORENSIC_SAMPLE_S = "0.1"
CLOUD_PART_BYTES = 8 << 20
CLOUD_BACKOFF_S = 0.05


def _metrics_get(port: int) -> str:
    """One ``GET /metrics`` on this host (http.client: no proxy applies)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        conn.request("GET", "/metrics")
        return conn.getresponse().read().decode("utf-8")
    finally:
        conn.close()


def _byte_samples(text: str) -> dict:
    """The byte gauges and counters of one exposition, by family."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name, value = line.rsplit(" ", 1)
        family = name.split("{", 1)[0]
        if "bytes" in family and not family.endswith(("_bucket", "_count", "_sum")):
            out[family] = float(value)
    return out


def _categories(attr: dict) -> str:
    wall = attr.get("wall_s_max") or 0.0
    return ", ".join(f"{c} {v:.3f} s ({v / wall:.1%})" if wall else f"{c} {v:.3f} s"
                     for c, v in sorted(attr["categories"].items(), key=lambda kv: -kv[1]))


def _planes_attribution(root: str, card: str) -> None:
    """(a) attribution and (d) /metrics on phase 12's state."""
    import threading

    from torchsnapshot_tpu_torch import Snapshot, StateDict, telemetry
    from torchsnapshot_tpu_torch.telemetry import critpath, history, promexp

    state = _big_state()
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    path = f"{root}/planes"
    scrapes = []
    with _env(TORCHSNAPSHOT_GPU_TELEMETRY="1", TORCHSNAPSHOT_GPU_PROGRESS_S=PLANES_PROGRESS_S,
              TORCHSNAPSHOT_GPU_METRICS_PORT="0"):
        telemetry.refresh_from_env()
        try:
            exporter = promexp.maybe_start(rank=0)
            if exporter is None:
                raise AssertionError("TORCHSNAPSHOT_GPU_METRICS_PORT=0 started no exporter")
            stop = threading.Event()

            def scrape() -> None:
                while not stop.is_set():
                    t = time.perf_counter()
                    try:
                        text = _metrics_get(exporter.port)
                    except OSError as e:
                        text = f"error {e!r}"
                    scrapes.append((t, time.perf_counter(), text))
                    stop.wait(PLANES_SCRAPE_S)

            scraper = threading.Thread(target=scrape, name="metrics-scraper", daemon=True)
            _sync()
            scraper.start()
            t0 = time.perf_counter()
            Snapshot.take(path, {"model": StateDict(state)})
            t1 = time.perf_counter()
            stop.set()
            scraper.join(timeout=10)
            take = telemetry.last_attribution()
            dst = {k: torch.zeros_like(t) for k, t in state.items()}
            _sync()
            t2 = time.perf_counter()
            Snapshot(path).restore({"model": StateDict(dst)})
            _sync()
            t3 = time.perf_counter()
            restore = telemetry.last_attribution()
        finally:
            promexp.stop_exporter()
    telemetry.refresh_from_env()
    if not all(torch.equal(dst[k], t) for k, t in state.items()):
        raise AssertionError("planes (a): the restore is not bit-exact")
    for op, attr, secs in (("take", take, t1 - t0), ("restore", restore, t3 - t2)):
        b = attr["binding"]
        log(f"[planes] (a) {op} of {nbytes} B in {secs * 1e3:.1f} ms: {attr['verdict']}, "
            f"binding {b['category']} ({b['class']}, share {b.get('share')}, "
            f"{b.get('gbps')} GB/s over its window); critical wall "
            f"{attr['critical_wall_s']:.3f} s; {_categories(attr)}; on {card}")
        idle = attr["categories"].get("sched_idle", 0.0) / attr["wall_s_max"]
        if idle >= 0.5:
            raise AssertionError(f"planes (a): sched_idle is {idle:.1%} of the {op}'s wall")
    if not os.path.isfile(os.path.join(path, critpath.ATTRIBUTION_FNAME)):
        raise AssertionError("planes (a): the take wrote no .snapshot_critpath")
    if take["categories"].get("stage_copy", 0.0) <= 0:
        raise AssertionError("planes (a): the take attributes no time to stage_copy")
    if restore["categories"].get("decode", 0.0) <= 0:
        raise AssertionError("planes (a): the restore attributes no time to decode")
    rec = [r for r in history.load_history(root)
           if r.get("op") == "take" and r.get("snapshot") == os.path.basename(path)][-1]
    if rec.get("binding") != take["binding"]["category"]:
        raise AssertionError(f"planes (a): the history record's binding {rec.get('binding')!r} "
                             f"is not the take's {take['binding']['category']!r}")
    log(f"[planes] (a) .snapshot_critpath written; the history record's binding "
        f"{rec['binding']} ({rec.get('binding_gbps')} GB/s) equals the take's")
    during = [text for a, b, text in scrapes if a >= t0 and b <= t1]
    live = [text for text in during
            if any(v > 0 for v in _byte_samples(text).values()) and 'phase="' in text]
    if not all(text.endswith("# EOF\n") for _, _, text in scrapes):
        raise AssertionError("planes (d): an exposition does not end with # EOF")
    if not live:
        raise AssertionError(f"planes (d): none of {len(during)} scrapes during the take showed "
                             "a non-zero bytes sample and the phase")
    samples = _byte_samples(live[-1])
    phase = live[-1].split('phase="', 1)[1].split('"', 1)[0]
    log(f"[planes] (d) /metrics: {len(scrapes)} scrapes, {len(during)} while the take ran, "
        f"{len(live)} with non-zero bytes and the phase; the last: phase {phase!r}, "
        + ", ".join(f"{k} {v:g}" for k, v in sorted(samples.items()) if v > 0))


def _planes_autotune(root: str, card: str) -> int:
    """(b) the closed loop over manager saves; returns K4's launches."""
    from torchsnapshot_tpu_torch import CheckpointManager, StateDict, scheduler, telemetry
    from torchsnapshot_tpu_torch import device_digest as dd
    from torchsnapshot_tpu_torch.entry import train_entry
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
    from torchsnapshot_tpu_torch.telemetry import history

    _, (state, _) = train_entry(device=DEVICE, seed=0)
    leaves = _flat(state)
    changed = sorted(leaves)[:AUTOTUNE_CHANGED_LEAVES]
    mgr_root = f"{root}/autotune"
    write, write_stream = FSStoragePlugin.write, FSStoragePlugin.write_stream

    def payload(p: str) -> bool:
        return not p.split("/", 1)[0].startswith(".")

    async def slow_write(self, write_io):
        if payload(write_io.path):
            await asyncio.sleep(AUTOTUNE_WRITE_DELAY_S)
        return await write(self, write_io)

    async def slow_write_stream(self, stream):
        if payload(stream.path):
            await asyncio.sleep(AUTOTUNE_WRITE_DELAY_S)
        return await write_stream(self, stream)

    launches = 0
    with _env(TORCHSNAPSHOT_GPU_TELEMETRY="1"):
        telemetry.refresh_from_env()
        gov = scheduler.reset_io_governor()
        FSStoragePlugin.write, FSStoragePlugin.write_stream = slow_write, slow_write_stream
        try:
            mgr = CheckpointManager(mgr_root, device_digests=AUTOTUNE_DEVICE_DIGESTS)
            for step in range(AUTOTUNE_SAVES):
                if step:
                    for p in changed:
                        leaves[p].add_(1)
                want = {p: t.clone() for p, t in leaves.items()}
                dd.fingerprint_lanes.launches = 0
                _sync()
                t0 = time.perf_counter()
                mgr.save(step, {"train": StateDict(state)}, force=True)
                _sync()
                save_ms = (time.perf_counter() - t0) * 1e3
                save_k4 = dd.fingerprint_lanes.launches
                launches += save_k4
                verdict = telemetry.last_attribution()["binding"]
                elected = {k: (e.value, e.source) for k, e in gov._elections.items()
                           if k[1] == "FSStoragePlugin" and k[0].endswith(".write")}
                trials = [k[0] for k, (_, src) in elected.items() if src == "trial"]
                _, (fresh, _) = train_entry(device=DEVICE, seed=1)
                holder = StateDict(fresh)
                dd.fingerprint_lanes.launches = 0
                if mgr.restore({"train": holder}) != step:
                    raise AssertionError(f"planes (b): restore did not return step {step}")
                _sync()
                launches += dd.fingerprint_lanes.launches
                got = _flat(dict(holder))
                if got.keys() != want.keys() or not all(torch.equal(got[p], want[p])
                                                        for p in want):
                    raise AssertionError(f"planes (b): the restore of step {step} is not "
                                         "bit-exact")
                log(f"[planes] (b) save {step} in {save_ms:.1f} ms: elections "
                    + ", ".join(f"{d[0]}={v} ({src})" for d, (v, src) in sorted(elected.items()))
                    + f"; verdict {verdict['category']} {verdict.get('gbps')} GB/s; K4 "
                    f"{save_k4}; restore bit-exact")
                if len(trials) > 1:
                    raise AssertionError(f"planes (b): save {step} ran trials on {trials}")
        finally:
            FSStoragePlugin.write, FSStoragePlugin.write_stream = write, write_stream
    telemetry.refresh_from_env()
    profiles = history.load_profiles(mgr_root)
    if not profiles:
        raise AssertionError('planes (b): no type="profile" record was persisted')
    learned = {}
    for rec in profiles:
        if rec.get("op") == "write":
            learned.update(rec.get("settings") or {})
    log(f"[planes] (b) {len(profiles)} profile records; learned write settings {learned}; "
        f"profiles {gov.profiles()}")
    if not learned:
        raise AssertionError("planes (b): the saves learned no setting")
    dim = sorted(learned)[0]
    site, op = dim.split(".")
    elect = (f"gov.io_concurrency({op!r}, 'FSStoragePlugin')" if site == "io_concurrency"
             else f"gov.sub_chunk_bytes('FSStoragePlugin', op={op!r})")
    code = (
        "import json\n"
        "from torchsnapshot_tpu_torch import CheckpointManager, scheduler\n"
        f"CheckpointManager({mgr_root!r})\n"
        "gov = scheduler.io_governor()\n"
        f"{elect}\n"
        "print(json.dumps([[list(k), [e.value, e.source]] for k, e in gov._elections.items()]))\n"
    )
    env = dict(os.environ, TORCHSNAPSHOT_GPU_AUTOTUNE="auto")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    if out.returncode != 0:
        raise AssertionError(f"planes (b): the fresh process failed: {out.stderr[-2000:]}")
    first = json.loads(out.stdout.strip().splitlines()[-1])[0]
    log(f"[planes] (b) a fresh process on the same root: first election {first[0][0]}="
        f"{first[1][0]} ({first[1][1]}); learned {learned[dim]}")
    if first[1][1] != "profile" or first[1][0] != learned[dim]:
        raise AssertionError(f"planes (b): the fresh process's first election was {first}")
    return launches


def _planes_forensics(root: str, card: str) -> None:
    """(c) a storage write held past its p99 trigger, and an aborted take."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict, faultinject
    from torchsnapshot_tpu_torch.telemetry import flightrec, forensics

    quick = {f"q{i}": torch.full((256,), float(i), device=DEVICE)
             for i in range(FORENSIC_QUICK_OPS)}
    small = {"a": torch.arange(512, dtype=torch.float32, device=DEVICE), "b": torch.ones(64)}
    with _env(TORCHSNAPSHOT_GPU_FORENSICS_SAMPLE_S=FORENSIC_SAMPLE_S):
        # The p99 baseline of this run alone: the quick take's writes.
        forensics._reset_registries_for_tests()
        Snapshot.take(f"{root}/forensics_quick", {"q": StateDict(quick)})
        seen = flightrec.recorded_total()
        slow = f"{root}/forensics_slow"
        # The second fs.write of a take is its first payload write (the
        # first plants the commit fence).
        faultinject.configure(f"fs.write@2=delay:{FORENSIC_DELAY_S}")
        try:
            t0 = time.perf_counter()
            Snapshot.take(slow, {"s": StateDict(small)})
            slow_s = time.perf_counter() - t0
        finally:
            faultinject.disable()
        events = [e for e in flightrec.snapshot_ring() if e[0] > seen and e[2] == "forensic.dump"]
        dumps = forensics.load_stack_dumps(slow).get(0, [])
        fs_frame = os.path.join("storage_plugins", "fs.py")
        hits = [r for r in dumps if r.get("trigger") == "storage-p99"
                and (r.get("wedge") or {}).get("category") == "storage_write"
                and str((r.get("wedge") or {}).get("frame", "")).startswith(fs_frame)]
        log(f"[planes] (c) a take with one payload write held {FORENSIC_DELAY_S} s ({slow_s:.2f} "
            f"s): {len(events)} forensic.dump flight events ({[e[3] for e in events]}); "
            f"{len(dumps)} stack dumps, wedges "
            f"{[(r.get('trigger'), r.get('wedge')) for r in dumps]}")
        if not events:
            raise AssertionError("planes (c): no forensic.dump flight event")
        if not hits:
            raise AssertionError("planes (c): no stacks record blames storage_write at "
                                 "storage_plugins/fs.py")
        aborted = f"{root}/forensics_abort"
        faultinject.configure("fs.write@2=permanent")
        try:
            Snapshot.take(aborted, {"s": StateDict(small)})
        except faultinject.InjectedPermanentError:
            pass
        else:
            raise AssertionError("planes (c): the faulted take did not abort")
        finally:
            faultinject.disable()
    flight = os.path.join(aborted, flightrec.FLIGHT_DIR)
    files = sorted(os.listdir(flight)) if os.path.isdir(flight) else []
    log(f"[planes] (c) the aborted take left {files} in {flightrec.FLIGHT_DIR}/")
    if files != ["rank_0.jsonl", "rank_0" + forensics.STACKS_SUFFIX]:
        raise AssertionError("planes (c): the aborted take's stacks are not beside its ring")


def _planes_cloud(card: str) -> None:
    """(e) the entry train state through the S3 and GCS plugins over
    in-memory clients, one transient fault each."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict, faultinject
    from torchsnapshot_tpu_torch.entry import train_entry
    from torchsnapshot_tpu_torch.storage_plugins import s3 as s3_mod
    from torchsnapshot_tpu_torch.storage_plugins.retry import CollectiveRetryStrategy
    from torchsnapshot_tpu_torch.test_utils import FakeGCSBucket, FakeS3Client

    _, (state, _) = train_entry(device=DEVICE, seed=0)
    want = {p: t.clone() for p, t in _flat(state).items()}
    nbytes = sum(t.numel() * t.element_size() for t in want.values())
    client, bucket = FakeS3Client(), FakeGCSBucket()
    strategy = CollectiveRetryStrategy(base_backoff_s=CLOUD_BACKOFF_S)
    options = {
        "s3": {"client": client, "multipart_threshold": CLOUD_PART_BYTES,
               "retry_strategy": strategy},
        "gs": {"bucket": bucket, "chunk_size_bytes": CLOUD_PART_BYTES,
               "retry_strategy": strategy},
    }
    # (take's fault, restore's fault) of each scheme.
    faults = {"s3": ("s3.put_part@1=transient", None), "gs": (None, "gcs.get@1=transient")}
    part_bytes = s3_mod.MULTIPART_PART_BYTES
    s3_mod.MULTIPART_PART_BYTES = CLOUD_PART_BYTES
    try:
        for scheme in ("s3", "gs"):
            url = f"{scheme}://bucket/planes"
            _, (fresh, _) = train_entry(device=DEVICE, seed=1)
            holder = StateDict(fresh)
            retries, ms = [], []
            for fault, op in zip(faults[scheme], ("take", "restore")):
                if fault:
                    faultinject.configure(fault)
                _sync()
                t0 = time.perf_counter()
                try:
                    if op == "take":
                        Snapshot.take(url, {"train": StateDict(state)},
                                      storage_options=options[scheme])
                    else:
                        Snapshot(url, storage_options=options[scheme]).restore(
                            {"train": holder})
                    _sync()
                finally:
                    faultinject.disable()
                ms.append((time.perf_counter() - t0) * 1e3)
                retries.append(strategy.fleet_attempts)
            got = _flat(dict(holder))
            if got.keys() != want.keys() or not all(torch.equal(got[p], want[p]) for p in want):
                raise AssertionError(f"planes (e): the {scheme} restore is not bit-exact")
            if scheme == "s3":
                stored = sum(len(v) for v in client.store.values())
                parts = (f"{client.parts_completed} multipart parts in {client.part_attempts} "
                         "part uploads")
            else:
                stored = sum(len(v) for v in bucket.store.values())
                parts = f"{sum(b.upload_attempts for b in bucket.blobs.values())} uploads"
            log(f"[planes] (e) {scheme}://: {nbytes} B state, {stored} B stored, {parts}; take "
                f"{ms[0]:.1f} ms ({retries[0]} retries), restore {ms[1]:.1f} ms ({retries[1]} "
                f"retries), bit-exact; on {card}")
            if sum(retries) != 1:
                raise AssertionError(f"planes (e): {scheme} retried {sum(retries)} times, not 1")
    finally:
        s3_mod.MULTIPART_PART_BYTES = part_bytes


def phase_planes(root: str, card: str) -> int:
    """Phase 21 (see the module docstring). Returns K4's launches."""
    t0 = time.perf_counter()
    with _env(TORCHSNAPSHOT_GPU_AUTOTUNE="auto"):
        _planes_forensics(root, card)
        _planes_attribution(root, card)
        launches = _planes_autotune(root, card)
        _planes_cloud(card)
    log(f"[planes] phase 21 took {time.perf_counter() - t0:.1f} s")
    return launches


CLI_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                           "reference_snapshot")
CLI_TORN_TAIL = b"TSJR\x20\x00\x00\x00torn"


def _cli(label: str, argv, want: int, walls: list, card: str):
    """The port's ``cli.main(argv)`` in this process, stdout and stderr
    captured: fails unless it exits ``want``; logs and keeps its wall."""
    import io

    from torchsnapshot_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = cli.main(list(argv))
    ms = (time.perf_counter() - t0) * 1e3
    walls.append((label, ms))
    log(f"[cli] {label}: exit {code} in {ms:.1f} ms; {card}")
    if code != want:
        raise AssertionError(f"cli {label}: exit {code}, expected {want}\n"
                             f"{out.getvalue()[-3000:]}\n{err.getvalue()[-3000:]}")
    return out.getvalue(), err.getvalue()


def _same_tree(a, b) -> bool:
    """Two nested states equal leaf by leaf, tensors bit-exact with dtypes."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu().reshape(-1).view(torch.uint8),
                                b.cpu().reshape(-1).view(torch.uint8)))
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_tree(x, y) for x, y in zip(a, b)))
    return a == b


def _zeros_on(tree, device: str):
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree, device=device)
    if isinstance(tree, dict):
        return {k: _zeros_on(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_on(v, device) for v in tree)
    return tree


def phase_cli(root: str, sharded: str, card: str) -> dict:
    """Phase 22 (see the module docstring). Returns K4's launches by step
    of the path."""
    from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict, telemetry
    from torchsnapshot_tpu_torch import device_digest as dd
    from torchsnapshot_tpu_torch.dist_store import TCPStore
    from torchsnapshot_tpu_torch.entry import train_entry
    from torchsnapshot_tpu_torch.telemetry import critpath
    from torchsnapshot_tpu_torch.tricks import torchsnapshot_interop as tsi

    t_phase = time.perf_counter()
    launches, walls = {}, []

    def k4(label: str, fn):
        dd.fingerprint_lanes.launches = 0
        out = fn()
        _sync()
        launches[label] = dd.fingerprint_lanes.launches
        return out

    def cli(label, argv, want=0):
        return _cli(label, argv, want, walls, card)

    primary, mirror, remote = f"{root}/primary", f"{root}/mirror", f"{root}/remote"
    a_snap, b_snap = f"{primary}/step_0000000000", f"{primary}/step_0000000001"
    c_snap = f"{root}/incremental"
    os.makedirs(remote)
    train_step, (state, batch) = train_entry(device=DEVICE, seed=0)
    # The serving copy of the embedding in the compute dtype: the bf16 leaf.
    serve = StateDict(embed=state["params"]["embed"].to(torch.bfloat16))
    app = {"train": StateDict(state), "serve": serve}
    leaves = _flat(state)
    nbytes = sum(t.numel() * t.element_size() for t in leaves.values())

    # Two takes with device digests and every plane on: telemetry, the
    # journal, a mirror, georep and the flight recorder (on by default).
    with _env(TORCHSNAPSHOT_GPU_TELEMETRY="1", TORCHSNAPSHOT_GPU_JOURNAL="1",
              TORCHSNAPSHOT_GPU_GEOREP=remote, TORCHSNAPSHOT_GPU_GEOREP_INTERVAL_S="0.05"):
        telemetry.refresh_from_env()
        try:
            mgr = CheckpointManager(primary, save_interval_steps=1, device_digests=True,
                                    storage_options={"mirror_url": mirror})
            k4("cli: save(0), every plane on", lambda: mgr.save(0, app))
            before = {p: t.clone() for p, t in leaves.items()}
            train_step(state, batch)
            after = {p: t.clone() for p, t in _flat(state).items()}
            k4("cli: save(1) after a train step", lambda: mgr.save(1, app))
            k4("cli: incremental take of step 1", lambda: Snapshot.take(
                c_snap, app, incremental_base=b_snap, device_digests=True, record_digests=True))
            train_step(state, batch)
            k4("cli: journal_step(2)", lambda: mgr.journal_step(2, app))
            if not mgr._georep.drain(120.0):
                raise AssertionError(f"georep did not drain: {mgr._georep.last_error}")
            mgr.close()
        finally:
            telemetry.refresh_from_env()
            telemetry.reset()
    log(f"[cli] the entry train state ({len(leaves)} leaves, {nbytes} B) and its bf16 serving "
        f"embedding taken as step 0, step 1 (after a train step, journaled once more) and an "
        f"incremental take of step 1, with device digests, telemetry, the journal, a mirror and "
        f"georep; K4 {sum(launches.values())} launches; {card}")

    out, _ = cli("info step 1", ["info", b_snap])
    if "entries:     " not in out or "checksums:" not in out:
        raise AssertionError(f"info printed {out!r}")
    out, _ = cli("ls step 1", ["ls", b_snap])
    if "0/train/params/embed" not in out or "0/serve/embed" not in out:
        raise AssertionError(f"ls lacks the state's leaves: {out[:2000]}")
    for leaf, header in (("0/serve/embed", "bfloat16[8192, 512]"),
                         ("0/train/params/embed", "float32[8192, 512]")):
        out, _ = cli(f"cat {leaf}", ["cat", b_snap, leaf])
        if out.splitlines()[0] != header:
            raise AssertionError(f"cat {leaf} printed {out.splitlines()[0]!r}")
    out, _ = cli("verify step 1", ["verify", b_snap])
    if ", 0 failed" not in out:
        raise AssertionError(f"verify printed {out!r}")
    for label, snap in (("step 0", a_snap), ("step 1 (journaled)", b_snap),
                        ("mirror step 1", f"{mirror}/step_0000000001"),
                        ("georep remote step 1", f"{remote}/step_0000000001")):
        out, _ = cli(f"fsck {label}", ["fsck", snap])
        if ", 0 finding(s)" not in out:
            raise AssertionError(f"fsck {label} printed {out!r}")
    for art in (".snapshot_telemetry", ".snapshot_critpath", ".journal"):
        if not os.path.exists(os.path.join(b_snap, art)):
            raise AssertionError(f"step 1 lacks {art}: the planes were not on")

    # Damage on a copy: one flipped payload byte, then an orphan and a torn
    # journal tail for --repair.
    damaged = f"{root}/damaged"
    shutil.copytree(b_snap, damaged)
    entry = Snapshot(damaged).metadata.manifest["0/train/params/embed"]
    payload = os.path.join(damaged, entry.chunks[0].array.location)
    with open(payload, "r+b") as f:
        f.seek(12345)
        byte = f.read(1)
        f.seek(12345)
        f.write(bytes([byte[0] ^ 0x01]))
    out, _ = cli("verify after a flipped byte", ["verify", damaged], want=1)
    if ", 1 failed" not in out:
        raise AssertionError(f"verify printed {out!r}")
    out, _ = cli("fsck after a flipped byte", ["fsck", damaged], want=1)
    if "CHECKSUM-MISMATCH" not in out:
        raise AssertionError(f"fsck printed {out!r}")
    with open(payload, "r+b") as f:
        f.seek(12345)
        f.write(byte)
    with open(os.path.join(damaged, "0", "stray.bin"), "wb") as f:
        f.write(b"orphan")
    seg = os.path.join(damaged, ".journal", "rank_0.seg")
    committed = os.path.getsize(seg)
    with open(seg, "ab") as f:
        f.write(CLI_TORN_TAIL)
    out, _ = cli("fsck --repair of an orphan and a torn tail", ["fsck", damaged, "--repair"])
    if "QUARANTINED  0/stray.bin" not in out or "TRUNCATED" not in out:
        raise AssertionError(f"fsck --repair printed {out!r}")
    if os.path.getsize(seg) != committed:
        raise AssertionError("fsck --repair left the torn journal tail")
    cli("fsck after the repair", ["fsck", damaged])
    shutil.rmtree(damaged)

    out, _ = cli("diff step 1 against its incremental take", ["diff", b_snap, c_snap])
    if " 0 changed" not in out:
        raise AssertionError(f"diff printed {out!r}")
    out, _ = cli("diff across the train step", ["diff", a_snap, b_snap], want=1)
    named = {ln.split()[1] for ln in out.splitlines() if ln.startswith("~ ")}
    stepped = {f"0/train/{p.lstrip('/')}" for p in before if not torch.equal(before[p], after[p])}
    if named != stepped or "0/serve/embed" in named:
        raise AssertionError(f"diff named {sorted(named)[:5]}..., the step changed "
                             f"{sorted(stepped)[:5]}...")
    log(f"[cli] diff across the train step named the {len(named)} leaves the step changed, "
        f"of {len(before)} (the bf16 serving copy unchanged)")
    out, _ = cli("deps of the manager root", ["deps", primary])
    if "step_0000000001" not in out:
        raise AssertionError(f"deps printed {out!r}")
    cli("stats step 1", ["stats", b_snap])
    out, _ = cli("stats --openmetrics step 1", ["stats", b_snap, "--openmetrics"])
    if not out.endswith("# EOF\n"):
        raise AssertionError("the OpenMetrics exposition does not end with # EOF")
    with open(os.path.join(b_snap, critpath.ATTRIBUTION_FNAME)) as f:
        binding = critpath.binding_exit_code(json.load(f))
    cli("explain step 1", ["explain", b_snap], want=binding)
    layout = f"{root}/layout.json"
    with open(layout, "w") as f:
        json.dump({"version": 1, "mesh": [["x", 4]],
                   "rules": [{"pattern": r"params/embed$", "spec": [[], ["x"]]}]}, f)
    if not os.path.isfile(os.path.join(sharded, ".snapshot_metadata")):
        raise AssertionError(f"no sharded snapshot at {sharded} for plan")
    out, _ = cli("plan of phase 15's world-of-2 snapshot onto 4 columns",
                 ["plan", sharded, layout, "--world", "4"])
    if "totals: storage" not in out:
        raise AssertionError(f"plan printed {out!r}")
    log(f"[cli] plan: {out.strip().splitlines()[-1]}")
    out, _ = cli("plan of step 1 (no sharded entry)", ["plan", b_snap, layout, "--world", "4"])
    georep_out, _ = cli("georep-status of the manager root", ["georep-status", primary,
                                                              "--remote", remote])
    if "caught up" not in georep_out:
        raise AssertionError(f"georep-status printed {georep_out!r}")

    # consolidate: the incremental take made self-contained restores onto
    # the card bit-exact to the state after the first train step.
    flat = f"{root}/consolidated"
    cli("consolidate the incremental take", ["consolidate", c_snap, flat])
    _, (fresh, _) = train_entry(device=DEVICE, seed=1)
    holder = StateDict(fresh)
    serve_dst = StateDict(embed=torch.zeros_like(serve["embed"]))
    Snapshot(flat).restore({"train": holder, "serve": serve_dst})
    got = _flat(dict(holder))
    if got.keys() != after.keys() or any(not torch.equal(got[p], after[p]) for p in after):
        raise AssertionError("the consolidated snapshot did not restore bit-exact")
    if not torch.equal(serve_dst["embed"], serve["embed"]):
        raise AssertionError("the consolidated bf16 leaf did not restore bit-exact")
    cli("fsck of the consolidated snapshot", ["fsck", flat])
    log(f"[cli] the consolidated snapshot restored onto {DEVICE} bit-exact")
    del holder, fresh, got

    # migrate: the reference fixture to a native snapshot, restored onto the
    # card; and back to the reference format.
    native, back = f"{root}/migrated", f"{root}/migrated_back"
    cli("migrate the reference fixture", ["migrate", CLI_FIXTURE, native])
    want = tsi.load_torchsnapshot(CLI_FIXTURE)
    dst = StateDict(_zeros_on(want["app"], DEVICE))
    Snapshot(native).restore({"app": dst})
    if not _same_tree(dict(dst), want["app"]) or not dst["weights"].device.type == DEVICE:
        raise AssertionError("the migrated snapshot did not restore bit-exact onto the card")
    tsi.migrate_to_torchsnapshot(native, back)
    if not _same_tree(tsi.load_torchsnapshot(back), want):
        raise AssertionError("the snapshot migrated back does not load as the fixture")
    log(f"[cli] migrate: the reference fixture restored onto {DEVICE} bit-exact; migrated back, "
        "load_torchsnapshot reads it identically")

    store = TCPStore("127.0.0.1", is_server=True, timeout=10.0)
    try:
        out, _ = cli("store-status of a live store", ["store-status", store.bootstrap_addr])
    finally:
        store.close()
    if "role=leader" not in out:
        raise AssertionError(f"store-status printed {out!r}")

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torchsnapshot_tpu_torch", "info", b_snap],
                          capture_output=True, text=True, env=env, cwd=here, timeout=300)
    ms = (time.perf_counter() - t0) * 1e3
    walls.append(("python3 -m torchsnapshot_tpu_torch info (a process)", ms))
    log(f"[cli] python3 -m torchsnapshot_tpu_torch info step 1: exit {proc.returncode} in "
        f"{ms:.1f} ms, the interpreter's start and imports included; {card}")
    if proc.returncode != 0 or proc.stdout != cli("info step 1 again", ["info", b_snap])[0]:
        raise AssertionError(f"python3 -m torchsnapshot_tpu_torch info: exit {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    log(f"[cli] {len(walls)} command runs, walls in ms: "
        + ", ".join(f"{label} {ms:.1f}" for label, ms in walls) + f"; {card}")
    log(f"[cli] phase 22 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    from torchsnapshot_tpu_torch.entry import ENTRY_CONFIG, entry

    # Reproducible cuBLAS GEMMs (set before the first cuBLAS handle): the
    # checkpoint phase requires a restored model to answer bit-identically.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # Phases 1-20 run with the closed loop off, so that their elections
    # and numbers stay those of earlier runs; phase 21 runs it.
    os.environ["TORCHSNAPSHOT_GPU_AUTOTUNE"] = "never"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    digest_instructions = phase_build()
    max_err = phase_kernels()
    fn, (params, _) = entry(device=DEVICE, seed=0)
    serve_launches, tokens, logits = phase_serve(fn, params, ENTRY_CONFIG)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_checkpoint(fn, params, tokens, logits, root)
        state = phase_state(root, card)
        io_launches = phase_io(root, state, card)
        phase_telemetry(root, state, card)
        del state
        stream_launches = phase_stream(root, card)
        train_launches = phase_train(ENTRY_CONFIG)
        phase_train_checkpoint(root)
        digest_err, digest_times = phase_digest(digest_instructions, max_sm_clock_mhz(), card)
        # Timed before the phases that spawn processes onto the card: after
        # those, the profiler has now and then recorded no device time.
        flash_kernels = phase_timing(max_err, card)
        digest_launches = phase_manager(f"{root}/manager", card)
        digest_launches.update(phase_durability(f"{root}/durability", card))
        fleet_launches, fleet_digests = phase_fleet(f"{root}/fleet", card)
        digest_launches.update(fleet_digests)
        digest_launches["io: unchanged zlib save of the manager"] = io_launches
        digest_launches.update(stream_launches)
        workload_launches, workload_digests = phase_workloads(f"{root}/workloads", card)
        digest_launches.update(workload_digests)
        sharded_launches, sharded_digests, partial_kernel = phase_sharded(
            f"{root}/sharded", card, digest_instructions, max_sm_clock_mhz())
        workload_launches["sharded_train"] = sharded_launches
        workload_launches["fleet"] = fleet_launches
        digest_launches.update(sharded_digests)
        workload_launches["parallel"], dd_launches = phase_parallel(f"{root}/parallel", card)
        digest_launches["parallel: dryrun device-digest round trip (4 ranks)"] = dd_launches
        phase_mesh_workloads(f"{root}/mesh", card)
        digest_launches["planes: autotuned manager saves and restores"] = phase_planes(
            f"{root}/planes", card)
        digest_launches.update(phase_cli(f"{root}/cli", f"{root}/sharded/w2", card))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    flash_launches = {
        "serve": {"flash_fwd": serve_launches, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
        "train": train_launches, **workload_launches}
    kernels = [with_launches(k, flash_launches) for k in flash_kernels]
    kernels.append({
        "name": "device_digest",
        "route": "cuda",
        "source": "torchsnapshot_tpu_torch/csrc/digest.cu",
        "replaces": "torchsnapshot_tpu/device_digest.py:73",
        "launches": sum(digest_launches.values()),
        "launches_by_path": digest_launches,
        "max_abs_err": float(digest_err),
        "library_ms": None,
        **digest_times,
    })
    kernels.append(partial_kernel)
    phase_profile(fn, params, tokens, ENTRY_CONFIG)

    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
