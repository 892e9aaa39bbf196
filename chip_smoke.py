#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--phases 4g,5]

Phases (any failure raises and exits nonzero; there is no CPU fallback).
``--phases`` runs [1], [2] and the listed phases only, and then ends without
the two JSON lines (a quicker check of one part); with no arguments every
phase runs.

1. The card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
   TF32 off for matrix products and convolutions (the plain versions and the
   CPU references are full f32).
2. Build every CUDA kernel from ``dynamic_load_balance_distributeddnn_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together) into ``build/torch_kernels``.
3. Each kernel against its plain PyTorch version on the card: GroupNorm (K1)
   at DenseNet-121 shapes at b = 32, 128 and 160 and on each of its routes
   (tiled with and without a cluster, general), f32 and bf16, the backward's
   bits repeating; cross-entropy (K2) at one DenseNet worker's logits and a
   packed step's ([512, 10]), at the language model's worker shapes and the
   full wikitext-2 vocabulary (33,278), f32 and bf16, with labels out of
   range and a row slice that starts off a 16-byte boundary; flash attention
   (K3) on its short route (T <= 64: forward and fused backward) at every
   shape of the language-model path, the validation chunk and T in {1, 17,
   35, 64}, on the model's strided views and on contiguous tensors, and on
   its tiled route (forward, dK/dV, dQ; 3xTF32 on the tensor cores) at a
   long-context shape, causal and not, and at [5c]'s shapes, the backward's
   bits repeating, with the blocks and warps an SM holds. K1 also
   at every distinct GroupNorm shape of DenseNet-121, ResNet-101, GoogLeNet
   and RegNetY-400MF at a packed step's b = 512, f32 and bf16, on the route
   and cluster ``plan`` picks; its route for every GroupNorm call of those
   models at b = 128 and 512. Then each kernel's device time (the
   profiler's sum of kernel time, so host launch gaps are not counted)
   beside its bound, the plain version's and one PyTorch library call's;
   the CUDA-event wall, which includes the host's launch gaps, is printed
   beside it. K1 is timed over one DenseNet-121 worker pass at b = 128
   beside its general route (the first port's kernels), and over
   one packed step's pass (b = 512) of DenseNet-121, f32
   and (``--precision bfloat16``'s K1) bf16, whose bound counts 2-byte
   activations; K1's route for every GroupNorm call of the four families at
   b = 512 in bf16 (the tiled one: C in whole 8-element vectors); K2
   and K3 at every shape the language-model path gives them (below), K2
   also at [8]'s (a rank's step, [16,384, 18,328], forward and backward;
   its validation chunk, [5,120, 18,328], forward), K3
   beside its tiled route; K3's tiled route at the long-context shape and
   at [5c]'s largest training and validation shapes, beside SDPA and two
   bounds (the f32 FMA peak's and the 3xTF32 one it computes in).
3b. The compute-mode straggler's synthetic load (``ops/faultload.py``): its
   kernel (``csrc/faultload.cu``, the whole chain in one cooperative
   launch) against the plain chain, its calibrated cost an iteration, its
   device time and bound, and the card's busy share over a 1,000-iteration
   call (at least 90%).
4. The vision path through the defaults: the port's ``cli.main`` trains
   DenseNet-121 on synthetic CIFAR-10 with 4 workers, B=512 and a 3:1
   virtual straggler for 3 epochs, on packed epochs with adaptive probes:
   every epoch packed, epoch 2 on modeled node times with no probe wall; the
   launch counters (zeroed just before) show K1 (on its tiled route only)
   and K2 ran, the rebalancer moved share off worker 0 and the 9 series
   were written; the peak device memory is printed. The run is traced
   (``--trace on --trace_spool``), for [4i].
4b. The same recipe with ``--packed off --fault_mode compute``: the elastic
   path, the calibrated cost of a synthetic-load iteration inside a step,
   the straggler's probed time an example at least twice a clean worker's,
   the synthetic-load kernel launched.
4c. The reference's random faults, ``-ft true -ftc 0.5 --fault_mode
   compute`` without ``--straggler``, 3 epochs at seed 213 (worker 0 is hit
   from epoch 1): share moves off worker 0, the synthetic-load kernel
   launched.
4d. ``-m resnet`` (ResNet-101), ``-m googlenet``, ``-m regnet``
   (RegNetY-400MF): 4 workers, B=512, 2,048 examples, 1 epoch each; K1 and
   K2 launched and the 9 series written.
4e. Window-cadence rebalancing: ``--packed off --straggler 8,1,1,1
   --fault_mode compute --fault_schedule sin --fault_period 1 --rebalance
   window --superstep_window 2`` on 8,192 examples (16 steps an epoch in 8
   windows), 2 epochs: at least one mid-epoch switch, at most 2 an epoch and
   fewer than the evaluations; the regret budget held (spent <= budget_frac
   * credit + cost_init); the run's decision journal (the controller
   snapshot in the series' ``_meta``) replays bit for bit through
   ``balance/replaylab.py`` with no invariant violated; K1 (tiled route
   only) and K2 launched; K1 forward and backward against their plain
   versions at every DenseNet-121 GroupNorm shape of each per-worker width
   the switches produced. Each evaluation's wall, its wall feedback (the
   card's time between two evaluations' CUDA events against the model's
   prediction) and the controller's ``wall_scale``, which no steady
   evaluation (epochs 1 on) may read at its clip (0.25 or 4.0); the run is
   traced (``--trace ring --trace_spool``, for [4i]). The same window
   recipe under ``--superstep off`` (eager steps; ``--stream_chunk_steps
   2`` cuts its windows, as ``--superstep_window 2`` does under ``auto``)
   with the same gates, and
   the per-epoch walls beside the same recipe at ``--rebalance epoch`` (for
   information). Both graphed runs take ``--warm_start true``: the warm
   service's on arm of [4m].
4m. The warm service (``runtime/compiler.py``: step graphs captured ahead,
   before an epoch's wall and in its untimed tail). (a) [4e]'s epoch-cadence
   twin on 2,048 examples, 7 epochs under ``-ocp true``, in virtual mode
   under a timing model (the plans fixed), cuDNN deterministic, under
   ``--aot_warm false`` against the default ``true`` with ``--warm_start
   true``: parameters, momentum, losses and partitions bit for bit; the on
   arm captures nothing in the foreground, and each decay epoch (a new
   learning rate: a new key) replays the key its speculation captured with
   no capture in its wall, where the off arm captures. (b) [4e]'s window recipe (real walls: the controller's
   decisions follow them, so the arms are compared on their figures, not
   bits) under ``--aot_warm false`` against [4e]'s run: under ``on`` no
   foreground capture in an epoch whose every batch tuple the service
   prepared before its wall; ``off`` takes its captures in the foreground.
   Printed a line each: each arm's captures and capture seconds inside and
   outside the walls, the speculation's hits and misses, each arm's epoch
   walls, and ``measured_s / modeled_s`` at the first evaluation after
   each switch.
4f. ``--precision bfloat16`` (bf16 compute over f32 master weights): [4]'s
   recipe, 2 epochs packed, then ``--packed off`` for 2 epochs (the elastic
   step and the probes in bf16): share moved off worker 0, finite losses,
   the 9 series, the peak memory; every K1 launch on bf16 activations and
   on the tiled route, every K2 launch on f32 logits (counted apart by the
   wrappers' ``_bf16`` counters). The packed epochs' walls beside [4]'s f32
   walls (for information).
5. The language-model path: ``cli.main`` trains the Transformer LM (EMSIZE
   200, 2 heads, 2 layers) on the committed wikitext-2 files with 4 workers,
   80 columns, bptt 35, per-worker clipping at 0.25, flash attention and a
   3:1 virtual straggler for 3 epochs; the counters (zeroed just before)
   show K3's short route and K2 ran (and K3's tiled route did not), share
   moved off worker 0, the 9 series were written. Each path's wall.
5b. The same under ``--precision bfloat16``, 2 epochs: K3's short route and
   K2 ran with f32 operands (the embedding runs in bf16, ``+ pe`` promotes
   to f32, as in the JAX package), share moved, finite losses.
5c. [5]'s recipe at ``--bptt 256``: 11 windows of 256 tokens an epoch (the
   last with 159 real ones, the rest weighted 0), above the short route, so
   every K3 launch takes the tiled kernels (the short route's counters stay
   0), inside the step graphs in training and eagerly in validation (the
   test stream's 960 rows of 256 in chunks of 457, ``lm_engine.eval_rows``);
   share moved, finite losses; each (B*H, T, D) the tiled forward saw.
4h. Stop and resume (``--ckpt_dir``): [4]'s packed DenseNet-121 and [4b]'s
   elastic compute-mode run at 1,024 examples (two steps an epoch), and
   [5]'s LM at half its tokens (108,800), each 2 epochs
   with ``--probe_mode always`` under ``--superstep auto`` and ``off``,
   cuDNN deterministic: the whole run with ``--ckpt_dir``, then a fresh
   trainer resuming from its epoch-0 checkpoint for the last epoch. Its
   parameters, momentum buffers and last train loss equal the whole run's
   bit for bit, and its recorder holds that epoch with the whole run's
   partition. Each save's and each restore's wall.
4i. Tracing: [4]'s trace attributes at least 95% of each epoch's wall to
   its phases (``obs/scope_cli.py summarize``), ``postmortem`` reads its
   spool; ``replay`` of [4e]'s spool reproduces every recorded verdict;
   [4f]'s recipe (1 epoch, 1,024 examples) under ``--profile_dir``: its
   Chrome trace's K1 kernels, counted, and those launched from graph
   replays; ``flops_per_epoch`` and ``mfu_bf16_peak`` of [4], [4f] and [5],
   each in (0, 1].
   Every path of [4]-[5c] runs under the default ``--superstep auto``: each
   training step replayed from a captured CUDA graph
   (``train/supersteps.py``); every epoch's steps are replays, one dispatch
   a window (the packed epoch: one), and an epoch on a repeated plan
   captures nothing (``_meta["supersteps"]``). Launch counts include the
   replays.
4g. ``--superstep`` as captured CUDA graphs: (i) each kernel captured alone
   at a path shape and replayed, against its plain version (the tolerances
   of [3]) and the eager launch's bits: K1 at every DenseNet-121 call at
   b = 512, f32 and bf16; K2 at [512, 10] and [1400, 18328]; K3's short
   route at (40, 2, 35, 100) and its tiled route at (26, 2, 256, 100), [5c]'s
   largest training step; the load with a device count, replayed at 0,
   3 and 300 iterations. (ii) From one state, two graphed steps (a capture,
   then a replay) against two eager steps, cuDNN deterministic: the
   parameters, momentum buffers and loss sums bit for bit, for DenseNet-121
   elastic at the 3:1 plan's widths (32, 160, 160, 160) with the
   straggler's compute-mode load, DenseNet-121 packed (b = 512), and the
   LM with dropout (the replays draw the eager masks). (iii) ``--superstep
   auto`` against ``off`` on [4b]'s, [5]'s and [4f]'s packed recipes cut to
   1 epoch (the DenseNet-121 ones to 1,024 examples): each arm's epoch (walls, captures, dispatches against the windows, host
   dispatch seconds, peak memory), then steady passes over one plan,
   one off and one auto, and one profiled pass each for the
   busy share.
4j. ``--remat`` (the training forward under ``torch.utils.checkpoint``, its
   dropout masks replayed from a tape): DenseNet-121 packed at b = 512, f32
   and bf16, and the LM (4 x 20 columns, clip 0.25, dropout on), each from
   one state, one step under remat off and on, eager and from a step graph,
   cuDNN deterministic: the gradients, the parameters after the step and
   the loss sum bit for bit across the four arms; under each mode remat
   launches K1's and K3's forwards twice as often as without it and every
   other kernel as often; each arm's peak device memory above the baseline
   and its steady step's device time.
4k. ``--elastic on`` in one process: [4]'s DenseNet-121 cell (4 workers,
   B = 512, 3:1 virtual straggler, 4,096 examples) on the elastic path
   (``--packed off --superstep_window 2``: windows of 2 steps, the
   liveness checks' boundaries), 6 epochs, through ``Trainer(cfg,
   injector=PreemptionInjector(4, [PreemptionEvent(worker=3, down_at=1.4,
   rejoin_epoch=3)], base=<the straggler>))``: worker 3 is confirmed lost
   in epoch 1, the epoch re-runs over 3 survivors from its snapshot, and
   worker 3 is readmitted at epoch 3 with a probe-seeded share. Checks:
   ``workers_alive`` 4, 3, 3, 4, 4, 4 and one recovery; every partition sums
   to 1 and splits the data disjointly; worker 0 holds the smallest share
   in the last epoch; finite losses; every epoch replayed from step graphs,
   the two new fleets' graphs captured anew; K1 (tiled) and K2 launched
   after the recovery. Printed: detection to resumed training, each
   snapshot's wall and bytes, the captures each new fleet forced.
4l. The host-fed path (``--device_cache off``): [4]'s DenseNet-121 cell
   (4 workers, B = 512, 3:1 virtual straggler, 4,096 examples), 2 epochs in
   windows of 2 steps (``--stream_chunk_steps 2``), in two arms, packed
   (``--superstep auto``, the defaults) and ``--packed off`` (elastic
   scan), each beside its resident twin (``--device_cache on``), the
   partitions fixed by a timing model and cuDNN deterministic. The training
   set stays on the host: each window's rows are packed by the C++ gather
   (``runtime/native.py``, which must have loaded) into pinned memory and
   staged one window ahead on a CUDA copy stream (``train/pipeline.py``).
   Checks: each arm's parameters, momentum, losses and partitions equal its
   twin's bit for bit; no training row resident on the card; ``host_put_s``
   measured; K1 and K2 launched. Printed: the epoch walls of the arms and
   their twins, ``host_put_s``, the busy share of one profiled training pass
   a run, the training-set bytes on the card, and ``take_rows`` against
   ``np.take`` in GB/s over one window's rows.
6. DenseNet-121, ResNet-18, RegNetY-400MF and the Transformer LM on the
   card against the same models on the CPU (plain versions), same weights
   and inputs; the CNNs' first-conv gradient against the CPU's f64 run, at
   three weight seeds.
6b. DenseNet-121 and the LM in bf16 on the card and on the CPU against the
   CPU's f64 run from the same weights and inputs: the loss and the first
   layer's gradient, the card's error within ``BF16_CARD_MULTIPLE`` times
   the CPU's bf16 error.

7. Data parallelism across processes: two ranks on ``cuda:0``, the
   gradient collectives on gloo through pinned host memory (two ranks share
   the card). The ranks of [7], [7c] and [8] are started once
   (``scripts/rank_launch.py`` ``run_rank_jobs``: one process group, every
   arm a ``cli.main`` call that reuses it, from zeroed launch counters and
   peak statistics) and run every arm in turn; each arm is the cli on
   ``<flags> --num_processes 2 --process_id <i>``. [7]: ``-m densenet -ds
   cifar10 -ws 2 -b 512 -gpu 0,0 --straggler 3,1 --fault_mode virtual -e 2
   --n_train 2048`` (DenseNet-121 at its published width, B = 512 over two
   ranks) in three arms: (a) the default DBS path (window-mode elastic
   epochs), (b) ``--fused_dbs true``, (c) ``-dbs false --grad_accum 2
   --compress_grads int8 --shard_update true`` (the fused path, ZeRO-1 on
   the int8 wire). Each rank writes a report beside the run's statistics
   (``cli.rank_report_file``, ``Trainer.rank_report``). Checks: gloo with 2
   ranks; the ranks' parameters bit for bit equal (their SHA-256); finite,
   falling losses; in (a) and (b) worker 0's share below 0.40 by the last
   epoch; K1 and K2 launched on each rank; in (c) each rank's momentum chunk
   half the padded flat parameter count. Arm (c) runs cuDNN deterministic
   with ``--ckpt_dir`` (a collective save an epoch: the ZeRO-1 chunks
   gathered, rank 0 writing), and two more jobs follow it: rank 0 copies
   its epoch-0 checkpoint alone (the run as if stopped there), and the run
   resumed from that copy ends with (c)'s parameters on every rank (their
   SHA-256) and (c)'s epoch-1 loss and partition. Printed: each arm's wall, the
   epoch walls, each epoch's collective walls (mean and max a step),
   ``sync_time``, ``comm_bytes_*`` and each rank's peak memory. A rank that
   fails or outlives the launch's limit fails the phase: every rank is
   killed and their logs printed. It runs right after [3b], while this
   process holds the least device memory (the ranks share the card with
   it).
7c. The language model across ranks, in the same launch: ``-m transformer
   -ds wikitext2 -d false -ws 2 -b 80 -gpu 0,0 --bptt 35 --grad_clip 0.25
   --straggler 3,1 --fault_mode virtual --use_flash_attention true -e 2``
   (``BASELINE.md`` config 5 at full width) in [7]'s three arms. Checks:
   the ranks' parameters bit for bit equal; finite, falling losses; share
   off worker 0 in (a) and (b); ``comm_bytes_ici`` the flat formula (4
   bytes an element, or the int8 wire's) times each epoch's combines; K2
   and K3 launched on each rank; in (c) the half momentum chunk.
8. Sequence parallelism, in the same launch: ``-m transformer -ds
   wikitext2 -d false -ws 2 -b 32 -gpu 0,0 --bptt 1024 -e 2 --seq_parallel
   ring``, then ``ulysses`` (6 windows of [32, 1024] an epoch, each rank
   512 positions). Checks: the ranks' parameters bit for bit equal;
   finite, falling losses; the recorder's series; K2 launched on each
   rank. In the ranks (``sp_checks``): the first window's loss and
   gradients through ``seq_parallel_value_and_grad`` of both modes against
   the one-device LM on the card with the same weights, dropout 0 (rtol
   1e-5, atol 5e-4: the CPU tests' tolerances), and
   ``ulysses_self_attention(use_flash=True)`` at that shape (one head a
   rank after the all-to-all, T = 1,024: K3's tiled route) against
   ``use_flash=False`` (atol 2e-5 forward, 5e-4 gradients).
7b. ``--grad_comm hier`` across four ranks on ``cuda:0`` over gloo, started
   once for every arm (``-m densenet -ds cifar10 -ws 4 -b 512 -gpu 0,0,0,0
   --straggler 3,1,1,1 -e 2 --n_train 2048 --grad_comm hier --hier_hosts
   2``: the tree (2, 2) on a synthetic two-host split), three arms: (a) the
   default wires (int8 on the outer hop, fp32 inside), DBS on; (b)
   ``--grad_comm_wires int4,fp32 --shard_update true`` (ZeRO-1 on the
   tree); (c) ``--hier_levels learned --dcn_bandwidth_probe true
   --grad_comm_wires auto`` (the bandwidth probe, the learned tree and the
   wires it picks; on one host it may merge to flat); and a fourth, the
   language model (``-m transformer -ds wikitext2 -d false -ws 4 -b 80
   --bptt 35 --use_flash_attention true`` on the same tree, DBS on, the
   default wires). Checks: gloo with 4 ranks; the ranks' parameters bit for
   bit equal; finite, falling losses; one combine, one set of wires and one
   probe verdict on every rank; ``comm_bytes_ici``/``_dcn`` the hier
   formula times each epoch's combines (the flat one if (c) merged); in (b)
   each rank's momentum chunk a quarter of the padded flat parameter count;
   K1 and K2 (the LM: K2 and K3) launched on each rank; (b) resumed from
   its epoch-0 checkpoint as [7]'s (c) is (the residual rows of every rank
   saved and taken back). Printed: the
   probe's rates and verdict, the epoch walls, the collective a step and
   each rank's peak memory. It runs right after [7]-[8].

7d. ``--elastic on`` across processes: two processes on ``cuda:0`` over
   gloo, brought up through the port's ``rendezvous.elastic_initialize``
   by ``tests/_torch_mh_worker.py`` (no JAX): DenseNet-121 at its published
   width, ``-ws 4 -b 512 --straggler 3,1,1,1 --fault_mode virtual
   --n_train 2048 --packed off``, ``--ckpt_dir`` under ``SCRATCH``, 4
   epochs, in a launch of its own. Process 1 is SIGKILLed inside epoch 1's
   gradient collectives (as soon as it writes its marker before its third
   combine of the epoch; it is not held, so the kill lands wherever that
   step is); the survivor re-rendezvouses alone, restores checkpoint 0 and
   re-runs epoch 1 over its 2 workers. Process 1 is then
   respawned as a joiner and readmitted at epoch 3. Checks: the survivor's
   two events (``lost`` [2, 3] at generation 1 from ``checkpoint[0]``;
   ``readmitted`` [2, 3] at generation 2, epoch 3); both processes end at
   4 workers over 2 processes with the same parameters (SHA-256) and the
   joiner's losses the survivor's tail; K1 and K2 launched in both; the
   parity leg, a fresh one-process 2-worker run from a copy of checkpoint
   0 with the survivor-restricted sidecar vectors over epoch 1, ends with
   the survivor's epoch-1 parameters and loss bit for bit (cuDNN
   deterministic). Printed: the kill to resumed training (the survivor's
   ``resumed_unix`` stamp against the kill's wall clock), attribution to
   resumed training (``detect_to_resume_s``, from the first failed
   collective or stale beacon), each phase's seconds (``agree``,
   ``teardown``, ``establish``, ``restore``), the grow's seconds and the
   phase's walls. It runs after [7b].

9. The many-stream engine (``runtime/scheduler.py``), cuDNN deterministic.
   (a) Two DenseNet-121 tenants at the published width on ``cuda:0``, 2 of
   4 slots each: A ``-ws 2 -b 512 --straggler 3,1 --fault_mode virtual
   --packed off --n_train 2048``, 2 epochs, DBS under a timing model (its
   partitions fixed); B the same model with ``-dbs false --seed 77``
   (packed), 3 epochs. Each alone through ``Trainer.run()``, then both
   through one ``MultiStreamEngine(n_devices=4, device="cuda")``, each on
   its own thread and stream. Checks: both done, no migration; each
   tenant's losses, partitions and parameters (SHA-256) equal its run alone
   bit for bit; B captures nothing from window 2 on; A moves share off
   worker 0; K1 (tiled route only) and K2 launched on each tenant's
   streams; A captures new keys in window 1 while B replays, and none of
   those captures overlaps B's epoch (``train/supersteps.py``
   ``CAPTURE_GATE``). Printed: both arms' walls and their ratio, each
   tenant's epoch walls in both and its makespan, ``stats()`` (its
   ``device_idle_fraction`` is the pool's slots' idle share), the peak
   memory, the card. (b) The JAX ``tests/test_scheduler.py`` heavy/light
   migration: MnistNet ``-ws 8 -b 64 -dbs false``, two tenants over 8
   slots, epoch walls modeled as demand / slots (24 : 8), 3 epochs. Checks:
   both done, each migrated, the last window 6:2, a fresh capture and a
   finite loss after every re-shard. Printed: each re-shard's seconds.

Every phase's seconds (each header to the next, a phase's sub-phases
summed) and each rank phase's seconds inside its launch are printed before
the JSON lines.

The last two lines are the kernels' JSON record (launches summed over every
path of this process; the ranks of [7]-[8] report their own) and the result line. Full tables go
to ``OUT``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import statistics
import sys
import time

from dynamic_load_balance_distributeddnn_tpu_torch.obs.kernel_timing import (
    attn_inputs,
    attn_work,
    attn_yardsticks,
    bound,
    bound_3xtf32,
    card,
    cuda_ms,
    device_ms,
    gn_work,
    kernel_us,
    timed,
    xent_inputs,
    xent_yardsticks,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")

MAIN_ARGV = (
    "-m densenet -ds cifar10 -d false -ws 4 -b 512 -gpu 0,0,0,0 "
    "--use_pallas true --straggler 3,1,1,1 --fault_mode virtual -e 3 "
    "--n_train 4096"
).split()
EPOCHS, WORKERS, GN_PER_FORWARD, MIN_STEPS = 3, 4, 120, 8
# [4b]: the same recipe on the elastic path with a compute-mode straggler
COMPUTE_ARGV = MAIN_ARGV[: MAIN_ARGV.index("--fault_mode")] + (
    "--fault_mode compute -e 3 --n_train 4096 --packed off").split()
# [4c]: the reference's random faults in compute mode, no straggler profile.
# Seed 213 (found with faults.LuckyFaultInjector on the CPU): no worker is
# hit in epoch 0, so the in-step iteration cost is calibrated there; worker
# 0 is hit in epoch 1 for 5 s an epoch until epoch 20; no other worker in
# epochs 0-2.
FT_SEED, FT_WORKER = 213, 0
FT_ARGV = (
    "-m densenet -ds cifar10 -d false -ws 4 -b 512 -gpu 0,0,0,0 -ft true -ftc 0.5 "
    f"--fault_mode compute -e 3 --n_train 4096 --seed {FT_SEED}"
).split()
# [4d]: one path a family at published widths, the reference's -m names
FAMILIES = ("resnet", "googlenet", "regnet")
FAMILY_EPOCHS = 1  # 2 until [4j] and [7b] joined: the script's time
FAMILY_ARGV = "-ds cifar10 -d false -ws 4 -b 512 -gpu 0,0,0,0 -e 1 --n_train 2048".split()
# [4e]: window-cadence rebalancing on the elastic path, 16 steps an epoch in
# 8 windows of 2, the 8:1 straggler of tests/test_online_dbs.py following a
# sin of one epoch's period as real synthetic load; and the same recipe at
# epoch cadence beside it; 2 epochs (3 until [4j] and [7b] joined: the
# script's time; the switches fall in epoch 1, the first on anchored rates)
WINDOW_ARGV = (
    "-m densenet -ds cifar10 -d false -ws 4 -b 512 -gpu 0,0,0,0 -e 2 --packed off "
    "--straggler 8,1,1,1 --fault_mode compute --fault_schedule sin --fault_period 1 "
    "--rebalance window --superstep_window 2 --n_train 8192"
).split()
WINDOW_EPOCHS = 2
EPOCH_CADENCE_ARGV = [("epoch" if a == "window" else a) for a in WINDOW_ARGV]
# [4e]'s graphed runs are [4m]'s on arm: the warm service with its warm start
WARM_ARGV = ["--warm_start", "true"]
# [4e] under --superstep off: the JAX package cuts the eager elastic epoch's
# windows at stream_chunk_steps alone (128 by default: one window, so no
# evaluation), so the off arm cuts them there at superstep_window's 2 steps
WINDOW_OFF_ARGV = WINDOW_ARGV + ["--superstep", "off", "--stream_chunk_steps", "2"]
# [4e]'s wall feedback: with the host formula (its launch time subtracted)
# the controller read wall_scale 0.37-0.43 at the end of its graphed runs
# (NVIDIA H100 80GB HBM3, 700 W), printed beside this run's
HOST_FORMULA_WALL_SCALE = "0.37-0.43"
WALL_SCALE_CLIP = (0.25, 4.0)

LM_ARGV = (
    "-m transformer -ds wikitext2 -d false -ws 4 -b 80 -gpu 0,0,0,0 --bptt 35 "
    "--grad_clip 0.25 --straggler 3,1,1,1 --fault_mode virtual "
    "--use_flash_attention true -e 3"
).split()
# [5c]: the same recipe at --bptt 256, above K3's short route (T <= 64):
# 2,720 tokens a column make 11 windows of 256 an epoch (the last one with
# 159 real tokens, padded with zero weights, as in the JAX package)
LM_LONG_ARGV = LM_ARGV[:LM_ARGV.index("--bptt") + 1] + ["256"] + LM_ARGV[LM_ARGV.index("--bptt") + 2:]
LM_LONG_STEPS = 11


# 2 epochs (3 until the tree's phase [7b] joined) of 2,048 examples (4,096
# until [9] joined): the script's time
DIST_ARGV = ("-m densenet -ds cifar10 -ws 2 -b 512 -gpu 0,0 --straggler 3,1 "
             "--fault_mode virtual -e 2 --n_train 2048").split()
DIST_ARMS = (
    ("a", "the default DBS path (window-mode elastic epochs)", []),
    ("b", "--fused_dbs true", ["--fused_dbs", "true"]),
    ("c", "the fused path, --grad_accum 2, the int8 wire, ZeRO-1",
     ["-dbs", "false", "--grad_accum", "2", "--compress_grads", "int8", "--shard_update", "true"]),
)
DIST_RANKS = 2
DIST_SHARE_MAX = 0.40
# [7b]: four ranks on cuda:0 over gloo, DenseNet-121 at its published width,
# --grad_comm hier on a synthetic two-host split (the tree (2, 2)), 2 epochs
# of 2,048 examples (4,096 until [9] joined: the script's time; at 1,024 the
# loss of arm (a) did not fall over the two epochs on an H100)
HIER_ARGV = ("-m densenet -ds cifar10 -ws 4 -b 512 -gpu 0,0,0,0 --straggler 3,1,1,1 "
             "--fault_mode virtual -e 2 --n_train 2048 --grad_comm hier --hier_hosts 2").split()
HIER_ARMS = (
    ("a", "the default wires (int8 outer hop, fp32 inner), DBS on", []),
    ("b", "--grad_comm_wires int4,fp32 --shard_update true",
     ["--grad_comm_wires", "int4,fp32", "--shard_update", "true"]),
    ("c", "--hier_levels learned --dcn_bandwidth_probe true --grad_comm_wires auto",
     ["--hier_levels", "learned", "--dcn_bandwidth_probe", "true", "--grad_comm_wires", "auto"]),
)
HIER_RANKS = 4
# [7c]: the language model over two ranks on cuda:0 (gloo), BASELINE.md
# config 5 at full width ([5]'s recipe at -ws 2), the arms of [7]
LM_DIST_ARGV = ("-m transformer -ds wikitext2 -d false -ws 2 -b 80 -gpu 0,0 --bptt 35 "
                "--grad_clip 0.25 --straggler 3,1 --fault_mode virtual "
                "--use_flash_attention true -e 2").split()
LM_DIST_ARMS = (
    ("a", "the default DBS path (window-mode elastic epochs)", []),
    ("b", "--fused_dbs true", ["--fused_dbs", "true"]),
    ("c", "the fused path, --grad_accum 2, the int8 wire, ZeRO-1",
     ["-dbs", "false", "--grad_accum", "2", "--compress_grads", "int8", "--shard_update", "true"]),
)
# [7b]'s fourth arm: the language model on the tree (2, 2), 4 ranks
HIER_LM_ARGV = ("-m transformer -ds wikitext2 -d false -ws 4 -b 80 -gpu 0,0,0,0 --bptt 35 "
                "--grad_clip 0.25 --straggler 3,1,1,1 --fault_mode virtual "
                "--use_flash_attention true -e 2 --grad_comm hier --hier_hosts 2").split()
# [8]: sequence parallelism over two ranks on cuda:0, the LM at full width on
# [B = 32, T = 1024] windows (6 full windows an epoch of the committed files)
SP_ARGV = "-m transformer -ds wikitext2 -d false -ws 2 -b 32 -gpu 0,0 --bptt 1024 -e 2".split()
SP_MODES = ("ring", "ulysses")
SP_B, SP_T = 32, 1024
SP_ATTN_TOL = (2e-5, 5e-4)  # forward, gradients: K3 against the plain local attention
SP_LOSS_RTOL, SP_GRAD_ATOL = 1e-5, 5e-4  # the CPU tests' (tests/test_torch_seq_parallel.py)
# each launch's time limit: the ranks start once and run every arm of their phases
RANKS2_TIMEOUT_S = 900
RANKS4_TIMEOUT_S = 600
# [7d]: --elastic on across processes, two processes on cuda:0 over gloo
# brought up through rendezvous.elastic_initialize (tests/_torch_mh_worker.py
# is the harness): DenseNet-121 at its published width, -ws 4 -b 512
# --straggler 3,1,1,1 --fault_mode virtual --n_train 2048 (4,096 until [4l]
# joined: the script's time), 4 epochs; process 1 killed when it writes its
# marker before its third combine of epoch 1 (4 steps an epoch), respawned
# as a joiner and readmitted at epoch 3. Its checkpoints go under SCRATCH
# (too big for OUT)
MH_WORKER = os.path.join(ROOT, "tests", "_torch_mh_worker.py")
MH_ENV = {"DBS_MH_DEVICE": "cuda", "DBS_MH_MODEL": "densenet", "DBS_MH_DATASET": "cifar10",
          "DBS_MH_BATCH": "512", "DBS_MH_NTRAIN": "2048", "DBS_MH_STRAGGLER": "3,1,1,1",
          "DBS_MH_WS": "4", "DBS_MH_EPOCHS": "4", "DBS_MH_JOIN_AT": "3",
          "DBS_MH_STEP_MARKER": "1:1:2",
          "DBS_PEER_HB_PERIOD_S": "0.2", "DBS_PEER_HB_STALE_S": "2.0", "DBS_RDZV_TIMEOUT_S": "120"}
MH_TIMEOUT_S = 400
# [9]: the many-stream engine (runtime/scheduler.py). (a) two DenseNet-121
# tenants at the published width on cuda:0 over a 4-slot pool, 2 slots
# each: A is [4]'s recipe halved (3:1 virtual straggler, DBS, the partitions
# fixed by a timing model) on the elastic path, whose step keys follow the
# workers' widths, so A captures new keys in epoch 1 while B, the same model
# with DBS off and another seed on the packed path (the defaults), replays;
# A 2 epochs, B 3 (window 2 then shows B's steady window; the script's time)
MS_A_ARGV = ("-m densenet -ds cifar10 -d false -ws 2 -b 512 -gpu 0,0 --straggler 3,1 "
             "--fault_mode virtual -e 2 --n_train 2048 --superstep auto --packed off").split()
MS_B_ARGV = MS_A_ARGV[:MS_A_ARGV.index("--straggler")] + (
    "-dbs false --seed 77 -e 3 --n_train 2048 --superstep auto").split()
MS_SLOTS, MS_TENANT_SLOTS = 4, {"a": (0, 1), "b": (2, 3)}
# (b) tests/test_scheduler.py's heavy/light migration: MnistNet, 8 ranks a
# tenant over an 8-slot pool, modeled epoch walls demand / slots (24 : 8)
MS_MIGRATE_ARGV = "-m mnistnet -ds mnist -d true -ws 8 -b 64 -dbs false -e 3 --n_train 1024".split()
MS_DEMAND = {"heavy": 24.0, "light": 8.0}
MS_MIGRATE_SEEDS = {"heavy": 11, "light": 22}


def with_epochs(argv, epochs: int):
    """``argv`` with its ``-e`` value replaced."""
    i = argv.index("-e")
    return argv[:i + 1] + [str(epochs)] + argv[i + 2:]


def with_n_train(argv, n: int):
    """``argv`` with its ``--n_train`` value replaced."""
    i = argv.index("--n_train")
    return argv[:i + 1] + [str(n)] + argv[i + 2:]


# [4m] (a): [4e]'s epoch-cadence twin on 2,048 examples (4 steps an epoch),
# in virtual mode (under a timing model compute mode would inject nothing:
# the load's iterations come from probed costs), the plans fixed by a timing
# model so that the two arms can be held bit for bit; 7 epochs under the
# one-cycle policy, whose decay epochs (5 and 6) each run a new learning
# rate, so a new key: the trajectory predictor's velocity has decayed by
# then (the plan converges at epoch 1) and it predicts their tuple
WARM_BITS_ARGV = [("virtual" if a == "compute" else a)
                  for a in with_epochs(with_n_train(EPOCH_CADENCE_ARGV, 2048), 7)] + ["-ocp", "true"]
WARM_BITS_EPOCHS = 7


# [4] and [4e] run traced; [4i] reads their traces and spools. What is too
# big to bring back (checkpoints, the profiler's trace) stays under build/.
TRACE_DIR = os.path.join(OUT, "trace")
SCRATCH = os.path.join(ROOT, "build", "chip_smoke")


def traced(tag: str, mode: str):
    """The flags that trace a run (``--trace`` ``mode``) with a spool."""
    d = os.path.join(TRACE_DIR, tag)
    shutil.rmtree(d, ignore_errors=True)
    return ["--trace", mode, "--trace_dir", d, "--trace_spool", os.path.join(d, "spool")]


# [4f] and [5b]: --precision bfloat16 (bf16 compute over f32 master
# weights): the vision defaults for 3 epochs, the same on the elastic path
# (--packed off: the elastic step and the probes in bf16) for 2 epochs of
# 4 steps (2,048 examples: the arm is cut to keep the script's time), and
# the language model for 2
BF16 = ["--precision", "bfloat16"]
BF16_ARGV = MAIN_ARGV + BF16
BF16_ELASTIC_EPOCHS, LM_BF16_EPOCHS = 2, 2
BF16_PACKED_EPOCHS = 2  # 3 until [4j] and [7b] joined: the script's time
BF16_ELASTIC_ARGV = (with_epochs(MAIN_ARGV, BF16_ELASTIC_EPOCHS)[:-2]
                     + ["--n_train", "2048", "--packed", "off"] + BF16)
LM_BF16_ARGV = with_epochs(LM_ARGV, LM_BF16_EPOCHS) + BF16
# [4h]: stop and resume, 2 epochs each (cut from 3 to keep the script's
# time), every epoch probed (so the whole and the resumed run train the
# last epoch on one plan)
RESUME_EPOCHS = 2
# [4k]: --elastic on in one process at [4]'s width: the elastic path
# (--packed off) in windows of 2 steps, the boundaries of the liveness
# checks; worker 3 lost at epoch-time 1.4 and back at epoch 3 (a
# PreemptionInjector over the 3:1 straggler). 6 epochs: the readmission
# seeds the shares at the probed clean costs (the returning worker's from
# a 16-row probe, which over-reads its cost), and the solver takes two
# epochs after it to move that worker's share above the straggler's
ELASTIC_ARGV = with_epochs(MAIN_ARGV, 6) + (
    "--elastic on --superstep auto --packed off --superstep_window 2").split()
ELASTIC_EVENT = (3, 1.4, 3)  # worker, down_at, rejoin_epoch
# [4l]: the host-fed path at [4]'s width, 2 epochs in windows of 2 steps
# (8 steps an epoch: 4 windows), packed and elastic, each arm beside its
# resident twin; DBS under a timing model (the walls of real probes would
# move one twin's plans off the other's)
HOST_FED_ARGV = with_epochs(MAIN_ARGV, 2) + ["--stream_chunk_steps", "2"]
HOST_FED_ARMS = (("packed", []), ("elastic", ["--packed", "off"]))
ELASTIC_ALIVE = [4.0, 3.0, 3.0, 4.0, 4.0, 4.0]
# [7] (c) and [7b] (b): the whole run saves a checkpoint an epoch, and a
# third job resumes from a copy of its epoch-0 checkpoint alone (the run as
# if stopped there); 56 MB a checkpoint, so under SCRATCH
RANK_CKPT = os.path.join(SCRATCH, "ranks_ckpt")
RESUMED_ARMS = {"dist": "c", "hier": "b"}  # [7]'s and [7b]'s resumed arm
# [4h]'s recipes: DenseNet-121 at 1,024 examples, two steps an epoch at
# -b 512, so the resumed epoch checks a step after the first one following
# the restore (the restored generators and step counter carried into a
# second step); the LM at half its tokens since [4l] joined (the script's
# time), still dozens of steps an epoch
RESUME_RECIPES = (("densenet packed", with_epochs(with_n_train(MAIN_ARGV, 1024), RESUME_EPOCHS)),
                  ("densenet elastic compute",
                   with_epochs(with_n_train(COMPUTE_ARGV, 1024), RESUME_EPOCHS)),
                  ("language model",
                   with_epochs(LM_ARGV, RESUME_EPOCHS) + ["--n_train", "108800"]))
# [4i]: [4f]'s packed bf16 recipe under the profiler, cut to 1 epoch of 2
# steps, both replayed from its graph (2 epochs traced 1.7M events)
PROFILE_ARGV = with_n_train(with_epochs(BF16_ARGV, 1), 1024)
# [6b]: the card's bf16 error from the CPU's f64 run within this multiple
# of the CPU's own bf16 error (for the scalar loss, or of one bf16 step of
# its f64 value, where that is larger: one number can land near f64 by
# chance; the gradient's largest error over its entries cannot)
BF16_CARD_MULTIPLE = 4
VAL_CHUNKS = -(-10000 // 1024)  # the CIFAR-10 test set in train/engine.py's chunks
# 217,646 training tokens over 80 columns make 2,720 rows, 78 windows of 35
# tokens per epoch; 70 leaves room for the rounding of the column split
LM_LAYERS, LM_MIN_STEPS = 2, 70
# K3 shapes (B, H, T, D): the language model's, T = bptt, D = 200 / 2 heads,
# B the columns of a worker's step: 3 for the straggler after rebalancing,
# 20 under the uniform first plan, 26 for the others after it, and 40, the
# JSON line's shape, kept from the earlier slices' records; the validation
# chunk of 1,024 windows (forward only); the long-context shape of
# scripts/kernel_bench.py, which takes the tiled kernels (T > 64)
ATTN_PATH_SHAPE, ATTN_LONG_SHAPE = (40, 2, 35, 100), (4, 4, 2048, 128)
ATTN_PATH_SHAPES = ((3, 2, 35, 100), (20, 2, 35, 100), (26, 2, 35, 100), ATTN_PATH_SHAPE)
ATTN_VAL_SHAPE = (1024, 2, 35, 100)
ATTN_TILED = ("attn_fwd_tiled", "attn_bwd_dkv", "attn_bwd_dq")
# K3 at [5c] (the tiled route): a worker's step at 3 and 26 columns of 256
# tokens (the straggler's and the others' after rebalancing), and the
# validation chunk: 457 of the test stream's 960 rows of 256 (the most
# whose logits over 18,328 words one K2 call takes, lm_engine.eval_rows)
ATTN_LM_LONG_SHAPES = ((3, 2, 256, 100), (26, 2, 256, 100))
ATTN_LM_LONG_VAL_SHAPE = (457, 2, 256, 100)
# K2 on the language model's path, over the 18,328-word vocabulary of the
# committed wikitext-2 files: 80 columns x 35 tokens split over 4 workers
# give 700 rows a worker under the first (uniform) plan; after rebalancing
# the straggler takes about 105 rows (3 columns) and each other worker about
# 910; validation runs 1,024-window chunks, 35,840 rows (forward only).
# XENT_LM_SHAPE, 40 columns (the size of two uniform workers' logits), is the
# JSON line's shape, kept from the earlier slices' records.
XENT_LM_V = 18328
XENT_LM_SHAPE = (40 * 35, XENT_LM_V)
XENT_PATH_ROWS = (105, 700, 910, 40 * 35)
XENT_VAL_ROWS = 1024 * 35
XENT_FULL_V = 33278  # wikitext-2's vocabulary once train.txt is present
# K2 in [8]: a rank's half of the [32, 1024] window (its step) and of a
# validation chunk of 10 windows
XENT_SP_ROWS = (SP_B * SP_T // DIST_RANKS, 10 * SP_T // DIST_RANKS)
CNN_KERNELS = ("groupnorm_fwd", "groupnorm_bwd", "xent_fwd", "xent_bwd")
SYNTH_ITERS = 1000  # the synthetic load's timed call
GN_GENERAL = ("groupnorm_fwd_general", "groupnorm_bwd_general")
# K1 on bf16 activations: the launch counters' bf16 shares, and the JSON
# line's bf16 rows (a packed pass of DenseNet-121, b = 512)
GN_BF16 = ("groupnorm_fwd_bf16", "groupnorm_bwd_bf16")
XENT_BF16 = ("xent_fwd_bf16", "xent_bwd_bf16")
# K1 is timed over one DenseNet-121 worker pass at 128, the batch of the
# uniform first plan (512 / 4 workers), of the JSON line's rows and of the
# earlier slices' records (the rebalanced plans' 32 and 160 are checked in
# [3] and [4], no longer timed: the script's time)
GN_BATCHES, GN_LINE_BATCH = (128,), 128
# and over one packed step's pass, b = 512: DenseNet-121's
GN_PACKED_B = 512
# [6]: weight seeds of the card-vs-CPU comparison, and its bound on the first
# conv's gradient against the CPU's f64 run, for every model. Readings on an
# H100 over these seeds: the card 4.3e-5 to 8.4e-5 from f64 on DenseNet-121,
# 1.7e-6 to 6.1e-5 on ResNet-18, 9.4e-4 to 1.73e-3 on RegNetY-400MF, whose
# gradient is ill-conditioned in f32 (the CPU's own f32 run is 1.1e-3 to
# 2.8e-3 from f64 there)
CARD_VS_CPU_SEEDS = (0, 1, 2)
GRAD_ATOL_F64 = 2e-3
LM_KERNELS = ("attn_fwd", "attn_bwd", "xent_fwd", "xent_bwd")


def log(*a):
    print(*a, flush=True)


_GN_CALLS = {}  # (family, batch): its GroupNorm calls, read once


def model_gn_shapes(torch, dev, name: str, b: int, with_relu: bool = False, dtype=None):
    """The ``(B, S, C, groups)`` of every GroupNorm call in one forward of
    ``-m name`` at batch ``b`` (``with_relu``: ``(B, S, C, groups, relu)``),
    read off the model with forward hooks (once a family and batch), and how
    many of them ``plan`` sends to the general route (forward and backward)
    on ``dtype`` activations (f32 unless given). DenseNet-121's are checked
    against ``gn_shapes``."""
    from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model
    from dynamic_load_balance_distributeddnn_tpu_torch.models.common import GroupNorm
    from dynamic_load_balance_distributeddnn_tpu_torch.models.densenet import gn_shapes
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import plan

    calls = _GN_CALLS.get((name, b))
    if calls is None:
        model = build_model(name).to(dev, memory_format=torch.channels_last)
        calls = []

        def hook(m, inp, out):
            n, c, h, w = inp[0].shape
            calls.append((n, h * w, c, m.num_groups, m.relu))

        handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, GroupNorm)]
        with torch.no_grad():
            model(torch.zeros(b, 32, 32, 3, device=dev))
        for h in handles:
            h.remove()
        del model
        torch.cuda.empty_cache()
        if name == "densenet":
            assert len(calls) == GN_PER_FORWARD, len(calls)
            assert [sh[:3] for sh in calls] == gn_shapes(b, (6, 12, 24, 16), 32), \
                "models/densenet.py gn_shapes is off"
        _GN_CALLS[(name, b)] = calls
    shapes = list(calls) if with_relu else [sh[:4] for sh in calls]
    general = sum(plan(bb, ss, c, g, dtype or torch.float32, back).route == "general"
                  for bb, ss, c, g, *_ in shapes for back in (False, True))
    return shapes, general


# K1's tolerances by dtype: (y, dx and dscale/dbias absolute, relative).
# f32: forward 1e-4 and dx 5e-4 (f32 statistics, another reduction order);
# dscale/dbias are sums over B*S terms, so their error is also held relative
# to their size (1e-4); bf16 rounds inputs and outputs to 8 significant bits
# (2e-2 plus 1e-2 relative); the saved statistics are f32 sums of the same
# values in another order (1e-5 plus 1e-5 relative) in both
GN_TOL = {"torch.float32": (1e-4, 5e-4, 0.0), "torch.bfloat16": (2e-2, 2e-2, 1e-2)}


def gn_case(torch, rand, shape, groups, relu, dtype, launch, what, records):
    """One K1 check on the inputs ``rand`` draws: the forward under
    ``launch[0]`` against ``group_norm_ref`` (y) and ``group_norm_stats_ref``
    (its saved mean and rstd), the backward under ``launch[1]`` twice,
    identical bits, against ``group_norm_bwd_ref`` from the kernel's own
    saved statistics (autograd through ``group_norm_ref`` would take the relu
    mask from its own statistics, which differ in the last bits, and at
    these sizes some pre-activation lies within that rounding of zero: at
    (32, 1024, 64) bf16 one is -3.7e-8). Returns the largest errors of y,
    dx and dscale/dbias."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import (
        group_norm_bwd,
        group_norm_bwd_ref,
        group_norm_fwd,
        group_norm_ref,
        group_norm_stats_ref,
    )

    ty, tg, rt = GN_TOL[str(dtype)]
    c = shape[-1]
    x = rand(shape).to(dtype)
    dy = rand(shape).to(dtype)
    w = 1 + 0.1 * rand((c,))
    b = 0.1 * rand((c,))
    y, mean, rstd = group_norm_fwd(x, w, b, groups, 1e-6, relu, launch=launch[0])
    dx, dw, db = group_norm_bwd(x, dy, w, b, mean, rstd, groups, relu, launch=launch[1])
    again = group_norm_bwd(x, dy, w, b, mean, rstd, groups, relu, launch=launch[1])
    assert all(torch.equal(u, v) for u, v in zip((dx, dw, db), again)), \
        f"groupnorm {shape} {what}: backward bits differ between runs"
    del again
    yr = group_norm_ref(x.float(), w, b, groups, 1e-6, relu)
    e_y = (y.float() - yr).abs().max().item()
    torch.testing.assert_close(y.float(), yr, atol=ty, rtol=rt)
    del y, yr
    mean_r, rstd_r = group_norm_stats_ref(x, groups, 1e-6)
    torch.testing.assert_close(mean, mean_r, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstd_r, atol=1e-5, rtol=1e-5)
    gx, gw, gb = group_norm_bwd_ref(x.float(), dy.float(), w, b, mean, rstd, groups, relu)
    e_x = (dx.float() - gx).abs().max().item()
    e_p = max((dw - gw).abs().max().item(), (db - gb).abs().max().item())
    log(f"  groupnorm {str(dtype)[6:]:8s} {shape} G={groups} relu={relu} ({what}): "
        f"|dy| {e_y:.2e}  |dx| {e_x:.2e}  |dscale,dbias| {e_p:.2e}")
    torch.testing.assert_close(dx.float(), gx, atol=tg, rtol=rt)
    torch.testing.assert_close(dw, gw, atol=tg, rtol=max(rt, 1e-4))
    torch.testing.assert_close(db, gb, atol=tg, rtol=max(rt, 1e-4))
    records.append({"kernel": "groupnorm", "dtype": str(dtype), "shape": shape,
                    "groups": groups, "relu": relu, "plan": [list(p) for p in launch],
                    "err_y": e_y, "err_dx": e_x, "err_params": e_p})
    return e_y, e_x, e_p


def check_groupnorm(torch, dev, records):
    """K1 forward and backward against their plain versions on the same
    inputs (``gn_case``), f32 and bf16: DenseNet-121 shapes at b = 32, 128
    and 160 (each stage; relu on, the main path, and once off) on the route
    ``plan`` picks, the tiled one, with a cluster and without; the general
    route, forced on a DenseNet shape, and as ``plan`` picks it for C = 18
    (C % 4 != 0); then every distinct (S, C, groups, relu) of a GroupNorm
    call in DenseNet-121, ResNet-101, GoogLeNet and RegNetY-400MF (read off
    the models by ``model_gn_shapes``) at a packed step's b = 512, on the
    route and cluster ``plan`` picks. Returns the largest f32 errors of the
    tiled route (``groupnorm_fwd``/``_bwd``) and of the general one, and the
    tiled route's largest bf16 errors (``groupnorm_fwd_bf16``/``_bwd_bf16``)."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import (
        general_plan,
        plan,
    )

    gen = torch.Generator().manual_seed(0)
    # (shape, groups, forced onto the general route); the tiled plans of
    # the DenseNet shapes split S over a cluster at S = 1,024 (and the
    # backward's at S = 256, C = 480), and not at S = 16 or 64
    cases = [((128, 1024, 64), 32, False), ((128, 1024, 224), 32, False),
             ((128, 256, 480), 32, False), ((128, 64, 992), 32, False), ((128, 16, 1024), 32, False),
             ((32, 1024, 64), 32, False), ((32, 256, 128), 32, False), ((32, 64, 992), 32, False),
             ((32, 16, 544), 32, False),
             ((160, 1024, 96), 32, False), ((160, 256, 320), 32, False), ((160, 64, 512), 32, False),
             ((160, 16, 1024), 32, False),
             ((32, 1024, 64), 32, True), ((8, 256, 18), 6, False)]
    cases = [(shape, groups, general, relu) for n, (shape, groups, general) in enumerate(cases)
             for relu in ((True, False) if n == 0 else (True,))]
    packed = set()
    for name in ("densenet",) + FAMILIES:
        packed.update(model_gn_shapes(torch, dev, name, GN_PACKED_B, with_relu=True)[0])
    packed = sorted(packed)
    log(f"  K1 at a packed step's b = {GN_PACKED_B}: {len(packed)} distinct (S, C, groups, relu) "
        f"of DenseNet-121, ResNet-101, GoogLeNet and RegNetY-400MF")
    cases += [((bb, s, c), g, False, relu) for bb, s, c, g, relu in packed]
    err = {k: 0.0 for k in ("groupnorm_fwd", "groupnorm_bwd") + GN_GENERAL + GN_BF16}
    for dtype in (torch.float32, torch.bfloat16):
        on_card = torch.Generator(device=dev).manual_seed(3)
        for shape, groups, general, relu in cases:
            bsz, s, c = shape
            if bsz == GN_PACKED_B:  # drawn on the card: these inputs reach 2**27 elements
                rand = lambda shp: torch.randn(shp, generator=on_card, device=dev)  # noqa: E731
            else:
                rand = lambda shp: torch.randn(shp, generator=gen).to(dev)  # noqa: E731
            launch = [general_plan(s, c // groups, back) if general
                      else plan(bsz, s, c, groups, dtype, back) for back in (False, True)]
            route = launch[0].route
            assert launch[1].route == route
            what = f"{route}" + (f", cluster {launch[0].cluster}/{launch[1].cluster}" if route == "tiled" else "")
            e_y, e_x, e_p = gn_case(torch, rand, shape, groups, relu, dtype, launch, what, records)
            if dtype == torch.float32:
                keys = GN_GENERAL if route == "general" else ("groupnorm_fwd", "groupnorm_bwd")
            else:
                keys = GN_BF16 if route == "tiled" else ()
            if keys:
                err[keys[0]] = max(err[keys[0]], e_y)
                err[keys[1]] = max(err[keys[1]], e_x, e_p)
            torch.cuda.empty_cache()
    return err


def dlogits_ratio(torch, dx, want, labels, g, rtol: float) -> float:
    """The largest ratio of |dx - want| to its limit, ``rtol * |want|``
    plus, on the gold column, where p - 1 cancels, ``2**-21 * g`` (four f32
    steps of a p near 1): above 1 fails. The limit follows each entry's own
    size: at V = 18,328 a typical entry is about g * 1e-6, far below any
    absolute tolerance that the gold column would need."""
    gold = torch.arange(want.shape[-1], device=want.device) == labels[:, None]
    lim = rtol * want.abs() + gold * (2.0**-21 * g[:, None])
    return ((dx.float() - want).abs() / lim.clamp_min(1e-38)).max().item()


def check_xent(torch, dev, records):
    """K2 forward and backward against their plain versions (the backward's
    with the kernel's own lse) on the same inputs: [128, 10] (one DenseNet
    worker's logits), [512, 10] (a packed step's), [1400, 18328] (the language model's), [105, 33278]
    (the full wikitext-2 vocabulary, rows off 16-byte boundaries), [16384,
    18328] and [5120, 18328] (a rank's step and validation chunk in [8]), each in
    f32 and bf16, with two labels out of range in the first; and logits[1:]
    of a [14, 10] tensor, a base off a 16-byte boundary. Tolerance: loss and
    lse atol 1e-5 (f32 sums in another order); each gradient entry within
    rtol 1e-5 of the plain version's in f32 (the same f32 expression; room
    for an exp a few steps apart), and for bf16 within rtol 2**-8 + 1e-5
    (the kernel rounds once to bf16's 8 significant bits), the gold column
    also within 2**-21 * g (see ``dlogits_ratio``)."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import (
        xent_bwd,
        xent_bwd_ref,
        xent_fwd,
        xent_fwd_ref,
    )

    gen = torch.Generator().manual_seed(1)
    err = {"xent_fwd": 0.0, "xent_bwd": 0.0}
    cases = [(128, 10), (512, 10), XENT_LM_SHAPE, (105, XENT_FULL_V)] + [
        (r, XENT_LM_V) for r in XENT_SP_ROWS]
    for dtype in (torch.float32, torch.bfloat16):
        rtol = 1e-5 if dtype == torch.float32 else 2.0**-8 + 1e-5
        for i, (r, v) in enumerate(cases + [(14, 10)]):
            logits = (3 * torch.randn(r, v, generator=gen)).to(dev, dtype)
            labels = torch.randint(0, v, (r,), generator=gen)
            labels[0], labels[-1] = 0, v - 1
            if i == 0:
                labels[1], labels[2] = -1, v  # out of range: gold 0, no onehot
            labels = labels.to(dev)
            g = (torch.rand(r, generator=gen) / 512).to(dev)
            what = f"[{r}, {v}]"
            if i == len(cases):  # a row slice: its base is off 16 bytes
                logits, labels, g = logits[1:], labels[1:], g[1:]
                assert logits.is_contiguous() and logits.data_ptr() % 16 != 0
                what = f"[{r}, {v}][1:]"
            loss, lse = xent_fwd(logits, labels)
            dx = xent_bwd(logits, labels, g, lse)
            loss_r, lse_r = xent_fwd_ref(logits, labels)
            dx_r = xent_bwd_ref(logits.float(), labels, g, lse)
            torch.cuda.synchronize()
            e_f = max((loss - loss_r).abs().max().item(), (lse - lse_r).abs().max().item())
            e_b = (dx.float() - dx_r).abs().max().item()
            ratio = dlogits_ratio(torch, dx, dx_r, labels, g, rtol)
            log(f"  xent {str(dtype)[6:]:8s} {what}: |loss, lse| {e_f:.2e}  |dlogits| {e_b:.2e} "
                f"(at most {ratio:.3f} of its limit, median |dlogits| "
                f"{dx_r.abs().median().item():.2e})")
            torch.testing.assert_close(loss, loss_r, atol=1e-5, rtol=0)
            torch.testing.assert_close(lse, lse_r, atol=1e-5, rtol=0)
            assert ratio <= 1.0, f"xent {dtype} {what}: dlogits off by {ratio:.3g} of its limit"
            assert dx.dtype == dtype
            if dtype == torch.float32:
                err["xent_fwd"] = max(err["xent_fwd"], e_f)
                err["xent_bwd"] = max(err["xent_bwd"], e_b)
            records.append({"kernel": "xent", "dtype": str(dtype), "shape": what,
                            "err_loss_lse": e_f, "err_dlogits": e_b, "dlogits_ratio": ratio})
    return err


def time_groupnorm(torch, dev, shapes, general: bool = True, dtype=None):
    """K1 over a pass of GroupNorm calls, ``shapes`` their ``(b, s, c,
    groups)``, forward and backward, relu on, activations in ``dtype`` (f32
    unless given; scale and bias f32 as the model passes them): the kernels
    on the route ``plan`` picks (the tiled one), with ``general`` the
    general route (the first port's kernels, "was") on the same inputs, the
    plain version and ``relu(F.group_norm)`` (cuDNN/ATen, the yardstick
    only; in bf16 with bf16 scale and bias, the call a bf16 model would
    make), and the bound from the bytes of that dtype. The backward
    yardsticks run 12 calls' autograd graphs at a time (their saved tensors
    at b = 512 would not fit at once), their device times summed."""
    from torch.nn import functional as F

    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import (
        general_plan,
        group_norm_bwd,
        group_norm_fwd,
        group_norm_ref,
    )

    dtype = dtype or torch.float32
    gen = torch.Generator(device=dev).manual_seed(2)
    calls = []
    for bb, s, c, g in shapes:
        x = torch.randn((bb, s, c), device=dev, generator=gen).to(dtype)
        dy = torch.randn((bb, s, c), device=dev, generator=gen).to(dtype)
        w = torch.ones(c, device=dev)
        bias = torch.zeros(c, device=dev)
        launch = (general_plan(s, c // g, False), general_plan(s, c // g, True))
        calls.append([x, dy, w, bias, g, None, None, launch])
    for call in calls:
        x, _, w, bias, g = call[:5]
        _, call[5], call[6] = group_norm_fwd(x, w, bias, g, 1e-6, True)

    def k_fwd(route=None):
        for x, _, w, bias, g, _, _, launch in calls:
            group_norm_fwd(x, w, bias, g, 1e-6, True, launch=route and launch[0])

    def k_bwd(route=None):
        for x, dy, w, bias, g, mean, rstd, launch in calls:
            group_norm_bwd(x, dy, w, bias, mean, rstd, g, True, launch=route and launch[1])

    def p_fwd():
        for x, _, w, bias, g, _, _, _ in calls:
            group_norm_ref(x, w, bias, g, 1e-6, True)

    def lib_view(x):  # [B, S, C] -> NCHW view in channels-last memory
        bb, s, c = x.shape
        h = int(round(s ** 0.5))
        return x.view(bb, h, h, c).permute(0, 3, 1, 2)

    def l_fwd():
        for x, _, w, bias, g, _, _, _ in calls:
            F.relu(F.group_norm(lib_view(x), g, w.to(dtype), bias.to(dtype), 1e-6))

    out = {"groupnorm_fwd": timed(k_fwd)}
    out["groupnorm_fwd"]["plain_ms"] = device_ms(p_fwd)
    out["groupnorm_fwd"]["library_ms"] = device_ms(l_fwd)
    out["groupnorm_bwd"] = timed(k_bwd)
    if general:
        out["groupnorm_fwd_general"] = timed(lambda: k_fwd("general"))
        out["groupnorm_bwd_general"] = timed(lambda: k_bwd("general"))
    # backward yardsticks: autograd through graphs built outside the timing
    for key, fwd in (("plain_ms", lambda x, w, bias, g: group_norm_ref(x, w, bias, g, 1e-6, True)),
                     ("library_ms", lambda x, w, bias, g: F.relu(F.group_norm(
                         lib_view(x), g, w.to(dtype), bias.to(dtype), 1e-6)))):
        total = 0.0
        for lo in range(0, len(calls), 12):
            graphs = []
            for x, dy, w, bias, g, _, _, _ in calls[lo:lo + 12]:
                xr, wr, br = (t.detach().requires_grad_() for t in (x, w, bias))
                y = fwd(xr, wr, br, g)
                graphs.append((y, (xr, wr, br), dy.view(y.shape) if y.dim() == 3 else lib_view(dy)))

            def bwd(graphs=graphs):
                for y, ins, grad in graphs:
                    torch.autograd.grad(y, ins, grad, retain_graph=True)

            total += device_ms(bwd)
            del graphs
            torch.cuda.empty_cache()
        out["groupnorm_bwd"][key] = total
    for k, (nbytes, flops) in gn_work(shapes, elem=torch.finfo(dtype).bits // 8).items():
        out[k]["bound_ms"], out[k]["bound_by"] = bound(nbytes, flops)
        if general:
            was = out[k + "_general"]
            was.update(plain_ms=out[k]["plain_ms"], library_ms=out[k]["library_ms"],
                       bound_ms=out[k]["bound_ms"], bound_by=out[k]["bound_by"])
            out[k]["was_ms"] = was["ms"]
    del calls
    torch.cuda.empty_cache()
    return out


def check_synthetic_load(torch, dev):
    """The compute-mode straggler's load (``ops/faultload.py``, the kernel
    in ``csrc/faultload.cu``): the kernel against the plain chain on the
    card at 0, 1, 3 and 300 iterations (atol 1e-6 and rtol 1e-5: the same
    f32 products, their sums in another order), its result repeating bit
    for bit; its calibrated cost an iteration; and, over a call of
    ``SYNTH_ITERS`` iterations, its device time (the JSON line's numbers)
    and the card's busy share, the profiler's kernel time over the
    CUDA-event wall (at least 90%), beside the plain chain's (one launch
    sequence an iteration from Python). Returns (max |error|, the
    readings)."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.faultload import SyntheticLoad, synthetic_load
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.faultload import SIZE, synthetic_load_cuda

    seed = torch.tensor(1.7, device=dev)
    err = 0.0
    for n in (0, 1, 3, 300):
        got, want = synthetic_load_cuda(n, seed), synthetic_load(n, seed)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
        assert torch.equal(got, synthetic_load_cuda(n, seed)), f"synthetic load x{n}: bits differ on a rerun"
        err = max(err, (got - want).abs().item())
    log(f"  synthetic load kernel vs plain chain at 0, 1, 3, 300 iterations: |error| {err:.3g}")
    us = SyntheticLoad().calibrate_iter_cost(dev) * 1e6
    out = {"us_per_iter": us}
    for name, fn in (("kernel", lambda: synthetic_load_cuda(SYNTH_ITERS, seed)),
                     ("plain", lambda: synthetic_load(SYNTH_ITERS, seed))):
        kernel, wall = device_ms(fn, reps=5), cuda_ms(fn, reps=5)
        out[name] = {"ms": kernel, "wall_ms": wall, "busy": kernel / wall}
        log(f"  synthetic load x{SYNTH_ITERS} ({name}): kernel {kernel:.3f} ms, event wall {wall:.3f} ms, "
            f"busy {100 * kernel / wall:.1f}%")
    log(f"  synthetic load: {us:.3f} us/iteration (calibrated, CUDA events)")
    # an iteration: a SIZE^3 product (two operations a multiply-add), then
    # tanh, scale and shift an element; the seed's fill and the final sum
    # once. Bytes: the seed read and the scalar written.
    flops = SYNTH_ITERS * (2 * SIZE**3 + 3 * SIZE**2) + 3 * SIZE**2
    b_ms, b_by = bound(8, flops)
    timing = {"ms": out["kernel"]["ms"], "wall_ms": out["kernel"]["wall_ms"],
              "plain_ms": out["plain"]["ms"], "bound_ms": b_ms, "bound_by": b_by,
              "library_ms": None}  # no one PyTorch call computes the chain
    log(f"  synthetic load x{SYNTH_ITERS}: bound {b_ms:.4f} ms ({b_by})")
    assert out["kernel"]["busy"] >= 0.9, f"the card is busy {out['kernel']['busy']:.2f} of the load's wall"
    return err, {**out, "timing": timing}


def time_xent(torch, dev):
    """K2 f32 at one DenseNet worker step's logits, [128, 10], a packed
    step's, [512, 10], at every row count of the language model's path over
    its 18,328-word vocabulary, and at [8]'s (``XENT_SP_ROWS``: a rank's
    step, [16,384, 18,328], and its validation chunk, [5,120, 18,328]),
    forward and backward (validation chunks forward only): the kernels
    beside their plain versions, ``F.cross_entropy(reduction="none")`` (the
    yardstick; its backward through autograd) and their bounds."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import xent_bwd, xent_fwd

    out = {}
    shapes = [(128, 10), (512, 10)] + [(r, XENT_LM_V) for r in XENT_PATH_ROWS + (XENT_VAL_ROWS,)
                                       + XENT_SP_ROWS]
    for r, v in shapes:
        backward = r not in (XENT_VAL_ROWS, XENT_SP_ROWS[1])  # validation runs no backward
        reps = 50 if backward and r * v < 10**8 else 5
        logits, labels, g, lse = xent_inputs(r, v, dev)
        row = xent_yardsticks(logits, labels, g, lse, reps, backward)
        row["xent_fwd"].update(timed(lambda: xent_fwd(logits, labels), reps))
        if backward:
            row["xent_bwd"].update(timed(lambda: xent_bwd(logits, labels, g, lse), reps))
        out[(r, v)] = row
        del logits, labels, g, lse
        torch.cuda.empty_cache()
    return out


def _close(torch, got, want, atol, what):
    """max |got - want|, after asserting it is within atol."""
    err = (got - want).abs().max().item()
    assert err <= atol, f"{what}: |error| {err:.3g} > {atol}"
    return err


def check_flash(torch, dev, records):
    """K3 against the plain versions on the same inputs, f32, to the JAX
    package's tolerances (forward 2e-5, gradients 5e-4).

    Short route (T <= 64), on the views the model passes ([B, T, H*D]
    buffers seen as [B, H, T, D]) and on contiguous tensors: the forward and
    the fused backward (from the kernel's own o and lse) at every language
    model shape, causal; the forward at the validation chunk; both at
    T in {1, 17, 35, 64}, causal and not; the backward twice, bit for bit;
    the autograd route through ``flash_attention`` against plain softmax
    attention. Tiled route: at the language model's shape, at [5c]'s
    shapes (T = 256: two worker steps, the validation chunk) and at the
    long-context shape, causal and not, the long one at forward 1e-4 and
    gradients 1e-3 (each output sums 2,048 products, in tiles in another
    order than cuBLAS's for the plain version); the backward twice at a
    [5c] shape, bit for bit; the blocks and warps an SM holds of each tiled
    kernel at D = 100 and 128 (for information)."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.flash_attention import (
        attention_ref,
        attn_bwd_dkv,
        attn_bwd_dq,
        attn_bwd_ref,
        attn_bwd_short,
        attn_bwd_short_ref,
        attn_fwd,
        attn_fwd_ref,
        attn_fwd_short,
        flash_attention,
        tiled_occupancy,
    )

    err = {k: 0.0 for k in ("attn_fwd", "attn_bwd") + ATTN_TILED}
    short = [(sh, True, True) for sh in ATTN_PATH_SHAPES] + [(ATTN_VAL_SHAPE, True, False)]
    short += [((4, 2, t, 100), causal, True) for t in (1, 17, 35, 64) for causal in (True, False)]
    for shape, causal, backward in short:
        for layout in ("model", "contiguous"):
            q, k, v, do = attn_inputs(shape, dev, 11, layout)
            o, lse = attn_fwd_short(q, k, v, causal)
            o_r, lse_r = attn_fwd_ref(q, k, v, causal)
            e = {"attn_fwd": max(_close(torch, o, o_r, 2e-5, f"attn_fwd {shape} o"),
                                 _close(torch, lse, lse_r, 2e-5, f"attn_fwd {shape} lse"))}
            if backward:
                got = attn_bwd_short(q, k, v, do, o, lse, causal)
                want = attn_bwd_short_ref(q, k, v, do, o, lse, causal)
                e["attn_bwd"] = max(_close(torch, g, w, 5e-4, f"attn_bwd {shape} d{n}")
                                    for g, w, n in zip(got, want, "qkv"))
            log(f"  flash attention short {shape} causal={causal} {layout}: |o, lse| "
                f"{e['attn_fwd']:.2e}" + (f"  |dq, dk, dv| {e['attn_bwd']:.2e}" if backward else ""))
            for key, val in e.items():
                err[key] = max(err[key], val)
            records.append({"kernel": "flash_attention_short", "shape": shape, "causal": causal,
                            "layout": layout, **e})
            del q, k, v, do, o, lse, o_r, lse_r
        torch.cuda.empty_cache()

    # the fused backward twice: identical bits (no float atomics)
    q, k, v, do = attn_inputs(ATTN_PATH_SHAPES[2], dev, 13)
    o, lse = attn_fwd_short(q, k, v, True)
    first, again = (attn_bwd_short(q, k, v, do, o, lse, True) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, again)), "attn_bwd: bits differ between runs"
    log("  flash attention short backward: identical bits on two calls")

    # the autograd route (what the model calls) against plain attention
    q, k, v, do = attn_inputs(ATTN_PATH_SHAPE, dev, 14)
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    qp, kp, vp = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = flash_attention(qs, ks, vs, causal=True)
    ref = attention_ref(qp, kp, vp, causal=True)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    for got, want in zip(torch.autograd.grad(out, (qs, ks, vs), do),
                         torch.autograd.grad(ref, (qp, kp, vp), do)):
        torch.testing.assert_close(got, want, atol=5e-4, rtol=0)
    del q, k, v, do, o, lse, first, again, qs, ks, vs, qp, kp, vp, out, ref

    for d in (100, 128):
        log(f"  flash attention tiled, D={d}: (blocks an SM, warps an SM, shared bytes a block, "
            f"columns a row) {tiled_occupancy(d)}")
    path_shapes = (ATTN_PATH_SHAPE,) + ATTN_LM_LONG_SHAPES + (ATTN_LM_LONG_VAL_SHAPE,)
    for shape, causal, tf, tg in [(sh, True, 2e-5, 5e-4) for sh in path_shapes] + [
        (ATTN_LONG_SHAPE, causal, 1e-4, 1e-3) for causal in (True, False)
    ]:
        b, h, t, d = shape
        q, k, v, do = (x.reshape(b * h, t, d) for x in attn_inputs(shape, dev, 11, "contiguous"))
        o, lse = attn_fwd(q, k, v, causal)
        delta = (do * o).sum(-1)
        dk, dv = attn_bwd_dkv(q, k, v, do, lse, delta, causal)
        dq = attn_bwd_dq(q, k, v, do, lse, delta, causal)
        o_r, lse_r = attn_fwd_ref(q, k, v, causal)
        dq_r, dk_r, dv_r = attn_bwd_ref(q, k, v, do, lse, delta, causal)
        e = {
            "attn_fwd_tiled": max(_close(torch, o, o_r, tf, f"attn_fwd_tiled {shape}"),
                                  _close(torch, lse, lse_r, tf, f"attn_fwd_tiled {shape} lse")),
            "attn_bwd_dkv": max(_close(torch, dk, dk_r, tg, f"attn_bwd_dkv {shape} dk"),
                                _close(torch, dv, dv_r, tg, f"attn_bwd_dkv {shape} dv")),
            "attn_bwd_dq": _close(torch, dq, dq_r, tg, f"attn_bwd_dq {shape}"),
        }
        log(f"  flash attention tiled {shape} causal={causal}: |o, lse| {e['attn_fwd_tiled']:.2e}  "
            f"|dk, dv| {e['attn_bwd_dkv']:.2e}  |dq| {e['attn_bwd_dq']:.2e}")
        for key, val in e.items():
            err[key] = max(err[key], val)
        records.append({"kernel": "flash_attention_tiled", "shape": shape, "causal": causal, **e})
        if shape == ATTN_LM_LONG_SHAPES[1]:  # no float atomics: the same bits on every run
            again = attn_bwd_dkv(q, k, v, do, lse, delta, causal)
            again += (attn_bwd_dq(q, k, v, do, lse, delta, causal),)
            assert all(torch.equal(a, b) for a, b in zip((dk, dv, dq), again)), \
                f"tiled backward {shape}: bits differ between runs"
            log("  flash attention tiled backward: identical bits on two calls")
            del again
        del q, k, v, do, o, lse, delta, dk, dv, dq, o_r, lse_r, dk_r, dv_r, dq_r
        torch.cuda.empty_cache()
    return err


def time_flash(torch, dev):
    """K3, causal f32. Short route at every language model shape (forward
    and fused backward) and the validation chunk (forward), on the model's
    views: the kernels beside their plain versions,
    ``F.scaled_dot_product_attention`` with autograd (the yardstick; its one
    backward call computes dq, dk and dv) and the bound, and beside the tiled
    kernels on contiguous [B*H, T, D] copies of the same inputs (the route
    these shapes took before; their backward is dK/dV plus dQ from a
    precomputed delta). Tiled route at the long-context shape (the JSON
    line's rows) and at [5c]'s largest training step (26, 2, 256, 100) and
    its validation chunk (457, 2, 256, 100, forward only): each kernel
    beside its plain version, SDPA (forward, and its one backward call) and
    two bounds, ``bound_ms`` the 3xTF32 one the kernels compute in and
    ``bound_f32_ms`` the f32 FMA peak's."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.flash_attention import (
        attn_bwd_dkv,
        attn_bwd_dq,
        attn_bwd_short,
        attn_fwd,
        attn_fwd_short,
    )

    out = {}
    for shape in ATTN_PATH_SHAPES + (ATTN_VAL_SHAPE,):
        b, h, t, d = shape
        backward = shape != ATTN_VAL_SHAPE
        reps = 20 if backward else 5
        q, k, v, do = attn_inputs(shape, dev, 12)
        o, lse = attn_fwd_short(q, k, v, True)
        flat = [x.reshape(b * h, t, d).contiguous() for x in (q, k, v, do)]
        o_t, lse_t = attn_fwd(*flat[:3], True)
        delta = (flat[3] * o_t).sum(-1)
        row = attn_yardsticks(q, k, v, do, True, reps, backward)
        row["attn_fwd"].update(timed(lambda: attn_fwd_short(q, k, v, True), reps))
        row["attn_fwd"]["tiled_ms"] = device_ms(lambda: attn_fwd(*flat[:3], True), reps)
        if backward:
            row["attn_bwd"].update(timed(lambda: attn_bwd_short(q, k, v, do, o, lse, True), reps))
            row["attn_bwd"]["tiled_ms"] = device_ms(lambda: (
                attn_bwd_dkv(*flat, lse_t, delta, True), attn_bwd_dq(*flat, lse_t, delta, True)), reps)
        out[shape] = row
        del q, k, v, do, o, lse, flat, o_t, lse_t, delta
        torch.cuda.empty_cache()

    for shape, backward in ((ATTN_LONG_SHAPE, True), (ATTN_LM_LONG_SHAPES[1], True),
                            (ATTN_LM_LONG_VAL_SHAPE, False)):
        out[shape] = time_tiled(torch, dev, shape, backward)
        torch.cuda.empty_cache()
    return out


def time_tiled(torch, dev, shape, backward):
    """K3's tiled kernels at ``shape``, causal: {kernel: timing row} (see
    ``time_flash``)."""
    from torch.nn import functional as F

    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.flash_attention import (
        attn_bwd_dkv,
        attn_bwd_dkv_ref,
        attn_bwd_dq,
        attn_bwd_dq_ref,
        attn_fwd,
        attn_fwd_ref,
    )

    b, h, t, d = shape
    q, k, v, do = (x.reshape(b * h, t, d) for x in attn_inputs(shape, dev, 12, "contiguous"))
    o, lse = attn_fwd(q, k, v, True)
    delta = (do * o).sum(-1)
    args = (q, k, v, do, lse, delta, True)
    ql, kl, vl = (x.view(b, h, t, d).clone().requires_grad_() for x in (q, k, v))
    row = {"attn_fwd_tiled": dict(
        timed(lambda: attn_fwd(q, k, v, True)),
        plain_ms=device_ms(lambda: attn_fwd_ref(q, k, v, True)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)),
    )}
    if backward:
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        lib_bwd = device_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), do.view(b, h, t, d), retain_graph=True))
        row["attn_bwd_dkv"] = dict(timed(lambda: attn_bwd_dkv(*args)),
                                   plain_ms=device_ms(lambda: attn_bwd_dkv_ref(*args)), library_ms=lib_bwd)
        row["attn_bwd_dq"] = dict(timed(lambda: attn_bwd_dq(*args)),
                                  plain_ms=device_ms(lambda: attn_bwd_dq_ref(*args)), library_ms=lib_bwd)
        del lib_out
    for name, work in attn_work(shape, True).items():
        if name in row:
            row[name]["bound_ms"], row[name]["bound_by"] = bound_3xtf32(*work)
            row[name]["bound_f32_ms"] = bound(*work)[0]
    del q, k, v, do, o, lse, delta, args, ql, kl, vl
    return row


def run_path(torch, argv, tag):
    """The port's cli on one recipe, launch counts zeroed just before and
    read just after; returns (launch counts, series with their "_meta",
    cli wall, peak device memory in bytes)."""
    from dynamic_load_balance_distributeddnn_tpu_torch import cli
    from dynamic_load_balance_distributeddnn_tpu_torch.config import config_from_args
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime

    run_dir = os.path.join(OUT, tag)
    shutil.rmtree(run_dir, ignore_errors=True)  # a done-sentinel would skip the run
    full = argv + ["--log_dir", os.path.join(run_dir, "logs"),
                   "--stat_dir", os.path.join(run_dir, "statis")]
    log("  python -m dynamic_load_balance_distributeddnn_tpu_torch.cli " + " ".join(argv))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    t0 = time.perf_counter()
    assert cli.main(full) == 0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(runtime.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    cfg = config_from_args(full)
    with open(os.path.join(cfg.stat_dir, cfg.base_filename().format(0) + ".json")) as f:
        series = json.load(f)
    log(f"  cli.main wall {wall:.1f}s (data, model build and validation included), "
        f"peak device memory {peak / 2**30:.2f} GiB")
    return counts, series, wall, peak


def epoch_walls(series):
    """Each epoch's wall, from the cumulative ``wallclock_time`` series."""
    wc = series["wallclock_time"]
    return [wc[0]] + [b - a for a, b in zip(wc, wc[1:])]


def check_series(series, rate: str, epochs: int = EPOCHS, moved_off: int = 0):
    """The 9 series, finite losses, and (``moved_off`` not None) share moved
    off that worker."""
    from dynamic_load_balance_distributeddnn_tpu_torch.obs import SERIES

    for k in SERIES:
        assert len(series[k]) == epochs, (k, series[k])
    loss = series["train_loss"]
    assert all(math.isfinite(v) for v in loss), loss
    assert all(math.isfinite(v) for v in series["val_loss"]), series["val_loss"]
    if moved_off is not None:
        share = [p[moved_off] for p in series["partition"]]
        assert share[-1] < 0.25, f"worker {moved_off} share did not drop: {share}"
    walls = epoch_walls(series)
    meta = series["_meta"]
    for e in range(epochs):
        log(f"  epoch {e} ({meta['paths'][e]}, node times {meta['node_time_source'][e]}): "
            f"wall {walls[e]:.3f}s  {rate}/s {series['examples_per_s'][e]:.1f}  "
            f"train_loss {loss[e]:.4f}  val_loss {series['val_loss'][e]:.4f}  "
            f"accuracy {series['accuracy'][e]:.4f}  partition "
            f"{[round(p, 4) for p in series['partition'][e]]}  sync_time "
            f"{series['sync_time'][e]:.4f}s  probe_time {series['probe_time'][e]:.3f}s")


def check_supersteps(meta, what, repeats=True):
    """Every epoch of a path under the default ``--superstep auto``: scan
    mode, each training step replayed from a step graph, one capture a new
    key, one dispatch a window (the packed epoch: one); with ``repeats``,
    an epoch whose plan and injected workers repeat an earlier epoch's
    captures nothing (not under a time-varying schedule, whose load moves
    within the epoch). Logs each epoch's captures and host dispatch time."""
    seen = []
    for rec in meta["supersteps"]:
        e = rec["epoch"]
        assert rec["mode"] == "scan" and rec["eager_runs"] == 0, f"{what} epoch {e}: {rec}"
        assert rec["replays"] == rec["steps"], f"{what} epoch {e}: {rec['replays']} replays, {rec['steps']} steps"
        assert rec["dispatches"] == rec["windows"], f"{what} epoch {e}: {rec}"
        assert rec["captures"] == rec["new_keys"], f"{what} epoch {e}: {rec}"
        sig = (rec["batch_sizes"], rec["injected"])
        if repeats and sig in seen:
            assert rec["captures"] == 0, f"{what} epoch {e}: a repeated plan captured {rec['captures']}"
        seen.append(sig)
        log(f"  epoch {e} step graphs: {rec['captures']} captured ({rec['capture_s']:.2f}s), "
            f"{rec['replays']} replays in {rec['dispatches']} dispatches, host dispatch "
            f"{rec['host_dispatch_s']:.3f}s, {rec['keys']} keys")


def check_cnn_path(counts, series, what, path="packed", epochs=EPOCHS, moved_off=0,
                   repeats=True):
    """A vision path: the series (``check_series``), every epoch on
    ``path`` and through step graphs (``check_supersteps``), K1 and K2
    launched; logs the launches and returns ``_meta``."""
    check_series(series, "examples", epochs, moved_off)
    meta = series["_meta"]
    assert meta["paths"] == [path] * epochs, meta["paths"]
    check_supersteps(meta, what, repeats)
    for k in CNN_KERNELS:
        assert counts[k] > 0, f"kernel {k} never launched on the {what} path"
    log(f"  launches: {counts}")
    return meta


def log_probes(meta):
    """The calibrated in-step load and epoch 1's probed seconds an example."""
    per_ex = meta["probe_per_example_s"]["1"]
    log(f"  calibrated in-step synthetic load {meta['iter_cost_s'] * 1e6:.3f} us/iteration; "
        f"epoch 1 probed s/example {[f'{v:.3e}' for v in per_ex]}; realized profile "
        f"{meta.get('realized_injection_profile')}")
    return per_ex


def check_main_path(counts, series):
    """[4]: the defaults take the packed path and adaptive probes: every
    epoch packed, epochs 0-1 probed, epoch 2 on modeled node times with no
    probe wall. K1 runs once a packed step (not once a worker step), plus
    the probes; every DenseNet-121 call on the tiled route."""
    meta = check_cnn_path(counts, series, "vision")
    assert meta["node_time_source"] == ["probed", "probed", "modeled"], meta["node_time_source"]
    assert series["probe_time"][2] == 0.0 and min(series["probe_time"][:2]) > 0
    need = GN_PER_FORWARD * 2 * MIN_STEPS * EPOCHS
    gn = counts["groupnorm_fwd"] + counts["groupnorm_bwd"]
    assert gn >= need, f"GroupNorm launches {gn} < {need}"
    for k in GN_GENERAL:  # every DenseNet-121 shape takes the tiled route
        assert counts[k] == 0, f"kernel {k}: {counts[k]} launches on the vision path, want 0"


def check_compute_path(counts, series):
    """[4b]: ``--packed off --fault_mode compute``: the elastic path, the
    in-step iteration cost calibrated on epoch 0, the straggler's probed
    time an example at least twice a clean worker's from epoch 1 (its
    factor is 3), share moved off it."""
    per_ex = log_probes(check_cnn_path(counts, series, "compute-mode", path="elastic"))
    assert counts["synthetic_load"] > 0, "the synthetic-load kernel never launched on the compute path"
    ratio = per_ex[0] / min(per_ex[1:])
    log(f"  the straggler probed {ratio:.2f}x a clean worker an example")
    assert ratio >= 2.0, f"the compute straggler probed {ratio:.2f}x a clean worker, want >= 2"


def check_ft_path(counts, series):
    """[4c]: ``-ft true -ftc 0.5 --fault_mode compute`` at seed 213: the
    packed path; worker 0, hit from epoch 1, probes slower an example than
    every clean worker there, and its share falls."""
    per_ex = log_probes(check_cnn_path(counts, series, "-ft", moved_off=FT_WORKER))
    assert counts["synthetic_load"] > 0, "the synthetic-load kernel never launched on the -ft path"
    assert per_ex[FT_WORKER] > max(v for r, v in enumerate(per_ex) if r != FT_WORKER)


def check_window_path(torch, dev, counts, series, epoch_arm, err, records):
    """[4e]: window-cadence rebalancing on the elastic path. The switches:
    at least one, at most 2 an epoch, fewer than the evaluations; the
    regret budget held; the decision journal (the controller snapshot in
    ``_meta``) replayed bit for bit with no invariant violated; K1 on its
    tiled route only. Then K1 forward and backward against their plain
    versions at every distinct DenseNet-121 GroupNorm shape of each
    per-worker width the switches produced (f32, the path's dtype; the
    errors join K1's in the JSON line). Logs each evaluation's wall, its
    wall feedback and ``wall_scale`` (``check_window_controller``), and the
    per-epoch walls beside the epoch-cadence arm's."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import plan

    check_cnn_path(counts, series, "window-cadence", path="elastic",
                   epochs=WINDOW_EPOCHS, moved_off=None, repeats=False)
    events = check_window_controller(counts, series, "auto")
    widths = sorted({b for ev in events for b in ev["batches"] if b > 0})
    log(f"  per-worker widths the switches produced: {widths}")
    gen = torch.Generator().manual_seed(4)
    rand = lambda shp: torch.randn(shp, generator=gen).to(dev)  # noqa: E731
    for b in widths:
        shapes = sorted(set(model_gn_shapes(torch, dev, "densenet", b, with_relu=True)[0]))
        for bb, s, c, g, relu in shapes:
            launch = [plan(bb, s, c, g, torch.float32, back) for back in (False, True)]
            assert launch[0].route == launch[1].route == "tiled", (bb, s, c)
            e_y, e_x, e_p = gn_case(torch, rand, (bb, s, c), g, relu, torch.float32, launch,
                                    f"tiled, width {b}", records)
            err["groupnorm_fwd"] = max(err["groupnorm_fwd"], e_y)
            err["groupnorm_bwd"] = max(err["groupnorm_bwd"], e_x, e_p)
        log(f"  K1 at width {b}: {len(shapes)} distinct GroupNorm shapes within tolerance")
        torch.cuda.empty_cache()
    walls = {"window": epoch_walls(series), "epoch": epoch_walls(epoch_arm)}
    for e in range(WINDOW_EPOCHS):
        log(f"  epoch {e} wall: window cadence {walls['window'][e]:.3f}s, "
            f"epoch cadence {walls['epoch'][e]:.3f}s (for information)")
    return walls


def check_window_off(counts, series):
    """[4e] under ``--superstep off``: the elastic path's eager steps (one
    dispatch a step), K1 (tiled route only) and K2 launched, and the
    controller's gates (``check_window_controller``)."""
    check_series(series, "examples", WINDOW_EPOCHS, moved_off=None)
    meta = series["_meta"]
    assert meta["paths"] == ["elastic"] * WINDOW_EPOCHS, meta["paths"]
    for rec in meta["supersteps"]:
        assert rec["mode"] == "step" and rec["dispatches"] == rec["steps"], rec
    for k in CNN_KERNELS:
        assert counts[k] > 0, f"kernel {k} never launched on the eager window path"
    check_window_controller(counts, series, "off")
    log(f"  launches: {counts}")


def check_window_controller(counts, series, mode):
    """[4e]'s controller gates: at least one switch, at most 2 an epoch and
    fewer than the evaluations; the regret budget held; the decision
    journal replayed bit for bit with no invariant violated; K1 on its
    tiled route only. Each evaluation's wall, its wall feedback (the card's
    time between the CUDA events of two evaluations, ``measured_s``,
    against the prediction, ``modeled_s``) and ``wall_scale`` after it; no
    steady evaluation (epochs 1 on: epoch 0 predicts on unanchored rates)
    reads ``wall_scale`` at its clip. Returns the switch events."""
    from dynamic_load_balance_distributeddnn_tpu_torch.balance import replaylab

    meta = series["_meta"]
    for k in GN_GENERAL:
        assert counts[k] == 0, f"kernel {k}: {counts[k]} launches on the window path, want 0"
    assert counts["synthetic_load"] > 0, "the synthetic-load kernel never launched"
    ctl = meta["rebalance_controller"]
    events = meta.get("rebalance_events", [])
    switches = series["plan_switches"]
    log(f"  controller: {ctl['evals']} evaluations, switches an epoch {switches}, "
        f"spent {ctl['spent_s']:.6f}s, credit {ctl['credit_s']:.6f}s, "
        f"wall_scale {ctl['wall_scale']}, switch cost EMA {ctl['switch_cost_ema_s']}s")
    for ev in events:
        log(f"  switch: epoch {ev['epoch']} window {ev['window']} step {ev['step']} -> "
            f"batches {ev['batches']}, predicted win {ev['predicted_win_s'] * 1e3:.3f} ms over "
            f"{ev['remaining_steps']} steps, measured cost {ev['switch_cost_s'] * 1e3:.3f} ms")
    for e in meta["rebalance_evals"]:
        fed = ("" if e["measured_s"] is None else
               f", fed {e['measured_s'] * 1e3:.3f} ms measured / {e['modeled_s'] * 1e3:.3f} ms "
               f"modeled = {e['measured_s'] / e['modeled_s']:.4f}")
        log(f"  [{mode}] evaluation epoch {e['epoch']} window {e['window']}: wall "
            f"{e['wall_s'] * 1e3:.3f} ms (synchronize {e['sync_s'] * 1e3:.3f} ms){fed}, "
            f"wall_scale {e['wall_scale']:.4f}{', switch' if e['switch'] else ''}")
    steady = [e["wall_scale"] for e in meta["rebalance_evals"] if e["epoch"] >= 1]
    assert steady and all(WALL_SCALE_CLIP[0] < w < WALL_SCALE_CLIP[1] for w in steady), \
        f"[{mode}] a steady evaluation's wall_scale sits at its clip {WALL_SCALE_CLIP}: {steady}"
    log(f"  [{mode}] steady wall_scale {min(steady):.4f}-{max(steady):.4f} "
        f"(the host formula under graphs: {HOST_FORMULA_WALL_SCALE}); switches {sum(switches)} "
        f"(with the host formula: 1 a run)")
    n = sum(switches)
    assert n >= 1, f"no mid-epoch switch in {ctl['evals']} evaluations"
    assert max(switches) <= 2, f"thrash: switches an epoch {switches}"
    assert n < ctl["evals"], f"{n} switches in {ctl['evals']} evaluations"
    cfg = ctl["config"]
    assert ctl["spent_s"] <= cfg["budget_frac"] * ctl["credit_s"] + cfg["cost_init"], \
        f"budget: spent {ctl['spent_s']} > {cfg['budget_frac']} * credit {ctl['credit_s']} + {cfg['cost_init']}"
    path = os.path.join(OUT, f"run_window_{mode}", "corpus.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"label": "chip_smoke [4e]", "rebalance_controller": ctl}, f)
    corpus = replaylab.load_corpus(path)
    report = replaylab.replay(corpus)
    assert report["parity"], f"the card run's journal did not replay: {report['mismatches'][:3]}"
    assert report["invariant_violations"] == [], report["invariant_violations"][:3]
    assert replaylab.check_invariants(corpus["config"], corpus["journal"]) == []
    assert report["replayed"]["switches"] == n, (report["replayed"], n)
    log(f"  journal: {len(corpus['journal'])} decisions replayed bit for bit, no invariant violated")
    return events


def warm_figures(series, arm: str):
    """[4m]: one arm's figures from its series. By epoch: the captures and
    capture seconds inside the wall (``_meta.supersteps``: the captures of
    the elastic epoch's staged keys and the foreground ones) and outside it
    (``_meta.aot``: the pre-wall drain and the speculation's tail), the
    foreground captures alone, the epoch walls; the speculation's hits and
    misses (``_meta.aot_service``); ``measured_s / modeled_s`` at the first
    evaluation after each switch (the wall feedback of the windows that ran
    the new plan first). Logs them, a line each."""
    meta = series["_meta"]
    recs, aot = meta["supersteps"], meta.get("aot", [])
    epochs = range(len(recs))
    inside = [(r["captures"], round(r["capture_s"], 3)) for r in recs]
    outside = [(sum(a["captures"] for a in aot if a["epoch"] == e and a["at"] != "stage"),
                round(sum(a["capture_s"] for a in aot if a["epoch"] == e and a["at"] != "stage"), 3))
               for e in epochs]
    fg = [r["foreground_captures"] for r in recs]
    stats = meta.get("aot_service") or {}
    evals = meta.get("rebalance_evals", [])
    after = []
    for ev in meta.get("rebalance_events", []):
        nxt = [e for e in evals if e["epoch"] == ev["epoch"] and e["window"] > ev["window"] + 1
               and e["measured_s"]]
        if nxt:
            after.append((ev["epoch"], ev["window"], round(nxt[0]["measured_s"] / nxt[0]["modeled_s"], 4)))
    walls = [round(w, 3) for w in epoch_walls(series)]
    log(f"  ({arm}) captures (count, s) an epoch inside the wall {inside}; outside it "
        f"(pre-wall drain, speculation) {outside}; foreground {fg}")
    log(f"  ({arm}) speculation: {stats.get('speculative_captured', 0)} captured, hits "
        f"{stats.get('speculative_hits', 0)}, misses {stats.get('speculative_misses', 0)}; "
        f"service captures {stats.get('captured', 0)} in {stats.get('capture_s', 0.0):.2f}s")
    log(f"  ({arm}) epoch walls {walls} s")
    log(f"  ({arm}) measured_s / modeled_s at the first evaluation after each switch "
        f"(epoch, switch window, ratio): {after}")
    return {"inside": inside, "outside": outside, "foreground": fg, "stats": stats,
            "walls": walls, "after_switch": after}


def prepared_epochs(series):
    """[4m]'s gate on an on arm: the epochs whose every batch tuple (the
    boundary plan's and each switch's) was held before the epoch's wall
    (captured by the warm service before it, in an earlier epoch's stage or
    speculation or in this epoch's pre-wall drain, or run by an earlier
    epoch) must take no foreground capture. Returns those epochs."""
    meta = series["_meta"]
    aot, events = meta.get("aot", []), meta.get("rebalance_events", [])
    out, ran = [], set()
    for rec in meta["supersteps"]:
        e = rec["epoch"]
        tuples = {tuple(rec["batch_sizes"])} | {tuple(ev["batches"]) for ev in events
                                                 if ev["epoch"] == e}
        ready = ran | {tuple(r) for a in aot
                       if a["epoch"] < e or (a["epoch"] == e and a["at"] == "drain")
                       for r in a["rows"]}
        ran |= tuples
        if tuples <= ready:
            assert rec["foreground_captures"] == 0, (
                f"[4m] epoch {e}: every tuple {sorted(tuples)} was prepared, yet "
                f"{rec['foreground_captures']} foreground captures")
            out.append(e)
    return out


def check_warm_service(torch, paths):
    """[4m]: (a) ``WARM_BITS_ARGV`` under a timing model, cuDNN
    deterministic, ``--aot_warm false`` against ``true --warm_start true``:
    parameters, momentum, losses and partitions bit for bit; the on arm
    takes no foreground capture, the off arm takes its captures in the
    foreground; each decay epoch of the one-cycle policy replays a
    speculated key under on and captures in its wall under off. (b) [4e]'s window recipe under ``--aot_warm false`` against
    [4e]'s own run (``--warm_start true``; run here when [4e] is not in the
    subset): the on arm's epochs whose tuples were all prepared take no
    foreground capture (``prepared_epochs``); the off arm's captures are
    all foreground. Each arm's figures logged (``warm_figures``) and saved
    to ``warm_service.json``; each run's launches join ``paths``."""
    from dynamic_load_balance_distributeddnn_tpu_torch.train.schedule import one_cycle_lr

    out = {}
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        runs = {}
        for arm, extra in (("off", ["--aot_warm", "false"]), ("on", WARM_ARGV)):
            argv = WARM_BITS_ARGV + extra
            log("  python -m dynamic_load_balance_distributeddnn_tpu_torch.cli " + " ".join(argv)
                + " (timing model: rows x steps)")
            *run, tr = run_trainer(torch, argv, f"warm/bits_{arm}", timing_model=ms_linear_time)
            paths[f"warm_bits_{arm}"] = tuple(run)
            check_cnn_path(run[0], run[1], f"[4m] (a) --aot_warm {arm}", path="elastic",
                           epochs=WARM_BITS_EPOCHS, moved_off=None, repeats=False)
            runs[arm] = (tr, run[1])
        (off, s_off), (on, s_on) = runs["off"], runs["on"]
        for key in ("train_loss", "val_loss", "accuracy", "partition", "node_time"):
            assert s_on[key] == s_off[key], f"[4m] (a): {key} {s_on[key]} != {s_off[key]}"
        for (n, p), q in zip(on.model.named_parameters(), off.model.parameters()):
            assert torch.equal(p, q), f"[4m] (a): parameter {n} differs between the arms"
            assert torch.equal(on.optimizer.state[p]["momentum_buffer"],
                               off.optimizer.state[q]["momentum_buffer"]), \
                f"[4m] (a): momentum of {n} differs between the arms"
        assert s_on["graph_captures"] == [0.0] * WARM_BITS_EPOCHS, s_on["graph_captures"]
        assert sum(s_off["graph_captures"]) >= 1 and off._aot is None, s_off["graph_captures"]
        cfg = on.cfg
        decay = [e for e in range(WARM_BITS_EPOCHS)
                 if one_cycle_lr(cfg.learning_rate, e, cfg.epoch_size) != cfg.learning_rate]
        rec_on, rec_off = s_on["_meta"]["supersteps"], s_off["_meta"]["supersteps"]
        assert decay, cfg
        for e in decay:
            assert rec_on[e]["captures"] == 0 and rec_on[e]["speculative_hits"] >= 1, rec_on[e]
            assert rec_off[e]["foreground_captures"] >= 1, rec_off[e]
        log(f"  (a) decay epochs {decay}: each replayed its speculated key (on), each captured "
            "in its wall (off)")
        log(f"  (a) bit for bit: {len(list(on.params))} parameter tensors and their momentum, "
            f"train loss {[round(x, 6) for x in s_on['train_loss']]}, partitions {s_on['partition']}")
        out["bits"] = {arm: warm_figures(runs[arm][1], f"a, {arm}") for arm in ("off", "on")}
        del on, off, runs
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    if "vision_window" not in paths:
        paths["vision_window"] = run_path(torch, WINDOW_ARGV + WARM_ARGV, "run_window")
    paths["vision_window_aot_off"] = run_path(torch, WINDOW_ARGV + ["--aot_warm", "false"],
                                              "run_window_aot_off")
    s_on, s_off = paths["vision_window"][1], paths["vision_window_aot_off"][1]
    check_cnn_path(*paths["vision_window_aot_off"][:2], "[4m] (b) --aot_warm false",
                   path="elastic", epochs=WINDOW_EPOCHS, moved_off=None, repeats=False)
    recs_off = s_off["_meta"]["supersteps"]
    assert all(r["foreground_captures"] == r["captures"] for r in recs_off), recs_off
    assert "aot" not in s_off["_meta"] and sum(r["captures"] for r in recs_off) >= 1
    ready = prepared_epochs(s_on)
    log(f"  (b) on: epochs whose every tuple was prepared before the wall {ready}, none with a "
        "foreground capture")
    out["window"] = {arm: warm_figures(s, f"b, {arm}") for arm, s in (("off", s_off), ("on", s_on))}
    out["window"]["prepared_epochs"] = ready
    with open(os.path.join(OUT, "warm_service.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def check_lm_path(counts, series, epochs=EPOCHS):
    check_series(series, "tokens", epochs)
    check_supersteps(series["_meta"], "LM")
    assert series["accuracy"] == [1.0 - v for v in series["val_loss"]], "accuracy != 1 - val_loss"
    for k in LM_KERNELS:
        # attention runs once per layer of a worker step, the loss once
        need = (LM_LAYERS if k.startswith("attn") else 1) * WORKERS * LM_MIN_STEPS * epochs
        assert counts[k] >= need, f"kernel {k}: {counts[k]} launches on the LM path < {need}"
    for k in ATTN_TILED:  # T = 35 takes the short route only
        assert counts[k] == 0, f"kernel {k}: {counts[k]} launches on the LM path, want 0"
    log(f"  launches: {counts}")


def run_lm_long(torch):
    """[5c]: [5]'s recipe at ``--bptt 256`` through ``run_path``, recording
    each ``[B*H, T, D]`` the tiled forward is handed (the recording runs
    where the wrapper does: each eager call and each capture, not the
    replays). Returns run_path's result and the shapes."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import flash_attention as fa

    shapes, launch = set(), fa.attn_fwd

    def recorded(q, k, v, causal):
        shapes.add(tuple(q.shape))
        return launch(q, k, v, causal)

    fa.attn_fwd = recorded
    try:
        return run_path(torch, LM_LONG_ARGV, "run_lm_long"), shapes
    finally:
        fa.attn_fwd = launch


def check_lm_long_path(counts, series, shapes):
    """[5c]: the LM path's checks; every K3 launch on the tiled kernels (the
    forward, dK/dV and dQ once per layer of each worker's step, the short
    route's counters 0), all at T = 256 (the windows' and the validation
    chunks')."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.flash_attention import SHORT_T

    check_series(series, "tokens", EPOCHS)
    check_supersteps(series["_meta"], "LM at bptt 256")
    assert series["accuracy"] == [1.0 - v for v in series["val_loss"]], "accuracy != 1 - val_loss"
    need = LM_LAYERS * WORKERS * LM_LONG_STEPS * EPOCHS
    for k in ATTN_TILED:
        assert counts[k] >= need, f"kernel {k}: {counts[k]} launches on the LM path at bptt 256 < {need}"
    for k in ("attn_fwd", "attn_bwd"):
        assert counts[k] == 0, f"kernel {k} (the short route): {counts[k]} launches at bptt 256, want 0"
    for k in ("xent_fwd", "xent_bwd"):
        assert counts[k] > 0, f"kernel {k} never launched on the LM path at bptt 256"
    ts = {t for _, t, _ in shapes}
    assert ts == {256} and min(ts) > SHORT_T, sorted(shapes)
    b, h, t, d = ATTN_LM_LONG_VAL_SHAPE  # the validation chunk [3] checks and times
    assert (b * h, t, d) in shapes, f"no validation chunk of {b} rows among {sorted(shapes)}"

    log(f"  K3 tiled forward's (B*H, T, D): {sorted(shapes)}")
    log(f"  launches: {counts}")


def check_bf16_vision_path(counts, series, path, epochs):
    """[4f]: a vision path under ``--precision bfloat16``: the series, share
    moved off worker 0, every epoch on ``path``; K1 launched on its tiled
    route only, on bf16 activations (its wrapper takes the f32 scale and
    bias the model casts) in every training forward and backward, on f32
    ones only in evaluation (which never casts: ``GN_PER_FORWARD`` calls a
    chunk of the 10,000 test images, ``VAL_CHUNKS`` chunks an epoch); K2 on
    f32 logits only (the loss is taken on f32 logits, as in the JAX
    package)."""
    check_cnn_path(counts, series, f"bf16 {path}", path=path, epochs=epochs)
    assert counts["groupnorm_bwd_bf16"] == counts["groupnorm_bwd"] > 0, \
        f"groupnorm_bwd: {counts['groupnorm_bwd_bf16']} of {counts['groupnorm_bwd']} launches bf16, want all"
    f32_fwd = counts["groupnorm_fwd"] - counts["groupnorm_fwd_bf16"]
    assert f32_fwd == GN_PER_FORWARD * VAL_CHUNKS * epochs, \
        f"groupnorm_fwd: {f32_fwd} launches on f32 activations, want the evaluation's alone"
    for k in GN_GENERAL:
        assert counts[k] == 0, f"kernel {k}: {counts[k]} launches on the bf16 path, want 0"
    for k in XENT_BF16:
        assert counts[k] == 0, f"kernel {k}: {counts[k]} launches on bf16 logits, want 0 (f32)"
    log(f"  K1 on bf16 activations: {counts['groupnorm_fwd_bf16']} / {counts['groupnorm_bwd_bf16']} "
        f"launches (every training forward and backward; the evaluation's {f32_fwd} forwards f32), "
        f"tiled route only; K2 on f32 logits: {counts['xent_fwd']} / {counts['xent_bwd']}")


def check_bf16_lm_path(counts, series):
    """[5b]: the language model under ``--precision bfloat16``: the LM
    path's checks over its epochs; K2 on f32 logits only; K3 (short route
    only) on f32 operands, the only dtype its wrapper takes: the embedding
    and its scale run in bf16, and ``+ pe`` promotes to f32, as in the JAX
    package."""
    check_lm_path(counts, series, LM_BF16_EPOCHS)
    for k in XENT_BF16:
        assert counts[k] == 0, f"kernel {k}: {counts[k]} launches on bf16 logits, want 0 (f32)"


def check_bf16_against_cpu(torch, dev, which: str):
    """[6b]: DenseNet-121 or the Transformer LM (full width, flash
    attention, eval mode) under the bf16 compute dtype, on the card (K1 in
    bf16, K2 and K3 in f32) and on the CPU (plain versions), against the
    CPU's f64 run from the same seeded weights and inputs: the loss and the
    first layer's gradient (``Conv_0``, ``Embed_0``), the card's error from
    f64 within ``BF16_CARD_MULTIPLE`` times the CPU's bf16 error (for the
    loss, or times one bf16 step of its f64 value, 2**-8 of it, where that
    is larger)."""
    from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model
    from dynamic_load_balance_distributeddnn_tpu_torch.models.common import init_flax_defaults
    from dynamic_load_balance_distributeddnn_tpu_torch.models.transformer import TransformerLM
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
    from dynamic_load_balance_distributeddnn_tpu_torch.train.steps import weighted_loss

    gen = torch.Generator().manual_seed(5)
    if which == "densenet":
        make = lambda: build_model("densenet").to(memory_format=torch.channels_last)  # noqa: E731
        x = torch.randn(8, 32, 32, 3, generator=gen)
        y = torch.randint(0, 10, (8,), generator=gen)
        w, first = torch.full((8,), 1.0 / 8), "Conv_0"
    else:
        kw = dict(ntoken=XENT_LM_SHAPE[1], ninp=200, nhead=2, nhid=200, nlayers=LM_LAYERS,
                  dropout=0.2, use_flash=True)
        make = lambda: TransformerLM(**kw)  # noqa: E731
        x = torch.randint(0, kw["ntoken"], (8, 35), generator=gen)
        y = torch.randint(0, kw["ntoken"], (8, 35), generator=gen)
        w, first = torch.full((8, 35), 1.0 / (8 * 35)), "Embed_0"
    ref = make()
    init_flax_defaults(ref, torch.Generator().manual_seed(0))
    res = {}
    for tag, d, dtype in (("card", dev, torch.bfloat16), ("cpu", "cpu", torch.bfloat16),
                          ("f64", "cpu", None)):
        model = make()
        model.load_state_dict(ref.state_dict())
        model = model.to(d, torch.float64 if dtype is None else torch.float32,
                         memory_format=torch.channels_last).eval()
        xx = x.to(d, torch.float64) if (dtype is None and x.is_floating_point()) else x.to(d)
        ww = w.to(d, torch.float64 if dtype is None else torch.float32)
        runtime.reset_launches()
        loss, _ = weighted_loss(model, xx, y.to(d), ww, dtype)
        loss.backward()
        if tag == "card":
            counts = dict(runtime.LAUNCHES)
            assert loss.dtype == torch.float32 and torch.isfinite(loss), loss
            if which == "densenet":
                assert counts["groupnorm_fwd_bf16"] == counts["groupnorm_fwd"] == GN_PER_FORWARD, counts
            else:
                assert counts["attn_fwd"] == counts["attn_bwd"] == LM_LAYERS, counts
            assert counts["xent_fwd"] == 1 and counts["xent_fwd_bf16"] == 0, counts
        res[tag] = (loss.detach().double().cpu(), getattr(model, first).weight.grad.double().cpu())
    row = {"model": which}
    for i, what in enumerate(("loss", f"d{first}")):
        exact = res["f64"][i]
        e_card = (res["card"][i] - exact).abs().max().item()
        e_cpu = (res["cpu"][i] - exact).abs().max().item()
        step = 2.0**-8 * exact.abs().max().item() if what == "loss" else 0.0
        lim = BF16_CARD_MULTIPLE * max(e_cpu, step)
        row[what] = {"card_vs_f64": e_card, "cpu_bf16_vs_f64": e_cpu, "limit": lim}
        log(f"  {which} bf16 {what}: card vs f64 {e_card:.3e}, CPU bf16 vs f64 {e_cpu:.3e}, "
            f"limit {lim:.3e} (max |f64| {exact.abs().max().item():.3e})")
        assert e_card <= lim, f"{which} bf16 {what}: card {e_card:.3g} from f64 > {lim:.3g}"
    return row


def check_against_cpu(torch, dev, name: str):
    """``-m name`` (DenseNet-121, ResNet-18, RegNetY-400MF) through the
    kernels on the card against the plain versions on the CPU, same seeded
    weights and 8 inputs, for each seed of ``CARD_VS_CPU_SEEDS``: logits
    within atol 2e-3 of the CPU's f32 run (up to 121 layers of differently
    ordered f32 sums; TF32 off), and the first conv's loss gradient within
    ``GRAD_ATOL_F64`` of the CPU's f64 run, the same rule for every model.
    DenseNet-121's gradient is also held, as before, within 2e-3 of the
    CPU's f32 run. Every seed is logged before any is asserted: the card's
    distance from f64 beside the CPU's own f32 distance from it."""
    from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model
    from dynamic_load_balance_distributeddnn_tpu_torch.models.common import init_flax_defaults
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import softmax_xent

    out = []
    for seed in CARD_VS_CPU_SEEDS:
        cpu = build_model(name).to(memory_format=torch.channels_last)
        init_flax_defaults(cpu, torch.Generator().manual_seed(seed))
        x = torch.randn(8, 32, 32, 3, generator=torch.Generator().manual_seed(1 + 10 * seed))
        y = torch.randint(0, 10, (8,), generator=torch.Generator().manual_seed(2 + 10 * seed))
        res = []
        for model, d, dtype in ((cpu, "cpu", torch.float32), (build_model(name), dev, torch.float32),
                                (build_model(name), "cpu", torch.float64)):
            model.load_state_dict(cpu.state_dict())
            model = model.to(d, dtype, memory_format=torch.channels_last)
            logits = model(x.to(d, dtype))
            softmax_xent(logits, y.to(d)).mean().backward()
            res.append((logits.detach().cpu(), model.Conv_0.weight.grad.cpu()))
        (l32, g32), (lc, gc), (_, g64) = res
        row = {"seed": seed, "logits": (lc - l32).abs().max().item(),
               "dconv0_vs_f64": (gc.double() - g64).abs().max().item(),
               "dconv0_cpu_f32_vs_f64": (g32.double() - g64).abs().max().item(),
               "dconv0_vs_cpu_f32": (gc - g32).abs().max().item(),
               "finite": lc.shape == (8, 10) and bool(torch.isfinite(lc).all())}
        log(f"  {name} seed {seed} card vs CPU: |logits| {row['logits']:.2e} (max |logit| "
            f"{l32.abs().max().item():.2f}); |dConv_0| card vs f64 {row['dconv0_vs_f64']:.2e}, "
            f"CPU f32 vs f64 {row['dconv0_cpu_f32_vs_f64']:.2e}, card vs CPU f32 "
            f"{row['dconv0_vs_cpu_f32']:.2e} (max |dConv_0| {g64.abs().max().item():.2e})")
        out.append(row)
    for row in out:
        assert row["finite"], f"{name} seed {row['seed']}: logits not finite or misshapen"
        assert row["logits"] <= 2e-3, f"{name} seed {row['seed']}: |logits| {row['logits']:.3g} > 2e-3"
        assert row["dconv0_vs_f64"] <= GRAD_ATOL_F64, \
            f"{name} seed {row['seed']}: |dConv_0 - f64| {row['dconv0_vs_f64']:.3g} > {GRAD_ATOL_F64}"
        if name == "densenet":  # the earlier slices' check, kept
            assert row["dconv0_vs_cpu_f32"] <= 2e-3, \
                f"densenet seed {row['seed']}: |dConv_0| {row['dconv0_vs_cpu_f32']:.3g} > 2e-3"
    return out


def check_lm_against_cpu(torch, dev):
    """The Transformer LM at full width (18,328-word vocabulary, EMSIZE 200,
    2 heads, 2 layers, flash attention) through the kernels on the card vs
    the plain versions on the CPU, same seeded weights and 8 windows of 35
    tokens, eval mode (no dropout): logits and the embedding's loss gradient
    within atol 1e-4 (two layers and a 200 x 18,328 output product of f32
    sums in another order on the card; TF32 off)."""
    from dynamic_load_balance_distributeddnn_tpu_torch.models.common import init_flax_defaults
    from dynamic_load_balance_distributeddnn_tpu_torch.models.transformer import TransformerLM
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import softmax_xent

    kw = dict(ntoken=XENT_LM_SHAPE[1], ninp=200, nhead=2, nhid=200, nlayers=LM_LAYERS,
              dropout=0.2, use_flash=True)
    cpu = TransformerLM(**kw).eval()
    init_flax_defaults(cpu, torch.Generator().manual_seed(0))
    gpu = TransformerLM(**kw).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(dev)
    gen = torch.Generator().manual_seed(1)
    x = torch.randint(0, kw["ntoken"], (8, 35), generator=gen)
    y = torch.randint(0, kw["ntoken"], (8, 35), generator=gen)
    res = []
    for model, d in ((cpu, "cpu"), (gpu, dev)):
        logits = model(x.to(d))
        softmax_xent(logits, y.to(d)).mean().backward()
        res.append((logits.detach().cpu(), model.Embed_0.weight.grad.cpu()))
    e_l = (res[1][0] - res[0][0]).abs().max().item()
    e_g = (res[1][1] - res[0][1]).abs().max().item()
    log(f"  Transformer LM card vs CPU: |logits| {e_l:.2e} (max |logit| "
        f"{res[0][0].abs().max().item():.2f}), |dEmbed_0| {e_g:.2e} (max "
        f"{res[0][1].abs().max().item():.2e})")
    assert res[1][0].shape == (8, 35, kw["ntoken"]) and torch.isfinite(res[1][0]).all()
    torch.testing.assert_close(res[1][0], res[0][0], atol=1e-4, rtol=0)
    torch.testing.assert_close(res[1][1], res[0][1], atol=1e-4, rtol=0)


# [4g]: --superstep as captured CUDA graphs. (i) each kernel alone replayed
# from a graph at a path shape; (ii) one graphed step against one eager step
# from the same state, cuDNN deterministic: DenseNet-121 elastic at the 3:1
# plan's widths with the straggler's compute-mode load in the step,
# DenseNet-121 packed (b = 512, the workers' summed load), the LM (4 x 20
# columns, clip 0.25, dropout); (iii) --superstep auto against off on [4b]'s,
# [5]'s and [4f]'s recipes, each arm's run beside the other's, then steady
# passes over one plan, one off and one auto, and one profiled
# pass each
SUPERSTEP_ELASTIC_WIDTHS, SUPERSTEP_LOAD_ITERS = (32, 160, 160, 160), 300
SUPERSTEP_LM_COLS = 20
# 1 epoch each, the DenseNet-121 recipes at 1,024 examples (2 epochs of
# 4,096 until [4j] and [7b] joined, 2,048 until [9] joined: the script's
# time)
SUPERSTEP_ARMS = tuple((name, with_epochs(argv, 1)) for name, argv in (
    ("densenet elastic, compute-mode straggler", with_n_train(COMPUTE_ARGV, 1024)),
    ("language model", LM_ARGV),
    ("densenet packed, bf16", with_n_train(BF16_ARGV, 1024))))
# [4]'s and [4f]'s packed cli peaks with eager steps, before step graphs
# (NVIDIA H100 80GB HBM3, 700 W), printed beside each arm's peak
EAGER_PEAK_GIB = "19.17 GiB ([4], f32 packed) / 9.69 GiB ([4f], bf16 packed)"


def replay_graph(torch, fn):
    """``fn()`` warmed once on a side stream (libraries loaded, plans
    chosen), captured into a CUDA graph and replayed once: (graph, the
    replay's outputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph, outs


def check_kernels_in_graphs(torch, dev, err):
    """[4g](i): each kernel captured alone at a path shape and replayed,
    against its plain version under the tolerances of [3] and against the
    same call launched eagerly (the same bits): K1 forward and backward at
    every distinct GroupNorm call of DenseNet-121 at the packed b = 512, f32
    and bf16; K2 forward and backward at [512, 10] and [1400, 18328]; K3's
    short route forward and fused backward at (40, 2, 35, 100) on the
    model's views; K3's tiled route (forward, dK/dV, dQ, delta between
    them as the autograd function forms it) at (26, 2, 256, 100), [5c]'s
    largest training step, within [3]'s path tolerances; the synthetic load
    captured once with a device count and replayed at 0, 3 and 300
    iterations. The errors join the JSON line's."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.faultload import SyntheticLoad, synthetic_load
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.flash_attention import (
        attn_bwd_dkv,
        attn_bwd_dq,
        attn_bwd_ref,
        attn_bwd_short,
        attn_bwd_short_ref,
        attn_fwd,
        attn_fwd_ref,
        attn_fwd_short,
    )
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import (
        group_norm_bwd,
        group_norm_bwd_ref,
        group_norm_fwd,
        group_norm_ref,
    )
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import (
        xent_bwd,
        xent_bwd_ref,
        xent_fwd,
        xent_fwd_ref,
    )

    def same(got, want, what):
        for a, b in zip(got, want):
            assert torch.equal(a, b), f"{what}: the replay's bits differ from the eager launch's"

    shapes = sorted(set(model_gn_shapes(torch, dev, "densenet", GN_PACKED_B, with_relu=True)[0]))
    on_card = torch.Generator(device=dev).manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        ty, tg, rt = GN_TOL[str(dtype)]
        keys = GN_BF16 if dtype == torch.bfloat16 else ("groupnorm_fwd", "groupnorm_bwd")
        for bb, s, c, g, relu in shapes:
            x = torch.randn((bb, s, c), generator=on_card, device=dev).to(dtype)
            dy = torch.randn((bb, s, c), generator=on_card, device=dev).to(dtype)
            w = 1 + 0.1 * torch.randn((c,), generator=on_card, device=dev)
            b = 0.1 * torch.randn((c,), generator=on_card, device=dev)

            def gn():
                y, mean, rstd = group_norm_fwd(x, w, b, g, 1e-6, relu)
                return (y, mean, rstd) + tuple(group_norm_bwd(x, dy, w, b, mean, rstd, g, relu))

            graph, got = replay_graph(torch, gn)
            same(got, gn(), f"groupnorm {dtype} {(bb, s, c)}")
            y, mean, rstd, dx, dw, db = got
            yr = group_norm_ref(x.float(), w, b, g, 1e-6, relu)
            torch.testing.assert_close(y.float(), yr, atol=ty, rtol=rt)
            gx, gw, gb = group_norm_bwd_ref(x.float(), dy.float(), w, b, mean, rstd, g, relu)
            torch.testing.assert_close(dx.float(), gx, atol=tg, rtol=rt)
            torch.testing.assert_close(dw, gw, atol=tg, rtol=max(rt, 1e-4))
            torch.testing.assert_close(db, gb, atol=tg, rtol=max(rt, 1e-4))
            err[keys[0]] = max(err[keys[0]], (y.float() - yr).abs().max().item())
            err[keys[1]] = max(err[keys[1]], (dx.float() - gx).abs().max().item(),
                               (dw - gw).abs().max().item(), (db - gb).abs().max().item())
            del graph, got, x, dy, y, dx, yr, gx
            torch.cuda.empty_cache()
        log(f"  K1 {str(dtype)[6:]} in a graph: {len(shapes)} distinct DenseNet-121 calls at "
            f"b={GN_PACKED_B}, forward and backward, within tolerance and the eager bits")
    for r, v in ((512, 10), XENT_LM_SHAPE):
        logits, labels, gr, _ = xent_inputs(r, v, dev)

        def xent():
            loss, lse = xent_fwd(logits, labels)
            return loss, lse, xent_bwd(logits, labels, gr, lse)

        graph, (loss, lse, dx) = replay_graph(torch, xent)
        same((loss, lse, dx), xent(), f"xent [{r}, {v}]")
        loss_r, lse_r = xent_fwd_ref(logits, labels)
        dx_r = xent_bwd_ref(logits, labels, gr, lse)
        torch.testing.assert_close(loss, loss_r, atol=1e-5, rtol=0)
        torch.testing.assert_close(lse, lse_r, atol=1e-5, rtol=0)
        ratio = dlogits_ratio(torch, dx, dx_r, labels, gr, 1e-5)
        assert ratio <= 1.0, f"xent [{r}, {v}] in a graph: dlogits off by {ratio:.3g} of its limit"
        err["xent_fwd"] = max(err["xent_fwd"], (loss - loss_r).abs().max().item(),
                              (lse - lse_r).abs().max().item())
        err["xent_bwd"] = max(err["xent_bwd"], (dx - dx_r).abs().max().item())
        log(f"  K2 [{r}, {v}] in a graph: forward and backward within tolerance and the eager bits")
    q, k, v, do = attn_inputs(ATTN_PATH_SHAPE, dev, 11, "model")

    def attn():
        o, lse = attn_fwd_short(q, k, v, True)
        return (o, lse) + tuple(attn_bwd_short(q, k, v, do, o, lse, True))

    graph, got = replay_graph(torch, attn)
    same(got, attn(), f"attention {ATTN_PATH_SHAPE}")
    o, lse = got[:2]
    o_r, lse_r = attn_fwd_ref(q, k, v, True)
    err["attn_fwd"] = max(err["attn_fwd"], _close(torch, o, o_r, 2e-5, "attn_fwd in a graph"),
                          _close(torch, lse, lse_r, 2e-5, "attn_fwd lse in a graph"))
    for n, a, b in zip("qkv", got[2:], attn_bwd_short_ref(q, k, v, do, o, lse, True)):
        err["attn_bwd"] = max(err["attn_bwd"], _close(torch, a, b, 5e-4, f"attn_bwd d{n} in a graph"))
    log(f"  K3 {ATTN_PATH_SHAPE} in a graph: forward and backward within tolerance and the eager bits")
    b, h, t, d = shape = ATTN_LM_LONG_SHAPES[1]
    q, k, v, do = (x.reshape(b * h, t, d) for x in attn_inputs(shape, dev, 11, "contiguous"))

    def tiled():
        o, lse = attn_fwd(q, k, v, True)
        delta = (do * o).sum(-1)
        dk, dv = attn_bwd_dkv(q, k, v, do, lse, delta, True)
        return o, lse, delta, dk, dv, attn_bwd_dq(q, k, v, do, lse, delta, True)

    graph, got = replay_graph(torch, tiled)
    same(got, tiled(), f"tiled attention {shape}")
    o, lse, delta, dk, dv, dq = got
    o_r, lse_r = attn_fwd_ref(q, k, v, True)
    err["attn_fwd_tiled"] = max(err["attn_fwd_tiled"],
                                _close(torch, o, o_r, 2e-5, "attn_fwd_tiled in a graph"),
                                _close(torch, lse, lse_r, 2e-5, "attn_fwd_tiled lse in a graph"))
    dq_r, dk_r, dv_r = attn_bwd_ref(q, k, v, do, lse, delta, True)
    err["attn_bwd_dkv"] = max(err["attn_bwd_dkv"], _close(torch, dk, dk_r, 5e-4, "attn_bwd_dkv dk in a graph"),
                              _close(torch, dv, dv_r, 5e-4, "attn_bwd_dkv dv in a graph"))
    err["attn_bwd_dq"] = max(err["attn_bwd_dq"], _close(torch, dq, dq_r, 5e-4, "attn_bwd_dq in a graph"))
    log(f"  K3 tiled {shape} in a graph: forward, dK/dV and dQ within tolerance and the eager bits")
    del graph, got, q, k, v, do, o, lse, delta, dk, dv, dq, o_r, lse_r, dq_r, dk_r, dv_r
    load = SyntheticLoad()
    seed = torch.tensor(1.7, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    graph, out = replay_graph(torch, lambda: load(count, seed))
    for n in (0, 3, SUPERSTEP_LOAD_ITERS):
        count.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, load(n, seed)), f"synthetic load x{n} in a graph: bits differ"
        torch.testing.assert_close(out, synthetic_load(n, seed), atol=1e-6, rtol=1e-5)
        err["synthetic_load"] = max(err["synthetic_load"], (out - synthetic_load(n, seed)).abs().item())
    log(f"  synthetic load captured once with a device count, replayed at 0, 3 and "
        f"{SUPERSTEP_LOAD_ITERS} iterations: the int form's bits")


def step_state(tr):
    """Copies of the trainer's parameters, momentum buffers and dropout
    generator state."""
    opt = tr.optimizer
    return ([p.detach().clone() for p in tr.params],
            [opt.state[p]["momentum_buffer"].clone() for p in tr.params],
            tr.dropout_gen.get_state())


def restore_state(torch, tr, saved):
    """``step_state``'s copies written back in place (a captured graph
    holds the tensors' addresses)."""
    params, bufs, gen = saved
    with torch.no_grad():
        for p, a, b in zip(tr.params, params, bufs):
            p.copy_(a)
            tr.optimizer.state[p]["momentum_buffer"].copy_(b)
    tr.dropout_gen.set_state(gen)


def check_step_graphs(torch, dev):
    """[4g](ii): from one state, two eager steps (``train/steps.py``) and
    two steps through ``StepGraphs`` (a capture, then replays) on the same
    batches: the parameters, momentum buffers and loss sums after each step
    bit for bit, cuDNN deterministic. DenseNet-121 elastic at the widths
    ``SUPERSTEP_ELASTIC_WIDTHS`` with the straggler's load of
    ``SUPERSTEP_LOAD_ITERS`` iterations in its step, DenseNet-121 packed
    (b = 512, the same load), and the LM (4 workers x 20 columns, clip
    0.25, dropout on: the replays draw the eager masks)."""
    import numpy as np

    from dynamic_load_balance_distributeddnn_tpu_torch.config import config_from_args
    from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
    from dynamic_load_balance_distributeddnn_tpu_torch.train.lm_engine import LMTrainer
    from dynamic_load_balance_distributeddnn_tpu_torch.train.steps import (
        elastic_step,
        packed_step,
        prepare_step_state,
    )

    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for case in ("elastic", "packed", "lm"):
            lm = case == "lm"
            argv = with_epochs(LM_ARGV if lm else COMPUTE_ARGV, 1) + [
                "--log_dir", os.path.join(OUT, "step_graphs", "logs"),
                "--stat_dir", os.path.join(OUT, "step_graphs", "statis")]
            tr = (LMTrainer if lm else Trainer)(config_from_args(argv), log_to_file=False)
            tr.model.train()
            if lm:
                cols = np.full(WORKERS, SUPERSTEP_LM_COLS)
                tr.shares = cols / cols.sum()
                plan = tr._build_plan(0, cols)
                batches = [tr._worker_epoch(plan, r)(0)[0] for r in range(WORKERS)]
                slow = [0] * WORKERS
            else:
                widths = np.asarray(SUPERSTEP_ELASTIC_WIDTHS)
                gen = torch.Generator(device=dev).manual_seed(8)
                batches = []
                for b in widths:
                    rows = torch.randint(0, tr.n_train, (int(b),), device=dev, generator=gen)
                    batches.append((tr._prep(tr.train_x[rows]), tr.train_y[rows],
                                    torch.full((int(b),), 1.0 / widths.sum(), device=dev)))
                slow = [SUPERSTEP_LOAD_ITERS, 0, 0, 0]
                if case == "packed":
                    batches = [tuple(torch.cat(t) for t in zip(*batches))]
                    slow = [SUPERSTEP_LOAD_ITERS]
            if case == "packed":
                def eager():
                    return packed_step(tr.model, tr.optimizer, batches[0], tr.load, slow[0],
                                       tr.compute_dtype)
                body, warm = tr._packed_body(), tr._warmup(0.0)
            else:
                def eager():
                    return elastic_step(tr.model, tr.optimizer, batches, tr.grad_clip, tr.load, slow,
                                        tr.compute_dtype)
                body, warm = tr._elastic_body(), tr._warmup(tr.grad_clip)
            prepare_step_state(tr.optimizer)
            saved = step_state(tr)
            want, loss = [], torch.zeros((), device=dev)
            for _ in range(2):
                loss += eager()
                want.append((step_state(tr)[:2], loss.clone()))
            restore_state(torch, tr, saved)
            tr.supersteps.loss.zero_()
            t0 = time.perf_counter()
            for i in range(2):
                tr._superstep(case if case == "packed" else "elastic", batches, slow, body, warm)
                torch.cuda.synchronize()
                (params, bufs), got_loss = step_state(tr)[:2], tr.supersteps.loss.clone()
                (w_params, w_bufs), w_loss = want[i]
                d_p = max((a - b).abs().max().item() for a, b in zip(params, w_params))
                d_m = max((a - b).abs().max().item() for a, b in zip(bufs, w_bufs))
                log(f"  {case} step {i + 1}: graphed against eager: |parameters| {d_p:.3g}, "
                    f"|momentum| {d_m:.3g}, loss sums {got_loss.item():.9g} / {w_loss.item():.9g}")
                assert all(torch.equal(a, b) for a, b in zip(params, w_params)), f"{case}: parameters differ"
                assert all(torch.equal(a, b) for a, b in zip(bufs, w_bufs)), f"{case}: momentum differs"
                assert torch.equal(got_loss, w_loss), f"{case}: loss sums differ"
            st = tr.supersteps.stats()
            assert (st["captures"], st["replays"]) == (1, 2), st
            out[case] = {"capture_s": st["capture_s"], "wall_s": time.perf_counter() - t0}
            log(f"  {case}: 1 capture ({st['capture_s']:.2f}s with its warm-up), 2 replays, "
                f"bit for bit with the eager steps")
            del tr, batches, saved, want
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    return out


# [4j]: --remat (the training forward recomputed in the backward): DenseNet-121
# packed at b = 512 (the 3:1 plan's widths concatenated), f32 and bf16, and
# the LM (4 x 20 columns, clip 0.25, dropout on), each from one state under
# remat off and on, eager (--superstep off) and from a step graph (auto)
REMAT_CASES = (("densenet packed f32", MAIN_ARGV), ("densenet packed bf16", BF16_ARGV),
               ("language model", LM_ARGV))
REMAT_ARMS = ((False, "off"), (True, "off"), (False, "auto"), (True, "auto"))
# the forward kernels that the checkpointed forward runs again in the
# backward: under remat each launches twice as often, every other kernel as
# often as without it
REMAT_FWD = ("groupnorm_fwd", "groupnorm_fwd_bf16", "groupnorm_fwd_general", "attn_fwd",
             "attn_fwd_tiled")


def check_remat(torch, dev):
    """[4j]: for each of ``REMAT_CASES``, from one state (parameters,
    momentum, dropout generator), one training step in each of
    ``REMAT_ARMS``, cuDNN deterministic: the step's gradients (``.grad``),
    the parameters after it and its loss sum equal bit for bit across the
    four arms. Each arm's peak device memory above the case's baseline and
    its steady step's device time (the profiler's kernel time over two
    steps after two warm-up steps) are logged. The launch counts of each
    arm's first step (under auto the warm-up and the capture) show the
    recompute: under each mode, remat on launches ``REMAT_FWD``'s kernels
    twice as often as remat off, and every other kernel as often."""
    from dynamic_load_balance_distributeddnn_tpu_torch.config import config_from_args
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
    from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
    from dynamic_load_balance_distributeddnn_tpu_torch.train.lm_engine import LMTrainer
    from dynamic_load_balance_distributeddnn_tpu_torch.train.steps import (
        elastic_step,
        packed_step,
        prepare_step_state,
        set_remat,
    )
    import numpy as np

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {}
    try:
        for name, argv in REMAT_CASES:
            lm = "language" in name
            argv = with_epochs(argv, 1) + [
                "--log_dir", os.path.join(OUT, "remat", "logs"),
                "--stat_dir", os.path.join(OUT, "remat", "statis")]
            tr = (LMTrainer if lm else Trainer)(config_from_args(argv), log_to_file=False)
            tr.model.train()
            if lm:
                cols = np.full(WORKERS, SUPERSTEP_LM_COLS)
                tr.shares = cols / cols.sum()
                plan = tr._build_plan(0, cols)
                batches = [tr._worker_epoch(plan, r)(0)[0] for r in range(WORKERS)]
                path, slow, body = "elastic", [0] * WORKERS, tr._elastic_body()
                warm = tr._warmup(tr.grad_clip)

                def eager():
                    return elastic_step(tr.model, tr.optimizer, batches, tr.grad_clip, tr.load, slow,
                                        tr.compute_dtype)
            else:
                widths = np.asarray(SUPERSTEP_ELASTIC_WIDTHS)
                gen = torch.Generator(device=dev).manual_seed(8)
                rows = torch.randint(0, tr.n_train, (int(widths.sum()),), device=dev, generator=gen)
                batches = [(tr._prep(tr.train_x[rows]), tr.train_y[rows],
                            torch.full((int(widths.sum()),), 1.0 / widths.sum(), device=dev))]
                path, slow, body, warm = "packed", [0], tr._packed_body(), tr._warmup(0.0)

                def eager():
                    return packed_step(tr.model, tr.optimizer, batches[0], tr.load, slow[0],
                                       tr.compute_dtype)
            prepare_step_state(tr.optimizer)
            saved = step_state(tr)
            results, arms = [], {}
            for remat, mode in REMAT_ARMS:
                restore_state(torch, tr, saved)
                set_remat(tr.model, remat)
                tr.supersteps.clear()
                tr.supersteps.loss.zero_()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                runtime.reset_launches()
                if mode == "off":
                    def step():
                        return eager()
                    loss = step().detach().clone()
                else:
                    def step():
                        tr._superstep(path, batches, slow, body, warm)
                    step()
                    loss = tr.supersteps.loss.clone()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                launches = {k: v for k, v in runtime.LAUNCHES.items() if v}
                results.append(([p.detach().clone() for p in tr.params],
                                [p.grad.detach().clone() for p in tr.params], loss))
                ms = device_ms(step, reps=2, windows=1)
                arm = f"remat {'on' if remat else 'off'}, superstep {mode}"
                arms[arm] = {"peak_bytes": peak, "step_ms": ms, "launches": launches}
                log(f"  {name} [{arm}]: peak {peak / 2**30:.2f} GiB above the baseline, steady step "
                    f"{ms:.3f} ms device time, first step's launches {launches}")
            want = results[0]
            for (remat, mode), got in zip(REMAT_ARMS[1:], results[1:]):
                for what, a, b in (("parameters", got[0], want[0]), ("gradients", got[1], want[1])):
                    d = max((x - y).abs().max().item() for x, y in zip(a, b))
                    assert all(torch.equal(x, y) for x, y in zip(a, b)), \
                        f"[4j] {name}: remat {remat} {mode}: {what} differ from remat off eager by {d:.3g}"
                assert torch.equal(got[2], want[2]), f"[4j] {name}: loss {got[2]} against {want[2]}"
            for mode in ("off", "auto"):  # the recompute ran (and, under auto, was captured)
                off = arms[f"remat off, superstep {mode}"]["launches"]
                on = arms[f"remat on, superstep {mode}"]["launches"]
                assert any(off.get(k) for k in REMAT_FWD), (name, mode, off)
                for k in set(off) | set(on):
                    want_n = 2 * off.get(k, 0) if k in REMAT_FWD else off.get(k, 0)
                    assert on.get(k, 0) == want_n, \
                        f"[4j] {name} under {mode}: {k} launched {on.get(k, 0)} times with remat, " \
                        f"{off.get(k, 0)} without ({want_n} expected)"
            off, on = arms["remat off, superstep auto"], arms["remat on, superstep auto"]
            log(f"  {name}: the four arms' gradients, parameters and loss sums bit for bit; graphed "
                f"peak {off['peak_bytes'] / 2**30:.2f} -> {on['peak_bytes'] / 2**30:.2f} GiB and step "
                f"{off['step_ms']:.3f} -> {on['step_ms']:.3f} ms with remat")
            out[name] = arms
            del tr, batches, saved, results
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def run_superstep_arms(torch, dev):
    """[4g](iii): ``--superstep auto`` against ``off`` on each recipe of
    ``SUPERSTEP_ARMS``: each arm's trainer runs the recipe's epochs (auto,
    then off); then, on the auto trainer's next plan, one untimed pass per
    arm (the auto arm captures that plan's new keys there), two timed
    passes of the epoch's training steps, probes off (off, then auto),
    and one pass each under ``torch.profiler`` for the busy share (device
    kernel time over the arm's median unprofiled pass wall). Per arm and
    epoch: walls, captures, replays, dispatches against the windows, host
    dispatch seconds; the peak device memory above the arm's baseline.
    Asserts: under auto every epoch's dispatches equal its windows (steps
    under off), an epoch whose batch sizes repeat an earlier epoch's
    captures nothing, and the timed passes capture nothing."""
    from torch.profiler import ProfilerActivity, profile

    from dynamic_load_balance_distributeddnn_tpu_torch.config import config_from_args
    from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
    from dynamic_load_balance_distributeddnn_tpu_torch.train.lm_engine import LMTrainer

    results = {}
    for name, argv in SUPERSTEP_ARMS:
        trainers, res = {}, {}
        for mode in ("auto", "off"):
            sub = os.path.join(OUT, "supersteps", name.split(",")[0].replace(" ", "_") + "_" + mode)
            shutil.rmtree(sub, ignore_errors=True)
            cfg = config_from_args(argv + ["--superstep", mode, "--log_dir", os.path.join(sub, "logs"),
                                           "--stat_dir", os.path.join(sub, "statis")])
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            tr = (LMTrainer if cfg.model == "transformer" else Trainer)(cfg, log_to_file=False)
            t0 = time.perf_counter()
            tr.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            recs = tr.recorder.meta["supersteps"]
            if mode == "auto":
                check_supersteps(tr.recorder.meta, f"{name} [auto]")
            for e, rec in enumerate(recs):
                assert rec["mode"] == ("scan" if mode == "auto" else "step"), rec
                want = rec["windows"] if mode == "auto" else rec["steps"]
                assert rec["dispatches"] == want, f"{name} {mode} epoch {e}: {rec}"
            walls = epoch_walls(tr.recorder.data)
            for e, rec in enumerate(recs):
                log(f"  {name} [{mode}] epoch {e} ({rec['path']}, batches {rec['batch_sizes']}): wall "
                    f"{walls[e]:.3f}s, {rec['steps']} steps in {rec['windows']} windows, dispatches "
                    f"{rec['dispatches']}, host dispatch {rec['host_dispatch_s']:.3f}s, captures "
                    f"{rec['captures']} ({rec['capture_s']:.2f}s), replays {rec['replays']}")
            log(f"  {name} [{mode}]: run {wall:.1f}s, peak device memory {peak / 2**30:.2f} GiB above "
                f"the arm's baseline (eager cli peaks before step graphs: {EAGER_PEAK_GIB})")
            trainers[mode] = tr
            res[mode] = {"epoch_walls": walls, "supersteps": recs, "run_s": wall, "peak_bytes": peak,
                         "passes": []}
        epoch = trainers["auto"].cfg.epoch_size
        plan, faults = trainers["auto"]._plan_epoch(epoch)

        def train_pass(mode):
            tr = trainers[mode]
            tr._probe_this_epoch = False  # the training steps alone
            train = tr._train_epoch_packed if tr._can_use_packed(plan) else tr._train_epoch_elastic
            before = tr.supersteps.stats()["captures"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train(plan, faults, epoch)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, tr.supersteps.stats()["captures"] - before, tr._host_meter

        for mode in ("off", "auto"):
            train_pass(mode)  # new keys of this plan captured here
        for mode in ("off", "auto"):  # (off, auto, auto, off) until [4j] and [7b] joined
            w, caps, meter = train_pass(mode)
            assert caps == 0, f"{name} {mode}: a pass on a repeated plan captured {caps}"
            res[mode]["passes"].append({"wall_s": w, "dispatches": meter.dispatches,
                                        "host_dispatch_s": meter.dispatch_s})
        for mode in ("auto", "off"):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                train_pass(mode)
            dev_us = sum(us for us, _ in kernel_us(prof).values())
            res[mode]["device_s"] = dev_us / 1e6
            res[mode]["busy"] = dev_us / 1e6 / statistics.median(p["wall_s"] for p in res[mode]["passes"])
        for mode in ("auto", "off"):
            r = res[mode]
            log(f"  {name} [{mode}] steady passes over one plan ({plan.num_steps} steps, batches "
                f"{plan.batch_sizes.tolist()}): walls {[round(p['wall_s'], 4) for p in r['passes']]}s, "
                f"host dispatch {[round(p['host_dispatch_s'], 4) for p in r['passes']]}s in "
                f"{r['passes'][0]['dispatches']} dispatches, device kernel time {r['device_s']:.4f}s, "
                f"busy {100 * r['busy']:.1f}%")
        results[name] = res
        del trainers
        torch.cuda.empty_cache()
    return results

def run_trainer(torch, argv, tag, epochs=None, injector=None, setup=None, timing_model=None):
    """The port's trainer on one recipe, as ``cli.main`` builds and runs it
    (``Trainer.run`` / ``LMTrainer.run``; ``injector`` and ``timing_model``
    given to the trainer, ``setup(trainer)`` called before the run), launch counts zeroed just
    before and read just after; returns (launch counts, series with their
    "_meta", wall, peak device memory in bytes, the trainer)."""
    from dynamic_load_balance_distributeddnn_tpu_torch.config import config_from_args
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
    from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
    from dynamic_load_balance_distributeddnn_tpu_torch.train.lm_engine import LMTrainer

    run_dir = os.path.join(OUT, tag)
    shutil.rmtree(run_dir, ignore_errors=True)
    cfg = config_from_args(argv + ["--log_dir", os.path.join(run_dir, "logs"),
                                   "--stat_dir", os.path.join(run_dir, "statis")])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    t0 = time.perf_counter()
    tr = (LMTrainer if cfg.model == "transformer" else Trainer)(
        cfg, injector=injector, timing_model=timing_model, log_to_file=False)
    if setup is not None:
        setup(tr)
    tr.run(epochs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(runtime.LAUNCHES)
    series = dict(tr.recorder.data, _meta=tr.recorder.meta)
    return counts, series, wall, torch.cuda.max_memory_allocated(), tr


def check_resume(torch, name, argv, mode, paths):
    """[4h]: one recipe under ``--superstep mode``: the whole run with
    ``--ckpt_dir`` (a save after each epoch), then a fresh trainer resuming
    from its checkpoint of epoch ``RESUME_EPOCHS - 2`` (copied alone into
    a directory of its own: the run as if stopped there) for the last
    epoch. The stop is taken from the whole run itself: a separate shorter
    run would probe its own walls, and on the card their noise can move its
    plans off the whole run's. The resumed run's parameters, momentum
    buffers and train loss equal the whole run's bit for bit; its recorder
    holds the last epoch alone, with the whole run's partition. Logs each
    save's and the restore's wall; both legs' launches join ``paths``."""
    tag = name.replace(" ", "_") + "_" + mode
    ck = os.path.join(SCRATCH, "ckpt", tag)  # DenseNet-121: 56 MB a checkpoint
    stop_ck = ck + "_stop"
    for d in (ck, stop_ck):
        shutil.rmtree(d, ignore_errors=True)
    base = argv + ["--superstep", mode, "--probe_mode", "always"]
    *run, whole = run_trainer(torch, base + ["--ckpt_dir", ck], f"resume/{tag}_whole")
    paths[f"resume_{tag}_whole"] = tuple(run)
    last = RESUME_EPOCHS - 1
    assert sorted(n for n in os.listdir(ck) if n.isdigit()) == [str(e) for e in range(RESUME_EPOCHS)]
    os.makedirs(stop_ck)
    shutil.copytree(os.path.join(ck, str(last - 1)), os.path.join(stop_ck, str(last - 1)))
    shutil.copy(os.path.join(ck, f"controller_{last - 1}.json"), stop_ck)
    *run, resumed = run_trainer(torch, base + ["--ckpt_dir", stop_ck], f"resume/{tag}_resumed")
    paths[f"resume_{tag}_resumed"] = tuple(run)
    assert resumed.recorder.data["epoch"] == [last], resumed.recorder.data["epoch"]
    assert resumed.recorder.data["partition"] == [whole.recorder.data["partition"][last]], \
        (resumed.recorder.data["partition"], whole.recorder.data["partition"])
    for (n, p), q in zip(whole.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), f"{name} [{mode}]: parameter {n} differs after the resume"
        assert torch.equal(whole.optimizer.state[p]["momentum_buffer"],
                           resumed.optimizer.state[q]["momentum_buffer"]), \
            f"{name} [{mode}]: momentum of {n} differs after the resume"
    assert resumed.recorder.data["train_loss"] == [whole.recorder.data["train_loss"][last]]
    assert resumed.steps_done == whole.steps_done
    saves = whole.recorder.meta["checkpoint"]["save_s"]
    restore = resumed.recorder.meta["checkpoint"]["restore_s"]
    n_params = sum(p.numel() for p in whole.params)
    log(f"  {name} [{mode}]: epoch {last} resumed bit for bit ({n_params:,} parameters and their "
        f"momentum, train loss {resumed.recorder.data['train_loss'][0]:.6f}, partition "
        f"{[round(x, 4) for x in resumed.recorder.data['partition'][0]]}); saves "
        f"{[round(t * 1e3, 1) for t in saves]} ms, restore {restore * 1e3:.1f} ms")
    for d in (ck, stop_ck):
        shutil.rmtree(d, ignore_errors=True)
    del whole, resumed
    gc.collect()  # the trainers' step graphs and pools go before the next recipe
    torch.cuda.empty_cache()
    return {"saves_s": saves, "restore_s": restore}


def check_elastic(torch, paths):
    """[4k]: ``--elastic on`` in one process at [4]'s width (``ELASTIC_ARGV``),
    driven through ``Trainer(cfg, injector=...)`` with a
    ``PreemptionInjector`` over the 3:1 straggler: worker 3 lost at
    epoch-time 1.4, back at epoch 3. Checks: ``workers_alive`` 4 -> 3 -> 4
    (``ELASTIC_ALIVE``), one recovery, in epoch 1; every partition sums to 1
    and splits the data disjointly; worker 0 (the straggler) holds the
    smallest share in the last epoch; finite losses; every epoch's steps
    replayed from step graphs, the re-run epoch's and the readmission
    epoch's graphs captured anew; K1 (tiled route) and K2 launched after
    the recovery (the counters read as it returns). Logs the seconds from
    the first miss to resumed training, each snapshot's wall and bytes, and
    the captures and capture seconds the new fleets forced."""
    import numpy as np

    from dynamic_load_balance_distributeddnn_tpu_torch.data.partitioner import partition_indices
    from dynamic_load_balance_distributeddnn_tpu_torch.faults import (
        PreemptionEvent,
        PreemptionInjector,
        StaticStragglerInjector,
    )
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime

    worker, down_at, rejoin = ELASTIC_EVENT
    factors = [float(x) for x in MAIN_ARGV[MAIN_ARGV.index("--straggler") + 1].split(",")]
    inj = PreemptionInjector(len(factors), [PreemptionEvent(worker, down_at, rejoin)],
                             base=StaticStragglerInjector(factors, mode="virtual"))
    at_recovery = {}

    def setup(tr):
        recover = tr._recover

        def counted(lost, epoch):
            recover(lost, epoch)
            at_recovery.update(runtime.LAUNCHES)

        tr._recover = counted

    log("  Trainer(cfg, injector=PreemptionInjector(4, [PreemptionEvent(worker=3, down_at=1.4, "
        "rejoin_epoch=3)], base=StaticStragglerInjector([3, 1, 1, 1]))) on "
        + " ".join(ELASTIC_ARGV))
    *run, tr = run_trainer(torch, ELASTIC_ARGV, "run_elastic_world", injector=inj, setup=setup)
    counts, series, wall, peak = run
    paths["vision_elastic_world"] = tuple(run)
    data, meta = tr.recorder.data, tr.recorder.meta
    assert data["workers_alive"] == ELASTIC_ALIVE, data["workers_alive"]
    assert data["recoveries"][-1] == 1.0, data["recoveries"]
    events = meta["elastic_events"]
    assert events[0]["lost"] == [worker] and events[0]["epoch"] == int(down_at), events
    assert any(e.get("readmitted") == [worker] and e["epoch"] == rejoin for e in events), events
    n = tr.n_train
    for shares in data["partition"]:
        assert abs(sum(shares) - 1.0) < 1e-9, shares
        owned = np.concatenate(partition_indices(n, shares))
        assert len(set(owned.tolist())) == len(owned) >= n - len(shares), shares
    final = data["partition"][-1]
    assert len(final) == len(factors) and min(range(len(final)), key=final.__getitem__) == 0, final
    assert all(math.isfinite(x) for x in data["train_loss"] + data["val_loss"]), data["train_loss"]
    recs = meta["supersteps"]
    assert [r["epoch"] for r in recs] == list(range(len(ELASTIC_ALIVE))), recs
    assert all(r["replays"] > 0 and r["path"] == "elastic" for r in recs), recs
    assert recs[int(down_at)]["captures"] > 0 and recs[rejoin]["captures"] > 0, recs
    after = {k: counts[k] - at_recovery[k] for k in CNN_KERNELS}
    assert all(v > 0 for v in after.values()), after
    assert counts["groupnorm_fwd_general"] == counts["groupnorm_bwd_general"] == 0, counts
    snap_bytes = 2 * 4 * sum(p.numel() for p in tr.params)  # parameters + momentum, f32
    log(f"  workers_alive {data['workers_alive']}, recoveries {data['recoveries']}; events {events}")
    log(f"  detection to resumed training {events[0]['detect_to_resume_s']:.4f} s; snapshots "
        f"({snap_bytes / 1e6:.1f} MB of parameters and momentum to the host each) "
        f"{[round(t * 1e3, 1) for t in meta['elastic_snapshot_s']]} ms")
    log(f"  captures a epoch {[r['captures'] for r in recs]}, capture seconds "
        f"{[round(r['capture_s'], 3) for r in recs]} (the fleets of 3 and 4 workers: epochs "
        f"{int(down_at)} and {rejoin}); replays {[r['replays'] for r in recs]}")
    log(f"  launches after the recovery {after} (of {dict((k, counts[k]) for k in CNN_KERNELS)}); "
        f"partition {data['partition']}; train loss {[round(x, 4) for x in data['train_loss']]}; "
        f"epoch walls {[round(w, 3) for w in epoch_walls(series)]} s; peak {peak / 2**30:.2f} GiB")
    out = {"events": events, "snapshot_s": meta["elastic_snapshot_s"], "snapshot_bytes": snap_bytes,
           "captures": [r["captures"] for r in recs], "capture_s": [r["capture_s"] for r in recs],
           "after_recovery": after, "wall": wall}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_bytes_on_card(tr) -> int:
    """The training set's bytes on the trainer's card: its resident arrays,
    or, for a path not yet fed from the host, its upload (``_train_dev``)."""
    arrays = [t for t in (tr.train_x, tr.train_y) if t.device.type == "cuda"]
    arrays += list(tr._train_dev or ())
    return sum(t.numel() * t.element_size() for t in arrays)


def profiled_pass(torch, tr):
    """One training pass of the trainer's next plan, probes off, under the
    profiler: (wall, device seconds, busy share). The device time sums
    every device record (kernels and the copy stream's copies)."""
    from torch.profiler import ProfilerActivity, profile

    epoch = tr.cfg.epoch_size
    plan, faults = tr._plan_epoch(epoch)
    tr._probe_this_epoch = False
    train = tr._train_epoch_packed if tr._can_use_packed(plan) else tr._train_epoch_elastic
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(plan, faults, epoch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_s = sum(us for us, _ in kernel_us(prof).values()) / 1e6
    return wall, dev_s, dev_s / wall


def gather_rates(tr):
    """``take_rows`` (the C++ gather) against ``np.take`` over one window's
    rows of the training set (2 steps of B = 512, random rows): the median
    of 5 calls each, in GB/s of rows written."""
    import numpy as np

    from dynamic_load_balance_distributeddnn_tpu_torch.runtime.native import take_rows

    data = tr.train_x.numpy()
    sel = np.random.RandomState(0).randint(0, len(data), size=2 * tr.cfg.batch_size)
    out = np.empty((len(sel),) + data.shape[1:], data.dtype)
    rates = {}
    for name, fn in (("take_rows", lambda: take_rows(data, sel, out=out)),
                     ("np.take", lambda: np.take(data, sel, axis=0, out=out))):
        fn()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        rates[name] = out.nbytes / statistics.median(walls) / 1e9
    return rates, out.nbytes


def check_host_fed(torch, paths):
    """[4l]: ``HOST_FED_ARGV`` in each arm of ``HOST_FED_ARMS`` under
    ``--device_cache on`` (the resident twin) and ``off`` (fed from the
    host), cuDNN deterministic, the partitions fixed by ``ms_linear_time``:
    each host-fed run's parameters, momentum buffers, train and validation
    losses and partitions equal its twin's bit for bit; its training set
    stays on the host (no byte of it on the card: the staged windows come
    and go); ``host_put_s`` > 0 every epoch; every epoch in step graphs, one
    dispatch a window; K1 and K2 launched. The C++ host runtime must have
    loaded. Logs the epoch walls, ``host_put_s``, the busy share of one
    profiled pass a run, the training-set bytes on the card, and the
    gather's GB/s against ``np.take``; each run's launches join ``paths``."""
    from dynamic_load_balance_distributeddnn_tpu_torch.runtime.native import (
        native_available,
        native_impl,
    )

    assert native_available(), f"the C++ host runtime did not load ({native_impl()})"
    out = {}
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for arm, extra in HOST_FED_ARMS:
            runs = {}
            for cache in ("on", "off"):
                argv = HOST_FED_ARGV + extra + ["--device_cache", cache]
                log("  python -m dynamic_load_balance_distributeddnn_tpu_torch.cli " + " ".join(argv)
                    + " (timing model: rows x steps)")
                *run, tr = run_trainer(torch, argv, f"host_fed/{arm}_{cache}",
                                       timing_model=ms_linear_time)
                counts, series, wall, peak = run
                paths[f"host_fed_{arm}_{cache}"] = tuple(run)
                check_cnn_path(counts, series, f"[4l] {arm} --device_cache {cache}",
                               path="packed" if arm == "packed" else "elastic", epochs=2,
                               moved_off=0)
                runs[cache] = (tr, series, wall, peak)
            (on, s_on, wall_on, peak_on), (off, s_off, wall_off, peak_off) = runs["on"], runs["off"]
            assert on._use_device_cache and not off._use_device_cache
            for key in ("train_loss", "val_loss", "accuracy", "partition", "node_time"):
                assert s_on[key] == s_off[key], f"[4l] {arm}: {key} {s_on[key]} != {s_off[key]}"
            for (n, p), q in zip(on.model.named_parameters(), off.model.parameters()):
                assert torch.equal(p, q), f"[4l] {arm}: parameter {n} differs from the resident run"
                assert torch.equal(on.optimizer.state[p]["momentum_buffer"],
                                   off.optimizer.state[q]["momentum_buffer"]), \
                    f"[4l] {arm}: momentum of {n} differs from the resident run"
            on_card = {c: train_bytes_on_card(runs[c][0]) for c in ("on", "off")}
            assert on_card["off"] == 0 and on_card["on"] > 0, on_card
            puts = s_off["host_put_s"]
            assert all(v > 0 for v in puts) and all(v == 0 for v in s_on["host_put_s"]), puts
            recs = s_off["_meta"]["supersteps"]
            assert all(r["windows"] == 4 and r["dispatches"] == 4 for r in recs), recs
            busy = {c: profiled_pass(torch, runs[c][0]) for c in ("on", "off")}
            w_on, w_off = epoch_walls(s_on), epoch_walls(s_off)
            log(f"  [{arm}] bit for bit with the resident twin: {len(list(on.params))} parameter "
                f"tensors and their momentum, train loss {[round(x, 6) for x in s_off['train_loss']]}, "
                f"partitions {s_off['partition']}")
            log(f"  [{arm}] epoch walls: host-fed {[round(w, 3) for w in w_off]} s, resident "
                f"{[round(w, 3) for w in w_on]} s; cli walls {wall_off:.1f} / {wall_on:.1f} s; "
                f"host_put_s {[round(v, 4) for v in puts]}; peak device memory "
                f"{peak_off / 2**30:.2f} / {peak_on / 2**30:.2f} GiB")
            log(f"  [{arm}] one profiled pass: host-fed wall {busy['off'][0]:.3f}s, device "
                f"{busy['off'][1]:.3f}s, busy {100 * busy['off'][2]:.1f}%; resident wall "
                f"{busy['on'][0]:.3f}s, device {busy['on'][1]:.3f}s, busy {100 * busy['on'][2]:.1f}%")
            log(f"  [{arm}] training-set bytes on the card: host-fed {on_card['off']:,}, resident "
                f"{on_card['on']:,}")
            out[arm] = {"epoch_walls": {"off": w_off, "on": w_on}, "host_put_s": puts,
                        "busy": busy, "train_bytes_on_card": on_card,
                        "cli_wall": {"off": wall_off, "on": wall_on}}
            if arm == HOST_FED_ARMS[0][0]:
                rates, nbytes = gather_rates(off)
                log(f"  take_rows {rates['take_rows']:.2f} GB/s, np.take {rates['np.take']:.2f} GB/s "
                    f"over one window's rows ({nbytes:,} bytes; host clock, warm)")
                out["gather_gb_s"] = rates
            del on, off, runs
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def check_trace(path_dir, what, mode):
    """[4i]: a traced run's Chrome trace attributes at least 95% of each
    epoch's wall to its phases (``scope_cli summarize``), and
    ``postmortem`` reads its spool. Returns the attribution."""
    import glob

    from dynamic_load_balance_distributeddnn_tpu_torch.obs import scope_cli
    from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import attribution, load_trace

    d = os.path.join(TRACE_DIR, path_dir)
    (trace,) = glob.glob(os.path.join(d, "*.trace.json"))
    att = attribution(load_trace(trace))
    log(f"  {what} (--trace {mode}): {trace}")
    for line in scope_cli.summarize(trace).splitlines():
        log("    " + line)
    covs = [ep["coverage"] for ep in att["epochs"].values()]
    assert covs and min(covs) >= 0.95, f"{what}: attribution {covs} below 95% of an epoch's wall"
    pm = json.loads(scope_cli.postmortem(os.path.join(d, "spool"), as_json=True))
    procs = pm["processes"].values()
    n_ev = sum(p.get("events", 0) for p in procs)
    assert procs and n_ev > 0, f"{what}: postmortem read no spooled events: {pm}"
    log(f"  {what}: postmortem read {len(procs)} process(es), {n_ev} events, "
        f"torn {[p.get('truncated') for p in procs]}")
    return att


def check_window_spool(series):
    """[4i]: ``replay`` of [4e]'s spool (``--trace ring``) reproduces every
    verdict the run's controller recorded."""
    from dynamic_load_balance_distributeddnn_tpu_torch.balance import replaylab
    from dynamic_load_balance_distributeddnn_tpu_torch.obs import scope_cli

    spool = os.path.join(TRACE_DIR, "window", "spool")
    corpus = replaylab.load_corpus(spool)
    report = replaylab.replay(corpus)
    ctl = series["_meta"]["rebalance_controller"]
    assert report["parity"] and report["invariant_violations"] == [], report["mismatches"][:3]
    assert len(corpus["journal"]) == ctl["evals"], (len(corpus["journal"]), ctl["evals"])
    assert report["replayed"]["switches"] == sum(series["plan_switches"])
    text, ok = scope_cli.replay_cmd(spool, {})
    assert ok, text
    log(f"  [4e]'s spool: {len(corpus['journal'])} verdicts replayed bit for bit "
        f"({report['replayed']['switches']} switches)")


def check_profile(torch, paths):
    """[4i]: [4f]'s packed bf16 recipe (``PROFILE_ARGV``) under
    ``--profile_dir``: its Chrome trace's K1 kernels (``gn_*``), counted,
    beside those whose correlation is a ``cudaGraphLaunch`` (launched from a
    graph replay) and the wrappers' launch counts. No K1 kernel from a
    replay in the trace is a finding about the profiler (CUPTI under CUDA
    graphs), logged as such, not a fault of the port."""
    prof_dir = os.path.join(SCRATCH, "profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    run = run_path(torch, PROFILE_ARGV + ["--profile_dir", prof_dir], "run_profile")
    paths["vision_bf16_profiled"] = run
    counts, series = run[:2]
    with open(series["_meta"]["profile_trace"]) as f:
        events = json.load(f)["traceEvents"]
    graph_corr = {e["args"]["correlation"] for e in events
                  if "GraphLaunch" in str(e.get("name", "")) and "correlation" in e.get("args", {})}
    k1 = [e for e in events if e.get("cat") == "kernel" and "gn_" in str(e.get("name", ""))]
    k1_graph = [e for e in k1 if e.get("args", {}).get("correlation") in graph_corr
                or "graph node id" in e.get("args", {})]
    out = {"trace": series["_meta"]["profile_trace"], "events": len(events),
           "graph_launches": len(graph_corr), "k1_kernels": len(k1),
           "k1_from_graphs": len(k1_graph),
           "k1_wrapper_launches": counts["groupnorm_fwd"] + counts["groupnorm_bwd"],
           "k1_names": sorted({e["name"] for e in k1})[:8]}
    log(f"  profiler trace: {out['events']} events, {out['graph_launches']} cudaGraphLaunch calls; "
        f"K1 kernels {out['k1_kernels']}, of which from graph replays {out['k1_from_graphs']}; "
        f"the K1 wrappers counted {out['k1_wrapper_launches']} launches (replays included)")
    assert k1, "the profiler's trace holds no K1 kernel"
    if not k1_graph:
        log("  FINDING: the profiler's trace shows no K1 kernel from inside a graph replay "
            "(CUPTI on this stack does not report graph-node kernels)")
    with open(os.path.join(OUT, "profile_summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def check_mfu(paths):
    """[4i]: ``flops_per_epoch`` and ``mfu_bf16_peak`` of [4], [4f] and
    [5], each MFU in (0, 1]."""
    for tag in ("vision", "vision_bf16", "lm"):
        if tag not in paths:
            continue
        series = paths[tag][1]
        flops, util = series["flops_per_epoch"], series["mfu_bf16_peak"]
        assert all(0.0 < u <= 1.0 for u in util), f"{tag}: mfu_bf16_peak {util}"
        log(f"  {tag}: flops_per_epoch {[f'{x:.4e}' for x in flops]}, mfu_bf16_peak "
            f"{[round(u, 5) for u in util]} (FLOPs an example "
            f"{series['_meta']['flops_per_example']:.4e})")


def time_kernels(torch, dev):
    """[3]'s timing: K1's route for every GroupNorm call of the four
    families at b = 128 and 512 (f32 and bf16), K1 over DenseNet-121 worker
    passes (``GN_BATCHES``) and DenseNet-121's packed pass (f32 and bf16), K2 and K3 at their path shapes; logs each beside its
    bound, plain version and library call. Returns (the JSON line's timing
    rows, K1's worker-pass, packed and packed bf16 tables, K2's and K3's
    tables, DenseNet-121's GroupNorm shapes at b = 128, K1's routes)."""
    gn_routes = {}
    for name in ("densenet",) + FAMILIES:
        for b, dtype in ((GN_LINE_BATCH, torch.float32), (GN_PACKED_B, torch.float32),
                         (GN_PACKED_B, torch.bfloat16)):
            calls, general = model_gn_shapes(torch, dev, name, b, dtype=dtype)
            what = f"{name} b={b}" + (" bf16" if dtype == torch.bfloat16 else "")
            gn_routes[what] = {"calls": len(calls), "general": general}
            log(f"  K1 routes, {what}: {len(calls)} GroupNorm calls a forward, "
                f"{general} of {2 * len(calls)} forward + backward launches on the general route")
            # bf16 needs C in whole 8-element vectors: every family's C is
            assert dtype == torch.float32 or general == 0, f"{what}: {general} general-route launches"
    shapes = model_gn_shapes(torch, dev, "densenet", GN_LINE_BATCH)[0]
    t0 = time.perf_counter()
    gt = {b: time_groupnorm(torch, dev, [(b,) + sh[1:] for sh in shapes]) for b in GN_BATCHES}
    # one packed step's pass at b = 512: DenseNet-121's (ResNet-101's too
    # until [4j] and [7b] joined: the script's time)
    gp = {name: time_groupnorm(torch, dev, model_gn_shapes(torch, dev, name, GN_PACKED_B)[0],
                               general=False)
          for name in ("densenet",)}
    # and the same pass on bf16 activations (--precision bfloat16)
    gp16 = {name: time_groupnorm(torch, dev, model_gn_shapes(torch, dev, name, GN_PACKED_B)[0],
                                 general=False, dtype=torch.bfloat16)
            for name in ("densenet",)}
    timing = dict(gt[GN_LINE_BATCH])
    t1 = time.perf_counter()
    xt = time_xent(torch, dev)
    t2 = time.perf_counter()
    at = time_flash(torch, dev)
    log(f"  timing seconds: K1 {t1 - t0:.1f}, K2 {t2 - t1:.1f}, K3 {time.perf_counter() - t2:.1f}")
    # the JSON line's K2 and short-route K3 rows are at the language model's
    # shapes, the tiled K3 rows at the long-context shape they now serve
    timing.update(xt[XENT_LM_SHAPE])
    timing.update(at[ATTN_PATH_SHAPE])
    timing.update(at[ATTN_LONG_SHAPE])
    rows = [(f"[{r}, {v}]", k, t) for (r, v), row in xt.items() for k, t in row.items()]
    rows += [(f"{sh} causal", k, t) for sh, row in at.items() for k, t in row.items()]
    for where, k, t in rows:
        tiled = f", tiled route {t['tiled_ms']:.4f} ms" if "tiled_ms" in t else ""
        f32 = f", f32 FMA bound {t['bound_f32_ms']:.6f} ms" if "bound_f32_ms" in t else ""
        log(f"  {k} {where}: kernel {t['ms']:.4f} ms (event wall {t['wall_ms']:.4f}){tiled}, "
            f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}{', 3xTF32' if f32 else ''}){f32}")
    for b, row in gt.items():
        for k in ("groupnorm_fwd", "groupnorm_bwd"):
            t = row[k]
            log(f"  {k} x{len(shapes)} (one DenseNet-121 worker pass, b={b}): kernel {t['ms']:.3f} ms "
                f"(event wall {t['wall_ms']:.3f}; {100 * t['bound_ms'] / t['ms']:.0f}% of bound), "
                f"general route (was) {t['was_ms']:.3f} ms (event wall "
                f"{row[k + '_general']['wall_ms']:.3f}), plain {t['plain_ms']:.3f} ms, "
                f"library {t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms ({t['bound_by']})")
    for name, row in list(gp.items()) + [(n + " bf16", r) for n, r in gp16.items()]:
        for k in ("groupnorm_fwd", "groupnorm_bwd"):
            t = row[k]
            log(f"  {k} ({name} packed pass, b={GN_PACKED_B}): kernel {t['ms']:.3f} ms "
                f"(event wall {t['wall_ms']:.3f}; {100 * t['bound_ms'] / t['ms']:.0f}% of bound), "
                f"plain {t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms, "
                f"bound {t['bound_ms']:.3f} ms ({t['bound_by']})")
    torch.cuda.empty_cache()
    return timing, gt, gp, gp16, xt, at, shapes, gn_routes


def run_rank_phases(tag: str, jobs, ranks: int, timeout: float):
    """``ranks`` ranks of one gloo group on ``cuda:0``, started once, running
    ``jobs`` in order (``scripts/rank_launch.py`` ``run_rank_jobs``: each cli
    job reuses the group, each starts from zeroed launch counters): joined
    with ``timeout`` seconds, all killed (and their logs printed) when one
    fails or the time runs out. Returns ``(the jobs' results by name, the
    launch's directory)``; logs the launch's wall and start-up."""
    from scripts.rank_launch import RanksFailed, run_rank_jobs

    run_dir = os.path.join(OUT, tag)
    shutil.rmtree(run_dir, ignore_errors=True)
    for name, job in jobs.items():
        what = ("python -m dynamic_load_balance_distributeddnn_tpu_torch.cli " + " ".join(job["argv"])
                + f" --num_processes {ranks} --process_id <i>") if "argv" in job else job["call"]
        log(f"  {name}: {what}")
    try:
        got, wall, startup = run_rank_jobs(jobs, ranks, run_dir, timeout)
    except RanksFailed as e:
        log(str(e))
        raise AssertionError(f"{tag}: the ranks failed") from None
    jobs_s = sum(max(r["wall"] for r in res) for res in got.values())
    log(f"  {ranks} ranks started once for {len(jobs)} jobs: launch wall {wall:.1f}s, of which "
        f"the jobs {jobs_s:.1f}s and each rank's start-up (imports, CUDA, rendezvous) "
        f"{[round(x, 1) for x in startup]} s")
    return got, run_dir


def job_wall(results) -> float:
    """A job's wall: the slowest rank's (every job starts behind a barrier)."""
    return max(r["wall"] for r in results)


def cli_series(run_dir: str, name: str, argv, ranks: int):
    """Rank 0's series of cli job ``name`` of a ``run_rank_phases`` launch."""
    from dynamic_load_balance_distributeddnn_tpu_torch.config import config_from_args
    from scripts.rank_launch import cli_job_argv

    full = cli_job_argv({"argv": argv}, ranks, os.path.join(run_dir, name)) + ["--process_id", "0"]
    cfg = config_from_args(full)
    with open(os.path.join(cfg.stat_dir, cfg.base_filename().format(0) + ".json")) as f:
        return json.load(f)


def cli_arm(got, run_dir: str, name: str, argv, ranks: int):
    """(each rank's report, rank 0's series, the job's wall) of a cli job."""
    return ([r["report"] for r in got[name]], cli_series(run_dir, name, argv, ranks),
            job_wall(got[name]))


def check_ranks(arm: str, reports, series, wall, tag: str = "[7]", kernels=CNN_KERNELS):
    """The checks of one arm of [7] (DenseNet-121) or of [7c] (the LM,
    ``kernels`` ``LM_KERNELS``; the module docstring): gloo over 2 ranks
    staged through pinned memory, ``kernels`` launched on each rank, the
    ranks' parameters bit for bit equal, finite and falling losses, share
    moved off worker 0 in (a) and (b), ``comm_bytes_ici`` the flat formula
    (4 bytes an element, or the int8 wire's) times each epoch's combines,
    in (c) each rank's momentum chunk half the padded parameter count. Logs
    the walls, the collective a step, the bytes and each rank's launches
    and peak."""
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.wire import wire_payload_bytes

    for r in reports:
        assert r["ranks"]["backend"] == "gloo" and r["ranks"]["size"] == DIST_RANKS, r["ranks"]
        assert r["ranks"]["staged_through_host"], r["ranks"]
        for k in kernels:
            assert r["launches"][k] > 0, (tag, arm, r["rank"], k, r["launches"])
    digests = {r["param_sha256"] for r in reports}
    assert len(digests) == 1, f"{tag} ({arm}): the ranks' parameters differ: {digests}"
    losses = series["train_loss"]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], losses
    share = series["partition"][-1][0]
    if arm in ("a", "b"):
        assert share < DIST_SHARE_MAX, f"{tag} ({arm}): worker 0's share {share} by the last epoch"
    comb = reports[0]["combine"]
    elems = comb["flat_elems"]
    per_elem = wire_payload_bytes("int8", DIST_RANKS) if comb["compress_grads"] == "int8" else 4
    steps = [c["steps"] for c in reports[0]["collective"]]
    want = [float(elems * per_elem) * n for n in steps]
    assert series["comm_bytes_ici"] == want, (tag, arm, series["comm_bytes_ici"], want)
    if arm == "c":
        for r in reports:
            c = r["combine"]
            assert c["shard_update"] and 2 * c["momentum_chunk_elems"] == c["padded_elems"], c
    walls = epoch_walls(series)
    log(f"  ({arm}) arm wall {wall:.1f}s (its job in the ranks' one launch); paths "
        f"{reports[0]['paths']}; epoch walls {[round(w, 3) for w in walls]} s; train loss "
        f"{[round(x, 4) for x in losses]}; val loss {[round(x, 4) for x in series['val_loss']]}; "
        f"partition {series['partition']}")
    log(f"  ({arm}) bytes a step {elems * per_elem:.0f} ({elems:,} elements x {per_elem}) x steps "
        f"{steps}: comm_bytes_ici {series['comm_bytes_ici']}; sync_time {series['sync_time']} s; "
        f"combine {comb}")
    for r in reports:
        coll = [(c["epoch"], round(1e3 * c["mean_s"], 2), round(1e3 * c["max_s"], 2))
                for c in r["collective"] or []]
        log(f"  ({arm}) rank {r['rank']}: collective wall a step (epoch, mean ms, max ms) {coll}; "
            f"launches {launch_text(r['launches'], kernels)}; peak device memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; parameters sha256 {r['param_sha256'][:16]}")
    return {"wall": wall, "epoch_walls": walls, "series": series, "reports": reports}


def arm_argv(prefix: str, arm: str, argv):
    """A rank arm's flags: the resumed arm's (``RESUMED_ARMS``) save a
    checkpoint an epoch under ``RANK_CKPT``."""
    if RESUMED_ARMS.get(prefix) != arm:
        return list(argv)
    return list(argv) + ["--ckpt_dir", os.path.join(RANK_CKPT, f"{prefix}_{arm}")]


def arm_jobs(prefix: str, base, arms):
    """The rank jobs of ``arms`` (``(arm, what, extra flags)``) on ``base``;
    the resumed arm runs deterministic (cuDNN), saving each epoch, and is
    followed by a job that copies its epoch-0 checkpoint alone
    (``stop_checkpoint``) and by the run resumed from that copy. Its
    checkpoint directories are emptied first (a whole run would resume
    from a stale one)."""
    jobs = {}
    for arm, _, extra in arms:
        jobs[f"{prefix}_{arm}"] = {"argv": arm_argv(prefix, arm, base + extra)}
        if RESUMED_ARMS.get(prefix) == arm:
            ck = os.path.join(RANK_CKPT, f"{prefix}_{arm}")
            for d in (ck, ck + "_stop"):
                shutil.rmtree(d, ignore_errors=True)
            jobs[f"{prefix}_{arm}"]["deterministic"] = True
            jobs[f"{prefix}_{arm}_stop"] = {"call": "chip_smoke:stop_checkpoint",
                                            "args": {"src": ck, "dst": ck + "_stop", "epoch": 0}}
            jobs[f"{prefix}_{arm}_resumed"] = {"argv": base + extra + ["--ckpt_dir", ck + "_stop"],
                                               "deterministic": True}
    return jobs


def stop_checkpoint(args, rank: int, world: int, device: str):
    """A call job of [7] and [7b]: rank 0 copies the whole run's checkpoint
    of epoch ``args["epoch"]`` (its directory and its sidecar) alone into
    ``args["dst"]``, the run as if stopped after that epoch (the next job
    starts behind a barrier). Returns the state file's bytes on rank 0."""
    if rank != 0:
        return None
    src, dst, e = args["src"], args["dst"], args["epoch"]
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    shutil.copytree(os.path.join(src, str(e)), os.path.join(dst, str(e)))
    shutil.copy(os.path.join(src, f"controller_{e}.json"), dst)
    return os.path.getsize(os.path.join(dst, str(e), "state.pt"))


def check_rank_resume(tag: str, prefix: str, arm: str, extra, base, got, run_dir: str,
                      ranks: int):
    """[7] (c) or [7b] (b) resumed: the run resumed from the whole run's
    epoch-0 checkpoint ends with the whole run's parameters on every rank
    (their SHA-256), and its series holds epoch 1 alone, with the whole
    run's partition and train loss. Logs each save's wall (a collective:
    ZeRO-1's chunks and the residual rows gathered, rank 0 writing), the
    restore's and the checkpoint's bytes; removes the checkpoints."""
    whole, whole_series, _ = cli_arm(got, run_dir, f"{prefix}_{arm}",
                                     arm_argv(prefix, arm, base + extra), ranks)
    ck = os.path.join(RANK_CKPT, f"{prefix}_{arm}")
    resumed, series, wall = cli_arm(got, run_dir, f"{prefix}_{arm}_resumed",
                                    base + extra + ["--ckpt_dir", ck + "_stop"], ranks)
    for w, r in zip(whole, resumed):
        assert w["param_sha256"] == r["param_sha256"], \
            f"{tag} ({arm}) resumed: rank {r['rank']}'s parameters differ from the whole run's"
    assert series["epoch"] == [1], series["epoch"]
    assert series["partition"] == whole_series["partition"][1:], \
        (series["partition"], whole_series["partition"])
    assert series["train_loss"] == whole_series["train_loss"][1:], \
        (series["train_loss"], whole_series["train_loss"])
    saves = whole_series["_meta"]["checkpoint"]["save_s"]
    restore = series["_meta"]["checkpoint"]["restore_s"]
    nbytes = got[f"{prefix}_{arm}_stop"][0]["result"]
    log(f"  ({arm}) resumed from the whole run's epoch-0 checkpoint ({nbytes / 1e6:.1f} MB): every "
        f"rank's parameters bit for bit the whole run's (sha256 {resumed[0]['param_sha256'][:16]}), "
        f"epoch 1's train loss {series['train_loss'][0]:.6f} and partition "
        f"{series['partition'][0]} its own; saves across {ranks} ranks "
        f"{[round(t * 1e3, 1) for t in saves]} ms, restore {restore * 1e3:.1f} ms (rank 0); "
        f"job wall {wall:.1f}s")
    for d in (ck, ck + "_stop"):
        shutil.rmtree(d, ignore_errors=True)
    return {"wall": wall, "saves_s": saves, "restore_s": restore, "bytes": nbytes}


def hier_bytes(elems: int, sizes, wires):
    """The hier combine's (ICI, DCN) bytes a step (the JAX package's
    formula, ``Trainer._comm_bytes_per_step``), from the port's per-hop
    bytes (``parallel/wire.py`` ``tree_hop_bytes``): the top hop DCN, the
    others ICI."""
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.wire import tree_hop_bytes

    hops = tree_hop_bytes(elems, sizes, wires)
    return float(sum(b for _, b in hops[:-1])), float(hops[-1][1])


def check_hier_ranks(arm: str, reports, series, wall, kernels=CNN_KERNELS):
    """[7b]'s checks of one arm: gloo over 4 ranks staged through pinned
    memory, K1 and K2 launched on each rank, the ranks' parameters bit for
    bit equal, finite and falling losses, one combine and one bandwidth
    verdict on every rank, and the recorded ``comm_bytes_*`` the hier
    formula (the flat one where the learned tree merged to flat) times each
    epoch's combines. Logs the walls, the collective a step, the bytes, the
    probe's rates and each rank's peak memory."""
    for r in reports:
        assert r["ranks"]["backend"] == "gloo" and r["ranks"]["size"] == HIER_RANKS, r["ranks"]
        assert r["ranks"]["staged_through_host"], r["ranks"]
        for k in kernels:
            assert r["launches"][k] > 0, (arm, r["rank"], k, r["launches"])
    digests = {r["param_sha256"] for r in reports}
    assert len(digests) == 1, f"[7b] ({arm}): the ranks' parameters differ: {digests}"
    for key in ("grad_comm", "grad_comm_wires", "link_bandwidth"):
        vals = [json.dumps(r[key], sort_keys=True) for r in reports]
        assert len(set(vals)) == 1, f"[7b] ({arm}): the ranks disagree on {key}: {vals}"
    losses = series["train_loss"]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], losses
    r0, meta = reports[0], series["_meta"]
    kind, wires, comb = r0["grad_comm"], r0["grad_comm_wires"], r0["combine"]
    elems = comb["flat_elems"]
    if kind == "hier":
        sizes = [s for _, s in meta["grad_comm_levels"]]
        ici, dcn = hier_bytes(elems, sizes, wires)
        assert comb["grad_comm"] == "hier" and comb["wires"] == wires, comb
    else:
        assert arm == "c", f"[7b] ({arm}) ran {kind}"
        ici, dcn = float(elems * 4), 0.0
    steps = [c["steps"] for c in r0["collective"]]
    assert series["comm_bytes_ici"] == [ici * n for n in steps], (series["comm_bytes_ici"], ici, steps)
    assert series["comm_bytes_dcn"] == [dcn * n for n in steps], (series["comm_bytes_dcn"], dcn, steps)
    if arm == "b":
        assert comb["shard_update"] and 4 * comb["momentum_chunk_elems"] == comb["padded_elems"], comb
    bw = r0["link_bandwidth"]
    walls = epoch_walls(series)
    log(f"  ({arm}) arm wall {wall:.1f}s (its job in the ranks' one launch); combine {kind}, "
        f"levels {meta.get('grad_comm_levels')}, wires {wires}, modeled combine "
        f"{meta.get('modeled_comm_step_s')} s; epoch walls {[round(w, 3) for w in walls]} s; "
        f"train loss {[round(x, 4) for x in losses]}; partition {series['partition']}")
    log(f"  ({arm}) bytes a step: ICI {ici:.0f}, DCN {dcn:.0f} (the {kind} formula, {elems:,} "
        f"elements) x steps {steps}: comm_bytes_ici {series['comm_bytes_ici']}, comm_bytes_dcn "
        f"{series['comm_bytes_dcn']}; sync_time {series['sync_time']} s")
    if bw is not None:
        log(f"  ({arm}) bandwidth probe (rank 0's numbers on every rank): level bytes/s "
            f"{[round(x) for x in bw['level_bytes_per_s']]}, phases {bw['phase_s']} s, tree "
            f"{bw['hier_wall_s']} s against flat {bw['flat_wall_s']} s (ratio {bw['wall_ratio']}, "
            f"gate {bw['gate_ratio']}): hier_wins {bw['hier_wins']}")
    for r in reports:
        coll = [(c["epoch"], round(1e3 * c["mean_s"], 2), round(1e3 * c["max_s"], 2))
                for c in r["collective"] or []]
        log(f"  ({arm}) rank {r['rank']}: collective wall a step (epoch, mean ms, max ms) {coll}; "
            f"launches {launch_text(r['launches'], kernels)}; peak device "
            f"memory {r['peak_bytes'] / 2**30:.2f} GiB")
    return {"wall": wall, "epoch_walls": walls, "series": series, "reports": reports}


def launch_text(launches, kernels) -> str:
    return ", ".join(f"{k} {launches[k]}" for k in kernels)


def sp_checks(args, rank: int, world: int, device: str):
    """[8]'s checks inside each rank (a ``run_rank_jobs`` call): (1) the
    first full window of ``SP_ARGV``'s training stream, ``[SP_B, SP_T]``,
    through ``seq_parallel_value_and_grad`` of the ring and the Ulysses LM
    (dropout 0) against the one-device LM on the card with the same weights
    (``TransformerLM`` without ``seq_axis``, the whole window, its loss the
    mean of the plain per-token losses, ``xent_fwd_ref``, so that K2 is on
    one side only): the loss's relative difference and the gradients'
    largest difference; (2) ``ulysses_self_attention`` with
    ``use_flash=True`` (one head a rank, T = ``SP_T``: K3's tiled route)
    against ``use_flash=False`` on the same random blocks: the output's and
    the gradients' largest differences, and K3's tiled launches."""
    import torch

    from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
    from dynamic_load_balance_distributeddnn_tpu_torch.data import Corpus, batchify, bptt_windows
    from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model
    from dynamic_load_balance_distributeddnn_tpu_torch.models.common import init_flax_defaults
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import xent_fwd_ref
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.mesh import data_mesh
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.seq_parallel import (
        seq_parallel_value_and_grad,
    )
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.ulysses import (
        ulysses_self_attention,
    )
    from dynamic_load_balance_distributeddnn_tpu_torch.train.sp_engine import SeqParallelLMTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    mesh = data_mesh(dev)
    corpus = Corpus(Config().lm_data_dir)
    b, t_all = SP_B, SP_T
    x, y, _ = bptt_windows(batchify(corpus.train, b), t_all)
    tokens, targets = (torch.from_numpy(a[0]).to(dev) for a in (x, y))
    t = t_all // world
    lo = rank * t
    sp_cls = SeqParallelLMTrainer
    dims = dict(ntoken=corpus.ntokens, ninp=sp_cls.EMSIZE, nhead=sp_cls.NHEAD, nhid=sp_cls.NHID,
                nlayers=sp_cls.NLAYERS, dropout=0.0)
    single = build_model("transformer", **dims)
    init_flax_defaults(single, torch.Generator().manual_seed(1))
    single = single.to(dev)
    loss_ref = xent_fwd_ref(single(tokens).reshape(-1, corpus.ntokens), targets.reshape(-1))[0].mean()
    grads_ref = torch.autograd.grad(loss_ref, list(single.parameters()))
    out = {"one_device_loss": float(loss_ref)}
    for mode in SP_MODES:
        sp = build_model("transformer", **dims, seq_axis=mesh, sp_mode=mode).to(dev)
        sp.load_state_dict(single.state_dict())
        loss, grads = seq_parallel_value_and_grad(sp, tokens[:, lo:lo + t], targets[:, lo:lo + t],
                                                  mesh)
        out[mode] = {"loss": float(loss),
                     "loss_rel": abs(float(loss) - float(loss_ref)) / abs(float(loss_ref)),
                     "grad_max_abs": max(float((g - r).abs().max())
                                         for g, r in zip(grads, grads_ref))}
        del sp, grads
    del single, grads_ref
    gen = torch.Generator(device=dev).manual_seed(7 + rank)
    shape = (b, sp_cls.NHEAD, t, sp_cls.EMSIZE // sp_cls.NHEAD)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev) for _ in range(4))
    res = {}
    before = runtime.LAUNCHES["attn_fwd_tiled"]
    for flash in (True, False):
        qs, ks, vs = (a.clone().requires_grad_() for a in (q, k, v))
        o = ulysses_self_attention(qs, ks, vs, mesh, causal=True, use_flash=flash)
        (o * g).sum().backward()
        res[flash] = (o.detach(), qs.grad, ks.grad, vs.grad)
    out["ulysses_flash"] = {
        "out_max_abs": float((res[True][0] - res[False][0]).abs().max()),
        "grad_max_abs": max(float((a - b).abs().max()) for a, b in zip(res[True][1:], res[False][1:])),
        "tiled_fwd_launches": runtime.LAUNCHES["attn_fwd_tiled"] - before,
        "shape_a_rank": list(shape), "heads_a_rank_after_all_to_all": sp_cls.NHEAD // world,
    }
    return out


def check_sp_ranks(mode: str, reports, series, wall):
    """[8]'s checks of one arm (``--seq_parallel <mode>``): gloo over 2 ranks
    staged through pinned memory, the ranks' parameters bit for bit equal,
    finite and falling losses, the recorder's sequence-parallel series, K2
    launched on each rank (the loss; the attention is plain, as the JAX
    model's). Logs the walls, tokens/s, the collectives a step and the
    peaks."""
    for r in reports:
        assert r["ranks"]["backend"] == "gloo" and r["ranks"]["size"] == DIST_RANKS, r["ranks"]
        assert r["ranks"]["staged_through_host"], r["ranks"]
        for k in ("xent_fwd", "xent_bwd"):
            assert r["launches"][k] > 0, (mode, r["rank"], k, r["launches"])
    digests = {r["param_sha256"] for r in reports}
    assert len(digests) == 1, f"[8] ({mode}): the ranks' parameters differ: {digests}"
    losses = series["train_loss"]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], losses
    assert series["partition"] == [[0.5, 0.5]] * len(losses), series["partition"]
    assert series["accuracy"] == [1.0 - v for v in series["val_loss"]]
    assert series["_meta"]["paths"] == [f"seq_parallel_{mode}"] * len(losses)
    walls = epoch_walls(series)
    log(f"  ({mode}) arm wall {wall:.1f}s (its job in the ranks' one launch); epoch walls "
        f"{[round(w, 3) for w in walls]} s; tokens/s {[round(x) for x in series['tokens_per_s']]}; "
        f"train loss {[round(x, 4) for x in losses]}; val loss "
        f"{[round(x, 4) for x in series['val_loss']]}")
    for r in reports:
        coll = [(c["epoch"], c["steps"], round(1e3 * c["mean_s"], 2), round(1e3 * c["max_s"], 2))
                for c in r["collective"] or []]
        log(f"  ({mode}) rank {r['rank']}: collectives' host wall a step (epoch, steps, mean ms, "
            f"max ms) {coll}; launches {launch_text(r['launches'], LM_KERNELS + ATTN_TILED)}; "
            f"peak device memory {r['peak_bytes'] / 2**30:.2f} GiB")
    return {"wall": wall, "epoch_walls": walls, "series": series, "reports": reports}


def check_sp_values(results):
    """[8]'s in-rank checks (``sp_checks``) against their tolerances."""
    for rank, r in enumerate(x["result"] for x in results):
        for mode in SP_MODES:
            m = r[mode]
            assert m["loss_rel"] <= SP_LOSS_RTOL, (rank, mode, m)
            assert m["grad_max_abs"] <= SP_GRAD_ATOL, (rank, mode, m)
            log(f"  rank {rank} {mode}: first step's loss {m['loss']:.6f} against the one-device "
                f"LM's {r['one_device_loss']:.6f} (relative {m['loss_rel']:.2e}, limit "
                f"{SP_LOSS_RTOL}), gradients' largest difference {m['grad_max_abs']:.2e} (limit "
                f"{SP_GRAD_ATOL})")
        u = r["ulysses_flash"]
        assert u["out_max_abs"] <= SP_ATTN_TOL[0] and u["grad_max_abs"] <= SP_ATTN_TOL[1], (rank, u)
        assert u["tiled_fwd_launches"] > 0, (rank, u)
        log(f"  rank {rank} ulysses use_flash=True against False at {u['shape_a_rank']} a rank "
            f"({u['heads_a_rank_after_all_to_all']} head a rank after the all-to-all, K3's tiled "
            f"route, {u['tiled_fwd_launches']} forward launches): output {u['out_max_abs']:.2e}, "
            f"gradients {u['grad_max_abs']:.2e} (limits {SP_ATTN_TOL})")
    return [x["result"] for x in results]


def _mh_spawn(env, proc: int, n: int, port: int, log_path: str):
    import subprocess

    with open(log_path, "w") as f:
        return subprocess.Popen([sys.executable, MH_WORKER, str(proc), str(n), str(port)],
                                stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT)


def _mh_result(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
    assert lines, f"[7d]: no RESULT line in {path}:\n{text[-4000:]}"
    return json.loads(lines[-1][len("RESULT "):])


def check_elastic_ranks():
    """[7d] (the module docstring): shrink, parity, regrow. Returns the
    survivor's and the joiner's results, the parity leg's and the walls."""
    import signal

    from scripts.rank_launch import RanksFailed, free_port, launch_ranks

    run, logs = os.path.join(SCRATCH, "mh"), os.path.join(OUT, "mh")
    for d in (run, logs):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    hb = os.path.join(run, "hb")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
               DBS_PEER_HB_DIR=hb, DBS_MH_CKPT=os.path.join(run, "ck"), **MH_ENV)
    port = free_port()
    t0 = time.perf_counter()
    deadline = t0 + MH_TIMEOUT_S

    def wait_for(path, procs):
        while not os.path.exists(path):
            assert time.perf_counter() < deadline, f"[7d]: {path} never appeared"
            assert any(p.poll() is None for p in procs), f"[7d]: the processes ended before {path}"
            time.sleep(0.05)

    def wait(p):
        while p.poll() is None:
            assert time.perf_counter() < deadline, "[7d]: a process outlived the phase's limit"
            time.sleep(0.1)
        return p.returncode

    procs = [_mh_spawn(env, i, 2, port, os.path.join(logs, f"p{i}.log")) for i in range(2)]
    try:
        wait_for(os.path.join(hb, "epoch1_step2_p1.marker"), procs)
        procs[1].send_signal(signal.SIGKILL)
        t_kill, t_kill_unix = time.perf_counter(), time.time()
        wait_for(os.path.join(hb, "epoch2_p0.marker"), procs[:1])
        t_resumed = time.perf_counter()
        # the parity leg's source, copied while the run still keeps it (a
        # checkpoint directory keeps the last 3 epochs)
        ck, ckp = os.path.join(run, "ck"), os.path.join(run, "ck_parity")
        shutil.copytree(os.path.join(ck, "0"), os.path.join(ckp, "0"))
        shutil.copy(os.path.join(ck, "controller_0.json"), ckp)
        procs.append(_mh_spawn(dict(env, DBS_MH_RESPAWNED="1", DBS_MH_IDENT="1"), 1, 2, port,
                               os.path.join(logs, "p1_respawn.log")))
        rc0, rcj = wait(procs[0]), wait(procs[2])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    for name, rc in (("p0", rc0), ("p1_respawn", rcj)):
        if rc != 0:
            with open(os.path.join(logs, f"{name}.log")) as f:
                log(f.read()[-6000:])
            raise AssertionError(f"[7d]: {name} exited {rc}")
    assert procs[1].returncode == -signal.SIGKILL, procs[1].returncode
    r0, rj = _mh_result(os.path.join(logs, "p0.log")), _mh_result(os.path.join(logs, "p1_respawn.log"))
    shrink, grow = r0["elastic_events"]
    assert shrink["lost"] == [2, 3] and shrink["rdzv_gen"] == 1 and shrink["roster"] == [0], shrink
    assert shrink["world_size"] == 2 and shrink["restored_from"] == "checkpoint[0]", shrink
    assert grow["readmitted"] == [2, 3] and grow["rdzv_gen"] == 2 and grow["epoch"] == 3, grow
    for r in (r0, rj):
        assert r["world_size"] == 4 and r["n_proc"] == 2 and r["roster"] == [0, 1], r
        assert all(math.isfinite(x) for x in r["losses"]), r["losses"]
        for k in CNN_KERNELS:  # the recovered and regrown epochs ran the kernels
            assert r["launches"][k] > 0, (k, r["launches"])
    assert rj["params_hash"] == r0["params_hash"], "[7d]: the regrown ranks' parameters differ"
    assert rj["losses"] == r0["losses"][-len(rj["losses"]):]
    # the parity leg: a fresh one-process 2-worker run from a copy of
    # checkpoint 0 with the survivor-restricted sidecar, over epoch 1 (its
    # plan comes from the sidecar alone; later plans read the card's probes)
    with open(os.path.join(ckp, "controller_0.json")) as f:
        side = json.load(f)
    sh = [side["shares"][r] for r in (0, 1)]
    penv = dict(env, DBS_MH_PARITY="1", DBS_MH_CKPT=ckp, DBS_MH_PARITY_UNTIL="2",
                DBS_MH_PARITY_VECS=json.dumps({"shares": [x / sum(sh) for x in sh],
                                               "node_times": [side["node_times"][r] for r in (0, 1)]}))
    t1 = time.perf_counter()
    try:
        launch_ranks([[sys.executable, MH_WORKER, "0", "1", "0"]], os.path.join(logs, "parity"),
                     max(deadline - t1, 60.0), [penv], cwd=ROOT)
    except RanksFailed as e:
        log(str(e))
        raise AssertionError("[7d]: the parity leg failed") from None
    parity_s = time.perf_counter() - t1
    pr = _mh_result(os.path.join(logs, "parity", "rank0.out"))
    assert pr["start_epoch"] == 1 and pr["hashes"]["1"] == r0["hashes"]["1"], (pr, r0["hashes"])
    assert pr["losses"] == [r0["losses"][1]], (pr["losses"], r0["losses"])
    log(f"  survivor: losses {[round(x, 4) for x in r0['losses']]}, partitions "
        f"{[[round(x, 4) for x in p] for p in r0['partitions']]}; launches "
        f"{launch_text(r0['launches'], CNN_KERNELS)}; joiner launches "
        f"{launch_text(rj['launches'], CNN_KERNELS)}")
    kill_to_resume = shrink["resumed_unix"] - t_kill_unix
    assert 0.0 < kill_to_resume < MH_TIMEOUT_S, kill_to_resume
    log(f"  shrink: the kill to resumed training {kill_to_resume:.3f}s; attribution to resumed "
        f"training {shrink['detect_to_resume_s']:.3f}s (phases {shrink['phase_s']} s); the "
        f"kill to the survivor's epoch-2 start {t_resumed - t_kill:.1f}s (epoch 1 re-run over "
        f"2 workers included)")
    log(f"  grow: {grow['detect_to_resume_s']:.3f}s from the join offer's boundary to resumed "
        f"training (phases {grow['phase_s']} s); the joiner's own join {rj['joined_s']:.1f}s")
    log(f"  parity against a fresh 2-worker run from checkpoint 0: epoch 1's parameters "
        f"{pr['hashes']['1'][:16]} = the survivor's, loss {pr['losses'][0]:.6f} "
        f"({parity_s:.1f}s); the regrown ranks' parameters {r0['params_hash'][:16]} on both")
    log(f"  [7d] wall {wall:.1f}s (the three processes), parity leg {parity_s:.1f}s")
    return {"survivor": r0, "joiner": rj, "parity": pr, "wall": wall, "parity_s": parity_s}


def ms_linear_time(plan):
    """[9] tenant A's timing model: a worker's seconds proportional to its
    padded batch times its steps (the virtual straggler multiplies it)."""
    import numpy as np

    return np.array([w.padded_batch * w.steps * 1e-3 for w in plan.workers])


def ms_config(argv, tag):
    from dynamic_load_balance_distributeddnn_tpu_torch.config import config_from_args

    run_dir = os.path.join(OUT, "multistream", tag)
    shutil.rmtree(run_dir, ignore_errors=True)
    return config_from_args(argv + ["--log_dir", os.path.join(run_dir, "logs"),
                                    "--stat_dir", os.path.join(run_dir, "statis"),
                                    "--trace_dir", os.path.join(run_dir, "trace")])


def param_sha(torch, tr) -> str:
    import hashlib

    h = hashlib.sha256()
    for p in tr.params:
        h.update(p.detach().to("cpu").contiguous().numpy().tobytes())
    return h.hexdigest()


def tenant_series(tr):
    return dict(tr.recorder.data, _meta=tr.recorder.meta)


def ms_tenants(torch, paths):
    """[9](a): tenants A and B each alone through ``Trainer.run()`` (the
    sequential arm), then both through one ``MultiStreamEngine(n_devices=4,
    device="cuda")``, each on its own thread and stream (the multiplexed
    arm), cuDNN deterministic. Checks: both done with no migration; each
    tenant's losses, partitions and parameters (SHA-256) equal its run alone
    bit for bit; B captures no step graph from window 2 on; A moves share
    off worker 0; K1 (tiled route only) and K2 launched on each tenant's
    streams; A captures new keys in window 1 while B replays its one key,
    and none of those captures overlaps B's epoch (the capture gate,
    ``train/supersteps.py``). Logs both arms' walls and their
    ratio, each tenant's makespan, ``stats()`` and the peak memory."""
    from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import configure, get_tracer
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
    from dynamic_load_balance_distributeddnn_tpu_torch.runtime.scheduler import (
        JobSpec,
        MultiStreamEngine,
    )
    from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer

    argv = {"a": MS_A_ARGV, "b": MS_B_ARGV}
    timing = {"a": ms_linear_time, "b": None}
    alone = {}
    t_seq = 0.0
    for name in ("a", "b"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        runtime.reset_launches()
        t0 = time.perf_counter()
        tr = Trainer(ms_config(argv[name], "alone_" + name), timing_model=timing[name],
                     log_to_file=False)
        tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t_seq += wall
        counts = dict(runtime.LAUNCHES)
        alone[name] = {"loss": tr.recorder.data["train_loss"],
                       "partition": tr.recorder.data["partition"], "sha": param_sha(torch, tr)}
        paths[f"multistream_alone_{name}"] = (counts, tenant_series(tr), wall,
                                              torch.cuda.max_memory_allocated())
        log(f"  ({name}) alone: {' '.join(argv[name])}: wall {wall:.1f}s, train loss "
            f"{[round(x, 6) for x in alone[name]['loss']]}, partition {alone[name]['partition']}")
        del tr
        gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    configure("on")
    try:
        t0 = time.perf_counter()
        eng = MultiStreamEngine(n_devices=MS_SLOTS, device="cuda")
        states = {name: eng.submit(JobSpec(name, ms_config(argv[name], "ms_" + name),
                                           timing_model=timing[name], max_devices=2,
                                           slots=MS_TENANT_SLOTS[name]))
                  for name in ("a", "b")}
        eng.run()
        torch.cuda.synchronize()
        t_ms = time.perf_counter() - t0
        events = get_tracer().events()
    finally:
        configure("off")
    peak = torch.cuda.max_memory_allocated()
    total = dict(runtime.LAUNCHES)
    # a tenant's launches: its stream's (steps, replays, probes, validation,
    # the backward's from autograd's thread) and its capture stream's (warm-ups)
    per_tenant = {name: {k: sum(runtime.LAUNCHES.of(("stream", s.cuda_stream))[k]
                                for s in (js.stream, js.trainer.supersteps.side_stream()))
                         for k in runtime.KERNELS}
                  for name, js in states.items()}
    series = {name: tenant_series(js.trainer) for name, js in states.items()}
    for name, js in states.items():
        data, meta = js.recorder.data, js.recorder.meta
        walls = [[round(w, 3) for w in epoch_walls(x)]
                 for x in (paths[f"multistream_alone_{name}"][1], series[name])]
        log(f"  ({name}) epoch walls alone {walls[0]} s, multiplexed {walls[1]} s (probes and "
            "validation excluded)")
        assert js.status == "done" and js.migrations == 0, (name, js.status, js.migrations)
        assert data["train_loss"] == alone[name]["loss"], (name, data["train_loss"], alone[name])
        assert data["partition"] == alone[name]["partition"], (name, data["partition"])
        sha = param_sha(torch, js.trainer)
        assert sha == alone[name]["sha"], f"tenant {name}: parameters differ from its run alone"
        counts = per_tenant[name]
        for k in CNN_KERNELS:
            assert counts[k] > 0, f"tenant {name}: kernel {k} never launched"
        for k in GN_GENERAL:
            assert counts[k] == 0, f"tenant {name}: {k} launched {counts[k]} times"
        assert all(math.isfinite(x) for x in data["train_loss"] + data["val_loss"]), data
        log(f"  ({name}) multiplexed: train loss, partitions and parameters (SHA-256 "
            f"{sha[:16]}) equal its run alone; its streams' launches "
            f"{ {k: counts[k] for k in CNN_KERNELS} }; captures an epoch "
            f"{[r['captures'] for r in meta['supersteps']]}, replays "
            f"{[r['replays'] for r in meta['supersteps']]}")
    assert all(r["captures"] == 0 for r in states["b"].recorder.meta["supersteps"][2:]), \
        states["b"].recorder.meta["supersteps"]
    part_a = states["a"].recorder.data["partition"]
    assert part_a[-1][0] < 0.5, part_a
    assert total == {k: sum(c[k] for c in per_tenant.values()) for k in total}, (total, per_tenant)

    def spans(name, job, epoch):
        return [(ts, ts + dur) for n, _, ph, ts, dur, _, args in events
                if n == name and ph == "X" and (args or {}).get("job") == job
                and (args or {}).get("epoch") == epoch]

    # in window 1 A captures the keys of its new widths while B replays its
    # one key: each capture holds the gate alone (train/supersteps.py
    # CAPTURE_GATE), so none overlaps B's epoch, which captures nothing
    rec_a, rec_b = (states[n].recorder.meta["supersteps"][1] for n in ("a", "b"))
    assert rec_a["captures"] > 0 and rec_b["captures"] == 0 and rec_b["replays"] > 0, (rec_a, rec_b)
    (b0, b1), = spans("epoch", "b", 1)
    clash = [c for c in spans("capture", "a", 1) if b0 < c[1] and c[0] < b1]
    assert not clash, f"a capture of tenant a overlapped tenant b's epoch 1 {(b0, b1)}: {clash}"
    waits = {n: [round(r["capture_wait_s"], 3) for r in js.recorder.meta["supersteps"]]
             for n, js in states.items()}
    st = eng.stats()
    log(f"  sequential arm {t_seq:.1f}s, multiplexed arm {t_ms:.1f}s: ratio multiplexed / "
        f"sequential {t_ms / t_seq:.3f} (a finding, not a claim); makespans "
        f"{ {n: round(js.makespan_s, 2) for n, js in states.items()} } s")
    log(f"  A captured {rec_a['captures']} keys in window 1 while B replayed, none inside B's epoch; "
        f"seconds the captures waited for the gate, by epoch {waits}; "
        f"peak device memory {peak / 2**30:.2f} GiB (both tenants)")
    log(f"  stats(): {st['windows']} windows, {st['window_wall_s']:.2f}s of windows; "
        f"device_idle_fraction {st['device_idle_fraction']} (the idle share of the pool's "
        f"{MS_SLOTS} SLOTS, which share one card: not the card's busy share); jobs {st['jobs']}")
    log(f"  {card()}")
    paths["multistream"] = (total, series, t_ms, peak)
    out = {"sequential_s": t_seq, "multiplexed_s": t_ms, "ratio": t_ms / t_seq, "stats": st,
           "peak_bytes": peak, "capture_wait_s": waits,
           "per_tenant_launches": per_tenant}
    del eng, states
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ms_migration(torch, paths):
    """[9](b): tests/test_scheduler.py's heavy/light scenario on the card:
    MnistNet ``-ws 8 -b 64 -dbs false``, two tenants over an 8-slot pool,
    epoch walls modeled as demand / slots (24 : 8), 3 epochs each. Checks:
    both done; each migrated at least once; the last window splits 6:2;
    every re-shard of live CUDA state is followed by a fresh capture in the
    tenant's next epoch, and finite losses. Logs each re-shard's seconds
    (its ``pool_reshard`` span)."""
    from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import configure, get_tracer
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
    from dynamic_load_balance_distributeddnn_tpu_torch.runtime.scheduler import (
        JobSpec,
        MultiStreamEngine,
    )

    reshards = []

    class Engine(MultiStreamEngine):
        def _apply_allotment(self, js, ordinals):
            before = list(js.trainer.active_ranks)
            super()._apply_allotment(js, ordinals)
            if list(js.trainer.active_ranks) != before:
                reshards.append((self._window, js.spec.job_id, len(before),
                                 len(js.trainer.active_ranks)))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    configure("on")
    try:
        t0 = time.perf_counter()
        eng = Engine(n_devices=8, device="cuda",
                     wall_model=lambda js: MS_DEMAND[js.spec.job_id] / max(len(js.devices), 1))
        states = {name: eng.submit(JobSpec(
            name, ms_config(MS_MIGRATE_ARGV + ["--seed", str(seed)], "migrate_" + name),
            epochs=3)) for name, seed in MS_MIGRATE_SEEDS.items()}
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events = get_tracer().events()
    finally:
        configure("off")
    assert {js.status for js in states.values()} == {"done"}, {n: js.status for n, js in states.items()}
    assert all(js.migrations >= 1 for js in states.values()), {n: js.migrations for n, js in states.items()}
    final = eng.windows[-1]["jobs"]
    assert (final["heavy"]["devices"], final["light"]["devices"]) == (6, 2), final
    for window, name, n0, n1 in reshards:
        meta, data = states[name].recorder.meta, states[name].recorder.data
        rec = meta["supersteps"][window]
        assert rec["epoch"] == window and rec["captures"] > 0, (name, window, rec)
        assert math.isfinite(data["train_loss"][window]), (name, data["train_loss"])
    secs = [round(dur / 1e6, 4) for n, _, ph, _, dur, _, _ in events if n == "pool_reshard" and ph == "X"]
    log(f"  re-shards (window, job, ranks before -> after): {reshards}")
    log(f"  pool_reshard seconds {secs}; windows' slot counts "
        f"{[{j: v['devices'] for j, v in w['jobs'].items()} for w in eng.windows]}; "
        f"migrations {({n: js.migrations for n, js in states.items()})}; wall {wall:.1f}s")
    paths["multistream_migration"] = (dict(runtime.LAUNCHES),
                                      {n: tenant_series(js.trainer) for n, js in states.items()},
                                      wall, torch.cuda.max_memory_allocated())
    out = {"reshards": reshards, "reshard_s": secs, "wall": wall, "journal": eng.decision_journal()}
    del eng, states
    gc.collect()
    return out


PHASES = ("3", "3b", "4", "4b", "4c", "4d", "4e", "4m", "4f", "5", "5b", "5c", "4h", "4k", "4l", "4i", "4g",
          "4j",
          "9", "6", "6b", "7", "7b", "7c", "8", "7d")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run the PyTorch port on one NVIDIA card and check it.")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="the phases to run after [1] and [2], a comma list of "
                         f"{', '.join(PHASES)} (default: all; a subset ends without the JSON lines)")
    args = ap.parse_args(argv)
    chosen = args.phases.split(",")
    unknown = set(chosen) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    every = set(chosen) == set(PHASES)

    def want(name):
        return name in chosen

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an NVIDIA card",
              file=sys.stderr)
        return 1
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime

    t_start = time.perf_counter()
    marks = []  # (phase header, script clock at it)
    rank_phase_s = {}  # a rank phase's seconds: its jobs' walls in the ranks

    def phase(title):  # each phase's header, with the script's clock
        marks.append((title.split(" ")[0], time.perf_counter() - t_start))
        log(f"{title} (at {marks[-1][1]:.1f}s)")

    def phase_seconds():
        """Each phase's seconds, header to next header (the last to now),
        its sub-phases' headers (the same tag) summed, logged."""
        ends = [t for _, t in marks[1:]] + [time.perf_counter() - t_start]
        out = {}
        for (name, t), end in zip(marks, ends):
            out[name] = out.get(name, 0.0) + end - t
        out = {name: round(secs, 1) for name, secs in out.items()}
        log(f"  seconds a phase: {out}; the rank phases' jobs: "
            f"{ {k: round(v, 1) for k, v in rank_phase_s.items()} }")
        return out

    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda", 0)

    phase("[1] card")
    smi = card()
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"  torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    log(f"  torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")

    phase("[2] build")
    t0 = time.perf_counter()
    runtime.build()
    log(f"  built {list(runtime.SOURCES)} in {time.perf_counter() - t0:.1f}s into {runtime.BUILD_DIR}")
    for name, text in runtime.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    err = {}
    records = []
    if want("3"):
        phase("[3] kernels against their plain versions")
        err.update(check_groupnorm(torch, dev, records))
        phase("[3] K2 and K3 against their plain versions")
        err.update(check_xent(torch, dev, records))
        err.update(check_flash(torch, dev, records))
        phase("[3] timing")
        timing, gt, gp, gp16, xt, at, shapes, gn_routes = time_kernels(torch, dev)

    if want("3b"):
        phase("[3b] synthetic load (compute-mode stragglers)")
        err["synthetic_load"], load = check_synthetic_load(torch, dev)
        timing["synthetic_load"] = load["timing"]

    ranks = {}
    # [7], [7c] and [8]: every arm by two ranks started once; [7b]: by four
    jobs2 = {}
    if want("7"):
        jobs2.update(arm_jobs("dist", DIST_ARGV, DIST_ARMS))
    if want("7c"):
        jobs2.update({f"lm_{arm}": {"argv": LM_DIST_ARGV + extra} for arm, _, extra in LM_DIST_ARMS})
    if want("8"):
        jobs2.update({f"sp_{m}": {"argv": SP_ARGV + ["--seq_parallel", m]} for m in SP_MODES})
        jobs2["sp_checks"] = {"call": "chip_smoke:sp_checks"}
    if jobs2:
        # here, before the paths: the ranks are other processes on this card,
        # and this one holds the least device memory now
        phase(f"[7]/[7c]/[8]: {DIST_RANKS} ranks on cuda:0 over gloo, started once for every arm")
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
        log(f"  this process: {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved; card "
            f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free")
        got, run_dir = run_rank_phases("ranks2", jobs2, DIST_RANKS, RANKS2_TIMEOUT_S)
        if want("7"):
            phase("[7] data parallelism: DenseNet-121, B=512, 2 ranks")
            for arm, what, extra in DIST_ARMS:
                log(f"  ({arm}) {what}")
                ranks[arm] = check_ranks(arm, *cli_arm(got, run_dir, f"dist_{arm}",
                                                       arm_argv("dist", arm, DIST_ARGV + extra),
                                                       DIST_RANKS))
                if RESUMED_ARMS["dist"] == arm:
                    ranks[arm + "_resumed"] = check_rank_resume("[7]", "dist", arm, extra,
                                                                DIST_ARGV, got, run_dir, DIST_RANKS)
            rank_phase_s["7"] = (sum(ranks[a]["wall"] for a, _, _ in DIST_ARMS)
                                 + ranks[RESUMED_ARMS["dist"] + "_resumed"]["wall"])
        if want("7c"):
            phase("[7c] the language model across ranks: 2 ranks, BASELINE.md config 5, B=80")
            for arm, what, extra in LM_DIST_ARMS:
                log(f"  ({arm}) {what}")
                ranks["lm_" + arm] = check_ranks(arm, *cli_arm(got, run_dir, f"lm_{arm}",
                                                               LM_DIST_ARGV + extra, DIST_RANKS),
                                                 tag="[7c]", kernels=LM_KERNELS)
            rank_phase_s["7c"] = sum(ranks["lm_" + a]["wall"] for a, _, _ in LM_DIST_ARMS)
        if want("8"):
            phase(f"[8] sequence parallelism: 2 ranks, the LM at [B={SP_B}, T={SP_T}]")
            for m in SP_MODES:
                log(f"  ({m}) --seq_parallel {m}")
                ranks["sp_" + m] = check_sp_ranks(m, *cli_arm(got, run_dir, f"sp_{m}",
                                                              SP_ARGV + ["--seq_parallel", m],
                                                              DIST_RANKS))
            ranks["sp_checks"] = check_sp_values(got["sp_checks"])
            rank_phase_s["8"] = (sum(ranks["sp_" + m]["wall"] for m in SP_MODES)
                                 + job_wall(got["sp_checks"]))

    if want("7b"):
        phase(f"[7b] --grad_comm hier: {HIER_RANKS} ranks on cuda:0 over gloo, started once: "
              "DenseNet-121 (B=512) in three arms, the language model in a fourth")
        gc.collect()
        torch.cuda.empty_cache()
        jobs4 = arm_jobs("hier", HIER_ARGV, HIER_ARMS)
        jobs4["hier_lm"] = {"argv": HIER_LM_ARGV}
        got, run_dir = run_rank_phases("ranks4", jobs4, HIER_RANKS, RANKS4_TIMEOUT_S)
        for arm, what, extra in HIER_ARMS:
            log(f"  ({arm}) {what}")
            ranks["hier_" + arm] = check_hier_ranks(
                arm, *cli_arm(got, run_dir, f"hier_{arm}", arm_argv("hier", arm, HIER_ARGV + extra),
                              HIER_RANKS))
            if RESUMED_ARMS["hier"] == arm:
                ranks[f"hier_{arm}_resumed"] = check_rank_resume(
                    "[7b]", "hier", arm, extra, HIER_ARGV, got, run_dir, HIER_RANKS)
        log("  (lm) the language model, DBS on, the default wires (int8 outer hop)")
        ranks["hier_lm"] = check_hier_ranks(
            "lm", *cli_arm(got, run_dir, "hier_lm", HIER_LM_ARGV, HIER_RANKS), kernels=LM_KERNELS)
        rank_phase_s["7b"] = sum(job_wall(r) for r in got.values())
    if want("7d"):
        phase("[7d] --elastic on across processes: 2 processes on cuda:0 over gloo, process 1 "
              "SIGKILLed at epoch 1, respawned and readmitted at epoch 3")
        gc.collect()
        torch.cuda.empty_cache()
        ranks["elastic_mh"] = check_elastic_ranks()
    for name, secs in rank_phase_s.items():
        log(f"  [{name}]: {secs:.1f}s of jobs in the ranks (their start-up shared)")

    paths = {}  # tag: (launch counts, series, wall, peak bytes)
    if want("4"):
        phase("[4] vision path: the defaults (packed epochs, adaptive probes), traced")
        paths["vision"] = run_path(torch, MAIN_ARGV + traced("vision", "on"), "run")
        check_main_path(*paths["vision"][:2])

    if want("4b"):
        phase("[4b] vision path, elastic, compute-mode straggler")
        paths["vision_compute"] = run_path(torch, COMPUTE_ARGV, "run_compute")
        check_compute_path(*paths["vision_compute"][:2])

    if want("4c"):
        phase(f"[4c] vision path, the reference's random faults (-ft), compute mode, seed {FT_SEED}")
        paths["vision_ft"] = run_path(torch, FT_ARGV, "run_ft")
        check_ft_path(*paths["vision_ft"][:2])

    if want("4d"):
        for name in FAMILIES:
            phase(f"[4d] -m {name}")
            paths[name] = run_path(torch, ["-m", name] + FAMILY_ARGV, f"run_{name}")
            check_cnn_path(*paths[name][:2], name, epochs=FAMILY_EPOCHS, moved_off=None)

    window_walls = None
    if want("4e"):
        phase("[4e] vision path, window-cadence rebalancing (compute-mode sin straggler)")
        err.setdefault("groupnorm_fwd", 0.0)
        err.setdefault("groupnorm_bwd", 0.0)
        paths["vision_window"] = run_path(torch, WINDOW_ARGV + WARM_ARGV + traced("window", "ring"),
                                          "run_window")
        paths["vision_window_epoch"] = run_path(torch, EPOCH_CADENCE_ARGV + WARM_ARGV,
                                                "run_window_epoch")
        check_cnn_path(*paths["vision_window_epoch"][:2], "epoch-cadence", path="elastic",
                       epochs=WINDOW_EPOCHS, moved_off=None, repeats=False)
        window_walls = check_window_path(torch, dev, *paths["vision_window"][:2],
                                         paths["vision_window_epoch"][1], err, records)
        phase("[4e] the same window recipe under --superstep off (eager steps)")
        paths["vision_window_off"] = run_path(torch, WINDOW_OFF_ARGV, "run_window_off")
        check_window_off(*paths["vision_window_off"][:2])

    if want("4m"):
        phase("[4m] the warm service: --aot_warm off against on (--warm_start true)")
        check_warm_service(torch, paths)

    if want("4f"):
        phase("[4f] vision path under --precision bfloat16: packed (the defaults), then elastic")
        paths["vision_bf16"] = run_path(torch, with_epochs(BF16_ARGV, BF16_PACKED_EPOCHS), "run_bf16")
        check_bf16_vision_path(*paths["vision_bf16"][:2], "packed", BF16_PACKED_EPOCHS)
        if "vision" in paths:
            for e, (w16, w32) in enumerate(zip(epoch_walls(paths["vision_bf16"][1]),
                                               epoch_walls(paths["vision"][1]))):
                log(f"  epoch {e} wall: bf16 {w16:.3f}s, f32 ([4]) {w32:.3f}s (for information)")
        paths["vision_bf16_elastic"] = run_path(torch, BF16_ELASTIC_ARGV, "run_bf16_elastic")
        check_bf16_vision_path(*paths["vision_bf16_elastic"][:2], "elastic", BF16_ELASTIC_EPOCHS)

    if want("5"):
        phase("[5] language-model path")
        paths["lm"] = run_path(torch, LM_ARGV, "run_lm")
        check_lm_path(*paths["lm"][:2])
        torch.cuda.empty_cache()

    if want("5b"):
        phase("[5b] language-model path under --precision bfloat16")
        paths["lm_bf16"] = run_path(torch, LM_BF16_ARGV, "run_lm_bf16")
        check_bf16_lm_path(*paths["lm_bf16"][:2])
        if "lm" in paths:
            for e, (w16, w32) in enumerate(zip(epoch_walls(paths["lm_bf16"][1]),
                                               epoch_walls(paths["lm"][1]))):
                log(f"  epoch {e} wall: bf16 {w16:.3f}s, f32 ([5]) {w32:.3f}s (for information)")
        torch.cuda.empty_cache()

    if want("5c"):
        phase("[5c] language-model path at --bptt 256 (K3's tiled route)")
        paths["lm_long"], attn_shapes = run_lm_long(torch)
        check_lm_long_path(*paths["lm_long"][:2], attn_shapes)
        torch.cuda.empty_cache()
    resume = {}
    if want("4h"):
        phase("[4h] stop and resume (--ckpt_dir), bit for bit against the whole run")
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            for name, argv in RESUME_RECIPES:
                for mode in ("auto", "off"):
                    resume[f"{name} [{mode}]"] = check_resume(torch, name, argv, mode, paths)
        finally:
            torch.backends.cudnn.deterministic = False

    elastic = {}
    if want("4k"):
        phase("[4k] --elastic on: worker 3 of 4 lost mid-epoch 1, re-solve, readmitted at epoch 3")
        elastic = check_elastic(torch, paths)

    host_fed = {}
    if want("4l"):
        phase("[4l] the host-fed path (--device_cache off): packed and elastic, each against "
              "its resident twin")
        host_fed = check_host_fed(torch, paths)

    tracing = {}
    if want("4i"):
        phase("[4i] tracing: graftscope attribution, the spools, the profiler, MFU")
        if "vision" not in paths:  # a phase subset: [4]'s recipe, traced, here
            paths["vision"] = run_path(torch, MAIN_ARGV + traced("vision", "on"), "run")
        tracing["vision"] = check_trace("vision", "[4]", "on")
        if "vision_window" in paths:
            check_window_spool(paths["vision_window"][1])
        else:
            log("  [4e] did not run in this subset: its spool's replay is not checked")
        tracing["profile"] = check_profile(torch, paths)
        check_mfu(paths)
    for tag, (_, _, wall, peak) in paths.items():
        log(f"  path {tag}: cli wall {wall:.1f}s, peak device memory {peak / 2**30:.2f} GiB")

    supersteps = {}
    if want("4g"):
        phase("[4g] --superstep as captured CUDA graphs: (i) each kernel replayed alone")
        for k in ("groupnorm_fwd", "groupnorm_bwd", "xent_fwd", "xent_bwd", "attn_fwd", "attn_bwd",
                  "synthetic_load") + GN_BF16 + ATTN_TILED:
            err.setdefault(k, 0.0)
        check_kernels_in_graphs(torch, dev, err)
        phase("[4g] (ii) one graphed step against one eager step, from the same state")
        supersteps["step_graphs"] = check_step_graphs(torch, dev)
        phase("[4g] (iii) --superstep auto against off")
        supersteps["arms"] = run_superstep_arms(torch, dev)

    remat = {}
    if want("4j"):
        phase("[4j] --remat: remat on and off, eager and graphed, bit for bit")
        remat = check_remat(torch, dev)

    multistream = {}
    if want("9"):
        phase("[9] the many-stream engine: (a) two DenseNet-121 tenants, alone then multiplexed")
        torch.backends.cudnn.deterministic = True
        try:
            multistream["tenants"] = ms_tenants(torch, paths)
            phase("[9] (b) the outer solve's migration, heavy/light (24 : 8) over 8 slots")
            multistream["migration"] = ms_migration(torch, paths)
        finally:
            torch.backends.cudnn.deterministic = False

    card_vs_cpu, bf16_vs_cpu = None, None
    if want("6"):
        phase("[6] end-to-end numerics")
        card_vs_cpu = {name: check_against_cpu(torch, dev, name)
                       for name in ("densenet", "resnet18", "regnet")}
        check_lm_against_cpu(torch, dev)

    if want("6b"):
        phase("[6b] bf16 on the card against the CPU's f64 run (the CPU's bf16 run the yardstick)")
        bf16_vs_cpu = [check_bf16_against_cpu(torch, dev, which) for which in ("densenet", "lm")]

    seconds = phase_seconds()
    if not every:
        with open(os.path.join(OUT, "phases.json"), "w") as f:
            json.dump({"card": smi, "phases": chosen, "errors": err, "supersteps": supersteps,
                       "phase_seconds": seconds, "rank_phase_seconds": rank_phase_s,
                       "ranks": ranks, "remat": remat, "elastic": elastic,
                       "resume": resume, "tracing": tracing, "multistream": multistream,
                       "host_fed": host_fed,
                       "launches": {tag: p[0] for tag, p in paths.items()},
                       "series": {tag: p[1] for tag, p in paths.items()},
                       "seconds": time.perf_counter() - t_start}, f, indent=1)
        log(f"  phases {chosen} passed in {time.perf_counter() - t_start:.1f}s "
            "(a subset: no kernels line, no result line)")
        return 0

    sources = {
        # the tiled route (every DenseNet-121 call), then the general one
        "groupnorm_fwd": ("csrc/groupnorm.cu", "ops/pallas/groupnorm.py:32", "DenseNet-121 b=128, 120 calls"),
        "groupnorm_bwd": ("csrc/groupnorm.cu", "ops/pallas/groupnorm.py:110", "DenseNet-121 b=128, 120 calls"),
        "groupnorm_fwd_general": ("csrc/groupnorm.cu", "ops/pallas/groupnorm.py:32", "DenseNet-121 b=128, 120 calls"),
        "groupnorm_bwd_general": ("csrc/groupnorm.cu", "ops/pallas/groupnorm.py:110", "DenseNet-121 b=128, 120 calls"),
        # the tiled route on bf16 activations (--precision bfloat16), a packed pass
        "groupnorm_fwd_bf16": ("csrc/groupnorm.cu", "ops/pallas/groupnorm.py:32",
                               "DenseNet-121 b=512 packed, 120 calls, bf16"),
        "groupnorm_bwd_bf16": ("csrc/groupnorm.cu", "ops/pallas/groupnorm.py:110",
                               "DenseNet-121 b=512 packed, 120 calls, bf16"),
        "xent_fwd": ("csrc/xent.cu", "ops/pallas/xent.py:30", list(XENT_LM_SHAPE)),
        "xent_bwd": ("csrc/xent.cu", "ops/pallas/xent.py:40", list(XENT_LM_SHAPE)),
        # the short route (T <= 64): attn_fwd_short_kernel, and attn_bwd_short_kernel,
        # which also replaces _attn_bwd_dq_kernel (:153)
        "attn_fwd": ("csrc/flash_attention.cu", "ops/pallas/flash_attention.py:58", list(ATTN_PATH_SHAPE)),
        "attn_bwd": ("csrc/flash_attention.cu", "ops/pallas/flash_attention.py:106", list(ATTN_PATH_SHAPE)),
        # the tiled route (T > 64)
        "attn_fwd_tiled": ("csrc/flash_attention.cu", "ops/pallas/flash_attention.py:58", list(ATTN_LONG_SHAPE)),
        "attn_bwd_dkv": ("csrc/flash_attention.cu", "ops/pallas/flash_attention.py:106", list(ATTN_LONG_SHAPE)),
        "attn_bwd_dq": ("csrc/flash_attention.cu", "ops/pallas/flash_attention.py:153", list(ATTN_LONG_SHAPE)),
        # not a Pallas kernel: the JAX package's chain is an XLA loop
        "synthetic_load": ("csrc/faultload.cu", "ops/faultload.py:27", [SYNTH_ITERS, 256, 256]),
    }
    for k16, k in zip(GN_BF16, ("groupnorm_fwd", "groupnorm_bwd")):
        timing[k16] = gp16["densenet"][k]
        launches = {tag: p[0][k16] for tag, p in paths.items() if p[0][k16]}
        for name, row in gp16.items():
            t = row[k]
            log(f"  {k16} ({name} packed pass, b={GN_PACKED_B}): kernel {t['ms']:.3f} ms (event wall "
                f"{t['wall_ms']:.3f}), bound {t['bound_ms']:.3f} ms ({t['bound_by']}, bf16 bytes), "
                f"plain {t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms; launches on the bf16 "
                f"paths {launches}")
    kernels = []
    for name, (src, tpu, shape) in sources.items():
        t = timing[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "dynamic_load_balance_distributeddnn_tpu_torch/" + src,
            "replaces": "dynamic_load_balance_distributeddnn_tpu/" + tpu,
            # each path counted from zero; a kernel on several adds them
            "launches": sum(counts[name] for counts, _, _, _ in paths.values()),
            "max_abs_err": err[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": shape,
        })
        if "bound_f32_ms" in t:  # K3's tiled route: bound_ms is its 3xTF32 bound
            kernels[-1]["bound_f32_ms"] = t["bound_f32_ms"]
    with open(os.path.join(OUT, "kernels.json"), "w") as f:
        json.dump({"card": smi, "kernels": kernels, "checks": records,
                   "groupnorm_timing": gt, "groupnorm_packed_timing": gp,
                   "groupnorm_packed_timing_bf16": gp16, "bf16_card_vs_cpu": bf16_vs_cpu,
                   "groupnorm_routes": gn_routes,
                   "xent_timing": {str(k): v for k, v in xt.items()},
                   "attn_timing": {str(k): v for k, v in at.items()},
                   "synthetic_load": load, "card_vs_cpu": card_vs_cpu,
                   "launches": {tag: p[0] for tag, p in paths.items()},
                   "walls": {tag: p[2] for tag, p in paths.items()},
                   "peak_bytes": {tag: p[3] for tag, p in paths.items()},
                   "series": {tag: p[1] for tag, p in paths.items()},
                   "groupnorm_shapes": shapes, "window_walls": window_walls,
                   "supersteps": supersteps, "resume": resume, "tracing": tracing,
                   "elastic": elastic, "multistream": multistream, "host_fed": host_fed,
                   "ranks": ranks, "remat": remat, "phase_seconds": seconds,
                   "rank_phase_seconds": rank_phase_s,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
