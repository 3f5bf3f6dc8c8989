"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py                 # the full check, one card

Phases, in order; any failed check raises and the script exits nonzero:

1. build   — compile the CUDA kernels from src/repro_torch/kernels/csrc;
             no instance of a flash kernel, forward or backward, may spill.
2. kernels — hold each kernel against its plain PyTorch version on the card
             (AdamW and pack bitwise, both flash kernels to a tolerance,
             and at every case on the wgmma route the backward kernel:
             each of dq, dk, dv within twice the plain bf16 backward's
             relative error against the plain f32 one, two launches
             bitwise equal; it is timed at gpt2-1.5b's and vit-h-14's
             microbatch beside the plain backward and SDPA's, and one
             call at gpt2's must add under 64 MB of device memory; at
             head dims from 8 to 256 in bf16 and f32, each case on the
             kernel ``route`` names, at every shape phases 8, 9 and 10
             launch (derived from their cells: whisper's 448 x 1500
             cross-attention, its encoder and decoder, the non-causal ViT,
             GQA 7:1 and 48:1, zamba2's shared block, llava), at dbrx's
             and gpt2-1.5b's shapes, and at sq > skv and at f32 sq != skv,
             and with a q_offset in bf16 and f32: llama3.2-3b's
             sequence-sharded rows (256 of 4096 at 3840, 24:8, 128), the
             tensor-parallel CPU test's reduced shape and rows that end
             before the last key), at each phase-4c rank yardstick's
             local attention shape (arctic's 14:2 heads at d 128 a rank
             of (1, 4), its 56:8 heads on one row a rank of (4, 1), the
             serving yardstick's 8:1 heads at d 64, batch 8 x 2048, and
             the family yardsticks': zamba2's shared block at 8:8 heads,
             whisper's encoder, decoder and 448 x 1500 cross-attention at
             4:4, the ViT's 4:4 at d 80, each timed too),
             on test shapes and again on every
             leaf and bucket of the main path, and time kernel, plain
             version, bound and one library call (the library call is a
             yardstick only; the port never makes it).
3. small   — a reduced model at f32 compute trains the same on the card
             (kernels) as on the CPU (plain versions); then tinyllama-1.1b
             at full width and 2 layers, f32 compute, 1 microbatch, batch
             2 x seq 2048, 2 steps: finite losses, the mma.sync flash kernel
             2 x layers x microbatches times a step, and the first step's
             loss within rtol 1e-4 of a forward on the CPU with the plain
             versions. This is the f32 flash kernel's path. Last, the
             explicit collectives on CUDA tensors over one-rank meshes
             (the only schedule one card runs; the n > 1 schedules are
             held on four gloo ranks by the CPU tests): the ring RS+AG
             hands back its input as result and owned chunk, and a
             one-stage GPipe equals its stage applied per microbatch.
4. main    — tinyllama-1.1b at full width: train() with an in-process channel
             into a 2-node async shadow on the card, 6 steps, a failure at
             step 4; the consolidated checkpoint must equal the trainer's
             params, mu and nu bit for bit, every kernel of the path must
             have run, the wgmma flash kernel 2 x layers x microbatches
             times a step and the mma.sync flash kernel never.
4b. ranks  — the data-parallel path over a one-rank NCCL world
             (``init_process_group("nccl")`` on a file store, rank 0 of
             1; ``Mesh.over_ranks((1, 1), ("data", "model"))`` with a
             DeviceMesh behind it): ``train(rules=...)`` and today's
             ``train()`` on tinyllama-1.1b at full width, 2 of 22 layers,
             bf16, 8 x 2048, 4 microbatches, 6 steps, a failure at step
             4, into a 2-node async shadow: losses, final states and
             the shadows' checkpoints bitwise equal between the runs, each
             trainer bitwise its checkpoint, no step lost, the wgmma flash
             kernel 2 x layers x microbatches times a step, AdamW and the
             pack launched; both step times beside the card's name and
             power limit. One card runs one rank: the n > 1 schedules
             are held on gloo ranks by the CPU tests. Before the runs,
             the tensor-parallel Functions on CUDA tensors over that
             mesh's model group of one rank: each the identity, forward
             and backward (train(rules=) then runs the plain layers);
             and serving under that mesh's rules (phase 9's dense batch
             8 x prompt 2048 at 2 layers, 8 greedy decode steps) bitwise
             serving with no rules: prefill logits, tokens and cache;
             and mamba2 and whisper at phase 8's cut and 2 layers: one
             microbatch's loss and gradients, 2 train steps, then phase
             9's prefill and 8 greedy decode steps under that mesh's
             rules bitwise the same with no rules. After the runs, the
             state gather over ranks (``RankStateGather``, the state_fn
             of a checkpointer over ranks) on the rules run's state:
             bitwise ``checkpoint_from_state``, one pack launch a tree,
             its added peak device bytes at most one tree's; both times,
             on a ``ranks gather`` line beside the card's name and power
             limit.
4c. dryrun — the port's dry run (``python -m repro_torch.launch.dryrun
             --arch tinyllama-1.1b``, and again with ``--multi-pod``) in
             two subprocesses that see no card (a fake world of 256 or
             512 ranks must not share a process with 4b's NCCL one),
             side by side: tinyllama-1.1b at full
             width and depth, train_4k, prefill_32k and decode_32k on the
             single- and multi-pod meshes, each cell ok (long_500k
             skipped), train cells with collective bytes, the multi-pod
             train cell's FLOPs a rank half the single-pod one's within
             2% (8 rows a rank, not 16); each cell's three roofline terms,
             bound, useful-FLOPs ratio and HBM bytes a rank printed, a
             model at the H100's data-sheet peaks. Meanwhile, on the
             card, the yardstick: ``analyze_step`` at 4b's cut (2 layers,
             8 x 2048, 4 microbatches, bf16) on a one-rank mesh beside one
             real step after a warm-up one: the predicted arguments +
             temporaries within 25% of the step's peak allocation, and
             the roofline step no longer than the measured one. Every
             cell traces the tensor-parallel step (``"model": "tp"``),
             serving too. Then the
             tensor-parallel yardstick: ``analyze_step`` for rank 0 of a
             (1, 4) ("data", "model") mesh in a fake world of 4 ranks
             (``cuda`` on the fake backend) at the same cut beside that
             rank's local step on the card: every local leaf the shape
             of its stand-in, the predicted peak within 25% of the
             card's, the roofline's compute and memory terms no longer
             than the measured step (the fake collectives move nothing,
             so values are not checked), the wgmma flash kernel 2 x
             layers x microbatches times a step and the analysis counting
             the same flash and AdamW calls. It runs twice: tinyllama at
             4b's cut, and arctic-480b at phase 8's cut (1 layer, 8
             experts, 2 a rank over ``model``, batch 4 x 2048 in 2
             microbatches), whose expert-parallel step routes every token
             on every model rank and runs its own two experts, and four
             more times, for mamba2, zamba2, whisper and the ViT at phase
             8's cuts (mamba2's 80 SSD heads 20 a rank, zamba2's 64 and
             its shared block's 32:32 heads 16 and 8:8, whisper's 16:16
             heads 4:4, the ViT's 4:4), each flash call at a local shape
             ``attention_shapes`` predicts (mamba2 none). Then the
             FSDP yardstick, the same checks for rank 0 of a (4, 1) mesh
             with FSDP: arctic-480b at phase 8's width, 4 layers, 8 x 2048
             in 2 microbatches, every ``wemb`` dim cut over the 4 data
             ranks and gathered a layer at a time in bf16 (forward and
             remat), its gradient reduce-scattered when the layer's
             backward ends; its step ms and card peak on a line of their
             own. Last, the serving yardstick: ``analyze_step`` of the
             serving prefill and decode for rank 0 of a (1, 4) mesh
             (tinyllama-1.1b at full width and depth, phase 9's batch 8 x
             prompt 2048, 8 decode steps over ``model``: 8 q heads and 1
             kv head a rank, a quarter of the cache's positions) beside
             that rank's own serving on the card: local leaves as their
             stand-ins, the prefill's predicted bytes within 25% of its
             peak, its roofline compute and memory terms no longer than
             the measured prefill, the wgmma flash kernel once a layer in
             prefill (as analysed) and no kernel in decode; its prefill
             ms and decode ms a token printed; and again for mamba2 at
             phase 9's cut (2 layers, 4 x 2048 + 8, 20 SSD heads a rank,
             no flash launch).
5. checkpointers — the training CLI (``repro_torch.launch.train.run``)
             at full width, ``--freq 1``, 5 steps, once per checkpointer:
             none; checkmate (2 async nodes, lag bound 2); checkmate
             --compress; the same two over ``--channel packetized
             --topology rail-optimized`` (the gradients cross the
             simulated multicast fabric) (these five at ``--layers 6``);
             sync; async; torch_dcp; gemini; checkfreq (the last five at
             ``--layers 2``). Every
             run but none fails at step 4. Each
             stall ledger must sum bit for bit, none must book no stall,
             each Checkmate run must lose no step at the failure, each
             copy-persist restore() must be its last checkpoint, bitwise
             the trainer's final state where that is the last step (all
             but checkfreq, whose tuned frequency skips steps 4 and 5), and
             each uncompressed Checkmate shadow bitwise the trainer's. On
             the card: the int8 codec equals its CPU run bitwise on a
             main-path bucket over two steps, kill_node makes consolidation
             name exactly the dead node's buckets, and the per-leaf shadow
             (flat=False) equals the flat one bitwise; at 2 layers the
             fabric gates a lost capture until a resync, a sharded fabric
             with a dead owner loses exactly its buckets while the
             surviving shard stays bitwise the trainer's, and both fabric
             engines give one result; a one-node apply at full width times
             what its staged receive hides.
6. durability — the durable shadow plane at full width, 2 layers:
             train() through a CheckmateCheckpointer with a DurableShadow
             (2 async nodes, lag bound 2, one LocalDiskTier under a
             temporary directory whose free space is checked first):
             raw — FlushPolicy(every_steps=2), 6 steps, a failure at step
             4; after drain() the last complete durable step is 6, no
             flush, durability or tier stage is in the ledger (which sums
             bit for bit), and after kill_node(1) (node 0's live shard
             merged with node 1's from the tier) and then after the loss
             of the whole plane, recover(tiers=...) gives the trainer's
             final params, mu and nu bit for bit (the total loss raising
             ShadowNodeLoss with total set and durable_hint
             ("local-disk", 6)); compressed — the same with int8 deltas, 4
             steps: each delta epoch smaller than the base, the total-loss
             restore within atol 1e-2 of the params; Adam and SGD, 3
             steps, a flush every step: shadow and restores bitwise; and
             the shadow planner at full depth (one measured apply on the
             card, and the cost model with the durability terms, against
             phase 4's step). Each run reports step and iteration medians,
             stall per checkpoint, flush and locked-snapshot ms, bytes per
             epoch, tier lag, disk peak and write rate, restore ms, and
             device and host peaks.
7. harness — the chaos harness (``repro_torch.harness``) on the card:
             all 42 channel-level golden scenarios pass every invariant,
             each AdamW one on an uncompressed channel ending with the
             trainer's and the shadow's checkpoints bitwise those of its
             CPU run (plain versions), each elastic drill booking
             elastic-reshard; the five full-level scenarios at
             tinyllama-1.1b full width, 1 layer, batch 8 x seq 2048,
             bf16, the config's 4 microbatches: every invariant passes,
             the wgmma flash kernel 2 x layers x microbatches times per
             executed step of the reference and checkpointed runs, the
             mma.sync one never, pack and AdamW launched; of them
             elastic-fsdp-flip restores onto FSDP-flipped sharding rules
             on the one-rank smoke mesh (train(elastic_rules=)), booking
             elastic-reshard once, its checkpoint after the flip bitwise
             the trainer's. Each scenario's wall seconds stand beside the
             JAX package's CPU baseline (benchmarks/golden_budget.json), a
             yardstick only.
8. families — every model family's training path at full width, cut in
             depth (and arctic's experts 128 -> 8) as far as 80 GB with a
             shadow forces, and whisper and vit for the time limit: granite-34b (2 layers; gelu2, GQA
             48:1), arctic-480b (1 layer, 8 experts; MoE), mamba2-2.7b (2
             layers, SSD at its published chunk 256), zamba2-1.2b (12
             layers: two calls of the shared block), whisper-medium (6 +
             6 layers, 1500 frames, 448 text tokens), llava-next-mistral-7b
             (2 layers, 576 patches + 1472 tokens) and vit-h-14 as a ViT
             (8 layers, 256 patches). Each first holds its .reduced()
             config at f32, 3 steps on the card against 3 on the CPU, to
             rtol 1e-4, and one forward at its run's widths, 2 layers (the
             hybrid: one segment, so one shared-block call; whisper 2 + 2),
             batch 1, at most 512 tokens, f32, on the card against the CPU,
             to rtol 1e-4; then train() with an in-process channel into a
             2-node async shadow, batch 4 in 2 microbatches, 3 steps, a
             failure at step 2: finite losses, no step lost, the
             consolidated checkpoint bitwise the trainer's, the wgmma flash
             kernel 2 x attention calls x microbatches times per executed
             step (0 for mamba2), each call at a shape attention_shapes()
             predicts and phase 2 checked, the mma.sync one never, AdamW
             and pack
             launched. Each prints its step ms, peak device memory and
             host RSS.
9. serving — prefill and greedy decode (``registry.prefill`` /
             ``decode_step``, bf16 compute from f32 params cast as
             ``train.step.serving_params`` casts them) at full width:
             tinyllama-1.1b at full depth, batch 8 x prompt 2048 + 64
             decode steps (the slice's main run), and every serving family
             at phase 8's cut, batch 4 x its phase-8 sequence + 32 steps
             (granite, arctic, mamba2, zamba2, whisper after 1500 frames,
             llava after 576 patches). Each: finite logits; the cache's
             length prompt (+ patches) + steps; the wgmma flash kernel
             launched exactly once per prefill attention call (layers;
             zamba2 its shared-block calls; whisper 6 + 2 x 6; mamba2 0),
             each at a shape phase 2 held, and no kernel during decode;
             the mma.sync one never; a second decode from the same prefill
             the same tokens. Before each, its config at 2 layers (zamba2
             one segment, whisper 2 + 2), f32, batch 1, at most 512 prompt
             tokens and 4 decode steps: logits on the card equal the CPU's
             (plain versions) and the full forward's at the same positions,
             to rtol 1e-4 / atol 1e-4. Each prints prefill ms, decode ms a
             token (median after the first), tokens/s, and peaks; the dense
             run also times the plain ``attention_decode`` at its last
             decode shape beside its K/V byte bound.
10. benchmarks — the paper's benchmark twins (``repro_torch.benchmarks``)
             that touch the card, at full width: kernels (the three Hopper
             kernels beside their plain versions at the main path's
             shapes), multicast_overhead (Fig 10; drops 0),
             optimizer_scaling (Fig 8: gpt3-6.7b, 2 layers, 1/2/4/8 shadow
             nodes), stalls (Fig 2: gpt3-xl, 2 layers, 8 x 2048, six
             systems: 4 steps, the four copy-persist ones 1), throughput (Fig 6: vit-h-14, gpt2-1.5b and
             gpt3-xl at 2 layers, llama2-7b at 1; no checkpoint and
             Checkmate 8 steps at each; async and gemini 2 steps and
             CheckFreq 6 at vit-h-14),
             shadow_timing (Fig 7, and its --json: flat against per-leaf,
             the arctic-480b fleet plan, the sharded critical path),
             durability_timing --json (4 layers of the tree, 2 steps) and
             correctness (Fig 9: vit-h-14, failures at 3, 5, 8); then the
             six examples (``repro_torch.examples``) at their own sizes
             and steps (train_100m 120, failing at 60). Every JAX twin's
             gate holds: Fig 9 bit-identical with 3 recoveries, every
             Checkmate run checkpointing every step, CheckFreq
             checkpointing less often at its tuned interval, no flush
             stage and a bitwise restore, the sharded plan at 8 or more
             nodes and each
             --json timing gate, the fabric rows without drops, each
             example's facts. Each run's flash calls match, shape by
             shape, the count its steps predict, every shape one phase 2
             held, the mma.sync kernel never; AdamW and the pack launched
             as predicted where a run fixes their counts. Prints each
             figure model's share of the bf16 peak at its measured step
             (not gated).

Output: a ``main_path`` JSON line, a ``ranks`` JSON line, a ``dryrun``
JSON line, ``flash_d128``, ``flash_f32_d128``,
``flash_bf16_d80``, ``flash_prefill`` (with phase 9's dense prefill
launches), ``flash_q_offset`` (llama3.2-3b's last sequence-sharded rows,
beside SDPA with the bottom-right mask), ``flash_ep_rank`` (an
expert-parallel arctic rank's heads, with one step of phase 4c's
launches), ``flash_fsdp_rank`` (an FSDP arctic rank's, with one step of
the FSDP yardstick's launches), ``flash_tp_serve_rank`` (a
tensor-parallel serving rank's prefill, with the serving yardstick's
launches), ``flash_tp_zamba2_rank``, ``flash_tp_whisper_enc_rank``,
``flash_tp_whisper_self_rank``, ``flash_tp_whisper_cross_rank`` and
``flash_tp_vit_rank`` (a family rank's local shapes, not causal where the
model's attention is not, with one step of that family yardstick's
launches at the shape) and ``pack_host`` timing lines, a ``kernels`` JSON line,
a ``checkpointers`` JSON line, a ``durability`` JSON line, a ``harness``
JSON line, a ``families`` JSON line, a ``serving`` JSON line, a
``benchmarks`` JSON line (each twin's CSV rows, seconds, launches and
gates) and an ``examples`` JSON line, the card's name and power limit, and
as the last line
``{"ok": true, "device": {...}}``. Without CUDA, or without the
repository beside it, it exits nonzero.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the H100 SXM's data-sheet peaks, from the port's roofline
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW as H100_BYTES_PER_S, PEAK_BF16 as H100_BF16_FLOPS,
    PEAK_F32 as H100_F32_FLOPS, PEAK_TF32 as H100_TF32_FLOPS)

# The main path's run: global batch 8 x seq 2048 through an in-process
# channel into a 2-node async shadow on the card. tools/profile_port.py
# profiles the same run.
MAIN_RUN = dict(batch=8, seq=2048, shadow_nodes=2, shadow_async=True)

# Phase 5: one CLI run per checkpointer, at MAIN_RUN's batch and seq,
# checkpointing every step, with a failure at step CKPT_FAIL (not for none).
CKPT_STEPS, CKPT_FAIL = 5, 4
# spans whose per-step medians each run reports (the stall ledger keeps
# only sums, which the first steps' pinned allocations inflate)
MEDIAN_SPANS = ("checkpoint.on_step", "channel.quantize", "channel.send",
                "fabric.simulate", "capture.d2h", "shadow.apply")
# the none and Checkmate rows run at CKPT_LAYERS layers (full width): the
# host simulating the fabric costs about 1.3 s a step at full depth, a
# full-depth Checkmate run holds two 13.2 GB shadow copies on the host, and
# the whole script must stay well inside its time limit
CKPT_LAYERS = 6
DEPTH = ("--layers", str(CKPT_LAYERS))
ASYNC = ("--shadow-async", "--max-lag-steps", "2")
PACKETIZED = ("--channel", "packetized", "--topology", "rail-optimized",
              *DEPTH)
# the five copy-persist rows run at COPY_PERSIST_LAYERS layers (full
# width): each of their checkpoints copies the whole state through
# pageable host memory (40-75 s a run at full depth, 10-22 s of stall at
# 6 layers), and phases 4b, 8 and 10 need the time
COPY_PERSIST_LAYERS = 2
COPY_PERSIST = ("--layers", str(COPY_PERSIST_LAYERS))
CKPT_RUNS = (
    ("none", DEPTH),
    ("checkmate", (*ASYNC, *DEPTH)),
    ("checkmate", (*ASYNC, *DEPTH, "--compress")),
    ("checkmate", (*ASYNC, *PACKETIZED)),
    ("checkmate", (*ASYNC, *PACKETIZED, "--compress")),
    *((name, COPY_PERSIST)
      for name in ("sync", "async", "torch_dcp", "gemini", "checkfreq")))


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1 -----------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.load()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.1f} s (nvcc {build.build_seconds} s)", flush=True)
    fn = None
    for line in build.ptxas_log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  ptxas:", line.strip())
        if fn and ("flash_fwd_kernel" in fn or "flash_bwd" in fn) \
                and "spill" in line:
            check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                  f"build: {fn} spills: {line.strip()}")


# -- phase 2 -----------------------------------------------------------------

HYPERS = (dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.0),
          dict(b1=0.8, b2=0.95, eps=1e-6, wd=0.2))


def check_adamw(dev) -> float:
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(1)
    sizes = (128, 1000, 12345, 38400, 25 * 1024 * 1024 // 4, 1_000_003)
    def place(t, lead):
        """A copy of ``t`` starting ``lead`` elements into its buffer
        (lead=1 takes the kernel's unaligned path)."""
        buf = torch.empty(t.numel() + lead, dtype=t.dtype, device=dev)
        view = buf[lead:]
        view.copy_(t)
        return view

    worst = 0.0
    for n in sizes:
        for pdt in (torch.float32, torch.bfloat16):
            for hyp in HYPERS:
                for lead in (0, 1):
                    p = torch.randn(n, generator=gen, device=dev).to(pdt)
                    g = torch.randn(n, generator=gen, device=dev)
                    m = torch.randn(n, generator=gen, device=dev)
                    v = torch.randn(n, generator=gen, device=dev).abs()
                    s = ref.adamw_scalars(5, 3e-4, **hyp)
                    pr, mr, vr = ref.adamw_ref(p, g, m, v, s, 0.75)
                    pk, gk, mk, vk = (place(t, lead) for t in (p, g, m, v))
                    ops.fused_adamw_(pk, gk, mk, vk, s, 0.75)
                    torch.cuda.synchronize()
                    for a, b, what in ((pk, pr, "p"), (mk, mr, "m"),
                                       (vk, vr, "v")):
                        err = (a.float() - b.float()).abs().max().item()
                        worst = max(worst, err)
                        check(torch.equal(a, b),
                              f"adamw {what} n={n} p={pdt} {hyp} lead={lead}"
                              f" not bitwise equal (max err {err})")
    print(f"kernels: adamw bitwise equal on {len(sizes)} sizes x 2 dtypes x "
          f"2 hyperparameter sets x aligned/misaligned", flush=True)
    return worst


def check_pack(dev) -> float:
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(2)
    sizes = (128, 1000, 12345, 128 * 300)
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        for n_leaves in (*range(1, 10), 200):     # 200: two launches
            leaves = []
            for i in range(n_leaves):
                n = sizes[i % len(sizes)] + i      # odd offsets too
                x = torch.randn(n, generator=gen, device=dev) * 100
                leaves.append(x.to(dt))
            offs = np.cumsum([0] + [t.numel() for t in leaves[:-1]]).tolist()
            total = sum(t.numel() for t in leaves)
            want = ref.bucket_pack_ref(
                leaves, offs, torch.zeros(total, dtype=dt, device=dev))
            before = ops.COUNTERS["bucket_pack"].value
            got = ops.pack_bucket(leaves, offs,
                                  torch.zeros(total, dtype=dt, device=dev))
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"pack {dt} with {n_leaves} leaves not exact")
            n = ops.COUNTERS["bucket_pack"].value - before
            check(n == -(-n_leaves // 128),
                  f"pack {dt} with {n_leaves} leaves: {n} launches")
    print("kernels: pack exact for 1..9 and 200 leaves x f32/bf16/int32",
          flush=True)
    return 0.0


# Flash ``o`` tolerance per dtype, elementwise: |o - ref| <= rtol*|ref| + atol.
# Both sides round an f32 result to bf16, so they differ by at most one bf16
# step (2**-7 of the value); the limit scales with |ref| because late causal
# rows average many values of v and are small.
# The head_dim-128 shape timed beside the main path's (the dense configs
# after tinyllama have head_dim 128): (b, s, h, kv, d, dtype, causal).
FLASH_D128 = (1, 2048, 32, 8, 128, torch.bfloat16, True)
# the dense serving run's prefill (phase 9): batch 8, tinyllama's heads
FLASH_PREFILL = (8, 2048, 32, 4, 64, torch.bfloat16, True)
# f32 at head_dim 128 (refused before the mma.sync kernel), and bf16 at
# vit-h-14's heads (head_dim 80, the wgmma kernel zero-filled to 128)
FLASH_F32_D128 = (1, 2048, 32, 8, 128, torch.float32, True)
FLASH_BF16_D80 = (2, 2048, 16, 16, 80, torch.bfloat16, True)
FLASH_TOL = {torch.float32: (0.0, 2e-5), torch.bfloat16: (1e-2, 1e-4)}
# head dims held against the plain version. bf16: the zero-filled wgmma
# instances (multiples of 8 up to 128), then the mma.sync kernel's (7: an
# odd d, loaded element by element); f32, all on the mma.sync kernel (3 and
# 33: rows copied 4 bytes at a time)
FLASH_BF16_DIMS = (8, 16, 24, 48, 72, 80, 96, 112, 128, 20, 100, 160, 256, 7)
FLASH_F32_DIMS = (8, 16, 20, 32, 64, 80, 96, 128, 160, 256, 3, 33)
# Flash with a q_offset, the sequence-sharded attention's rows (causal row
# i keeps the keys up to q_offset + i): (b, sq, skv, h, kv, d, q_offset),
# each in bf16 and f32. llama3.2-3b's rows on the single pod (24 heads do
# not divide 16 model ranks: each rank takes 256 of 4096 rows; the last
# rank's at 3840), the tensor-parallel CPU test's reduced shape (3 heads
# over 2 ranks: rank 1's 8 of 16 rows), and rows that end before the
# last key. The first is timed (FLASH_OFFSET_ROW).
FLASH_OFFSET_CASES = ((1, 256, 4096, 24, 8, 128, 3840),
                      (4, 8, 16, 3, 1, 16, 8),
                      (1, 100, 300, 8, 2, 64, 37))
FLASH_OFFSET_ROW = FLASH_OFFSET_CASES[0]


# Flash shapes beside phase 8's own (which family_flash_cases() derives
# from FAMILY_CELLS): (b, sq, skv, h, kv, d, dtype, causal). whisper's
# cross-attention in f32, and its transpose (sq > skv) in both dtypes.
FLASH_EXTRA_CASES = (
    (2, 448, 1500, 16, 16, 64, torch.float32, False),
    (2, 1500, 448, 16, 16, 64, torch.bfloat16, False),
    (2, 1500, 448, 16, 16, 64, torch.float32, False))
# configs not run in phase 8 whose attention shapes phase 2 holds:
# (arch, token seq): dbrx's GQA 6:1 and gpt2-1.5b's 25 heads
FLASH_CONFIG_CASES = (("dbrx-132b", 2048), ("gpt2-1.5b", 2048))


def flash_cases() -> tuple[list, int]:
    """Every flash case phase 2 holds, (b, sq, skv, h, kv, d, dtype,
    causal), and how many of them are the phases' own shapes
    (`family_flash_cases`)."""
    cases = []   # (b, s, h, kv, d, dtype, causal), sq == skv
    for b, s, h, d in ((2, 128, 2, 16), (1, 256, 4, 32), (2, 64, 2, 8),
                       (1, 64, 1, 64)):
        for causal in (True, False):
            cases.append((b, s, h, h, d, torch.float32, causal))
    cases += [(1, 128, 2, 2, 32, torch.bfloat16, True),
              (1, 128, 1, 1, 16, torch.float32, True),      # 64/32 tiles
              (1, 100, 8, 2, 64, torch.float32, True)]      # ragged, GQA
    for d in (64, 128):              # the tensor-core kernel: ragged s,
        for causal in (True, False):  # GQA 8:1 and 1:1
            cases += [(1, 100, 8, 1, d, torch.bfloat16, causal),
                      (1, 1000, 8, 8, d, torch.bfloat16, causal)]
    # every head dim route() takes: ragged s, GQA 4:1, both mask settings
    for dt, dims in ((torch.bfloat16, FLASH_BF16_DIMS),
                     (torch.float32, FLASH_F32_DIMS)):
        for d in dims:
            for causal in (True, False):
                cases.append((1, 300, 8, 2, d, dt, causal))
    cases += [(2, 2048, 32, 4, 64, torch.bfloat16, True),   # main path
              FLASH_D128, FLASH_F32_D128, FLASH_BF16_D80,
              (2, 2048, 32, 4, 64, torch.float32, True)]    # phase 3's
    cases = [(b, s, s, h, kv, d, dt, causal)
             for b, s, h, kv, d, dt, causal in cases]
    cases += [c for cut, batch, seq, mesh in rank_yard_cells().values()
              for c in attention_shapes(rank_local(cut, mesh), seq,
                                        batch // mesh[0]
                                        // cut.microbatches)]
    for cut, b, prompt, _, mesh in serve_yard_cells().values():
        cases += list(attention_shapes(rank_local(cut, mesh), prompt,
                                       b // mesh[0]))
    family = family_flash_cases()
    return cases + family, len(family)


# the backward's rows: gpt2-1.5b's microbatch (4 x 1024, 25 heads of 64,
# causal) and vit-h-14's (32 x 256 patches, 16 heads of 80, no mask), the
# benchmark's cells' shapes, as (b, s, h, kv, d, causal)
FLASH_BWD_GPT2 = (4, 1024, 25, 25, 64, True)
FLASH_BWD_VIT = (32, 256, 16, 16, 80, False)


def rel_err(x, ref32) -> float:
    """||x - ref|| / ||ref|| over the whole tensor, in f32."""
    return ((x.float() - ref32).norm() / ref32.norm().clamp_min(1e-30)).item()


def check_flash_bwd(q, k, v, o, lse, do, causal, off, case) -> float:
    """The backward kernel at one case against the plain backward: each of
    dq, dk, dv within twice the plain bf16 backward's own relative error
    against the plain backward in f32 on the same inputs; one launch a
    call; two launches bitwise equal. Returns the worst ratio of the
    kernel's error to the plain bf16 one's."""
    from repro_torch.kernels import ops, ref
    before = ops.launch_counts()["flash_attention_bwd"]
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal, off)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal, off)
    n = ops.launch_counts()["flash_attention_bwd"] - before
    check(n == 2, f"flash bwd {case}: {n} launches for two calls")
    plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, off)
    f32 = ref.flash_attention_bwd_ref(*(t.float() for t in (q, k, v, o)),
                                      lse, do.float(), causal, off)
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, a, pl, w in zip(("dq", "dk", "dv"), got, again, plain, f32):
        check(torch.equal(g, a), f"flash bwd {case}: {name} differs between "
                                 f"two launches")
        ek, ep = rel_err(g, w), rel_err(pl, w)
        check(ek <= 2.0 * ep, f"flash bwd {case}: {name} relative error "
                              f"{ek:.3e} > twice the plain bf16 backward's "
                              f"{ep:.3e}")
        worst = max(worst, ek / max(ep, 1e-30))
    del got, again, plain, f32
    return worst


def check_flash(dev) -> dict:
    """Both flash kernels against the plain version, and on the wgmma
    route the backward kernel (`check_flash_bwd`); returns the worst
    error in ``o`` of each kernel and input dtype, keyed "name:dtype"."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import route
    gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(shape, dt, s=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dt)

    cases, n_family = flash_cases()
    cases += [(b, s, skv, h, kv, d, dt, True, off)
              for b, s, skv, h, kv, d, off in FLASH_OFFSET_CASES
              for dt in (torch.bfloat16, torch.float32)]
    worst, ratios = {}, {}
    bwd_worst, n_bwd = 0.0, 0
    for case in cases:
        b, s, skv, h, kv, d, dt, causal = case[:8]
        off = case[8] if len(case) > 8 else 0
        rtol, atol = FLASH_TOL[dt]
        q, k, v = rnd((b, s, h, d), dt, 0.3), \
            rnd((b, skv, kv, d), dt, 0.3), rnd((b, skv, kv, d), dt)
        name = f"flash_attention_{route(dt, d)}"
        before = ops.launch_counts()
        o, lse = ops.flash_attention(q, k, v, causal, off)
        ran = {n: c - before[n] for n, c in ops.launch_counts().items()}
        check(ran[name] == 1 and sum(ran.values()) == 1,
              f"flash {case}: launched {ran}, not {name} once")
        orf, lref = ref.flash_attention_ref(q, k, v, causal, off)
        torch.cuda.synchronize()
        diff = (o.float() - orf.float()).abs()
        ratio = (diff / (rtol * orf.float().abs() + atol)).max().item()
        err = diff.max().item()
        lerr = (lse - lref).abs().max().item()
        key = f"{name}:{str(dt).removeprefix('torch.')}"
        worst[key] = max(worst.get(key, 0.0), err)
        ratios[key] = max(ratios.get(key, 0.0), ratio)
        check(ratio <= 1.0, f"flash o {case} err {err}: {ratio:.3f} times "
                            f"the limit {rtol}*|ref| + {atol}")
        check(lerr <= 1e-4, f"flash lse {case} err {lerr} > 1e-4")
        if name == "flash_attention_wgmma":
            do = rnd((b, s, h, d), dt)
            bwd_worst = max(bwd_worst, check_flash_bwd(
                q, k, v, o, lse, do, causal, off, case))
            n_bwd += 1
            del do
        if s >= 1024:
            late = diff[:, s // 2:].max().item()
            size = orf[:, s // 2:].float().abs().mean().item()
            print(f"kernels: flash {case} ({name}): max err {err}, "
                  f"{ratio:.3f} of the limit; rows past s/2: max err {late}, "
                  f"mean |o| {size}", flush=True)
    print(f"kernels: flash within tolerance on {len(cases)} cases, "
          f"{n_family} of them the families' shapes (sq != skv among "
          f"them), {2 * len(FLASH_OFFSET_CASES)} with a q_offset "
          f"(o: 2e-5 f32, 1e-2*|ref| + 1e-4 bf16; lse 1e-4); "
          f"worst share of the limit {ratios}", flush=True)
    print(f"kernels: flash backward within twice the plain bf16 "
          f"backward's relative error (against the plain f32 one) on the "
          f"{n_bwd} wgmma cases, and bitwise the same on a second launch; "
          f"worst share {bwd_worst:.3f}", flush=True)
    return worst


def check_main_shapes(dev, p, g, m, v, layout, s) -> dict:
    """AdamW and pack against their plain versions on the tensors the main
    path hands them: AdamW on every leaf (the trainer's update) and every
    bucket flat (the shadow's), pack on every bucket. Both bitwise."""
    from repro_torch.kernels import ops, ref
    worst = {"fused_adamw": 0.0, "bucket_pack": 0.0}

    def held(got, want, name, what):
        err = (got.float() - want.float()).abs().max().item()
        worst[name] = max(worst[name], err)
        check(torch.equal(got, want), f"{name} {what} not bitwise equal at "
                                      f"the main path's shape (max err {err})")

    def adamw(pt, gt, mt, vt, what):
        pk, mk, vk = pt.clone(), mt.clone(), vt.clone()
        ops.fused_adamw_(pk, gt, mk, vk, s, 0.75)
        for got, want, t in zip((pk, mk, vk),
                                ref.adamw_ref(pt, gt, mt, vt, s, 0.75), "pmv"):
            held(got, want, "fused_adamw", f"{t} of {what}")

    for k in p:
        adamw(p[k], g[k], m[k], v[k], f"leaf {k} {tuple(p[k].shape)}")
    for b in layout.buckets:
        leaves = {name: [tree[sl.name].reshape(-1) for sl in b.slots]
                  for name, tree in (("p", p), ("g", g), ("m", m), ("v", v))}
        offs = [sl.offset for sl in b.slots]
        flats = {name: ref.bucket_pack_ref(ls, offs,
                                           torch.zeros(b.size, device=dev))
                 for name, ls in leaves.items()}
        got = ops.pack_bucket(leaves["g"], offs, torch.zeros_like(flats["g"]))
        held(got, flats["g"], "bucket_pack", f"bucket {b.bucket_id}")
        adamw(flats["p"], flats["g"], flats["m"], flats["v"],
              f"bucket {b.bucket_id} ({b.size})")
        del leaves, flats, got
    torch.cuda.synchronize()
    print(f"kernels: adamw bitwise equal on the main path's {len(p)} leaves and "
          f"{len(layout.buckets)} bucket flats; pack exact on its "
          f"{len(layout.buckets)} buckets", flush=True)
    return worst


def time_kernels(dev, cfg, errs: dict) -> tuple[list[dict], dict, dict]:
    """Each kernel at the main path's shapes: checked against its plain
    version there, then timed with the plain version, bound and library
    yardstick. Returns the kernels' rows, the flash rows at shapes no path
    runs (by their output line's name), and the pack wrapper's host time
    per call."""
    from repro_torch.core.buckets import layout_for_tree
    from repro_torch.kernels import bucket_pack, ops, ref
    from repro_torch.models import registry

    specs = registry.param_specs(cfg)
    gen = torch.Generator(device=dev).manual_seed(4)
    p = {k: torch.randn(sp.shape, generator=gen, device=dev) * 0.02
         for k, sp in sorted(specs.items())}
    g = {k: torch.randn_like(t) * 1e-3 for k, t in p.items()}
    m = {k: torch.randn_like(t) * 1e-4 for k, t in p.items()}
    v = {k: (torch.randn_like(t) * 1e-3).square() for k, t in p.items()}
    n_params = sum(t.numel() for t in p.values())
    s = ref.adamw_scalars(2, 3e-4)
    names = list(p)
    layout = layout_for_tree(g)
    main_errs = check_main_shapes(dev, p, g, m, v, layout, s)
    for name, err in main_errs.items():
        errs[name] = max(errs[name], err)
    torch.cuda.empty_cache()
    steps = [torch.tensor(2.0, device=dev) for _ in names]
    rows = []

    def adamw_kernel():
        for k in names:
            ops.fused_adamw_(p[k], g[k], m[k], v[k], s)

    def adamw_plain():
        for k in names:
            ref.adamw_ref(p[k], g[k], m[k], v[k], s)

    def adamw_library():
        torch._fused_adamw_([p[k] for k in names], [g[k] for k in names],
                            [m[k] for k in names], [v[k] for k in names], [],
                            steps, lr=3e-4, beta1=0.9, beta2=0.95,
                            weight_decay=0.1, eps=1e-8, amsgrad=False,
                            maximize=False)
    bms, by = bound(28.0 * n_params, 15.0 * n_params, H100_F32_FLOPS)
    rows.append(dict(
        name="fused_adamw", source="src/repro_torch/kernels/csrc/fused_adamw.cu",
        replaces="src/repro/kernels/fused_adamw.py:74",
        max_abs_err=errs["fused_adamw"], ms=time_ms(adamw_kernel, 5),
        plain_ms=time_ms(adamw_plain, 3, 1), bound_ms=bms, bound_by=by,
        library_ms=time_ms(adamw_library, 5)))

    bufs = {b.bucket_id: torch.empty(b.size, device=dev)
            for b in layout.buckets}

    def per_bucket(fn):
        def run():
            for b in layout.buckets:
                fn([g[sl.name].reshape(-1) for sl in b.slots],
                   [sl.offset for sl in b.slots], bufs[b.bucket_id])
        return run

    def cat_out(leaves, offs, out):
        torch.cat(leaves, out=out)
    # the kernel alone: every bucket's launch tables built beforehand
    tables = [(bucket_pack.table(plan), bufs[b.bucket_id])
              for b in layout.buckets
              for plan in bucket_pack.launch_plan(
                  [g[sl.name].reshape(-1) for sl in b.slots],
                  [sl.offset for sl in b.slots], 4)]

    def pack_launches():
        for t, out in tables:
            bucket_pack.launch(t, out)
    bms, by = bound(8.0 * n_params, 0.0, H100_F32_FLOPS)
    rows.append(dict(
        name="bucket_pack", source="src/repro_torch/kernels/csrc/bucket_pack.cu",
        replaces="src/repro/kernels/bucket_pack.py:34",
        max_abs_err=errs["bucket_pack"], ms=time_ms(pack_launches, 5),
        plain_ms=time_ms(per_bucket(ref.bucket_pack_ref), 5),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(per_bucket(cat_out), 5)))
    # the wrapper's host time per call: with the kernel (a sync after each
    # call), and the enqueue alone
    with_sync, enqueue = [], []
    for _ in range(5):
        for b in layout.buckets:
            leaves = [g[sl.name].reshape(-1) for sl in b.slots]
            offs = [sl.offset for sl in b.slots]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ops.pack_bucket(leaves, offs, bufs[b.bucket_id])
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            enqueue.append((t1 - t0) * 1e3)
            with_sync.append((t2 - t0) * 1e3)
    host = {"calls": len(enqueue), "buckets": len(layout.buckets),
            "enqueue_ms_per_call": float(np.mean(enqueue)),
            "with_sync_ms_per_call": float(np.mean(with_sync)),
            "kernel_ms_per_step": rows[-1]["ms"]}
    print(f"timing: bucket_pack host per call: enqueue "
          f"{host['enqueue_ms_per_call']:.4f} ms, with the kernel and a sync "
          f"{host['with_sync_ms_per_call']:.4f} ms", flush=True)
    del p, g, m, v, bufs, tables
    torch.cuda.empty_cache()

    b, sq = MAIN_RUN["batch"] // cfg.microbatches, MAIN_RUN["seq"]
    main_shape = (b, sq, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    rows.append(flash_row(dev, gen, main_shape, torch.bfloat16, errs))
    rows.append(flash_row(dev, gen, main_shape, torch.float32, errs))
    rows.append(flash_bwd_row(dev, gen, FLASH_BWD_GPT2))
    extra = {label: flash_row(dev, gen, case[:5], case[5], errs)
             for label, case in (("flash_d128", FLASH_D128),
                                 ("flash_f32_d128", FLASH_F32_D128),
                                 ("flash_bf16_d80", FLASH_BF16_D80),
                                 ("flash_prefill", FLASH_PREFILL))}
    extra["flash_bwd_vit"] = flash_bwd_row(dev, gen, FLASH_BWD_VIT)
    b, sq, skv, h, kv, d, off = FLASH_OFFSET_ROW
    extra["flash_q_offset"] = flash_row(dev, gen, (b, sq, h, kv, d),
                                        torch.bfloat16, errs, skv=skv,
                                        q_offset=off)
    # an expert-parallel rank's attention: arctic's heads a rank of
    # phase 4c's (1, 4) mesh, one microbatch
    cut, bsz, sq, mesh = rank_yard_cells()["arctic"]
    loc = rank_local(cut, mesh)
    extra["flash_ep_rank"] = flash_row(
        dev, gen, (bsz // cut.microbatches, sq, loc.num_heads,
                   loc.num_kv_heads, loc.head_dim), torch.bfloat16, errs)
    # an FSDP rank's attention: arctic's whole heads on phase 4c's (4, 1)
    # mesh, one microbatch of that rank's batch
    cut, bsz, sq, mesh = rank_yard_cells()["fsdp"]
    extra["flash_fsdp_rank"] = flash_row(
        dev, gen, (bsz // mesh[0] // cut.microbatches, sq, cut.num_heads,
                   cut.num_kv_heads, cut.head_dim), torch.bfloat16, errs)
    # a tensor-parallel serving rank's prefill: tinyllama's heads a rank
    # of phase 4c's (1, 4) mesh, the dense serving run's batch
    cut, bsz, prompt, _, mesh = serve_yard_cell()
    loc = rank_local(cut, mesh)
    extra["flash_tp_serve_rank"] = flash_row(
        dev, gen, (bsz // mesh[0], prompt, loc.num_heads, loc.num_kv_heads,
                   loc.head_dim), torch.bfloat16, errs)
    # the tensor-parallel family ranks' attention: each local shape phase
    # 4c's family yardsticks launch (rank 0 of the (1, 4) mesh)
    for name, (_, shape) in family_rank_flash().items():
        b, sq, skv, h, kv, d, dt, causal = shape
        extra[name] = flash_row(dev, gen, (b, sq, h, kv, d), dt, errs,
                                skv=skv, causal=causal)
    for r in rows + list(extra.values()):
        r["route"] = "cuda"
        by = ", ".join(filter(None, (r["bound_by"], r.get("bound_unit"))))
        other = (f"; on the f32 units {r['other_bound_ms']:.4f} ms"
                 if "other_bound_ms" in r else "")
        print(f"timing: {r['name']} {r.get('shape', '')}: kernel "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
              f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({by}){other}", flush=True)
    return rows, extra, host


FLASH_SOURCES = {"flash_attention_wgmma": "flash_attention_wgmma.cu",
                 "flash_attention_mma": "flash_attention.cu"}


def family_rank_flash() -> dict:
    """{row name: (yardstick label, flash shape)} of every local flash
    shape phase 4c's family yardsticks launch (`attention_shapes` of
    rank 0's heads, one microbatch of its rows): one row a family, and
    whisper's by call (``enc``, ``self``, ``cross``)."""
    rows, cells = {}, rank_yard_cells()
    for label in FAMILY_YARDS:
        cut, bsz, seq, mesh = cells[label]
        shapes = list(attention_shapes(rank_local(cut, mesh), seq,
                                       bsz // mesh[0] // cut.microbatches))
        for shape in shapes:
            sq, skv, causal = shape[1], shape[2], shape[7]
            kind = ("" if len(shapes) == 1 else "_self" if causal
                    else "_enc" if sq == skv else "_cross")
            rows[f"flash_tp_{label}{kind}_rank"] = (label, shape)
    return rows


def flash_row(dev, gen, shape, dt, errs, skv=None, q_offset=0,
              causal=True) -> dict:
    """The flash kernel ``route`` picks, timed at (b, s, h, kv, d), causal
    (or with no mask: ``causal`` False, every (q, k) pair), beside its
    plain version and SDPA on kv expanded to h heads. Its bound
    is that of the unit it runs on: bf16 products on the tensor cores
    (wgmma), or at the TF32 rate three times for f32 and one and a half
    times for bf16 (mma.sync, 3xTF32; bf16 splits only P), with the f32
    units' bound beside it. With ``skv`` and ``q_offset`` (skv - s: the
    last rows of a sequence-sharded attention), s query rows at that
    offset against skv keys, and SDPA with the equivalent bottom-right
    causal mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import causal_pairs, route
    b, sq, h, kv, d = shape
    skv = sq if skv is None else skv
    name = f"flash_attention_{route(dt, d)}"
    q = (torch.randn((b, sq, h, d), generator=gen, device=dev) * 0.3).to(dt)
    k = (torch.randn((b, skv, kv, d), generator=gen, device=dev) * 0.3).to(dt)
    v = torch.randn((b, skv, kv, d), generator=gen, device=dev).to(dt)
    qt = q.transpose(1, 2)
    kt = ref.expand_kv(k, h).transpose(1, 2)
    vt = ref.expand_kv(v, h).transpose(1, 2)
    if not causal:
        sdpa = {}
    elif q_offset:
        from torch.nn.attention.bias import causal_lower_right
        check(q_offset == skv - sq, f"flash_row: offset {q_offset} is not "
                                    f"the bottom-right mask's {skv - sq}")
        sdpa = dict(attn_mask=causal_lower_right(sq, skv))
    else:
        sdpa = dict(is_causal=True)
    # the (q, k) pairs the mask keeps
    pairs = causal_pairs(sq, skv, q_offset) if causal else sq * skv
    flops = 4.0 * b * h * d * pairs
    item = q.element_size()
    nbytes = item * (q.numel() * 2 + k.numel() + v.numel()) + 4.0 * b * h * sq
    extra = {}
    if name == "flash_attention_wgmma":
        bms, by = bound(nbytes, flops, H100_BF16_FLOPS)
        extra["bound_unit"] = "bf16 tensor cores, 989 TFLOP/s"
    else:
        passes = 3.0 if dt == torch.float32 else 1.5
        bms, by = bound(nbytes, passes * flops, H100_TF32_FLOPS)
        extra["bound_unit"] = (f"TF32 tensor cores, {passes:g} passes, "
                               f"495 TFLOP/s")
        extra["other_bound_ms"], extra["other_bound_by"] = bound(
            nbytes, flops, H100_F32_FLOPS)
        extra["other_bound_unit"] = "f32 units, 67 TFLOP/s"
    row = dict(
        name=name, source=f"src/repro_torch/kernels/csrc/{FLASH_SOURCES[name]}",
        replaces="src/repro/kernels/flash_attention.py:80",
        max_abs_err=errs[f"{name}:{str(dt).removeprefix('torch.')}"],
        ms=time_ms(lambda: ops.flash_attention(q, k, v, causal, q_offset),
                   10),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v, causal,
                                                         q_offset), 3, 1),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **sdpa), 10),
        shape=list(shape), dtype=str(dt).removeprefix("torch."), **extra)
    if q_offset:
        row.update(skv=skv, q_offset=q_offset)
    elif skv != sq:
        row.update(skv=skv)
    if not causal:
        row.update(causal=False)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def flash_bwd_row(dev, gen, shape) -> dict:
    """The backward kernel at (b, s, h, kv, d, causal) in bf16, held to
    the plain backward on the inputs it is timed on (`check_flash_bwd`;
    ``rel_err_ratio`` is the worst of dq, dk, dv's relative error over the
    plain bf16 backward's), timed beside the plain backward and SDPA's
    backward (a yardstick only; the port never calls it), with its bound
    (`flash_bwd_work`: five products at the bf16 peak, or its bytes at the
    HBM rate) and the device memory each adds above its inputs and
    outputs during one call."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_bwd_work
    b, s, h, kv, d, causal = shape

    def rnd(shp, sc=1.0):
        return (torch.randn(shp, generator=gen, device=dev) * sc).to(
            torch.bfloat16)
    q, k, v = rnd((b, s, h, d), 0.3), rnd((b, s, kv, d), 0.3), \
        rnd((b, s, kv, d))
    do = rnd((b, s, h, d))
    o, lse = ops.flash_attention(q, k, v, causal)
    ratio = check_flash_bwd(q, k, v, o, lse, do, causal, 0, shape)

    def kernel():
        return ops.flash_attention_bwd(q, k, v, o, lse, do, causal)

    def plain():
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)

    def added_mb(fn) -> float:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del out
        return peak / 1e6
    kernel_mb, plain_mb = added_mb(kernel), added_mb(plain)
    check(kernel_mb < 64.0, f"flash bwd {shape}: one call adds {kernel_mb} "
                            f"MB of device memory, not under 64")
    qt, kt, vt = (ref.expand_kv(t, h).transpose(1, 2).detach()
                  .requires_grad_() for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    flops, nbytes = flash_bwd_work(q, k, causal)
    bms, by = bound(nbytes, flops, H100_BF16_FLOPS)
    row = dict(
        name="flash_attention_bwd",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/layers.py:_flash_bwd",
        rel_err_ratio=ratio,
        ms=time_ms(kernel, 10), plain_ms=time_ms(plain, 3, 1),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), 10),
        shape=[b, s, h, kv, d], dtype="bfloat16",
        bound_unit="bf16 tensor cores, 989 TFLOP/s", added_mb=kernel_mb,
        plain_added_mb=plain_mb)
    if not causal:
        row.update(causal=False)
    print(f"timing: flash_attention_bwd {shape}: kernel {row['ms']:.4f} ms, "
          f"plain {row['plain_ms']:.3f} ms, SDPA backward "
          f"{row['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}); one call "
          f"adds {kernel_mb:.1f} MB (plain {plain_mb:.1f} MB); relative "
          f"error {ratio:.4f} times the plain bf16 backward's", flush=True)
    del q, k, v, o, lse, do, qt, kt, vt, ot, dot
    torch.cuda.empty_cache()
    return row


# -- phase 3 -----------------------------------------------------------------

# Phase 3's full-width f32 run: tinyllama-1.1b cut to SMALL_LAYERS layers
# (widths untouched), f32 compute, one microbatch, SMALL_RUN's batch and seq.
SMALL_LAYERS = 2
SMALL_RUN = dict(steps=2, batch=2, seq=2048, seed=5)


def phase_small() -> dict:
    """A reduced model trains the same on the card as on the CPU; then the
    full-width f32 run (the mma.sync flash kernel's path). Returns the
    launch counts of the full-width run."""
    from repro_torch import configs
    cfg = configs.get("tinyllama-1.1b")
    lg, lc = reduced_card_equals_cpu(cfg, "small")
    print(f"small: reduced model at f32, 3 steps, card losses {lg} vs CPU "
          f"{lc} (rtol 1e-4)", flush=True)
    launches = small_full_width()
    one_rank_collectives(cfg)
    return launches


def one_rank_collectives(cfg):
    """The ring RS+AG and GPipe on CUDA tensors over one-rank meshes (no
    process group): the ring's n = 1 path hands back its input, at a
    main-path leaf's shape; a one-stage pipeline at the CPU tests' GPipe
    widths equals its stage applied to each microbatch, bit for bit; the
    smoke mesh's rules place nothing (``shard`` is the identity)."""
    from repro_torch.dist.collectives import ring_all_reduce_rs_ag
    from repro_torch.dist.pipeline import make_pp_mesh, pipeline_apply
    from repro_torch.dist.sharding import ShardingRules, make_smoke_mesh
    from repro_torch.models import registry
    from repro_torch.optim.sharded import zero1_shardings
    rules = ShardingRules(make_smoke_mesh())
    check(rules.mesh.device_type == "cuda" and rules.mesh.size == 1,
          f"collectives: smoke mesh {rules.mesh}")
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(cfg.d_ff, cfg.d_model, device="cuda", generator=gen)
    full, owned = ring_all_reduce_rs_ag(x, rules.mesh, "data")
    check(full is x and owned is x, "collectives: the one-rank ring did not "
                                    "hand back its input")
    check(rules.shard(x, "ff", "wemb") is x, "collectives: shard moved x")
    pp = make_pp_mesh(1, 1)
    ws = torch.randn(1, 8, 8, device="cuda", generator=gen) * 0.3
    xs = torch.randn(6, 2, 8, device="cuda", generator=gen)
    out = pipeline_apply(lambda w, v: torch.tanh(v @ w), ws, xs, pp)
    ref = torch.stack([torch.tanh(v @ ws[0]) for v in xs])
    check(out.device.type == "cuda" and torch.equal(out, ref),
          "collectives: the one-stage pipeline differs from its stage")
    z1 = zero1_shardings(registry.param_specs(cfg), rules)
    check(all("data" in s for s in z1.values()),
          f"collectives: ZeRO-1 left a leaf unplaced on the smoke mesh {z1}")
    print(f"collectives: one-rank ring RS+AG over a {tuple(x.shape)} leaf "
          f"and a one-stage GPipe (M 6, mb 2, d 8) on the card; ZeRO-1 "
          f"specs for {len(z1)} leaves", flush=True)


def reduced_card_equals_cpu(cfg, what: str) -> tuple[list, list]:
    """``cfg.reduced()`` at f32, 2 microbatches: 3 steps on the card
    (kernels) against 3 on the CPU (plain versions) from the same weights,
    losses to rtol 1e-4 (f32 on both; sums run in another order on the
    card). Returns the card's and the CPU's losses."""
    from repro_torch.core.recovery import (checkpoint_from_state,
                                           state_from_checkpoint)
    from repro_torch.train.loop import train
    from repro_torch.train.step import make_train_state
    cfg = cfg.reduced(compute_dtype="float32", microbatches=2)
    init = checkpoint_from_state(make_train_state(cfg, seed=5, device="cpu"))
    losses = {}
    for dev in ("cpu", "cuda"):
        _, stats = train(cfg, steps=3, batch=4, seq=64, device=dev, seed=5,
                         state=state_from_checkpoint(init, dev))
        losses[dev] = np.array(stats.losses)
    lc, lg = losses["cpu"], losses["cuda"]
    check(lg.shape == (3,) and np.all(np.isfinite(lg)),
          f"{what}: reduced losses {lg}")
    check(np.allclose(lg, lc, rtol=1e-4, atol=0),
          f"{what}: reduced card losses {lg} vs CPU {lc} beyond rtol 1e-4")
    return lg.tolist(), lc.tolist()


def small_full_width() -> dict:
    """tinyllama-1.1b at full width, SMALL_LAYERS layers, f32 compute, on
    the card: finite losses, the mma.sync flash kernel launched 2 x layers
    x microbatches a step (forward and the remat recompute), and the first
    step's loss equal, to rtol 1e-4, to a forward of the same params and
    batch on the CPU (plain versions). Returns the run's launch counts."""
    from repro_torch import configs
    from repro_torch.core.recovery import (checkpoint_from_state,
                                           state_from_checkpoint)
    from repro_torch.data.synthetic import SyntheticStream, device_batch
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train.loop import train
    from repro_torch.train.step import make_train_state
    cfg = dataclasses.replace(configs.get("tinyllama-1.1b"),
                              num_layers=SMALL_LAYERS,
                              compute_dtype="float32", microbatches=1)
    run = SMALL_RUN
    init = checkpoint_from_state(make_train_state(cfg, seed=run["seed"],
                                                  device="cpu"))
    ops.reset_launch_counts()
    _, stats = train(cfg, steps=run["steps"], batch=run["batch"],
                     seq=run["seq"], device="cuda", seed=run["seed"],
                     state=state_from_checkpoint(init, "cuda"))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    lg = np.array(stats.losses)
    check(lg.shape == (run["steps"],) and np.all(np.isfinite(lg)),
          f"small: full-width losses {lg}")
    want = 2 * cfg.num_layers * cfg.microbatches * stats.steps
    check(launches["flash_attention_mma"] == want,
          f"small: mma.sync flash launched {launches['flash_attention_mma']}"
          f" times at full width, not {want}")
    check(launches["flash_attention_bwd"] == 0,
          f"small: the bf16 flash backward launched "
          f"{launches['flash_attention_bwd']} times on the f32 path")
    check(launches["flash_attention_wgmma"] == 0,
          f"small: wgmma flash launched {launches['flash_attention_wgmma']} "
          f"times on the f32 path")
    t0 = time.perf_counter()
    batch = device_batch(SyntheticStream(cfg, run["batch"], run["seq"],
                                         seed=run["seed"]).batch_at(0), "cpu")
    with torch.no_grad():
        lc = float(registry.loss_fn(init["params"], cfg, batch))
    cpu_s = time.perf_counter() - t0
    check(math.isclose(lg[0], lc, rel_tol=1e-4, abs_tol=0.0),
          f"small: full-width first loss {lg[0]} on the card vs {lc} on the "
          f"CPU beyond rtol 1e-4")
    del init, batch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"small: {cfg.name} at full width, {cfg.num_layers} layers, f32, "
          f"batch {run['batch']} x seq {run['seq']}: card losses "
          f"{lg.tolist()}, first vs the CPU forward {lc} (rtol 1e-4; CPU "
          f"{cpu_s:.1f} s), flash launches {launches}", flush=True)
    return launches


# -- phase 4 -----------------------------------------------------------------

def phase_main(cfg, steps: int = 6) -> tuple[dict, dict]:
    from repro_torch.core.channel import InProcessChannel
    from repro_torch.core.recovery import FailurePlan
    from repro_torch.kernels import ops
    from repro_torch.train.loop import train
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, stats = train(cfg, steps=steps, channel=InProcessChannel(),
                         failure_plan=FailurePlan((4,)), seed=0,
                         device="cuda", **MAIN_RUN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    shadow = stats.checkpointer.shadow
    sst = shadow.stats()
    ckpt = shadow.consolidate()
    shadow.shutdown()

    check(all(math.isfinite(x) for x in stats.losses),
          f"main: non-finite loss {stats.losses}")
    check(stats.recoveries == 1, f"main: recoveries {stats.recoveries} != 1")
    check(ckpt["step"] == steps, f"main: checkpoint at {ckpt['step']}")
    for tree in ("params", "mu", "nu"):
        ours = getattr(state, tree)
        check(set(ckpt[tree]) == set(ours), f"main: {tree} leaf names differ")
        for k, t in ours.items():
            check(torch.equal(ckpt[tree][k].to(t.device), t),
                  f"main: checkpoint {tree}[{k}] not bitwise equal")
    ran = stats.steps
    for name, n in launches.items():
        if name != "flash_attention_mma":
            check(n > 0, f"main: kernel {name} never launched")
    # forward and remat recompute, per layer and microbatch, every step
    want = 2 * cfg.num_layers * cfg.microbatches * ran
    check(launches["flash_attention_wgmma"] == want,
          f"main: tensor-core flash launched "
          f"{launches['flash_attention_wgmma']} times, not {want}")
    # one backward per layer and microbatch, every step
    check(launches["flash_attention_bwd"] == want // 2,
          f"main: flash backward launched "
          f"{launches['flash_attention_bwd']} times, not {want // 2}")
    check(launches["flash_attention_mma"] == 0,
          f"main: mma.sync flash launched {launches['flash_attention_mma']} "
          f"times on the bf16 path")
    n_params = sum(t.numel() for t in state.params.values())
    batch, seq = MAIN_RUN["batch"], MAIN_RUN["seq"]
    out = {
        "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "params": n_params, "batch": batch, "seq": seq,
        "microbatches": cfg.microbatches, "steps": steps,
        "steps_run": ran, "recoveries": stats.recoveries,
        "recovered_at": stats.recovered_at,
        "losses": stats.losses,
        "step_ms": stats.steady_iter * 1e3,
        "step_ms_all": [t * 1e3 for t in stats.iter_times],
        "tokens_per_s": batch * seq / stats.steady_iter,
        "capture_ms": float(np.median(stats.capture_times)) * 1e3,
        "stall_ms": float(np.median(stats.stall_times)) * 1e3,
        "shadow_mean_apply_ms": sst.mean_apply_s * 1e3,
        "shadow_max_apply_ms": sst.max_apply_s * 1e3,
        "shadow_lag": sst.lag,
        "shadow_max_queue_depth": sst.max_queue_depth,
        "peak_mem_gb": peak / 1e9,
        "wall_s": wall,
        "launches": launches,
        "checkpoint_bitwise_equal": True,
    }
    print(f"main: {cfg.name} {cfg.num_layers}L, {ran} steps run, losses "
          f"{[round(x, 4) for x in stats.losses]}, checkpoint at step "
          f"{ckpt['step']} bitwise equal to the trainer", flush=True)
    return out, launches


# -- phase 4b ----------------------------------------------------------------
# The data-parallel path on the card: train(rules=) over a one-rank NCCL
# world (NCCL refuses two ranks on one card, and a gloo world would time
# host copies), held bitwise against today's train() on the same cut:
# tinyllama-1.1b at full width, RANKS_LAYERS of its 22 layers, MAIN_RUN's
# batch and shadow, a failure at step 4; then the state gather that hands
# a checkpointer over ranks the whole state, on that run's state. The
# n > 1 schedules are held on gloo ranks by the CPU tests.
RANKS_LAYERS, RANKS_STEPS = 2, 6


def card_name_power() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def identity_at_model_one(mesh, cfg):
    """The tensor-parallel Functions on CUDA tensors over the model group
    of a one-rank mesh: each hands back its input and passes its
    gradient as it is, and the layers' context is None there (so
    train(rules=) runs the plain layers, bitwise train())."""
    from repro_torch.dist import tensor_parallel as TP
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.models import registry
    tp = TP.ModelParallel(mesh, ("wq",))
    x = torch.randn(4, 8, device="cuda", requires_grad=True)
    for name, fn in (("copy_to_model", TP.copy_to_model),
                     ("reduce_from_model", TP.reduce_from_model),
                     ("gather_from_model",
                      lambda t, tp: TP.gather_from_model(t, -1, tp)),
                     ("gather_rows", lambda t, tp: TP.gather_rows(t, 1, tp))):
        y = fn(x, tp)
        (g,) = torch.autograd.grad(y, x, torch.ones_like(x))
        check(y is x and torch.equal(g, torch.ones_like(x)),
              f"ranks: {name} is not the identity at model extent 1")
    check(TP.context(ShardingRules(mesh), registry.param_specs(cfg))
          is None, "ranks: a context at model extent 1")


def serving_at_model_one(mesh, cut) -> dict:
    """Serving under the rules of the one-rank mesh bitwise serving with
    no rules: phase 9's dense batch and prompt at ``cut``'s depth, then
    SERVE_YARD_STEPS greedy decode steps through ``build_decode_step``;
    the prefill logits, every token and the cache equal bit for bit (at
    model extent 1 serving takes no context and calls no collective)."""
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.launch.serve import max_seq_for
    from repro_torch.models import registry
    from repro_torch.train.step import build_decode_step, serving_params
    _, _, b, prompt, _ = SERVE_DENSE
    rules = ShardingRules(mesh)
    check(registry.serving_tp(cut, rules) is None,
          "ranks: a serving context at model extent 1")
    max_seq = max_seq_for(cut, prompt, SERVE_YARD_STEPS)
    full = registry.init_params(cut, 0, "cuda")
    toks, _ = serve_inputs(cut, b, prompt, torch.bfloat16, "cuda")
    runs = {}
    for label, r in (("rules", rules), ("plain", None)):
        params = serving_params(cut, full, r)
        cache, logits = registry.prefill(params, cut, toks, max_seq, rules=r)
        tok = registry.greedy_token(cut, logits, r)
        out, step = [tok], build_decode_step(cut, r)
        for _ in range(SERVE_YARD_STEPS):
            tok, cache = step(params, cache, tok)
            out.append(tok)
        runs[label] = (logits, cache, torch.cat(out, dim=1))
        del params
    (la, ca, ta), (lb, cb, tb) = runs["rules"], runs["plain"]
    check(torch.equal(la, lb) and torch.equal(ta, tb)
          and set(ca) == set(cb) and ca["length"] == cb["length"] == max_seq
          and torch.equal(ca["k"], cb["k"]) and torch.equal(ca["v"], cb["v"]),
          "ranks: serving on the one-rank mesh differs from serving with no "
          "rules")
    del runs, full
    _free()
    return {"layers": cut.num_layers, "batch": b, "prompt": prompt,
            "decode_steps": SERVE_YARD_STEPS, "bitwise_equal": True,
            "sample_tokens": ta[0].tolist()}


# the families held bitwise on the (1, 1) mesh (phase 4b): phase 8's cuts at
# ONE_LAYERS layers (whisper: and encoder layers), FAMILY_BATCH rows,
# ONE_STEPS training steps; serving phase 9's batch and prompt and
# SERVE_YARD_STEPS decode steps
ONE_FAMILIES, ONE_LAYERS, ONE_STEPS = ("mamba2", "whisper"), 2, 2


def families_at_model_one(mesh) -> dict:
    """Training and serving of each of ONE_FAMILIES under the rules of the
    one-rank mesh bitwise the same with no rules: one microbatch's loss
    and gradients (`registry.loss_fn`, which takes the family's context,
    None at model extent 1), ONE_STEPS steps of the built train step,
    then prefill and greedy decode (logits, tokens and every cache
    leaf)."""
    from repro_torch.data.synthetic import SyntheticStream, device_batch
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.launch.serve import max_seq_for
    from repro_torch.models import registry
    from repro_torch.optim.functional import OptimizerConfig, init_state
    from repro_torch.train.step import (build_decode_step, build_train_step,
                                        serving_params)
    out = {}
    for label in ONE_FAMILIES:
        cut = dataclasses.replace(
            family_cfg(label), num_layers=ONE_LAYERS,
            encoder_layers=min(family_cfg(label).encoder_layers, ONE_LAYERS))
        seq = FAMILY_CELLS[label][2]
        rules = ShardingRules(mesh, fsdp=cut.fsdp)
        check(registry.family_module(cut).tp_context(cut, rules) is None
              and registry.serving_tp(cut, rules) is None,
              f"ranks: {label} has a context at model extent 1")
        full = registry.init_params(cut, 0, "cuda")
        stream = SyntheticStream(cut, FAMILY_BATCH, seq, seed=0)
        batch = device_batch(stream.batch_at(0), "cuda")
        one = {k: v[:FAMILY_BATCH // cut.microbatches]
               for k, v in batch.items()}
        runs = {}
        for name, r in (("rules", rules), ("plain", None)):
            leaves = {k: p.clone().requires_grad_(True)
                      for k, p in full.items()}
            loss = registry.loss_fn(leaves, cut, one, rules=r)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            del leaves
            state = init_state({k: p.clone() for k, p in full.items()})
            step = build_train_step(cut, OptimizerConfig(), lambda t: 1e-3,
                                    r)
            for t in range(ONE_STEPS):
                state, _, _ = step(state, device_batch(stream.batch_at(t),
                                                       "cuda"))
            _, _, b, prompt, _ = serve_cells()[label]
            params = serving_params(cut, full, r)
            toks, extra = serve_inputs(cut, b, prompt, torch.bfloat16,
                                       "cuda")
            max_seq = max_seq_for(cut, prompt, SERVE_YARD_STEPS)
            cache, logits = registry.prefill(params, cut, toks, max_seq,
                                             rules=r, **extra)
            tok = registry.greedy_token(cut, logits, r)
            toks_out, dec = [tok], build_decode_step(cut, r)
            for _ in range(SERVE_YARD_STEPS):
                tok, cache = dec(params, cache, tok)
                toks_out.append(tok)
            runs[name] = (loss, grads, state, logits, cache,
                          torch.cat(toks_out, dim=1))
            del params, step
        (la, ga, sa, pa, ca, ta), (lb, gb, sb, pb, cb, tb) = \
            runs["rules"], runs["plain"]
        same = (torch.equal(la, lb)
                and all(torch.equal(x, y) for x, y in zip(ga, gb))
                and all(torch.equal(t, getattr(sb, tree)[k])
                        for tree in ("params", "mu", "nu")
                        for k, t in getattr(sa, tree).items())
                and torch.equal(pa, pb) and torch.equal(ta, tb)
                and set(ca) == set(cb) and ca["length"] == cb["length"]
                and all(torch.equal(ca[k], cb[k]) for k in cb
                        if torch.is_tensor(cb[k])))
        check(same, f"ranks: {label} on the one-rank mesh differs from no "
                    f"rules (training or serving)")
        out[label] = {"layers": ONE_LAYERS, "batch": FAMILY_BATCH,
                      "seq": seq, "steps": ONE_STEPS,
                      "serve": [b, prompt, SERVE_YARD_STEPS],
                      "loss": float(la.detach()), "bitwise_equal": True,
                      "sample_tokens": ta[0].tolist()}
        del runs, full, batch, one
        _free()
    return out


def gather_on_card(cut, rules, state) -> dict:
    """The state gather over ranks (`RankStateGather`, the state_fn of a
    checkpointer over ranks) on the one-rank NCCL mesh, after a step:
    bitwise `checkpoint_from_state`, one pack launch a tree, and its added
    peak device bytes at most one tree's share (here the whole tree).
    Times the one call of each that the check makes, host clock from a
    synchronised card to the host tensors."""
    from repro_torch.core.recovery import checkpoint_from_state
    from repro_torch.kernels import ops
    from repro_torch.train.loop import RankStateGather
    from repro_torch.train.step import state_sharding
    t_check = time.perf_counter()
    trees = ("params", "mu", "nu")
    gather = RankStateGather(state_sharding(cut, rules),
                             torch.device("cuda"))
    _free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = gather(state)
    torch.cuda.synchronize()
    gather_ms = (time.perf_counter() - t0) * 1e3
    added = torch.cuda.max_memory_allocated() - base
    packs = ops.launch_counts()["bucket_pack"]
    t0 = time.perf_counter()
    want = checkpoint_from_state(state)
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(packs == len(trees),
          f"ranks: gather: {packs} pack launches, want one a tree")
    check(got["step"] == want["step"] and all(
        got[t].keys() == want[t].keys() for t in trees),
        "ranks: gather: not the checkpoint's leaves")
    for t in trees:
        for k, x in want[t].items():
            check(got[t][k].device.type == "cpu"
                  and got[t][k].dtype == x.dtype
                  and torch.equal(got[t][k], x),
                  f"ranks: gather: {t}[{k}] not bitwise "
                  f"checkpoint_from_state")
    largest = max(sum(x.numel() * x.element_size()
                      for x in getattr(state, t).values()) for t in trees)
    check(0 < added <= largest,
          f"ranks: gather: added peak {added} B, one tree is {largest} B")
    out = {"bitwise_equal": True, "pack_launches": packs,
           "gather_ms": gather_ms, "checkpoint_from_state_ms": plain_ms,
           "added_peak_bytes": added, "largest_tree_bytes": largest,
           "check_s": time.perf_counter() - t_check,
           "card": card_name_power()}
    print(f"ranks gather: RankStateGather on the one-rank NCCL mesh, "
          f"{cut.name} {cut.num_layers}L, bitwise checkpoint_from_state, "
          f"{packs} pack launches (one a tree); {out['gather_ms']:.2f} ms "
          f"vs checkpoint_from_state {out['checkpoint_from_state_ms']:.2f} "
          f"ms; added peak device bytes {added} (largest tree {largest}); "
          f"the check {out['check_s']:.2f} s; {out['card']}", flush=True)
    return out


def phase_ranks(cfg) -> dict:
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.core.channel import InProcessChannel
    from repro_torch.core.recovery import FailurePlan
    from repro_torch.dist.sharding import Mesh, ShardingRules
    from repro_torch.kernels import ops
    from repro_torch.train.loop import train
    cut = dataclasses.replace(cfg, num_layers=RANKS_LAYERS)
    store = tempfile.mkdtemp()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        store, "store"), rank=0, world_size=1)
    runs = {}
    try:
        mesh = Mesh.over_ranks((1, 1), ("data", "model"))
        check(mesh.device_mesh is not None and mesh.device_type == "cuda"
              and mesh.coords == {"data": 0, "model": 0},
              f"ranks: mesh {mesh} at {mesh.coords}")
        identity_at_model_one(mesh, cut)
        serve_one = serving_at_model_one(mesh, cut)
        fam_one = families_at_model_one(mesh)
        for label, kw in (("rules", {"rules": ShardingRules(mesh)}),
                          ("plain", {})):
            _free()
            ops.reset_launch_counts()
            state, stats = train(cut, steps=RANKS_STEPS,
                                 channel=InProcessChannel(),
                                 failure_plan=FailurePlan((4,)), seed=0,
                                 device="cuda", **MAIN_RUN, **kw)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            shadow = stats.checkpointer.shadow
            ckpt = shadow.consolidate()
            shadow.shutdown()
            check(stats.recoveries == 1 and stats.recovered_at == [3]
                  and ckpt["step"] == RANKS_STEPS,
                  f"ranks: {label}: recovered at {stats.recovered_at}, "
                  f"checkpoint at {ckpt['step']}")
            for tree in ("params", "mu", "nu"):
                for k, t in getattr(state, tree).items():
                    check(torch.equal(ckpt[tree][k].to(t.device), t),
                          f"ranks: {label}: checkpoint {tree}[{k}] not "
                          f"bitwise the trainer's")
            want = 2 * cut.num_layers * cut.microbatches * stats.steps
            check(launches["flash_attention_wgmma"] == want
                  and launches["flash_attention_bwd"] == want // 2
                  and launches["flash_attention_mma"] == 0
                  and launches["fused_adamw"] > 0
                  and launches["bucket_pack"] > 0,
                  f"ranks: {label}: launches {launches} (wgmma {want})")
            runs[label] = dict(state=state, stats=stats, ckpt=ckpt,
                               launches=launches)
        gather = gather_on_card(cut, ShardingRules(mesh),
                                runs["rules"]["state"])
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    a, b = runs["rules"], runs["plain"]
    check(a["stats"].losses == b["stats"].losses,
          f"ranks: losses {a['stats'].losses} vs {b['stats'].losses}")
    for tree in ("params", "mu", "nu"):
        for k, t in getattr(a["state"], tree).items():
            check(torch.equal(t, getattr(b["state"], tree)[k]),
                  f"ranks: trainer {tree}[{k}] differs between the runs")
            check(torch.equal(a["ckpt"][tree][k], b["ckpt"][tree][k]),
                  f"ranks: checkpoint {tree}[{k}] differs between the runs")
    out = {"model": cut.name, "layers": cut.num_layers,
           "batch": MAIN_RUN["batch"], "seq": MAIN_RUN["seq"],
           "microbatches": cut.microbatches, "steps": RANKS_STEPS,
           "steps_run": a["stats"].steps, "recovered_at":
           a["stats"].recovered_at, "lost_steps": 0,
           "losses": a["stats"].losses,
           "step_ms": {k: r["stats"].steady_iter * 1e3
                       for k, r in runs.items()},
           "launches": {k: r["launches"] for k, r in runs.items()},
           "bitwise_equal": True, "gather": gather,
           "serving_at_model_one": serve_one,
           "families_at_model_one": fam_one, "card": card_name_power()}
    print(f"ranks: one-rank NCCL train(rules=) vs train(), {cut.name} "
          f"{cut.num_layers}L: step {out['step_ms']['rules']:.2f} vs "
          f"{out['step_ms']['plain']:.2f} ms, launches {out['launches']}, "
          f"losses, states and checkpoints bitwise equal; serving on the "
          f"(1, 1) mesh ({serve_one['batch']} x {serve_one['prompt']} + "
          f"{serve_one['decode_steps']}) bitwise serving with no rules; "
          f"training and serving of {', '.join(fam_one)} at "
          f"{ONE_LAYERS} layers on the (1, 1) mesh bitwise no rules; "
          f"{out['card']}", flush=True)
    return out


# -- phase 4c ----------------------------------------------------------------

# The dry run's cells: tinyllama-1.1b at full width and depth, every shape,
# both production meshes (long_500k is skipped for a dense model); each
# traced on the CPU in a subprocess that sees no card, since a fake world
# must not share a process with phase 4b's NCCL one.
DRYRUN_ARCH = "tinyllama-1.1b"
DRYRUN_TIMEOUT_S = 300
# the yardstick's tolerance: predicted bytes (arguments + temporaries)
# against the card's peak allocation over one step
DRYRUN_MEMORY_RTOL = 0.25


def _start_dryrun(out: str, mesh_flags: list) -> subprocess.Popen:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         DRYRUN_ARCH, *mesh_flags, "--out", out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def dryrun_yardstick(cfg) -> dict:
    """`analyze_step` at phase 4b's cut on a one-rank mesh beside one real
    step on the card: the predicted bytes (arguments + temporaries)
    within DRYRUN_MEMORY_RTOL of the step's peak allocation (above what
    was allocated before its state was made), and the roofline step no
    longer than the measured one."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import SyntheticStream, device_batch
    from repro_torch.dist.sharding import ShardingRules, make_smoke_mesh
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import Roofline, model_flops_for
    from repro_torch.launch.step_analysis import analyze_step
    from repro_torch.models import registry
    from repro_torch.optim.functional import OptimizerConfig
    from repro_torch.train.step import (abstract_train_state,
                                        build_train_step, make_train_state)
    cut = dataclasses.replace(cfg, num_layers=RANKS_LAYERS)
    shape = ShapeConfig("phase4b", MAIN_RUN["seq"], MAIN_RUN["batch"],
                        "train")
    rules = ShardingRules(make_smoke_mesh("cpu"))
    opt = OptimizerConfig()
    a = analyze_step(build_train_step(cut, opt, lambda s: 1e-3, rules),
                     abstract_train_state(cut, rules),
                     registry.input_specs(cut, shape, rules))
    del a["result"]
    rf = Roofline(arch=cut.name, shape=shape.name, mesh="one rank", chips=1,
                  flops_per_device=a["flops_per_device"],
                  bytes_per_device=a["bytes_per_device"],
                  collective_bytes_per_device=a["collective_bytes_per_device"],
                  model_flops=model_flops_for(cut, shape), per_collective={})
    predicted = a["memory"]["argument_bytes"] + a["memory"]["temp_bytes"]

    _free()
    base = torch.cuda.memory_allocated()
    state = make_train_state(cut, 0, "cuda")
    batch = device_batch(SyntheticStream(cut, MAIN_RUN["batch"],
                                         MAIN_RUN["seq"]).batch_at(0), "cuda")
    step = build_train_step(cut, opt, lambda s: 1e-3)
    out = step(state, batch)             # warm-up: cuBLAS handles, workspace
    del out
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = step(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = ops.launch_counts()
    del out, state, batch
    _free()
    err = predicted / peak - 1.0
    flash = 2 * cut.num_layers * cut.microbatches      # forward and remat
    check(launches["flash_attention_wgmma"] == flash
          and launches["flash_attention_bwd"] == flash // 2
          and launches["fused_adamw"] == a["kernels"]["fused_adamw"]["calls"]
          and a["kernels"]["flash_attention"]["calls"] == flash
          and a["kernels"]["flash_attention_bwd"]["calls"] == flash // 2,
          f"dryrun: the card's step launched {launches}, the analysis "
          f"recorded {a['kernels']} (flash {flash})")
    check(abs(err) <= DRYRUN_MEMORY_RTOL,
          f"dryrun: predicted {predicted} bytes vs the card's peak {peak} "
          f"({err:+.1%}; tolerance {DRYRUN_MEMORY_RTOL:.0%})")
    check(rf.step_time_s <= step_s,
          f"dryrun: roofline step {rf.step_time_s * 1e3:.2f} ms beats the "
          f"measured {step_s * 1e3:.2f} ms")
    return {"model": cut.name, "layers": cut.num_layers,
            "batch": MAIN_RUN["batch"], "seq": MAIN_RUN["seq"],
            "microbatches": cut.microbatches,
            "predicted_bytes": predicted, "memory": a["memory"],
            "peak_bytes": peak, "memory_err": err,
            "flops": a["flops_per_device"], "bytes": a["bytes_per_device"],
            "roofline": {k: v for k, v in rf.row().items()
                         if k in ("compute_s", "memory_s", "bound",
                                  "step_time_s")},
            "step_ms": step_s * 1e3, "launches": launches,
            "roofline_share": rf.step_time_s / step_s}


# The rank yardsticks: rank 0 of a mesh in a fake world of its size. Their
# collectives move nothing on the card, so their values are not checked:
# only the local shapes, the peak, the time and the launches. The
# tensor-parallel ones run on a (1, 4) ("data", "model") mesh, the FSDP
# one on (4, 1).
TP_YARD_MESH = (1, 4)
FSDP_YARD_MESH = (4, 1)
# timed steps after two warm-up ones (the step is host-paced: a quarter of
# the one-rank step's device work, the same number of launches); the
# median is reported
TP_YARD_STEPS = 3
# the FSDP yardstick: arctic at phase 8's width, 4 layers, 8 x 2048 (two
# rows a rank) in 2 microbatches
FSDP_YARD_LAYERS, FSDP_YARD_BATCH = 4, 8
# the families whose tensor-parallel rank yardsticks run at phase 8's cut
FAMILY_YARDS = ("mamba2", "zamba2", "whisper", "vit")


def rank_yard_cells() -> dict:
    """label: (config cut, global batch, token seq, mesh) of each
    yardstick: tinyllama at phase 4b's cut (its 32 heads and 4 kv heads
    divide 4, so every leaf the spec maps to model is cut on whole
    heads), and arctic at phase 8's (56 heads and 8 kv heads: 14 and 2 a
    rank; 8 experts: 2 a rank), each on TP_YARD_MESH; and ``fsdp``:
    arctic at phase 8's width on FSDP_YARD_MESH with FSDP, every ``wemb``
    dim cut over the 4 data ranks and gathered a layer at a time; and
    each of FAMILY_YARDS at phase 8's cut on TP_YARD_MESH (mamba2's 80 SSD
    heads 20 a rank; zamba2's 64 and its shared block's 32:32 heads, 16
    and 8:8; whisper's 16:16 heads 4:4 in its encoder, decoder and
    cross-attention; the ViT's 16:16 heads 4:4 at d 80)."""
    from repro_torch import configs
    cells = {"tinyllama": (dataclasses.replace(
                 configs.get(DRYRUN_ARCH), num_layers=RANKS_LAYERS),
                 MAIN_RUN["batch"], MAIN_RUN["seq"], TP_YARD_MESH),
             "arctic": (family_cfg("arctic"), FAMILY_BATCH,
                        FAMILY_CELLS["arctic"][2], TP_YARD_MESH),
             "fsdp": (dataclasses.replace(family_cfg("arctic"),
                                          num_layers=FSDP_YARD_LAYERS,
                                          fsdp=True),
                      FSDP_YARD_BATCH, FAMILY_CELLS["arctic"][2],
                      FSDP_YARD_MESH)}
    for label in FAMILY_YARDS:
        cells[label] = (family_cfg(label), FAMILY_BATCH,
                        FAMILY_CELLS[label][2], TP_YARD_MESH)
    return cells


def rank_local(cut, mesh):
    """``cut`` with the heads rank 0 of ``mesh`` attends over (every
    yardstick cuts q and kv heads on whole heads, and the SSD heads of
    the ssm and hybrid families on whole heads too); an attention-free
    model has no attention heads to cut."""
    m = mesh[1]
    if cut.family in ("ssm", "hybrid"):
        check(cut.ssm_heads % m == 0,
              f"dryrun: {cut.name}'s {cut.ssm_heads} SSD heads do not split "
              f"over {m} model ranks")
    if cut.family == "ssm":
        return cut
    check(cut.num_heads % m == 0 and cut.num_kv_heads % m == 0,
          f"dryrun: {cut.name}'s heads do not split over {m} model ranks")
    return dataclasses.replace(cut, num_heads=cut.num_heads // m,
                               num_kv_heads=cut.num_kv_heads // m)


def rank_yardstick(label: str) -> dict:
    """`analyze_step` for rank 0 of the mesh of the yardstick ``label``
    of `rank_yard_cells` beside that rank's local step on the card (the
    fake backend takes CUDA tensors too; the median of TP_YARD_STEPS
    steps, the peak over them): every local leaf the shape of its
    stand-in, the predicted arguments + temporaries within
    DRYRUN_MEMORY_RTOL of the step's peak allocation, the roofline's
    compute and memory terms no longer than the measured step (its
    collective term is reported beside them: the fake collectives cost
    the card nothing), the wgmma flash kernel launched as often as the
    model implies (twice a microbatch per attention call: the forward and
    the remat recompute; none for mamba2), each call at a local shape
    `attention_shapes` predicts (phase 2 holds them), and the flash
    kernel and AdamW as often as the analysis counts them."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import SyntheticStream, device_batch
    from repro_torch.dist.sharding import Mesh, ShardingRules
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import fake_world
    from repro_torch.launch.roofline import Roofline, model_flops_for
    from repro_torch.launch.step_analysis import analyze_step
    from repro_torch.models import registry
    from repro_torch.optim.functional import OptimizerConfig
    from repro_torch.train.step import (abstract_train_state,
                                        build_train_step, make_train_state)
    t_start = time.perf_counter()
    cut, batch_size, seq, mesh = rank_yard_cells()[label]
    shape = ShapeConfig(f"rank-{label}", seq, batch_size, "train")
    opt = OptimizerConfig()
    names = ("data", "model")
    with fake_world(math.prod(mesh)):
        rules = ShardingRules(Mesh.over_ranks(mesh, names, device="cpu"),
                              fsdp=cut.fsdp)
        stand_in = abstract_train_state(cut, rules)
        a = analyze_step(build_train_step(cut, opt, lambda s: 1e-3, rules),
                         stand_in, registry.input_specs(cut, shape, rules))
        del a["result"]
        rf = Roofline(
            arch=cut.name, shape=shape.name,
            mesh=f"{mesh[0]}x{mesh[1]} rank 0", chips=math.prod(mesh),
            flops_per_device=a["flops_per_device"],
            bytes_per_device=a["bytes_per_device"],
            collective_bytes_per_device=a["collective_bytes_per_device"],
            model_flops=model_flops_for(cut, shape),
            per_collective=a["per_collective"])
        predicted = a["memory"]["argument_bytes"] + a["memory"]["temp_bytes"]

        card = ShardingRules(Mesh.over_ranks(mesh, names), fsdp=cut.fsdp)
        _free()
        base = torch.cuda.memory_allocated()
        state = make_train_state(cut, 0, "cuda", card)
        for tree in ("params", "mu", "nu"):
            for k, t in getattr(state, tree).items():
                check(t.shape == getattr(stand_in, tree)[k].shape,
                      f"dryrun: {label} {tree}[{k}] {tuple(t.shape)} on "
                      f"the card, {tuple(getattr(stand_in, tree)[k].shape)} "
                      f"traced")
        batch = device_batch(SyntheticStream(cut, batch_size,
                                             seq).batch_at(0),
                             "cuda", card, cut.microbatches)
        step = build_train_step(cut, opt, lambda s: 1e-3, card)
        for _ in range(2):                # warm-up: the host-paced step
            out = step(state, batch)      # settles on its second call
            del out
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, flash_fn = [], ops.flash_attention

        def recording(q, k, v, causal, q_offset=0):
            seen[(*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                  q.shape[3], q.dtype, causal)] += 1
            return flash_fn(q, k, v, causal, q_offset)
        ops.flash_attention = recording
        try:
            for i in range(TP_YARD_STEPS):
                ops.reset_launch_counts()
                seen = collections.Counter()      # the last step's calls
                t0 = time.perf_counter()
                out = step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                del out
        finally:
            ops.flash_attention = flash_fn
        step_s = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() - base
        launches = ops.launch_counts()
        del state, batch, step
        _free()
    err = predicted / peak - 1.0
    local = attention_shapes(rank_local(cut, mesh), seq,
                             batch_size // mesh[0] // cut.microbatches)
    shapes = {k: 2 * cut.microbatches * n for k, n in local.items()}
    flash = sum(shapes.values())
    local_s = max(rf.compute_s, rf.memory_s)
    bwd = a["kernels"].get("flash_attention_bwd", {}).get("calls", 0)
    check(launches["flash_attention_wgmma"] == flash
          and launches["flash_attention_bwd"] == bwd == flash // 2
          and launches["flash_attention_mma"] == 0
          and a["kernels"].get("flash_attention", {}).get("calls", 0) == flash
          and launches["fused_adamw"] == a["kernels"]["fused_adamw"]["calls"],
          f"dryrun: {label} step launched {launches}, the analysis "
          f"recorded {a['kernels']} (flash {flash})")
    check(dict(seen) == shapes,
          f"dryrun: {label} flash calls by shape {dict(seen)}, not the "
          f"predicted {shapes}")
    check(abs(err) <= DRYRUN_MEMORY_RTOL,
          f"dryrun: {label} predicted {predicted} bytes vs the card's "
          f"peak {peak} ({err:+.1%}; tolerance {DRYRUN_MEMORY_RTOL:.0%})")
    check(local_s <= step_s,
          f"dryrun: {label} roofline {local_s * 1e3:.2f} ms (compute and "
          f"memory) beats the measured {step_s * 1e3:.2f} ms")
    return {"model": cut.name, "layers": cut.num_layers,
            "experts": cut.num_experts, "mesh": list(mesh),
            "fsdp": cut.fsdp, "batch": batch_size, "seq": seq,
            "microbatches": cut.microbatches,
            "predicted_bytes": predicted, "memory": a["memory"],
            "peak_bytes": peak, "memory_err": err,
            "flops": a["flops_per_device"], "bytes": a["bytes_per_device"],
            "collective_bytes": a["collective_bytes_per_device"],
            "per_collective": a["per_collective"],
            "roofline": {k: v for k, v in rf.row().items()
                         if k in ("compute_s", "memory_s", "collective_s",
                                  "bound", "step_time_s")},
            "step_ms": step_s * 1e3,
            "step_ms_each": [t * 1e3 for t in times], "launches": launches,
            "flash_by_shape": {flash_key(k): n for k, n in seen.items()},
            "local_roofline_share": local_s / step_s,
            "seconds": time.perf_counter() - t_start}


def flash_key(shape: tuple) -> str:
    """A flash call's (b, sq, skv, h, kv, d, dtype, causal) as one
    string, for a JSON key."""
    *dims, dt, causal = shape
    return "x".join(map(str, dims)) + (
        f":{str(dt).removeprefix('torch.')}:"
        f"{'causal' if causal else 'full'}")


def _print_rank_yardstick(kind: str, label: str, tp: dict,
                          extra: str = "") -> None:
    print(f"dryrun: {kind} yardstick {label} ({tp['model']}), "
          f"rank 0 of {tp['mesh']}, {tp['layers']} layers, {tp['batch']} x "
          f"{tp['seq']}: predicted {tp['predicted_bytes'] / 1e9:.3f} GB, "
          f"card peak {tp['peak_bytes'] / 1e9:.3f} GB "
          f"({tp['memory_err']:+.1%}); roofline compute "
          f"{tp['roofline']['compute_s'] * 1e3:.2f} ms, memory "
          f"{tp['roofline']['memory_s'] * 1e3:.2f} ms, collective "
          f"{tp['roofline']['collective_s'] * 1e3:.2f} ms (not run: the "
          f"fake collectives move nothing); measured local step "
          f"{tp['step_ms']:.2f} ms{extra}; launches {tp['launches']}; "
          f"{tp['seconds']:.1f} s in all; {card_name_power()}", flush=True)


# the serving rank yardsticks: rank 0 of a fake TP_YARD_MESH world serving
# through prefill and SERVE_YARD_STEPS greedy decode steps over model:
# phase 9's dense run (SERVE_DENSE: tinyllama-1.1b at full width and
# depth, batch 8 x prompt 2048; 8 q heads and 1 kv head a rank), and
# phase 9's mamba2 cell (2 layers, batch 4 x prompt 2048; 20 of its 80
# SSD heads a rank)
SERVE_YARD_STEPS = 8


def serve_yard_cells() -> dict:
    """label: (config, batch, prompt, decode steps, mesh) of each serving
    yardstick."""
    from repro_torch import configs
    cells = {}
    for label, (arch, over, b, prompt, _) in (
            ("tinyllama", SERVE_DENSE),
            ("mamba2", serve_cells()["mamba2"])):
        cells[label] = (dataclasses.replace(configs.get(arch), **over), b,
                        prompt, SERVE_YARD_STEPS, TP_YARD_MESH)
    return cells


def serve_yard_cell() -> tuple:
    """(config, batch, prompt, decode steps, mesh) of the dense serving
    yardstick."""
    return serve_yard_cells()["tinyllama"]


def serve_yardstick(label: str = "tinyllama") -> dict:
    """`analyze_step` of the serving prefill and decode steps for rank 0
    of a (1, 4) mesh in a fake world of 4 ranks beside that rank's own
    serving on the card (its weight slices cast as ``serving_params``
    casts them, its cut of the cache; the fake collectives move nothing,
    so values are not checked), for the cell ``label`` of
    `serve_yard_cells`: every local leaf the shape and dtype of its
    stand-in, the prefill's predicted arguments + temporaries within
    DRYRUN_MEMORY_RTOL of its peak allocation, the prefill's roofline
    compute and memory terms no longer than the measured prefill, the
    wgmma flash kernel once an attention call in prefill (as the
    analysis counts it; mamba2 none) and no kernel in decode; the
    prefill's ms and each decode step's."""
    from repro_torch.dist.sharding import Mesh, ShardingRules
    from repro_torch.kernels import ops
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import fake_world
    from repro_torch.launch.roofline import Roofline, model_flops_for
    from repro_torch.launch.serve import max_seq_for
    from repro_torch.launch.step_analysis import analyze_step
    from repro_torch.models import registry
    from repro_torch.train.step import build_decode_step, serving_params
    t_start = time.perf_counter()
    cfg, b, prompt, steps, mesh = serve_yard_cells()[label]
    max_seq = max_seq_for(cfg, prompt, steps)
    attn = sum(attention_shapes(cfg, prompt).values())
    names = ("data", "model")
    with fake_world(math.prod(mesh)):
        rules = ShardingRules(Mesh.over_ranks(mesh, names, device="cpu"))
        stand_in = serving_params(cfg, registry.abstract_params(cfg, rules))
        meta_tokens = torch.empty((b // mesh[0], prompt), dtype=torch.int64,
                                  device="meta")
        pre = analyze_step(
            lambda p, t: registry.prefill(p, cfg, t, max_seq, rules=rules),
            stand_in, meta_tokens)
        dec = analyze_step(build_decode_step(cfg, rules), stand_in,
                           registry.abstract_cache(cfg, rules, b, max_seq),
                           meta_tokens[:, :1])
        for a in (pre, dec):
            del a["result"]
        rf = Roofline(
            arch=cfg.name, shape="serve-rank prefill",
            mesh=f"{mesh[0]}x{mesh[1]} rank 0", chips=math.prod(mesh),
            flops_per_device=pre["flops_per_device"],
            bytes_per_device=pre["bytes_per_device"],
            collective_bytes_per_device=pre["collective_bytes_per_device"],
            model_flops=model_flops_for(cfg, ShapeConfig(
                "serve-rank", prompt, b, "prefill")),
            per_collective=pre["per_collective"])
        predicted = (pre["memory"]["argument_bytes"]
                     + pre["memory"]["temp_bytes"])

        card = ShardingRules(Mesh.over_ranks(mesh, names))
        _free()
        base = torch.cuda.memory_allocated()
        full = registry.init_params(cfg, 0, "cuda")
        params = serving_params(cfg, full, card)
        del full
        _free()
        for k, t in params.items():
            check(t.shape == stand_in[k].shape
                  and t.dtype == stand_in[k].dtype,
                  f"dryrun: serving {k} {tuple(t.shape)} {t.dtype} on the "
                  f"card, {tuple(stand_in[k].shape)} {stand_in[k].dtype} "
                  f"traced")
        toks, _ = serve_inputs(cfg, b // mesh[0], prompt, torch.bfloat16,
                               "cuda")
        out = registry.prefill(params, cfg, toks, max_seq, rules=card)
        del out                             # warm-up
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        cache, logits = registry.prefill(params, cfg, toks, max_seq,
                                         rules=card)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        prefill_launches = ops.launch_counts()
        decode = build_decode_step(cfg, card)
        tok = registry.greedy_token(cfg, logits, card)
        ops.reset_launch_counts()
        step_ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            tok, cache = decode(params, cache, tok)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        decode_launches = ops.launch_counts()
        length = cache["length"]
        del params, cache, logits, tok, toks, decode
        _free()
    err = predicted / peak - 1.0
    local_s = max(rf.compute_s, rf.memory_s)
    what = f"dryrun: {label} serving yardstick"
    check(prefill_launches["flash_attention_wgmma"] == attn
          == pre["kernels"].get("flash_attention", {}).get("calls", 0)
          and prefill_launches["flash_attention_mma"] == 0,
          f"{what} prefill launched {prefill_launches}, the analysis "
          f"recorded {pre['kernels']} (flash {attn})")
    check(all(n == 0 for n in decode_launches.values())
          and "flash_attention" not in dec["kernels"],
          f"{what} decode launched {decode_launches}, the analysis "
          f"recorded {dec['kernels']}")
    check(length == max_seq, f"{what} cache length {length}, not "
                             f"{max_seq}")
    check(abs(err) <= DRYRUN_MEMORY_RTOL,
          f"{what} predicted {predicted} bytes vs the card's peak {peak} "
          f"({err:+.1%}; tolerance {DRYRUN_MEMORY_RTOL:.0%})")
    check(local_s <= prefill_s,
          f"{what} roofline {local_s * 1e3:.2f} ms (compute and memory) "
          f"beats the measured prefill {prefill_s * 1e3:.2f} ms")
    return {"model": cfg.name, "layers": cfg.num_layers, "mesh": list(mesh),
            "batch": b, "prompt": prompt, "decode_steps": steps,
            "max_seq": max_seq, "predicted_bytes": predicted,
            "memory": pre["memory"], "peak_bytes": peak, "memory_err": err,
            "flops": pre["flops_per_device"],
            "bytes": pre["bytes_per_device"],
            "collective_bytes": pre["collective_bytes_per_device"],
            "per_collective": pre["per_collective"],
            "decode_analysis": {k: dec[k] for k in (
                "flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "per_collective", "memory")},
            "roofline": {k: v for k, v in rf.row().items()
                         if k in ("compute_s", "memory_s", "collective_s",
                                  "bound", "step_time_s")},
            "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_token": statistics.median(step_ms[1:]),
            "decode_ms_each": step_ms,
            "prefill_launches": prefill_launches,
            "decode_launches": decode_launches,
            "local_roofline_share": local_s / prefill_s,
            "seconds": time.perf_counter() - t_start}


def phase_dryrun(cfg) -> dict:
    """The port's dry run of DRYRUN_ARCH on the two production meshes, a
    subprocess each, while the yardstick runs on the card; every traced
    cell ok, train cells with collective bytes, the multi-pod train
    cell's FLOPs per rank half the single-pod one's within 2%."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp()
    recs, procs = [], {}
    try:
        for mesh, flags in (("single", []), ("multi", ["--multi-pod"])):
            out = os.path.join(tmp, f"{mesh}.json")
            procs[out] = _start_dryrun(out, flags)
        yard = dryrun_yardstick(cfg)
        tp = rank_yardstick("tinyllama")
        ep = rank_yardstick("arctic")
        fs = rank_yardstick("fsdp")
        fam = {label: rank_yardstick(label) for label in FAMILY_YARDS}
        sv = serve_yardstick()
        sv_ssm = serve_yardstick("mamba2")
        for out, proc in procs.items():
            log, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            check(proc.returncode == 0,
                  f"dryrun: the CLI exited {proc.returncode}: {log[-3000:]}")
            with open(out) as f:
                recs += json.load(f)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    cells = {}
    for r in recs:
        key = f"{r['shape']}/{r['mesh']}"
        if r["shape"] == "long_500k":
            check(r["status"] == "skipped", f"dryrun: {key}: {r}")
            continue
        check(r["status"] == "ok", f"dryrun: {key}: {r}")
        if r["shape"] == "train_4k":
            check(r["collective_s"] > 0 and r["per_collective"]["send"] > 0,
                  f"dryrun: {key}: no collective bytes")
        check(r["model"] == "tp",
              f"dryrun: {key}: model layout {r['model']}")
        cells[key] = {"model": r["model"],
                      "compute_s": r["compute_s"], "memory_s": r["memory_s"],
                      "collective_s": r["collective_s"], "bound": r["bound"],
                      "useful_flops_ratio": r["useful_flops_ratio"],
                      "hbm_gb_per_rank": r["bytes_per_device_hbm"] / 1e9,
                      "flops_per_rank": r["hlo_flops_total"] / r["chips"],
                      "trace_s": r["trace_s"]}
    check(len(cells) == 6, f"dryrun: cells {sorted(cells)}")
    half = (cells["train_4k/multi"]["flops_per_rank"]
            / cells["train_4k/single"]["flops_per_rank"])
    check(abs(half / 0.5 - 1.0) <= 0.02,
          f"dryrun: multi-pod train FLOPs a rank {half:.4f} of the "
          f"single-pod one's, not half within 2%")
    for key, c in cells.items():
        print(f"dryrun: {DRYRUN_ARCH} {key}: compute {c['compute_s']:.4f} "
              f"memory {c['memory_s']:.4f} collective "
              f"{c['collective_s']:.4f} s, {c['bound']}-bound, useful "
              f"{c['useful_flops_ratio']:.3f}, HBM {c['hbm_gb_per_rank']:.2f} "
              f"GB a rank (a model at H100 peaks, traced on the CPU in "
              f"{c['trace_s']} s)", flush=True)
    print(f"dryrun: yardstick at {yard['layers']} layers, {yard['batch']} x "
          f"{yard['seq']}: predicted {yard['predicted_bytes'] / 1e9:.3f} GB, "
          f"card peak {yard['peak_bytes'] / 1e9:.3f} GB "
          f"({yard['memory_err']:+.1%}); roofline step "
          f"{yard['roofline']['step_time_s'] * 1e3:.2f} ms "
          f"({yard['roofline']['bound']}-bound), measured "
          f"{yard['step_ms']:.2f} ms, share {yard['roofline_share']:.3f}; "
          f"{card_name_power()}", flush=True)
    _print_rank_yardstick("tensor-parallel", "tinyllama", tp,
                          f" against the one-rank {yard['step_ms']:.2f} ms "
                          f"({tp['step_ms'] / yard['step_ms']:.3f})")
    _print_rank_yardstick("tensor-parallel", "arctic", ep)
    _print_rank_yardstick("FSDP", "arctic", fs)
    print(f"dryrun: FSDP yardstick step {fs['step_ms']:.2f} ms, card peak "
          f"{fs['peak_bytes'] / 1e9:.3f} GB; {card_name_power()}",
          flush=True)
    for label, t in fam.items():
        _print_rank_yardstick("tensor-parallel", label, t,
                              f", flash calls by shape {t['flash_by_shape']}")
    for v in (sv, sv_ssm):
        print(f"dryrun: serving yardstick ({v['model']}), rank 0 of "
              f"{v['mesh']}, {v['layers']} layers, {v['batch']} x "
              f"{v['prompt']} + {v['decode_steps']}: prefill predicted "
              f"{v['predicted_bytes'] / 1e9:.3f} GB, card peak "
              f"{v['peak_bytes'] / 1e9:.3f} GB ({v['memory_err']:+.1%}); "
              f"roofline compute {v['roofline']['compute_s'] * 1e3:.2f} ms, "
              f"memory {v['roofline']['memory_s'] * 1e3:.2f} ms, collective "
              f"{v['roofline']['collective_s'] * 1e3:.2f} ms (not run); "
              f"measured prefill {v['prefill_ms']:.2f} ms, decode "
              f"{v['decode_ms_per_token']:.3f} ms a token (median after the "
              f"first); prefill launches {v['prefill_launches']}, decode "
              f"{v['decode_launches']}; {v['seconds']:.1f} s in all; "
              f"{card_name_power()}", flush=True)
    return {"arch": DRYRUN_ARCH, "cells": cells,
            "multi_over_single_flops": half, "yardstick": yard,
            "tp_yardstick": tp, "ep_yardstick": ep, "fsdp_yardstick": fs,
            "family_yardsticks": fam, "serve_yardstick": sv,
            "ssm_serve_yardstick": sv_ssm, "card": card_name_power()}


# -- phase 5 -----------------------------------------------------------------

def _free():
    """Return the card's and the pinned host cache's free blocks."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    empty_host = getattr(torch._C, "_accelerator_emptyHostCache", None) or \
        getattr(torch._C, "_host_emptyCache", None)
    if empty_host is not None:
        empty_host()


def _proc_kb(path: str, key: str):
    """A ``key: N kB`` field of a /proc file, or None."""
    try:
        with open(path) as f:
            for line in f:
                if line.startswith(key + ":"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


class RssPeak:
    """The host's peak resident set of this process over a ``with`` block,
    sampled every 10 ms from /proc/self/statm (``peak`` stays None where
    that file cannot be read)."""

    def __init__(self):
        self.peak = self._read()
        self._stop = threading.Event()

    @staticmethod
    def _read():
        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            return None

    def _poll(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self._read() or 0)

    def __enter__(self):
        if self.peak is not None:
            self._t = threading.Thread(target=self._poll, daemon=True)
            self._t.start()
        return self

    def __exit__(self, *exc):
        if self.peak is not None:
            self._stop.set()
            self._t.join()
            self.peak = max(self.peak, self._read() or 0)
        return False


def _state_equal(a: dict, state, what: str):
    """Host checkpoint ``a`` bitwise equal to the trainer's ``state``."""
    for tree in ("params", "mu", "nu"):
        ours = getattr(state, tree)
        check(set(a[tree]) == set(ours), f"{what}: {tree} leaf names differ")
        for k, t in ours.items():
            check(torch.equal(a[tree][k], t.to("cpu")),
                  f"{what}: {tree}[{k}] not bitwise equal to the trainer")


def ckpt_run(cfg, name: str, extra: tuple) -> dict:
    """One CLI run at full width; checks it and returns its row."""
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.obs.stalls import KNOWN_STAGES
    fail = name != "none"
    argv = ["--arch", cfg.name, "--steps", str(CKPT_STEPS),
            "--batch", str(MAIN_RUN["batch"]), "--seq", str(MAIN_RUN["seq"]),
            "--freq", "1", "--checkpointer", name, "--device", "cuda",
            "--shadow-nodes", str(MAIN_RUN["shadow_nodes"]), *extra]
    if fail:
        argv += ["--fail-at", str(CKPT_FAIL)]
    label = " ".join([name, *extra])
    _free()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with obs.enabled_session() as ob, RssPeak() as rss:
        r = launch.run(argv)
        events = ob.tracer.events()
    launches = ops.launch_counts()
    torch.cuda.synchronize()
    peak_dev = torch.cuda.max_memory_allocated()
    st, ck = r.stats, r.checkpointer

    check(all(math.isfinite(x) for x in st.losses),
          f"{label}: non-finite loss {st.losses}")
    check(st.recoveries == int(fail), f"{label}: recoveries {st.recoveries}")
    total = 0.0
    for sec in ck.stall_stages.values():
        total += sec
    check(ck.stall_total == total, f"{label}: ledger does not sum bit for "
                                   f"bit ({ck.stall_total} != {total})")
    check(set(ck.stall_stages) <= set(KNOWN_STAGES),
          f"{label}: unknown stages {set(ck.stall_stages)}")
    for k in ("fused_adamw", "flash_attention_wgmma", "flash_attention_bwd"):
        check(launches[k] > 0, f"{label}: {k} never launched")
    checkmate = name == "checkmate"
    check((launches["bucket_pack"] > 0) == checkmate,
          f"{label}: bucket_pack launched {launches['bucket_pack']} times")
    ck_steps = [e["args"]["step"] for e in events
                if e["name"] == "checkpoint.on_step"]
    if name == "none":
        check(ck.stall_total == 0.0 and not ck.stall_stages,
              f"none: stall booked {ck.stall_stages}")
    elif checkmate:
        check(st.recovered_at == [CKPT_FAIL - 1],
              f"{label}: recovered at {st.recovered_at}, lost steps")
        shadow = ck.shadow
        sst = shadow.stats()
        if "--compress" not in extra:
            ckpt = shadow.consolidate()
            check(ckpt["step"] == CKPT_STEPS, f"{label}: shadow at "
                                              f"{ckpt['step']}")
            _state_equal(ckpt, r.state, f"{label}: shadow")
            del ckpt
    else:
        latest = ck.restore()
        check(latest["step"] == ck_steps[-1],
              f"{label}: restore() at {latest['step']}, last checkpoint "
              f"at {ck_steps[-1]}")
        if latest["step"] == CKPT_STEPS:
            _state_equal(latest, r.state, f"{label}: restore()")
        del latest
    restore = [e for e in events if e["name"] == "recovery.restore"]
    resume = [e for e in events if e["name"] == "recovery.resume"]
    iters = [(s + c + x) for s, c, x in zip(
        st.iter_times, st.capture_times or [0.0] * st.steps,
        st.stall_times)]
    spans = {}                 # median span ms from step 2 on
    for e in events:
        if e["name"] in MEDIAN_SPANS and e.get("args", {}).get("step", 0) > 1:
            spans.setdefault(e["name"], []).append(e["dur"] / 1e3)
    n_ck = max(ck.n_checkpoints, 1)
    per_ck = {k: v / n_ck * 1e3 for k, v in ck.stall_stages.items()
              if k != "consolidate-wait"}
    tokens = MAIN_RUN["batch"] * MAIN_RUN["seq"]
    iter_ms = statistics.median(iters[1:]) * 1e3
    row = {
        "run": label, "steps_run": st.steps, "report": r.report,
        "layers": (int(extra[extra.index("--layers") + 1])
                   if "--layers" in extra else cfg.num_layers),
        "step_ms": st.steady_iter * 1e3, "iter_ms": iter_ms,
        "tokens_per_s": tokens / iter_ms * 1e3,
        "step_ms_all": [t * 1e3 for t in st.iter_times],
        "iter_ms_all": [t * 1e3 for t in iters],
        "stall_ms_by_stage": {k: v * 1e3 for k, v in ck.stall_stages.items()},
        "stall_ms_per_checkpoint": per_ck,
        "stall_total_ms": ck.stall_total * 1e3,
        "stall_ms_median": statistics.median(st.stall_times[1:]) * 1e3,
        "span_ms_median": {k: statistics.median(v) for k, v in spans.items()},
        "capture_ms": (statistics.median(st.capture_times) * 1e3
                       if st.capture_times else None),
        "checkpoints": ck.n_checkpoints, "checkpoint_steps": ck_steps,
        "recovered_at": st.recovered_at,
        "lost_steps": [CKPT_FAIL - 1 - s for s in st.recovered_at],
        "restore_ms": [e["dur"] / 1e3 for e in restore],
        "restore_to_resume_ms": [(b["ts"] - a["ts"]) / 1e3
                                 for a, b in zip(restore, resume)],
        "peak_device_gb": peak_dev / 1e9,
        "host_peak_rss_gb": rss.peak / 1e9 if rss.peak is not None else None,
        "launches": launches,
    }
    if name == "checkfreq":
        row["tuned_freq"] = ck.tuned_freq
    if checkmate:
        row.update(lag_waits=sst.lag_waits, max_batch=sst.max_batch,
                   shadow_mean_apply_ms=sst.mean_apply_s * 1e3,
                   shadow_max_apply_ms=sst.max_apply_s * 1e3,
                   shadow_lag=sst.lag,
                   shadow_max_queue_depth=sst.max_queue_depth)
    if "--compress" in extra:
        row["compression_ratio"] = ck.channel.compressor.ratio
    if "packetized" in extra:
        row["fabric"] = fabric_row(ck, events, label)
    print(f"checkpointers: {label}: step {row['step_ms']:.2f} ms, iteration "
          f"{iter_ms:.2f} ms, stall {row['stall_ms_by_stage']}, "
          f"checkpoints {ck.n_checkpoints}, recovered at {st.recovered_at}, "
          f"peak {row['peak_device_gb']:.2f} GB, host RSS "
          f"{row['host_peak_rss_gb']} GB", flush=True)
    del r, st, ck, events
    return row


def fabric_row(ck, events, label: str) -> dict:
    """A packetized run's fabric account: its channel's `FabricTotals`;
    per send the simulated AllGather time and event count (from the
    ``allgather step<N>`` spans on the simulated-time tracks); and per send
    the host wall ms of the send, of its copy into the wire buffer and of
    the simulation (the first sends page-lock fresh rx buffers)."""
    chan = ck.channel
    while not hasattr(chan, "totals"):
        chan = chan.inner
    tot = chan.totals
    sims = [e for e in events if e["pid"] == 2
            and e["name"].startswith("allgather step")]
    check(tot.sends == len(sims) and tot.sends > 0,
          f"{label}: {tot.sends} sends, {len(sims)} fabric spans")
    check(tot.gated == 0 and tot.drops == 0,
          f"{label}: {tot.gated} gated sends, {tot.drops} drops")
    out = {"sends": tot.sends, "gated": tot.gated,
           "frames_tx": tot.frames_tx, "frames_rx": tot.frames_rx,
           "frames_mirrored": tot.frames_mirrored, "drops": tot.drops,
           "pfc_pauses": tot.pfc_pauses, "fabric_time_s": tot.fabric_time_s,
           "wire_bytes": tot.wire_bytes,
           "simulated_ms_per_send": [e["dur"] / 1e3 for e in sims],
           "events_per_send": [e["args"]["events"] for e in sims],
           "span_ms_all": {name: [e["dur"] / 1e3 for e in events
                                  if e["name"] == name]
                           for name in ("channel.send", "bucket.pack",
                                        "fabric.simulate")}}
    print(f"checkpointers: {label}: fabric {out['sends']} sends, "
          f"{out['gated']} gated, frames tx {out['frames_tx']} rx "
          f"{out['frames_rx']} mirrored {out['frames_mirrored']}, drops "
          f"{out['drops']}, PFC pauses {out['pfc_pauses']}, simulated "
          f"{out['fabric_time_s']:.6f} s", flush=True)
    return out


def check_codec_on_card(dev, cfg) -> dict:
    """The int8 codec on the card equals its CPU run bitwise, over two
    steps, on one main-path bucket (the first with more than one leaf)."""
    from repro_torch.core.buckets import BucketLayout, layout_for_tree
    from repro_torch.dist.compression import Compressor
    from repro_torch.models import registry
    specs = registry.param_specs(cfg)
    layout = layout_for_tree({k: torch.empty(sp.shape, device="meta")
                              for k, sp in sorted(specs.items())})
    b = next(b for b in layout.buckets if len(b.slots) > 1)
    one = BucketLayout((b,))
    gen = torch.Generator(device="cpu").manual_seed(6)
    card, cpu = Compressor(), Compressor()
    for step in range(2):
        g = torch.randn(b.size, generator=gen) * 1e-3
        g[::97] = 0.0
        g[1::101] = 1e-40                    # subnormal: flushed by both
        got = card.compress_flats(one, {b.bucket_id: g.to(dev)})
        want = cpu.compress_flats(one, {b.bucket_id: g})
        torch.cuda.synchronize()
        check(torch.equal(got[b.bucket_id].cpu(), want[b.bucket_id]),
              f"codec: card and CPU dequantized values differ at step {step}")
        check(torch.equal(card._ef_flat[b.bucket_id].cpu(),
                          cpu._ef_flat[b.bucket_id]),
              f"codec: card and CPU residuals differ at step {step}")
    print(f"checkpointers: int8 codec bitwise equal on the card and the CPU "
          f"over 2 steps on bucket {b.bucket_id} ({len(b.slots)} leaves, "
          f"{b.size} elements)", flush=True)
    return {"bucket": b.bucket_id, "leaves": len(b.slots), "size": b.size,
            "steps": 2, "bitwise_equal": True}


def check_shadow_on_card(dev, cfg) -> dict:
    """At full width and reduced depth: a killed node makes consolidation
    name exactly its buckets, and the per-leaf shadow (flat=False) equals
    the flat one (async, lag bound 2) bitwise after three deliveries."""
    from repro_torch.core.buckets import layout_for_tree
    from repro_torch.core.channel import InProcessChannel, StepEvent
    from repro_torch.core.shadow import ShadowCluster, ShadowNodeLoss
    from repro_torch.optim.functional import OptimizerConfig
    from repro_torch.train.step import make_train_state
    state = make_train_state(cfg, seed=7, device=dev)
    layout = layout_for_tree(state.params)
    opt = OptimizerConfig()
    flat = ShadowCluster(layout, opt, n_nodes=2, async_mode=True,
                         max_lag_steps=2, device=dev)
    leaf = ShadowCluster(layout, opt, n_nodes=2, device=dev, flat=False)
    chan = InProcessChannel()
    chan.open(layout)
    gen = torch.Generator(device=dev).manual_seed(8)
    for cl in (flat, leaf):
        cl.bootstrap(state.params, state.mu, state.nu, 0)
    for step in range(1, 4):
        grads = {k: torch.randn(p.shape, generator=gen, device=dev) * 1e-2
                 for k, p in state.params.items()}
        chan.send(StepEvent(step=step, grads=grads, lr=1e-3,
                            grad_scale=0.9))
        (d,) = chan.poll()
        flat.on_delivery(d)
        leaf.on_delivery(d)
    a, b = flat.consolidate(), leaf.consolidate()
    check(a["step"] == b["step"] == 3, f"shadow: steps {a['step']}, "
                                       f"{b['step']}")
    for tree in ("params", "mu", "nu"):
        for k in a[tree]:
            check(torch.equal(a[tree][k], b[tree][k]),
                  f"shadow: flat=False {tree}[{k}] differs from flat=True")
    st = flat.stats()
    check(flat.nodes[1].bucket_ids, "shadow: node 1 owns no bucket")
    flat.kill_node(1)
    try:
        flat.consolidate()
        fail("shadow: consolidation after kill_node did not raise")
    except ShadowNodeLoss as e:
        check(e.dead_nodes == [1] and e.missing_buckets ==
              {1: tuple(flat.nodes[1].bucket_ids)},
              f"shadow: ShadowNodeLoss named {e.missing_buckets}")
        survivors = {s.name for bid in flat.nodes[0].bucket_ids
                     for s in layout.buckets[bid].slots}
        check(set(e.partial["params"]) == survivors,
              "shadow: the partial checkpoint is not node 0's leaves")
    flat.shutdown()
    leaf.shutdown()
    out = {"layers": cfg.num_layers, "buckets": len(layout.buckets),
           "flat_false_bitwise_equal": True, "max_batch": st.max_batch,
           "killed_node": 1,
           "missing_buckets": list(flat.nodes[1].bucket_ids)}
    print(f"checkpointers: at {cfg.num_layers} layers, flat=False equals "
          f"flat=True bitwise; kill_node(1) -> ShadowNodeLoss naming buckets "
          f"{out['missing_buckets']}", flush=True)
    return out


def check_fabric_on_card(dev, cfg) -> dict:
    """At full width and reduced depth, on the card: a lost capture is
    gated and the shadow frozen until the next step's state_fn resync; a
    sharded fabric with owner 1 dead loses exactly its buckets while owner
    0's shard stays bitwise the trainer's; the fast and per-frame fabric
    engines deliver the same bytes with the same `FabricResult`."""
    from repro_torch.core.buckets import layout_for_tree
    from repro_torch.core.channel import PacketizedChannel, StepEvent
    from repro_torch.core.checkpoint import CheckmateCheckpointer
    from repro_torch.core.shadow import ShadowCluster, ShadowNodeLoss
    from repro_torch.optim.functional import OptimizerConfig
    from repro_torch.train.loop import train
    from repro_torch.train.step import make_train_state
    run = dict(steps=4, batch=4, seq=256, device=dev, seed=3)

    # a lost capture: step 2 gated, frozen at 1, resynced from step 3's state
    applied = []
    state, stats = train(cfg, channel=PacketizedChannel(
        failures_at={2: "capture"}), step_hook=lambda s, st, x: applied.append(
            x.checkpointer.shadow.stats().steps_applied), **run)
    ck = stats.checkpointer
    check(ck.skipped_steps == [2] and ck.resyncs == [3],
          f"fabric: skipped {ck.skipped_steps}, resyncs {ck.resyncs}")
    check(applied == [1, 1, 3, 4], f"fabric: shadow steps {applied}")
    _state_equal(ck.shadow.consolidate(), state, "fabric: after the resync")
    gated = {"skipped_steps": ck.skipped_steps, "resyncs": ck.resyncs,
             "shadow_steps": applied}
    del state, stats, ck

    # a dead owner on a sharded fabric: the last step applies to owner 0
    state0 = make_train_state(cfg, seed=3, device=dev)
    layout = layout_for_tree(state0.params)
    shadow = ShadowCluster(layout, OptimizerConfig(), n_nodes=2, device=dev)
    shadow.bootstrap(state0.params, state0.mu, state0.nu, 0)
    chan = PacketizedChannel(sharded=True, n_shadow_nodes=2)
    ck = CheckmateCheckpointer(shadow, channel=chan)

    def kill(step, st, x):
        if step == run["steps"] - 1:
            shadow.kill_node(1)
            chan.kill_shadow_node(1)
    state, stats = train(cfg, checkpointer=ck, state=state0, step_hook=kill,
                         **run)
    check(ck.partial_steps == [run["steps"]],
          f"fabric: partial steps {ck.partial_steps}")
    lost = tuple(shadow.nodes[1].bucket_ids)
    try:
        shadow.consolidate()
        fail("fabric: consolidation with a dead owner did not raise")
    except ShadowNodeLoss as e:
        check(e.missing_buckets == {1: lost},
              f"fabric: ShadowNodeLoss named {e.missing_buckets}")
        mine = {s.name for bid in shadow.nodes[0].bucket_ids
                for s in layout.buckets[bid].slots}
        check(e.partial["step"] == run["steps"]
              and set(e.partial["params"]) == mine,
              "fabric: the partial checkpoint is not owner 0's at the end")
        for tree in ("params", "mu", "nu"):
            for k in mine:
                check(torch.equal(e.partial[tree][k],
                                  getattr(state, tree)[k].cpu()),
                      f"fabric: surviving {tree}[{k}] not bitwise")
    sharded = {"partial_steps": ck.partial_steps, "missing_buckets": lost}
    del state, stats, ck, shadow, chan, state0

    # both engines, fed device flats (the compressed channel's path)
    gen = torch.Generator(device=dev).manual_seed(11)
    flats = {b.bucket_id: torch.randn(b.size, generator=gen, device=dev)
             for b in layout.buckets}
    res = []
    for fast in (False, True):
        chan = PacketizedChannel(fast=fast)
        chan.open(layout)
        chan.send(StepEvent(step=1, flats=flats, lr=1e-3))
        (d,) = chan.poll()
        for bid, t in flats.items():
            check(torch.equal(d.flats[bid], t.cpu()),
                  f"fabric: fast={fast} bucket {bid} not delivered bitwise")
        res.append(dataclasses.asdict(d.fabric))
        del d, chan
    check(res[0] == res[1], "fabric: fast and per-frame engines differ")
    out = {"layers": cfg.num_layers, "gated": gated, "sharded": sharded,
           "engines_equal": True, "bytes": sum(t.numel() * 4
                                               for t in flats.values()),
           "simulated_ms": res[0]["duration_s"] * 1e3,
           "events": res[0]["events"]}
    print(f"checkpointers: fabric at {cfg.num_layers} layers: step 2's "
          f"capture gated, resynced at 3; dead owner 1 lost buckets "
          f"{list(lost)}, owner 0 bitwise; both engines equal "
          f"({out['events']} events, {out['simulated_ms']:.3f} ms "
          f"simulated)", flush=True)
    return out


def time_staged_receive(cfg, reps: int = 3) -> dict:
    """How much of a shadow apply the staged receive hides, at full width
    on one node: the apply from pinned host flats (staged), against its
    parts run alone (the host-to-device copies; the AdamW launches on
    device-resident flats). Wall ms per apply, means over ``reps``."""
    from repro_torch.core.buckets import alloc_flat, layout_for_tree
    from repro_torch.core.shadow import ShadowCluster
    from repro_torch.models import registry
    from repro_torch.optim.functional import OptimizerConfig
    specs = registry.param_specs(cfg)
    zeros = {k: torch.zeros(sp.shape, device="cuda")
             for k, sp in sorted(specs.items())}
    layout = layout_for_tree(zeros)
    cl = ShadowCluster(layout, OptimizerConfig(), n_nodes=1, device="cuda")
    cl.bootstrap(zeros, zeros, zeros, 0)
    del zeros
    node = cl.nodes[0]
    gen = torch.Generator(device="cuda").manual_seed(9)
    dev_flats = {b.bucket_id: torch.randn(b.size, generator=gen,
                                          device="cuda") * 1e-3
                 for b in layout.buckets}
    host = {bid: alloc_flat(t.numel(), t.dtype, "cpu", pin=True).copy_(t)
            for bid, t in dev_flats.items()}
    scratch = {bid: torch.empty_like(t) for bid, t in dev_flats.items()}

    def wall(fn) -> float:
        fn()                                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    def copies():
        for bid, t in host.items():
            scratch[bid].copy_(t, non_blocking=True)
    out = {"buckets": len(layout.buckets),
           "bytes": sum(t.numel() * 4 for t in host.values()),
           "staged_ms": wall(lambda: node.apply(1, 1e-3, host)),
           "copies_ms": wall(copies),
           "adamw_ms": wall(lambda: node.apply(1, 1e-3, dev_flats))}
    out["hidden_ms"] = out["copies_ms"] + out["adamw_ms"] - out["staged_ms"]
    print(f"checkpointers: staged receive, one node at full width: apply "
          f"{out['staged_ms']:.2f} ms against copies {out['copies_ms']:.2f} "
          f"+ AdamW {out['adamw_ms']:.2f} ms alone ({out['hidden_ms']:.2f} "
          f"ms hidden)", flush=True)
    del cl, node, dev_flats, host, scratch
    return out


def phase_checkpointers(cfg, dev) -> dict:
    rows = [ckpt_run(cfg, name, extra) for name, extra in CKPT_RUNS]
    _free()
    codec = check_codec_on_card(dev, cfg)
    small = check_shadow_on_card(dev, dataclasses.replace(cfg, num_layers=2))
    _free()
    small["fabric"] = check_fabric_on_card(
        dev, dataclasses.replace(cfg, num_layers=2))
    _free()
    small["staged_receive"] = time_staged_receive(cfg)
    _free()
    return {"model": cfg.name, "layers": cfg.num_layers,
            "batch": MAIN_RUN["batch"], "seq": MAIN_RUN["seq"],
            "steps": CKPT_STEPS, "fail_at": CKPT_FAIL,
            "host_mem_total_gb": (_proc_kb("/proc/meminfo", "MemTotal")
                                  or 0) * 1024 / 1e9,
            "runs": rows, "codec": codec, "shadow": small}


# -- phase 6 -----------------------------------------------------------------

# Phase 6: the durable shadow plane at MAIN_RUN's width, batch and seq, cut
# to DUR_LAYERS layers (a full-depth run writes 13.2 GB an epoch and takes
# 70-100 s). The raw run fails at DUR_FAIL; every run flushes every
# DUR_EVERY steps to one local-disk tier under a temporary directory.
DUR_LAYERS = 2
DUR_STEPS, DUR_FAIL, DUR_EVERY = 6, 4, 2
DUR_COMPRESSED_STEPS, DUR_SMALL_STEPS = 4, 3
STALL_WORDS = ("flush", "durability", "tier")     # no such stage may appear


class DiskPeak:
    """The peak bytes of the files under ``root`` over a ``with`` block,
    and the least ``MemAvailable`` of the machine, sampled every 20 ms."""

    def __init__(self, root: str):
        self.root = root
        self.peak = 0
        self.mem_available_min = None
        self._stop = threading.Event()

    def _read(self) -> int:
        total = 0
        try:
            with os.scandir(self.root) as it:
                for e in it:
                    try:
                        total += e.stat().st_size
                    except OSError:
                        pass            # pruned or renamed meanwhile
        except OSError:
            pass
        return total

    def _poll(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._read())
            avail = _proc_kb("/proc/meminfo", "MemAvailable")
            if avail is not None:
                self.mem_available_min = min(self.mem_available_min or avail,
                                             avail)

    def __enter__(self):
        self._t = threading.Thread(target=self._poll, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak = max(self.peak, self._read())
        return False


def _logged_tier(root: str, retain: int, shadow):
    """A `LocalDiskTier` that keeps every put's manifest entry, its record
    step and the trainer's step when the put returned (retention prunes
    the manifest itself)."""
    from repro_torch.durability import LocalDiskTier

    class LoggedTier(LocalDiskTier):
        def __init__(self):
            super().__init__(root, retain_epochs=retain)
            self.log: list[dict] = []

        def put(self, rec):
            entry = super().put(rec)
            self.log.append({"epoch": entry.epoch, "node": entry.node,
                             "step": entry.step, "kind": entry.kind,
                             "compressed": entry.compressed,
                             "nbytes": entry.nbytes,
                             "train_step": shadow.train_step_seen})
            return entry
    return LoggedTier()


def _spans(events, name) -> list:
    return [e for e in events if e["name"] == name]


def _state_on_card_equal(state, ref, what: str):
    """Two trainer states on the card bitwise equal."""
    for tree in ("params", "mu", "nu"):
        a, b = getattr(state, tree), getattr(ref, tree)
        check(set(a) == set(b), f"{what}: {tree} leaf names differ")
        for k, t in b.items():
            check(torch.equal(a[k], t),
                  f"{what}: {tree}[{k}] not bitwise equal to the trainer")


def durable_run(cfg, label: str, *, steps: int, fail, compress: bool,
                opt_name: str = "adamw", every: int = DUR_EVERY,
                rebase: int = 2, retain: int = 1,
                check_shadow: bool = False) -> dict:
    """One training run through a CheckmateCheckpointer with a durable
    shadow plane (2 async nodes, lag bound 2) at ``cfg``'s depth (with
    ``check_shadow`` the shadow is then held bitwise to the trainer); then
    a partial loss (node 1) and a total loss, each recovered through
    ``recover(tiers=...)``: bitwise the trainer's final state, or for a
    compressed plane a total-loss restore within atol 1e-2 of its params
    (the JAX bound)."""
    import shutil
    import tempfile
    from repro_torch import obs
    from repro_torch.core.buckets import layout_for_tree
    from repro_torch.core.channel import InProcessChannel
    from repro_torch.core.checkpoint import CheckmateCheckpointer
    from repro_torch.core.recovery import FailurePlan, recover
    from repro_torch.core.shadow import ShadowCluster, ShadowNodeLoss
    from repro_torch.durability import DurableShadow, FlushPolicy
    from repro_torch.kernels import ops
    from repro_torch.optim.functional import OptimizerConfig
    from repro_torch.train.loop import train
    from repro_torch.train.step import make_train_state
    _free()
    opt = OptimizerConfig(name=opt_name)
    root = tempfile.mkdtemp(prefix="chip-smoke-durability-")
    try:
        init = [make_train_state(cfg, seed=0, device="cuda")]
        layout = layout_for_tree(init[0].params)
        state_bytes = sum(b.size * 12 for b in layout.buckets)
        # the chain on disk at its peak: the previous base and delta, and
        # the new base being written before they are pruned (a compressed
        # delta is about a quarter of the state)
        need = state_bytes * (2.25 if compress else 3.0)
        free = shutil.disk_usage(root).free
        check(free >= need, f"{label}: {free} bytes free under {root}, the "
                            f"run needs {int(need)}")
        _free()
        torch.cuda.reset_peak_memory_stats()
        retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        ops.reset_launch_counts()
        with obs.enabled_session() as ob, RssPeak() as rss, \
                DiskPeak(root) as disk:
            shadow = ShadowCluster(layout, opt, n_nodes=2, async_mode=True,
                                   max_lag_steps=2, device="cuda")
            tier = _logged_tier(root, retain, shadow)
            dur = DurableShadow([tier], FlushPolicy(
                every_steps=every, compress=compress, rebase_every=rebase))
            t0 = time.perf_counter()
            ck = CheckmateCheckpointer(shadow, channel=InProcessChannel(),
                                       durability=dur)
            attach_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            shadow.bootstrap(init[0].params, init[0].mu, init[0].nu, 0)
            bootstrap_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            state, st = train(cfg, steps=steps, batch=MAIN_RUN["batch"],
                              seq=MAIN_RUN["seq"], opt=opt, checkpointer=ck,
                              failure_plan=FailurePlan((fail,) if fail
                                                       else ()),
                              seed=0, state=init.pop(), device="cuda")
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = ops.launch_counts()
            dur.drain()
            events = ob.tracer.events()
            lag_gauge = ob.metrics.gauge("durability_tier_lag_steps").value(
                tier=tier.name)
            peak_dev = torch.cuda.max_memory_allocated()
            peak_reserved = torch.cuda.max_memory_reserved()
            retries = torch.cuda.memory_stats().get("num_alloc_retries",
                                                    0) - retries0
            last = dur.last_complete_step(tier.name)
            check(not dur.errors, f"{label}: flushes raised {dur.errors}")
            check(last == steps, f"{label}: last complete durable step "
                                 f"{last}, not {steps}")
            total = 0.0
            for sec in ck.stall_stages.values():
                total += sec
            check(ck.stall_total == total, f"{label}: ledger does not sum "
                                           f"bit for bit")
            check(not any(w in stage for stage in ck.stall_stages
                          for w in STALL_WORDS),
                  f"{label}: a flush stage in the ledger {ck.stall_stages}")
            check(st.recoveries == int(bool(fail)),
                  f"{label}: recoveries {st.recoveries}")
            if fail:
                check(st.recovered_at == [fail - 1],
                      f"{label}: recovered at {st.recovered_at}")
            if check_shadow:
                ckpt = shadow.consolidate()
                _state_equal(ckpt, state, f"{label}: shadow")
                del ckpt
                _free()
            out_recover = {}
            if not compress:
                shadow.kill_node(1)
                t0 = time.perf_counter()
                got, at = recover(shadow, device="cuda", tiers=[tier])
                torch.cuda.synchronize()
                out_recover["partial_loss_restore_ms"] = \
                    (time.perf_counter() - t0) * 1e3
                check(at == steps, f"{label}: partial-loss recover at {at}")
                _state_on_card_equal(got, state, f"{label}: partial loss")
                del got
                _free()
            shadow.kill_node(0)
            shadow.kill_node(1)
            try:
                shadow.consolidate()
                fail_msg = "no ShadowNodeLoss"
            except ShadowNodeLoss as e:
                fail_msg = None
                check(e.total and e.durable_hint == (tier.name, steps),
                      f"{label}: total loss {e.total}, hint "
                      f"{e.durable_hint}")
            check(fail_msg is None, f"{label}: total loss raised "
                                    f"{fail_msg}")
            t0 = time.perf_counter()
            got, at = recover(shadow, device="cuda", tiers=[tier])
            torch.cuda.synchronize()
            out_recover["total_loss_restore_ms"] = \
                (time.perf_counter() - t0) * 1e3
            check(at == steps, f"{label}: total-loss recover at {at}")
            if not compress:
                _state_on_card_equal(got, state, f"{label}: total loss")
            else:
                err = max((got.params[k] - t).abs().max().item()
                          for k, t in state.params.items())
                check(err <= 1e-2, f"{label}: compressed restore err {err} "
                                   f"> atol 1e-2")
                out_recover["restore_max_abs_err"] = err
            del got
            shadow.shutdown()
            disk_end = tier.disk_bytes()
            log = list(tier.log)
        flush = _spans(events, "durability.flush")
        locked = _spans(events, "durability.snapshot")
        puts = _spans(events, "durability.put")
        by_key = {(r["epoch"], r["node"]): r for r in log}
        rates = [by_key[(e["args"]["epoch"], e["args"]["node"])]["nbytes"]
                 / (e["dur"] / 1e6) / 1e9 for e in puts
                 if (e["args"]["epoch"], e["args"]["node"]) in by_key]
        epochs: dict = {}
        for r in log:
            ep = epochs.setdefault(r["epoch"], {"step": r["step"],
                                                "kinds": [], "bytes": 0,
                                                "lag": 0})
            ep["kinds"].append(r["kind"] + ("*" if r["compressed"] else ""))
            ep["bytes"] += r["nbytes"]
            ep["lag"] = max(ep["lag"], r["train_step"] - r["step"])
        base = [ep["bytes"] for ep in epochs.values()
                if all(k == "base" for k in ep["kinds"])]
        delta = [ep["bytes"] for ep in epochs.values()
                 if not all(k == "base" for k in ep["kinds"])]
        if compress:
            check(delta and all(d < min(base) for d in delta),
                  f"{label}: delta epochs {delta} not below the base "
                  f"{base}")
        iters = [(s + c + x) for s, c, x in zip(
            st.iter_times, st.capture_times, st.stall_times)]
        n_ck = max(ck.n_checkpoints, 1)
        row = {
            "run": label, "optimizer": opt_name, "layers": cfg.num_layers,
            "steps": steps, "fail_at": fail, "compress": compress,
            "every_steps": every, "rebase_every": rebase,
            "retain_epochs": retain, "state_bytes": state_bytes,
            "steps_run": st.steps, "recovered_at": st.recovered_at,
            "step_ms": st.steady_iter * 1e3,
            "iter_ms": statistics.median(iters[1:]) * 1e3,
            "step_ms_all": [t * 1e3 for t in st.iter_times],
            "capture_ms_all": [t * 1e3 for t in st.capture_times],
            "stall_ms_per_checkpoint": {k: v / n_ck * 1e3 for k, v
                                        in ck.stall_stages.items()
                                        if k != "consolidate-wait"},
            "attach_s": attach_s, "bootstrap_s": bootstrap_s,
            "train_s": train_s, "last_complete_step": last,
            "flush_ms_median": (statistics.median(e["dur"] / 1e3
                                                  for e in flush)
                                if flush else None),
            "flush_ms_all": [e["dur"] / 1e3 for e in flush],
            "locked_ms_median": (statistics.median(e["dur"] / 1e3
                                                   for e in locked)
                                 if locked else None),
            "locked_ms_all": [e["dur"] / 1e3 for e in locked],
            "put_gb_per_s_median": (statistics.median(rates)
                                    if rates else None),
            "epochs": epochs,
            "base_epoch_bytes": base, "delta_epoch_bytes": delta,
            "delta_to_state": [d / state_bytes for d in delta],
            "tier_lag_steps_max": max((ep["lag"] for ep in epochs.values()),
                                      default=None),
            "tier_lag_gauge_end": lag_gauge,
            "disk_peak_bytes": disk.peak, "disk_end_bytes": disk_end,
            "mem_available_min_gb": (disk.mem_available_min * 1024 / 1e9
                                     if disk.mem_available_min else None),
            "peak_device_gb": peak_dev / 1e9,
            "peak_device_reserved_gb": peak_reserved / 1e9,
            "alloc_retries": retries,
            "host_peak_rss_gb": rss.peak / 1e9 if rss.peak is not None
            else None,
            "launches": launches, **out_recover}
        print(f"durability: {label}: step {row['step_ms']:.2f} ms, flush "
              f"median {row['flush_ms_median']} "
              f"ms, locked median {row['locked_ms_median']} ms, epochs "
              f"{ {k: (v['step'], v['kinds'], v['bytes']) for k, v in epochs.items()} }, "
              f"disk peak {disk.peak / 1e9:.2f} GB, restores "
              f"{out_recover}, device {row['peak_device_gb']:.2f} GB, host "
              f"RSS {row['host_peak_rss_gb']} GB", flush=True)
        return row
    finally:
        shutil.rmtree(root, ignore_errors=True)


def plan_row(cfg, iter_s: float) -> dict:
    """The shadow planner at full width: one measured apply on the card
    and the cost model's plan with the durability terms."""
    from repro_torch.core import costmodel
    from repro_torch.core.buckets import layout_for_tree
    from repro_torch.core.shadow import plan_shadow_nodes
    from repro_torch.models import registry
    from repro_torch.optim.functional import OptimizerConfig
    _free()
    specs = registry.param_specs(cfg)
    trial = {k: torch.empty(sp.shape, device="meta")
             for k, sp in sorted(specs.items())}
    layout = layout_for_tree(trial)
    n, apply_s = plan_shadow_nodes(layout, OptimizerConfig(), iter_s, trial,
                                   device="cuda")
    plan = costmodel.plan_shadow_nodes(layout, iter_time_s=iter_s,
                                       flush_every_steps=DUR_EVERY)
    out = {"iter_s": iter_s, "measured_nodes": n,
           "measured_apply_ms": apply_s * 1e3,
           "costmodel": dataclasses.asdict(plan)}
    print(f"durability: planner at {iter_s:.3f} s an iteration: measured "
          f"{n} node(s), one apply {apply_s * 1e3:.2f} ms; cost model "
          f"{plan.n_nodes} node(s), flush bound {plan.flush_bound}, disk "
          f"bound {plan.disk_bound}", flush=True)
    _free()
    return out


def phase_durability(cfg, step_ms_ref: float) -> dict:
    """The durable runs at DUR_LAYERS layers; the planner at full width
    against the main path's step (``step_ms_ref``)."""
    small = dataclasses.replace(cfg, num_layers=DUR_LAYERS)
    raw = durable_run(small, "raw", steps=DUR_STEPS, fail=DUR_FAIL,
                      compress=False)
    packed = durable_run(small, "compressed", steps=DUR_COMPRESSED_STEPS,
                         fail=None, compress=True, rebase=8)
    others = [durable_run(small, f"{name} at {DUR_LAYERS} layers",
                          steps=DUR_SMALL_STEPS, fail=None, compress=False,
                          opt_name=name, every=1, rebase=8, retain=None,
                          check_shadow=True)
              for name in ("adam", "sgd")]
    plan = plan_row(cfg, step_ms_ref / 1e3)
    return {"model": cfg.name, "batch": MAIN_RUN["batch"],
            "seq": MAIN_RUN["seq"], "shadow_nodes": 2, "max_lag_steps": 2,
            "runs": [raw, packed, *others], "planner": plan}


# -- phase 7 -----------------------------------------------------------------

# Phase 7's full-level scenarios: tinyllama-1.1b at full width cut to
# HARNESS_LAYERS layers, bf16 compute, the config's microbatches, each
# scenario's batch and seq replaced by HARNESS_SHAPE. One layer (two
# before phase 4c's family yardsticks joined) pays for those yardsticks.
HARNESS_LAYERS = 1
HARNESS_SHAPE = dict(batch=8, seq=2048)


def _budget() -> dict:
    """The JAX package's committed per-scenario CPU seconds, a yardstick
    printed beside the card's wall seconds (not a measurement of it)."""
    with open(os.path.join(ROOT, "benchmarks", "golden_budget.json")) as f:
        return json.load(f)["scenarios"]


def _same_ckpt(a: dict, b: dict) -> bool:
    """Two host checkpoints bitwise equal (step, leaf names, every bit)."""
    return a["step"] == b["step"] and all(
        set(a[t]) == set(b[t]) and all(torch.equal(a[t][k], b[t][k])
                                       for k in a[t])
        for t in ("params", "mu", "nu"))


def harness_channel(budget: dict) -> list[dict]:
    """Every channel-level golden scenario on the card: every invariant
    passes; an AdamW scenario on an uncompressed channel ends with the
    trainer's and the shadow's checkpoints bitwise those of its CPU run
    (plain versions); every elastic drill books elastic-reshard."""
    from repro_torch.harness import GOLDEN, run_scenario
    from repro_torch.kernels import ops
    rows = []
    for name, sc in GOLDEN.items():
        if sc.level != "channel":
            continue
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_scenario(sc, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        check(res.passed, f"harness: {name} on the card violates "
                          f"{[v.to_dict() for v in res.violations[:3]]}")
        stages = res.trace.checkpointer.stall_stages
        if name.startswith("elastic-"):
            check("elastic-reshard" in stages,
                  f"harness: {name} booked no elastic-reshard ({stages})")
        bitwise = None
        if sc.optimizer == "adamw" and sc.channel.kind != "compressed":
            check(launches["fused_adamw"] > 0,
                  f"harness: {name} never launched fused_adamw")
            cpu = run_scenario(sc, device="cpu")
            check(cpu.passed, f"harness: {name} on the CPU violates "
                              f"{[v.to_dict() for v in cpu.violations[:3]]}")
            bitwise = (_same_ckpt(res.trace.final, cpu.trace.final)
                       and _same_ckpt(res.trace.final_shadow,
                                      cpu.trace.final_shadow))
            check(bitwise, f"harness: {name}'s checkpoints on the card "
                           f"differ from its CPU run")
        rows.append({"name": name, "s": wall,
                     "jax_cpu_baseline_s": budget.get(name),
                     "launches": launches, "bitwise_vs_cpu": bitwise,
                     "elastic_events": len(res.trace.elastic_events)})
    check(len(rows) == 42, f"harness: {len(rows)} channel-level scenarios")
    check(sum(r["launches"]["fused_adamw"] for r in rows) > 0,
          "harness: fused_adamw never launched at channel level")
    print(f"harness: {len(rows)} channel-level scenarios pass on the card, "
          f"{sum(r['bitwise_vs_cpu'] is True for r in rows)} AdamW ones "
          f"bitwise their CPU runs, in {sum(r['s'] for r in rows):.1f} s",
          flush=True)
    return rows


def harness_full(budget: dict) -> list[dict]:
    """The full-level golden scenarios at full width and HARNESS_LAYERS
    layers on the card: every invariant passes; the wgmma flash kernel
    launches 2 x layers x microbatches per executed step of the reference
    and the checkpointed runs together, the mma.sync one never; the pack
    (for Checkmate) and AdamW kernels launch. The elastic drill books
    elastic-reshard once and ends with the shadow's checkpoint bitwise the
    trainer's."""
    from repro_torch import configs
    from repro_torch.harness import GOLDEN, run_scenario
    from repro_torch.kernels import ops
    cfg = dataclasses.replace(configs.get("tinyllama-1.1b"),
                              num_layers=HARNESS_LAYERS)
    rows = []
    for name, sc in GOLDEN.items():
        if sc.level != "full":
            continue
        sc = dataclasses.replace(sc, **HARNESS_SHAPE)
        _free()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_scenario(sc, device="cuda", cfg=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        check(res.passed, f"harness: {name} at full width violates "
                          f"{[v.to_dict() for v in res.violations[:3]]}")
        st = res.trace.stats
        ran = len(res.trace.ref_losses) + st.steps
        want = 2 * cfg.num_layers * cfg.microbatches * ran
        check(launches["flash_attention_wgmma"] == want
              and launches["flash_attention_bwd"] == want // 2,
              f"harness: {name}: wgmma flash launched "
              f"{launches['flash_attention_wgmma']} times, not {want}; its "
              f"backward {launches['flash_attention_bwd']}, not {want // 2}")
        check(launches["flash_attention_mma"] == 0,
              f"harness: {name}: mma.sync flash launched "
              f"{launches['flash_attention_mma']} times on the bf16 path")
        check(launches["fused_adamw"] > 0,
              f"harness: {name} never launched fused_adamw")
        if sc.checkpointer == "checkmate":
            check(launches["bucket_pack"] > 0,
                  f"harness: {name} never launched bucket_pack")
        elastic = None
        if sc.schedule.train_node_loss:
            stages = res.trace.checkpointer.stall_stages
            check(list(stages).count("elastic-reshard") == 1,
                  f"harness: {name} booked {list(stages)}")
            check(len(res.trace.elastic_events) == 1
                  and res.trace.elastic_events[0]["fsdp"],
                  f"harness: {name}: {res.trace.elastic_events}")
            check(_same_ckpt(res.trace.final_shadow, res.trace.final),
                  f"harness: {name}: the shadow after the flip is not "
                  f"bitwise the trainer's")
            elastic = {"events": res.trace.elastic_events,
                       "elastic_reshard_ms": stages["elastic-reshard"] * 1e3}
        rows.append({
            "name": name, "s": wall, "jax_cpu_baseline_s": budget.get(name),
            "batch": sc.batch, "seq": sc.seq, "layers": cfg.num_layers,
            "microbatches": cfg.microbatches, "steps_run": st.steps,
            "reference_steps": len(res.trace.ref_losses),
            "recoveries": st.recoveries, "recovered_at": st.recovered_at,
            "step_ms": st.steady_iter * 1e3, "losses": st.losses,
            "launches": launches, "elastic": elastic})
        print(f"harness: {name} at full width, {cfg.num_layers} layers, "
              f"batch {sc.batch} x seq {sc.seq}: pass in {wall:.1f} s, "
              f"{st.steps} steps + {len(res.trace.ref_losses)} reference, "
              f"step {st.steady_iter * 1e3:.2f} ms, launches {launches}"
              + (f", elastic-reshard "
                 f"{elastic['elastic_reshard_ms']:.3f} ms" if elastic
                 else ""), flush=True)
        del res
    check(len(rows) == 5, f"harness: {len(rows)} full-level scenarios")
    _free()
    return rows


def phase_harness() -> dict:
    budget = _budget()
    t0 = time.perf_counter()
    channel = harness_channel(budget)
    t1 = time.perf_counter()
    full = harness_full(budget)
    t2 = time.perf_counter()
    return {"channel_s": t1 - t0, "full_s": t2 - t1,
            "baseline_note": "jax_cpu_baseline_s: the JAX package's "
                             "seconds on a CPU (benchmarks/golden_budget."
                             "json), a yardstick, not a card time",
            "channel": channel, "full": full}


# -- phase 8 -----------------------------------------------------------------

# Phase 8: each family's training path at full width through train() with
# an in-process channel into a 2-node async shadow on the card. Global batch
# FAMILY_BATCH in FAMILY_MICROBATCHES microbatches (cut from each config's
# 8), FAMILY_STEPS steps, a failure at FAMILY_FAIL. Widths as published;
# depth (and arctic's experts) cut as far as 80 GB with a shadow forces,
# whisper's and vit's (24 + 24 and 32 layers) for the script's time limit.
# label: (arch, config overrides, seq): seq is the token sequence
# (whisper's decoder context; llava's text after its 576 patches; unused by
# vit, which trains on its 256 patches).
FAMILY_BATCH, FAMILY_MICROBATCHES = 4, 2
FAMILY_STEPS, FAMILY_FAIL = 3, 2
FAMILY_CELLS = {
    "granite": ("granite-34b", dict(num_layers=2), 2048),
    "arctic": ("arctic-480b", dict(num_layers=1, num_experts=8), 2048),
    "mamba2": ("mamba2-2.7b", dict(num_layers=2), 2048),
    "zamba2": ("zamba2-1.2b", dict(num_layers=12), 2048),
    "whisper": ("whisper-medium", dict(num_layers=6, encoder_layers=6),
                448),
    "llava": ("llava-next-mistral-7b", dict(num_layers=2), 2048 - 576),
    "vit": ("vit-h-14", dict(family="vit", num_layers=8), 256),
}


def family_cfg(label: str):
    from repro_torch import configs
    arch, over, _ = FAMILY_CELLS[label]
    return dataclasses.replace(configs.get(arch),
                               microbatches=FAMILY_MICROBATCHES, **over)


def attention_shapes(cfg, seq: int, batch: int = 0) -> dict:
    """The flash forward calls of one forward (or prefill) of ``cfg``'s
    model at token sequence ``seq``: {(b, sq, skv, h, kv, d, dtype,
    causal): calls}, b = ``batch``, or one microbatch of phase 8's,
    FAMILY_BATCH // cfg.microbatches."""
    from repro_torch.core.buckets import TORCH_DTYPES
    from repro_torch.models import hybrid
    calls = collections.Counter()
    b = batch or FAMILY_BATCH // cfg.microbatches

    def add(n, sq, skv, causal, kv=cfg.num_kv_heads):
        calls[(b, sq, skv, cfg.num_heads, kv, cfg.head_dim,
               TORCH_DTYPES[cfg.compute_dtype], causal)] += n
    if cfg.family == "hybrid":            # the shared block's calls
        add(hybrid.n_shared_calls(cfg), seq, seq, True)
    elif cfg.family == "audio":          # encoder; decoder self and cross
        enc = cfg.encoder_seq              # (cross k, v at every head)
        add(cfg.encoder_layers, enc, enc, False)
        add(cfg.num_layers, seq, seq, True)
        add(cfg.num_layers, seq, enc, False, kv=cfg.num_heads)
    elif cfg.family == "vlm":            # patches before the text
        add(cfg.num_layers, cfg.num_patches + seq, cfg.num_patches + seq,
            True)
    elif cfg.family == "vit":
        add(cfg.num_layers, cfg.num_patches, cfg.num_patches, False)
    elif cfg.family != "ssm":
        add(cfg.num_layers, seq, seq, True)
    return dict(calls)


def family_flash_cases() -> list:
    """Every flash shape phase 8 launches (from FAMILY_CELLS), phase 9's
    prefills launch (from serve_cells()) and phase 10's runs launch (from
    benchmark_cells()), so none can drift from what phase 2 holds; then
    FLASH_CONFIG_CASES' and FLASH_EXTRA_CASES."""
    from repro_torch import configs
    cells = [(family_cfg(label), FAMILY_CELLS[label][2], 0)
             for label in FAMILY_CELLS]
    cells += [(dataclasses.replace(configs.get(arch),
                                   microbatches=FAMILY_MICROBATCHES), seq, 0)
              for arch, seq in FLASH_CONFIG_CASES]
    cells += [(serve_cfg(label), prompt, b)
              for label, (_, _, b, prompt, _) in serve_cells().items()]
    cells += benchmark_cells()
    cases = [c for cfg, seq, b in cells
             for c in attention_shapes(cfg, seq, b)]
    return list(dict.fromkeys(cases + list(FLASH_EXTRA_CASES)))


# the full-width forward check of each family: FW_LAYERS layers (and
# encoder layers), batch 1, at most FW_SEQ tokens, f32 on both sides
FW_LAYERS, FW_SEQ = 2, 512


def full_width_card_equals_cpu(label: str) -> dict:
    """One forward of ``label``'s run at its widths, cut to FW_LAYERS
    layers (the hybrid to one segment: one shared-block call), f32
    compute, on the card (kernels) and on the CPU (plain versions) from
    the same weights and batch: losses within rtol 1e-4."""
    from repro_torch.data.synthetic import SyntheticStream, device_batch
    from repro_torch.models import registry
    cfg = family_cfg(label)
    layers = (cfg.attn_every if cfg.family == "hybrid"
              else min(cfg.num_layers, FW_LAYERS))
    cfg = dataclasses.replace(
        cfg, num_layers=layers,
        encoder_layers=min(cfg.encoder_layers, FW_LAYERS),
        compute_dtype="float32", microbatches=1)
    seq = min(FAMILY_CELLS[label][2], FW_SEQ)
    # drawn on the card: the CPU's generator takes tens of seconds for the
    # wide embeddings
    params = {"cuda": registry.init_params(cfg, seed=0, device="cuda")}
    params["cpu"] = {k: v.cpu() for k, v in params["cuda"].items()}
    batch = SyntheticStream(cfg, 1, seq, seed=0).batch_at(0)
    out = {"layers": layers, "encoder_layers": cfg.encoder_layers,
           "seq": seq}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        with torch.no_grad():
            out[dev] = float(registry.loss_fn(params[dev], cfg,
                                              device_batch(batch, dev)))
        out[f"{dev}_s"] = time.perf_counter() - t0
    check(math.isfinite(out["cuda"]) and
          math.isclose(out["cuda"], out["cpu"], rel_tol=1e-4, abs_tol=0.0),
          f"families: {label} full-width f32 loss {out['cuda']} on the card "
          f"vs {out['cpu']} on the CPU beyond rtol 1e-4")
    del params
    return out


def family_run(label: str) -> dict:
    """One family at full width through the main path; checks it and
    returns its row."""
    from repro_torch.core.channel import InProcessChannel
    from repro_torch.core.recovery import FailurePlan
    from repro_torch.kernels import ops
    from repro_torch.train.loop import train
    cfg = family_cfg(label)
    seq = FAMILY_CELLS[label][2]
    small, _ = reduced_card_equals_cpu(cfg, f"families: {label}")
    wide = full_width_card_equals_cpu(label)
    _free()
    torch.cuda.reset_peak_memory_stats()
    # every flash call's shape, to hold against attention_shapes (and so
    # against what phase 2 checked)
    seen, flash = collections.Counter(), ops.flash_attention

    def recording(q, k, v, causal, q_offset=0):
        seen[(*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
              q.dtype, causal)] += 1
        return flash(q, k, v, causal, q_offset)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with RssPeak() as rss:
        ops.flash_attention = recording
        try:
            state, stats = train(cfg, steps=FAMILY_STEPS, batch=FAMILY_BATCH,
                                 seq=seq, channel=InProcessChannel(),
                                 shadow_nodes=2, shadow_async=True,
                                 failure_plan=FailurePlan((FAMILY_FAIL,)),
                                 seed=0, device="cuda")
        finally:
            ops.flash_attention = flash
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        shadow = stats.checkpointer.shadow
        ckpt = shadow.consolidate()
        shadow.shutdown()
        check(all(math.isfinite(x) for x in stats.losses),
              f"families: {label} non-finite loss {stats.losses}")
        check(stats.recovered_at == [FAMILY_FAIL - 1],
              f"families: {label} recovered at {stats.recovered_at}, "
              f"lost steps")
        check(ckpt["step"] == FAMILY_STEPS == state.step,
              f"families: {label} checkpoint at {ckpt['step']}")
        for tree in ("params", "mu", "nu"):
            ours = getattr(state, tree)
            check(set(ckpt[tree]) == set(ours),
                  f"families: {label} {tree} leaf names differ")
            for k, t in ours.items():
                check(torch.equal(ckpt[tree][k].to(t.device), t),
                      f"families: {label} checkpoint {tree}[{k}] not "
                      f"bitwise equal to the trainer")
    ran = stats.steps
    # forward and remat recompute, per microbatch, per executed step
    shapes = {k: 2 * n * cfg.microbatches * ran
              for k, n in attention_shapes(cfg, seq).items()}
    check(dict(seen) == shapes,
          f"families: {label} flash calls by shape {dict(seen)}, not the "
          f"predicted {shapes}")
    want = sum(shapes.values())
    check(launches["flash_attention_wgmma"] == want
          and launches["flash_attention_bwd"] == want // 2,
          f"families: {label} wgmma flash launched "
          f"{launches['flash_attention_wgmma']} times, not {want}; its "
          f"backward {launches['flash_attention_bwd']}, not {want // 2}")
    check(launches["flash_attention_mma"] == 0,
          f"families: {label} mma.sync flash launched "
          f"{launches['flash_attention_mma']} times on a bf16 path")
    for name in ("fused_adamw", "bucket_pack"):
        check(launches[name] > 0, f"families: {label} {name} never launched")
    row = {
        "run": label, "arch": FAMILY_CELLS[label][0],
        "family": cfg.family, "layers": cfg.num_layers,
        "encoder_layers": cfg.encoder_layers, "experts": cfg.num_experts,
        "params": sum(t.numel() for t in state.params.values()),
        "batch": FAMILY_BATCH, "seq": seq,
        "microbatches": cfg.microbatches, "steps": FAMILY_STEPS,
        "steps_run": ran, "recovered_at": stats.recovered_at,
        "lost_steps": [FAMILY_FAIL - 1 - s for s in stats.recovered_at],
        "losses": stats.losses,
        "step_ms": stats.steady_iter * 1e3,
        "step_ms_all": [t * 1e3 for t in stats.iter_times],
        "capture_ms": float(np.median(stats.capture_times)) * 1e3,
        "peak_device_gb": peak / 1e9,
        "host_peak_rss_gb": rss.peak / 1e9 if rss.peak is not None else None,
        "train_s": train_s, "launches": launches,
        "flash_launches_predicted": want,
        "reduced_f32_losses": small, "full_width_f32_loss": wide,
        "checkpoint_bitwise_equal": True,
    }
    print(f"families: {label} ({row['arch']}, {cfg.family}, "
          f"{cfg.num_layers} layers, {row['params']} params): step "
          f"{row['step_ms']:.2f} ms, peak {row['peak_device_gb']:.2f} GB, "
          f"host RSS {row['host_peak_rss_gb']} GB, losses "
          f"{[round(x, 4) for x in stats.losses]}, recovered at "
          f"{stats.recovered_at}, launches {launches} (flash predicted "
          f"{want}, every call at a predicted shape); checkpoint bitwise; "
          f"reduced f32 card = CPU (rtol 1e-4); full width "
          f"{wide['layers']} layers f32 seq {wide['seq']}: card "
          f"{wide['cuda']} vs CPU {wide['cpu']} (rtol 1e-4; CPU "
          f"{wide['cpu_s']:.1f} s)", flush=True)
    del state, stats, shadow, ckpt
    _free()
    return row


def phase_families() -> dict:
    return {"batch": FAMILY_BATCH, "microbatches": FAMILY_MICROBATCHES,
            "steps": FAMILY_STEPS, "fail_at": FAMILY_FAIL,
            "runs": [family_run(label) for label in FAMILY_CELLS]}


# -- phase 9 -----------------------------------------------------------------

# Phase 9: serving, greedy, bf16 compute from f32 params held as the
# reference holds them (matmul weights cast once up front, norms and the
# SSM's dt_bias and A_log kept f32). label: (arch, config overrides, batch,
# prompt tokens, decode steps). The dense run is the slice's main run, at
# full width and depth; the others take phase 8's cut (FAMILY_CELLS) and its
# token sequence as the prompt (whisper's 448 after 1500 frames, llava's
# 1472 after 576 patches). Each decode step writes one cache position.
SERVE_DENSE = ("tinyllama-1.1b", {}, 8, 2048, 64)
SERVE_BATCH, SERVE_STEPS = 4, 32
# the f32 checks: FW_LAYERS layers (the hybrid one segment, whisper 2 + 2),
# batch 1, at most FW_SEQ prompt tokens, SERVE_FW_STEPS decode steps
SERVE_FW_STEPS = 4
SERVE_TOL = (1e-4, 1e-4)            # rtol, atol of the f32 logits


def serve_cells() -> dict:
    cells = {"dense": SERVE_DENSE}
    for label, (arch, over, seq) in FAMILY_CELLS.items():
        if label != "vit":             # no serving path (as in the reference)
            cells[label] = (arch, over, SERVE_BATCH, seq, SERVE_STEPS)
    return cells


def serve_cfg(label: str):
    from repro_torch import configs
    arch, over, *_ = serve_cells()[label]
    return dataclasses.replace(configs.get(arch), **over)


def serve_inputs(cfg, b: int, n_tokens: int, dtype, device) -> tuple:
    """Tokens (b, n_tokens) and the family's frames or patch embeddings,
    drawn from np.random.default_rng(0) in ``launch.serve``'s order and
    scale."""
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, n_tokens)),
                           device=device)
    extra = {}
    for name, family, n in (("frames", "audio", cfg.encoder_seq),
                            ("patch_embeds", "vlm", cfg.num_patches)):
        if cfg.family == family:
            extra[name] = torch.as_tensor(
                rng.standard_normal((b, n, cfg.d_model)),
                device=device).to(dtype) * 0.02
    return toks, extra


def _logits_close(got, want, what: str) -> float:
    rtol, atol = SERVE_TOL
    got, want = got.float().cpu(), want.float().cpu()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    err = (got - want).abs()
    ratio = (err / (rtol * want.abs() + atol)).max().item()
    check(ratio <= 1.0, f"{what}: max err {err.max().item()}, {ratio:.3f} "
                        f"times rtol {rtol} / atol {atol}")
    return err.max().item()


def serve_card_equals_cpu(label: str) -> dict:
    """``label``'s config cut to FW_LAYERS layers, f32, batch 1: prefill
    of at most FW_SEQ tokens and SERVE_FW_STEPS teacher-forced decode
    steps on the card (kernels) and on the CPU (plain versions) from the
    same weights, logits within SERVE_TOL; and on the card, the prefill's
    and each decode's logits equal the full forward's at those positions
    (the twin of tests/test_models.py's decode-vs-forward check). A MoE
    runs at capacity_factor E / top_k: no token drops in the forward over
    the whole sequence, as none drops in decode, else the two differ."""
    from repro_torch.launch.serve import max_seq_for
    from repro_torch.models import registry
    cfg = serve_cfg(label)
    over = dict(num_layers=(cfg.attn_every if cfg.family == "hybrid"
                            else min(cfg.num_layers, FW_LAYERS)),
                encoder_layers=min(cfg.encoder_layers, FW_LAYERS),
                compute_dtype="float32")
    if cfg.num_experts:
        over["capacity_factor"] = cfg.num_experts / cfg.top_k
    cfg = dataclasses.replace(cfg, **over)
    prompt, n = min(serve_cells()[label][3], FW_SEQ), SERVE_FW_STEPS
    params = {"cuda": registry.init_params(cfg, seed=0, device="cuda")}
    params["cpu"] = {k: v.cpu() for k, v in params["cuda"].items()}
    toks, extra = serve_inputs(cfg, 1, prompt + n, torch.float32, "cpu")
    max_seq = max_seq_for(cfg, prompt, n)
    out, secs = {}, {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        t = toks.to(dev)
        ex = {k: v.to(dev) for k, v in extra.items()}
        cache, logits = registry.prefill(params[dev], cfg, t[:, :prompt],
                                         max_seq, **ex)
        steps = [logits[:, -1]]
        for i in range(n):
            logits, cache = registry.decode_step(
                params[dev], cfg, cache, t[:, prompt + i:prompt + i + 1])
            steps.append(logits[:, -1])
        out[dev] = torch.stack(steps, dim=1).cpu()
        secs[dev] = time.perf_counter() - t0
        check(cache["length"] == max_seq,
              f"serving: {label} f32 cache length {cache['length']}")
    err_cpu = _logits_close(out["cuda"], out["cpu"],
                            f"serving: {label} f32 card vs CPU")
    with torch.no_grad():
        mod = registry.family_module(cfg)
        ex = [v.cuda() for v in extra.values()]
        full = mod.forward(params["cuda"], cfg, toks.cuda(), *ex)
        full = full[0] if cfg.family == "moe" else full
    err_fwd = _logits_close(out["cuda"], full[:, prompt - 1:prompt + n],
                            f"serving: {label} f32 prefill + decode vs the "
                            f"forward")
    del params, full
    return {"layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
            "prompt": prompt, "decode_steps": n,
            "max_err_card_vs_cpu": err_cpu, "max_err_vs_forward": err_fwd,
            "cpu_s": secs["cpu"], "card_s": secs["cuda"]}


def decode_loop(params, cfg, cache, tok, steps: int) -> dict:
    """Greedy decode of ``steps`` tokens from ``tok`` (b, 1): the step
    ``build_decode_step`` builds (argmax of the last logits), with the
    logits kept to check them finite. No host sync inside the loop; each
    step's device time by CUDA events."""
    from repro_torch.models import registry
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    finite = torch.ones((), dtype=torch.bool, device=tok.device)
    toks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events[0].record()
    for i in range(steps):
        logits, cache = registry.decode_step(params, cfg, cache, tok)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks.append(tok)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return {"tokens": torch.cat(toks, dim=1), "cache": cache,
            "finite": bool(finite), "wall_s": wall, "step_ms": step_ms}


def time_decode_attention(cache, cfg) -> dict:
    """The plain ``attention_decode`` at the dense run's last decode shape
    (layer 0's cache, every position written), beside its bound (the bytes
    of K and V it must read) and SDPA on the same inputs (kv expanded, a
    yardstick only)."""
    import torch.nn.functional as F
    from repro_torch.kernels.ref import expand_kv
    from repro_torch.models import layers as L
    kc, vc = cache["k"][0], cache["v"][0]
    b, S, kv, d = kc.shape
    h = cfg.num_heads
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(kc.dtype)
    length = cache["length"]
    nbytes = 2.0 * kc.numel() * kc.element_size()
    qt = q.transpose(1, 2)
    kt, vt = (expand_kv(t, h).transpose(1, 2) for t in (kc, vc))
    ms = time_ms(lambda: L.attention_decode(q, kc, vc, length), 20, 3)
    return {"shape": [b, S, h, kv, d], "dtype": str(kc.dtype).removeprefix(
        "torch."), "length": length, "ms": ms,
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "kv_bytes": nbytes, "sdpa_ms": time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt), 20, 3)}


def serve_run(label: str) -> dict:
    """One family's serving at full width: prefill (every attention call
    on the wgmma flash kernel, at a shape phase 2 held), greedy decode
    (no flash launch), a second decode from the same prefill giving the
    same tokens; checks it and returns its row."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import max_seq_for
    from repro_torch.models import registry
    from repro_torch.train.step import serving_params
    arch, _, b, prompt, steps = serve_cells()[label]
    cfg = serve_cfg(label)
    fw = serve_card_equals_cpu(label)
    _free()
    torch.cuda.reset_peak_memory_stats()
    seen, flash = collections.Counter(), ops.flash_attention

    def recording(q, k, v, causal, q_offset=0):
        seen[(*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
              q.dtype, causal)] += 1
        return flash(q, k, v, causal, q_offset)
    with RssPeak() as rss:
        t0 = time.perf_counter()
        params = serving_params(cfg, registry.init_params(cfg, seed=0,
                                                          device="cuda"))
        init_s = time.perf_counter() - t0
        toks, extra = serve_inputs(cfg, b, prompt, torch.bfloat16, "cuda")
        max_seq = max_seq_for(cfg, prompt, steps)
        prefill_ms = []
        for i in range(2):             # the first counted, the second warm
            ops.reset_launch_counts()
            ops.flash_attention = recording
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cache, logits = registry.prefill(params, cfg, toks, max_seq,
                                                 **extra)
                torch.cuda.synchronize()
                prefill_ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                ops.flash_attention = flash
            if i == 0:
                prefill_launches = ops.launch_counts()
                prefill_seen = dict(seen)
        check(bool(torch.isfinite(logits).all()),
              f"serving: {label} non-finite prefill logits")
        shapes = attention_shapes(cfg, prompt, b)
        check(prefill_seen == shapes,
              f"serving: {label} flash calls by shape {prefill_seen}, not "
              f"the predicted {shapes}")
        want = sum(shapes.values())
        check(prefill_launches["flash_attention_wgmma"] == want,
              f"serving: {label} prefill launched the wgmma flash "
              f"{prefill_launches['flash_attention_wgmma']} times, not {want}")
        check(prefill_launches["flash_attention_mma"] == 0,
              f"serving: {label} prefill launched the mma.sync flash "
              f"{prefill_launches['flash_attention_mma']} times")
        first = torch.argmax(logits[:, -1], dim=-1)[:, None]
        saved = {k: v.clone() if torch.is_tensor(v) else v
                 for k, v in cache.items()}
        ops.reset_launch_counts()
        run = decode_loop(params, cfg, cache, first, steps)
        decode_launches = ops.launch_counts()
        check(all(n == 0 for n in decode_launches.values()),
              f"serving: {label} decode launched {decode_launches}")
        check(run["finite"], f"serving: {label} non-finite decode logits")
        length = run["cache"]["length"]
        check(length == max_seq,
              f"serving: {label} cache length {length}, not {max_seq}")
        again = decode_loop(params, cfg, saved, first, steps)
        check(torch.equal(again["tokens"], run["tokens"]),
              f"serving: {label} a second decode from the same prefill gave "
              f"other tokens")
        decode_attn = (time_decode_attention(run["cache"], cfg)
                       if label == "dense" else None)
        peak = torch.cuda.max_memory_allocated()
    ms = run["step_ms"][1:]
    row = {
        "run": label, "arch": arch, "family": cfg.family,
        "layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
        "experts": cfg.num_experts,
        "params": sum(t.numel() for t in params.values()),
        "batch": b, "prompt": prompt, "decode_steps": steps,
        "cache_length": length, "init_s": init_s,
        "prefill_ms": prefill_ms[1], "prefill_first_ms": prefill_ms[0],
        "prefill_tokens_per_s": b * (max_seq - steps) / prefill_ms[1] * 1e3,
        "decode_ms_per_token": statistics.median(ms),
        "decode_ms_first": run["step_ms"][0],
        "decode_ms_again": statistics.median(again["step_ms"][1:]),
        "decode_tokens_per_s": b * steps / run["wall_s"],
        "decode_wall_s": run["wall_s"],
        "prefill_launches": prefill_launches,
        "flash_launches_predicted": want,
        "flash_shapes": [[*k[:6], str(k[6]).removeprefix("torch."), k[7], n]
                         for k, n in shapes.items()],
        "decode_launches": decode_launches,
        "sample_tokens": run["tokens"][0, :8].tolist(),
        "second_decode_same_tokens": True,
        "peak_device_gb": peak / 1e9,
        "host_peak_rss_gb": rss.peak / 1e9 if rss.peak is not None else None,
        "f32_check": fw,
    }
    if decode_attn is not None:
        # the whole step's bound: every weight but the embedding table (b
        # rows of it are gathered) and every layer's K and V, read once
        nbytes = sum(t.numel() * t.element_size() for k, t in params.items()
                     if k != "embed") + decode_attn["kv_bytes"] * cfg.num_layers
        decode_attn.update(step_ms=row["decode_ms_per_token"],
                           step_bound_ms=nbytes / H100_BYTES_PER_S * 1e3,
                           step_bytes=nbytes)
        row["decode_attention"] = decode_attn
    print(f"serving: {label} ({arch}, {cfg.family}, {cfg.num_layers} "
          f"layers, {row['params']} params), batch {b} x prompt {prompt} + "
          f"{steps} decode steps: prefill {prefill_ms[1]:.2f} ms (first "
          f"{prefill_ms[0]:.2f}), decode {row['decode_ms_per_token']:.3f} ms "
          f"a token (median after the first; {row['decode_tokens_per_s']:.1f}"
          f" tokens/s), peak {row['peak_device_gb']:.2f} GB, host RSS "
          f"{row['host_peak_rss_gb']} GB; prefill flash {prefill_launches} "
          f"(predicted {want}, every call at a predicted shape), decode "
          f"{decode_launches}; second decode same tokens; f32 "
          f"{fw['layers']} layers, prompt {fw['prompt']}: card vs CPU max "
          f"err {fw['max_err_card_vs_cpu']}, vs forward "
          f"{fw['max_err_vs_forward']} (CPU {fw['cpu_s']:.1f} s)", flush=True)
    if decode_attn is not None:
        print(f"serving: attention_decode (plain) at {decode_attn['shape']} "
              f"{decode_attn['dtype']}, length {decode_attn['length']}: "
              f"{decode_attn['ms']:.4f} ms, bound {decode_attn['bound_ms']:.4f}"
              f" ms (K and V bytes), SDPA {decode_attn['sdpa_ms']:.4f} ms; "
              f"the decode step {decode_attn['step_ms']:.3f} ms, bound "
              f"{decode_attn['step_bound_ms']:.4f} ms (weights and every "
              f"layer's K and V)", flush=True)
    del params, cache, saved, run, again, logits
    _free()
    return row


def phase_serving() -> dict:
    return {"steps_dense": SERVE_DENSE[4], "steps": SERVE_STEPS,
            "tolerance_f32": {"rtol": SERVE_TOL[0], "atol": SERVE_TOL[1]},
            "runs": [serve_run(label) for label in serve_cells()]}


# -- phase 10 ----------------------------------------------------------------

def _reduced(arch: str):
    from repro_torch import configs
    return configs.get(arch).reduced()


def benchmark_cells() -> list:
    """Every model phase 10 runs, as (cfg, token seq, batch per call of the
    flash kernel): the figure twins' cells on the card and the examples'.
    Phase 2 holds the flash kernels at each of their attention shapes."""
    from repro_torch.benchmarks import (correctness, shadow_timing, stalls,
                                        throughput)
    from repro_torch.benchmarks.common import card_config
    from repro_torch.examples import (failure_recovery, fabric_failures,
                                      quickstart, serve_decode, train_100m)
    cuda = torch.device("cuda")
    train = [(card_config("gpt3-xl", stalls.CARD["layers"]),
              stalls.CARD["batch"], stalls.CARD["seq"])]
    train += [(card_config(a, layers), b, s)
              for a, b, s, layers in throughput.CARD_MODELS]
    train += shadow_timing.cells(cuda)
    train += [(correctness.default_config(cuda), correctness.BATCH,
               correctness.SEQ),
              (_reduced("tinyllama-1.1b"), quickstart.BATCH, quickstart.SEQ),
              (_reduced(failure_recovery.SCENARIO.arch),
               failure_recovery.SCENARIO.batch,
               failure_recovery.SCENARIO.seq),
              (_reduced(fabric_failures.RECOVERY.arch),
               fabric_failures.RECOVERY.batch, fabric_failures.RECOVERY.seq),
              (train_100m.config(), train_100m.BATCH, train_100m.SEQ)]
    cells = [(cfg, seq, batch // cfg.microbatches)
             for cfg, batch, seq in train]
    cells += [(_reduced(a), serve_decode.PROMPT, serve_decode.BATCH)
              for a in serve_decode.ARCHS]
    return cells


def train_flash(cfg, batch: int, seq: int, steps_run: int) -> dict:
    """The flash calls ``steps_run`` executed training steps make: forward
    and remat recompute, per attention call and microbatch."""
    mb = cfg.microbatches
    return {k: 2 * n * mb * steps_run
            for k, n in attention_shapes(cfg, seq, batch // mb).items()}


# durability_timing --json's steps on the card (the JAX module's 6, cut for
# the script's time limit: each raw epoch writes the whole state)
DURABILITY_STEPS = 2


def phase_benchmarks() -> tuple[dict, dict]:
    """Phase 10: the paper's benchmark twins that touch the device, then
    the six examples, on the card. Each run's flash calls are recorded by
    shape and held against the shapes phase 2 checked and the count its
    runs predict; AdamW and the pack against their predicted counts where
    a run fixes them, else launched; the mma.sync flash kernel never.
    Returns the ``benchmarks`` and ``examples`` lines."""
    from repro_torch.benchmarks import (correctness, durability_timing,
                                        kernels, multicast_overhead,
                                        optimizer_scaling, shadow_timing,
                                        stalls, throughput)
    from repro_torch.benchmarks.common import card_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.buckets import build_buckets
    from repro_torch.examples import (cost_planner, fabric_failures,
                                      failure_recovery, quickstart,
                                      serve_decode, train_100m)
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import model_flops_for
    from repro_torch.models import registry
    held = set(flash_cases()[0])
    flash = ops.flash_attention

    def drive(label: str, fn, predict):
        """Run ``fn()``; ``predict(result)`` gives the run's predicted
        {shape: flash calls} and {kernel: launches} (None: at least one)."""
        _free()
        seen = collections.Counter()

        def recording(q, k, v, causal, q_offset=0):
            seen[(*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                  q.shape[3], q.dtype, causal)] += 1
            return flash(q, k, v, causal, q_offset)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        ops.flash_attention = recording
        try:
            result = fn()
        finally:
            ops.flash_attention = flash
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.launch_counts()
        shapes, counts = predict(result)
        check(set(seen) <= held,
              f"benchmarks: {label} flash at shapes phase 2 did not hold: "
              f"{set(seen) - held}")
        check(dict(seen) == shapes,
              f"benchmarks: {label} flash calls by shape {dict(seen)}, not "
              f"the predicted {shapes}")
        # a training run's backward follows its forward and remat
        want = {"flash_attention_bwd": sum(shapes.values()) // 2, **counts,
                "flash_attention_mma": 0,
                "flash_attention_wgmma": sum(shapes.values())}
        for name, n in want.items():
            check(launches[name] == n if n is not None else
                  launches[name] > 0,
                  f"benchmarks: {label} launched {name} {launches[name]} "
                  f"times, not {'some' if n is None else n}")
        print(f"benchmarks: {label} {secs:.1f} s, launches {launches}",
              flush=True)
        return result, secs, launches

    def flash_of(records) -> dict:
        total = collections.Counter()
        for r in records:
            cfg = card_config(r["arch"], r["layers"],
                              microbatches=r["microbatches"])
            total.update(train_flash(cfg, r["batch"], r["seq"],
                                     r["steps_run"]))
        return dict(total)

    lines = {}

    # kernels: each call checked once, then WARMUP + REPS timed calls
    calls = 1 + kernels.WARMUP + kernels.REPS
    main_layout = build_buckets(
        [(k, tuple(sp.shape), "float32") for k, sp in sorted(
            registry.param_specs(card_config(kernels.MAIN_ARCH)).items())])
    pack_per_call = sum(-(-len(b.slots) // 128) for b in main_layout.buckets)
    shape = kernels.FLASH_SHAPE
    rows, secs, launches = drive("kernels", lambda: kernels.run("cuda"),
                                 lambda _: ({(shape[0], shape[1], shape[1],
                                              shape[2], shape[3], shape[4],
                                              torch.bfloat16, True): calls},
                                            {"fused_adamw": calls,
                                             "bucket_pack": calls
                                             * pack_per_call,
                                             "flash_attention_bwd": 0}))
    lines["kernels"] = dict(rows=rows, seconds=secs,
                            launches=launches)

    # the channel rows' shadow runs SGD: no AdamW launch
    rows, secs, launches = drive(
        "multicast_overhead", lambda: multicast_overhead.run(device="cuda"),
        lambda _: ({}, {"fused_adamw": 0, "bucket_pack": None}))
    drops = [r for r in rows if r[0].startswith("fig10.rf")
             and "drops=0" not in r[2]]
    check(not drops, f"benchmarks: fabric rows with drops {drops}")
    lines["multicast_overhead"] = dict(rows=rows, seconds=secs,
                                       launches=launches,
                                       gates={"fabric_drops_0": True})

    # Fig 8, per node count: a warm-up delivery to every node, then each
    # node's warm-up and REPS timed applies (2 + REPS AdamW launches a
    # bucket); the bootstrap packs params, mu and nu and the warm-up send
    # the gradients (4 packs of every bucket)
    scaling_cfg = optimizer_scaling.default_config(torch.device("cuda"))
    specs = registry.param_specs(scaling_cfg)
    scaling_layout = build_buckets([(k, tuple(sp.shape), "float32")
                                    for k, sp in specs.items()])
    n_b = len(scaling_layout.buckets)
    n_counts = len(optimizer_scaling.NODES)
    rows, secs, launches = drive(
        "optimizer_scaling", lambda: optimizer_scaling.run(device="cuda"),
        lambda _: ({}, {"fused_adamw": n_counts * n_b
                        * (2 + optimizer_scaling.REPS),
                        "bucket_pack": n_counts * 4 * sum(
                            -(-len(b.slots) // 128)
                            for b in scaling_layout.buckets)}))
    lines["optimizer_scaling"] = dict(
        rows=rows, seconds=secs, launches=launches,
        model=scaling_cfg.name, layers=scaling_cfg.num_layers,
        buckets=n_b)

    def model_twin(label, fn):
        record = []
        rows, secs, launches = drive(
            label, lambda: fn(record),
            lambda _: (flash_of(record), {"fused_adamw": None,
                                          "bucket_pack": None}))
        for r in record:
            if r["system"] == "checkmate":
                check(r["checkpoints"] == r["steps_run"],
                      f"benchmarks: {label} {r['arch']} checkmate "
                      f"checkpointed {r['checkpoints']} of "
                      f"{r['steps_run']} steps")
            if r["system"] == "checkfreq":
                # past its profiled steps CheckFreq runs at the interval
                # it tuned, so it checkpoints less often than every step
                check(r["tuned_freq"] is not None
                      and r["checkpoints"] < r["steps_run"],
                      f"benchmarks: {label} {r['arch']} checkfreq tuned "
                      f"{r['tuned_freq']}, {r['checkpoints']} checkpoints "
                      f"in {r['steps_run']} steps")
            check(all(math.isfinite(x) for x in r["losses"]),
                  f"benchmarks: {label} {r['arch']} {r['system']} "
                  f"non-finite loss")
        lines[label] = dict(rows=rows, seconds=secs,
                            launches=launches, runs=record,
                            gates={"checkmate_checkpoints_every_step": True,
                                   "checkfreq_tuned_interval": True})
        return record

    model_twin("stalls", lambda rec: stalls.run("cuda", record=rec))
    tput = model_twin("throughput",
                      lambda rec: throughput.run("cuda", record=rec))
    model_twin("shadow_timing", lambda rec: shadow_timing.run("cuda",
                                                              record=rec))

    out_dir = os.path.join(ROOT, "build")
    rc_report, secs, launches = drive(
        "shadow_timing --json", lambda: shadow_timing.run_json(
            os.path.join(out_dir, "BENCH_shadow.json"), device="cuda"),
        lambda _: ({}, {"fused_adamw": None, "bucket_pack": None}))
    rc, report = rc_report
    check(rc == 0, f"benchmarks: shadow_timing --json gates failed: "
                   f"{report['fails']}")
    lines["shadow_timing_json"] = dict(report=report, seconds=secs,
                                       launches=launches,
                                       gates={"all": True})

    rc_report, secs, launches = drive(
        "durability_timing --json", lambda: durability_timing.run_json(
            os.path.join(out_dir, "BENCH_durability.json"),
            steps=DURABILITY_STEPS, device="cuda"),
        lambda _: ({}, {"fused_adamw": None, "bucket_pack": None}))
    rc, report = rc_report
    check(rc == 0 and report["raw"]["restore_bitwise"],
          f"benchmarks: durability_timing --json gates failed: "
          f"{report['fails']}")
    lines["durability_timing_json"] = dict(report=report, seconds=secs,
                                           launches=launches,
                                           gates={"all": True})

    record = {}
    rows, secs, launches = drive(
        "correctness", lambda: correctness.run("cuda", record=record),
        lambda _: (train_flash(correctness.default_config(
            torch.device("cuda")), record["batch"], record["seq"],
            record["steps_run"]), {"fused_adamw": None,
                                   "bucket_pack": None}))
    check(record["states_bit_identical"] and record["recoveries"] == 3,
          f"benchmarks: correctness bit-identical "
          f"{record['states_bit_identical']}, recoveries "
          f"{record['recoveries']}")
    lines["correctness"] = dict(rows=rows, seconds=secs,
                                launches=launches, run=record,
                                gates={"states_bit_identical": True,
                                       "recoveries_3": True})

    # the share of the bf16 peak each figure model's measured step reaches
    # (throughput's no-checkpoint run; printed, not gated)
    mfu = {}
    for r in tput:
        if r["system"] != "no_checkpoint":
            continue
        cfg = card_config(r["arch"], r["layers"],
                          microbatches=r["microbatches"])
        tokens = r["seq"] + (cfg.num_patches if cfg.family == "vlm" else 0)
        flops = model_flops_for(cfg, ShapeConfig("card", tokens, r["batch"],
                                                 "train"))
        mfu[r["arch"]] = {"layers": r["layers"], "batch": r["batch"],
                          "tokens": tokens, "step_s": r["steady_iter_s"],
                          "model_flops": flops,
                          "bf16_peak_share": flops / r["steady_iter_s"]
                          / H100_BF16_FLOPS}
    print(f"benchmarks: share of the bf16 peak (989 TFLOP/s) by figure "
          f"model's step: {json.dumps(mfu)}", flush=True)
    lines["bf16_peak_share"] = mfu

    # -- the examples, at their own sizes ------------------------------------
    examples = {}

    def example(label, fn, predict):
        facts, secs, launches = drive(f"example {label}", fn, predict)
        examples[label] = dict(seconds=secs, launches=launches,
                               facts=_jsonable(facts))
        return facts

    counts = {"fused_adamw": None, "bucket_pack": None}
    example("quickstart", lambda: quickstart.main(["--device", "cuda"]),
            lambda f: (train_flash(_reduced("tinyllama-1.1b"), f["batch"],
                                   f["seq"], f["steps_run"]), counts))
    example("failure_recovery",
            lambda: failure_recovery.main(["--device", "cuda"]),
            lambda f: (train_flash(_reduced(f["arch"]), f["batch"],
                                   f["seq"], f["steps_run"]), counts))
    example("fabric_failures",
            lambda: fabric_failures.main(["--device", "cuda"]),
            lambda f: (train_flash(_reduced(f["arch"]), f["batch"],
                                   f["seq"], f["steps_run"]), counts))
    example("cost_planner", lambda: cost_planner.main(["--device", "cuda"]),
            lambda f: ({}, {"fused_adamw": 0, "bucket_pack": 0}))

    def serve_flash(_):
        total = collections.Counter()
        for a in serve_decode.ARCHS:
            total.update(attention_shapes(_reduced(a), serve_decode.PROMPT,
                                          serve_decode.BATCH))
        return dict(total), {"fused_adamw": 0, "bucket_pack": 0,
                             "flash_attention_bwd": 0}
    example("serve_decode", lambda: serve_decode.main(["--device", "cuda"]),
            serve_flash)
    facts = example(
        "train_100m", lambda: train_100m.main(["--device", "cuda"]),
        lambda f: (train_flash(train_100m.config(), f["batch"], f["seq"],
                               f["steps_run"]), counts))
    check(facts["recoveries"] == 1 and facts["shadow_bit_identical"],
          f"examples: train_100m {facts}")
    return lines, examples


def _jsonable(x):
    """``x`` with what json cannot write (dataclasses, tensors, dicts with
    int keys) turned into plain values."""
    if dataclasses.is_dataclass(x):
        return _jsonable(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.tolist()
    return x


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import configs
    cfg = configs.get("tinyllama-1.1b")
    dev = torch.device("cuda")

    secs, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        secs[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    phase_build()
    lap("build")
    errs = {"fused_adamw": check_adamw(dev), "bucket_pack": check_pack(dev),
            **check_flash(dev)}
    rows, flash_extra, pack_host = time_kernels(dev, cfg, errs)
    lap("kernels")
    small_launches = phase_small()
    lap("small")
    main_out, launches = phase_main(cfg)
    lap("main")
    ranks = phase_ranks(cfg)
    lap("ranks")
    dryrun = phase_dryrun(cfg)
    lap("dryrun")
    # each kernel's launches on its path: the f32 flash kernel's is phase
    # 3's full-width run, every other kernel's phase 4
    for r in rows:
        r["launches"] = (small_launches if r["name"] == "flash_attention_mma"
                         else launches)[r["name"]]
    ckpts = phase_checkpointers(cfg, dev)
    lap("checkpointers")
    durability = phase_durability(cfg, main_out["step_ms"])
    lap("durability")
    harness = phase_harness()
    lap("harness")
    families = phase_families()
    lap("families")
    serving = phase_serving()
    lap("serving")
    bench, examples = phase_benchmarks()
    lap("benchmarks")
    # the flash row at the dense serving run's prefill shape: its launches
    # are that run's prefill's
    flash_extra["flash_prefill"]["launches"] = \
        serving["runs"][0]["prefill_launches"]["flash_attention_wgmma"]
    # the expert-parallel and FSDP ranks' rows: one step of phase 4c's
    # arctic yardsticks
    flash_extra["flash_ep_rank"]["launches"] = \
        dryrun["ep_yardstick"]["launches"]["flash_attention_wgmma"]
    flash_extra["flash_fsdp_rank"]["launches"] = \
        dryrun["fsdp_yardstick"]["launches"]["flash_attention_wgmma"]
    # the tensor-parallel serving rank's row: phase 4c's serving
    # yardstick's prefill
    flash_extra["flash_tp_serve_rank"]["launches"] = \
        dryrun["serve_yardstick"]["prefill_launches"]["flash_attention_wgmma"]
    # the family ranks' rows: one step of phase 4c's family yardsticks,
    # the calls at the row's shape
    for name, (label, shape) in family_rank_flash().items():
        flash_extra[name]["launches"] = dryrun["family_yardsticks"][label][
            "flash_by_shape"].get(flash_key(shape), 0)
    print(f"timing: seconds by phase {secs}", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the flash rows also name their shape and dtype, the unit of their
    # bound and, for the mma.sync kernel, the f32 units' bound beside it
    more = ("shape", "skv", "q_offset", "causal", "dtype", "bound_unit",
            "other_bound_ms", "other_bound_by",
            "other_bound_unit", "added_mb", "plain_added_mb", "rel_err_ratio")
    print(json.dumps({"main_path": main_out}))
    print(json.dumps({"ranks": ranks}))
    print(json.dumps({"dryrun": dryrun}))
    for label, r in flash_extra.items():
        print(json.dumps({label: {k: r[k] for k in keys + more if k in r}}))
    print(json.dumps({"pack_host": pack_host}))
    print(json.dumps({"kernels": [{k: r[k] for k in keys + more if k in r}
                                  for r in rows]}))
    print(json.dumps({"checkpointers": ckpts}))
    print(json.dumps({"durability": durability}))
    print(json.dumps({"harness": harness}))
    print(json.dumps({"families": families}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"benchmarks": bench}))
    print(json.dumps({"examples": examples}))
    print(card_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
