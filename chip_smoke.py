#!/usr/bin/env python3
"""Smoke run of horovod_tpu_torch on one NVIDIA GPU (H100): ``python3
chip_smoke.py``.

Phases, in order; any failure exits nonzero and prints no result:

1. the card's name and power limit (nvidia-smi), TF32 off, and the build of
   every CUDA kernel from ``horovod_tpu_torch/ops/csrc`` (nvcc, in
   parallel, with the planted-fault builds of ``_build.PLANTED``), with
   build seconds and ptxas's register/spill report;
2. each kernel against its plain PyTorch version on the card: at GPT-2
   medium's attention shapes (B 8, T 1024, H 16, d 64, bf16, causal) and at
   ragged shapes with key bias, segment ids and ``causal_offset=-1`` and
   cross-attention shapes at d 128, in bf16 (all three kernels on the tensor
   cores: forward, dQ and dK/dV) and in fp32 (the FMA kernels), and at B 8,
   T 1024, H 8, d 128 in bf16, each
   output element by element (tolerances at ``BF16_TOL``/``F32_TOL``; the
   worst share of the bound is printed); at the main shapes the same check
   must also catch four planted faults (a scale off by 1 %, a strict causal
   mask, a dropped last key tile, and kernels built to round P and dS to
   bf16 once, caught on O, dQ, dK and dV); then median times of each
   kernel, one call between two
   events and over 10 back-to-back calls, with its achieved TFLOP/s, its
   plain version, and, as a yardstick only, ``scaled_dot_product_attention``
   forward and backward (the port never calls it), at the main shapes and at
   d 128;
3. the main path: ``hvd.init()`` (one rank, NCCL), GPT-2 medium at full
   width and depth with ``attention="flash"``, ``broadcast_parameters``,
   ``DistributedOptimizer(AdamW)`` for 5 steps on a fixed seeded batch. The
   loss must be finite and falling and every kernel's launch count must grow
   by ``num_layers`` a step. A tiny fp32 GPT-2 checks flash against dense
   attention first.
4. the reference's headline models and the rest of the collective API, on
   a new one-rank NCCL world: a tiny fp32 ResNet on the card against the
   same on the CPU (logits, a gradient), with cross-replica BN, and its
   space-to-depth stem against the conv stem; ResNet-50 at the bench's
   shape (``bench.py:186-235``: B 128, 224x224, bf16, 1000 classes,
   ``channels_last``, local BN) through ``broadcast_parameters`` and
   ``DistributedOptimizer(SGD(0.1, momentum 0.9))`` for 5 steps on a
   seeded fixed batch (loss finite and falling, running statistics finite
   and moved; images/s, the step split, peak memory and the share of the
   tensor-core bound printed); one step with bf16 BN statistics and the
   s2d stem; the MNIST CNN at the bench's shape (B 512, fp32, 5 steps); and
   every new collective once on NCCL with card tensors. This path runs no
   kernel of the port's own (the reference computes it outside Pallas), so
   no kernel may launch in it.
5. the reference's BERT-large, ViT-B/16 and Llama-340M on the flash
   kernels, Adasum and the join mask, on a new one-rank NCCL world: the
   three kernels against their plain versions at each model's attention
   shape (``PATHS``: BERT B 8, T 512, non-causal with a zero key bias, and
   once with the last 64 keys of two rows padded; ViT B 128, T 197,
   non-causal; Llama B 4, T 2048, causal, K and V expanded from 4 heads;
   all bf16, d 64), with their times, bounds, plain times and SDPA with the
   same mask; tiny fp32 BERT, ViT and Llama on the card against the CPU
   (logits, a gradient) and flash against dense; each model trained at
   full width for 5 steps through ``broadcast_parameters`` and
   ``DistributedOptimizer(AdamW(1e-4))`` (BERT with ``op=Adasum``), the
   loss finite and falling and each kernel launched ``num_layers`` times a
   step, with tokens or images per second, the step split, peak memory
   and the share of the tensor-core bound; Adasum on the card (the
   identity on one rank, its arithmetic against float64 on the CPU) and
   the join mask (``alive``).
6. the controller on the card, on a new one-rank NCCL world: phase 3's
   GPT-2 medium run again under ``start_timeline`` (before ``init``),
   ``start_metrics_flusher`` and the stall watchdog ``init`` starts. The
   trace must be valid JSON with init's ``clock_anchor``, every op must
   have one QUEUE and one EXEC event and the op ids must run 1..N; the
   growth of ``collective_calls_total`` (5 allreduces, one broadcast per
   state tensor) and of ``fusion_buckets_total`` (5 times the gradients'
   bucket plan) must be what the steps issued, the metrics file must hold
   the count, each kernel must launch 24 times a step, and the losses must
   equal phase 3's within ``LOSS_TOL``; the median step time is printed
   beside phase 3's. Then a planted stall (a ``collective_begin`` with no
   end under a ``StallWatchdog(timeout_s=0.2)``) must fire exactly one
   report naming the tensor, add one to ``stall_events_total`` and leave
   one ``collective_stall`` marker. With two cards,
   ``tools/torch_controller_bench.py --np 2`` runs the join service, a
   mismatch and the negotiation timing on a two-rank NCCL world; with one
   card a line says it did not run.
7. collective depth, on a new one-rank NCCL world: (a) the quantized
   allreduce (``ops/quantized.py``) at GPT-2 medium's gradient bucket
   sizes, int8 and fp8: codes and scales on the card equal the CPU's, the
   result equals the plain CPU computation bit for bit and lies within
   one step of each block of its input, and codes made with a scale one
   step off must fail the code check; (b) phase 3's GPT-2 medium under
   ``DistributedOptimizer(overlap=True)`` (gradient hooks issue the
   buckets during the backward): the losses equal phase 3's within
   ``LOSS_TOL``, every step issues buckets before the backward returns,
   at most one negotiation round a step, 24 launches of each kernel a
   step, the median step time printed beside phase 3's; (c) the same with
   ``Compression.int8`` and error feedback: the losses inside
   ``INT8_LOSS_BAND`` of phase 3's, the residual nonzero; and one step
   with ``Compression.fp8``; (d) with two cards
   ``tools/torch_collective_bench.py --np 2`` at 1, 64 and 1024 MB; with
   one card a line says it did not run.
8. elastic training of phase 3's GPT-2 medium, committing a
   ``TorchState`` and saving it through ``ShardedCheckpointManager
   (max_to_keep=2)`` every step (the disk must hold three saves): (a)
   ``runner.run_elastic(np=1, spares=1)`` of
   ``tools/torch_elastic_worker.py`` with ``kill@rank=0,step=4``: one
   restart, the spare held no CUDA context in standby, it resumed from the
   newest published step, every step's loss equals phase 3's within
   ``LOSS_TOL`` and each kernel launched 24 times in every step that ran;
   the recovery time and its parts, a save's seconds and bytes, how long
   ``save()`` held the step and the step time with saves are printed; (b)
   on a new one-rank NCCL world, an in-process reset under
   ``@elastic.run`` after step 2's commit: the state rolls back, the group
   is re-formed (``init_epoch`` + 1), the same losses and launches, the
   commit's and the reset's times; (c) with two cards, two-rank runs with
   ``kill@rank=1,step=3`` with and without a spare against a golden
   two-rank run; with one card a line says it did not run.
9. the rest of the model zoo, on a new one-rank NCCL world, every run
   bf16, 5 steps, seed 0, ``broadcast_parameters`` and
   ``DistributedOptimizer(AdamW(1e-4))``: (a) the three kernels against
   their plain versions, with times, bounds and SDPA under the same mask,
   at GPT-2 medium's 4k shape (B 2, H 16, T 4096, causal) and at the
   packed batch (B 8, T 1024, ``bench.py:611-616``'s segment ids); (b)
   GPT-2 medium as phase 3 without remat, under ``remat_policy="dots"``
   and under ``"full"``: phase 3's losses within ``LOSS_TOL``, peak memory
   full < dots < none, and the forward kernel launched twice a layer under
   remat (a block's ``Dense`` layers must reach ``mm`` / ``addmm``, which
   ``dots`` saves); (c) ``gpt2_long``, GPT-2 medium at 4096 tokens (B 2,
   dots); (d) ``gpt2_packed`` (packed positions and loss, dots) after a
   tiny fp32 packed GPT-2 on the card against the CPU; (e) a Mixtral-style
   Llama (Llama-340M's shape with 8 experts, top-2, capacity 1.25, dots,
   ``loss_fn_moe``; the aux loss and the share of dropped choices a step)
   after a tiny fp32 MoE Llama on the card against the CPU and a check that
   its block's dispatch and combine reach ``mm`` and its experts ``bmm``;
   (f) T5-small (B 16, 512/512, dots), on which no kernel may launch; (g)
   greedy decode with bf16 weights of GPT-2 medium (B 8, prompt 32, 480
   new), Llama-340M (64 new) and T5-small (``t5_generate``, 32 new): the
   decode logits at every position within ``DECODE_ATOL`` of the dense
   forward's, and every generated token equal to the forward's
   ``greedy_token`` where its top two logits differ by more than
   ``DECODE_CLEAR_GAP``; tokens/s, ms a step beside its HBM bound, aten ops
   a step. Every loss must be finite and falling and every kernel launch
   count as stated.
10. long context, on a new one-rank NCCL world, bf16, seed 0: (a) the
   three kernels against their plain versions at a ring hop's shape (B 2,
   H 16, 4096 tokens a shard, d 64) with the queries' packed segment ids
   against the neighbour shard's (``seg_q != seg_k``) in the full, causal
   and strict (``offset=-1``) modes, the backward given an outside lse and
   delta, under ``BF16_TOL``; kernels fed ``seg_q`` as their ``seg_k`` must
   fail; times, bounds and SDPA under the same mask; (b) four virtual ranks
   of a 16384-token sequence (B 1, H 16) through ``ops/ring_flash.py``'s
   per-hop functions, each hop fed the block the ring would deliver, for
   the contiguous and striped causal rings, a non-causal ring with a key
   mask and a causal ring with packed segment ids: the assembled O, dQ,
   dK, dV against ``flash_attention`` over the whole sequence within the
   bound ``RING_ROUNDING`` derives from one bf16 rounding per hop, and r +
   1 hops launched on virtual rank r under the contiguous causal mask, n
   otherwise; (c) ``gpt2_long`` with ``use_ring_attention=True`` under the
   contiguous ring, the striped ring (``striped_lm_loss``) and Ulysses:
   phase 9 (c)'s losses within ``LOSS_TOL`` (its own ``gpt2_long`` run when
   phase 9 did not run), 48 / 24 / 24 launches a step, ms a step, tokens/s
   and peak memory beside phase 9 (c)'s; (d) with two cards
   ``tools/torch_ring_bench.py --np 2``: GPT-2 medium at 8192 tokens over
   two ranks, striped and Ulysses, against one card within
   ``SP_LOSS_BAND``, and a hop's exchange against its kernels; with one
   card a line says it did not run.
11. the rest of the data-parallel step and ZeRO-1, on a new one-rank NCCL
   world, bf16, seed 0, phase 3's GPT-2 medium and batch (through a
   ``ShardedBatchIterator``, shuffle off) for 5 steps: (a)
   ``hvd.value_and_grad`` over ``torch.func.functional_call`` with a plain
   ``torch.optim.AdamW`` (one eager and one in-step allreduce a step), then
   ``grad(overlap=True)`` (one in-step tap a parameter, no eager allreduce,
   no round): phase 3's losses within ``LOSS_TOL``; (b)
   ``sharded_adamw(1e-4, weight_decay=1e-4, eps=1e-8)``: after step 1 its
   mu and nu equal AdamW's ``exp_avg`` and ``exp_avg_sq`` flattened in the
   reference's (sorted) order under ``F32_TOL`` and not in registration
   order, and its losses lie within ``ZERO1_LOSS_BAND`` of phase 3's; (d)
   (b)'s state saved before step 3 through ``save_state`` of a
   ``TensorState`` and adopted into a fresh one: step, mu, nu and the
   parameters bit for bit, and the resumed step's loss equal to the
   uninterrupted run's; (c) ``AutotunedStep`` over (a)'s step with its
   allreduce at the tuner's threshold (2 probes of 2 samples): converged,
   one build a probe, the step gauge and histogram set, losses falling;
   every path launching each kernel 24 times a step, with ms a step, peak
   memory and the moments' bytes; (e) with two cards
   ``tools/torch_zero_bench.py --np 2`` (ZeRO-1 on two ranks against one,
   ceil(L/2) moments a rank, a two-rank save restored on one bit for bit);
   with one card a line says it did not run. Without phase 3 it runs phase
   3's path itself first.
12. FSDP / ZeRO-3, ZeRO-2 and ``FsdpState``, on a new one-rank NCCL world,
   phase 3's GPT-2 medium, weights, batch and AdamW settings (lr 1e-4,
   weight decay 1e-4, eps 1e-8), 5 steps each: (a) the 24 blocks as
   ``stack_layer_shards`` rows on the card through ``fsdp_scan_blocks``
   (``module_block_fn`` over meta-device blocks) with ``fsdp_adamw``, the
   rest replicated under ``sharded_adamw``: losses within
   ``ZERO1_LOSS_BAND`` of phase 3's and their gap to phase 11 (b)'s
   printed, K1 48 and K2, K3 24 launches a step, 48 in-step all-gathers
   and 24 reduce-scatters a step and no negotiation round, ms a step,
   peak memory and the rows' bytes; (b) ``gather_shard`` at one block's
   width on the bf16 and int8 wires inside the quantizer's bound (half a
   block scale; bf16 half an ulp), then (a) with ``zero3_apply`` on each
   wire: losses finite and falling, their gap to (a); (c) ZeRO-2
   (``zero2_grad_shard`` of the local gradients, ``zero2_update``) over
   the whole model: losses within the band, the gap to phase 11 (b), the
   moments' bytes, 24 launches a step; (d) an ``FsdpState`` (and a
   ``TensorState`` of the replicated part) committed after step 2: after
   two more steps ``restore()`` gives the rows, mu, nu and step back bit
   for bit and the two steps repeat their losses exactly; ``save`` then
   ``load`` into a fresh state gives the canonical arrays; (e) with two
   cards ``tools/torch_zero_bench.py --stage 3`` at 2 (and 4) ranks, and
   ``--mesh dp2xmp2`` with four; with one card a line says it did not
   run. Without phase 3 it runs phase 3's path itself first.
13. Megatron tensor parallelism (``parallel/mp.py``), on a new one-rank
   NCCL world: (a) phase 3's GPT-2 medium through ``mp.tensor_parallel``
   over the mesh's mp set, ``mp.vocab_parallel_loss`` and
   ``DistributedOptimizer`` over the dp set, 5 steps at mp 1: phase 3's
   losses bit for bit, 24 launches of each kernel a step, ms a step and
   peak memory; the three kernels against their plain versions at the
   local head count of GPT-2 medium split over 2 and 4 ranks (B 8, T 1024,
   8 and 4 heads, d 64, causal, bf16: BH 64 and 32), with their times,
   bounds, plain times and SDPA; (b) GPT-2 medium with random biases
   split by ``split_params`` over 2 and 4 virtual ranks on the one card
   (``tp_virtual_logits``: one thread a rank runs the port's wired
   tensor-parallel model and ``vocab_parallel_loss``'s arithmetic, with
   g and the max reduced over the threads; the vocab slices of the logits
   concatenated), held against the dense forward's logits and the fp32
   forward's within twice the dense bf16 forward's own error against
   fp32 (the bound, derived on the card), every rank's loss within rtol
   1e-5 of ``loss_fn`` on the same logits; a contiguous qkv split and a
   row bias added on every rank must leave the bound; K1 launched 24
   times a virtual rank; (c) ``tp_decode_step`` at mp
   1 on the model's state dict against ``decode_step``, bit for bit
   (logits, greedy tokens, cache), at phase 9's decode setting for GPT-2
   medium (B 8, prompt 32; 96 new tokens) and Llama-340M (B 4, prompt 32,
   64 new), bf16 parameters. Without phase 3 it runs phase 3's path
   itself first.

14. The other mesh axes (``make_mesh`` with sp or ep beside dp and tp),
   on a new one-rank NCCL world: (a) phase 3's GPT-2 medium through the
   reference's dp x sp x tp step (``__graft_entry__.py:66-103``) at one
   rank: ``mp.tensor_parallel(model, tp, sp=)`` with the flash ring over
   the sp line, ``mp.vocab_parallel_loss(..., sp=)`` and
   ``DistributedOptimizer`` over the dp x sp plane, 5 steps: phase 3's
   losses bit for bit, 24 launches of each kernel a step; the three
   kernels against their plain versions at the new shapes
   (``MESH_SHAPES``: ``gpt2_long``'s hops at sp 2 x tp 2, BH 16, t 2048,
   causal, full and strict; the Mixtral-style Llama at tp 2, BH 32 over 2
   kv heads), with their times, bounds, plain times and SDPA; (b)
   ``gpt2_long`` over 4 virtual ranks, sp 2 x tp 2, both ring layouts
   (``sp_tp_virtual``: one thread a rank runs the port's wired model, its
   rings over a ``Ring`` whose hops go through the threads, and the
   port's loss), the assembled logits within twice the dense bf16
   forward's error against fp32, every rank's loss ``loss_fn``'s on them
   (rtol 1e-5); positions from the whole set and a loss without the
   shift across shards must fail; (c) each MoE layer of the Mixtral-style
   Llama-340M over 2 and 4 virtual ep ranks (``ep_virtual_layer``: the
   port's ``MoEMLP`` with an ``ExpertParallel`` whose gather goes through
   the threads), outputs within the layer's own bf16 error against fp32
   (bit for bit reported), aux losses bit for bit, 1/ep of the expert
   bytes a rank, a rank routing among its own experts with their capacity
   outside the bound; (d) the dp x ep x tp step of the Mixtral-style Llama
   at one rank: phase 9's ``llama_moe`` losses bit for bit, ms a step and
   peak memory. Without phases 3 and 9 it runs their paths first.
15. T5 under tensor parallelism on a new one-rank NCCL world, T5-small at
   full width (d 512, 8 heads of 64, d_ff 1024, 6 + 6 layers, vocab 32128)
   at ``bench.py``'s T5 shape (B 16, 512 source and 512 target tokens,
   dots remat), four source rows with padded tails: (a) the plain T5
   trainer (``t5_small_padded``) and T5-small through
   ``mp.tensor_parallel`` over the mesh's mp set with
   ``DistributedOptimizer`` over its dp set (``t5_small_tp``), 5 AdamW
   steps each: the same losses bit for bit; (b) T5-small, its bias tables
   redrawn at ``T5_TABLE_STD`` and its query projections at the original
   T5 init, split over 2 and 4 virtual tp ranks
   (``t5_virtual_logits``: one thread a rank runs the port's wired T5 on
   its split of the model's own weights), forward only: the concatenated
   logits within twice the dense bf16 forward's error against fp32, every
   rank's vocab-parallel ``seq2seq_loss`` arithmetic the same and within
   rtol 1e-5 of it over the whole logits, and a planted fault (every rank
   adding heads [0, H/mp) of the tables) outside that bound; (c) no flash
   kernel launches on any of these paths.
16. Pipelines (``parallel/pipeline.py``, ``models/gpt2_pipeline.py``):
   GPT-2 medium at full width and depth (24 layers, bf16, flash) staged
   over virtual pp ranks on the one card (``staged_gpt2``: one thread a
   rank runs the port's step on its block, the hops through a line
   transport between the threads, each rank's backward on its own
   thread), one step each: (a) GPipe over 4 stages, 4 microbatches of 2 x
   1024, against the unstaged model trained with gradient accumulation
   over the same microbatches: the loss equal (rtol 1e-6), every gradient
   within twice the largest relative gap between that model's full-batch
   and accumulated bf16 gradients, and a hop that delivers the previous
   microbatch's activation more than ``PP_FAULT_FACTOR`` times outside;
   (b) 1F1B against GPipe over 4 stages at M 12 = 4(S - 1) microbatches
   of 1 x 1024: the loss equal (rtol 1e-6), the gradients within the same
   kind of bound at M 12, a lower peak memory, and stage s holding at most
   min(2(S - 1 - s) + 1, M) microbatches; (c) 1F1B over pp 2 x tp 2 (the
   tp f and g reduced over the threads) at (a)'s microbatches: every
   gradient within twice the unstaged bf16 gradients' gap to fp32's, the
   loss within twice the unstaged bf16 loss's relative gap to fp32's, and
   a stage body without f more than ``PP_FAULT_FACTOR`` times outside. K1,
   K2 and K3 launch 24 x M times a run, summed over the stages (per tp
   rank in (c) and (f)); first they are held against their plain versions
   at the shapes of the runs (``PP_SHAPES``, B*H 16 and 32 at T 1024).
   The interleaved schedules, R = 2 rounds a rank, the line wrapped into a
   ring: (d) interleaved GPipe over 4 stages (3 blocks a virtual stage) at
   (a)'s microbatches: the loss equal to the accumulated one (rtol 1e-6),
   every gradient within (a)'s bound, and a wrap hop (stage 3 -> 0) that
   delivers the previous microbatch's activation more than
   ``PP_FAULT_FACTOR`` times outside; (e) interleaved 1F1B over 4 stages at
   (b)'s M 12, against (b)'s GPipe: the loss equal (rtol 1e-6), the
   gradients within (b)'s bound, each stage's peak in flight its row's live
   peak in ``build_interleaved_1f1b``'s tables, and a lower peak memory
   than interleaved GPipe's at M 12 (three chunks of 4, its gradients
   within the same bound); (f) interleaved 1F1B over pp 2 x tp 2 (6 blocks
   a virtual stage; at S = 2 a rank's forward and backward hops share its
   one peer) at (a)'s microbatches, within (c)'s bounds, and stage 1
   posting its backward hops before its forward ones more than
   ``PP_FAULT_FACTOR`` times outside. The line transport hands a pair's
   k-th send to its k-th receive, as NCCL matches them.
17. The host observability plane, on a new one-rank NCCL world: (a) phase
   3's GPT-2 medium under ``start_timeline`` (before ``init``), with
   ``metrics_http(0)`` serving, a ``LocalSampler`` every
   ``SAMPLE_INTERVAL_S`` and a client thread GETting ``/metrics`` and
   ``/metrics.json`` every ``SCRAPE_PAUSE_S``: phase 3's losses within
   ``LOSS_TOL``, 24 launches of each kernel a step, every scrape 200 and
   parsed, no counter series lower than at the scrape before it, and once
   the steps end ``/metrics`` is ``to_prometheus()`` byte for byte and
   ``/metrics.json`` ``to_json()``; ``/trace`` and ``/healthz`` give the
   reference's fallbacks, ``/config`` ``confbus.config_view()``,
   ``/doctor`` 200 with
   ``hvd.doctor()``'s findings, an unknown
   path 404 and ``POST /config`` 403 (401 where a token is configured); the
   median step ms beside phases 3 and 6, and the scrapes' median and
   maximum ms; (b) the store's ``delta`` of ``collective_calls_total
   {kind=allreduce}`` over the run equal to the snapshots' growth (5),
   ``rate`` that delta over the window, ``window_snapshot`` of the
   reference's doctor shape; (c) ``merge_timelines`` of (a)'s shard with
   ``feed_metrics``: valid JSON, one track ``rank 0`` holding every event,
   ``exec_spans`` the shard's EXEC events with positive op ids, the
   algorithms' buckets and wire bytes the ``allreduce_algorithm`` markers
   (steps x the bucket plan) and the growth of
   ``allreduce_wire_bytes_total``, no collective in the straggler list,
   and ``overlap_efficiency_estimate{source="merge"}`` in the next scrape;
   the merge's seconds and events; (d) with two cards
   ``tools/torch_controller_bench.py --np 2 --late-rank 1 --late-ms 50``:
   its shards merged, op ids lined up, rank 1 the planted op's last rank
   and blamed at least 50 ms; with one card a line says it did not run.
   Without phase 3 it runs phase 3's path itself first.
18. The profiler and the doctor, on a new one-rank NCCL world, around
   phase 3's GPT-2 medium: (a) its step through
   ``hvd.profiler.instrument(..., model_flops=F, timed=True)`` (F the
   model FLOPs of phase 3's share of the bound) for 5 steps: phase 3's
   losses bit for bit, 24 launches of each kernel a step, compiles 1 and
   recompiles 0, the first call's cost capture exactly 6 x (macs +
   head_macs) dense FLOPs from ``FlopCounterMode`` plus 4·d, 6·d and 8·d a
   visible pair from the kernels' tally, ``program_mfu`` the share of the
   tensor-core bound at the same step time and ``program_hfu`` above it,
   the captured peak between the parameters plus AdamW's state and the
   card; then one planted call at B 4: one recompile blamed on ``tokens``
   (``recompile_blame_total`` and one ``recompile`` marker in the
   timeline); a packed, masked flash call at GPT-2 medium's attention
   shape peaks no higher under a cost capture than without, which counts
   its pairs exactly; (b) ``hvd.profile()`` around one step, its Chrome
   trace holding each flash kernel's device events 24 times and the
   step's NCCL allreduces (kernels with two ranks or more, host ops with
   one); under ``HOROVOD_PROFILE_ON_STALL=1`` a stall planted as phase
   6's while steps run fires exactly one triggered capture, which the
   next step's poll starts on the training thread and which holds every
   flash kernel 24 times for each step that ran wholly inside its window
   (the forward from the training thread, the backward from autograd's);
   a second trigger is refused while it runs; a manual capture preempts
   a 600 s trigger; each capture's seconds and trace bytes; (c) ``check_memory_pressure`` a fraction in (0, 1) with its
   gauges, one ``memory_pressure`` event from two checks at threshold 0,
   the live-buffer census at least the parameters' bytes; (d)
   ``hvd.doctor()`` ranks the planted recompile (naming ``tokens``) and the
   memory pressure, ``format_report`` renders every finding, ``/doctor``
   answers 200 with the same findings, ``doctor_window`` over a
   ``LocalSampler`` store has the reference's report shape. Without phase
   3 it runs phase 3's path itself first.
19. The flight recorder (``blackbox.py``): (a) on a new one-rank NCCL
   world under ``HOROVOD_BLACKBOX=1``, ``HOROVOD_PROFILE_ON_STALL=1`` and
   a timeline, ``init`` arms the recorder and its SIGTERM handler; phase
   3's GPT-2 medium for 5 steps: phase 3's losses bit for bit, 24
   launches of each kernel a step, the step time beside phase 3's and, on
   the same model, 5 steps with the recorder's feeds stopped and 5 armed
   again; then a
   stall planted as phase 6's while steps run, a 1 s watchdog scanning
   every 0.05 s through the triggered capture and its stop's hold: exactly
   one stall report, one capture and one ``stall`` bundle, whose manifest
   lists every file, whose trace tail merges with ``trace_merge`` (the
   stall marker and EXEC phases in it), whose ``metrics.window.json``
   feeds ``profiler.doctor`` and which ``postmortem_report`` ranks
   ``stall`` first; a ``dump_postmortem()`` while another thread holds
   ``metrics.registry._lock`` completes with ``sampled_final`` false, and
   ``blackbox_dumps_total`` counts stall 1 and manual 1; the bundle's
   bytes and the dump's ms; (b) ``tools/torch_elastic_worker.py`` at
   GPT-2 medium's width and ``BLACKBOX_WORKER_LAYERS`` layers, one rank,
   under ``kill@rank=0,step=3``: exit -9 after steps 0-2, one ``fault``
   bundle published before the SIGKILL, and ``tools/torch_postmortem.py
   --json`` exits 2 with cause ``fault_kill`` naming rank 0 and step 3;
   (c) the same worker sent SIGTERM after two steps: exit -15 (the
   handler re-delivers it), one ``signal`` bundle whose ``stacks.txt``
   holds the training frame on the main thread, and how long the handler
   ran after the signal was sent. Without phase 3 it runs phase 3's path
   itself first.
20. The config bus (``confbus.py``), on a new one-rank NCCL world with
   ``metrics_http(0)`` up, ``HOROVOD_SERVE_AUTH_TOKEN``,
   ``HOROVOD_CONFIG_LEDGER``, ``HOROVOD_BLACKBOX=1`` and a timeline; phase
   3's GPT-2 medium, with the bus driven between its 5 steps: (a) ``POST
   /config`` without the token and with a wrong one is refused 401; with
   it, ``HOROVOD_STALL_CHECK_TIME_SECONDS`` 60 -> 1 s is applied to the
   running watchdog, and a held step (a ``collective_begin`` with no end,
   phase 6's pattern) is then reported once within ``CONFBUS_HOLD_S``,
   which the old timeout could not do; ``HOROVOD_FUSION_THRESHOLD`` is
   refused ``shape_affecting`` and the next step issues phase 3's bucket
   plan; an invalid value is ``rejected`` and the environment keeps the
   applied one; (b) phase 3's losses bit for bit and 24 launches of each
   kernel a step, counted into the kernels line as
   ``gpt2_medium_confbus``; (c) one env change and ``hvd.init()`` (which
   re-reads the environment) and a second re-read: one WARN line, the
   ``config_epoch`` gauge equal to the two applied mutations, and the same
   four records in the ledger file, ``GET /config``'s ledger tail, the
   timeline's ``CONFIG`` markers and a ``dump_postmortem()`` bundle's
   "config" records; the token in none of them, nor in the log or the
   HTTP replies; (d) the phase's seconds and its step median with the bus
   live beside phase 3's. Without phase 3 it runs phase 3's path itself
   first.

Before the last line it prints one JSON object ``{"kernels": [...]}``: each
kernel's numbers at GPT-2's shapes, its launches on each path (GPT-2,
BERT, ViT, Llama, GPT-2 under the controller, GPT-2 under overlap and
under the int8 wire, GPT-2 under elastic training over both attempts of
(a) and under the reset of (b), phase 9's, phase 10 (c)'s, phase 11's,
phase 12's, phase 13's, phase 14's, phase 15's, phase 16's, phase 17's,
phase 18's, phase 19's and phase 20's paths, each counted from 0 just
before the path and read just after) and their sum, and its numbers at
each new path's shape (phases 5, 9, 10 (a), 13, 14 and 16). The last line is
``{"ok": true,
"device": {...}}``. ``--phases 1,2`` stops after the kernel checks;
``--phases 1,9`` runs phase 9 alone (its remat losses then compare with
its own run without remat); ``--phases 1,10`` runs phase 10 alone;
``--phases 1,11`` phase 11 alone; ``--phases 1,12`` phase 12 alone;
``--phases 1,13`` phase 13 alone; ``--phases 1,14`` phase 14 alone;
``--phases 1,15`` phase 15 alone; ``--phases 1,16`` phase 16 alone;
``--phases 1,17`` phase 17 alone; ``--phases 1,18`` phase 18 alone;
``--phases 1,19`` phase 19 alone; ``--phases 1,3,20`` phase 20 beside
phase 3.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import re
import signal
import statistics
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3 bandwidth

# Tolerances of kernel vs plain, (rtol, atol_rms, rel_rms): every element
# must hold |got - want| <= rtol * |want| + atol_rms * rms(want), and the
# whole tensor rms(got - want) <= rel_rms * rms(want). Both sides do the same
# fp32 math, summed in another order, and round the result once.
BF16_TOL = (2 ** -6, 1e-3, 1e-2)   # two bf16 ulps of each element
F32_TOL = (1e-5, 1e-4, 1e-5)       # fp32 sums taken in another order

KERNEL_INFO = {
    "flash_fwd": ("horovod_tpu_torch/ops/csrc/flash_fwd.cu",
                  "horovod_tpu/ops/flash_attention.py:110"),
    "flash_bwd_dq": ("horovod_tpu_torch/ops/csrc/flash_bwd.cu",
                     "horovod_tpu/ops/flash_attention.py:256"),
    "flash_bwd_dkv": ("horovod_tpu_torch/ops/csrc/flash_bwd.cu",
                      "horovod_tpu/ops/flash_attention.py:296"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# Cycles the card sleeps before a run of back-to-back calls (~2.5 ms): the
# host queues the whole run meanwhile, so its speed never shows in the time.
QUEUE_SLEEP_CYCLES = 5_000_000


def cuda_ms(fn, reps: int, warmup: int = 2, inner: int = 1) -> float:
    """Device time of one ``fn()`` in ms: the median over ``reps`` runs of
    ``inner`` back-to-back calls, each run timed with events and divided by
    ``inner``. With ``inner`` > 1 the card first sleeps while the host
    queues the run, so the calls follow each other on the card and the
    host's time per call is not counted even on a slow host."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if inner > 1:
            torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


# ---------------------------------------------------------------- phase 1

def phase_build():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: matmul and cudnn off")
    from horovod_tpu_torch.ops import _build
    t0 = time.perf_counter()
    secs = _build.build(list(_build.SOURCES) + list(_build.PLANTED))
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per library "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name in _build.SOURCES:
        rep = _build.ptxas_report(name)
        if rep:
            log(f"ptxas {name}:\n{rep}")
        # The tensor-core kernels must keep everything in registers.
        entry = ""
        for line in rep.splitlines():
            if "Compiling entry" in line:
                entry = line
            elif "_wg_kernel" in entry and re.search(
                    r"[1-9]\d* bytes spill (stores|loads)", line):
                fail(f"a wgmma kernel spills: {entry}: {line}")
    # The tensor-core kernels take all their shared memory dynamically, so
    # ptxas's lines above show none for them.
    fwd, bwd = _build.load("flash_fwd"), _build.load("flash_bwd")
    smem = {"forward": fwd.hvd_flash_fwd_smem, "dQ": bwd.hvd_flash_bwd_dq_smem,
            "dK/dV": bwd.hvd_flash_bwd_dkv_smem}
    log("dynamic shared memory per block (bytes) of the bf16 wgmma kernels, "
        "head dim <= 64 / 128: " + ", ".join(
            f"{k} {f(64)} / {f(128)}" for k, f in smem.items()))
    return card


# ---------------------------------------------------------------- phase 2

def _inputs(bh, b, tq, tk, d, dtype, seed, bias=False, seg=False):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    q, k, v, do = rnd(bh, tq, d), rnd(bh, tk, d), rnd(bh, tk, d), \
        rnd(bh, tq, d)
    kb = sg = None
    if bias:
        kb = torch.randn(b, tk, generator=g, device="cuda")
        kb[:, -7:] = -1e30                 # padded keys
        kb[b - 1, :] = -1e30               # a batch row with no visible key
    if seg:
        cut = torch.randint(1, tq, (b, 2), generator=g, device="cuda")
        pos = torch.arange(tq, device="cuda")[None]
        sg = ((pos >= cut[:, :1]).int() + (pos >= cut[:, 1:]).int())
        sg = sg.to(torch.int32).contiguous()
    return q, k, v, do, kb, sg


def _visible_pairs(bh, tq, tk, causal, offset, h, bias=None, seg=None,
                   seg_k=None):
    """Visible (q, k) pairs of this run's masks, summed over BH (``seg_k``:
    the keys' own segment ids, default the queries')."""
    import torch
    qp = torch.arange(tq, device="cuda")[:, None]
    kp = torch.arange(tk, device="cuda")[None, :]
    vis = torch.ones(tq, tk, dtype=torch.bool, device="cuda")
    if causal:
        vis = qp + offset >= kp
    vis = vis[None].expand(bh // h, tq, tk)
    if seg is not None:
        seg_k = seg if seg_k is None else seg_k
        vis = vis & (seg[:, :, None] == seg_k[:, None, :])
    if bias is not None:
        vis = vis & (bias[:, None, :] > -1e29)
    return int(vis.sum().item()) * h


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _stats(got, want, tol):
    """(max |err|, max of err / per-element bound, rms(err) / rms(want), ok)
    of ``got`` against ``want`` under ``tol`` = (rtol, atol_rms, rel_rms)."""
    rtol, atol_rms, rel_rms = tol
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rms_w = w.pow(2).mean().sqrt()
    bound = rtol * w.abs() + atol_rms * rms_w
    worst = (err / bound.clamp_min(1e-30)).max().item()
    rel = (err.pow(2).mean().sqrt() / rms_w.clamp_min(1e-30)).item()
    ok = bool((err <= bound).all().item()) and rel <= rel_rms
    return err.max().item(), worst, rel, ok


# Worst share of the per-element bound seen by _check, per tolerance.
WORST = {BF16_TOL: 0.0, F32_TOL: 0.0}


def _check(name, got, want, tol, against="its plain version"):
    """Fails unless ``got`` holds ``tol`` against ``want``; returns the max
    abs error."""
    err, worst, rel, ok = _stats(got, want, tol)
    WORST[tol] = max(WORST.get(tol, 0.0), worst)
    log(f"  {name}: max_abs_err {err:.3e}, max err/bound {worst:.3f}, "
        f"rms err/rms {rel:.3e} (rtol {tol[0]:.3e}, atol {tol[1]:.0e} rms, "
        f"rel rms <= {tol[2]:.0e})")
    if not ok:
        fail(f"{name} disagrees with {against}")
    return err


def compare_case(label, b, tq, tk, h, d, dtype, causal, offset, bias, seg,
                 tol):
    """Kernel vs plain for the three kernels on one case of ``_inputs``;
    returns errors, the inputs and plain residuals, and the outputs."""
    bh = b * h
    inputs = _inputs(bh, b, tq, tk, d, dtype, seed=tq + d, bias=bias,
                     seg=seg)
    log(f"case {label}: B {b} Tq {tq} Tk {tk} H {h} d {d} {dtype} "
        f"causal {causal} offset {offset} bias {bias} seg {seg}")
    return compare_kernels(inputs, b, h, d, causal, offset, tol,
                           dead_row=bias)


def compare_kernels(inputs, b, h, d, causal, offset, tol, dead_row=False,
                    sg_k=None, outside=False):
    """The three kernels against their plain versions on packed ``inputs``
    (q, k, v, dO, key bias, segment ids); with ``dead_row`` the last batch
    row sees no key and must give O = 0 and lse = -1e30. ``sg_k`` gives the
    keys their own segment ids (default: the queries'). With ``outside``
    the backward takes an lse and a delta from outside, as a ring hop
    takes the global ones: this hop's lse merged with another hop's of
    about the same mass, and a delta scaled per row. Returns the errors,
    the case (q, k, v, dO, key bias, segment ids, the backward's lse and
    delta, the plain O, the keys' segment ids) and the kernels' O, dQ, dK,
    dV."""
    import torch
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    q, k, v, do, kb, sg = inputs
    sg_k = sg if sg_k is None else sg_k
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, kb, sg, sg_k, h, scale, causal, offset)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, kb, sg, sg_k, h, scale,
                                    causal, offset)
    torch.cuda.synchronize()
    # lse is compared where a row sees any key; rows that see none must
    # hold -1e30 on both sides.
    live = lse_p > -1e29
    if not torch.equal(live, lse > -1e29):
        fail("kernel and plain disagree on which rows see no key")
    # lse is fp32 from the same fp32 scores whatever the input type.
    errs = {"flash_fwd": max(
        _check("O", o, o_p, tol),
        _check("lse", lse[live], lse_p[live], F32_TOL))}
    if dead_row:
        masked = lse_p[(b - 1) * h:].max().item()
        if masked > -1e29 or lse[(b - 1) * h:].max().item() > -1e29:
            fail("fully masked rows must give lse = -1e30")
        if o[(b - 1) * h:].abs().max().item() != 0.0:
            fail("fully masked rows must give O = 0")
    delta = (do.float() * o_p.float()).sum(-1)
    if outside:
        g = torch.Generator(device=q.device).manual_seed(1)
        lse_p = torch.logaddexp(lse_p, lse_p + torch.randn(
            lse_p.shape, generator=g, device=q.device))
        delta = delta * torch.rand(delta.shape, generator=g,
                                   device=q.device)
    dq = fa.flash_bwd_dq(q, k, v, kb, sg, sg_k, do, lse_p, delta, h,
                         scale, causal, offset)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, kb, sg, sg_k, do, lse_p, delta,
                                 h, scale, causal, offset)
    dk, dv, db = fa.flash_bwd_dkv(q, k, v, kb, sg, sg_k, do, lse_p, delta,
                                  h, scale, causal, offset)
    dk_p, dv_p, db_p = fa.flash_bwd_dkv_plain(q, k, v, kb, sg, sg_k, do,
                                              lse_p, delta, h, scale,
                                              causal, offset)
    torch.cuda.synchronize()
    errs["flash_bwd_dq"] = _check("dQ", dq, dq_p, tol)
    e = [_check("dK", dk, dk_p, tol), _check("dV", dv, dv_p, tol)]
    if kb is not None:
        e.append(_check("dbias", db, db_p, tol))
    errs["flash_bwd_dkv"] = max(e)
    return errs, (q, k, v, do, kb, sg, lse_p, delta, o_p, sg_k), (o, dq, dk,
                                                                  dv)


def planted_faults(inputs, outs, b, h, d, tol):
    """The check must catch a wrong kernel: the kernels' outputs at the main
    shapes are held against plain runs with a fault planted, and each fault
    must fail the check of every kernel. Also prints what a bound of
    1.6e-2 * max(1, max |want|) would have said."""
    import torch
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    q, k, v, do = inputs[:4]
    tk = k.shape[1]
    scale = d ** -0.5
    drop = torch.zeros(b, tk, device="cuda")
    drop[:, tk - 64:] = -1e30
    faults = {
        "scale x 1.01": (scale * 1.01, 0, None),
        "strict causal (offset -1)": (scale, -1, None),
        "last 64-key tile dropped": (scale, 0, drop),
    }
    for label, (sc, off, kb) in faults.items():
        o_f, lse_f = fa.flash_fwd_plain(q, k, v, kb, None, None, h, sc, True,
                                        off)
        delta_f = (do.float() * o_f.float()).sum(-1)
        dq_f = fa.flash_bwd_dq_plain(q, k, v, kb, None, None, do, lse_f,
                                     delta_f, h, sc, True, off)
        dk_f, dv_f, _ = fa.flash_bwd_dkv_plain(q, k, v, kb, None, None, do,
                                               lse_f, delta_f, h, sc, True,
                                               off, want_db=False)
        caught, loose = {}, []
        for name, got, want in zip(("O", "dQ", "dK", "dV"), outs,
                                   (o_f, dq_f, dk_f, dv_f)):
            err, worst, rel, ok = _stats(got, want, tol)
            caught[name] = not ok
            if err <= 1.6e-2 * max(1.0, want.float().abs().max().item()):
                loose.append(name)
            log(f"  fault {label}: {name} max_abs_err {err:.3e}, max "
                f"err/bound {worst:.3f}, rms err/rms {rel:.3e} -> "
                f"{'caught' if not ok else 'MISSED'}")
        log(f"  fault {label}: a max-relative bound would pass "
            f"{loose or 'nothing'}")
        if not (caught["O"] and caught["dQ"]
                and (caught["dK"] or caught["dV"])):
            fail(f"the kernel check misses the planted fault {label}")


def planted_rounding(inputs, h, d, tol):
    """The check must catch kernels that round P and dS to bf16 once instead
    of splitting them into hi + lo (``_build.PLANTED``): their O, dQ, dK and
    dV at the main shapes are held against the plain versions, and each must
    fail. These launches go through the libraries directly and count
    nowhere."""
    import torch
    from horovod_tpu_torch.ops import _build
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    q, k, v, do, _, _, lse_p, delta, o_p, _ = inputs
    scale = d ** -0.5
    dq_p = fa.flash_bwd_dq_plain(q, k, v, None, None, None, do, lse_p,
                                 delta, h, scale, True)
    dk_p, dv_p, _ = fa.flash_bwd_dkv_plain(q, k, v, None, None, None, do,
                                           lse_p, delta, h, scale, True,
                                           want_db=False)
    st = torch.cuda.current_stream().cuda_stream
    o, lse = torch.empty_like(q), torch.empty(q.shape[:2], device="cuda")
    fa.launch_fwd(_build.load("flash_fwd_one_rounding"), q, k, v, None, None,
                  None, o, lse, h, scale, True, 0, st)
    bwd = _build.load("flash_bwd_one_rounding")
    dq = torch.empty_like(q)
    fa.launch_bwd_dq(bwd, q, k, v, None, None, None, do, lse_p, delta, dq, h,
                     scale, True, 0, st)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fa.launch_bwd_dkv(bwd, q, k, v, None, None, None, do, lse_p, delta, dk, dv,
                      None, h, scale, True, 0, st)
    torch.cuda.synchronize()
    for name, got, want in (("O", o, o_p), ("dQ", dq, dq_p), ("dK", dk, dk_p),
                            ("dV", dv, dv_p)):
        err, worst, rel, ok = _stats(got, want, tol)
        log(f"  fault P and dS rounded to bf16 once: {name} max_abs_err "
            f"{err:.3e}, max err/bound {worst:.3f}, rms err/rms {rel:.3e} -> "
            f"{'MISSED' if ok else 'caught'}")
        if ok:
            fail(f"the kernel check misses one bf16 rounding of P/dS on "
                 f"{name}")


def kernel_times(case, b, h, d, causal=True, offset=0):
    """Median ms of each kernel and of SDPA forward and backward (the
    yardstick, with the same mask: the case's key bias as a boolean key
    mask, or the causal diagonal) on one case's inputs: ({kernel: one
    call}, {kernel: per call of 10 back-to-back}, (sdpa one call, sdpa
    10))."""
    import torch
    import torch.nn.functional as F
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    q, k, v, do, kb, sg, lse, delta, _, sg_k = case
    t_ = q.shape[1]
    scale = d ** -0.5
    runs = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, kb, sg, sg_k, h, scale,
                                          causal, offset),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, kb, sg, sg_k, do,
                                                lse, delta, h, scale, causal,
                                                offset),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, kb, sg, sg_k, do,
                                                  lse, delta, h, scale,
                                                  causal, offset),
    }

    # SDPA on the same inputs in its (B, H, T, D) layout; its backward alone
    # computes dQ, dK and dV in one call, the work of both backward kernels.
    def bhtd(x):
        return x.view(b, h, t_, d).detach().clone().requires_grad_(True)
    sq, sk, sv = bhtd(q), bhtd(k), bhtd(v)
    sdo = do.view(b, h, t_, d)
    mask = None if kb is None else (kb > -1e29)[:, None, None, :]
    sdpa_causal = causal and offset == 0
    if sg is not None or (causal and offset):
        # Segment ids and a shifted diagonal become a boolean mask that
        # also holds the diagonal.
        vis = torch.ones(b, t_, t_, dtype=torch.bool, device=q.device)
        if sg is not None:
            vis = sg[:, :, None] == sg_k[:, None, :]
        if causal:
            vis = vis & torch.ones(t_, t_, dtype=torch.bool,
                                   device=q.device).tril(offset)
        mask = vis[:, None] if mask is None else mask & vis[:, None]
        sdpa_causal = False

    def sdpa():
        return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                              is_causal=sdpa_causal)
    sout = sdpa()
    runs["fwd"] = sdpa
    runs["bwd"] = lambda: torch.autograd.grad(sout, (sq, sk, sv), sdo,
                                              retain_graph=True)
    one = {n: cuda_ms(f, 20) for n, f in runs.items()}
    ten = {n: cuda_ms(f, 20, inner=10) for n, f in runs.items()}
    pick = lambda x: ({n: x[n] for n in fa.KERNELS},
                      {n: x[n] for n in ("fwd", "bwd")})
    (k1, s1), (k10, s10) = pick(one), pick(ten)
    return k1, k10, (s1, s10)


def plain_times(case, h, d, causal=True, reps=5, offset=0):
    """Median ms of each kernel's plain version on one case's inputs."""
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    q, k, v, do, kb, sg, lse, delta, _, sk = case
    scale = d ** -0.5
    return {
        "flash_fwd": cuda_ms(lambda: fa.flash_fwd_plain(
            q, k, v, kb, sg, sk, h, scale, causal, offset), reps),
        "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq_plain(
            q, k, v, kb, sg, sk, do, lse, delta, h, scale, causal, offset),
            reps),
        "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv_plain(
            q, k, v, kb, sg, sk, do, lse, delta, h, scale, causal, offset),
            reps),
    }


def kernel_work(bh, tq, tk, d, pairs, bias_rows=0, seg_rows=0,
                split_seg=False):
    """{kernel: (FLOPs, bytes)} of the function each kernel computes:
    4·d, 6·d and 8·d FLOPs per visible (q, k) pair; each input read once
    and each output written once: bf16 (BH, T, d) tensors, fp32 (BH, T)
    rows (lse, delta; the bias gradient), a (B, Tk) fp32 key bias of
    ``bias_rows`` rows and (B, T) int32 segment ids of ``seg_rows`` (with
    ``split_seg`` the keys' own (B, Tk) ids besides)."""
    el_q, el_k = bh * tq * d * 2, bh * tk * d * 2
    row = bh * tq * 4
    kb = bias_rows * tk * 4 + seg_rows * (tq + (tk if split_seg else 0)) * 4
    return {
        "flash_fwd": (4 * d * pairs, 2 * el_q + 2 * el_k + row + kb),
        "flash_bwd_dq": (6 * d * pairs, 3 * el_q + 2 * el_k + 2 * row + kb),
        "flash_bwd_dkv": (8 * d * pairs, 2 * el_q + 4 * el_k + 2 * row + kb
                          + (bh * tk * 4 if bias_rows else 0)),
    }


def bound(flops, nbytes):
    """(ms, "operations" or "bytes"): the larger of FLOPs over the bf16
    tensor-core peak and bytes over the HBM rate."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def host_us(fn, reps: int = 200) -> float:
    """Median host time of one ``fn()`` in us: the wrapper's Python and the
    launch, not the kernel (the card runs it behind the host's back)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def phase_kernels():
    import torch
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")

    B, T, H, D = 8, 1024, 16, 64
    errs, main, main_outs = compare_case("main", B, T, T, H, D,
                                         torch.bfloat16, True, 0, False,
                                         False, BF16_TOL)
    planted_faults(main, main_outs, B, H, D, BF16_TOL)
    planted_rounding(main, H, D, BF16_TOL)
    del main_outs
    for dtype, tol, tag in ((torch.bfloat16, BF16_TOL, "bf16"),
                            (torch.float32, F32_TOL, "fp32")):
        compare_case(f"ragged-{tag}", 2, 200, 200, 4, 64, dtype, True, -1,
                     True, True, tol)
        compare_case(f"cross-{tag}", 2, 77, 130, 2, 128, dtype, False, 0,
                     True, False, tol)
    compare_case("small-head", 2, 50, 50, 3, 24, torch.bfloat16, True, 0,
                 False, True, BF16_TOL)
    _, wide, _ = compare_case("d128", 8, 1024, 1024, 8, 128, torch.bfloat16,
                              True, 0, False, False, BF16_TOL)
    log(f"worst max err/bound: bf16 outputs {WORST[BF16_TOL]:.3f}, fp32 "
        f"outputs and lse {WORST[F32_TOL]:.3f} (fails above 1)")

    # Times at the main-path shapes: one call between two events (the
    # kernels line's ms), and per call over 10 back-to-back calls, which
    # leaves the wrapper's host time out.
    q, k, v, do, _, _, lse, delta, o, _ = main
    bh, scale = B * H, D ** -0.5
    t, t10, (sdpa, sdpa10) = kernel_times(main, B, H, D)
    p = plain_times(main, H, D)
    log(f"times (ms; median of 20 single calls / of 20 runs of 10 "
        f"back-to-back calls; 5 single calls for the plain versions) at B {B} "
        f"T {T} H {H} d {D} bf16 causal:")
    for name in fa.KERNELS:
        log(f"  {name}: kernel {t[name]:.4f} / {t10[name]:.4f}  plain "
            f"{p[name]:.4f}")
    log(f"  sdpa fwd {sdpa['fwd']:.4f} / {sdpa10['fwd']:.4f}  sdpa bwd "
        f"{sdpa['bwd']:.4f} / {sdpa10['bwd']:.4f} (yardstick; the port never "
        f"calls it); flash_bwd_dq + flash_bwd_dkv "
        f"{t['flash_bwd_dq'] + t['flash_bwd_dkv']:.4f} / "
        f"{t10['flash_bwd_dq'] + t10['flash_bwd_dkv']:.4f}")
    host = {
        "flash_fwd": host_us(lambda: fa.flash_fwd(q, k, v, None, None, None,
                                                  H, scale, True)),
        "flash_bwd_dq": host_us(lambda: fa.flash_bwd_dq(
            q, k, v, None, None, None, do, lse, delta, H, scale, True)),
    }
    log("wrapper host time per call (us, median of 200; the kernel runs "
        "behind it): " + ", ".join(f"{n} {us:.1f}" for n, us in host.items()))
    wt, wt10, (wsdpa, wsdpa10) = kernel_times(wide, 8, 8, 128)
    log(f"times (ms, the same two ways) at B 8 T 1024 H 8 d 128 bf16 causal: "
        f"flash_fwd {wt['flash_fwd']:.4f} / {wt10['flash_fwd']:.4f}, "
        f"flash_bwd_dkv {wt['flash_bwd_dkv']:.4f} / "
        f"{wt10['flash_bwd_dkv']:.4f}, flash_bwd_dq {wt['flash_bwd_dq']:.4f} "
        f"/ {wt10['flash_bwd_dq']:.4f}; sdpa fwd {wsdpa['fwd']:.4f} / "
        f"{wsdpa10['fwd']:.4f}, bwd {wsdpa['bwd']:.4f} / "
        f"{wsdpa10['bwd']:.4f}")
    del wide

    pairs = _visible_pairs(bh, T, T, True, 0, H)
    work = kernel_work(bh, T, T, D, pairs)
    library = {"flash_fwd": (sdpa["fwd"], "scaled_dot_product_attention "
                             "forward"),
               "flash_bwd_dq": (None, "no library call computes dQ alone"),
               "flash_bwd_dkv": (sdpa["bwd"], "scaled_dot_product_attention "
                                 "backward: dQ, dK and dV in one call, the "
                                 "work of flash_bwd_dq and flash_bwd_dkv "
                                 "together")}
    report = {}
    for name in fa.KERNELS:
        flops, nbytes = work[name]
        bound_ms, bound_by = bound(flops, nbytes)
        log(f"  {name}: {flops / t[name] / 1e9:.1f} TFLOP/s one call at a "
            f"time, {flops / t10[name] / 1e9:.1f} back to back, on the "
            f"function's {flops / 1e9:.2f} GFLOP ({flops // (D * pairs)}·d "
            f"per visible pair)")
        src, replaces = KERNEL_INFO[name]
        report[name] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": 0,
            "max_abs_err": errs[name], "ms": t[name],
            "ms_back_to_back": t10[name], "plain_ms": p[name],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library[name][0],
            "library_ms_back_to_back": {"flash_fwd": sdpa10["fwd"],
                                        "flash_bwd_dkv": sdpa10["bwd"]}.get(
                                            name),
            "library_note": library[name][1],
            "flops": flops, "bytes": nbytes,
            "tflops": flops / t[name] / 1e9,
            "tflops_back_to_back": flops / t10[name] / 1e9,
        }
    log(json.dumps({"kernel_checks": list(fa.KERNELS),
                    "launches_in_checks": dict(fa.launches)}))
    return report


# ---------------------------------------------------------------- phase 3

def phase_reference_check():
    """Tiny fp32 GPT-2 on the card: flash logits == dense logits."""
    import torch
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn
    tokens = torch.randint(0, 256, (2, 100),
                           generator=torch.Generator().manual_seed(3))
    tokens = tokens.cuda()
    out = {}
    for impl in ("dense", "flash"):
        m = GPT2(GPT2Config.tiny(dtype=torch.float32, attention=impl),
                 torch.Generator().manual_seed(0)).cuda()
        logits = m(tokens)
        loss = loss_fn(logits, tokens)
        loss.backward()
        out[impl] = (logits.detach(), loss.item(),
                     m.h[0].attn.qkv.weight.grad.clone())
    err = _err(out["flash"][0], out["dense"][0])
    gerr = _err(out["flash"][2], out["dense"][2])
    log(f"reference check (tiny fp32 GPT-2, flash vs dense): logits "
        f"max_abs_err {err:.3e}, qkv grad max_abs_err {gerr:.3e}, loss "
        f"{out['flash'][1]:.6f} vs {out['dense'][1]:.6f}")
    if out["flash"][0].shape != (2, 100, 256) or \
            not torch.isfinite(out["flash"][0]).all():
        fail("tiny GPT-2 logits are not finite or have the wrong shape")
    if err > 1e-4 or gerr > 1e-4:
        fail("flash GPT-2 disagrees with dense GPT-2 (tol 1e-4)")


def phase_main_path(card):
    """GPT-2 medium through the port's training path (``build_path``,
    ``phase_train_path``) on a one-rank NCCL world."""
    import horovod_tpu_torch as hvd
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    run = phase_train_path("gpt2_medium", card, hvd.device())
    hvd.shutdown()
    return run


# ---------------------------------------------------------------- phase 4

# The CPU tests' tolerances (tests/test_torch_port_resnet.py): fp32 logits
# and gradients, plus BN_SCALE of the tensor's largest element for what
# passes through a stack of BNs.
LOGIT_TOL = (1e-4, 1e-5)
GRAD_TOL = (1e-3, 1e-6)
BN_SCALE = 1e-4


def _close(name, got, want, tol, floor=BN_SCALE):
    """Fails unless every element of ``got`` is within rtol·|want| + atol
    (atol at least ``floor`` of max |want|) of ``want``."""
    import torch
    rtol, atol = tol
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    atol = max(atol, floor * w.abs().max().item())
    err = (g - w).abs()
    worst = (err / (rtol * w.abs() + atol)).max().item()
    log(f"  {name}: max_abs_err {err.max().item():.3e}, max err/bound "
        f"{worst:.3f}")
    if not torch.isfinite(g).all() or worst > 1.0:
        fail(f"{name} disagrees (tol rtol {rtol}, atol {atol:.2e})")


def _tiny_resnet(block, stem, **kw):
    import torch
    from horovod_tpu_torch.models import resnet
    return resnet.ResNet(stage_sizes=[1, 1, 1, 1],
                         block_cls=getattr(resnet, block), num_classes=10,
                         num_filters=8, dtype=torch.float32, stem=stem,
                         generator=torch.Generator().manual_seed(0), **kw)


def _train_pass(model, x, y):
    import torch.nn.functional as F
    logits = model(x)
    F.cross_entropy(logits, y).backward()
    return logits, model.conv_init.weight.grad


def phase_resnet_reference(dev):
    """Tiny fp32 ResNets: the card against the CPU (train mode: logits,
    the stem's gradient, the running statistics), cross-replica BN over the
    one-rank NCCL set against local BN, and the s2d stem with converted
    weights against the conv stem."""
    import copy
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 3, 32, 32, generator=g)
    y = torch.randint(0, 10, (8,), generator=g)
    xd, yd = x.to(dev), y.to(dev)
    for block in ("BasicBlock", "BottleneckBlock"):
        cpu = _tiny_resnet(block, "conv")
        card = copy.deepcopy(cpu).to(dev)
        cross = _tiny_resnet(block, "conv",
                             bn_cross_replica=hvd.global_process_set())
        cross.load_state_dict(cpu.state_dict())
        cross = cross.to(dev)
        want = _train_pass(cpu, x, y)
        log(f"tiny fp32 ResNet ({block}), card against CPU:")
        for tag, m in (("local BN", card), ("cross-replica BN", cross)):
            got = _train_pass(m, xd, yd)
            _close(f"{tag} logits", got[0], want[0], LOGIT_TOL)
            _close(f"{tag} conv_init grad", got[1], want[1], GRAD_TOL)
            _close(f"{tag} running_var", m.blocks[0].bn0.running_var,
                   cpu.blocks[0].bn0.running_var, LOGIT_TOL)
    conv = _tiny_resnet("BottleneckBlock", "conv").to(dev)
    s2d = _tiny_resnet("BottleneckBlock", "s2d")
    sd = {k: v.cpu() for k, v in conv.state_dict().items()}
    w = sd["conv_init.weight"].permute(2, 3, 1, 0).numpy()
    sd["conv_init.weight"] = torch.tensor(
        resnet.convert_stem_weights(w).transpose(3, 2, 0, 1).copy())
    s2d.load_state_dict(sd)
    s2d = s2d.to(dev)
    log("tiny fp32 ResNet, s2d stem with convert_stem_weights against the "
        "conv stem, on the card:")
    with torch.no_grad():
        _close("s2d logits", s2d(xd), conv(xd), LOGIT_TOL)


def _conv_macs(model, *x):
    """Multiply-adds of one forward of ``model`` on ``x``: every conv,
    dense and MoE layer (``MoEMLP.macs``: router, dispatch, combine and
    experts), counted from the shapes this run gives them."""
    import torch
    from horovod_tpu_torch.models.gpt2 import Dense
    from horovod_tpu_torch.models.resnet import Conv
    from horovod_tpu_torch.ops.moe import MoEMLP
    macs = [0]

    def hook(mod, inp, out):
        if isinstance(mod, Conv):
            macs[0] += out.numel() * mod.weight[0].numel()
        elif isinstance(mod, MoEMLP):
            macs[0] += mod.macs(out[0].shape[0] * out[0].shape[1])
        else:
            macs[0] += out.numel() * mod.weight.shape[1]
    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, (Conv, Dense, MoEMLP))]
    with torch.no_grad():
        model(*x)
    for h in hs:
        h.remove()
    return macs[0]


def _train_steps(model, opt, x, y, steps, tag, generator=None):
    """``steps`` SGD steps on one fixed batch: per step the loss, the wall
    seconds and the device ms of forward + loss, backward and the
    optimizer (fused allreduce + SGD), from CUDA events. These paths have
    no kernel of the port's: the launch counts, zeroed just before, must
    still be 0 just after."""
    import torch
    import torch.nn.functional as F
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    fa.reset_launches()
    losses, wall, parts = [], [], []
    for step in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        opt.zero_grad()
        logits = (model(x) if generator is None else model(x, generator))
        loss = F.cross_entropy(logits, y)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        losses.append(loss.item())
        log(f"{tag} step {step}: loss {losses[-1]:.6f}  {wall[-1]:.3f} s  "
            f"forward {parts[-1][0]:.1f} ms  backward {parts[-1][1]:.1f} ms"
            f"  allreduce+sgd {parts[-1][2]:.1f} ms")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: non-finite loss: {losses}")
    if any(fa.launches.values()):
        fail(f"{tag}: a flash kernel launched: {fa.launches}")
    return losses, wall, parts


def phase_resnet50(card, dev):
    """ResNet-50 at the bench's shape through the port's training path."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import ResNet50
    B, S, steps = 128, 224, 5
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    with torch.device(dev):
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         generator=g)
    model = model.to(memory_format=torch.channels_last)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"ResNet-50: 16 bottleneck blocks, {n_params} params, B {B} {S}x{S} "
        f"bf16 channels_last, local BN, built on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1, momentum=0.9))
    x = torch.randn(B, 3, S, S, generator=g, device=dev).to(
        memory_format=torch.channels_last)
    y = torch.randint(0, 1000, (B,), generator=g, device=dev)
    macs = _conv_macs(model, x)
    flops = 3 * 2 * macs            # forward, and twice it backward
    bn = [m for m in model.modules() if hasattr(m, "running_var")]
    before = [(m.running_mean.clone(), m.running_var.clone()) for m in bn]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, wall, parts = _train_steps(model, opt, x, y, steps, "resnet50")
    peak = torch.cuda.max_memory_allocated()
    if not losses[-1] < losses[0]:
        fail(f"ResNet-50 loss is not falling: {losses}")
    stats = [(m.running_mean, m.running_var) for m in bn]
    if not all(torch.isfinite(t).all() for pair in stats for t in pair):
        fail("ResNet-50 running statistics are not finite")
    moved = sum(not torch.equal(a, c) or not torch.equal(b, d)
                for (a, b), (c, d) in zip(stats, before))
    if moved != len(bn):
        fail(f"only {moved} of {len(bn)} BNs moved their running stats")
    steady = wall[1:]
    med = [statistics.median(p[i] for p in parts[1:]) for i in range(3)]
    step_ms = statistics.median(steady) * 1e3
    bound_ms = flops / PEAK_BF16_FLOPS * 1e3
    out = {"images_per_s": B * len(steady) / sum(steady),
           "step_ms_median": step_ms, "forward_ms": med[0],
           "backward_ms": med[1], "allreduce_sgd_ms": med[2],
           "peak_gib": peak / 2 ** 30, "gmac_per_image": macs / B / 1e9,
           "step_tflop": flops / 1e12, "bound_ms": bound_ms,
           "share_of_bound": bound_ms / step_ms, "losses": losses,
           "bns_moved": moved}
    log(f"ResNet-50 on {card}: {out['images_per_s']:.1f} images/s (steps "
        f"1-{steps - 1}, wall), step {step_ms:.1f} ms median (forward "
        f"{med[0]:.1f}, backward {med[1]:.1f}, allreduce+sgd {med[2]:.1f} "
        f"ms, device time between events), peak memory "
        f"{out['peak_gib']:.2f} GiB; {macs / B / 1e9:.3f} GMAC an image, "
        f"{flops / 1e12:.3f} TFLOP a step, tensor-core bound {bound_ms:.3f}"
        f" ms at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s = "
        f"{out['share_of_bound']:.4f} of the step; running stats moved in "
        f"{moved} of {len(bn)} BNs; losses {losses}")
    del model, opt, x, y
    torch.cuda.empty_cache()
    return out


def phase_resnet50_s2d_bf16_stats(dev):
    """One step of ResNet-50 with bf16 BN statistics and the s2d stem."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import ResNet50
    g = torch.Generator(device=dev).manual_seed(2)
    with torch.device(dev):
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         bn_stats_dtype=torch.bfloat16, stem="s2d",
                         generator=g)
    model = model.to(memory_format=torch.channels_last)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1, momentum=0.9))
    x = torch.randn(128, 3, 224, 224, generator=g, device=dev).to(
        memory_format=torch.channels_last)
    y = torch.randint(0, 1000, (128,), generator=g, device=dev)
    _train_steps(model, opt, x, y, 1, "resnet50 s2d + bf16 BN stats")
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        fail("ResNet-50 (s2d, bf16 BN statistics): non-finite parameters")
    del model, opt, x, y
    torch.cuda.empty_cache()


def phase_mnist(card, dev):
    """The MNIST CNN at the bench's shape (``bench.py:356-385``)."""
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.mnist import MnistCNN
    B, steps = 512, 5
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        model = MnistCNN(generator=g)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1, momentum=0.9))
    x = torch.randn(B, 1, 28, 28, generator=g, device=dev)
    y = torch.randint(0, 10, (B,), generator=g, device=dev)

    def eval_loss():
        model.eval()
        with torch.no_grad():
            v = F.cross_entropy(model(x), y).item()
        model.train()
        return v
    first = eval_loss()
    losses, wall, parts = _train_steps(model, opt, x, y, steps, "mnist",
                                       generator=g)
    last = eval_loss()
    if not last < first:
        fail(f"MNIST loss (eval mode, the same batch) is not falling: "
             f"{first} -> {last}")
    steady = wall[1:]
    out = {"images_per_s": B * len(steady) / sum(steady),
           "step_ms_median": statistics.median(steady) * 1e3,
           "losses": losses, "eval_loss": [first, last]}
    log(f"MNIST on {card}: {out['images_per_s']:.1f} images/s (steps "
        f"1-{steps - 1}, wall), step {out['step_ms_median']:.2f} ms median;"
        f" train losses {losses}; eval loss {first:.6f} -> {last:.6f}")
    return out


def phase_collectives(dev):
    """Every collective of the port once on NCCL (one rank), card tensors:
    each result against what a one-rank world must give."""
    import torch
    import horovod_tpu_torch as hvd
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(4, 3, generator=g, device=dev)
    xb = x.to(torch.bfloat16)
    xi = torch.randint(-9, 9, (4, 2), generator=g, device=dev,
                       dtype=torch.int32)
    checks = {}

    def same(name, got, want):
        ok = (got.device == want.device and got.dtype == want.dtype
              and torch.equal(got, want))
        checks[name] = ok
        if not ok:
            fail(f"collective {name} on NCCL: got {got} want {want}")

    y = x.clone()
    same("allreduce_", hvd.allreduce_(y, op=hvd.Sum), x)
    same("allreduce bf16", hvd.allreduce(xb), xb)
    same("allreduce int32 average", hvd.allreduce(xi), xi)
    handles = {
        "allreduce_async": (hvd.allreduce_async(x), x),
        "allreduce_async_": (hvd.allreduce_async_(x.clone()), x),
        "broadcast_async": (hvd.broadcast_async(x, 0), x),
        "broadcast_async_": (hvd.broadcast_async_(x.clone(), 0), x),
        "allgather_async": (hvd.allgather_async(xb), xb),
        "alltoall_async": (hvd.alltoall_async(x), x),
        "reducescatter_async": (hvd.reducescatter_async(x, op=hvd.Sum), x),
    }
    grouped = {
        "grouped_allreduce_async": (hvd.grouped_allreduce_async([x, xb]),
                                    [x, xb]),
        "grouped_allgather_async": (hvd.grouped_allgather_async([x, xi]),
                                    [x, xi]),
        "grouped_reducescatter_async": (hvd.grouped_reducescatter_async(
            [x, xb], op=hvd.Average), [x, xb]),
    }
    # Synchronized in the reverse of their issue order.
    for name in reversed(list(grouped)):
        h, wants = grouped[name]
        for i, (got, want) in enumerate(zip(hvd.synchronize(h), wants)):
            same(f"{name}[{i}]", got, want)
    for name in reversed(list(handles)):
        h, want = handles[name]
        same(name, hvd.synchronize(h), want)
        checks[name + " poll"] = hvd.poll(h)
    same("grouped_allgather", hvd.grouped_allgather([x])[0], x)
    same("grouped_reducescatter",
         hvd.grouped_reducescatter([x], op=hvd.Sum)[0], x)
    same("reducescatter", hvd.reducescatter(x), x)
    same("alltoall", hvd.alltoall(x), x)
    recv, rsplits = hvd.alltoall(x[:3], splits=[3])
    same("alltoall splits", recv, x[:3])
    checks["alltoall received splits"] = rsplits.tolist() == [3]
    same("ragged_allgather", hvd.ragged_allgather(x[:3]), x[:3])
    checks["allgather_object"] = hvd.allgather_object({"r": 0}) == [{"r": 0}]
    ps = hvd.add_process_set([0])
    same("allreduce on an added set", hvd.allreduce(x, process_set=ps), x)
    checks["process sets"] = (hvd.get_process_set_ids_and_ranks()
                              == {0: None, 1: [0]}
                              and hvd.remove_process_set(ps))
    sbn = hvd.SyncBatchNorm(3).to(dev)
    t = torch.randn(8, 3, 5, 5, generator=g, device=dev, requires_grad=True)
    w = torch.randn(8, 3, 5, 5, generator=g, device=dev)
    ref = torch.nn.BatchNorm2d(3).to(dev)
    tr = t.detach().clone().requires_grad_(True)
    (sbn(t) * w).sum().backward()
    (ref(tr) * w).sum().backward()
    log("hvd.SyncBatchNorm on NCCL against torch's BatchNorm2d:")
    _close("SyncBatchNorm input grad", t.grad, tr.grad, GRAD_TOL)
    hvd.barrier()
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"collectives on NCCL failed: {bad}")
    log(f"collectives on NCCL (one rank, card tensors): {len(checks)} "
        f"checks passed: {', '.join(checks)}")
    return len(checks)


def phase_models(card):
    import torch
    import horovod_tpu_torch as hvd
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    dev = hvd.device()
    phase_resnet_reference(dev)
    resnet50 = phase_resnet50(card, dev)
    phase_resnet50_s2d_bf16_stats(dev)
    mnist = phase_mnist(card, dev)
    n_checks = phase_collectives(dev)
    hvd.shutdown()
    torch.cuda.synchronize()
    return {"resnet50": resnet50, "mnist": mnist,
            "collective_checks": n_checks}


# ---------------------------------------------------------------- phase 5

# The attention shapes of the three new paths, one launch of each kernel a
# layer (bf16, d 64): batch, query heads, T, causal, the KV heads that GQA
# expands to the query heads before the kernels, and whether the model
# passes a key bias (BERT always does: its mask of all ones is a zero
# bias).
PATHS = {
    "bert_large": dict(b=8, h=16, t=512, causal=False, hkv=16, bias=True),
    "vit_b16": dict(b=128, h=12, t=197, causal=False, hkv=12, bias=False),
    "llama_340m": dict(b=4, h=16, t=2048, causal=True, hkv=4, bias=False),
}


def _path_inputs(b, h, t, causal, hkv, bias, seed, pad_rows=0):
    """Packed (B·H, T, 64) bf16 q, k, v, dO at a model's attention shape: K
    and V drawn for ``hkv`` heads, each repeated for its query heads as GQA
    expands them; a zero key bias (a mask of all ones) whose last 64 keys
    are padded (-1e30) in the first ``pad_rows`` rows."""
    import torch
    d = 64
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(heads):
        x = torch.randn(b, t, heads, d, generator=g, device="cuda")
        x = x.repeat_interleave(h // heads, dim=2).to(torch.bfloat16)
        return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()

    q, k, v, do = rnd(h), rnd(hkv), rnd(hkv), rnd(h)
    kb = None
    if bias:
        kb = torch.zeros(b, t, device="cuda")
        kb[:pad_rows, t - 64:] = -1e30
    return q, k, v, do, kb, None


def phase_path_kernels():
    """The three kernels against their plain versions at each new path's
    shape (and at BERT's with two rows padded), then their times, bounds,
    plain times and SDPA with the same mask: {path: {kernel: numbers}}."""
    import torch
    out = {}
    for path, c in PATHS.items():
        b, h, t, causal = c["b"], c["h"], c["t"], c["causal"]
        log(f"path {path}: B {b} H {h} T {t} d 64 bf16 causal {causal} "
            f"KV heads {c['hkv']} key bias {c['bias']}")
        errs, case, outs = compare_kernels(
            _path_inputs(seed=t, **c), b, h, 64, causal, 0, BF16_TOL)
        del outs
        if c["bias"]:
            log(f"path {path}, the last 64 keys of two rows padded:")
            padded = compare_kernels(_path_inputs(seed=t + 1, pad_rows=2,
                                                  **c),
                                     b, h, 64, causal, 0, BF16_TOL)[0]
            errs = {k: max(v, padded[k]) for k, v in errs.items()}
        out[path] = shape_report(case, errs, b, h, t, causal,
                                 bias_rows=b if c["bias"] else 0)
        del case
        torch.cuda.empty_cache()
    return out


def shape_report(case, errs, b, h, t, causal, bias_rows=0, offset=0):
    """Times (one call / back to back), plain times, bounds and SDPA with
    the same mask of the three kernels on one checked case (d 64):
    {kernel: numbers}."""
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    one, ten, (sdpa, sdpa10) = kernel_times(case, b, h, 64, causal, offset)
    plain = plain_times(case, h, 64, causal, offset=offset)
    seg, seg_k = case[5], case[9]
    pairs = _visible_pairs(b * h, t, t, causal, offset, h, bias=case[4],
                           seg=seg, seg_k=seg_k)
    work = kernel_work(b * h, t, t, 64, pairs, bias_rows=bias_rows,
                       seg_rows=0 if seg is None else b,
                       split_seg=seg_k is not seg)
    library = {"flash_fwd": (sdpa["fwd"], sdpa10["fwd"]),
               "flash_bwd_dq": (None, None),
               "flash_bwd_dkv": (sdpa["bwd"], sdpa10["bwd"])}
    out = {}
    for name in fa.KERNELS:
        flops, nbytes = work[name]
        bound_ms, bound_by = bound(flops, nbytes)
        out[name] = {
            "max_abs_err": errs[name], "ms": one[name],
            "ms_back_to_back": ten[name], "plain_ms": plain[name],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library[name][0],
            "library_ms_back_to_back": library[name][1],
            "flops": flops, "bytes": nbytes}
        log(f"  {name}: {one[name]:.4f} / {ten[name]:.4f} ms (one call /"
            f" back to back), plain {plain[name]:.4f}, bound "
            f"{bound_ms:.4f} ms ({bound_by}), "
            f"{flops / ten[name] / 1e9:.1f} TFLOP/s back to back")
    log(f"  sdpa with the same mask: fwd {sdpa['fwd']:.4f} / "
        f"{sdpa10['fwd']:.4f}, bwd {sdpa['bwd']:.4f} / "
        f"{sdpa10['bwd']:.4f} ms (yardstick; the port never calls it)")
    return out


# The tiny fp32 models of the CPU tests, on the card against the CPU: their
# tolerances (tests/test_torch_port_{bert,vit,llama}.py).
def _tiny_transformers():
    """{name: (build(attention), inputs, loss(model, inputs) -> (output,
    loss), the parameter whose gradient is compared)}."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.models.bert import Bert, BertConfig, mlm_loss
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig, loss_fn
    from horovod_tpu_torch.models.vit import ViT, ViTConfig
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, 256, (2, 40), generator=g)
    mask = torch.ones(2, 40, dtype=torch.bool)
    mask[1, -9:] = False
    mpos = (torch.rand(2, 40, generator=g) < 0.15).float()
    images = torch.randn(4, 3, 32, 32, generator=g)
    labels = torch.randint(0, 10, (4,), generator=g)
    f32 = torch.float32

    def bert_loss(m, x):
        mlm, nsp = m(x[0], attention_mask=x[1])
        return mlm, mlm_loss(mlm, x[0], x[2]) + 0.1 * (nsp ** 2).mean()

    def vit_loss(m, x):
        logits = m(x[0])
        return logits, F.cross_entropy(logits, x[1])

    def llama_loss(m, x):
        logits = m(x[0])
        return logits, loss_fn(logits, x[0])

    return {
        "bert": (lambda a: Bert(BertConfig.tiny(dtype=f32, attention=a)),
                 (tokens, mask, mpos), bert_loss, "layer.0.qkv.weight"),
        "vit": (lambda a: ViT(ViTConfig.tiny(dtype=f32, attention=a)),
                (images, labels), vit_loss, "block.0.qkv.weight"),
        "llama": (lambda a: Llama(LlamaConfig.tiny(dtype=f32, attention=a)),
                  (tokens,), llama_loss, "h.0.attn.wk.weight"),
    }


def phase_tiny_transformers(dev):
    """Tiny fp32 BERT (key mask with padding), ViT (T 17) and Llama (GQA, 4
    heads over 2): flash on the card against flash on the CPU (logits and
    one gradient), and flash against dense on the card."""
    import copy
    for name, (build, inputs, loss_of, pname) in \
            _tiny_transformers().items():
        runs = {}
        cpu = build("flash")
        for tag, model, x in (
                ("cpu", cpu, inputs),
                ("card", copy.deepcopy(cpu).to(dev),
                 [t.to(dev) for t in inputs])):
            out, loss = loss_of(model, x)
            loss.backward()
            runs[tag] = (out, dict(model.named_parameters())[pname].grad)
        dense = build("dense").to(dev)
        dense.load_state_dict(cpu.state_dict())
        log(f"tiny fp32 {name}, flash on the card against flash on the CPU "
            f"and against dense on the card:")
        _close(f"{name} logits", runs["card"][0], runs["cpu"][0], LOGIT_TOL,
               floor=0.0)
        _close(f"{name} {pname} grad", runs["card"][1], runs["cpu"][1],
               GRAD_TOL, floor=0.0)
        _close(f"{name} flash vs dense logits", runs["card"][0],
               loss_of(dense, [t.to(dev) for t in inputs])[0], LOGIT_TOL,
               floor=0.0)


# GPT-2 medium's weights as built on the CPU from seed 0 (the main path's),
# kept after the first build so that later GPT-2 medium paths of this
# process start from the same weights without building them again.
_GPT2_MEDIUM_CPU = {}


def packed_batch(b, t, vocab, seed=0):
    """``bench.py:598-616``'s packed batch: tokens from
    ``default_rng(seed)``, then three fixed cuts a row (~4 documents),
    segment ids counting the cuts passed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, t))
    bounds = np.sort(rng.integers(t // 8, t - t // 8, (b, 3)), axis=1)
    seg = np.zeros((b, t), np.int32)
    for row in range(b):
        for cut in bounds[row]:
            seg[row, cut:] += 1
    return tokens, seg


def _gpt2_medium(dev, **cfg_extra):
    """GPT-2 medium with flash attention and the main path's weights; at
    another depth (``num_layers``, phase 19 (b) and (c)'s workers) with
    weights of its own from seed 0."""
    import torch
    from horovod_tpu_torch.models import get_model
    if "num_layers" in cfg_extra:
        with torch.device(dev):
            return get_model("gpt2", num_heads=16, d_model=1024,
                             attention="flash", generator=torch.Generator(
                                 device=dev).manual_seed(0), **cfg_extra)
    if not _GPT2_MEDIUM_CPU:
        cpu = get_model("gpt2_medium", attention="flash",
                        generator=torch.Generator().manual_seed(0))
        _GPT2_MEDIUM_CPU.update(cpu.state_dict())
    with torch.device(dev):
        model = get_model("gpt2_medium", attention="flash",
                          generator=torch.Generator(device=dev).manual_seed(
                              0), **cfg_extra)
    model.load_state_dict(_GPT2_MEDIUM_CPU)
    return model


def _moe_hooks(model):
    """A list that each MoE layer's forward appends (aux loss, kept
    assignments: the dispatch tensor's sum) to, through forward hooks."""
    from horovod_tpu_torch.ops.moe import MoEMLP
    seen = []
    for m in list(model.modules()):
        if isinstance(m, MoEMLP):
            kept = {}
            m.router.register_forward_hook(
                lambda mod, i, o, kept=kept: kept.update(n=o[0].detach()
                                                         .sum()))
            m.register_forward_hook(
                lambda mod, i, o, kept=kept: seen.append((o[1].detach(),
                                                          kept["n"])))
    return seen


def _moe_step_stats(seen, n, k):
    """(mean aux loss, share of the k choices a token makes that found no
    slot) over one forward's MoE layers, as device tensors."""
    import torch
    aux = torch.stack([a for a, _ in seen]).mean()
    kept = torch.stack([c for _, c in seen]).sum()
    return aux, 1.0 - kept / (k * n * len(seen))


def build_path(name, dev, rows=None, cfg_extra=None, **opt_extra):
    """One training path at full width, on ``dev``, from seed 0: (model,
    optimizer, loss closure, info: the items a step and their unit, the
    model's inputs, the LM head's multiply-adds a step outside ``Dense``,
    the attention's (B, heads, T, causal) or its visible pairs summed over
    layers, the launches of each kernel a step, the optimizer's name).
    GPT-2 medium as ``bench.py:258-286``, BERT-large and Llama-340M as
    ``:289-319`` and ``:552-586`` without the bench's remat, ViT-B/16 as
    ``:322-353`` with ``attention="flash"``; phase 9's paths with the
    bench's ``remat_policy="dots"``: ``gpt2_long`` (``:520-549``),
    ``gpt2_packed`` (``:589-630``), ``llama_moe`` (``:552-586``'s Llama
    with 8 experts, top-2, capacity 1.25) and ``t5_small``
    (``:632-667``); ``t5_small_padded`` is ``t5_small`` with the padded
    source tails of ``t5_source`` and ``t5_small_tp`` the same through
    ``mp.tensor_parallel`` over the mesh's mp set, its optimizer over the
    dp set (phase 15 (a)). ``cfg_extra`` replaces fields of GPT-2 medium's
    config (phase 9 (b): ``remat``, ``remat_policy``) and of
    ``gpt2_long``'s (phase 10 (c): sequence parallelism; the striped layout
    trains on ``striped_lm_loss``). ``opt_extra`` goes to
    ``DistributedOptimizer`` (phase 7: ``overlap``, ``compression``,
    ``error_feedback``). ``rows`` (GPT-2 medium) takes this rank's slice of
    the batch (phase 8's two-rank worlds). ``gpt2_medium_tp`` is GPT-2
    medium through ``mp.tensor_parallel`` over the mesh's mp set and
    ``mp.vocab_parallel_loss``, its optimizer over the dp set (phase 13
    (a)). ``gpt2_medium_sp_tp`` and ``llama_moe_ep_tp`` are the reference's
    dryrun steps over ``make_mesh`` of the world (``dryrun_dims``): GPT-2
    medium with the contiguous flash ring over the sp line, the
    vocab-parallel loss over the whole sequence and the optimizer over the
    dp x sp plane; ``llama_moe`` with E/ep experts a rank and the optimizer
    over the dp line (phase 14)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import get_model
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    from horovod_tpu_torch.parallel import make_mesh
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    opt_kw = {}
    dots = dict(remat=True, remat_policy="dots")
    info = {}
    if name in ("gpt2_medium", "gpt2_medium_tp", "gpt2_medium_sp_tp"):
        from horovod_tpu_torch.models.gpt2 import loss_fn
        from horovod_tpu_torch.parallel import mp
        lm_loss = loss_fn
        if name == "gpt2_medium_sp_tp":
            # The reference's dp x sp x tp step: the rings over the sp
            # line at the local head count, the loss exact over the whole
            # sequence and the vocab slices, the optimizer over the dp x
            # sp plane.
            model = _gpt2_medium(dev, use_ring_attention=True)
            mesh = make_mesh(dict(zip(("dp", "sp", "tp"),
                                      dryrun_dims(hvd.size()))))
            tp_set = mesh.process_set("tp")
            model = mp.tensor_parallel(model, tp_set,
                                       sp=mesh.process_set("sp"))

            def lm_loss(logits, x):
                return mp.vocab_parallel_loss(logits, x, tp_set,
                                              sp=model.sp,
                                              layout=model.cfg.ring_layout)
            opt_kw = {"process_set": mesh.process_set(("dp", "sp"))}
        else:
            model = _gpt2_medium(dev, **(cfg_extra or {}))
        if name == "gpt2_medium_tp":
            # Tensor parallelism over the mesh's mp set (one rank here),
            # the optimizer over its dp set.
            model = mp.tensor_parallel(model)
            lm_loss = mp.vocab_parallel_loss
            opt_kw = {"process_set": hvd.mesh2d().process_set("dp")}
        b, t = 8, 1024
        tokens = torch.randint(0, model.cfg.vocab_size, (b, t),
                               generator=torch.Generator().manual_seed(0))
        inputs = (tokens if rows is None else tokens[rows]).to(dev)

        def loss():
            return lm_loss(model(inputs), inputs)
    elif name == "gpt2_long":
        from horovod_tpu_torch.models.gpt2 import loss_fn, striped_lm_loss
        with torch.device(dev):
            model = get_model("gpt2_medium", max_seq_len=4096,
                              attention="flash", generator=g, **dots,
                              **(cfg_extra or {}))
        b, t = 2, 4096
        inputs = torch.tensor(rng.integers(0, model.cfg.vocab_size, (b, t)),
                              device=dev)
        striped = model.cfg.use_ring_attention and \
            model.cfg.ring_layout == "striped"
        lm_loss = striped_lm_loss if striped else loss_fn

        def loss():
            return lm_loss(model(inputs), inputs)
    elif name == "gpt2_packed":
        from horovod_tpu_torch.models.gpt2 import loss_fn
        from horovod_tpu_torch.ops.attention import packed_positions
        model = _gpt2_medium(dev, **dots)
        b, t = 8, 1024
        tokens, seg = packed_batch(b, t, model.cfg.vocab_size)
        inputs = torch.tensor(tokens, device=dev)
        seg = torch.tensor(seg, device=dev)
        pos = packed_positions(seg)
        h = model.cfg.num_heads
        info["pairs"] = _visible_pairs(b * h, t, t, True, 0, h,
                                       seg=seg) * model.cfg.num_layers

        def loss():
            return loss_fn(model(inputs, segment_ids=seg, positions=pos),
                           inputs, segment_ids=seg)
    elif name == "bert_large":
        from horovod_tpu_torch.models.bert import mlm_loss
        with torch.device(dev):
            model = get_model("bert_large", attention="flash", generator=g)
        b, t = 8, 512
        inputs = torch.tensor(rng.integers(0, model.cfg.vocab_size, (b, t)),
                              device=dev)
        mpos = torch.tensor(rng.random((b, t)) < 0.15, device=dev).float()

        def loss():
            return mlm_loss(model(inputs)[0], inputs, mpos)
        opt_kw = {"op": hvd.Adasum}
    elif name == "vit_b16":
        with torch.device(dev):
            model = get_model("vit_b16", attention="flash", generator=g)
            b, t = 128, 197
            inputs = torch.randn(b, 3, 224, 224, generator=g)
            labels = torch.randint(0, 1000, (b,), generator=g)

        def loss():
            return F.cross_entropy(model(inputs), labels)
    elif name in ("t5_small", "t5_small_padded", "t5_small_tp"):
        from horovod_tpu_torch.models.t5 import seq2seq_loss, shift_right
        with torch.device(dev):
            model = get_model("t5_small", generator=g, **dots)
        cfg = model.cfg
        b, t = 16, 512
        src = torch.tensor(rng.integers(1, cfg.vocab_size, (b, t)),
                           device=dev)
        inputs = torch.tensor(rng.integers(1, cfg.vocab_size, (b, t)),
                              device=dev)
        if name != "t5_small":
            src = t5_source(src, cfg.pad_id)
        if name == "t5_small_tp":
            # T5's own split over the mesh's mp set (one rank here), the
            # optimizer over its dp set.
            from horovod_tpu_torch.parallel import mp
            model = mp.tensor_parallel(model,
                                       hvd.mesh2d().process_set("mp"))
            opt_kw = {"process_set": hvd.mesh2d().process_set("dp")}
        h = cfg.num_heads
        # Encoder self (all pairs), decoder self (causal) and cross.
        info.update(
            pairs=b * h * (cfg.num_encoder_layers * t * t
                           + cfg.num_decoder_layers * (t * (t + 1) // 2
                                                       + t * t)),
            head_dim=cfg.head_dim,
            layers=cfg.num_encoder_layers + cfg.num_decoder_layers,
            macs_args=(src, shift_right(inputs, cfg.pad_id)),
            launches={k: 0 for k in fa.KERNELS})

        def loss():
            return seq2seq_loss(model, src, inputs)
    else:
        from horovod_tpu_torch.models.llama import loss_fn, loss_fn_moe
        moe = dict(num_experts=8, moe_router="top2",
                   expert_capacity_factor=1.25, **dots) \
            if name in ("llama_moe", "llama_moe_ep_tp") else {}
        with torch.device(dev):
            model = get_model("llama", vocab_size=32000, max_seq_len=2048,
                              num_layers=24, num_heads=16, num_kv_heads=4,
                              d_model=1024, d_ff=2816, attention="flash",
                              generator=g, **moe)
        b, t = 4, 2048
        inputs = torch.tensor(rng.integers(0, model.cfg.vocab_size, (b, t)),
                              device=dev)
        moe_loss = loss_fn_moe
        if name == "llama_moe_ep_tp":
            # The reference's dp x ep x tp step: E/ep experts a rank, the
            # tokens replicated over ep, the optimizer over the dp line.
            from horovod_tpu_torch.parallel import mp
            mesh = make_mesh(dict(zip(("dp", "ep", "tp"),
                                      dryrun_dims(hvd.size()))))
            tp_set = mesh.process_set("tp")
            model = mp.tensor_parallel(model, tp_set,
                                       ep=mesh.process_set("ep"))
            opt_kw = {"process_set": mesh.process_set("dp")}

            def moe_loss(m, x):
                logits, aux = m(x, return_aux=True)
                return mp.vocab_parallel_loss(logits, x, tp_set) \
                    + 1e-2 * aux.mean()
        if moe:
            info["moe_steps"] = moe_steps = []
            seen = _moe_hooks(model)

        def loss():
            if not moe:
                return loss_fn(model(inputs), inputs)
            seen.clear()
            out = moe_loss(model, inputs)
            # The forward's layers only (the recompute comes later).
            moe_steps.append(_moe_step_stats(seen, b * t, 2))
            return out
    cfg = model.cfg
    lm = name != "vit_b16"
    layers = info.get("layers", getattr(cfg, "num_layers", 0))
    # The path's own entries (T5's pairs and launches) replace these.
    info = {"items": b * t if lm else b, "unit": "tokens" if lm else "images",
            "inputs": inputs,
            "head_macs": b * t * cfg.vocab_size * cfg.d_model if lm else 0,
            "attention": (b, cfg.num_heads, t,
                          name not in ("bert_large", "vit_b16")),
            "launches": {k: layers * (2 if getattr(cfg, "remat", False)
                                      and k == "flash_fwd" else 1)
                         for k in fa.KERNELS},
            "optimizer": "AdamW, op=" + ("Adasum" if "op" in opt_kw
                                         else "Average"),
            **info}
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8), **opt_kw,
        **opt_extra)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    return model, opt, loss, info


def phase_train_path(name, card, dev, steps=5, cfg_extra=None, **opt_extra):
    """Trains one path of ``build_path`` for ``steps`` steps: the loss must
    be finite and falling and each kernel must launch as the path says a
    step (``num_layers`` times; the forward twice that under remat, which
    runs it again in the backward; never on T5), the counts set to 0 just
    before the steps and read just after. Returns tokens or images/s, the
    step split, peak memory, the share of the tensor-core bound, the
    losses and the launches, and per step the negotiation rounds and, under ``overlap=True``, what the
    gradient hooks did; under error feedback the largest residual."""
    import torch
    from horovod_tpu_torch import collective as C
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    t0 = time.perf_counter()
    model, opt, loss_of, info = build_path(name, dev, cfg_extra=cfg_extra,
                                           **opt_extra)
    cfg, items, unit = model.cfg, info["items"], info["unit"]
    n_params = sum(p.numel() for p in model.parameters())
    from horovod_tpu_torch import fusion
    from horovod_tpu_torch.config import get_config
    grads = [p for p in model.parameters() if p.requires_grad]
    buckets = len(fusion.make_plan(
        [p.numel() for p in grads], [p.dtype for p in grads],
        get_config().fusion_threshold_bytes).buckets)
    want = info["launches"]
    remat = cfg.remat_policy if getattr(cfg, "remat", False) else "none"
    log(f"{name}: d {cfg.d_model}, {cfg.num_heads} heads, {n_params} "
        f"params, {items} {unit} a step, {cfg.dtype}, attention "
        f"{getattr(cfg, 'attention', 'dense')}, remat {remat}, "
        f"{info['optimizer']}, kernel launches a step {want}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    macs = _conv_macs(model, *info.get("macs_args", (info["inputs"],)))
    pairs = info.get("pairs")
    if pairs is None:
        b, h, t, causal = info["attention"]
        pairs = _visible_pairs(b * h, t, t, causal, 0, h) * cfg.num_layers
    hd = info.get("head_dim", cfg.d_model // cfg.num_heads)
    # Model FLOPs: forward 2 per multiply-add of every dense layer, conv,
    # MoE layer and LM head, plus 4·d per visible (q, k) pair and layer;
    # backward twice the forward (remat's recompute is not counted).
    flops = 3 * (2 * (macs + info["head_macs"]) + 4 * hd * pairs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, wall, parts, rounds, hooks = [], [], [], [], []
    for step in range(steps):
        before = dict(fa.launches)
        n0 = sum(C.negotiation_stats().values())
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        opt.zero_grad()
        loss = loss_of()
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        losses.append(loss.item())
        rounds.append(sum(C.negotiation_stats().values()) - n0)
        if opt.last_overlap is not None:
            hooks.append(dict(opt.last_overlap))
        grew = {k: fa.launches[k] - before[k] for k in fa.KERNELS}
        log(f"{name} step {step}: loss {losses[-1]:.6f}  {wall[-1]:.3f} s  "
            f"forward {parts[-1][0]:.1f} ms  backward {parts[-1][1]:.1f} ms"
            f"  allreduce+adamw {parts[-1][2]:.1f} ms  launches {grew}")
        if grew != want:
            fail(f"{name}: the kernels must launch {want} a step, got "
                 f"{grew}")
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        fail(f"{name}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{name}: loss is not falling: {losses}")
    steady = wall[1:]
    med = [statistics.median(p[i] for p in parts[1:]) for i in range(3)]
    step_ms = statistics.median(steady) * 1e3
    bound_ms = flops / PEAK_BF16_FLOPS * 1e3
    out = {f"{unit}_per_s": items * len(steady) / sum(steady),
           "step_ms_median": step_ms, "forward_ms": med[0],
           "backward_ms": med[1], "allreduce_adamw_ms": med[2],
           "peak_gib": peak / 2 ** 30, "step_tflop": flops / 1e12,
           "bound_ms": bound_ms, "share_of_bound": bound_ms / step_ms,
           "losses": losses, "launches": launches, "params": n_params,
           "buckets_per_step": buckets,
           "state_tensors": sum(torch.is_tensor(t)
                                for t in model.state_dict().values()),
           "rounds": rounds, "overlap": hooks}
    if opt._ef:
        out["ef_residual_max"] = max(float(r.abs().max())
                                     for r in opt._residual.values())
    if "moe_steps" in info:
        out["moe_aux"], out["moe_dropped_share"] = (
            [float(x[i]) for x in info["moe_steps"][-steps:]]
            for i in (0, 1))
        log(f"{name}: aux loss a step {out['moe_aux']}, share of the "
            f"top-2 choices dropped a step {out['moe_dropped_share']}")
    log(f"{name} on {card}: {out[f'{unit}_per_s']:.1f} {unit}/s (steps "
        f"1-{steps - 1}, wall), step {step_ms:.1f} ms median (forward "
        f"{med[0]:.1f}, backward {med[1]:.1f}, allreduce+adamw {med[2]:.1f} "
        f"ms, device time between events), peak memory "
        f"{out['peak_gib']:.2f} GiB; {flops / 1e12:.3f} TFLOP a step, "
        f"tensor-core bound {bound_ms:.3f} ms = {out['share_of_bound']:.4f}"
        f" of the step; launches {launches}; losses {losses}")
    del model, opt
    torch.cuda.empty_cache()
    return out


def phase_adasum_card(dev):
    """Adasum on the card: on one rank it returns its input bit for bit;
    its arithmetic (the combine, a VHDD round's partial dot and norms
    summed over the two halves, the coefficients and the scaled add) on
    card tensors against float64 on the CPU, for fp32 and bf16 buffers of
    4 M elements. The fp32 results must hold 1e-5 of the float64 scale
    (|a||b| for the dot, |a|^2 for the norms, 1 for the coefficients, the
    largest element for vectors); the bf16 combine that plus one rounding
    to bf16 (2^-8 of each element)."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import adasum as A
    g = torch.Generator(device=dev).manual_seed(6)
    n = 4 * 2 ** 20
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        x = torch.randn(n, generator=g, device=dev).to(dtype)
        if not torch.equal(hvd.allreduce(x, op=hvd.Adasum), x):
            fail(f"Adasum on one rank changed its {tag} input")
        pair = hvd.grouped_allreduce([x, x[:1000] * 2], op=hvd.Adasum)
        if not (torch.equal(pair[0], x) and torch.equal(pair[1],
                                                        x[:1000] * 2)):
            fail(f"grouped Adasum on one rank changed its {tag} inputs")
        a = torch.randn(n, generator=g, device=dev).to(dtype)
        b = (0.5 * a.float() + torch.randn(n, generator=g, device=dev)).to(
            dtype)
        a64, b64 = a.double().cpu(), b.double().cpu()
        want = torch.stack([a64 @ b64, a64 @ a64, b64 @ b64])
        scale = torch.stack([(want[1] * want[2]).sqrt(), want[1], want[2]])
        half = n // 2
        af, bf = a.float(), b.float()
        full = A.dot_and_norms(af, bf)
        split = (A.dot_and_norms(af[:half], bf[:half])
                 + A.dot_and_norms(af[half:], bf[half:]))
        errs = {}
        for what, got in (("dot and norms", full),
                          ("halves' partials summed", split)):
            errs[what] = ((got.double().cpu() - want).abs()
                          / scale).max().item()
        ca64 = 1 - want[0] / (2 * want[1])
        cb64 = 1 - want[0] / (2 * want[2])
        ca, cb = A.coefficients(*split.unbind())
        errs["coefficients"] = max(abs(ca.item() - ca64.item()),
                                   abs(cb.item() - cb64.item()))
        exact = ca64 * a64 + cb64 * b64
        top = exact.abs().max().item()
        errs["scaled add"] = ((A.scaled_add(ca, af, cb, bf).double().cpu()
                               - exact).abs().max().item() / top)
        comb = A.adasum_combine(a, b)
        if comb.dtype != dtype:
            fail(f"adasum_combine returned {comb.dtype} for {tag}")
        err = (comb.double().cpu() - exact).abs()
        # fp32: the fp32 limit; bf16: that plus one rounding to bf16, as a
        # share of that bound (at most 1).
        errs["combine"] = (err.max().item() / top if dtype == torch.float32
                           else (err / (2 ** -8 * exact.abs() + 1e-5 * top)
                                 ).max().item())
        lim = {k: 1e-5 for k in errs}
        if dtype == torch.bfloat16:
            lim["combine"] = 1.0
        log(f"Adasum arithmetic on the card, {tag}, {n} elements, against "
            f"float64 on the CPU: " + ", ".join(
                f"{k} {v:.3e} (limit {lim[k]:.1e})" for k, v in errs.items()))
        bad = [k for k, v in errs.items() if not v <= lim[k]]
        if bad:
            fail(f"Adasum arithmetic ({tag}) off float64 in {bad}")
        worst[tag] = errs
    return worst


def phase_join_mask(dev):
    """The join mask on the card: ``alive=0`` on the one rank gives zero
    (finite: ``n_alive`` is clamped to 1) gradients with Average and Sum,
    and a ``DistributedOptimizer`` step with ``alive=1`` equals one without
    the mask, bit for bit."""
    import copy
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig, loss_fn
    g = torch.Generator(device=dev).manual_seed(7)
    for op in (hvd.Average, hvd.Sum):
        grads = [torch.randn(300, generator=g, device=dev),
                 torch.randn(4, 5, generator=g, device=dev)]
        out = hvd.allreduce_gradients(grads, op=op, alive=0)
        if not all(torch.isfinite(t).all() and not t.any() for t in out):
            fail(f"alive=0 must give zero gradients (op {op})")
    with torch.device(dev):
        base = Llama(LlamaConfig.tiny(attention="flash"),
                     torch.Generator(device=dev).manual_seed(8))
    tokens = torch.randint(0, 256, (2, 64), generator=g, device=dev)
    after = []
    for alive in (None, 1):
        m = copy.deepcopy(base)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(m.parameters(),
                                                         lr=1e-3))
        opt.zero_grad()
        loss_fn(m(tokens), tokens).backward()
        if alive is None:
            opt.step()
        else:
            opt.step(alive=alive)
        after.append([p.detach().clone() for p in m.parameters()])
    if not all(torch.equal(a, b) for a, b in zip(*after)):
        fail("a step with alive=1 differs from a step without the mask")
    m = copy.deepcopy(base)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(m.parameters()))
    loss_fn(m(tokens), tokens).backward()
    opt.synchronize(alive=0)
    if any(p.grad.any() for p in m.parameters() if p.grad is not None):
        fail("alive=0 left a nonzero gradient in DistributedOptimizer")
    log("join mask on the card: alive=0 gives zero gradients (Average, "
        "Sum, DistributedOptimizer), alive=1 equals no mask bit for bit")


def phase_new_paths(card):
    """Phase 5 on a new one-rank NCCL world: returns its report."""
    import torch
    import horovod_tpu_torch as hvd
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    dev = hvd.device()
    kernels = phase_path_kernels()
    phase_tiny_transformers(dev)
    trained = {name: phase_train_path(name, card, dev) for name in PATHS}
    adasum = phase_adasum_card(dev)
    phase_join_mask(dev)
    hvd.shutdown()
    torch.cuda.synchronize()
    return {"kernels": kernels, "trained": trained, "adasum": adasum}

# ---------------------------------------------------------------- phase 6

LOSS_TOL = 1e-6     # absolute: phase 3's losses, observed or not


def _phase_events(trace):
    """{op_id: [phase names]} of the trace's complete phase events."""
    ops: dict = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "phase" and e.get("ph") == "X":
            ops.setdefault(e["args"]["op_id"], []).append(
                (e["name"], e["args"]["kind"]))
    return ops


def _counter(snap, name, **labels):
    return sum(s["value"] for s in snap["counters"].get(name, [])
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def phase_controller(card, main_path):
    """Phase 6: the controller on the card. GPT-2 medium's phase-3 run
    again on a new one-rank NCCL world, under the timeline (started before
    ``init``, so init's clock anchor is in it), the metrics flusher and the
    stall watchdog that ``init`` starts; then a planted stall; then, with
    two cards, ``tools/torch_controller_bench.py --np 2``."""
    import os
    import tempfile
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics, timeline
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase6_")
    trace_path = os.path.join(tmp, "trace.json")
    prom_path = os.path.join(tmp, "metrics.prom")
    hvd.start_timeline(trace_path)
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    hvd.start_metrics_flusher(prom_path, interval_s=0.5)
    dog = hvd.get_stall_watchdog()
    if dog is None or dog._thread is None:
        fail("init did not start the stall watchdog")
    before = metrics.snapshot()
    run = phase_train_path("gpt2_medium", card, hvd.device())
    after = metrics.snapshot()
    hvd.stop_timeline()
    hvd.stop_metrics_flusher()

    with open(trace_path) as f:
        trace = json.load(f)            # valid JSON, or this raises
    anchors = [e for e in trace["traceEvents"] if e["name"] == "clock_anchor"]
    if len(anchors) != 1 or anchors[0]["cat"] != "trace" or \
            anchors[0]["ph"] != "i" or set(anchors[0]["args"]) != {
                "epoch", "wall_time"}:
        fail(f"phase 6: no clock_anchor of the reference's form: {anchors}")
    ops = _phase_events(trace)
    if sorted(ops) != list(range(1, len(ops) + 1)):
        fail(f"phase 6: op ids are not 1..{len(ops)}: {sorted(ops)[:20]}")
    bad = {i: p for i, p in ops.items()
           if sorted(n for n, _ in p) != ["EXEC", "QUEUE"]}
    if bad:
        fail(f"phase 6: ops without one QUEUE and one EXEC: "
             f"{dict(list(bad.items())[:5])}")
    kinds = [p[0][1] for _, p in sorted(ops.items())]
    steps = len(run["losses"])
    delta = {k: _counter(after, "collective_calls_total", kind=k)
             - _counter(before, "collective_calls_total", kind=k)
             for k in ("allreduce", "broadcast")}
    buckets = (_counter(after, "fusion_buckets_total")
               - _counter(before, "fusion_buckets_total"))
    want = {"allreduce": steps, "broadcast": run["state_tensors"]}
    if delta != want or kinds.count("allreduce") != steps or \
            buckets != steps * run["buckets_per_step"]:
        fail(f"phase 6: collective_calls_total grew by {delta} (the steps "
             f"issued {want}), {kinds.count('allreduce')} allreduce spans, "
             f"fusion_buckets_total by {buckets} (the plan: "
             f"{steps} x {run['buckets_per_step']})")
    with open(prom_path) as f:
        prom = f.read()
    line = 'horovod_tpu_collective_calls_total{kind="allreduce"}'
    if f"{line} {_counter(after, 'collective_calls_total', kind='allreduce')}" \
            not in prom:
        fail(f"phase 6: the metrics file lacks {line}")
    diffs = [abs(a - b) for a, b in zip(run["losses"],
                                        main_path["losses"])]
    if len(diffs) != steps or max(diffs) > LOSS_TOL:
        fail(f"phase 6: losses {run['losses']} differ from phase 3's "
             f"{main_path['losses']} by up to {max(diffs):.3e} "
             f"(limit {LOSS_TOL})")
    log(f"phase 6: GPT-2 medium under the timeline, the metrics flusher and "
        f"the stall watchdog: {len(ops)} ops with QUEUE and EXEC, op ids "
        f"1..{len(ops)} ({steps} grouped allreduces, {delta['broadcast']} "
        f"broadcasts), fusion_buckets_total +{buckets}, losses within "
        f"{max(diffs):.3e} of phase 3's; step {run['step_ms_median']:.2f} ms "
        f"median of steps 2-{steps} against phase 3's "
        f"{main_path['step_ms_median']:.2f} ms")

    # A planted stall: a collective that begins and never ends.
    stall_path = os.path.join(tmp, "stall.json")
    timeline.start_timeline(stall_path)
    seen = []
    n0 = metrics.registry.counter("stall_events_total").value
    tok = metrics.collective_begin("allreduce", name="planted/stall",
                                   nbytes=4096)
    planted = metrics.StallWatchdog(timeout_s=0.2, poll_s=0.05,
                                    on_stall=seen.append).start()
    try:
        time.sleep(0.8)
    finally:
        planted.stop()
        metrics.collective_end(tok)
        timeline.stop_timeline()
    with open(stall_path) as f:
        marks = [e for e in json.load(f)["traceEvents"]
                 if e["name"] == "collective_stall"]
    fired = metrics.registry.counter("stall_events_total").value - n0
    if len(seen) != 1 or seen[0]["tensor"] != "planted/stall" or \
            fired != 1 or len(marks) != 1 or \
            marks[0]["args"]["tensor"] != "planted/stall":
        fail(f"phase 6: the planted stall fired {len(seen)} reports "
             f"({seen}), stall_events_total +{fired}, {len(marks)} markers")
    log(f"phase 6: planted stall reported once after "
        f"{seen[0]['pending_s']:.3f} s: {seen[0]}")
    hvd.shutdown()
    torch.cuda.synchronize()

    world = None
    if torch.cuda.device_count() >= 2:
        proc = subprocess.run(
            [sys.executable, "tools/torch_controller_bench.py", "--np", "2"],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"phase 6: the two-rank NCCL world failed:\n"
                 f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
        world = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"phase 6: two-rank NCCL world on two cards: {world}")
    else:
        log("phase 6: the two-rank NCCL part (join service, mismatch, "
            "negotiation time) did not run for want of a second card "
            f"(cards: {torch.cuda.device_count()})")
    return {"step_ms_median": run["step_ms_median"],
            "phase3_step_ms_median": main_path["step_ms_median"],
            "losses": run["losses"], "max_loss_diff": max(diffs),
            "ops": len(ops), "collective_calls": delta,
            "fusion_buckets": buckets, "launches": run["launches"],
            "stall_report": seen[0], "two_rank_world": world}


# ---------------------------------------------------------------- phase 7

# Absolute band around phase 3's losses that the int8 run (error feedback
# on) must stay in, at every step (written into PERF.md before the run).
INT8_LOSS_BAND = 0.02


def _gpt2_bucket_sizes():
    """The element counts of GPT-2 medium's gradient buckets under a
    quantized wire: the fusion plan of its parameters at the default
    threshold, each tensor padded to whole blocks (``fusion.py``)."""
    import torch
    from horovod_tpu_torch import fusion
    from horovod_tpu_torch.config import get_config
    from horovod_tpu_torch.models import get_model
    from horovod_tpu_torch.ops.quantized import BLOCK
    with torch.device("meta"):
        model = get_model("gpt2_medium", attention="flash")
    ps = [p for p in model.parameters() if p.requires_grad]
    plan = fusion.make_plan([p.numel() for p in ps], [p.dtype for p in ps],
                            get_config().fusion_threshold_bytes, BLOCK)
    return sorted({sum(plan.padded_len(s) for s in segs)
                   for segs in plan.buckets})


def _plain_one_rank(x, wire):
    """The quantized allreduce of one rank, in plain torch on the CPU:
    quantize, dequantize, divide by 1, re-quantize, dequantize."""
    from horovod_tpu_torch.ops.quantized import (BLOCK, dequantize_blocks,
                                                 quantize_blocks)
    L = x.numel()
    c = -(-L // BLOCK) * BLOCK
    rows = torch_pad(x, c).view(1, c)
    q1, s1 = quantize_blocks(rows, wire)
    part = dequantize_blocks(q1, s1)[0] / 1.0
    q2, s2 = quantize_blocks(part, wire)
    return dequantize_blocks(q2, s2)[:L]


def torch_pad(x, n):
    import torch
    return torch.nn.functional.pad(x, (0, n - x.numel()))


def _codes_with_scale(x, scale, wire):
    """``x`` quantized with the given per-block scales (a planted fault)."""
    import torch
    from horovod_tpu_torch.ops.quantized import BLOCK
    L = x.numel()
    blocks = torch_pad(x, scale.numel() * BLOCK).view(-1, BLOCK) \
        / scale[:, None]
    if wire == "int8":
        q = torch.round(blocks).clamp(-127, 127).to(torch.int8)
    else:
        q = blocks.clamp(-448.0, 448.0).to(torch.float8_e4m3fn)
    return q.reshape(-1)[:L]


def _codes_equal(q, s, q_ref, s_ref) -> bool:
    import torch
    return (torch.equal(q.cpu().view(torch.uint8), q_ref.view(torch.uint8))
            and torch.equal(s.cpu(), s_ref))


def phase_quantized(dev):
    """Phase 7 (a): the quantized allreduce on the card at GPT-2 medium's
    bucket sizes, int8 and fp8: the card's codes and scales equal the
    CPU's, the one-rank result equals the plain CPU computation bit for
    bit and lies within one step of each block (two re-quantizations of
    half a step) of the input; a planted fault (codes made with a scale
    one step off) must fail the code check. On one rank the division by
    the member count and the re-quantization change nothing (re-quantizing
    dequantized codes gives the same codes), so no fault of theirs can
    show here; the CPU tests hold them against the reference on 2 and 4
    ranks."""
    import numpy as np
    import torch
    from horovod_tpu_torch.ops.quantized import (BLOCK, quantize_blocks,
                                                 quantized_allreduce)
    sizes = _gpt2_bucket_sizes()
    picked = sorted({sizes[0], sizes[len(sizes) // 2], sizes[-1]})
    rows = []
    for L in picked:
        g = np.random.default_rng(L % 100003)
        blocks = -(-L // BLOCK)
        mag = np.exp(g.uniform(-12, 2, blocks)).astype(np.float32)
        x = (g.standard_normal(L).astype(np.float32)
             * np.repeat(mag, BLOCK)[:L])
        x[:BLOCK] = 0.0                         # a zero block
        xc = torch.from_numpy(x)
        xd = xc.to(dev)
        for wire in ("int8", "fp8"):
            q_d, s_d = quantize_blocks(xd, wire)
            q_c, s_c = quantize_blocks(xc, wire)
            if not _codes_equal(q_d, s_d, q_c, s_c):
                fail(f"phase 7: {wire} codes or scales on the card differ "
                     f"from the CPU's at {L} elements")
            out = quantized_allreduce(xd, average=True, wire=wire)
            torch.cuda.synchronize()
            want = _plain_one_rank(xc, wire)
            if not torch.equal(out.cpu(), want):
                fail(f"phase 7: {wire} allreduce at {L} elements differs "
                     f"from the plain CPU computation by "
                     f"{float((out.cpu() - want).abs().max()):.3e}")
            absmax = torch_pad(xc.abs(), blocks * BLOCK).view(-1, BLOCK) \
                .amax(1)
            step = (absmax / (127.0 if wire == "int8" else 8.0)) \
                .repeat_interleave(BLOCK)[:L]
            err = (out.cpu() - xc).abs()
            if not bool((err <= step).all()):
                fail(f"phase 7: {wire} result off its input by more than "
                     f"a step: {float((err - step).max()):.3e}")
            # A planted fault must fail the code check: codes made with a
            # scale one int8 step too large, reported with the right scale.
            q_bad = _codes_with_scale(xd, s_d * (1.0 + 1.0 / 127.0), wire)
            if _codes_equal(q_bad, s_d, q_c, s_c):
                fail(f"phase 7: a scale off by one step passed the "
                     f"{wire} code check")
            ms = cuda_ms(lambda: quantized_allreduce(xd, True, wire), reps=5)
            t0 = time.perf_counter()
            _plain_one_rank(xc, wire)
            plain_ms = (time.perf_counter() - t0) * 1e3
            rows.append({"elements": L, "wire": wire, "ms": ms,
                         "plain_cpu_ms": plain_ms,
                         "max_err_steps": float((err / step.clamp_min(
                             1e-30)).max())})
            log(f"phase 7: quantized allreduce {wire}, {L} elements "
                f"({L * 4 / 2 ** 20:.1f} MB fp32): codes and scales equal "
                f"the CPU's, result equals the plain one bit for bit, "
                f"worst error {rows[-1]['max_err_steps']:.3f} of a step; "
                f"{ms:.3f} ms on the card, plain on the CPU {plain_ms:.1f} "
                f"ms; the planted scale fault was caught")
    return {"bucket_sizes": sizes, "checked": rows}


def phase_collective_depth(card, main_path):
    """Phase 7 on a new one-rank NCCL world: (a) the quantized allreduce;
    (b) GPT-2 medium under ``DistributedOptimizer(overlap=True)``; (c) the
    same with ``Compression.int8`` and error feedback, and one step with
    ``Compression.fp8``; (d) with two cards,
    ``tools/torch_collective_bench.py --np 2``."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    dev = hvd.device()
    quant = phase_quantized(dev)

    ov = phase_train_path("gpt2_medium", card, dev, overlap=True)
    diffs = [abs(a - b) for a, b in zip(ov["losses"], main_path["losses"])]
    if max(diffs) > LOSS_TOL:
        fail(f"phase 7: overlap losses {ov['losses']} differ from phase "
             f"3's {main_path['losses']} by {max(diffs):.3e}")
    if any(h["issued_in_backward"] < 1 for h in ov["overlap"]) or \
            len(ov["overlap"]) != len(ov["losses"]):
        fail(f"phase 7: no bucket went out during the backward: "
             f"{ov['overlap']}")
    if any(r > 1 for r in ov["rounds"]):
        fail(f"phase 7: more than one negotiation round a step: "
             f"{ov['rounds']}")
    log(f"phase 7: GPT-2 medium, overlap=True: losses within "
        f"{max(diffs):.3e} of phase 3's, buckets issued in the backward "
        f"{[h['issued_in_backward'] for h in ov['overlap']]} of "
        f"{ov['overlap'][0]['buckets']}, hook firings "
        f"{ov['overlap'][0]['firings']}, rounds {ov['rounds']}; step "
        f"{ov['step_ms_median']:.2f} ms median against phase 3's "
        f"{main_path['step_ms_median']:.2f} ms")

    q = phase_train_path("gpt2_medium", card, dev, overlap=True,
                         compression=hvd.Compression.int8,
                         error_feedback=True)
    band = [abs(a - b) for a, b in zip(q["losses"], main_path["losses"])]
    if max(band) > INT8_LOSS_BAND:
        fail(f"phase 7: int8 losses {q['losses']} leave the band "
             f"{INT8_LOSS_BAND} around phase 3's {main_path['losses']}")
    if not q.get("ef_residual_max", 0.0) > 0.0:
        fail("phase 7: the int8 run's error-feedback residual is zero")
    snap = metrics.snapshot()
    int8_bytes = sum(s["value"] for s in snap["counters"].get(
        "allreduce_wire_bytes_total", [])
        if s["labels"] == {"algorithm": "compression", "wire": "int8"})
    log(f"phase 7: GPT-2 medium, Compression.int8 + error feedback: losses "
        f"{q['losses']}, at most {max(band):.4f} from phase 3's (band "
        f"{INT8_LOSS_BAND}), residual max {q['ef_residual_max']:.3e}, "
        f"int8 wire bytes {int8_bytes}; step {q['step_ms_median']:.2f} ms")

    model, opt, loss_of, _ = build_path(
        "gpt2_medium", dev, overlap=True, compression=hvd.Compression.fp8,
        error_feedback=True)
    opt.zero_grad()
    loss = loss_of()
    loss.backward()
    opt.step()
    torch.cuda.synchronize()
    res = max(float(r.abs().max()) for r in opt._residual.values())
    if not (torch.isfinite(loss).item() and
            abs(loss.item() - main_path["losses"][0]) <= LOSS_TOL and
            res > 0.0):
        fail(f"phase 7: the fp8 step: loss {loss.item()}, residual {res}")
    with torch.no_grad():
        after = float(loss_of().item())
    if not math.isfinite(after):
        fail(f"phase 7: the loss after the fp8 step is {after}")
    log(f"phase 7: one Compression.fp8 step: loss {loss.item():.6f} -> "
        f"{after:.6f}, residual max {res:.3e}")
    del model, opt
    torch.cuda.empty_cache()
    hvd.shutdown()
    torch.cuda.synchronize()

    bench = None
    if torch.cuda.device_count() >= 2:
        proc = subprocess.run(
            [sys.executable, "tools/torch_collective_bench.py", "--np", "2",
             "--sizes", "1,64,1024", "--reps", "5"],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            fail(f"phase 7: the two-rank collective bench failed:\n"
                 f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
        bench = json.loads(proc.stdout.strip().splitlines()[-1])
        best = max(bench["rank0"], key=lambda r: r["busbw_gbs"])
        log(f"phase 7: two-rank collective bench: best busbw "
            f"{best['busbw_gbs']:.1f} GB/s ({best['algorithm']}, "
            f"{best['wire']}, {best['mb']} MB)")
    else:
        log("phase 7: tools/torch_collective_bench.py --np 2 did not run "
            f"for want of a second card (cards: "
            f"{torch.cuda.device_count()})")
    return {"quantized": quant,
            "overlap": {k: ov[k] for k in ("step_ms_median", "losses",
                                           "rounds", "overlap",
                                           "backward_ms",
                                           "allreduce_adamw_ms",
                                           "peak_gib")},
            "int8": {k: q[k] for k in ("step_ms_median", "losses",
                                       "ef_residual_max", "peak_gib")},
            "int8_loss_band": INT8_LOSS_BAND, "max_int8_loss_diff": max(band),
            "phase3_step_ms_median": main_path["step_ms_median"],
            "launches": {"gpt2_medium_overlap": ov["launches"],
                         "gpt2_medium_int8": q["launches"]},
            "two_rank_bench": bench}


# ---------------------------------------------------------------- phase 8

ELASTIC_WORKER = "tools/torch_elastic_worker.py"
# Absolute band between a two-rank golden run's losses and a run whose
# world shrank to one rank after the restore: the same global batch, the
# gradient summed in another order (phase 8 (c)). On two H100s a correct
# shrink lands 6.6e-05 from the golden losses, a restore that leaves
# AdamW's moments fresh 2.8e-02 and one that trains on the old half batch
# 8.4e-02 (tools/torch_elastic_band.py).
SHRINK_LOSS_TOL = 1e-3


def elastic_job(state_dir, np_, spares=0, plan="", steps=5,
                model="gpt2_medium", device="cuda", max_pending=2,
                timeout=900):
    """``runner.run_elastic`` of ``tools/torch_elastic_worker.py`` under the
    fault plan ``plan``; returns (restarts, the lines of its steps.jsonl,
    the lines of its exits.jsonl, wall seconds). The first attempt waits
    for the spares to register, so the fault cannot come before a spare
    could be promoted."""
    import os
    from horovod_tpu_torch.runner import run_elastic
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, os.path.join(root, ELASTIC_WORKER), "--steps",
           str(steps), "--model", model, "--device", device,
           "--max-pending", str(max_pending)]
    if spares:
        cmd += ["--wait-spares", str(spares)]
    env = {"HOROVOD_FAULT_PLAN": plan} if plan else {}
    t0 = time.perf_counter()
    restarts = run_elastic(cmd, np=np_, spares=spares, state_dir=state_dir,
                           extra_env=env, timeout=timeout, max_restarts=1)
    wall = time.perf_counter() - t0

    def jsonl(name):
        path = os.path.join(state_dir, name)
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [json.loads(x) for x in f if x.strip()]
    return restarts, jsonl("steps.jsonl"), jsonl("exits.jsonl"), wall


# What a rank's error says when its peer's process died under it (the
# controller's gloo round reads from or writes to a closed socket).
PEER_LOST = ("by peer", "Broken pipe")


def check_elastic_job(tag, restarts, lines, exits, want_losses, tol, steps,
                      world_after, kill_step, planted, layers=None,
                      promoted=True):
    """Holds one faulted elastic run to its contract: one restart, caused
    by the planted kill: rank ``planted`` died of SIGKILL and every other
    rank of the first attempt was still running when that was seen, or had
    failed in step ``kill_step`` on a lost peer; the promoted spare (when
    ``promoted``) held no CUDA context in standby; the relaunched attempt
    restored the newest published step and re-ran every step after it;
    every step's loss within ``tol`` of ``want_losses``; each kernel
    launched ``layers`` times in every step that ran (when given). Returns
    a summary; raises AssertionError naming the fault."""
    runs = [x for x in lines if "event" not in x]
    done = {x["attempt"]: x for x in lines if x.get("event") == "done"}
    promo = [x for x in lines if x.get("event") == "promoted"]
    errors = {x["rank"]: x for x in lines if x.get("event") == "error"
              and x["attempt"] == 0}
    assert restarts == 1, f"{tag}: {restarts} restarts, expected 1"
    assert [e["attempt"] for e in exits] == [0], \
        f"{tag}: failed attempts {exits}"
    codes = {int(r): c for r, c in exits[0]["exits"].items()}
    assert codes.get(planted) == -signal.SIGKILL, \
        f"{tag}: rank {planted} was to die of the planted SIGKILL; the " \
        f"first attempt's exit codes {codes}, errors {errors}"
    for r, c in codes.items():
        if r == planted or c is None:
            continue
        e = errors.get(r)
        assert e is not None and e["step"] == kill_step and \
            any(m in e["error"] for m in PEER_LOST), \
            f"{tag}: rank {r} failed on its own (exit {c}): {e}"
    assert 1 in done and 0 not in done, f"{tag}: attempts done {sorted(done)}"
    if promoted:
        assert len(promo) == 1 and \
            promo[0]["cuda_initialized_in_standby"] is False, \
            f"{tag}: promotion records {promo}"
    first = sorted(x["step"] for x in runs if x["attempt"] == 0)
    if planted == 0:
        # rank 0 logs every step it finishes, and is the one killed
        assert first == list(range(kill_step)), \
            f"{tag}: the first attempt ran steps {first}, killed at " \
            f"{kill_step}"
    else:
        # Rank 0 logs a step after its save() returns: it can be torn down
        # while a save waits for the writer, before it logs the last steps.
        assert first == list(range(len(first))) and \
            len(first) <= kill_step, \
            f"{tag}: the first attempt ran steps {first}, killed at " \
            f"{kill_step}"
    back = done[1]
    assert back["restored_step"] is not None, \
        f"{tag}: nothing was published before the fault; the relaunch " \
        f"started from step 0"
    published = back["checkpoints_seen"]["published"]
    r = back["restored_step"]
    assert r is not None and r == max(published) and r < kill_step, \
        f"{tag}: restored step {r}, published {published}"
    again = sorted(x["step"] for x in runs if x["attempt"] == 1)
    assert again == list(range(r + 1, steps)), \
        f"{tag}: the relaunch ran {again}, restored at {r}"
    assert all(x["world"] == world_after for x in runs
               if x["attempt"] == 1), f"{tag}: worlds after the restart " \
        f"{sorted({x['world'] for x in runs if x['attempt'] == 1})}"
    diffs = [abs(x["loss"] - want_losses[x["step"]]) for x in runs]
    got = [(x["attempt"], x["step"], x["loss"]) for x in runs]
    assert max(diffs) <= tol, \
        f"{tag}: losses {got} differ from {want_losses} by up to " \
        f"{max(diffs):.3e} (limit {tol})"
    if layers is not None:
        bad = [x["launches"] for x in runs
               if any(v != layers for v in x["launches"].values())]
        assert not bad, f"{tag}: launches per step {bad}"
    launches = {}
    for x in runs:
        for k, v in x["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"restored_step": r, "published_at_restore": published,
            "unpublished_at_restore":
                back["checkpoints_seen"]["unpublished"],
            "steps_rerun": again, "max_loss_diff": max(diffs),
            "first_attempt_exits": codes,
            "launches": launches, "done": back, "runs": runs,
            "promoted": promo}


def phase_elastic(card, main_path):
    """Phase 8: elastic training of phase 3's GPT-2 medium. (a) relaunch:
    ``run_elastic(np=1, spares=1)`` with ``kill@rank=0,step=4``; (b) an
    in-process reset under ``@elastic.run`` on a new one-rank NCCL world;
    (c) with two cards, two-rank runs with ``kill@rank=1,step=3`` with and
    without a spare against a golden two-rank run."""
    import os
    import shutil
    import tempfile
    import torch
    from horovod_tpu_torch.models import get_model
    steps = len(main_path["losses"])
    kill = 4
    with torch.device("meta"):
        meta = get_model("gpt2_medium", attention="flash")
    n_params = sum(p.numel() for p in meta.parameters())
    layers = meta.cfg.num_layers
    save_bytes = n_params * 4 * 3      # fp32 weights and AdamW's two moments
    keep = 2
    sdir = tempfile.mkdtemp(prefix="chip_smoke_phase8_")
    free = shutil.disk_usage(sdir).free
    log(f"phase 8: {n_params} params, {save_bytes / 1e9:.2f} GB a save; "
        f"{free / 1e9:.1f} GB free under {sdir}")
    if free < (keep + 1) * save_bytes:
        fail(f"phase 8: {free / 1e9:.1f} GB free under {sdir}, a sharded "
             f"checkpoint with max_to_keep={keep} needs "
             f"{(keep + 1) * save_bytes / 1e9:.1f} GB")

    # (a) a SIGKILLed worker replaced by the promoted spare
    restarts, lines, exits, wall = elastic_job(
        sdir, 1, spares=1, plan=f"kill@rank=0,step={kill}", steps=steps)
    try:
        a = check_elastic_job("phase 8 (a)", restarts, lines, exits,
                              main_path["losses"], LOSS_TOL, steps, 1, kill,
                              0, layers=layers)
    except AssertionError as e:
        fail(str(e))
    shutil.rmtree(sdir, ignore_errors=True)
    done, runs = a["done"], a["runs"]
    saves = done["checkpoint_save_seconds"]
    holds = [x["save_hold_s"] for x in runs]
    with_save = [x["step_with_save_s"] * 1e3 for x in runs]
    trained = [x["step_s"] * 1e3 for x in runs]
    split = {
        "promotion_s": done["t_promoted"] - done["failed_at"],
        "init_s": done["t_init"] - done["t_promoted"],
        "build_s": done["t_built"] - done["t_init"],
        "adopt_and_sync_s": done["t_restored"] - done["t_built"],
        "spare_import_s": done["t_imported"] - done["t_start"]}
    ea = {"restarts": restarts, "wall_s": wall,
          "first_attempt_exits": a["first_attempt_exits"],
          "restored_step": a["restored_step"],
          "published_at_restore": a["published_at_restore"],
          "unpublished_at_restore": a["unpublished_at_restore"],
          "steps_rerun": a["steps_rerun"],
          "elastic_recovery_seconds": done["elastic_recovery_seconds"],
          "recovery_split": split,
          "checkpoint_save_seconds_mean": saves["sum"] / saves["count"],
          "checkpoint_restore_seconds":
              done["checkpoint_restore_seconds"]["sum"],
          "bytes_a_save": done["checkpoint_bytes_total"] / saves["count"],
          "save_hold_s": holds, "step_with_save_ms": with_save,
          "step_ms": trained,
          "step_with_save_ms_median": statistics.median(with_save),
          "step_ms_median": statistics.median(trained),
          "phase3_step_ms_median": main_path["step_ms_median"],
          "losses": [(x["attempt"], x["step"], x["loss"]) for x in runs],
          "max_loss_diff": a["max_loss_diff"]}
    log(f"phase 8 (a): kill@rank=0,step={kill} with one spare: {restarts} "
        f"restart (the first attempt's exit codes "
        f"{a['first_attempt_exits']}), the spare (no CUDA context in "
        f"standby) restored step "
        f"{a['restored_step']} (published {a['published_at_restore']}, "
        f"unpublished {a['unpublished_at_restore']}) and re-ran steps "
        f"{a['steps_rerun']}; losses within {a['max_loss_diff']:.3e} of "
        f"phase 3's, {layers} launches of each kernel a step; "
        f"elastic_recovery_seconds {done['elastic_recovery_seconds']:.3f} "
        f"(promotion {split['promotion_s']:.3f}, init {split['init_s']:.3f},"
        f" build {split['build_s']:.3f}, adopt + sync "
        f"{split['adopt_and_sync_s']:.3f} s; the spare's import "
        f"{split['spare_import_s']:.3f} s, paid before the fault); "
        f"checkpoint_save_seconds {ea['checkpoint_save_seconds_mean']:.3f} "
        f"s a save (writer), {ea['bytes_a_save'] / 1e9:.3f} GB a save, "
        f"restore {ea['checkpoint_restore_seconds']:.3f} s; save() held the "
        f"step {', '.join(f'{h:.3f}' for h in holds)} s; step "
        f"{ea['step_ms_median']:.1f} ms median, with the save "
        f"{ea['step_with_save_ms_median']:.1f} ms, against phase 3's "
        f"{main_path['step_ms_median']:.1f} ms; run {wall:.1f} s")

    eb = phase_elastic_reset(card, main_path)

    ec = None
    if torch.cuda.device_count() >= 2:
        ec = two_rank_elastic(steps=steps)
        log(f"phase 8 (c): two ranks, kill@rank=1,step=3: {ec}")
    else:
        log("phase 8 (c): the two-rank elastic runs (kill@rank=1,step=3 "
            "with and without a spare) did not run for want of a second "
            f"card (cards: {torch.cuda.device_count()})")
    return {"relaunch": ea, "reset": eb, "two_rank": ec,
            "launches": {"gpt2_medium_elastic": a["launches"],
                         "gpt2_medium_elastic_reset": eb.pop("launches")}}


def two_rank_elastic(steps=5, model="gpt2_medium", device="cuda"):
    """Phase 8 (c), also run by ``tests/test_torch_port_card.py``: a golden
    two-rank run, then ``kill@rank=1,step=3`` without a spare (the world
    shrinks to one rank and resumes from a manifest written at two) and
    with one (the spare is promoted into rank 1, on GPU 1). One save in
    flight: rank 1 has nothing to write and would otherwise reach the kill
    before rank 0's writer publishes anything; with one, step 1's save
    returns only after step 0 is published."""
    import shutil
    import tempfile
    out = {}
    gdir = tempfile.mkdtemp(prefix="chip_smoke_phase8c_")
    restarts, lines, exits, wall = elastic_job(gdir, 2, steps=steps,
                                               model=model, device=device)
    shutil.rmtree(gdir, ignore_errors=True)
    golden = {x["step"]: x["loss"] for x in lines if "event" not in x}
    assert restarts == 0 and not exits and \
        sorted(golden) == list(range(steps)), \
        f"golden two-rank run: {restarts} restarts, steps {sorted(golden)}"
    want = [golden[s] for s in range(steps)]
    out["golden_losses"] = want
    for spares, world, tol in ((0, 1, SHRINK_LOSS_TOL), (1, 2, LOSS_TOL)):
        d = tempfile.mkdtemp(prefix="chip_smoke_phase8c_")
        restarts, lines, exits, wall = elastic_job(
            d, 2, spares=spares, plan="kill@rank=1,step=3", steps=steps,
            model=model, device=device, max_pending=1)
        shutil.rmtree(d, ignore_errors=True)
        c = check_elastic_job(f"two ranks, {spares} spare(s)", restarts,
                              lines, exits, want, tol, steps, world, 3, 1,
                              promoted=bool(spares))
        out[f"spares_{spares}"] = {
            "world_after": world, "restored_step": c["restored_step"],
            "first_attempt_exits": c["first_attempt_exits"],
            "steps_rerun": c["steps_rerun"],
            "max_loss_diff": c["max_loss_diff"], "tol": tol,
            "elastic_recovery_seconds":
                c["done"]["elastic_recovery_seconds"], "wall_s": wall}
    return out


def phase_elastic_reset(card, main_path):
    """Phase 8 (b): phase 3's GPT-2 medium under ``@elastic.run`` on a new
    one-rank NCCL world, committing every step. A ``DeviceDiscovery`` whose
    probe changes after step 2's commit makes step 3 end in
    ``HostsUpdatedInterrupt`` before its commit: the state rolls back to
    step 2's commit, the NCCL group is re-formed (``init_epoch`` + 1) and
    the run finishes. Every step's loss, step 3's both times, must equal
    phase 3's within ``LOSS_TOL``, with ``num_layers`` launches of each
    kernel a step."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import core, elastic, metrics
    from horovod_tpu_torch.elastic import driver
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    steps = len(main_path["losses"])
    model, opt, loss_of, _ = build_path("gpt2_medium", hvd.device())
    model_layers = model.cfg.num_layers
    state = elastic.TorchState(model=model, optimizer=opt, step=0)
    generation = [0]
    disco = elastic.DeviceDiscovery(
        probe=lambda: [f"cuda:0 generation {generation[0]}"])
    epoch0 = core.init_epoch()
    ran, commits = [], []

    @elastic.run
    def train(state):
        while state.step < steps:
            s = state.step
            before = dict(fa.launches)
            opt.zero_grad()
            loss = loss_of()
            loss.backward()
            opt.step()
            ran.append((s, loss.item(), core.init_epoch(),
                        {k: fa.launches[k] - before[k] for k in fa.KERNELS}))
            if s == 3 and len(ran) == 4:      # step 3's first run
                deadline = time.monotonic() + 30
                while not driver.notification_manager.changed:
                    if time.monotonic() > deadline:
                        fail("phase 8 (b): discovery never saw the change")
                    time.sleep(0.01)
                state.check_host_updates()
            state.step = s + 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state.commit()
            torch.cuda.synchronize()
            commits.append(time.perf_counter() - t0)
            if s == 2:
                generation[0] = 1

    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    train(state, discovery=disco)
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    reset_s = metrics.gauge("elastic_recovery_seconds").value
    epoch1 = core.init_epoch()
    hvd.shutdown()
    del model, opt, state
    torch.cuda.empty_cache()
    order = [s for s, _, _, _ in ran]
    if order != [0, 1, 2, 3, 3, 4] or epoch1 != epoch0 + 1 or \
            [e for *_, e, _ in ran] != [epoch0] * 4 + [epoch1] * 2:
        fail(f"phase 8 (b): steps ran {order} in init epochs "
             f"{[e for *_, e, _ in ran]} ({epoch0} -> {epoch1})")
    diffs = [abs(v - main_path["losses"][s]) for s, v, _, _ in ran]
    if max(diffs) > LOSS_TOL:
        fail(f"phase 8 (b): losses {[(s, v) for s, v, _, _ in ran]} differ "
             f"from phase 3's {main_path['losses']} by up to "
             f"{max(diffs):.3e} (limit {LOSS_TOL})")
    layers = model_layers
    if any(v != layers for *_, grew in ran for v in grew.values()):
        fail(f"phase 8 (b): launches a step {[g for *_, g in ran]}")
    log(f"phase 8 (b): in-process reset after step 2's commit: steps ran "
        f"{order}, init epoch {epoch0} -> {epoch1} (NCCL group re-formed), "
        f"losses within {max(diffs):.3e} of phase 3's, {layers} launches of "
        f"each kernel a step; commit (device copy of the model and AdamW state) "
        f"{statistics.median(commits) * 1e3:.1f} ms median "
        f"({', '.join(f'{c * 1e3:.1f}' for c in commits)}), reset "
        f"{reset_s:.3f} s; run {wall:.1f} s")
    return {"steps_ran": order, "init_epochs": [epoch0, epoch1],
            "losses": [(s, v) for s, v, _, _ in ran],
            "max_loss_diff": max(diffs), "commit_ms": [c * 1e3
                                                       for c in commits],
            "reset_s": reset_s, "wall_s": wall, "launches": launches}


# ---------------------------------------------------------------- phase 9

# The kernels' two new shapes (bf16, 16 heads, d 64, causal): GPT-2 medium
# at 4k tokens (bench.py:527-533) and its packed batch (bench.py:598-616).
NEW_SHAPES = {"gpt2_4k": dict(b=2, t=4096, packed=False),
              "gpt2_packed": dict(b=8, t=1024, packed=True)}
DECODE_ATOL = 0.02      # decode logits against the forward's (the
                        # reference's bound, tests/test_generate.py:96-98)
DECODE_CLEAR_GAP = 0.04  # a greedy token is held where the top two differ
                         # by more


def phase_shape_kernels():
    """(a) The three kernels against their plain versions at NEW_SHAPES,
    then their times, bounds, plain times and SDPA with the same mask:
    {path: {kernel: numbers}}."""
    import torch
    h, d = 16, 64
    out = {}
    for path, c in NEW_SHAPES.items():
        b, t = c["b"], c["t"]
        g = torch.Generator(device="cuda").manual_seed(t + 9)
        q, k, v, do = (torch.randn(b * h, t, d, generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        sg = None
        if c["packed"]:
            sg = torch.tensor(packed_batch(b, t, 50304)[1], device="cuda")
        log(f"path {path}: B {b} H {h} T {t} d {d} bf16 causal, segment "
            f"ids {c['packed']}")
        errs, case, outs = compare_kernels((q, k, v, do, None, sg), b, h, d,
                                           True, 0, BF16_TOL)
        del outs, q, k, v, do
        out[path] = shape_report(case, errs, b, h, t, True)
        del case
        torch.cuda.empty_cache()
    return out


def _dispatched_ops(fn):
    """{aten op: calls} that ``fn()`` dispatches, without autograd."""
    import collections
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] += 1
            return func(*args, **(kwargs or {}))
    with torch.no_grad(), Count() as c:
        fn()
    return c.ops


def check_block_ops(tag, block, args, want_saved, want_bmm):
    """One block's forward on the card: the products the "dots" policy
    saves (``utils.remat.SAVED_OPS``: ``mm`` / ``addmm``, each ``Dense``
    and the MoE dispatch / combine) and the batched ones it recomputes
    (``bmm``: the MoE experts)."""
    import torch
    from horovod_tpu_torch.utils.remat import SAVED_OPS
    ops = _dispatched_ops(lambda: block(*args))
    saved = sum(n for op, n in ops.items() if op in SAVED_OPS)
    bmm = ops.get(torch.ops.aten.bmm.default, 0)
    log(f"{tag} block on the card: {saved} mm/addmm (saved under dots), "
        f"{bmm} bmm (recomputed); {sum(ops.values())} aten ops")
    if (saved, bmm) != (want_saved, want_bmm):
        fail(f"{tag}: a block dispatched {saved} mm/addmm and {bmm} bmm, "
             f"want {want_saved} and {want_bmm}")
    return {"saved": saved, "bmm": bmm}


def phase_remat(card, dev, main_path):
    """(b) GPT-2 medium as phase 3 without remat, under "dots" and under
    "full": phase 3's losses within LOSS_TOL (the run without remat's
    when phase 3 did not run), peak memory full < dots < none, the forward
    kernel launched twice a layer under remat."""
    import torch
    blk = _gpt2_medium(dev).h[0]
    x = torch.randn(8, 1024, 1024, device=dev).to(torch.bfloat16)
    ops = check_block_ops("gpt2_medium", blk, (x,), 4, 0)
    del blk, x
    runs = {}
    for policy in ("none", "dots", "full"):
        extra = {} if policy == "none" else dict(remat=True,
                                                 remat_policy=policy)
        runs[policy] = run = phase_train_path("gpt2_medium", card, dev,
                                              cfg_extra=extra)
        want = (main_path or runs["none"])["losses"]
        diff = max(abs(a - b) for a, b in zip(run["losses"], want))
        log(f"remat {policy}: largest loss difference to phase 3 "
            f"{diff:.3e} (limit {LOSS_TOL:.0e}), peak {run['peak_gib']:.2f}"
            f" GiB, step {run['step_ms_median']:.1f} ms")
        if diff > LOSS_TOL:
            fail(f"remat {policy}: losses differ from phase 3's by {diff}")
    peak = {p: r["peak_gib"] for p, r in runs.items()}
    if not peak["full"] < peak["dots"] < peak["none"]:
        fail(f"peak memory must read full < dots < none, got {peak}")
    return runs, ops


def _tiny_on_card(tag, build, loss_of, dev, pnames):
    """A tiny fp32 model on the card against the same on the CPU: its
    output, aux or loss and the gradients of ``pnames`` (the CPU tests'
    tolerances)."""
    import copy
    cpu = build()
    runs = {}
    for where, model in (("cpu", cpu), ("card", copy.deepcopy(cpu).to(dev))):
        outs = loss_of(model, "cpu" if where == "cpu" else dev)
        outs[-1].backward()
        params = dict(model.named_parameters())
        runs[where] = list(outs) + [params[n].grad for n in pnames]
    log(f"tiny fp32 {tag} on the card against the CPU:")
    names = [f"out{i}" for i in range(len(runs["cpu"]) - len(pnames))]
    for i, name in enumerate(names + [f"{n} grad" for n in pnames]):
        tol = LOGIT_TOL if i < len(names) else GRAD_TOL
        _close(f"{tag} {name}", runs["card"][i], runs["cpu"][i], tol,
               floor=0.0)


def phase_tiny_zoo(dev):
    """Tiny fp32 packed GPT-2 and MoE Llama (8 experts, top-2) on the card
    against the CPU: logits, the loss (with the aux loss), a gradient."""
    import torch
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig
    from horovod_tpu_torch.ops.attention import packed_positions
    tokens, seg = packed_batch(2, 100, 256, seed=3)
    tokens, seg = torch.tensor(tokens), torch.tensor(seg)

    def packed(m, where):
        t, s = tokens.to(where), seg.to(where)
        logits = m(t, segment_ids=s, positions=packed_positions(s))
        return logits, loss_fn(logits, t, segment_ids=s)
    _tiny_on_card("packed GPT-2",
                  lambda: GPT2(GPT2Config.tiny(dtype=torch.float32,
                                               attention="flash")),
                  packed, dev, ["h.0.attn.qkv.weight"])

    def moe(m, where):
        t = tokens.to(where)
        logits, aux = m(t, return_aux=True)
        return logits, aux, loss_fn(logits, t) + 1e-2 * aux.mean()
    _tiny_on_card("MoE Llama",
                  lambda: Llama(LlamaConfig.tiny(
                      dtype=torch.float32, attention="flash", num_experts=8,
                      expert_capacity_factor=1.25)),
                  moe, dev, ["h.0.mlp.moe.w_gate", "h.1.mlp.moe.router.router"])


# Parameters a decode step does not read whole, by config: the lookup
# tables (one row a token; GPT-2's wte is read whole by its tied head), and
# T5's encoder and cross-attention K / V projections (run once).
_NOT_READ_A_STEP = {
    "GPT2Config": ("wpe",),
    "LlamaConfig": ("wte",),
    "T5Config": ("embedding", "enc.", "enc_rel.", "enc_norm.", "dec_rel."),
}


def _decode_bound_ms(model, cache_bytes):
    """(least ms of one decode step, weight bytes it reads): the weights a
    step reads and ``cache_bytes`` of cache, over the HBM rate."""
    skip = _NOT_READ_A_STEP[type(model.cfg).__name__]
    nbytes = sum(p.numel() * p.element_size()
                 for n, p in model.named_parameters()
                 if not n.startswith(skip) and ".cross_attn.k." not in n
                 and ".cross_attn.v." not in n)
    return (nbytes + cache_bytes) / PEAK_HBM_BYTES * 1e3, nbytes


def _check_decode(tag, step, model, tokens, fwd, first, extras=None):
    """Teacher-forces ``tokens`` through the decode step: its logits at
    every position within DECODE_ATOL of the forward's ``fwd``, and each
    token from position ``first`` on equal to ``greedy_token`` of the
    forward wherever its top two logits differ by more than
    DECODE_CLEAR_GAP. ``fwd[:, i]`` are the logits that choose token
    ``i + 1`` (decoder-only) or ``i`` (T5: ``first`` 0)."""
    import torch
    from horovod_tpu_torch.models import generate as G
    cfg = model.cfg
    b, total = tokens.shape
    steps = fwd.shape[1]
    # The forward's length: the softmax then reduces over as many keys.
    cache = G.init_cache(cfg, b, total, device=tokens.device)
    err = torch.zeros((), device=tokens.device)
    inputs = tokens if extras is None else torch.cat(
        [torch.full_like(tokens[:, :1], cfg.pad_id), tokens[:, :-1]], 1)
    for t in range(steps):
        cache, logits = step(model, cache, inputs[:, t], t, extras)
        err = torch.maximum(err, (logits - fwd[:, t]).abs().max())
    err = err.item()
    lo = first - 1 if extras is None else 0
    chosen = fwd[:, lo:steps]
    top2 = chosen.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > DECODE_CLEAR_GAP
    gen = tokens[:, lo + 1:] if extras is None else tokens
    wrong = int(((gen != G.greedy_token(chosen)) & clear).sum().item())
    log(f"{tag} decode: logits max_abs_err {err:.3e} against the dense "
        f"forward at {steps} positions (limit {DECODE_ATOL}); "
        f"{int(clear.sum())} of {clear.numel()} generated tokens clear of a "
        f"near-tie, {wrong} of them differ from the forward's greedy token")
    if not err <= DECODE_ATOL:
        fail(f"{tag}: decode logits differ from the forward's by {err}")
    if wrong:
        fail(f"{tag}: {wrong} generated tokens differ from the forward's "
             "greedy choice")
    return err


def _decode_run(tag, card, model, prompt, new, src=None):
    """Greedy decode through ``generate`` (``t5_generate`` with ``src``):
    tokens/s as ``bench.py:716`` counts them (every decode step, the
    prompt's included), ms a step beside its HBM bound, the aten ops a
    step dispatches, no flash launch; then the check."""
    import torch
    from horovod_tpu_torch.models import generate as G
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    cfg = model.cfg
    b = prompt.shape[0]
    run = ((lambda n: G.t5_generate(model, src, n)) if src is not None
           else (lambda n: G.generate(model, prompt, n)))
    run(4)                                           # warm-up
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    out = run(new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    if any(launches.values()):
        fail(f"{tag} decode launched a flash kernel: {launches}")
    steps = new if src is not None else prompt.shape[1] + new - 1
    step = G.decode_step(cfg)
    fam = G.decode_family(cfg)
    kv_row = (fam.num_layers(cfg) * 2 * fam.kv_heads(cfg)
              * fam.head_dim(cfg) * 2)                 # bytes a position
    extras = None
    if src is not None:
        mask = src != cfg.pad_id
        extras = {"cross": G.t5_encode(model, cfg, src, mask),
                  "src_mask": mask,
                  "dec_bias": G.t5_decoder_bias(cfg, model, new)}
        with torch.no_grad():
            fwd = model(src, torch.cat([torch.full_like(out[:, :1],
                                                        cfg.pad_id),
                                        out[:, :-1]], 1))
        cross = b * src.shape[1] * kv_row
    else:
        with torch.no_grad():
            fwd = model(out)[:, :-1]
        cross = 0
    # The step at position t reads t + 1 cached positions: the mean.
    cache_bytes = b * kv_row * (steps + 1) / 2 + cross
    bound_ms, weight_bytes = _decode_bound_ms(model, cache_bytes)
    tok = torch.zeros(b, dtype=torch.long, device=prompt.device)
    ops = _dispatched_ops(lambda: step(model, G.init_cache(
        cfg, b, 2, device=prompt.device), tok, 0, extras))
    err = _check_decode(tag, step, model, out, fwd,
                        0 if src is not None else prompt.shape[1], extras)
    res = {"tokens_per_s": b * steps / wall, "ms_per_step":
           wall * 1e3 / steps, "steps": steps, "batch": b,
           "bound_ms_per_step": bound_ms, "weight_bytes": weight_bytes,
           "cache_bytes_mean": cache_bytes,
           "aten_ops_per_step": sum(ops.values()),
           "flash_launches_per_step": 0, "max_abs_err": err}
    log(f"{tag} decode on {card}: {res['tokens_per_s']:.1f} tokens/s "
        f"(B {b}, {steps} steps), {res['ms_per_step']:.3f} ms a step "
        f"against an HBM bound of {bound_ms:.4f} ms ({weight_bytes / 1e9:.3f}"
        f" GB of weights, {cache_bytes / 1e9:.3f} GB of cache read a step on"
        f" average) = {bound_ms / res['ms_per_step']:.4f} of the step; "
        f"{res['aten_ops_per_step']} aten ops a step, no flash launch")
    return res


def phase_decode(card, dev, gpt2_new=480):
    """(g) Greedy decode with bf16 parameters: GPT-2 medium (B 8, prompt
    32, ``gpt2_new`` new, ``bench.py:681-723``), Llama-340M (B 4, prompt
    32, 64 new) and ``t5_generate`` on T5-small (B 4, 64 source tokens, 32
    new), each checked against its dense forward."""
    import numpy as np
    import torch
    from horovod_tpu_torch.models import get_model
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    res = {}
    with torch.device(dev):
        model = get_model("gpt2_medium", attention="dense", generator=g)
    model = model.to(torch.bfloat16)
    prompt = torch.tensor(rng.integers(1, model.cfg.vocab_size, (8, 32)),
                          device=dev)
    res["gpt2_medium"] = _decode_run("gpt2_medium", card, model, prompt,
                                     gpt2_new)
    del model
    with torch.device(dev):
        model = get_model("llama", vocab_size=32000, max_seq_len=2048,
                          num_layers=24, num_heads=16, num_kv_heads=4,
                          d_model=1024, d_ff=2816, attention="dense",
                          generator=g)
    model = model.to(torch.bfloat16)
    prompt = torch.tensor(rng.integers(1, model.cfg.vocab_size, (4, 32)),
                          device=dev)
    res["llama_340m"] = _decode_run("llama_340m", card, model, prompt, 64)
    del model
    with torch.device(dev):
        model = get_model("t5_small", generator=g)
    model = model.to(torch.bfloat16)
    src = torch.tensor(rng.integers(1, model.cfg.vocab_size, (4, 64)),
                       device=dev)
    res["t5_small"] = _decode_run("t5_small", card, model, src[:, :1], 32,
                                  src=src)
    torch.cuda.empty_cache()
    return res


def phase_zoo(card, main_path):
    """Phase 9 on a new one-rank NCCL world: returns its report."""
    import torch
    import horovod_tpu_torch as hvd
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    dev = hvd.device()
    t0 = time.perf_counter()
    kernels = phase_shape_kernels()
    remat, remat_ops = phase_remat(card, dev, main_path)
    phase_tiny_zoo(dev)
    trained = {f"gpt2_medium_remat_{p}": r for p, r in remat.items()}
    for name in ("gpt2_long", "gpt2_packed", "llama_moe", "t5_small"):
        if name == "llama_moe":
            from horovod_tpu_torch.models import get_model
            with torch.device(dev):
                blk = get_model(
                    "llama", num_layers=1, num_heads=16, num_kv_heads=4,
                    d_model=1024, d_ff=2816, num_experts=8,
                    moe_router="top2", attention="flash",
                    generator=torch.Generator(device=dev).manual_seed(0)).h[0]
            x = torch.randn(4, 2048, 1024, device=dev).to(torch.bfloat16)
            remat_ops["llama_moe"] = check_block_ops(
                "llama_moe", blk, (x, torch.arange(2048, device=dev)), 7, 3)
            del blk, x
        trained[name] = phase_train_path(name, card, dev)
    decode = phase_decode(card, dev)
    launches = {k: r.pop("launches") for k, r in trained.items()}
    launches["decode"] = {}
    hvd.shutdown()
    torch.cuda.synchronize()
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return {"kernels": kernels, "trained": trained, "block_ops": remat_ops,
            "decode": decode, "launches": launches}


# ---------------------------------------------------------------- phase 10

# (a) The ring's per-hop shape: a GPT-2 medium shard of 4096 tokens; the
# modes of a hop's kernels, mode -> (causal, causal_offset).
RING_HOP = dict(b=2, h=16, t=4096, d=64)
RING_MODES = {"full": (False, 0), "causal": (True, 0), "strict": (True, -1)}
# (b) n virtual ranks of one sequence on one card.
RING_ASSEMBLY = dict(n=4, b=1, h=16, t=16384, d=64)
# The assembled ring against flash_attention over the whole sequence: each
# hop rounds its share of O (of dQ; of dK and dV) to bf16 once before the
# fp32 merge, 2^-9 of that share, and the shares may cancel (a row's dS sums
# to 0 over all keys), so an element may move by 2^-9 of the sum of its
# shares' magnitudes on the ring's side and by as much again on the whole
# sequence's, whose one rounding of the sum is no larger: RING_ROUNDING
# times that sum, on top of BF16_TOL's bound (which keeps its rms share).
# The O so rounded enters delta = rowsum(dO * O): delta_i moves by up to
# e_i = RING_ROUNDING * sum_d |dO_id| * (O's shares' sum)_id, dS_ij by
# P_ij e_i, so dQ_i by scale * e_i * sum_j P_ij |K_j| and dK_j by scale *
# sum_i P_ij e_i |Q_i| (``_ring_slack`` computes both with the kernels).
RING_ROUNDING = 2 ** -8
# (d) GPT-2 medium over two ranks against one card on the same 8192-token
# batch, absolute on every step's loss: the striped ring merges two hops'
# bf16 O where one call rounds once (~2^-9 of an element), which moves a
# mean over 16,382 targets by ~1e-4 and five AdamW steps by a few times
# that; Ulysses runs the same kernel calls as one card.
SP_LOSS_BAND = 1e-3


def planted_shared_ids(case, h, d, causal, offset):
    """The check must catch kernels that read the queries' segment ids for
    the keys': the kernels fed ``seg_q`` as their ``seg_k`` give an O, dQ,
    dK and dV that must fail against the plain versions with the keys' own
    ids."""
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    q, k, v, do, kb, sg, lse, delta, o_p, sk = case
    scale = d ** -0.5
    want = (o_p,
            fa.flash_bwd_dq_plain(q, k, v, kb, sg, sk, do, lse, delta, h,
                                  scale, causal, offset),
            *fa.flash_bwd_dkv_plain(q, k, v, kb, sg, sk, do, lse, delta, h,
                                    scale, causal, offset, want_db=False)[:2])
    got = (fa.flash_fwd(q, k, v, kb, sg, sg, h, scale, causal, offset)[0],
           fa.flash_bwd_dq(q, k, v, kb, sg, sg, do, lse, delta, h, scale,
                           causal, offset),
           *fa.flash_bwd_dkv(q, k, v, kb, sg, sg, do, lse, delta, h, scale,
                             causal, offset, want_db=False)[:2])
    caught = {}
    for name, g, w in zip(("O", "dQ", "dK", "dV"), got, want):
        err, worst, rel, ok = _stats(g, w, BF16_TOL)
        caught[name] = not ok
        log(f"  fault seg_q fed as seg_k: {name} max_abs_err {err:.3e}, max "
            f"err/bound {worst:.3f}, rms err/rms {rel:.3e} -> "
            f"{'caught' if not ok else 'MISSED'}")
    if not (caught["O"] and caught["dQ"] and (caught["dK"] or caught["dV"])):
        fail("the kernel check misses kernels that take the queries' "
             "segment ids for the keys'")


def phase_ring_hops():
    """(a) The three kernels against their plain versions at the ring's hop
    shape in each mode, the home shard's packed ids against the neighbour
    shard's, the backward given an outside lse and delta; the planted
    shared-ids fault; times, bounds and SDPA under the same mask."""
    import torch
    c = RING_HOP
    b, h, t, d = c["b"], c["h"], c["t"], c["d"]
    g = torch.Generator(device="cuda").manual_seed(t + 10)
    q, k, v, do = (torch.randn(b * h, t, d, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    # A packed row of 2t tokens: the home shard holds its second half, the
    # neighbour shard (the block a ring hop brings) its first.
    seg = torch.tensor(packed_batch(b, 2 * t, 50304, seed=10)[1],
                       device="cuda")
    seg_q, seg_k = seg[:, t:].contiguous(), seg[:, :t].contiguous()
    out = {}
    for mode, (causal, offset) in RING_MODES.items():
        log(f"ring hop {mode}: B {b} H {h} t_local {t} d {d} bf16, causal "
            f"{causal} offset {offset}, seg_q != seg_k, outside lse and "
            f"delta")
        errs, case, outs = compare_kernels(
            (q, k, v, do, None, seg_q), b, h, d, causal, offset, BF16_TOL,
            sg_k=seg_k, outside=True)
        del outs
        planted_shared_ids(case, h, d, causal, offset)
        out[f"ring_hop_{mode}"] = shape_report(case, errs, b, h, t, causal,
                                               offset=offset)
        del case
        torch.cuda.empty_cache()
    return out


def _ring_shards(x, n, layout):
    """Rank r's shard of (B, T, ...) ``x`` in ``layout``."""
    t = x.shape[1] // n
    return [(x[:, r::n] if layout == "striped" else x[:, r * t:(r + 1) * t])
            .contiguous() for r in range(n)]


def _ring_assemble(parts, n, layout, b, h):
    """The whole (B, T, H, D) sequence from the ranks' packed shards."""
    import torch
    from horovod_tpu_torch.ops import ring_flash as rf
    shards = [rf._unpack(p, b, h) for p in parts]
    t = shards[0].shape[1]
    out = shards[0].new_empty((b, n * t) + tuple(shards[0].shape[2:]))
    for r, x in enumerate(shards):
        if layout == "striped":
            out[:, r::n] = x
        else:
            out[:, r * t:(r + 1) * t] = x
    return out


def _ring_slack(q, k, v, do, mag_o, causal, key_bias, seg):
    """The delta terms of ``RING_ROUNDING``'s bound over the whole (B, T,
    H, D) sequence: (dQ's, dK's). sum_j P_ij |K_j| is the forward with |K|
    for V; sum_i P_ij x_i is the dV of upstream x."""
    import torch
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    scale = q.shape[-1] ** -0.5
    e = RING_ROUNDING * (do.float().abs() * mag_o).sum(-1, keepdim=True)
    kw = dict(causal=causal, key_bias=key_bias, segment_ids=seg)
    with torch.no_grad():
        pk = fa.flash_attention(q, k, k.abs(), **kw).float()
    vv = v.detach().clone().requires_grad_(True)
    fa.flash_attention(q, k, vv, **kw).backward(
        (e * q.float().abs()).to(q.dtype))
    return scale * e * pk, scale * vv.grad.float()


def _ring_check(name, got, want, mag, slack=None):
    """``got`` against ``want`` within BF16_TOL's bound plus
    ``RING_ROUNDING`` times ``mag``, the sum of the hops' share
    magnitudes, plus ``slack`` (the delta terms); returns the max abs error
    and the max share of the bound."""
    import torch
    g, w = got.float(), want.float()
    rms = w.pow(2).mean().sqrt()
    bound = (BF16_TOL[0] * w.abs() + BF16_TOL[1] * rms
             + RING_ROUNDING * mag.float())
    if slack is not None:
        bound = bound + slack
    err = (g - w).abs()
    worst = (err / bound).max().item()
    rel = (err.pow(2).mean().sqrt() / rms.clamp_min(1e-30)).item()
    log(f"  {name}: max_abs_err {err.max().item():.3e}, max err/bound "
        f"{worst:.3f}, rms err/rms {rel:.3e}, hop shares' sum / |whole| "
        f"{(mag.float().mean() / w.abs().mean().clamp_min(1e-30)).item():.2f}"
        f", delta terms / rms "
        f"{0.0 if slack is None else (slack.mean() / rms).item():.2e}"
        f" (bound: rtol {BF16_TOL[0]:.3e}, atol {BF16_TOL[1]:.0e} rms, "
        f"{RING_ROUNDING:.3e} x the shares' sum, the delta terms; rel rms "
        f"<= {BF16_TOL[2]:.0e})")
    if not (bool(torch.all(err <= bound)) and rel <= BF16_TOL[2]):
        fail(f"{name} disagrees with flash_attention over the whole "
             f"sequence")
    return err.max().item(), worst


def phase_ring_assembly():
    """(b) n virtual ranks of one sequence through ``ring_flash``'s per-hop
    functions on one card, each hop fed the block the ring delivers at that
    hop and the backward's dK/dV summed in the ring's order; the assembled
    O, dQ, dK and dV against ``flash_attention`` over the whole sequence
    (``_ring_check``), and the launches per virtual rank: r + 1 hops on
    rank r under the contiguous causal mask, n otherwise."""
    import torch
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    from horovod_tpu_torch.ops import ring_flash as rf
    c = RING_ASSEMBLY
    n, b, h, T, d = c["n"], c["b"], c["h"], c["t"], c["d"]
    scale = d ** -0.5
    g = torch.Generator(device="cuda").manual_seed(16)
    q, k, v, do = (torch.randn(b, T, h, d, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    key_bias = torch.where(
        torch.rand(b, T, generator=g, device="cuda") > 0.1, 0.0, -1e30)
    seg = torch.tensor(packed_batch(b, T, 50304, seed=16)[1], device="cuda")
    configs = {"contiguous_causal": ("contiguous", True, None, None),
               "striped_causal": ("striped", True, None, None),
               "full_key_mask": ("contiguous", False, key_bias, None),
               "causal_packed": ("contiguous", True, None, seg)}
    report = {}
    for name, (layout, causal, bias, sg) in configs.items():
        t0 = time.perf_counter()
        qq, kk, vv = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))
        o_ref = fa.flash_attention(qq, kk, vv, causal=causal, key_bias=bias,
                                   segment_ids=sg)
        o_ref.backward(do)
        want = {"O": o_ref.detach(), "dQ": qq.grad, "dK": kk.grad,
                "dV": vv.grad}
        del qq, kk, vv, o_ref
        Q, K, V, DO = ([rf._pack(x) for x in _ring_shards(y, n, layout)]
                       for y in (q, k, v, do))
        BI = _ring_shards(bias, n, layout) if bias is not None else [None] * n
        S = _ring_shards(sg, n, layout) if sg is not None else [None] * n
        striped = layout == "striped"
        hops = [{kn: 0 for kn in fa.KERNELS} for _ in range(n)]

        def block(src):
            return K[src], V[src], BI[src], S[src]

        def counted(r, fn):
            before = dict(fa.launches)
            res = fn()
            for kn in fa.KERNELS:
                hops[r][kn] += fa.launches[kn] - before[kn]
            return res
        zeros = [torch.zeros(x.shape, device="cuda") for x in Q]
        o_acc, parts = list(zeros), [[] for _ in range(n)]
        lse = [torch.full(x.shape[:2], -1e30, device="cuda") for x in Q]
        for i in range(n):
            for r in range(n):
                src = (r - i) % n
                hop = counted(r, lambda: rf.fwd_hop(
                    Q[r], block(src), S[r], src, r, h, scale, causal,
                    striped))
                if hop is not None:
                    o_acc[r], lse[r] = rf.safe_merge(o_acc[r], lse[r], *hop)
                    parts[r].append(hop)
        O = [x.to(torch.bfloat16) for x in o_acc]
        # A hop's share of O is exp(lse_hop - lse) O_hop.
        mag = {"O": [sum(torch.exp(lb - lse[r])[..., None] * ob.abs()
                         for ob, lb in parts[r]) for r in range(n)]}
        del parts
        delta = [(DO[r].float() * O[r].float()).sum(-1) for r in range(n)]
        got = {key: [torch.zeros(x.shape, device="cuda") for x in Q]
               for key in ("dQ", "dK", "dV")}
        mag.update({key: [torch.zeros(x.shape, device="cuda") for x in Q]
                    for key in ("dQ", "dK", "dV")})
        # Hop i outside, rank r inside: block src's partial sums grow in
        # the order the ring carries them (ranks src, src + 1, ...).
        for i in range(n):
            for r in range(n):
                src = (r - i) % n
                hop = counted(r, lambda: rf.bwd_hop(
                    Q[r], block(src), S[r], DO[r], lse[r], delta[r], src, r,
                    h, scale, causal, striped))
                if hop is None:
                    continue
                for key, at, part in (("dQ", r, hop[0]), ("dK", src, hop[1]),
                                      ("dV", src, hop[2])):
                    got[key][at] += part
                    mag[key][at] += part.abs()
        got["O"] = O
        log(f"ring assembly {name}: n {n}, B {b} H {h} T {T} (t_local "
            f"{T // n}) d {d} bf16, layout {layout}, causal {causal}, key "
            f"mask {bias is not None}, packed {sg is not None}")
        mag = {key: _ring_assemble(m, n, layout, b, h)
               for key, m in mag.items()}
        slack = dict(zip(("dQ", "dK"), _ring_slack(q, k, v, do, mag["O"],
                                                   causal, bias, sg)))
        errs = {}
        for key in ("O", "dQ", "dK", "dV"):
            whole = _ring_assemble([x.to(torch.bfloat16) for x in got[key]],
                                   n, layout, b, h)
            errs[key] = _ring_check(f"{name} {key}", whole, want[key],
                                    mag[key], slack.get(key))
        skips = not striped and causal
        for r in range(n):
            want_hops = r + 1 if skips else n
            if any(v != want_hops for v in hops[r].values()):
                fail(f"ring assembly {name}: virtual rank {r} launched "
                     f"{hops[r]}, want {want_hops} of each kernel")
        log(f"  launches per virtual rank (K1, K2, K3 each): "
            f"{[hops[r]['flash_fwd'] for r in range(n)]}; "
            f"{time.perf_counter() - t0:.1f} s")
        report[name] = {"max_abs_err": {k: e for k, (e, _) in errs.items()},
                        "max_share_of_bound": {k: w for k, (_, w)
                                               in errs.items()},
                        "hops_per_rank": [hops[r]["flash_fwd"]
                                          for r in range(n)]}
        del Q, K, V, DO, got, want, O, o_acc, lse, delta, mag, slack
        torch.cuda.empty_cache()
    return report


# (c) GPT-2 medium at 4096 tokens under sequence parallelism on one rank.
SP_RUNS = {"ring_contiguous": dict(sp_impl="ring", ring_layout="contiguous"),
           "ring_striped": dict(sp_impl="ring", ring_layout="striped"),
           "ulysses": dict(sp_impl="ulysses", ring_layout="contiguous")}


def phase_sp_gpt2(card, dev, long_run):
    """(c) ``gpt2_long`` with ``use_ring_attention=True`` under the
    contiguous ring, the striped ring (``striped_lm_loss``) and Ulysses:
    phase 9 (c)'s losses within ``LOSS_TOL`` (its run, or one of its own
    when phase 9 did not run), 48 / 24 / 24 launches a step."""
    if long_run is None:
        log("phase 10 (c): phase 9 did not run: gpt2_long without sequence "
            "parallelism first")
        long_run = phase_train_path("gpt2_long", card, dev)
        long_run.pop("launches")
    out = {}
    for tag, extra in SP_RUNS.items():
        log(f"phase 10 (c): gpt2_long, use_ring_attention=True, {extra}")
        r = phase_train_path("gpt2_long", card, dev,
                             cfg_extra=dict(use_ring_attention=True, **extra))
        diffs = [abs(a - w) for a, w in zip(r["losses"], long_run["losses"])]
        if max(diffs) > LOSS_TOL:
            fail(f"phase 10 (c) {tag}: losses {r['losses']} differ from "
                 f"phase 9 (c)'s {long_run['losses']} by up to "
                 f"{max(diffs):.3e} (limit {LOSS_TOL})")
        r["max_loss_diff"] = max(diffs)
        r["bit_for_bit"] = r["losses"] == long_run["losses"]
        log(f"phase 10 (c) {tag} on {card}: losses within {max(diffs):.3e} "
            f"of phase 9 (c)'s (bit for bit: {r['bit_for_bit']}); "
            f"{r['step_ms_median']:.1f} ms a step against "
            f"{long_run['step_ms_median']:.1f}, "
            f"{r['tokens_per_s']:.1f} tokens/s against "
            f"{long_run['tokens_per_s']:.1f}, peak {r['peak_gib']:.2f} GiB "
            f"against {long_run['peak_gib']:.2f}")
        out[f"gpt2_long_sp_{tag}"] = r
    return out


def phase_sp_two_cards():
    """(d) With two cards: ``tools/torch_ring_bench.py --np 2`` trains
    GPT-2 medium at T_global 8192 striped and Ulysses against one card
    (``SP_LOSS_BAND``) and times a hop's exchange against its kernels."""
    import torch
    if torch.cuda.device_count() < 2:
        log("phase 10 (d): GPT-2 medium sequence-parallel over a two-rank "
            "NCCL world (T_global 8192, striped and Ulysses, against one "
            "card) and the per-hop exchange against the hop's kernels did "
            "not run for want of a second card")
        return None
    out = {}
    for mode in ("gpt2", "hop"):
        r = subprocess.run(
            [sys.executable, "tools/torch_ring_bench.py", "--np", "2",
             "--mode", mode, "--band", str(SP_LOSS_BAND)],
            capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            fail(f"phase 10 (d): torch_ring_bench.py --mode {mode} failed "
                 f"({r.returncode}):\n{r.stdout[-2000:]}\n"
                 f"{r.stderr[-3000:]}")
        out[mode] = json.loads(r.stdout.strip().splitlines()[-1])
        log(f"phase 10 (d) {mode}: {json.dumps(out[mode])}")
    return out


def phase_long_context(card, long_run):
    """Phase 10 on a new one-rank NCCL world: returns its report."""
    import torch
    import horovod_tpu_torch as hvd
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    dev = hvd.device()
    t0 = time.perf_counter()
    kernels = phase_ring_hops()
    assembly = phase_ring_assembly()
    trained = phase_sp_gpt2(card, dev, long_run)
    launches = {k: r.pop("launches") for k, r in trained.items()}
    hvd.shutdown()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    two = phase_sp_two_cards()
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return {"kernels": kernels, "assembly": assembly, "trained": trained,
            "two_cards": two, "launches": launches}


# ---------------------------------------------------------------- phase 11

# Absolute band between phase 3's losses (``torch.optim.AdamW``) and
# ZeRO-1's (``sharded_adamw``, the reference's form of AdamW) on the same
# batches, at every step. The two forms are equal in exact arithmetic: torch
# decays the parameter first and divides by sqrt(v)/sqrt(1 - b2^t) + eps,
# the reference adds lr * wd * p to the step and divides by
# sqrt(v / (1 - b2^t)) + eps. They round differently: about one fp32 ulp of
# each parameter a step (~1e-9 at GPT-2's ~0.02 weights), which moves a
# bf16 weight of the forward only where it sits that close to a bf16
# rounding boundary, a few thousand of 355M a step. Step 0's loss precedes
# any update and is equal. The band lies between two readings on an NVIDIA
# H100 80GB HBM3 at 700 W (``PERF.md`` §6): the sound runs' largest gap,
# 1.268e-04 on one card and 1.945e-04 on two (``tools/torch_zero_bench.py``),
# and the gap of (b)'s planted fault, mu's bias correction dropped, 0.382.
# 1e-3 is five times the first and 1/382 of the second; (b) fails if the
# planted run stays inside it. Moments put on the wrong elements are caught
# first, by (b)'s check of mu and nu against AdamW's ``exp_avg`` and
# ``exp_avg_sq``. Weight decay is below any loss band here: lr * wd * p is
# ~2e-10 a step at GPT-2's ~0.02 weights, a tenth of their fp32 ulp.
ZERO1_LOSS_BAND = 1e-3
# (d) resumes from the checkpoint written before this step.
ZERO1_CKPT_STEP = 3


def _planted_chunk_update(g, state, p, learning_rate, b1, b2, eps,
                          weight_decay):
    """``optimizer_sharded._adamw_chunk_update`` with one planted fault:
    the first moment's bias correction dropped (mu_hat = mu), which makes
    step 1's update ten times smaller."""
    import torch
    step = state.step + 1
    stepf = step.to(torch.float32)[0]
    mu = b1 * state.mu + (1 - b1) * g
    nu = b2 * state.nu + (1 - b2) * torch.square(g)
    nu_hat = nu / (1 - b2 ** stepf)
    upd = -learning_rate * (mu / (torch.sqrt(nu_hat) + eps)
                            + weight_decay * p)
    return upd, (step, mu, nu)


def _functional_gpt2(dev):
    """Phase 3's GPT-2 medium as a function of its parameters: (model, its
    parameters by name in registration order, the loss ``f(params,
    tokens)`` over ``torch.func.functional_call``, and ``batch(step)``:
    phase 3's rows through a ``ShardedBatchIterator`` of this rank, shuffle
    off, one epoch a step)."""
    import torch
    from torch.func import functional_call
    from horovod_tpu_torch.data import ShardedBatchIterator
    from horovod_tpu_torch.models.gpt2 import loss_fn
    model = _gpt2_medium(dev)
    tokens = torch.randint(0, model.cfg.vocab_size, (8, 1024),
                           generator=torch.Generator().manual_seed(0))
    it = ShardedBatchIterator([tokens.numpy()], 8, shuffle=False)
    if len(it) != 1:
        fail(f"phase 11: {len(it)} batches an epoch, not one")

    def batch(step):
        it.set_epoch(step)
        (rows,), mask = next(iter(it))
        if not mask.all() or not torch.equal(torch.from_numpy(rows), tokens):
            fail("phase 11: the iterator's batch is not phase 3's")
        return torch.from_numpy(rows).to(dev)

    def f(p, t):
        return loss_fn(functional_call(model, p, (t,)), t)

    return model, dict(model.named_parameters()), f, batch


def _phase11_steps(tag, steps, step_fn, layers, pre=None, phase=11,
                   first=0):
    """Runs ``step_fn(i) -> loss`` for ``steps`` steps (i from ``first``),
    each timed on the wall clock behind ``torch.cuda.synchronize()``
    (``pre(i)`` runs untimed before step i); every kernel must launch
    ``layers`` times a step (a number, or a count per kernel), counted
    from 0 just before the run."""
    import torch
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    want = layers if isinstance(layers, dict) else {k: layers
                                                     for k in fa.KERNELS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, wall = [], []
    for i in range(first, first + steps):
        if pre is not None:
            pre(i)
        before = dict(fa.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step_fn(i)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.item()))
        grew = {k: fa.launches[k] - before[k] for k in fa.KERNELS}
        log(f"phase {phase} {tag} step {i}: loss {losses[-1]:.6f}  "
            f"{wall[-1]:.1f} ms  launches {grew}")
        if grew != want:
            fail(f"phase {phase} {tag}: the kernels must launch {want} a "
                 f"step, got {grew}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"phase {phase} {tag}: non-finite loss: {losses}")
    return {"losses": losses, "wall_ms": wall,
            "step_ms_median": statistics.median(wall[1:] or wall),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": dict(fa.launches)}


def _flat_moments(opt, params, names):
    """AdamW's ``exp_avg`` and ``exp_avg_sq`` flattened in ``names``'
    order, in host memory (so they do not count in the card's peak)."""
    import torch
    return [torch.cat([opt.state[params[k]][m].reshape(-1).cpu()
                       for k in names])
            for m in ("exp_avg", "exp_avg_sq")]


def _loss_diffs(tag, losses, want, tol):
    diffs = [abs(a - b) for a, b in zip(losses, want)]
    if len(diffs) != len(want) or max(diffs) > tol:
        fail(f"phase 11 {tag}: losses {losses} differ from phase 3's {want} "
             f"by up to {max(diffs):.3e} (limit {tol})")
    return max(diffs)


def phase_functional_step(card, main_path):
    """Phase 11 on a new one-rank NCCL world: phase 3's GPT-2 medium through
    (a) ``hvd.value_and_grad`` + ``torch.optim.AdamW`` and ``grad(overlap=
    True)``, (b) ZeRO-1, (c) ``AutotunedStep``, (d) a ZeRO-1 checkpoint and
    (e) ``tools/torch_zero_bench.py --np 2`` with two cards."""
    import os
    import shutil
    import tempfile
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint_sharded as cs
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.autotune import BayesianAutotuner
    from horovod_tpu_torch.elastic import TensorState
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    dev = hvd.device()
    if main_path is None:
        main_path = phase_train_path("gpt2_medium", card, dev)
    want = main_path["losses"]
    steps = len(want)
    adamw_kw = dict(lr=1e-4, weight_decay=1e-4, eps=1e-8)
    out, launches = {}, {}

    # (a) value_and_grad over functional_call, then plain AdamW.
    model, params, f, batch = _functional_gpt2(dev)
    layers = model.cfg.num_layers
    names = sorted(params)
    n_params = sum(p.numel() for p in params.values())
    adamw = torch.optim.AdamW(model.parameters(), **adamw_kw)
    vg = hvd.value_and_grad(f)
    ref = {}

    def step_a(i):
        v, g = vg(params, batch(i))
        for k, p in params.items():
            p.grad = g[k]
        adamw.step()
        if i == 0:
            ref["sorted"] = _flat_moments(adamw, params, names)
            ref["registered"] = _flat_moments(adamw, params, list(params))
        return v

    snap0 = metrics.snapshot()
    a = _phase11_steps("(a)", steps, step_a, layers)
    snap1 = metrics.snapshot()
    a["max_loss_diff"] = _loss_diffs("(a)", a["losses"], want, LOSS_TOL)
    calls = {k: _counter(snap1, "collective_" + k + "_total",
                         kind="allreduce")
             - _counter(snap0, "collective_" + k + "_total",
                        kind="allreduce") for k in ("calls", "traced")}
    if calls != {"calls": steps, "traced": steps}:
        fail(f"phase 11 (a): value_and_grad issued {calls}, not one eager "
             f"allreduce (gradients) and one in-step (the value) a step")
    log(f"phase 11 (a): value_and_grad + AdamW: losses within "
        f"{a['max_loss_diff']:.3e} of phase 3's; {a['step_ms_median']:.1f} "
        f"ms a step against phase 3's {main_path['step_ms_median']:.1f}, "
        f"peak {a['peak_gib']:.2f} GiB; allreduces {calls}")
    launches["gpt2_medium_value_and_grad"] = a.pop("launches")
    del model, params, adamw
    torch.cuda.empty_cache()

    model, params, f, batch = _functional_gpt2(dev)
    adamw = torch.optim.AdamW(model.parameters(), **adamw_kw)

    def f_aux(p, t):
        v = f(p, t)
        return v, v.detach()
    gfn = hvd.grad(f_aux, overlap=True, has_aux=True)
    rounds = []

    def step_ov(i):
        n0 = sum(hvd.negotiation_stats().values())
        g, v = gfn(params, batch(i))
        rounds.append(sum(hvd.negotiation_stats().values()) - n0)
        for k, p in params.items():
            p.grad = g[k]
        adamw.step()
        return v

    snap0 = metrics.snapshot()
    ov = _phase11_steps("(a) overlap", steps, step_ov, layers)
    snap1 = metrics.snapshot()
    ov["max_loss_diff"] = _loss_diffs("(a) overlap", ov["losses"], want,
                                      LOSS_TOL)
    calls = {k: _counter(snap1, "collective_" + k + "_total",
                         kind="allreduce")
             - _counter(snap0, "collective_" + k + "_total",
                        kind="allreduce") for k in ("calls", "traced")}
    # One tap a bucket: the parameters in registration order, cut greedily
    # at the fusion threshold.
    from horovod_tpu_torch.config import get_config
    threshold = get_config().fusion_threshold_bytes
    taps, size = 1, 0
    for p in params.values():
        if size and size + p.numel() * p.element_size() > threshold:
            taps, size = taps + 1, 0
        size += p.numel() * p.element_size()
    if calls != {"calls": 0, "traced": steps * taps} or any(rounds):
        fail(f"phase 11 (a): grad(overlap=True) issued {calls} and took "
             f"rounds {rounds}: the taps must be {taps} in-step "
             f"allreduces a step and nothing eager")
    ov["taps"] = taps
    log(f"phase 11 (a): grad(overlap=True) + AdamW: losses within "
        f"{ov['max_loss_diff']:.3e} of phase 3's, {taps} taps a step of at "
        f"most {threshold} bytes for {len(params)} tensors ({calls}), "
        f"negotiation rounds {rounds}; "
        f"{ov['step_ms_median']:.1f} ms a step, peak {ov['peak_gib']:.2f} "
        f"GiB")
    launches["gpt2_medium_grad_overlap"] = ov.pop("launches")
    del model, params, adamw
    torch.cuda.empty_cache()

    # (b) ZeRO-1, with (d)'s checkpoint written before ZERO1_CKPT_STEP.
    model, params, f, batch = _functional_gpt2(dev)
    opt = hvd.sharded_adamw(1e-4, weight_decay=1e-4, eps=1e-8)
    st = {"opt": opt.init(params)}
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_phase11_")
    mgr = cs.ShardedCheckpointManager(ckpt_dir)
    saved = {}

    def save(i):
        if i != ZERO1_CKPT_STEP:
            return
        ts = TensorState(params={k: p.detach() for k, p in params.items()},
                         opt_state=st["opt"])
        t0 = time.perf_counter()
        cs.save_state(mgr, i, ts, wait=True)
        saved["seconds"] = time.perf_counter() - t0
        saved["commit"] = ts._saved_pytrees

    def step_b(i):
        v, g = vg(params, batch(i))
        upd, st["opt"] = opt.update(g, st["opt"], params)
        with torch.no_grad():
            torch._foreach_add_([params[k] for k in names],
                                [upd[k] for k in names])
        if i == 0:
            row = st["opt"]
            if row.mu.numel() != n_params or row.step.tolist() != [1]:
                fail(f"phase 11 (b): one rank's row holds "
                     f"{row.mu.numel()} of {n_params} elements, step "
                     f"{row.step.tolist()}")
            mu, nu = row.mu.cpu(), row.nu.cpu()
            saved["mu_err"] = _check("phase 11 (b) mu after step 1",
                                     mu, ref["sorted"][0], F32_TOL,
                                     "AdamW's exp_avg (sorted leaf order)")
            saved["nu_err"] = _check("phase 11 (b) nu after step 1",
                                     nu, ref["sorted"][1], F32_TOL,
                                     "AdamW's exp_avg_sq")
            if _stats(mu, ref["registered"][0], F32_TOL)[3]:
                fail("phase 11 (b): mu also matches exp_avg in registration "
                     "order: the check cannot see the leaf order")
            ref.clear()
        return v

    b = _phase11_steps("(b) ZeRO-1", steps, step_b, layers, pre=save)
    diffs = [abs(x - y) for x, y in zip(b["losses"], want)]
    if max(diffs) > ZERO1_LOSS_BAND:
        fail(f"phase 11 (b): ZeRO-1 losses {b['losses']} leave the band "
             f"{ZERO1_LOSS_BAND} around phase 3's {want}")
    row = st["opt"]
    b.update(max_loss_diff=max(diffs), loss_diffs=diffs,
             moment_bytes=2 * row.mu.numel() * row.mu.element_size(),
             adamw_moment_bytes=2 * n_params * 4, mu_err=saved["mu_err"],
             nu_err=saved["nu_err"])
    log(f"phase 11 (b): ZeRO-1 (sharded_adamw): losses {b['losses']}, at "
        f"most {max(diffs):.3e} from phase 3's (band {ZERO1_LOSS_BAND}); "
        f"moments {b['moment_bytes'] / 2 ** 30:.3f} GiB on this rank (AdamW "
        f"{b['adamw_moment_bytes'] / 2 ** 30:.3f} GiB); "
        f"{b['step_ms_median']:.1f} ms a step against (a)'s "
        f"{a['step_ms_median']:.1f}, peak {b['peak_gib']:.2f} GiB against "
        f"(a)'s {a['peak_gib']:.2f}")
    launches["gpt2_medium_zero1"] = b.pop("launches")
    del model, params, opt, st
    torch.cuda.empty_cache()

    # (b) planted: the same steps with one fault in the update, which the
    # band must reject.
    from horovod_tpu_torch import optimizer_sharded as S
    model, params, f, batch = _functional_gpt2(dev)
    opt = hvd.sharded_adamw(1e-4, weight_decay=1e-4, eps=1e-8)
    st = {"opt": opt.init(params)}
    def step_p(i):
        v, g = vg(params, batch(i))
        upd, st["opt"] = opt.update(g, st["opt"], params)
        with torch.no_grad():
            torch._foreach_add_([params[k] for k in names],
                                [upd[k] for k in names])
        return v

    real_update = S._adamw_chunk_update
    S._adamw_chunk_update = _planted_chunk_update
    try:
        planted = _phase11_steps("(b) planted fault", steps, step_p, layers)
    finally:
        S._adamw_chunk_update = real_update
    gaps = [abs(x - y) for x, y in zip(planted["losses"], want)]
    if not max(gaps) > ZERO1_LOSS_BAND:
        fail(f"phase 11 (b): ZeRO-1 with mu's bias correction dropped stays "
             f"within {max(gaps):.3e} of phase 3's losses, inside the band "
             f"{ZERO1_LOSS_BAND}: the band cannot see a wrong update")
    b.update(planted_loss_diffs=gaps, planted_max_loss_diff=max(gaps))
    log(f"phase 11 (b): planted fault (no bias correction of mu): losses "
        f"{planted['losses']}, up to {max(gaps):.3e} from phase 3's, "
        f"outside the band {ZERO1_LOSS_BAND} (the sound run's "
        f"{b['max_loss_diff']:.3e})")
    del model, params, opt, st
    torch.cuda.empty_cache()

    # (d) the checkpoint adopted into a fresh state, then the next step.
    model, params, f, batch = _functional_gpt2(dev)
    opt = hvd.sharded_adamw(1e-4, weight_decay=1e-4, eps=1e-8)
    fresh = TensorState(params={k: p.detach() for k, p in params.items()},
                        opt_state=opt.init(params))
    t0 = time.perf_counter()
    got_step = cs.adopt_state(mgr, fresh)
    adopt_s = time.perf_counter() - t0
    mgr.close()
    commit = saved["commit"]
    for fld in ("step", "mu", "nu"):
        x, y = getattr(fresh.opt_state, fld), getattr(commit["opt_state"],
                                                      fld)
        if x.device != dev or x.dtype != y.dtype or \
                not torch.equal(x.cpu(), y):
            fail(f"phase 11 (d): the adopted {fld} is not the saved one "
                 f"bit for bit")
    if got_step != ZERO1_CKPT_STEP or any(
            not torch.equal(fresh.params[k].cpu(), commit["params"][k])
            for k in names):
        fail(f"phase 11 (d): adopted step {got_step} or its parameters "
             f"differ from the save")
    del commit, saved["commit"]
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    rs = {"opt": fresh.opt_state}

    def step_d(i):
        v, g = vg(fresh.params, batch(ZERO1_CKPT_STEP + i))
        upd, rs["opt"] = opt.update(g, rs["opt"], fresh.params)
        with torch.no_grad():
            torch._foreach_add_([fresh.params[k] for k in names],
                                [upd[k] for k in names])
        return v

    d = _phase11_steps("(d) resumed", 1, step_d, layers)
    if d["losses"][0] != b["losses"][ZERO1_CKPT_STEP]:
        fail(f"phase 11 (d): the resumed step's loss {d['losses'][0]!r} is "
             f"not the uninterrupted run's "
             f"{b['losses'][ZERO1_CKPT_STEP]!r}")
    d.update(save_s=saved["seconds"], adopt_s=adopt_s, step=got_step)
    log(f"phase 11 (d): ZeRO-1 checkpoint before step {ZERO1_CKPT_STEP}: "
        f"save {saved['seconds']:.2f} s, adopt {adopt_s:.2f} s; step, mu, "
        f"nu and the parameters bit for bit; the resumed step's loss "
        f"{d['losses'][0]!r} equals the uninterrupted run's")
    launches["gpt2_medium_zero1_resumed"] = d.pop("launches")
    del model, params, fresh, rs
    torch.cuda.empty_cache()

    # (c) AutotunedStep over (a)'s step, the allreduce at the tuner's
    # threshold.
    model, params, f, batch = _functional_gpt2(dev)
    adamw = torch.optim.AdamW(model.parameters(), **adamw_kw)
    builds = []

    def make_step(threshold):
        builds.append(int(threshold))

        def step(i):
            xs = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
            v = f(xs, batch(i))
            gs = [g.contiguous() for g in torch.autograd.grad(
                v, list(xs.values()))]
            hvd.allreduce_gradients(gs, fusion_threshold_bytes=threshold)
            for p, g in zip(params.values(), gs):
                p.grad = g
            adamw.step()
            return v.detach()
        return step

    probes, samples = 2, 2
    tuned = hvd.AutotunedStep(make_step, BayesianAutotuner(
        probes=probes, samples_per_probe=samples))
    h0 = metrics.snapshot()["histograms"].get(
        "optimizer_step_latency_seconds", [{"count": 0}])[0]["count"]
    calls_c = 1 + probes * (1 + samples)
    c = _phase11_steps("(c) AutotunedStep", calls_c, tuned, layers)
    snap = metrics.snapshot()
    h1 = snap["histograms"]["optimizer_step_latency_seconds"][0]["count"]
    gauge = snap["gauges"]["optimizer_step_seconds"][0]["value"]
    if not tuned.converged or len(builds) != 1 + probes or \
            h1 - h0 != probes * samples or not gauge > 0 or \
            not c["losses"][-1] < c["losses"][0]:
        fail(f"phase 11 (c): converged {tuned.converged}, builds {builds} "
             f"(want {1 + probes}), histogram +{h1 - h0} (want "
             f"{probes * samples}), gauge {gauge}, losses {c['losses']}")
    c.update(builds=builds, best_threshold=tuned.current_threshold(),
             gauge_s=gauge, timed=h1 - h0)
    log(f"phase 11 (c): AutotunedStep, {probes} probes of {samples} "
        f"samples: thresholds built {builds}, converged on "
        f"{tuned.current_threshold()}; optimizer_step_seconds {gauge:.4f}, "
        f"{h1 - h0} steps timed; losses {c['losses']}")
    launches["gpt2_medium_autotuned"] = c.pop("launches")
    del model, params, adamw, tuned
    torch.cuda.empty_cache()
    hvd.shutdown()
    torch.cuda.synchronize()

    e = None
    if torch.cuda.device_count() >= 2:
        proc = subprocess.run(
            [sys.executable, "tools/torch_zero_bench.py", "--np", "2",
             "--band", str(ZERO1_LOSS_BAND)],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            fail(f"phase 11 (e): the two-rank ZeRO-1 bench failed:\n"
                 f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
        e = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"phase 11 (e): two ranks: losses within "
            f"{e['max_loss_diff']:.3e} of one rank's, checks {e['checks']}; "
            f"per rank: " + "; ".join(
                f"rank {x['rank']} {x['step_ms']:.1f} ms a step, peak "
                f"{x['peak_gib']:.2f} GiB, mu {x['mu_elements']} elements"
                for x in e["per_rank"]) +
            f"; one rank {e['one_rank']['step_ms']:.1f} ms, peak "
            f"{e['one_rank']['peak_gib']:.2f} GiB")
    else:
        log("phase 11 (e): tools/torch_zero_bench.py --np 2 did not run for "
            f"want of a second card (cards: {torch.cuda.device_count()})")
    out.update(value_and_grad=a, grad_overlap=ov, zero1=b, resumed=d,
               autotuned=c, two_cards=e, zero1_loss_band=ZERO1_LOSS_BAND,
               phase3_step_ms_median=main_path["step_ms_median"],
               launches=launches)
    return out

# ---------------------------------------------------------------- phase 12



def _fsdp_launches(layers):
    """Launches a step of each kernel on the FSDP paths: the block runs
    twice a step (the backward gathers again and recomputes it, as remat
    "full")."""
    return {"flash_fwd": 2 * layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers}

# (d) commits after this many steps, runs two more, restores, reruns them.
FSDP_COMMIT_STEP = 3


def _fsdp_gpt2(dev, wire=None, process_set=None, build=None):
    """Phase 3's GPT-2 medium (or ``build(dev)``'s model) with its blocks
    stored as this rank's ``stack_layer_shards`` rows on the card and the
    rest (``wte``, ``wpe``, ``ln_f``) replicated. Returns ``(rows, rest,
    template, loss)``: ``loss(rows, rest, tokens)`` runs the model as
    ``GPT2.forward`` does, the blocks through ``fsdp_scan_blocks`` (or
    ``zero3_apply`` on ``wire``, one a layer) over meta-device modules
    whose parameters ``functional_call`` supplies."""
    import torch
    from torch.func import functional_call
    from horovod_tpu_torch.models.gpt2 import Block, LayerNorm, loss_fn
    from horovod_tpu_torch.parallel import fsdp, mp
    model = (build or _gpt2_medium)(dev)
    cfg = model.cfg
    blocks = [dict(b.named_parameters()) for b in model.h]
    with torch.no_grad():
        stacked = {k: torch.stack([b[k] for b in blocks])
                   for k in sorted(blocks[0])}
        rows = fsdp.stack_layer_shards(stacked, process_set=process_set)
        del stacked
    rest = {k: p.detach().clone() for k, p in model.named_parameters()
            if not k.startswith("h.")}
    template = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in blocks[0].items()}
    del model, blocks
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    with torch.device("meta"):
        block, ln_f = Block(cfg), LayerNorm(cfg.d_model, cfg.ln_eps)
    block_fn = fsdp.module_block_fn(block)

    def loss(rows, rest, tokens):
        t = tokens.shape[1]
        x = (rest["wte"][tokens].to(cfg.dtype)
             + rest["wpe"][torch.arange(t, device=tokens.device)]
             .to(cfg.dtype))
        if wire is None:
            x = fsdp.fsdp_scan_blocks(block_fn, template, rows, x,
                                      process_set)
        else:
            for row in rows.unbind(0):
                x = mp.zero3_apply(block_fn, template, row, x, process_set,
                                   wire)
        x = functional_call(ln_f, {"weight": rest["ln_f.weight"],
                                   "bias": rest["ln_f.bias"]}, (x,))
        logits = torch.einsum("btd,vd->btv", x.float(), rest["wte"].float())
        return loss_fn(logits, tokens)
    return rows, rest, template, loss


def _fsdp_trainer(dev, wire=None, process_set=None, build=None):
    """(state, step): ``step(i, tokens)`` takes one AdamW step (lr 1e-4,
    weight decay 1e-4, eps 1e-8) of :func:`_fsdp_gpt2`'s model: the rows
    through ``fsdp_adamw`` (their gradient is already the data-parallel
    mean), the replicated rest through ``sharded_adamw``. ``state`` holds
    the rows, the rest and both optimizer states."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import fsdp
    rows, rest, template, loss = _fsdp_gpt2(dev, wire, process_set, build)
    kw = dict(weight_decay=1e-4, eps=1e-8)
    fopt = fsdp.fsdp_adamw(1e-4, **kw)
    zopt = hvd.sharded_adamw(1e-4, process_set=process_set, **kw)
    st = {"rows": rows, "rest": rest, "f": fopt.init(rows),
          "z": zopt.init(rest), "template": template,
          "layers": rows.shape[0]}

    def step(tokens):
        rows_ = st["rows"].requires_grad_()
        rest_ = {k: v.requires_grad_() for k, v in st["rest"].items()}
        value = loss(rows_, rest_, tokens)
        g_rows, *g_rest = torch.autograd.grad(
            value, [rows_] + list(rest_.values()))
        with torch.no_grad():
            upd, st["f"] = fopt.update(g_rows, st["f"], rows_)
            rows_.add_(upd)
            del upd, g_rows
            upd, st["z"] = zopt.update(dict(zip(rest_, g_rest)), st["z"],
                                       rest_)
            for k, v in rest_.items():
                v.add_(upd[k])
        return value.detach()
    return st, step


def _gap(losses, want):
    return max(abs(a - b) for a, b in zip(losses, want))


def phase_fsdp(card, main_path, zero1, remat_full=None):
    """Phase 12 on a new one-rank NCCL world: FSDP / ZeRO-3, ZeRO-3 on the
    bf16 and int8 wires, ZeRO-2 and ``FsdpState`` on phase 3's GPT-2
    medium, and (e) ``tools/torch_zero_bench.py --stage 3`` on more
    cards."""
    import os
    import tempfile
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.elastic import FsdpState, TensorState
    from horovod_tpu_torch.ops.quantized import quantize_blocks
    from horovod_tpu_torch.parallel import mp
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    dev = hvd.device()
    if main_path is None:
        main_path = phase_train_path("gpt2_medium", card, dev)
    want = main_path["losses"]
    steps = len(want)
    _, _, _, batch = _functional_gpt2(dev)
    out, launches = {}, {}

    def traced(snap, kind):
        return _counter(snap, "collective_traced_total", kind=kind)

    # (a) FSDP / ZeRO-3: the blocks as rows, gathered a layer at a time.
    st, step = _fsdp_trainer(dev)
    layers = st["layers"]
    fsdp_launches = _fsdp_launches(layers)
    rows_bytes = st["rows"].numel() * st["rows"].element_size()
    snap0, r0 = metrics.snapshot(), sum(hvd.negotiation_stats().values())
    a = _phase11_steps("(a) FSDP", steps, lambda i: step(batch(i)),
                       fsdp_launches, phase=12)
    snap1, r1 = metrics.snapshot(), sum(hvd.negotiation_stats().values())
    colls = {k: traced(snap1, k) - traced(snap0, k)
             for k in ("allgather", "reducescatter")}
    if colls != {"allgather": 2 * layers * steps,
                 "reducescatter": layers * steps} or r1 != r0:
        fail(f"phase 12 (a): in-step collectives {colls} and {r1 - r0} "
             f"negotiation rounds over {steps} steps; want {2 * layers} "
             f"all-gathers and {layers} reduce-scatters a step and no "
             f"round")
    a["max_loss_diff"] = _gap(a["losses"], want)
    if a["max_loss_diff"] > ZERO1_LOSS_BAND:
        fail(f"phase 12 (a): FSDP losses {a['losses']} leave the band "
             f"{ZERO1_LOSS_BAND} around phase 3's {want}")
    a.update(rows_bytes=rows_bytes, rows_shape=list(st["rows"].shape),
             collectives_a_step={k: v // steps for k, v in colls.items()},
             gap_to_zero1=None if zero1 is None else _gap(
                 a["losses"], zero1["losses"]))
    log(f"phase 12 (a): FSDP: losses within {a['max_loss_diff']:.3e} of "
        f"phase 3's (band {ZERO1_LOSS_BAND}), "
        + ("phase 11 (b) not run" if zero1 is None else
           f"largest gap to phase 11 (b)'s ZeRO-1 losses "
           f"{a['gap_to_zero1']:.3e}")
        + f"; rows {tuple(st['rows'].shape)} fp32 = "
        f"{rows_bytes / 2 ** 30:.3f} GiB; {a['step_ms_median']:.1f} ms a "
        f"step, peak {a['peak_gib']:.2f} GiB"
        + ("" if zero1 is None else
           f" (phase 11 (b): {zero1['step_ms_median']:.1f} ms, "
           f"{zero1['peak_gib']:.2f} GiB)")
        + ("" if remat_full is None else
           f" (phase 9 full remat: {remat_full['step_ms_median']:.1f} ms, "
           f"{remat_full['peak_gib']:.2f} GiB)")
        + f"; in-step collectives a step {a['collectives_a_step']}, no "
        f"negotiation round")
    launches["gpt2_medium_fsdp"] = a.pop("launches")

    # (b) the gathers on reduced wires, then (a) on each.
    row = st["rows"][0].detach()
    exact = mp.gather_shard(row)
    _, scale = quantize_blocks(row, "int8")
    # int8: half a block scale, plus the fp32 roundings of x / scale and
    # of code * scale; bf16: half an ulp, 2^-8 of the value.
    bound = {"int8": 0.5 * scale.repeat_interleave(256)[:row.numel()]
             + 2 ** -21 * row.abs(),
             "bf16": 2 ** -8 * row.abs()}
    b = {"gather": {}}
    for wire in ("bf16", "int8"):
        err = (mp.gather_shard(row, wire=wire) - exact).abs()
        share = float((err / bound[wire].clamp_min(1e-30)).max())
        b["gather"][wire] = {"max_abs_err": float(err.max()),
                             "share_of_bound": share}
        if not share <= 1.0:
            fail(f"phase 12 (b): gather_shard(wire={wire!r}) at one block "
                 f"({row.numel()} elements) leaves the quantizer's bound: "
                 f"{share:.3f} of it")
    log(f"phase 12 (b): gather_shard at one block ({row.numel()} "
        f"elements): " + ", ".join(
            f"{w} max error {v['max_abs_err']:.3e}, "
            f"{v['share_of_bound']:.3f} of its bound"
            for w, v in b["gather"].items()))
    del st, step, row, exact, scale, bound
    torch.cuda.empty_cache()
    for wire in ("bf16", "int8"):
        st, step = _fsdp_trainer(dev, wire=wire)
        run = _phase11_steps(f"(b) ZeRO-3 wire {wire}", steps,
                             lambda i: step(batch(i)), fsdp_launches,
                             phase=12)
        losses = run["losses"]
        if not losses[-1] < losses[0]:
            fail(f"phase 12 (b): wire {wire} losses do not fall: {losses}")
        run["gap_to_fsdp"] = _gap(losses, a["losses"])
        log(f"phase 12 (b): ZeRO-3 on the {wire} wire: losses {losses}, "
            f"largest gap to (a) {run['gap_to_fsdp']:.3e}; "
            f"{run['step_ms_median']:.1f} ms a step, peak "
            f"{run['peak_gib']:.2f} GiB")
        launches[f"gpt2_medium_zero3_{wire}"] = run.pop("launches")
        b[wire] = run
        del st, step
        torch.cuda.empty_cache()

    # (c) ZeRO-2 over the whole model.
    model, params, f, _ = _functional_gpt2(dev)
    names = list(params)
    zst = {"s": hvd.sharded_adamw(1e-4).init(params)}

    def step_c(i):
        value = f(params, batch(i))
        grads = torch.autograd.grad(value, [params[k] for k in names])
        g_shard = mp.zero2_grad_shard(dict(zip(names, grads)))
        del grads
        new, zst["s"] = mp.zero2_update(
            params, g_shard, zst["s"], learning_rate=1e-4,
            weight_decay=1e-4, eps=1e-8)
        with torch.no_grad():
            for k in names:
                params[k].copy_(new[k])
        return value.detach()

    c = _phase11_steps("(c) ZeRO-2", steps, step_c, model.cfg.num_layers,
                       phase=12)
    c["max_loss_diff"] = _gap(c["losses"], want)
    if c["max_loss_diff"] > ZERO1_LOSS_BAND:
        fail(f"phase 12 (c): ZeRO-2 losses {c['losses']} leave the band "
             f"{ZERO1_LOSS_BAND} around phase 3's {want}")
    mu = zst["s"].mu
    c.update(moment_bytes=2 * mu.numel() * mu.element_size(),
             gap_to_zero1=None if zero1 is None else _gap(
                 c["losses"], zero1["losses"]))
    log(f"phase 12 (c): ZeRO-2: losses within {c['max_loss_diff']:.3e} of "
        f"phase 3's, " + ("phase 11 (b) not run" if zero1 is None else
                          f"largest gap to phase 11 (b) "
                          f"{c['gap_to_zero1']:.3e}")
        + f"; moments {c['moment_bytes'] / 2 ** 30:.3f} GiB; "
        f"{c['step_ms_median']:.1f} ms a step, peak {c['peak_gib']:.2f} GiB")
    launches["gpt2_medium_zero2"] = c.pop("launches")
    del model, params, f, zst
    torch.cuda.empty_cache()

    # (d) FsdpState: commit, two steps, restore, the same two steps.
    st, step = _fsdp_trainer(dev)
    keep = {}

    def pre(i):
        if i == FSDP_COMMIT_STEP and "fs" not in keep:
            keep["fs"] = FsdpState(st["template"], shard=st["rows"],
                                   opt_state=st["f"], step=i)
            keep["ts"] = TensorState(rest=st["rest"], opt=st["z"])

    d = _phase11_steps("(d) FsdpState", FSDP_COMMIT_STEP + 2,
                       lambda i: step(batch(i)), fsdp_launches, pre=pre,
                       phase=12)
    fs, ts = keep["fs"], keep["ts"]
    t0 = time.perf_counter()
    fs.restore()
    ts.restore()
    restore_s = time.perf_counter() - t0
    saved = fs._saved
    for name, got in (("shard", fs.shard), ("mu", fs.opt_state.mu),
                      ("nu", fs.opt_state.nu)):
        if got.device != dev or not torch.equal(
                got.cpu(), torch.from_numpy(saved[name])):
            fail(f"phase 12 (d): the restored {name} is not the commit "
                 f"bit for bit")
    if fs.opt_state.step.tolist() != [FSDP_COMMIT_STEP] or \
            fs.step != FSDP_COMMIT_STEP:
        fail(f"phase 12 (d): restored step {fs.opt_state.step.tolist()}")
    st.update(rows=fs.shard, f=fs.opt_state, rest=ts.rest, z=ts.opt)
    again = _phase11_steps("(d) after restore", 2, lambda i: step(batch(i)),
                           fsdp_launches, phase=12, first=FSDP_COMMIT_STEP)
    if again["losses"] != d["losses"][FSDP_COMMIT_STEP:]:
        fail(f"phase 12 (d): the steps after restore() gave "
             f"{again['losses']}, not {d['losses'][FSDP_COMMIT_STEP:]}")
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_phase12_"),
                        "fsdp.ckpt")
    t0 = time.perf_counter()
    fs.save(path)
    save_s = time.perf_counter() - t0
    fresh = FsdpState(st["template"], step=-1)
    t0 = time.perf_counter()
    fresh.load(path)
    load_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    os.remove(path)
    os.rmdir(os.path.dirname(path))
    if any(not np.array_equal(fresh._saved[k], saved[k])
           for k in ("shard", "mu", "nu")) or \
            fresh._saved["step"] != saved["step"] or fresh.step != \
            FSDP_COMMIT_STEP:
        fail("phase 12 (d): save then load did not give the canonical "
             "arrays back")
    d.update(repeated=again["losses"], restore_s=restore_s, save_s=save_s,
             load_s=load_s, file_bytes=size)
    log(f"phase 12 (d): FsdpState committed after step "
        f"{FSDP_COMMIT_STEP - 1}: rows, mu, nu and step restored bit for "
        f"bit in {restore_s:.2f} s, steps {FSDP_COMMIT_STEP}-"
        f"{FSDP_COMMIT_STEP + 1} repeat {again['losses']} exactly; save "
        f"{save_s:.2f} s, load {load_s:.2f} s, {size / 2 ** 30:.2f} GiB, "
        f"the canonical arrays equal")
    launches["gpt2_medium_fsdp_state"] = {
        k: d["launches"][k] + again["launches"][k] for k in d["launches"]}
    d.pop("launches")
    del st, step, keep, fs, ts, fresh
    torch.cuda.empty_cache()
    hvd.shutdown()
    torch.cuda.synchronize()

    e = None
    if torch.cuda.device_count() >= 2:
        e = {}
        for n in (2, 4):
            if torch.cuda.device_count() < n:
                continue
            proc = subprocess.run(
                [sys.executable, "tools/torch_zero_bench.py", "--np", str(n),
                 "--stage", "3", "--band", str(ZERO1_LOSS_BAND)],
                capture_output=True, text=True, timeout=1200)
            if proc.returncode != 0:
                fail(f"phase 12 (e): tools/torch_zero_bench.py --np {n} "
                     f"--stage 3 failed:\n{proc.stdout[-2000:]}"
                     f"{proc.stderr[-3000:]}")
            e[n] = json.loads(proc.stdout.strip().splitlines()[-1])
            log(f"phase 12 (e): {n} ranks, stage 3: losses within "
                f"{e[n]['max_loss_diff']:.3e} of one rank's, checks "
                f"{e[n]['checks']}")
        if torch.cuda.device_count() >= 4:
            proc = subprocess.run(
                [sys.executable, "tools/torch_zero_bench.py", "--np", "4",
                 "--mesh", "dp2xmp2"], capture_output=True, text=True,
                timeout=900)
            if proc.returncode != 0:
                fail(f"phase 12 (e): tools/torch_zero_bench.py --mesh "
                     f"dp2xmp2 failed:\n{proc.stdout[-2000:]}"
                     f"{proc.stderr[-3000:]}")
            e["dp2xmp2"] = json.loads(proc.stdout.strip().splitlines()[-1])
            log(f"phase 12 (e): dp2xmp2 FSDP x tp MLP: checks "
                f"{e['dp2xmp2']['checks']}")
    else:
        log("phase 12 (e): tools/torch_zero_bench.py --stage 3 did not run "
            f"for want of a second card (cards: {torch.cuda.device_count()})")
    out.update(fsdp=a, wires=b, zero2=c, fsdp_state=d, more_cards=e,
               launches=launches, zero1_loss_band=ZERO1_LOSS_BAND)
    return out



# ---------------------------------------------------------------- phase 13

# The kernels' shapes under tensor parallelism: GPT-2 medium's attention
# (B 8, T 1024, d 64, causal, bf16) at the local head count 16 / mp.
TP_SHAPES = {"gpt2_tp2": dict(b=8, h=8, t=1024),
             "gpt2_tp4": dict(b=8, h=4, t=1024)}
# Standard deviation of the random biases phase 13 (b) gives every Dense
# layer (GPT-2's init zeroes them, and a row bias added on every rank must
# show).
TP_BIAS_STD = 0.05


def phase_tp_kernels():
    """K1-K3 against their plain versions at TP_SHAPES, then their times,
    bounds, plain times and SDPA with the same mask: {path: {kernel:
    numbers}}."""
    import torch
    out = {}
    for path, c in TP_SHAPES.items():
        b, h, t = c["b"], c["h"], c["t"]
        log(f"path {path}: B {b} H {h} (B*H {b * h}) T {t} d 64 bf16 "
            f"causal")
        errs, case, outs = compare_kernels(
            _path_inputs(b, h, t, True, h, False, seed=t + h), b, h, 64,
            True, 0, BF16_TOL)
        del outs
        out[path] = shape_report(case, errs, b, h, t, True)
        del case
        torch.cuda.empty_cache()
    return out


class _VirtualSet:
    """``n`` virtual tensor-parallel ranks on one card, one thread each.
    One thread runs at a time (``lock``); a reduction hands the card on
    until every rank has brought its operand, and each rank gets the
    result over all of them, in rank order, as a collective over a real
    set gives it."""

    def __init__(self, n, lock=None):
        import threading
        self.n = n
        self.slots = [None] * n
        # Sets of one grid of virtual ranks share one lock: one thread of
        # the grid runs at a time.
        self.lock = lock or threading.Lock()
        self.barrier = threading.Barrier(n, timeout=600)

    def _meet(self):
        self.lock.release()
        try:
            self.barrier.wait()
        finally:
            self.lock.acquire()

    def reduce(self, r, x, op):
        self.slots[r] = x
        self._meet()
        out = op(self.slots)
        self._meet()
        return out


def _run_virtual(n, body, lock, sets):
    """``body(r)`` on ``n`` threads, one at a time under the grid's
    ``lock``: returns the results in rank order. A rank that raises
    aborts the barriers of the ``_VirtualSet``s ``sets``, so the others
    stop too, and the first error is raised after every thread has
    stopped."""
    import threading
    out, errs = [None] * n, []

    def run(r):
        lock.acquire()
        try:
            out[r] = body(r)
        except BaseException as e:   # noqa: BLE001 -- re-raised below
            errs.append(e)
            for vs in sets:
                vs.barrier.abort()
        finally:
            lock.release()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


def _virtual_tp(vset, r):
    """Rank ``r`` of ``vset`` as a ``mp.TensorParallel``: its embedding
    and its place in the vocab are the port's; f is the identity (the
    forward only), g and the max reduce over the virtual ranks."""
    import torch
    from horovod_tpu_torch.parallel import mp

    class VirtualTP(mp.TensorParallel):
        def __init__(self):
            self.process_set, self.size, self.rank = vset, vset.n, r
            self.f = lambda x: x
            self.g = lambda x: vset.reduce(r, x, sum)

        def max(self, x):
            return vset.reduce(r, x.detach(),
                               lambda xs: torch.stack(xs).amax(0))

    return VirtualTP()


def tp_virtual_logits(model, tokens, mp_, fault=None):
    """GPT-2 ``model``'s logits and loss from ``mp_`` virtual
    tensor-parallel ranks on one card (``_VirtualSet``): each rank's
    ``split_params`` part in a GPT-2 built on the meta device and wired by
    ``mp._part_model`` as ``tensor_parallel`` wires it, so its forward
    runs the port's tensor-parallel modules (the local head count, the
    row-parallel ``Dense.reduce`` with the bias after the sum, the
    vocab-parallel embedding) and the loss is ``vocab_parallel_loss``'s
    arithmetic over the vocab slices (``mp._vocab_parallel_loss``); only
    the collectives are the virtual set's. Returns (the vocab slices of
    the logits concatenated, each rank's loss). ``fault`` plants
    ``"contiguous_qkv"`` (qkv rows split in contiguous blocks, not by
    heads) or ``"bias_every_rank"`` (each rank adds the row bias before
    the sum)."""
    import torch
    from horovod_tpu_torch.parallel import mp
    cfg = model.cfg
    full = {k: v.detach() for k, v in model.state_dict().items()}
    vset = _VirtualSet(mp_)
    ranks = []
    for r in range(mp_):
        part = mp.split_params(cfg, full, mp_, r)
        if fault == "contiguous_qkv":
            for k in part:
                if ".attn.qkv." in k:
                    part[k] = mp._split_one("rows", full[k], mp_, r)
        tp = _virtual_tp(vset, r)
        m = mp._part_model(cfg, part, tp)
        if fault == "bias_every_rank":
            for blk in m.h:
                for d in (blk.attn.out, blk.mlp.proj):
                    bias, d.bias = d.bias, None
                    d.reduce = (lambda y, bias=bias, tp=tp:
                                tp.g(y + bias.to(cfg.dtype)))
        ranks.append((m, tp))
    def body(r):
        m, tp = ranks[r]
        with torch.no_grad():
            lg = m(tokens)
            return lg, mp._vocab_parallel_loss(tp, lg, tokens)

    out = _run_virtual(mp_, body, vset.lock, [vset])
    return torch.cat([lg for lg, _ in out], -1), [float(x) for _, x in out]


def phase_tp_virtual(dev):
    """(b) GPT-2 medium with random biases split over 2 and 4 virtual ranks
    on the one card (``tp_virtual_logits``) against its dense forward. The
    bound is derived on the card: the dense bf16 forward's own largest
    error against the same weights run in fp32 (dense attention), twice
    over, since the tensor-parallel forward rounds once more (each partial
    to bf16 before the sum) and is held against the fp32 forward as well.
    Every virtual rank's loss equals the others' and is within rtol 1e-5
    (the CPU tests' bound on this loss) of ``loss_fn`` over the same
    logits concatenated. Both planted faults must leave the logits'
    bound. Counts K1's launches on each virtual forward (24 layers x mp
    ranks)."""
    import torch
    from horovod_tpu_torch.models import get_model
    from horovod_tpu_torch.models.gpt2 import Dense, loss_fn
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    model = _gpt2_medium(dev)
    g = torch.Generator(device=dev).manual_seed(13)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Dense) and m.bias is not None:
                m.bias.normal_(0.0, TP_BIAS_STD, generator=g)
    tokens = torch.randint(0, model.cfg.vocab_size, (8, 1024),
                           generator=torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        dense = model(tokens)
        with torch.device(dev):
            ref = get_model("gpt2_medium", attention="dense",
                            dtype=torch.float32, generator=g)
        ref.load_state_dict(model.state_dict())
        exact = ref(tokens)
        del ref
    dense_err = _err(dense, exact)
    tol = 2 * dense_err
    log(f"phase 13 (b): the dense bf16 forward's largest logit error "
        f"against the fp32 forward is {dense_err:.4e}; bound on a "
        f"tensor-parallel forward's error against either: {tol:.4e}")
    out, launches = {"dense_err_vs_fp32": dense_err, "bound": tol}, {}
    for n in (2, 4):
        fa.reset_launches()
        t0 = time.perf_counter()
        got, losses = tp_virtual_logits(model, tokens, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[f"gpt2_medium_tp_virtual_mp{n}"] = dict(fa.launches)
        want = {"flash_fwd": model.cfg.num_layers * n, "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0}
        if dict(fa.launches) != want:
            fail(f"phase 13 (b): {n} virtual ranks launched {fa.launches}, "
                 f"want {want}")
        e_dense, e_exact = _err(got, dense), _err(got, exact)
        with torch.no_grad():
            whole = float(loss_fn(got, tokens))
        out[f"mp{n}"] = {"max_abs_err_vs_dense": e_dense,
                         "max_abs_err_vs_fp32": e_exact, "wall_s": wall,
                         "loss": losses[0], "loss_fn_on_logits": whole}
        log(f"phase 13 (b): {n} virtual ranks: logits within {e_dense:.4e} "
            f"of the dense forward's and {e_exact:.4e} of the fp32 "
            f"forward's (bound {tol:.4e}); vocab-parallel loss "
            f"{losses[0]!r} on every rank, loss_fn on the logits "
            f"{whole!r}; K1 launches {fa.launches}; {wall:.2f} s")
        if not (e_dense <= tol and e_exact <= tol):
            fail(f"phase 13 (b): {n} virtual ranks leave the bound {tol}: "
                 f"{e_dense} against the dense forward, {e_exact} against "
                 f"fp32")
        if len(set(losses)) != 1 or not math.isclose(
                losses[0], whole, rel_tol=1e-5, abs_tol=0.0):
            fail(f"phase 13 (b): the vocab-parallel losses {losses} at {n} "
                 f"ranks are not loss_fn's {whole} (rtol 1e-5)")
        del got
        for fault in ("contiguous_qkv", "bias_every_rank"):
            bad = _err(tp_virtual_logits(model, tokens, n, fault)[0], dense)
            out[f"mp{n}"][f"planted_{fault}"] = bad
            log(f"phase 13 (b): planted {fault} at {n} ranks: "
                f"{bad:.4e} from the dense forward")
            if not bad > tol:
                fail(f"phase 13 (b): the planted {fault} at {n} ranks "
                     f"passed the check ({bad} <= {tol})")
    del model, dense, exact
    torch.cuda.empty_cache()
    return out, launches


def _tp_decode_run(tag, model, prompt, new):
    """(c) Greedy decode of ``prompt`` and ``new`` tokens through
    ``decode_step`` and, on the same input token at each position, through
    ``tp_decode_step`` over the one-rank mp set with the model's state
    dict: logits and the greedy tokens equal at every step, each step's ms
    for both."""
    import torch
    from horovod_tpu_torch.models import generate as G
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    from horovod_tpu_torch.parallel import mp
    cfg = model.cfg
    b, p = prompt.shape
    total = p + new
    dense, tp = G.decode_step(cfg), mp.tp_decode_step(cfg)
    state = {k: v for k, v in model.state_dict().items()}
    ca = G.init_cache(cfg, b, total, device=prompt.device)
    cb = G.init_cache(cfg, b, total, device=prompt.device)
    tok = prompt[:, 0]
    ms = {"dense": [], "tp": []}
    fa.reset_launches()
    for t in range(total - 1):
        for which in ("dense", "tp"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if which == "dense":
                ca, la = dense(model, ca, tok, t)
            else:
                cb, lb = tp(state, cb, tok, t)
            torch.cuda.synchronize()
            ms[which].append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(la, lb):
            fail(f"phase 13 (c) {tag}: tp_decode_step's logits differ from "
                 f"decode_step's at position {t} by "
                 f"{(la - lb).abs().max().item()}")
        ga, gb = G.greedy_token(la), G.greedy_token(lb)
        if not torch.equal(ga, gb):
            fail(f"phase 13 (c) {tag}: greedy tokens differ at {t}")
        tok = prompt[:, t + 1] if t + 1 < p else ga
    if any(fa.launches.values()):
        fail(f"phase 13 (c) {tag}: decode launched {fa.launches}")
    if not all(torch.equal(ca[i][k], cb[i][k]) for i in ca for k in "kv"):
        fail(f"phase 13 (c) {tag}: the caches differ")
    res = {"steps": total - 1, "batch": b,
           "dense_ms_per_step": statistics.median(ms["dense"]),
           "tp_ms_per_step": statistics.median(ms["tp"])}
    log(f"phase 13 (c) {tag}: tp_decode_step equals decode_step bit for "
        f"bit at all {total - 1} positions (B {b}, prompt {p}, {new} new), "
        f"logits, greedy tokens and cache; median ms a step: dense "
        f"{res['dense_ms_per_step']:.2f}, tp {res['tp_ms_per_step']:.2f}")
    return res


def phase_tensor_parallel(card, main_path):
    """Phase 13 on a new one-rank NCCL world: (a) GPT-2 medium through
    ``mp.tensor_parallel`` and ``mp.vocab_parallel_loss`` at mp = 1 for 5
    steps, its losses equal to phase 3's bit for bit, 24 launches of each
    kernel a step; the kernels at the tensor-parallel shapes; (b)
    ``phase_tp_virtual``; (c) ``tp_decode_step`` at mp = 1 against
    ``decode_step``, bit for bit, for GPT-2 medium (B 8, prompt 32, 96
    new) and Llama-340M (B 4, prompt 32, 64 new), bf16 parameters.
    Without phase 3 it runs phase 3's path itself first."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import get_model
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    dev = hvd.device()
    t0 = time.perf_counter()
    if main_path is None:
        main_path = phase_train_path("gpt2_medium", card, dev)
    a = phase_train_path("gpt2_medium_tp", card, dev)
    if a["losses"] != main_path["losses"]:
        fail(f"phase 13 (a): tensor-parallel losses at mp 1 {a['losses']} "
             f"are not phase 3's {main_path['losses']} bit for bit")
    log(f"phase 13 (a): GPT-2 medium through tensor_parallel at mp 1: "
        f"losses equal phase 3's bit for bit; {a['step_ms_median']:.1f} ms "
        f"a step (phase 3: {main_path['step_ms_median']:.1f}), peak "
        f"{a['peak_gib']:.2f} GiB")
    launches = {"gpt2_medium_tp": a.pop("launches")}
    kernels = phase_tp_kernels()
    b, virt = phase_tp_virtual(dev)
    launches.update(virt)
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    c = {}
    with torch.device(dev):
        model = get_model("gpt2_medium", attention="dense", generator=g)
    model = model.to(torch.bfloat16)
    prompt = torch.tensor(rng.integers(1, model.cfg.vocab_size, (8, 32)),
                          device=dev)
    c["gpt2_medium"] = _tp_decode_run("gpt2_medium", model, prompt, 96)
    del model
    with torch.device(dev):
        model = get_model("llama", vocab_size=32000, max_seq_len=2048,
                          num_layers=24, num_heads=16, num_kv_heads=4,
                          d_model=1024, d_ff=2816, attention="dense",
                          generator=g)
    model = model.to(torch.bfloat16)
    prompt = torch.tensor(rng.integers(1, model.cfg.vocab_size, (4, 32)),
                          device=dev)
    c["llama_340m"] = _tp_decode_run("llama_340m", model, prompt, 64)
    del model
    launches["tp_decode"] = {}
    torch.cuda.empty_cache()
    hvd.shutdown()
    torch.cuda.synchronize()
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")
    return {"kernels": kernels, "train_mp1": a, "virtual": b, "decode": c,
            "launches": launches}



# ---------------------------------------------------------------- phase 14

def dryrun_dims(n):
    """The reference's dryrun factorization of ``n`` ranks into (dp, sp,
    tp) and (dp, ep, tp) (``__graft_entry__.py:69-74``, ``:107-109``):
    8 -> (2, 2, 2), 4 -> (1, 2, 2), 2 -> (1, 1, 2), 1 -> (1, 1, 1)."""
    tp = 2 if n % 2 == 0 else 1
    mid = 2 if n % (2 * tp) == 0 else 1
    return n // (tp * mid), mid, tp


# The kernels' shapes on the other axes: gpt2_long's shard (B 2, T 4096)
# at sp 2 x tp 2, 8 heads a rank and t 2048 a hop, in each of its hops'
# modes (the diagonal, the contiguous ring's full hop, the striped ring's
# strict one), and the Mixtral-style Llama-340M at tp 2 (8 heads over 2 kv
# heads, T 2048).
MESH_SHAPES = {
    "gpt2_long_sp2tp2_causal": dict(b=2, h=8, t=2048, causal=True,
                                    offset=0, hkv=8),
    "gpt2_long_sp2tp2_full": dict(b=2, h=8, t=2048, causal=False, offset=0,
                                  hkv=8),
    "gpt2_long_sp2tp2_strict": dict(b=2, h=8, t=2048, causal=True,
                                    offset=-1, hkv=8),
    "llama_moe_tp2": dict(b=4, h=8, t=2048, causal=True, offset=0, hkv=2),
}


def phase_mesh_kernels():
    """K1-K3 against their plain versions at MESH_SHAPES (a ring hop's
    backward with an outside lse and delta, as the ring gives it), then
    their times, bounds, plain times and SDPA with the same mask: {path:
    {kernel: numbers}}."""
    import torch
    out = {}
    for path, c in MESH_SHAPES.items():
        b, h, t, causal, offset = c["b"], c["h"], c["t"], c["causal"], \
            c["offset"]
        log(f"path {path}: B {b} H {h} (B*H {b * h}) T {t} d 64 bf16 "
            f"causal {causal} offset {offset} KV heads {c['hkv']}")
        errs, case, outs = compare_kernels(
            _path_inputs(b, h, t, causal, c["hkv"], False, seed=t + h + 7),
            b, h, 64, causal, offset, BF16_TOL,
            outside=path.startswith("gpt2_long"))
        del outs
        out[path] = shape_report(case, errs, b, h, t, causal, offset=offset)
        del case
        torch.cuda.empty_cache()
    return out


def _virtual_ring(vset, r):
    """Rank ``r`` of ``vset`` as an ``ops.ring_attention.Ring``: its place
    and its reduction are the virtual set's, a hop hands each rank's
    tensors to its neighbour through the set (``post``); the rings, the
    merges and the losses that run over it are the port's."""
    import torch
    from horovod_tpu_torch.ops.ring_attention import Ring

    class VirtualRing(Ring):
        def __init__(self):
            self.ps, self.group, self.n, self.rank = vset, None, vset.n, r
            self.next, self.prev = (r + 1) % vset.n, (r - 1) % vset.n

        def post(self, send, forward=True, into=None):
            if self.n == 1 or not send:
                return list(send), [], ()
            got = vset.reduce(r, [x.contiguous() for x in send],
                              list)[self.prev if forward else self.next]
            if into is None:
                return [x.clone() for x in got], [], ()
            for buf, x in zip(into, got):
                buf.copy_(x)
            return list(into), [], ()

        def psum(self, x):
            return vset.reduce(r, x, lambda xs: torch.stack(xs).sum(0))

    return VirtualRing()


def sp_tp_virtual(model, tokens, sp, tp, layout, fault=None):
    """GPT-2 ``model``'s logits and loss from ``sp`` x ``tp`` virtual ranks
    on one card, the reference's dp x sp x tp layout at dp 1: rank (s, c)
    holds tp part c (``split_params``, wired by ``mp._part_model``: the
    local heads, ``Dense.reduce``, the vocab-parallel embedding), feeds
    shard s of the tokens in ``layout``, runs the port's rings over its
    sp line (``_virtual_ring``, bound by ``mp._bind`` as
    ``tensor_parallel(sp=)`` binds it) and takes the port's loss
    (``sharded_lm_loss`` over ``mp._vocab_parallel_ll``). Only the
    collectives are the virtual sets'. Returns (the (B, T, V) logits
    assembled from the shards, each rank's loss). ``fault`` plants
    ``"global_positions"`` (wpe read at the positions the whole 4-rank
    set gives: the model's wpe extended to 2T rows for that run, so the
    wrong rows exist) or ``"no_shift"`` (each shard's loss over its own
    next tokens, the shift across shards left out)."""
    import dataclasses
    import functools
    import threading
    import torch
    from horovod_tpu_torch.models.gpt2 import sharded_lm_loss
    from horovod_tpu_torch.parallel import mp
    cfg = dataclasses.replace(model.cfg, use_ring_attention=True,
                              ring_layout=layout)
    full = {k: v.detach() for k, v in model.state_dict().items()}
    b, t_all = tokens.shape
    t = t_all // sp
    if fault == "global_positions":
        g = torch.Generator(device=tokens.device).manual_seed(17)
        extra = torch.randn(full["wpe"].shape, generator=g,
                            device=tokens.device) * 0.01
        full["wpe"] = torch.cat([full["wpe"], extra])
        cfg = dataclasses.replace(cfg, max_seq_len=2 * cfg.max_seq_len)
    lock = threading.Lock()
    tp_sets = [_VirtualSet(tp, lock) for _ in range(sp)]
    sp_sets = [_VirtualSet(sp, lock) for _ in range(tp)]
    whole = _VirtualSet(sp * tp, lock)
    ranks = []
    for s in range(sp):
        for c in range(tp):
            vtp = _virtual_tp(tp_sets[s], c)
            m = mp._part_model(cfg, mp.split_params(cfg, full, tp, c), vtp)
            mp._bind(m, "sp", _virtual_ring(sp_sets[c], s))
            if fault == "global_positions":
                m.sp = _virtual_ring(whole, s * tp + c)
            shard = tokens[:, s::sp].contiguous() if layout == "striped" \
                else tokens[:, s * t:(s + 1) * t]
            ranks.append((m, vtp, shard))

    def body(i):
        m, vtp, shard = ranks[i]
        ring = m.h[0].attn.sp
        with torch.no_grad():
            lg = m(shard)
            if fault == "no_shift":
                return lg, mp._vocab_parallel_loss(vtp, lg, shard)
            return lg, sharded_lm_loss(
                lg, shard, ring, layout,
                functools.partial(mp._vocab_parallel_ll, vtp))
    got = _run_virtual(sp * tp, body, lock, tp_sets + sp_sets)
    shards = [torch.cat([got[s * tp + c][0] for c in range(tp)], -1)
              for s in range(sp)]
    if layout == "striped":
        logits = torch.stack(shards, 2).reshape(b, t_all, -1)
    else:
        logits = torch.cat(shards, 1)
    return logits, [float(x) for _, x in got]


def phase_sp_tp_virtual(dev):
    """(b) ``gpt2_long`` (GPT-2 medium at T 4096, B 2, flash) over 4
    virtual ranks, sp 2 x tp 2 (``sp_tp_virtual``), both ring layouts,
    against its dense one-card forward. The bound is derived on the card
    as phase 13 (b) derives its own: the dense bf16 forward's largest
    logit error against the same weights in fp32 (dense attention), twice
    over. Each virtual rank's loss equals the others' and is within rtol
    1e-5 of ``loss_fn`` over the assembled logits. The planted faults
    (positions from the whole set, contiguous; the shift across shards
    left out of the loss, striped) must leave the logits' bound or the
    loss's. K1 launches: one a non-skipped hop, a layer and a rank."""
    import torch
    from horovod_tpu_torch.models import get_model
    from horovod_tpu_torch.models.gpt2 import loss_fn
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    g = torch.Generator(device=dev).manual_seed(14)
    with torch.device(dev):
        model = get_model("gpt2_medium", max_seq_len=4096, attention="flash",
                          generator=g)
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 4096),
                           generator=torch.Generator().manual_seed(14)).to(
                               dev)
    with torch.no_grad():
        dense = model(tokens)
        with torch.device(dev):
            ref = get_model("gpt2_medium", max_seq_len=4096,
                            attention="dense", dtype=torch.float32,
                            generator=g)
        ref.load_state_dict(model.state_dict())
        exact = ref(tokens)
        del ref
        whole_loss = float(loss_fn(dense, tokens))
    dense_err = _err(dense, exact)
    tol = 2 * dense_err
    log(f"phase 14 (b): gpt2_long's dense bf16 logits are within "
        f"{dense_err:.4e} of its fp32 forward's; bound on a virtual sp x tp "
        f"forward's error against either: {tol:.4e}")
    out, launches = {"dense_err_vs_fp32": dense_err, "bound": tol,
                     "dense_loss": whole_loss}, {}
    layers = model.cfg.num_layers
    # Non-skipped hops of the two sp ranks (contiguous: 1 and 2; striped:
    # 2 and 2), on each of the 2 tp ranks.
    want_k1 = {"contiguous": 3 * 2 * layers, "striped": 4 * 2 * layers}
    for layout in ("contiguous", "striped"):
        fa.reset_launches()
        t0 = time.perf_counter()
        got, losses = sp_tp_virtual(model, tokens, 2, 2, layout)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[f"gpt2_long_sp2tp2_virtual_{layout}"] = dict(fa.launches)
        want = {"flash_fwd": want_k1[layout], "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0}
        if dict(fa.launches) != want:
            fail(f"phase 14 (b) {layout}: the virtual ranks launched "
                 f"{fa.launches}, want {want}")
        e_dense, e_exact = _err(got, dense), _err(got, exact)
        with torch.no_grad():
            on_logits = float(loss_fn(got, tokens))
        out[layout] = {"max_abs_err_vs_dense": e_dense,
                       "max_abs_err_vs_fp32": e_exact, "wall_s": wall,
                       "losses": losses, "loss_fn_on_logits": on_logits}
        log(f"phase 14 (b) {layout}: sp 2 x tp 2 logits within "
            f"{e_dense:.4e} of the dense forward's and {e_exact:.4e} of "
            f"fp32's (bound {tol:.4e}); losses {losses}, loss_fn on the "
            f"logits {on_logits!r} (dense forward's {whole_loss!r}); K1 "
            f"launches {fa.launches}; {wall:.2f} s")
        if not (e_dense <= tol and e_exact <= tol):
            fail(f"phase 14 (b) {layout}: the virtual ranks leave the "
                 f"bound {tol}: {e_dense} against the dense forward, "
                 f"{e_exact} against fp32")
        if len(set(losses)) != 1 or not math.isclose(
                losses[0], on_logits, rel_tol=1e-5, abs_tol=0.0):
            fail(f"phase 14 (b) {layout}: the losses {losses} are not "
                 f"loss_fn's {on_logits} on the same logits (rtol 1e-5)")
        del got
    for layout, fault in (("contiguous", "global_positions"),
                          ("striped", "no_shift")):
        bad, losses = sp_tp_virtual(model, tokens, 2, 2, layout, fault)
        e = _err(bad, dense)
        rel = max(abs(x - out[layout]["loss_fn_on_logits"])
                  / abs(out[layout]["loss_fn_on_logits"]) for x in losses)
        out[f"planted_{fault}"] = {"logits_err": e, "loss_rel_err": rel}
        log(f"phase 14 (b): planted {fault} ({layout}): logits {e:.4e} "
            f"from the dense forward (bound {tol:.4e}), losses {losses} "
            f"{rel:.3e} relative from loss_fn's (limit 1e-5)")
        if not (e > tol or rel > 1e-5):
            fail(f"phase 14 (b): the planted {fault} passed the checks "
                 f"({e} <= {tol}, {rel} <= 1e-5)")
        del bad
    del model, dense, exact
    torch.cuda.empty_cache()
    return out, launches


def _virtual_ep(vset, r):
    """Rank ``r`` of ``vset`` as an ``ops.moe.ExpertParallel``: its place
    is the virtual set's and its all-gather concatenates the ranks' expert
    outputs through the set; f (the identity forward) and the layer are
    the port's."""
    import torch
    from horovod_tpu_torch.ops.moe import ExpertParallel

    class VirtualEP(ExpertParallel):
        def __init__(self):
            self.process_set, self.size, self.rank = vset, vset.n, r
            self.f = lambda x: x

        def all_gather(self, x):
            return vset.reduce(r, x.contiguous(), torch.cat)

    return VirtualEP()


def _planted_local_router(router, lo, el):
    """The planted (c) fault: a router whose dispatch for experts [lo, lo
    + el) comes from routing among those experts alone, with the capacity
    of an el-expert layer, cut to the layer's C slots."""
    import copy
    import torch

    sub = copy.deepcopy(router)
    sub.num_experts = el
    sub.router = torch.nn.Parameter(router.router[:, lo:lo + el].detach())

    def forward(x):
        dispatch, combine, aux = type(router).forward(router, x)
        mine = sub(x)[0][..., :dispatch.shape[2]]
        dispatch = dispatch.clone()
        dispatch[:, lo:lo + el] = mine
        return dispatch, combine, aux
    return forward


def ep_virtual_layer(layer, x, ep, fault=False):
    """One MoE ``layer`` split over ``ep`` virtual ranks: rank e keeps
    experts [e*E/ep, (e+1)*E/ep) of a copy of the layer, with a
    ``_virtual_ep`` on its ``ep``, and runs the port's ``MoEMLP.forward``
    on the same tokens ``x``. Returns each rank's (out, aux) and its
    expert bytes. ``fault`` plants ``_planted_local_router`` on rank 1."""
    import copy
    import threading
    import torch
    from horovod_tpu_torch.parallel import mp
    e = layer.router.num_experts
    el = e // ep
    lock = threading.Lock()
    vset = _VirtualSet(ep, lock)
    ranks = []
    for r in range(ep):
        part = copy.copy(layer)
        part._parameters = dict(layer._parameters)
        for name in ("w_in", "w_out", "w_gate", "b_in", "b_out"):
            if name in part._parameters:
                part._parameters[name] = torch.nn.Parameter(
                    layer._parameters[name].detach()[r * el:(r + 1) * el],
                    requires_grad=False)
        part.ep = _virtual_ep(vset, r)
        if fault and r == 1:
            part._modules = dict(layer._modules)
            part._modules["router"] = copy.copy(layer.router)
            part._modules["router"].forward = _planted_local_router(
                layer.router, r * el, el)
        ranks.append(part)

    def body(r):
        with torch.no_grad():
            return ranks[r](x)
    outs = _run_virtual(ep, body, lock, [vset])
    nbytes = [mp.param_bytes({k: v for k, v in p._parameters.items()
                              if k != "router"}) for p in ranks]
    return outs, nbytes


def phase_ep_virtual(dev):
    """(c) The Mixtral-style Llama-340M of phase 9 (8 experts, top-2,
    SwiGLU, B 4, T 2048): each MoE layer's input from one dense forward,
    then the layer split over 2 and 4 virtual ep ranks
    (``ep_virtual_layer``): every rank's output within the layer's own
    bound (its bf16 output's largest error against the same layer in
    fp32; bit for bit is reported) and its aux loss bit for bit the dense
    layer's, every rank holding 1/ep of the expert bytes; the planted
    router (rank 1 routing among its own experts with their capacity)
    must leave the bound on every layer."""
    import copy
    import numpy as np
    import torch
    from horovod_tpu_torch.models import get_model
    from horovod_tpu_torch.ops.moe import MoEMLP
    from horovod_tpu_torch.parallel import mp
    g = torch.Generator(device=dev).manual_seed(15)
    with torch.device(dev):
        model = get_model("llama", vocab_size=32000, max_seq_len=2048,
                          num_layers=24, num_heads=16, num_kv_heads=4,
                          d_model=1024, d_ff=2816, attention="flash",
                          num_experts=8, moe_router="top2",
                          expert_capacity_factor=1.25, generator=g)
    tokens = torch.tensor(np.random.default_rng(15).integers(
        0, 32000, (4, 2048)), device=dev)
    seen = []
    layers = [m for m in model.modules() if isinstance(m, MoEMLP)]
    hooks = [m.register_forward_hook(
        lambda mod, i, o: seen.append((mod, i[0].detach(), o[0].detach(),
                                       o[1].detach()))) for m in layers]
    with torch.no_grad():
        model(tokens)
        for h in hooks:
            h.remove()
        # Each layer's bound: its bf16 output's error against the same
        # layer computing in fp32 (the same routing: the router is fp32).
        bounds = []
        for layer, x, want, _ in seen:
            f32 = copy.copy(layer)
            f32.dtype = torch.float32
            bounds.append(_err(want, f32(x.float())[0]))
    out = {"layers": len(seen), "smallest_bound": min(bounds)}
    for ep in (2, 4):
        worst, exact, faults, ratios = 0.0, True, [], set()
        for (layer, x, want, want_aux), bound in zip(seen, bounds):
            outs, nbytes = ep_virtual_layer(layer, x, ep)
            whole = mp.param_bytes({k: v for k, v in
                                    layer._parameters.items()})
            ratios.update(nb / whole for nb in nbytes)
            for o, aux in outs:
                err = _err(o, want)
                exact = exact and torch.equal(o, want)
                if not torch.equal(aux, want_aux):
                    fail(f"phase 14 (c): ep {ep} aux loss {aux.item()} is "
                         f"not the dense layer's {want_aux.item()}")
                if err > bound:
                    fail(f"phase 14 (c): ep {ep} output {err} from the "
                         f"dense layer's, beyond its bound {bound}")
                worst = max(worst, err)
            bad, _ = ep_virtual_layer(layer, x, ep, fault=True)
            faults.append(min(_err(o, want) / bound for o, _ in bad))
            del outs, bad
        if ratios != {1.0 / ep}:
            fail(f"phase 14 (c): ep {ep} ranks hold {sorted(ratios)} of the "
                 f"expert bytes, want {1.0 / ep}")
        if not min(faults) > 1.0:
            fail(f"phase 14 (c): the planted router at ep {ep} stayed "
                 f"within the bound on a layer ({min(faults)} of it)")
        out[f"ep{ep}"] = {"max_abs_err": worst, "bit_for_bit": exact,
                          "expert_bytes_share": 1.0 / ep,
                          "planted_min_share_of_bound": min(faults)}
        log(f"phase 14 (c): {len(seen)} MoE layers over {ep} virtual ep "
            f"ranks: outputs within {worst:.4e} of the dense layers' "
            f"(bit for bit: {exact}; the smallest layer bound "
            f"{min(bounds):.4e}), "
            f"aux losses bit for bit, 1/{ep} of the expert bytes a rank; "
            f"the planted router {min(faults):.1f}x the bound or more")
    del model, seen
    torch.cuda.empty_cache()
    return out


def phase_mesh(card, main_path, moe_run):
    """Phase 14 on a new one-rank NCCL world: (a) GPT-2 medium through the
    reference's dp x sp x tp step at one rank (``gpt2_medium_sp_tp``):
    phase 3's losses bit for bit, 24 launches of each kernel a step; the
    kernels at MESH_SHAPES; (b) ``phase_sp_tp_virtual``; (c)
    ``phase_ep_virtual``; (d) the dp x ep x tp step of the Mixtral-style
    Llama at one rank (``llama_moe_ep_tp``), phase 9's ``llama_moe``
    losses bit for bit, with (a)'s and (d)'s ms a step and peak memory.
    Without phases 3 and 9 it runs their paths itself first."""
    import torch
    import horovod_tpu_torch as hvd
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    dev = hvd.device()
    t0 = time.perf_counter()
    if main_path is None:
        main_path = phase_train_path("gpt2_medium", card, dev)
    a = phase_train_path("gpt2_medium_sp_tp", card, dev)
    if a["losses"] != main_path["losses"]:
        fail(f"phase 14 (a): the dp x sp x tp step's losses {a['losses']} "
             f"are not phase 3's {main_path['losses']} bit for bit")
    log(f"phase 14 (a): GPT-2 medium through the dp x sp x tp step at one "
        f"rank: losses equal phase 3's bit for bit; "
        f"{a['step_ms_median']:.1f} ms a step (phase 3: "
        f"{main_path['step_ms_median']:.1f}), peak {a['peak_gib']:.2f} GiB")
    launches = {"gpt2_medium_sp_tp": a.pop("launches")}
    kernels = phase_mesh_kernels()
    b, virt = phase_sp_tp_virtual(dev)
    launches.update(virt)
    c = phase_ep_virtual(dev)
    if moe_run is None:
        moe_run = phase_train_path("llama_moe", card, dev)
        launches["llama_moe"] = moe_run.pop("launches")
    d = phase_train_path("llama_moe_ep_tp", card, dev)
    launches["llama_moe_ep_tp"] = d.pop("launches")
    if d["losses"] != moe_run["losses"]:
        fail(f"phase 14 (d): the dp x ep x tp step's losses {d['losses']} "
             f"are not llama_moe's {moe_run['losses']} bit for bit")
    log(f"phase 14 (d): the Mixtral-style Llama through the dp x ep x tp "
        f"step at one rank: losses equal llama_moe's bit for bit; "
        f"{d['step_ms_median']:.1f} ms a step (llama_moe: "
        f"{moe_run['step_ms_median']:.1f}), peak {d['peak_gib']:.2f} GiB")
    hvd.shutdown()
    torch.cuda.synchronize()
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")
    return {"kernels": kernels, "sp_tp_step": a, "virtual_sp_tp": b,
            "virtual_ep": c, "ep_tp_step": d, "launches": launches}


# ---------------------------------------------------------------- phase 15

# Source rows of phase 15 with padded tails: row i < T5_PAD_ROWS ends in
# 64 * (i + 1) pad ids.
T5_PAD_ROWS = 4
# Standard deviation of the relative bias tables in phase 15 (b): the
# init's 0.02 moves the scores too little for a wrong head slice to show
# against bf16 rounding; trained T5 tables are of order 1 and more.
T5_TABLE_STD = 1.0
# Phase 15 (b) redraws the query projections at the original T5 init, std
# (d_model * head_dim) ** -0.5, which carries the 1/sqrt(head_dim) score
# scale T5 leaves out of its attention. Under the lecun init that the
# reference and the port draw, T5-small's untrained scores have a std of
# about sqrt(head_dim) = 8, its softmax is nearly one-hot, and bf16
# rounding flips its near ties: the dense bf16 logits were 3.1 from the
# fp32 ones, and a wrong bias slice hid under twice that.


def t5_source(src, pad_id):
    """``src`` with the tails of its first ``T5_PAD_ROWS`` rows padded."""
    src = src.clone()
    for i in range(T5_PAD_ROWS):
        src[i, src.shape[1] - 64 * (i + 1):] = pad_id
    return src


def t5_virtual_logits(model, src, labels, mp_, fault=False):
    """T5 ``model``'s logits and loss from ``mp_`` virtual tensor-parallel
    ranks on one card (``_VirtualSet``): each rank's split of the model's
    own weights (``mp._split_t5``, as ``tensor_parallel`` splits them) in a
    T5 built on the meta device and wired by ``mp._part_model``, so its
    forward runs the port's tensor-parallel modules (H/mp heads, this
    rank's columns of each bias table, ``o`` and ``wo`` summed by g, the
    vocab-parallel embedding for both stacks) and the loss is
    ``seq2seq_loss``'s vocab-parallel arithmetic (``t5._token_loss``);
    only the collectives are the virtual set's. Returns (the vocab slices
    of the logits concatenated, each rank's loss). ``fault`` makes every
    rank add heads [0, H/mp) of the tables."""
    import types
    import torch
    from horovod_tpu_torch.models.t5 import _token_loss, shift_right
    from horovod_tpu_torch.parallel import mp
    cfg = model.cfg
    full = {k: v.detach() for k, v in model.state_dict().items()}
    vset = _VirtualSet(mp_)
    ranks = []
    for r in range(mp_):
        tp = _virtual_tp(vset, r)
        m = mp._part_model(cfg, mp._split_t5(cfg, full, mp_, r), tp)
        if fault:
            for rb in (m.enc_rel, m.dec_rel):
                rb.tp = types.SimpleNamespace(f=tp.f, size=tp.size, rank=0)
        ranks.append((m, tp))
    dec_in = shift_right(labels, cfg.pad_id)

    def body(r):
        m, tp = ranks[r]
        with torch.no_grad():
            lg = m(src, dec_in)
            return lg, _token_loss(lg, labels, cfg.pad_id, tp)

    out = _run_virtual(mp_, body, vset.lock, [vset])
    return torch.cat([lg for lg, _ in out], -1), [float(x) for _, x in out]


def phase_t5_virtual(dev):
    """(b) T5-small, its bias tables redrawn at ``T5_TABLE_STD`` and its
    query projections at the original T5 init, split over 2 and 4
    virtual ranks on the one card (``t5_virtual_logits``) against
    its dense forward, at phase 15's batch. The bound is derived on the
    card as phase 13 (b) derives its own: twice the dense bf16 forward's
    largest logit error against the same weights run in fp32. Every
    virtual rank's loss equals the others' and is within rtol 1e-5 of the
    loss over the logits concatenated. The planted bias-slice fault must
    leave the logits' bound. Counts the flash kernels' launches on each
    virtual forward (none: T5's attention is dense)."""
    import numpy as np
    import torch
    from horovod_tpu_torch.models import get_model
    from horovod_tpu_torch.models.t5 import (T5Attention, _token_loss,
                                             shift_right)
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    g = torch.Generator(device=dev).manual_seed(15)
    with torch.device(dev):
        model = get_model("t5_small", generator=g)
    cfg = model.cfg
    with torch.no_grad():
        for rb in (model.enc_rel, model.dec_rel):
            rb.rel_bias.normal_(0.0, T5_TABLE_STD, generator=g)
        for m in model.modules():
            if isinstance(m, T5Attention):
                m.q.weight.normal_(0.0, (cfg.d_model * cfg.head_dim) ** -0.5,
                                   generator=g)
    rng = np.random.default_rng(15)
    b, t = 16, 512
    src = t5_source(torch.tensor(rng.integers(1, cfg.vocab_size, (b, t)),
                                 device=dev), cfg.pad_id)
    labels = torch.tensor(rng.integers(1, cfg.vocab_size, (b, t)),
                          device=dev)
    dec_in = shift_right(labels, cfg.pad_id)
    with torch.no_grad():
        dense = model(src, dec_in)
        with torch.device(dev):
            ref = get_model("t5_small", dtype=torch.float32, generator=g)
        ref.load_state_dict(model.state_dict())
        exact = ref(src, dec_in)
        del ref
    dense_err = _err(dense, exact)
    tol = 2 * dense_err
    rms = float(exact.pow(2).mean().sqrt())
    log(f"phase 15 (b): the dense bf16 forward's largest logit error "
        f"against the fp32 forward is {dense_err:.4e} (the fp32 logits' "
        f"rms {rms:.4e}); bound on a tensor-parallel forward's error "
        f"against either: {tol:.4e}")
    out, launches = {"dense_err_vs_fp32": dense_err, "bound": tol,
                     "logits_rms": rms}, {}
    for n in (2, 4):
        fa.reset_launches()
        t0 = time.perf_counter()
        got, losses = t5_virtual_logits(model, src, labels, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[f"t5_small_tp_virtual_mp{n}"] = dict(fa.launches)
        if any(fa.launches.values()):
            fail(f"phase 15 (c): {n} virtual T5 ranks launched "
                 f"{fa.launches}; T5's attention is dense")
        e_dense, e_exact = _err(got, dense), _err(got, exact)
        with torch.no_grad():
            whole = float(_token_loss(got, labels, cfg.pad_id))
        out[f"mp{n}"] = {"max_abs_err_vs_dense": e_dense,
                         "max_abs_err_vs_fp32": e_exact, "wall_s": wall,
                         "loss": losses[0], "loss_on_logits": whole}
        log(f"phase 15 (b): {n} virtual ranks: logits within {e_dense:.4e} "
            f"of the dense forward's and {e_exact:.4e} of the fp32 "
            f"forward's (bound {tol:.4e}); vocab-parallel seq2seq loss "
            f"{losses[0]!r} on every rank, on the whole logits {whole!r}; "
            f"flash launches {fa.launches}; {wall:.2f} s")
        if not (e_dense <= tol and e_exact <= tol):
            fail(f"phase 15 (b): {n} virtual ranks leave the bound {tol}: "
                 f"{e_dense} against the dense forward, {e_exact} against "
                 f"fp32")
        if len(set(losses)) != 1 or not math.isclose(
                losses[0], whole, rel_tol=1e-5, abs_tol=0.0):
            fail(f"phase 15 (b): the vocab-parallel losses {losses} at {n} "
                 f"ranks are not seq2seq_loss's {whole} (rtol 1e-5)")
        del got
        bad = _err(t5_virtual_logits(model, src, labels, n, True)[0], dense)
        out[f"mp{n}"]["planted_bias_slice"] = bad
        log(f"phase 15 (b): planted bias slice (heads [0, H/mp) on every "
            f"rank) at {n} ranks: {bad:.4e} from the dense forward")
        if not bad > tol:
            fail(f"phase 15 (b): the planted bias slice at {n} ranks passed "
                 f"the check ({bad} <= {tol})")
    del model, dense, exact
    torch.cuda.empty_cache()
    return out, launches


def phase_t5_tp(card):
    """Phase 15 on a new one-rank NCCL world: (a) the plain T5 trainer and
    T5-small through ``mp.tensor_parallel`` at mp 1 with
    ``DistributedOptimizer`` over the dp set, 5 steps each on the padded
    batch, losses bit for bit; (b) ``phase_t5_virtual``; (c) no flash
    kernel launches on any of them."""
    import torch
    import horovod_tpu_torch as hvd
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    dev = hvd.device()
    t0 = time.perf_counter()
    plain = phase_train_path("t5_small_padded", card, dev)
    a = phase_train_path("t5_small_tp", card, dev)
    if a["losses"] != plain["losses"]:
        fail(f"phase 15 (a): tensor-parallel T5 losses at mp 1 "
             f"{a['losses']} are not the plain trainer's "
             f"{plain['losses']} bit for bit")
    launches = {"t5_small_padded": plain.pop("launches"),
                "t5_small_tp": a.pop("launches")}
    if any(n for k in launches.values() for n in k.values()):
        fail(f"phase 15 (c): the T5 paths launched {launches}")
    log(f"phase 15 (a): T5-small through tensor_parallel at mp 1: losses "
        f"equal the plain trainer's bit for bit; {a['step_ms_median']:.1f} "
        f"ms a step (plain: {plain['step_ms_median']:.1f}), peak "
        f"{a['peak_gib']:.2f} GiB (plain: {plain['peak_gib']:.2f})")
    b, virt = phase_t5_virtual(dev)
    launches.update(virt)
    hvd.shutdown()
    torch.cuda.synchronize()
    log(f"phase 15: {time.perf_counter() - t0:.1f} s")
    return {"plain": plain, "train_mp1": a, "virtual": b,
            "launches": launches}


# ---------------------------------------------------------------- phase 16

# Phase 16's staged runs of GPT-2 medium over virtual pp ranks: (a) GPipe,
# 4 stages, 4 microbatches of 2 x 1024; (b) GPipe and 1F1B, 4 stages, M 12
# = 4(S - 1) microbatches of 1 x 1024; (c) 1F1B over pp 2 x tp 2, (a)'s
# microbatches; (d) interleaved GPipe as (a); (e) interleaved 1F1B and
# GPipe as (b); (f) interleaved 1F1B as (c); the interleaved ones at
# PP_ROUNDS rounds a rank.
PP_RUNS = {"a": dict(pp=4, tp=1, m=4, mb=2), "b": dict(pp=4, tp=1, m=12, mb=1),
           "c": dict(pp=2, tp=2, m=4, mb=2)}
PP_ROUNDS = 2
# A planted fault must leave its bound by more than this factor.
PP_FAULT_FACTOR = 5.0
# The kernels' shapes in phase 16 (T 1024, d 64, causal, bf16): (b)'s and
# (e)'s microbatch of 1 x 16 heads, (c)'s and (f)'s of 2 x 8 local heads at
# tp 2 (both B*H 16), and (a)'s and (d)'s of 2 x 16 heads (B*H 32).
PP_SHAPES = {"gpt2_medium_pp_mb1": dict(b=1, h=16, t=1024),
             "gpt2_medium_pp2_tp2_mb2": dict(b=2, h=8, t=1024),
             "gpt2_medium_pp_mb2": dict(b=2, h=16, t=1024)}


def phase_pp_kernels():
    """K1-K3 against their plain versions at PP_SHAPES, then their times,
    bounds, plain times and SDPA with the same mask: {path: {kernel:
    numbers}}."""
    import torch
    out = {}
    for path, c in PP_SHAPES.items():
        b, h, t = c["b"], c["h"], c["t"]
        log(f"path {path}: B {b} H {h} (B*H {b * h}) T {t} d 64 bf16 "
            f"causal")
        errs, case, outs = compare_kernels(
            _path_inputs(b, h, t, True, h, False, seed=t + b * h + 16), b, h,
            64, True, 0, BF16_TOL)
        del outs
        out[path] = shape_report(case, errs, b, h, t, True)
        del case
        torch.cuda.empty_cache()
    return out


class _VirtualLines:
    """Factory of the line transport of ``n`` virtual pp ranks on one card
    (a ``_VirtualSet``): each tick's sends are left in a mailbox, the
    stages meet, each takes what its neighbours sent it, and they meet
    again; the sum over the line is the set's reduction. The box holds a
    queue per (sender, receiver): a pair's k-th send meets its k-th
    receive, as NCCL matches a pair's point-to-point operations in the
    order they are posted (at S = 2 both of a tick's hops go to one peer).
    The line's posting order is the port's (``Line._posts``)."""

    def __init__(self, n, lock):
        self.vset, self.box = _VirtualSet(n, lock), {}

    def line(self, r, wrap=False, stale=None, swap=False):
        """Rank ``r``'s line, wrapped into a ring when ``wrap``. Planted
        faults: ``stale`` "every" makes each forward hop deliver the
        previous microbatch's activation, "wrap" only the hop from the last
        stage to stage 0; ``swap`` makes this rank post its backward hops
        before its forward ones."""
        import torch.distributed as dist
        from horovod_tpu_torch.parallel.pipeline import Line
        vset, box, n = self.vset, self.box, self.vset.n

        class VirtualLine(Line):
            def __init__(self):
                self.n, self.rank, self.wrap = n, r, wrap
                self.prev = (r - 1) % n if wrap or r > 0 else None
                self.next = (r + 1) % n if wrap or r < n - 1 else None
                self.held = None

            def _posts(self, *args):
                posts = super()._posts(*args)
                if swap:
                    posts.sort(key=lambda p: (p[0] is not dist.isend,
                                              p[3] == "fwd"))
                return posts

            def _run(self, posts):
                for op, t, peer, _ in posts:
                    if op is dist.isend:
                        box.setdefault((r, peer), []).append(t)
                vset._meet()
                got = {way: box[(peer, r)].pop(0)
                       for op, _, peer, way in posts if op is dist.irecv}
                vset._meet()
                got_f = got.get("fwd")
                if got_f is not None and (stale == "every" or (
                        stale == "wrap" and r == 0)):
                    got_f, self.held = (got_f if self.held is None
                                        else self.held), got_f
                return got_f, got.get("bwd")

            def psum(self, x):
                return vset.reduce(r, x, sum)

        return VirtualLine()


def _virtual_tp_train(vset, r, with_f=True):
    """Rank ``r`` of ``vset`` as a ``mp.TensorParallel`` for training: f
    the identity forward and the sum over the virtual ranks backward, g
    the sum forward and the identity backward (Megatron's pair); without
    ``with_f`` f is the identity both ways (a planted fault)."""
    import torch
    from horovod_tpu_torch.parallel import mp

    class F(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return vset.reduce(r, g, sum)

    class G(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return vset.reduce(r, x, sum)

        @staticmethod
        def backward(ctx, g):
            return g

    class VirtualTP(mp.TensorParallel):
        def __init__(self):
            self.process_set, self.size, self.rank = vset, vset.n, r
            self.f = F.apply if with_f else (lambda x: x)
            self.g = G.apply

    return VirtualTP()


def staged_gpt2(model, tokens, pp, tp=1, schedule="gpipe", fault=None):
    """GPT-2 ``model`` trained one step staged over ``pp`` x ``tp`` virtual
    ranks on one card: each rank a thread (``_run_virtual``) that runs the
    port's ``gpt2_pipeline`` step on its block of ``make_pp_tp_params``'
    stack under ``block_specs_tp`` (``stack_block_params``' under
    ``P("pp")`` at tp 1; their ``_interleaved`` forms at ``PP_ROUNDS``
    rounds and ``extra_dims=1`` for the interleaved schedules), the block
    ``shard_pytree``'s ``_local_block`` gives the rank at its coordinates
    on a (pp, tp) ``Mesh``, the hops through ``_VirtualLines`` (wrapped
    for the interleaved schedules) and tp's f and g through
    ``_virtual_tp_train``; the backward runs on each rank's thread
    (``set_multithreading_enabled(False)``). ``tokens``: (M, mb, T);
    ``schedule``: "gpipe", "1f1b", "interleaved_gpipe" or
    "interleaved_1f1b". Returns (loss, {name: gradient} in the model's
    layout, each rank's peak microbatches in flight under a 1F1B).
    ``fault``: "stale_hop" (every forward hop), "stale_wrap" (the hop from
    the last stage to stage 0), "swap" (stage 1 posts backward before
    forward) or "no_f"."""
    import threading
    import numpy as np
    import torch
    from horovod_tpu_torch.models import gpt2_pipeline as gp
    from horovod_tpu_torch.parallel.mesh import Mesh
    from horovod_tpu_torch.parallel.sharding import (P, PartitionRules,
                                                     _local_block)
    cfg = model.cfg
    rounds = PP_ROUNDS if schedule.startswith("interleaved") else None
    extra = 0 if rounds is None else 1
    state = {k: v.detach() for k, v in model.state_dict().items()}
    if tp > 1:
        blocks, rest = (gp.make_pp_tp_params(state, pp, cfg.num_heads)
                        if rounds is None else
                        gp.make_pp_tp_params_interleaved(state, pp, rounds,
                                                         cfg.num_heads))
    else:
        blocks, rest = (gp.stack_block_params(state, pp) if rounds is None
                        else gp.stack_block_params_interleaved(state, pp,
                                                               rounds))
    del state
    mesh = Mesh(np.arange(pp * tp).reshape(pp, tp), ("pp", "tp"))
    rules = (gp.block_specs_tp(extra_dims=extra) if tp > 1
             else PartitionRules([(r"", P("pp"))]))
    lock = threading.Lock()
    lines = [_VirtualLines(pp, lock) for _ in range(tp)]
    tps = [_VirtualSet(tp, lock) for _ in range(pp)]
    n = pp * tp
    steps = {  # schedule: (the pp step, the pp x tp step)
        "gpipe": (gp.gpt2_pp_loss_and_grad, gp.gpt2_pp_tp_loss_and_grad),
        "1f1b": (gp.gpt2_pp_1f1b_loss_and_grad,
                 gp.gpt2_pp_tp_1f1b_loss_and_grad),
        "interleaved_gpipe": (gp.gpt2_pp_loss_and_grad_interleaved,
                              gp.gpt2_pp_tp_loss_and_grad_interleaved),
        "interleaved_1f1b": (
            lambda c, line: gp.gpt2_pp_interleaved_1f1b_loss_and_grad(
                c, rounds, line),
            lambda c, line, t: gp.gpt2_pp_tp_interleaved_1f1b_loss_and_grad(
                c, rounds, line, t))}[schedule]
    ranks = []
    for r in range(n):
        coords = mesh.coords(r)
        line = lines[coords["tp"]].line(
            coords["pp"], wrap=rounds is not None,
            stale={"stale_hop": "every", "stale_wrap": "wrap"}.get(fault),
            swap=fault == "swap" and coords["pp"] == 1)
        local = {k: _local_block(v, rules.spec_for(k), mesh, coords)
                 for k, v in blocks.items()}
        if tp > 1:
            tpr = _virtual_tp_train(tps[coords["pp"]], coords["tp"],
                                    with_f=fault != "no_f")
            step = steps[1](cfg, line, tpr)
        else:
            step = steps[0](cfg, line)
        ranks.append((coords, local, step))
    # The ranks hold copies of their blocks: keep only the stack's shapes.
    shapes = {k: v.shape for k, v in blocks.items()}
    del blocks

    def body(r):
        coords, local, step = ranks[r]
        with torch.autograd.set_multithreading_enabled(False):
            loss, gb, gr = step(local, rest, tokens)
        core = getattr(step, "core", None)
        return coords, float(loss), gb, gr, (core.peak_in_flight if core
                                              else None)

    out = _run_virtual(n, body, lock, [ln.vset for ln in lines] + tps)
    losses = {x[1] for x in out}
    if len(losses) != 1:
        fail(f"phase 16: the virtual ranks' losses differ: {losses}")
    # The blocks' gradients back in the model's layout: each rank's block
    # where _local_block took it from (a stack of positions, sliced alike),
    # then layer (r·S + s)·K + k of an interleaved (S, R, K, ...) stack.
    whole = {}
    for k, shape in shapes.items():
        g = torch.empty(shape, dtype=out[0][2][k].dtype, device=tokens.device)
        at = torch.arange(g.numel(), dtype=torch.int32,
                          device=g.device).reshape(shape)
        for coords, _, gb, _, _ in out:
            where = _local_block(at, rules.spec_for(k), mesh, coords)
            g.view(-1)[where.reshape(-1).long()] = gb[k].reshape(-1)
        del at
        lead = 2 + extra
        g = (g if rounds is None else g.transpose(0, 1)).reshape(
            (-1,) + tuple(g.shape[lead:]))
        if k == "attn.qkv.weight":
            g = g.reshape(g.shape[0], -1, g.shape[-1])
        elif k == "attn.qkv.bias":
            g = g.reshape(g.shape[0], -1)
        elif k == "attn.out.weight":
            g = g.reshape(g.shape[:2] + (-1,))
        for i in range(g.shape[0]):
            whole[f"h.{i}.{k}"] = g[i]
    whole.update(out[0][3])
    for _, _, _, gr, _ in out[1:]:
        if fault is None and any(not torch.equal(gr[k], out[0][3][k])
                                 for k in gr):
            fail("phase 16: the rest gradients differ between virtual "
                 "ranks")
    return losses.pop(), whole, [x[4] for x in out]


def _unstaged_grads(model, tokens, full):
    """The unstaged model's loss and gradients over the (M, mb, T) tokens:
    the whole batch at once (``full``) or accumulated over the M
    microbatches, each loss divided by M."""
    from horovod_tpu_torch.models.gpt2 import loss_fn
    model.zero_grad(set_to_none=True)
    m = tokens.shape[0]
    if full:
        flat = tokens.reshape(-1, tokens.shape[-1])
        loss = loss_fn(model(flat), flat)
        loss.backward()
        loss = loss.item()
    else:
        loss = 0.0
        for i in range(m):
            li = loss_fn(model(tokens[i]), tokens[i]) / m
            li.backward()
            loss += li.item()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss, grads


def _grad_gap(got, want):
    """(the largest relative error ||got - want|| / ||want|| over the
    tensors, its tensor's name); a NaN counts as infinite."""
    worst = (-1.0, None)
    for k, w in want.items():
        w = w.float()
        e = float((got[k].float() - w).norm() / w.norm().clamp_min(1e-30))
        e = math.inf if math.isnan(e) else e
        if e > worst[0]:
            worst = (e, k)
    return worst


def _pp_tokens(run, vocab, dev):
    import numpy as np
    import torch
    c = PP_RUNS[run]
    rng = np.random.default_rng(16)
    return torch.tensor(rng.integers(0, vocab, (c["m"], c["mb"], 1024)),
                        device=dev)


def phase_pipeline(card):
    """Phase 16: GPT-2 medium (24 layers, bf16, flash) staged over virtual
    pp ranks on the one card (``staged_gpt2``). The bounds are derived on
    the card from the unstaged model on the same weights and tokens:

    (a) GPipe over 4 stages, M 4 of 2 x 1024: the loss equal to the
    unstaged model's accumulated over the microbatches (rtol 1e-6), every
    gradient within twice the largest relative gap between that model's
    full-batch and accumulated gradients (the bound); a hop that delivers
    the previous microbatch's activation must leave it by more than
    ``PP_FAULT_FACTOR`` times. (b) GPipe and 1F1B over 4 stages at M 12 of
    1 x 1024: 1F1B's loss equal to GPipe's (rtol 1e-6) and its gradients
    within twice the full-batch / accumulated gap at M 12; its peak memory
    (above the allocation at its start, ``max_memory_allocated``) below
    GPipe's; stage s holds at most min(2(S - 1 - s) + 1, M) microbatches.
    (c) 1F1B over pp 2 x tp 2 at (a)'s M and tokens: the gradients within
    twice the gap between the unstaged bf16 gradients and the fp32 ones
    (tp rounds each partial product to bf16 before its sum, as phase 13
    (b)'s bound allows for), the loss within twice the relative gap
    between the unstaged bf16 and fp32 accumulated losses of the bf16 one;
    a stage body without f must leave the bound by more than
    ``PP_FAULT_FACTOR`` times. The interleaved schedules at ``PP_ROUNDS``
    rounds: (d) interleaved GPipe as (a), with (a)'s bars, and a stale
    wrap hop (stage 3 -> 0) outside by more than the factor; (e)
    interleaved 1F1B and GPipe (three chunks of 4) as (b), with (b)'s
    bars, 1F1B's peak memory below interleaved GPipe's and each stage's
    peak in flight its row's live peak in the port's schedule tables; (f)
    interleaved 1F1B as (c), with (c)'s bars and that check of the stash,
    and stage 1 posting its backward hops first outside by more than the
    factor. K1, K2 and K3 launch 24 x M times a run, summed over the
    stages, per tp rank in (c) and (f); before the runs they are held
    against their plain versions at ``PP_SHAPES`` and timed there."""
    import torch
    from horovod_tpu_torch.models import get_model
    from horovod_tpu_torch.parallel.schedule_sim import build_interleaved_1f1b
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    kernels = phase_pp_kernels()
    model = _gpt2_medium(dev)
    cfg = model.cfg
    L = cfg.num_layers
    out, launches = {}, {}

    def staged(tag, tokens, pp, tp=1, schedule="gpipe", fault=None):
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t1 = time.perf_counter()
        loss, grads, flight = staged_gpt2(model, tokens, pp, tp, schedule,
                                          fault)
        torch.cuda.synchronize()
        run = {"loss": loss, "wall_s": time.perf_counter() - t1,
               "peak_gib_above_start": (torch.cuda.max_memory_allocated()
                                        - start) / 2 ** 30,
               "launches": dict(fa.launches)}
        if flight[0] is not None:
            run["in_flight"] = flight
        if fault is None:
            want = {k: L * tokens.shape[0] * tp for k in fa.KERNELS}
            if run["launches"] != want:
                fail(f"phase 16 {tag}: launches {run['launches']}, want "
                     f"{want}")
            launches[tag] = run["launches"]
        log(f"phase 16 {tag}: loss {loss!r}, {run['wall_s']:.2f} s wall, "
            f"peak {run['peak_gib_above_start']:.2f} GiB above its start, "
            f"launches {run['launches']}"
            + (f", in flight {flight}" if flight[0] is not None else ""))
        return run, grads

    def check(tag, run, grads, want, bound, fault=False):
        gap, name = _grad_gap(grads, want)
        run["grad_gap"], run["grad_gap_at"], run["bound"] = gap, name, bound
        log(f"phase 16 {tag}: largest relative gradient gap {gap:.4e} "
            f"({name}), bound {bound:.4e}")
        if fault and not gap > PP_FAULT_FACTOR * bound:
            fail(f"phase 16 {tag}: the planted fault passed ({gap} <= "
                 f"{PP_FAULT_FACTOR} x {bound})")
        if not fault and not gap <= bound:
            fail(f"phase 16 {tag}: gradients leave the bound ({gap} > "
                 f"{bound}, {name})")

    def in_flight_bound(run, tag, S, tp, M):
        # Stage s's row of the interleaved 1F1B tables: its live peak.
        peaks = build_interleaved_1f1b(S, PP_ROUNDS, M).live_peaks()
        want = [peaks[r // tp] for r in range(S * tp)]
        run["in_flight_bound"] = want
        if run["in_flight"] != want:
            fail(f"phase 16 ({tag}): ranks held {run['in_flight']} "
                 f"microbatches at most, the tables' peaks are {want}")

    # (a) GPipe, 4 stages, M 4 x 2 x 1024.
    tok_a = _pp_tokens("a", cfg.vocab_size, dev)
    loss_full, g_full = _unstaged_grads(model, tok_a, True)
    loss_acc, g_acc = _unstaged_grads(model, tok_a, False)
    gap, name = _grad_gap(g_full, g_acc)
    bound_a = 2 * gap
    log(f"phase 16 (a): the unstaged model's full-batch and accumulated "
        f"gradients differ by {gap:.4e} at most ({name}); bound "
        f"{bound_a:.4e}; losses {loss_full!r} / {loss_acc!r}")
    del g_full
    a, g = staged("gpt2_medium_pp4_gpipe", tok_a, 4)
    check("(a)", a, g, g_acc, bound_a)
    a["loss_unstaged_accumulated"] = loss_acc
    if not math.isclose(a["loss"], loss_acc, rel_tol=1e-6):
        fail(f"phase 16 (a): the staged loss {a['loss']} is not the "
             f"accumulated {loss_acc} (rtol 1e-6)")
    bad, g = staged("(a) planted stale hop", tok_a, 4, fault="stale_hop")
    check("(a) planted stale hop", bad, g, g_acc, bound_a, fault=True)
    a["planted_stale_hop"] = bad
    out["a"] = a
    del g

    # (d) Interleaved GPipe, 4 stages x 2 rounds, (a)'s tokens and bars.
    dd, g = staged("gpt2_medium_pp4x2_interleaved_gpipe", tok_a, 4,
                   schedule="interleaved_gpipe")
    check("(d)", dd, g, g_acc, bound_a)
    dd["loss_unstaged_accumulated"] = loss_acc
    if not math.isclose(dd["loss"], loss_acc, rel_tol=1e-6):
        fail(f"phase 16 (d): the interleaved loss {dd['loss']} is not the "
             f"accumulated {loss_acc} (rtol 1e-6)")
    bad, g = staged("(d) planted stale wrap hop", tok_a, 4,
                    schedule="interleaved_gpipe", fault="stale_wrap")
    check("(d) planted stale wrap hop", bad, g, g_acc, bound_a, fault=True)
    dd["planted_stale_wrap_hop"] = bad
    out["d"] = dd
    del g

    # (c) 1F1B over pp 2 x tp 2 on (a)'s tokens, against (a)'s yardstick.
    with torch.device(dev):
        ref = get_model("gpt2_medium", attention="dense",
                        dtype=torch.float32,
                        generator=torch.Generator(device=dev).manual_seed(0))
    ref.load_state_dict(model.state_dict())
    loss32, g32 = _unstaged_grads(ref, tok_a, False)
    del ref
    gap, name = _grad_gap(g_acc, g32)
    bound_c = 2 * gap
    loss_bound_c = 2 * abs(loss_acc - loss32) / abs(loss_acc)
    del g32
    log(f"phase 16 (c): the unstaged bf16 gradients differ from fp32's by "
        f"{gap:.4e} at most ({name}); bound {bound_c:.4e}; the bf16 loss "
        f"{loss_acc!r}, fp32's {loss32!r}: loss bound {loss_bound_c:.4e} "
        f"relative")
    c, g = staged("gpt2_medium_pp2_tp2_1f1b", tok_a, 2, 2, "1f1b")
    check("(c)", c, g, g_acc, bound_c)
    c["gap_over_bound_a"] = c["grad_gap"] / bound_a
    c["loss_fp32"], c["loss_unstaged_accumulated"] = loss32, loss_acc
    c["loss_gap"] = abs(c["loss"] - loss_acc) / abs(loss_acc)
    c["loss_bound"] = loss_bound_c
    log(f"phase 16 (c): loss gap {c['loss_gap']:.4e} relative, bound "
        f"{loss_bound_c:.4e}")
    if not c["loss_gap"] <= loss_bound_c:
        fail(f"phase 16 (c): the loss {c['loss']} is not the accumulated "
             f"{loss_acc} (relative gap {c['loss_gap']} > {loss_bound_c})")
    bad, g = staged("(c) planted no f", tok_a, 2, 2, "1f1b", fault="no_f")
    check("(c) planted no f", bad, g, g_acc, bound_c, fault=True)
    c["planted_no_f"] = bad
    out["c"] = c
    del g

    # (f) Interleaved 1F1B over pp 2 x tp 2, 2 rounds, (c)'s bars.
    f, g = staged("gpt2_medium_pp2x2_tp2_interleaved_1f1b", tok_a, 2, 2,
                  "interleaved_1f1b")
    check("(f)", f, g, g_acc, bound_c)
    f["loss_gap"] = abs(f["loss"] - loss_acc) / abs(loss_acc)
    f["loss_bound"] = loss_bound_c
    if not f["loss_gap"] <= loss_bound_c:
        fail(f"phase 16 (f): the loss {f['loss']} is not the accumulated "
             f"{loss_acc} (relative gap {f['loss_gap']} > {loss_bound_c})")
    in_flight_bound(f, "f", 2, 2, tok_a.shape[0])
    bad, g = staged("(f) planted swapped posting order", tok_a, 2, 2,
                    "interleaved_1f1b", fault="swap")
    check("(f) planted swapped posting order", bad, g, g_acc, bound_c,
          fault=True)
    f["planted_swapped_posting_order"] = bad
    out["f"] = f
    del g, g_acc

    # (b) GPipe and 1F1B, 4 stages, M 12 x 1 x 1024.
    tok_b = _pp_tokens("b", cfg.vocab_size, dev)
    _, g_full = _unstaged_grads(model, tok_b, True)
    _, g_acc = _unstaged_grads(model, tok_b, False)
    gap, name = _grad_gap(g_full, g_acc)
    bound_b = 2 * gap
    del g_full, g_acc
    log(f"phase 16 (b): at M 12 the full-batch and accumulated gradients "
        f"differ by {gap:.4e} at most ({name}); bound {bound_b:.4e}")
    gpipe, g_gpipe = staged("gpt2_medium_pp4_gpipe_m12", tok_b, 4)
    f1b, g = staged("gpt2_medium_pp4_1f1b_m12", tok_b, 4, schedule="1f1b")
    check("(b)", f1b, g, g_gpipe, bound_b)
    del g
    if not math.isclose(f1b["loss"], gpipe["loss"], rel_tol=1e-6):
        fail(f"phase 16 (b): 1F1B's loss {f1b['loss']} is not GPipe's "
             f"{gpipe['loss']} (rtol 1e-6)")
    if not f1b["peak_gib_above_start"] < gpipe["peak_gib_above_start"]:
        fail(f"phase 16 (b): 1F1B's peak {f1b['peak_gib_above_start']} GiB "
             f"is not below GPipe's {gpipe['peak_gib_above_start']}")
    S, M = PP_RUNS["b"]["pp"], PP_RUNS["b"]["m"]
    want = [min(2 * (S - 1 - s) + 1, M) for s in range(S)]
    if f1b["in_flight"] != want:
        fail(f"phase 16 (b): stages held {f1b['in_flight']} microbatches "
             f"at most, want {want}")
    out["b"] = {"gpipe": gpipe, "1f1b": f1b}

    # (e) Interleaved GPipe (three chunks of 4) and 1F1B, 4 stages x 2
    # rounds, (b)'s tokens and bars.
    e = {}
    for name in ("interleaved_gpipe", "interleaved_1f1b"):
        run, g = staged(f"gpt2_medium_pp4x2_{name}_m12", tok_b, 4,
                        schedule=name)
        check(f"(e) {name}", run, g, g_gpipe, bound_b)
        del g
        if not math.isclose(run["loss"], gpipe["loss"], rel_tol=1e-6):
            fail(f"phase 16 (e): {name}'s loss {run['loss']} is not "
                 f"GPipe's {gpipe['loss']} (rtol 1e-6)")
        e[name] = run
    del g_gpipe
    i1f1b, igpipe = e["interleaved_1f1b"], e["interleaved_gpipe"]
    if not i1f1b["peak_gib_above_start"] < igpipe["peak_gib_above_start"]:
        fail(f"phase 16 (e): interleaved 1F1B's peak "
             f"{i1f1b['peak_gib_above_start']} GiB is not below interleaved "
             f"GPipe's {igpipe['peak_gib_above_start']}")
    in_flight_bound(i1f1b, "e", 4, 1, tok_b.shape[0])
    out["e"] = e
    del model
    torch.cuda.empty_cache()
    log(f"phase 16: {time.perf_counter() - t0:.1f} s")
    return {"runs": out, "launches": launches, "kernels": kernels}


# ---------------------------------------------------------------- phase 17

SCRAPE_PAUSE_S = 0.02    # the client's pause between two rounds of scrapes
SAMPLE_INTERVAL_S = 0.05  # LocalSampler's interval
# Points a series keeps: the default 256 hold 12.8 s at 0.05 s, less than
# the run with its model build, and the window's baseline must survive it.
SAMPLE_POINTS = 4096
LATE_MS = 50.0           # (d)'s planted delay
_PROM_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$')
_MERGE_GAUGE = 'horovod_tpu_overlap_efficiency_estimate{source="merge"}'


def _http(url, data=None, headers=None):
    """(status, body, ms) of one GET (or POST of ``data``); an HTTP error
    status is an answer, not an exception."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=data, headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, body, (time.perf_counter() - t0) * 1e3


def _prom_counters(text):
    """{(name, labels): value} of the counter-like samples (``_total``,
    ``_count``) of a text exposition; raises ValueError on a bad line."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            if not re.match(r"^# (HELP|TYPE) \S+ ", line):
                raise ValueError(f"bad comment line {line!r}")
            continue
        m = _PROM_SAMPLE.match(line)
        if m is None:
            raise ValueError(f"unparseable line {line!r}")
        value = float(m.group(3))
        if m.group(1).endswith(("_total", "_count")):
            out[(m.group(1), m.group(2) or "")] = value
    return out


def _json_counters(doc):
    return {(n, json.dumps(s["labels"], sort_keys=True)): s["value"]
            for n, series in doc["counters"].items() for s in series}


def _check_scrapes(scrapes):
    """Every scrape 200 and parsed, no counter series lower than in the
    scrape of the same route before it. Returns the routes' counts."""
    last = {"/metrics": {}, "/metrics.json": {}}
    for i, (path, code, body, _) in enumerate(scrapes):
        if code != 200:
            fail(f"phase 17 (a): scrape {i} of {path} answered {code}")
        try:
            if path == "/metrics":
                cur = _prom_counters(body.decode())
            else:
                doc = json.loads(body)
                cur = _json_counters(doc)
                for n, series in doc["histograms"].items():
                    for s in series:
                        if s["buckets"][-1][1] != s["count"]:
                            fail(f"phase 17 (a): scrape {i}: histogram {n} "
                                 f"count {s['count']} against its +Inf "
                                 f"bucket {s['buckets'][-1][1]}")
        except ValueError as e:
            fail(f"phase 17 (a): scrape {i} of {path} does not parse: {e}")
        back = [(k, last[path][k], v) for k, v in cur.items()
                if v < last[path].get(k, 0)]
        if back:
            fail(f"phase 17 (a): counters went backwards at scrape {i} of "
                 f"{path}: {back[:5]}")
        last[path] = cur
    return {p: sum(1 for s in scrapes if s[0] == p) for p in last}


def phase_observability(card, main_path, controller):
    """Phase 17: the host observability plane around phase 3's GPT-2
    medium on a new one-rank NCCL world: (a) scraped training, (b) the time
    series, (c) the merge of its shard, (d) with two cards a merged
    two-rank world with a planted late rank."""
    import os
    import tempfile
    import threading
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics, timeseries
    from horovod_tpu_torch.config import get_config
    from horovod_tpu_torch.trace_merge import merge_timelines
    t_phase = time.perf_counter()
    if main_path is None:
        main_path = phase_main_path(card)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase17_")
    trace_path = os.path.join(tmp, "trace.json")
    hvd.start_timeline(trace_path)
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    srv = hvd.metrics_http(0)
    store = timeseries.TimeSeriesStore(max_points=SAMPLE_POINTS)
    sampler = timeseries.LocalSampler(store, interval_s=SAMPLE_INTERVAL_S)
    scrapes, errors, stop = [], [], threading.Event()

    def client():
        while not stop.is_set():
            for path in ("/metrics", "/metrics.json"):
                try:
                    scrapes.append((path,) + _http(srv.url + path))
                except Exception as e:      # reported below, then fail
                    errors.append(f"{path}: {e!r}")
            stop.wait(SCRAPE_PAUSE_S)

    # (a) scraped training
    before = metrics.snapshot()
    t_start = time.time()
    sampler.sample_once(ts=t_start)
    sampler.start()
    scraper = threading.Thread(target=client, name="phase17-scraper",
                               daemon=True)
    scraper.start()
    try:
        run = phase_train_path("gpt2_medium", card, hvd.device())
    finally:
        stop.set()
        scraper.join(timeout=60)
    t_end = time.time()
    sampler.sample_once(ts=t_end)
    after = metrics.snapshot()
    if errors:
        fail(f"phase 17 (a): scrapes raised: {errors[:5]}")
    counts = _check_scrapes(scrapes)
    if min(counts.values()) < 2:
        fail(f"phase 17 (a): too few scrapes during the run: {counts}")
    steps = len(run["losses"])
    diffs = [abs(a - b) for a, b in zip(run["losses"], main_path["losses"])]
    if len(diffs) != steps or max(diffs) > LOSS_TOL:
        fail(f"phase 17 (a): losses {run['losses']} differ from phase 3's "
             f"{main_path['losses']} by up to {max(diffs):.3e} (limit "
             f"{LOSS_TOL})")
    prom = _http(srv.url + "/metrics")
    js = _http(srv.url + "/metrics.json")
    if prom[:2] != (200, metrics.to_prometheus().encode("utf-8")):
        fail("phase 17 (a): /metrics after the steps is not to_prometheus()")
    got, want = json.loads(js[1]), json.loads(metrics.to_json())
    got.pop("timestamp")
    want.pop("timestamp")
    if js[0] != 200 or got != want:
        fail("phase 17 (a): /metrics.json after the steps is not to_json()")
    token = bool(get_config().serve_auth_token)
    from horovod_tpu_torch import confbus
    routes = {
        "/trace": (200, {"traceEvents": [], "displayTimeUnit": "ms"}),
        "/healthz": (200, {"status": "ok", "ok": True, "alerts": []}),
        "/config": (200, json.loads(json.dumps(confbus.config_view(),
                                               default=str))),
    }
    for path, want_route in routes.items():
        code, body, _ = _http(srv.url + path)
        if (code, json.loads(body)) != want_route:
            fail(f"phase 17 (a): {path} answered {code} {body[:200]!r}, "
                 f"not {str(want_route)[:200]}")
    code, body, _ = _http(srv.url + "/doctor")
    doctor_now = json.loads(json.dumps(hvd.doctor(), default=str))
    if code != 200 or json.loads(body)["findings"] != \
            doctor_now["findings"]:
        fail(f"phase 17 (a): /doctor answered {code} {body[:200]!r}, not "
             f"hvd.doctor()'s report")
    if _http(srv.url + "/no/such/route")[0] != 404:
        fail("phase 17 (a): an unknown path did not answer 404")
    code, body, _ = _http(srv.url + "/config", data=b'{"name": "x"}')
    if code != (401 if token else 403):
        fail(f"phase 17 (a): POST /config answered {code} {body[:200]!r}")
    ms = sorted(s[3] for s in scrapes)
    scrape = {"scrapes": len(scrapes), "by_route": counts,
              "median_ms": statistics.median(ms), "max_ms": ms[-1]}
    p6 = controller["step_ms_median"] if controller else None
    log(f"phase 17 (a): GPT-2 medium scraped every "
        f"{SCRAPE_PAUSE_S * 1e3:.0f} ms and sampled every "
        f"{SAMPLE_INTERVAL_S * 1e3:.0f} ms: losses within {max(diffs):.3e} "
        f"of phase 3's; step {run['step_ms_median']:.2f} ms median against "
        f"phase 3's {main_path['step_ms_median']:.2f} and phase 6's "
        f"{'not run' if p6 is None else f'{p6:.2f}'}; {len(scrapes)} "
        f"scrapes ({counts}), every one 200, parsed, no counter backwards, "
        f"{scrape['median_ms']:.2f} ms median, {scrape['max_ms']:.2f} ms max "
        f"(host clock); /trace and /healthz the reference's fallbacks, "
        f"/config the config bus's view, /doctor "
        f"200 with hvd.doctor()'s {len(doctor_now['findings'])} findings, "
        f"POST /config {401 if token else 403}; on {card}")

    # (b) the time series
    window = t_end - t_start
    grew = (_counter(after, "collective_calls_total", kind="allreduce")
            - _counter(before, "collective_calls_total", kind="allreduce"))
    delta = store.delta("collective_calls_total", window,
                        labels={"kind": "allreduce"}, now=t_end)
    rate = store.rate("collective_calls_total", window,
                      labels={"kind": "allreduce"}, now=t_end)
    snap = store.window_snapshot(window, now=t_end)
    in_window = [s["value"] for s in snap["counters"].get(
        "collective_calls_total", []) if s["labels"].get("kind") ==
        "allreduce"]
    points = max(len(p) for p in store._points(
        "counter", "collective_calls_total", {"kind": "allreduce"}))
    if points < 3:
        fail(f"phase 17 (b): the sampler added no point during the run "
             f"({points} points)")
    if not delta == grew == steps:
        fail(f"phase 17 (b): delta {delta} of collective_calls_total "
             f"{{kind=allreduce}} against the snapshots' growth {grew} and "
             f"the {steps} steps")
    if abs(rate * window - delta) > 1e-9 * max(1.0, delta):
        fail(f"phase 17 (b): rate {rate} is not delta {delta} over "
             f"{window} s")
    if set(snap) != {"counters", "gauges", "histograms",
                     "pending_collectives", "window_seconds", "timestamp"} \
            or in_window != [float(steps)] or \
            snap["window_seconds"] != window:
        fail(f"phase 17 (b): window_snapshot is not the reference's doctor "
             f"shape: keys {sorted(snap)}, allreduces {in_window}")
    sampler.stop()
    t0 = time.perf_counter()
    for _ in range(20):
        sampler.sample_once()
    sample_ms = (time.perf_counter() - t0) / 20 * 1e3
    log(f"phase 17 (b): the store over the run's {window:.3f} s: delta "
        f"{delta} allreduces (snapshots {grew}), rate {rate:.4f}/s, "
        f"{points} points in the series, {store.series_count()} series, "
        f"window_snapshot of the doctor's shape; a sample takes "
        f"{sample_ms:.3f} ms (host clock, on {card})")

    # (c) the merge of (a)'s shard
    hvd.stop_timeline()
    with open(trace_path) as f:
        shard = [e for e in json.load(f)["traceEvents"]
                 if e.get("ph") != "M"]
    merged_path = os.path.join(tmp, "trace.merged.json")
    t0 = time.perf_counter()
    doc = merge_timelines(trace_path, merged_path, feed_metrics=True)
    merge_s = time.perf_counter() - t0
    with open(merged_path) as f:
        disk = json.load(f)          # valid JSON, or this raises
    rep = disk["stragglerReport"]
    names = [e["args"]["name"] for e in disk["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"]
    body = [e for e in disk["traceEvents"] if e.get("ph") != "M"]
    if names != ["rank 0"] or len(body) != len(shard) or \
            {e["pid"] for e in body} != {0}:
        fail(f"phase 17 (c): tracks {names}, {len(body)} events on pids "
             f"{sorted({e['pid'] for e in body})} for the shard's "
             f"{len(shard)}")

    def positive(e):
        op = (e.get("args") or {}).get("op_id")
        return isinstance(op, int) and op > 0

    execs = sum(1 for e in shard if e["name"] == "EXEC" and positive(e))
    markers = [e for e in shard if e["name"] == "allreduce_algorithm"]
    wire = (sum(s["value"] for s in after["counters"].get(
        "allreduce_wire_bytes_total", []))
        - sum(s["value"] for s in before["counters"].get(
            "allreduce_wire_bytes_total", [])))
    algs = rep["overlap"]["algorithms"]
    buckets = sum(a["buckets"] for a in algs.values())
    wire_merged = sum(a["wire_bytes"] for a in algs.values())
    if rep["overlap"]["by_rank"]["0"]["exec_spans"] != execs:
        fail(f"phase 17 (c): overlap exec_spans "
             f"{rep['overlap']['by_rank']['0']['exec_spans']} against the "
             f"shard's {execs} EXEC events with positive op ids")
    if buckets != len(markers) or wire_merged != wire or \
            wire_merged != sum(m["args"]["wire_bytes"] for m in markers):
        fail(f"phase 17 (c): algorithms {algs} against {len(markers)} "
             f"markers and allreduce_wire_bytes_total +{wire}")
    if buckets != steps * run["buckets_per_step"]:
        fail(f"phase 17 (c): {buckets} algorithm markers, not the "
             f"{steps} x {run['buckets_per_step']} buckets the steps issued")
    if rep["collectives"] or rep["ranks"] != [0]:
        fail(f"phase 17 (c): one rank, yet ranks {rep['ranks']} and "
             f"{len(rep['collectives'])} collectives in the straggler list")
    if doc != disk:
        fail("phase 17 (c): the returned document differs from the file")
    if _MERGE_GAUGE not in _http(srv.url + "/metrics")[1].decode():
        fail(f"phase 17 (c): {_MERGE_GAUGE} is not in the next scrape")
    merge = {"seconds": merge_s, "events": len(disk["traceEvents"]),
             "exec_spans": execs, "algorithm_markers": len(markers),
             "algorithms": algs,
             "overlap_efficiency": rep["overlap"]["overlap_efficiency"]}
    log(f"phase 17 (c): merged the shard in {merge_s:.4f} s (host clock, "
        f"on {card}), "
        f"{len(disk['traceEvents'])} events on one track 'rank 0', "
        f"{execs} EXEC spans, {len(markers)} allreduce_algorithm markers "
        f"({steps} steps x {run['buckets_per_step']} buckets: the port marks "
        f"every bucket it issues), wire bytes {wire_merged}, no collective "
        f"in the straggler list; overlap_efficiency "
        f"{merge['overlap_efficiency']} (an estimate from the host's issue "
        f"spans, not device overlap), and {_MERGE_GAUGE} in the next scrape")
    srv.stop()
    hvd.shutdown()
    torch.cuda.synchronize()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(("hvd-metrics-http", "hvd-ts-sampler"))]
    if left:
        fail(f"phase 17: threads still running after stop: {left}")

    # (d) two cards: a merged two-rank world with a planted late rank
    world = None
    if torch.cuda.device_count() >= 2:
        proc = subprocess.run(
            [sys.executable, "tools/torch_controller_bench.py", "--np", "2",
             "--late-rank", "1", "--late-ms", str(LATE_MS)],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"phase 17 (d): the two-rank world failed:\n"
                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        world = json.loads(proc.stdout.strip().splitlines()[-1])["merge"]
        log(f"phase 17 (d): two ranks merged, rank 1 planted {LATE_MS} ms "
            f"late: spread {world['planted_spread_seconds']:.6f} s, blame "
            f"{world['late_rank_blame_seconds']:.6f} s, the other ops "
            f"every rank issues in one order "
            f"{world['other_spreads_seconds']} s, the join scenario's "
            f"largest {world['scenario_spreads_max_seconds']} s, merge "
            f"{world['merge_seconds']:.4f} s of {world['events']} events "
            f"(host clock; cards of the kind of {card})")
    else:
        log("phase 17 (d): the merged two-rank world with a planted late "
            "rank did not run for want of a second card (cards: "
            f"{torch.cuda.device_count()})")
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s on {card}")
    return {"step_ms_median": run["step_ms_median"],
            "phase3_step_ms_median": main_path["step_ms_median"],
            "phase6_step_ms_median": p6, "losses": run["losses"],
            "max_loss_diff": max(diffs), "scrape": scrape,
            "timeseries": {"window_s": window, "delta": delta, "rate": rate,
                           "points": points, "sample_ms": sample_ms},
            "merge": merge, "two_rank_world": world,
            "launches": run["launches"]}


# ---------------------------------------------------------------- phase 18

PROFILE_SECONDS = 1.5     # (b)'s triggered capture
STALL_TIMEOUT_S = 0.2     # (b)'s watchdog, as phase 6's
PREEMPT_LIMIT_S = 60.0    # (b): a manual capture must stop a 600 s trigger
_FLASH_NAMES = {"flash_fwd": "flash_fwd_", "flash_bwd_dq": "flash_bwd_dq_",
                "flash_bwd_dkv": "flash_bwd_dkv_"}


def _trace_kernels(logdir):
    """Of the Chrome trace a capture wrote into ``logdir``: its device
    kernel events, the flash kernels' by kernel, the NCCL kernels', the
    host's NCCL allreduce ops (names holding "allreduce" or "all_reduce"
    outside the device rows), the trace's bytes and the session's window
    on the host's wall clock (ns since the epoch: Kineto's base time plus
    the session span's start and its "Record Window End")."""
    import glob
    import os
    paths = glob.glob(os.path.join(logdir, "trace.*.json"))
    if len(paths) != 1:
        fail(f"phase 18: capture {logdir} holds {paths}, not one trace")
    with open(paths[0]) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    spans = [e["ts"] for e in evs if e.get("cat") == "Trace"]
    ends = [e["ts"] for e in evs if e.get("name") == "Record Window End"]
    window = None
    if len(spans) == 1 and len(ends) == 1 and "baseTimeNanoseconds" in doc:
        window = tuple(doc["baseTimeNanoseconds"] + int(ts * 1e3)
                       for ts in (spans[0], ends[0]))
    kernels = [e["name"] for e in evs if e.get("cat") == "kernel"]
    flash = {k: sum(1 for n in kernels if pat in n)
             for k, pat in _FLASH_NAMES.items()}
    nccl = sum(1 for n in kernels if "nccl" in n.lower())
    host = [e["name"] for e in evs if e.get("cat") != "kernel" and any(
        w in str(e.get("name", "")).lower() for w in ("allreduce",
                                                      "all_reduce"))]
    return {"kernels": len(kernels), "flash": flash, "nccl": nccl,
            "nccl_host_ops": len(host), "nccl_host_names": sorted(set(host)),
            "bytes": os.path.getsize(paths[0]), "window_ns": window}


def _packed_capture_peak(dev, profiler, fa):
    """Phase 18 (a): GPT-2 medium's attention (B 8, T 1024, 16 heads, d 64,
    bf16), causal, packed four sequences a row with the last 64 keys
    padded, forward and backward, plain and then under a
    ``CostCapture``. The capture counts the masked, packed pairs from the
    (B, T) ids and bias on the host, so it must not raise the card's peak.
    Returns (peak bytes above the start of each call, the capture)."""
    import contextlib
    import torch
    b, t, h, d, segs, pad = 8, 1024, 16, 64, 4, 64
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(b, t, h, d, device=dev, generator=g)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    seg = (torch.arange(t, device=dev) // (t // segs)).repeat(b, 1)
    bias = torch.zeros(b, t, device=dev)
    bias[:, -pad:] = -1e30
    peaks = []
    for captured in (False, True):
        for x in (q, k, v):
            x.grad = None
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        m0 = torch.cuda.memory_allocated(dev)
        cap = profiler.CostCapture() if captured else contextlib.nullcontext()
        with cap:
            out = fa.flash_attention(q, k, v, causal=True, key_bias=bias,
                                     segment_ids=seg)
            out.float().sum().backward()
            del out
        torch.cuda.synchronize(dev)
        peaks.append(torch.cuda.max_memory_allocated(dev) - m0)
    # Each segment's causal triangle; the last segment's queries see no
    # padded key.
    n = t // segs
    last = sum(min(i, t - pad - 1) - (t - n) + 1 for i in range(t - n, t))
    pairs = b * h * ((segs - 1) * n * (n + 1) // 2 + last)
    want = {kern: fa.FLOPS_PER_PAIR[kern] * d * pairs for kern in fa.KERNELS}
    if peaks[0] != peaks[1] or cap.kernel_flops != want:
        fail(f"phase 18 (a): a packed, masked flash call peaked {peaks[0]} "
             f"bytes plain and {peaks[1]} under a cost capture (must be "
             f"equal); the capture counted {cap.kernel_flops}, not {want}")
    return peaks, cap


def phase_profiler(card, main_path):
    """Phase 18: the profiler and the doctor around phase 3's GPT-2 medium on
    a new one-rank NCCL world: (a) the instrumented step, (b) captures, (c)
    memory accounting, (d) the doctor. Without phase 3 it runs phase 3's
    path itself first."""
    import os
    import tempfile
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import config, metrics, profiler, timeseries
    from horovod_tpu_torch.models.gpt2 import loss_fn
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    t_phase = time.perf_counter()
    if main_path is None:
        main_path = phase_main_path(card)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase18_")
    trace_path = os.path.join(tmp, "trace.json")
    hvd.start_timeline(trace_path)
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    metrics.reset_metrics()
    profiler.registry.reset()
    store = timeseries.TimeSeriesStore(max_points=SAMPLE_POINTS)
    sampler = timeseries.LocalSampler(store)
    t_window = time.time()
    sampler.sample_once(ts=t_window)
    dev = hvd.device()
    model, opt, _, info = build_path("gpt2_medium", dev)
    cfg, tokens = model.cfg, info["inputs"]
    b, h, t, causal = info["attention"]
    hd = cfg.d_model // cfg.num_heads
    macs = _conv_macs(model, tokens)
    pairs = _visible_pairs(b * h, t, t, causal, 0, h) * cfg.num_layers
    dense = 6 * (macs + info["head_macs"])
    flops = 3 * (2 * (macs + info["head_macs"]) + 4 * hd * pairs)
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    from horovod_tpu_torch import fusion
    grads = [p for p in model.parameters() if p.requires_grad]
    buckets = len(fusion.make_plan(
        [p.numel() for p in grads], [p.dtype for p in grads],
        config.get_config().fusion_threshold_bytes).buckets)

    def train_step(tokens):
        opt.zero_grad()
        loss = loss_fn(model(tokens), tokens)
        loss.backward()
        opt.step()
        return loss

    step = profiler.instrument(train_step, name="gpt2_medium_train",
                               model_flops=flops, timed=True)

    # (a) the instrumented step
    torch.cuda.synchronize()
    # The phase's window over the peak: the capture reads the card's peak
    # before and after its call and never resets it.
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, ms = [], []
    for i in range(5):
        before = dict(fa.launches)
        t0 = time.perf_counter()
        loss = step(tokens)
        losses.append(loss.item())
        ms.append((time.perf_counter() - t0) * 1e3)
        grew = {k: fa.launches[k] - before[k] for k in fa.KERNELS}
        if grew != info["launches"]:
            fail(f"phase 18 (a): step {i} launched {grew}, not "
                 f"{info['launches']}")
    launches = dict(fa.launches)
    rec = step.record()
    cap = step.last_capture
    if losses != main_path["losses"]:
        fail(f"phase 18 (a): losses {losses} are not phase 3's "
             f"{main_path['losses']} bit for bit")
    if (rec.compiles, rec.recompiles, rec.steps) != (1, 0, 4):
        fail(f"phase 18 (a): compiles {rec.compiles}, recompiles "
             f"{rec.recompiles}, timed steps {rec.steps}; expected 1, 0, 4")
    want_kernels = {k: fa.FLOPS_PER_PAIR[k] * hd * pairs for k in fa.KERNELS}
    if cap.dense_flops != dense or cap.kernel_flops != want_kernels:
        fail(f"phase 18 (a): captured {cap.dense_flops} dense FLOPs and "
             f"{cap.kernel_flops} from the kernels; expected 6 x "
             f"(macs + head_macs) = {dense} and {want_kernels}")
    snap = metrics.snapshot()
    mfu = _gauge_value(snap, "program_mfu", program="gpt2_medium_train")
    hfu = _gauge_value(snap, "program_hfu", program="gpt2_medium_train")
    step_s = rec.last_step_seconds
    share = (flops / PEAK_BF16_FLOPS * 1e3) / (step_s * 1e3)
    if mfu is None or abs(mfu - share) > 1e-12 * share or hfu < mfu:
        fail(f"phase 18 (a): program_mfu {mfu} against the share of the "
             f"tensor-core bound {share} at {step_s * 1e3:.3f} ms; hfu {hfu}")
    state = sum(x.numel() * x.element_size() for st in opt.state.values()
                for x in st.values() if torch.is_tensor(x))
    total = torch.cuda.mem_get_info(dev)[1]
    peak = rec.peak_hbm_bytes
    if not (params + state < peak < total) or not cap.peak_exact:
        fail(f"phase 18 (a): program_peak_hbm_bytes {peak} (exact "
             f"{cap.peak_exact}) outside (parameters {params} + AdamW state "
             f"{state}, the card's {total})")
    steady = statistics.median(ms[1:])
    log(f"phase 18 (a): GPT-2 medium through profiler.instrument: losses "
        f"phase 3's bit for bit, 24 launches of each kernel a step; "
        f"compiles 1, recompiles 0; the capture call {ms[0]:.1f} ms, steady "
        f"{steady:.2f} ms median against phase 3's "
        f"{main_path['step_ms_median']:.2f} (host clock behind the wrapper's "
        f"sync); captured {cap.flops / 1e12:.6f} TFLOP = {dense} dense + "
        f"{sum(want_kernels.values())} in the kernels, exactly; mfu "
        f"{mfu:.6f} = the bound's share at {step_s * 1e3:.3f} ms, hfu "
        f"{hfu:.6f}; peak {peak / 2 ** 30:.3f} GiB (parameters + AdamW "
        f"state {(params + state) / 2 ** 30:.3f} GiB, card {total / 2 ** 30:.1f}"
        f" GiB); on {card}")
    blame0 = _counter(metrics.snapshot(), "recompile_blame_total",
                      program="gpt2_medium_train", argument="tokens")
    step(tokens[:4])                       # planted: a new batch size
    blame = _counter(metrics.snapshot(), "recompile_blame_total",
                     program="gpt2_medium_train", argument="tokens")
    if rec.recompiles != 1 or rec.last_blame != ["tokens"] or \
            blame - blame0 != 1:
        fail(f"phase 18 (a): the B 4 call gave recompiles {rec.recompiles}, "
             f"blame {rec.last_blame}, recompile_blame_total{{tokens}} "
             f"+{blame - blame0}")
    packed_peaks, packed = _packed_capture_peak(dev, profiler, fa)
    log(f"phase 18 (a): a packed, masked flash call forward and backward "
        f"peaked {packed_peaks[0]} bytes above its start plain and "
        f"{packed_peaks[1]} under a cost capture; the capture counted "
        f"{sum(packed.kernel_flops.values())} kernel FLOPs, exactly the "
        f"packed pairs'; on {card}")

    # (b) captures
    caps = {}
    t0 = time.perf_counter()
    with hvd.profile(os.path.join(tmp, "manual")) as logdir:
        step(tokens)
    caps["manual"] = dict(_trace_kernels(logdir),
                          seconds=time.perf_counter() - t0)
    got = caps["manual"]
    # One rank: NCCL launches no kernel for an allreduce over itself (an
    # H100 run of this phase found none), so the step's buckets show as the
    # host's NCCL ops, one a bucket at least; with two ranks or more
    # their kernels are on the device rows too.
    if got["flash"] != info["launches"] or \
            got["nccl_host_ops"] < buckets or \
            (hvd.size() > 1 and got["nccl"] < buckets):
        fail(f"phase 18 (b): the manual capture of one step holds "
             f"{got['flash']} flash kernel events, {got['nccl']} NCCL "
             f"kernels and {got['nccl_host_ops']} host NCCL ops "
             f"({got['nccl_host_names']}), not {info['launches']} and one "
             f"a bucket ({buckets})")
    os.environ.update(HOROVOD_PROFILE_ON_STALL="1",
                      HOROVOD_PROFILE_SECONDS=str(PROFILE_SECONDS),
                      HOROVOD_PROFILE_DIR=os.path.join(tmp, "triggered"))
    config.refresh()
    captures0 = _counter(metrics.snapshot(), "profile_capture_total")
    fires = []
    dog = metrics.StallWatchdog(
        timeout_s=STALL_TIMEOUT_S, poll_s=0.05,
        on_stall=lambda report: fires.append(report["tensor"]))
    token = metrics.collective_begin("allreduce", name="phase18/stuck",
                                     nbytes=4)
    dog.start()
    refused, t0, n, trig_ms, trig_ns = "not tried", time.perf_counter(), 0, \
        [], []
    try:
        while n < 40 and (n < 3 or profiler._PROFILE_ACTIVE or not fires):
            t1, wall = time.perf_counter(), time.time_ns()
            step(tokens)
            trig_ms.append((time.perf_counter() - t1) * 1e3)
            trig_ns.append((wall, time.time_ns()))
            n += 1
            if fires:
                # One plant: the capture's own stop and export hold the
                # loop long enough for a 0.2 s watchdog to fire on a real
                # bucket.
                dog.stop()
            if profiler._PROFILE_ACTIVE and refused == "not tried":
                refused = profiler.trigger_profile("phase18_second")
    finally:
        metrics.collective_end(token)
        dog.stop()
    fired = _counter(metrics.snapshot(), "profile_capture_total") - captures0
    dirs = os.listdir(os.path.join(tmp, "triggered"))
    if fires != ["phase18/stuck"] or fired != 1 or len(dirs) != 1 or \
            profiler._PROFILE_ACTIVE or refused is not None:
        fail(f"phase 18 (b): the watchdog fired on {fires}, {fired} "
             f"captures ({dirs}), a second trigger while active gave "
             f"{refused!r}")
    got = caps["triggered"] = dict(
        _trace_kernels(os.path.join(tmp, "triggered", dirs[0])),
        seconds=time.perf_counter() - t0, steps=n,
        step_ms_max=max(trig_ms), step_ms_median=statistics.median(trig_ms))
    # The steps' polls start and stop the session on the training thread;
    # the steps that ran wholly inside its window launched every kernel 24
    # times each, from the training thread (the forward) and from
    # autograd's (the backward).
    if got["window_ns"] is None:
        fail("phase 18 (b): the triggered capture's trace has no session "
             "window")
    w0, w1 = got["window_ns"]
    got["steps_inside"] = sum(1 for a, z in trig_ns if a >= w0 and z <= w1)
    short = {k: c for k, c in got["flash"].items()
             if c < info["launches"][k] * got["steps_inside"]}
    if got["steps_inside"] < 1 or short:
        fail(f"phase 18 (b): the triggered capture spans "
             f"{got['steps_inside']} whole steps but holds flash kernel "
             f"events {got['flash']} (short: {short}), not "
             f"{info['launches']} a step: it lost device activity; "
             f"{got['kernels']} kernel events in all")
    long_dir = profiler.trigger_profile("phase18_long", seconds=600.0)
    if long_dir is None:
        fail("phase 18 (b): the long trigger was refused")
    t0 = time.perf_counter()
    with hvd.profile(os.path.join(tmp, "preempting")) as logdir:
        step(tokens)
    preempt_s = time.perf_counter() - t0
    caps["preempting"] = dict(_trace_kernels(logdir), seconds=preempt_s)
    caps["preempted"] = _trace_kernels(long_dir)
    if preempt_s > PREEMPT_LIMIT_S or profiler._PROFILE_ACTIVE or \
            caps["preempting"]["flash"] != info["launches"] or \
            profiler._TRIGGER is not None:
        fail(f"phase 18 (b): the manual capture did not preempt the long "
             f"trigger: {preempt_s:.1f} s, {caps['preempting']}")
    for k in ("HOROVOD_PROFILE_ON_STALL", "HOROVOD_PROFILE_SECONDS",
              "HOROVOD_PROFILE_DIR"):
        os.environ.pop(k)
    config.refresh()
    log(f"phase 18 (b): captures (host clock; Chrome traces): " + "; ".join(
        f"{k} {v.get('seconds', 0):.2f} s, {v['bytes']} bytes, "
        f"{v['kernels']} kernel events (flash {v['flash']}, NCCL "
        f"{v['nccl']}), {v['nccl_host_ops']} host NCCL ops"
        + (f", {v['steps_inside']} of {v['steps']} steps wholly inside"
           if "steps_inside" in v else "")
        for k, v in caps.items())
        + f"; the stall fired once, one triggered capture (step ms median "
        f"{caps['triggered']['step_ms_median']:.1f}, max "
        f"{caps['triggered']['step_ms_max']:.1f}), holding every flash "
        f"kernel of the steps inside it, a second trigger refused; the 600 s "
        f"trigger preempted in {preempt_s:.2f} s; on {card}")

    # (c) memory
    frac = profiler.check_memory_pressure()
    i = str(dev.index or 0)
    snap = metrics.snapshot()
    in_use = _gauge_value(snap, "device_hbm_bytes_in_use", device=i)
    limit = _gauge_value(snap, "device_hbm_bytes_limit", device=i)
    if frac is None or not 0 < frac < 1 or in_use is None or \
            limit != total or abs(in_use / limit - frac) > 1e-12:
        fail(f"phase 18 (c): pressure {frac}, in use {in_use}, limit {limit}")
    for _ in range(2):
        profiler.check_memory_pressure(threshold=0.0)
    events = _counter(metrics.snapshot(), "memory_pressure_total")
    census = profiler.live_buffer_census()
    if events != 1 or census["gpu"]["bytes"] < params:
        fail(f"phase 18 (c): {events} memory_pressure events (expected 1); "
             f"census {census}")
    log(f"phase 18 (c): the card {frac:.4f} in use ({in_use / 2 ** 30:.2f} "
        f"of {limit / 2 ** 30:.2f} GiB), one memory_pressure event from two "
        f"checks at threshold 0, live buffers {census}; on {card}")

    # (d) the doctor
    rep = hvd.doctor()
    by_cat = {f["category"]: f for f in rep["findings"]}
    rc = by_cat.get("recompile", {}).get("evidence", {})
    if rc.get("program") != "gpt2_medium_train" or \
            rc.get("blamed_arguments") != ["tokens"] or \
            "memory_pressure" not in by_cat or rep["healthy"]:
        fail(f"phase 18 (d): the doctor's findings {rep['findings']}")
    text = profiler.format_report(rep)
    if any(f["title"] not in text or f["suggestion"] not in text
           for f in rep["findings"]):
        fail("phase 18 (d): format_report left a finding out")
    srv = hvd.metrics_http(0)
    try:
        code, body, _ = _http(srv.url + "/doctor")
    finally:
        srv.stop()
    if code != 200 or json.loads(body)["findings"] != json.loads(
            json.dumps(rep["findings"], default=str)):
        fail(f"phase 18 (d): /doctor answered {code} {body[:300]!r}")
    now = time.time()
    sampler.sample_once(ts=now)
    window = profiler.doctor_window(store, now - t_window + 1.0, now=now)
    cats = [f["category"] for f in window["findings"]]
    # The reference's shape; a counter born inside the window has one
    # point there and so no delta (PromQL's increase), as in the reference.
    if set(window) != {"findings", "healthy", "inputs"} or \
            window["inputs"] != {"snapshot": f"window:{now - t_window + 1:g}s",
                                 "trace": "none", "programs": []} or \
            store.series_count() < 10:
        fail(f"phase 18 (d): doctor_window gave {window} over "
             f"{store.series_count()} series")
    hvd.stop_timeline()
    with open(trace_path) as f:
        markers = [e for e in json.load(f)["traceEvents"]
                   if e["name"] == "recompile"]
    if len(markers) != 1 or markers[0]["args"]["arguments"] != ["tokens"]:
        fail(f"phase 18 (a): recompile markers in the timeline: {markers}")
    log(f"phase 18 (d): hvd.doctor() ranks {[(f['rank'], f['category'], f['severity']) for f in rep['findings']]}; "
        f"the recompile blamed on 'tokens' ({rc.get('recompiles')}x), "
        f"format_report renders all, /doctor 200 with the same findings, "
        f"doctor_window over the sampler's store {cats}; one recompile "
        f"marker in the timeline")
    del model, opt, step
    hvd.shutdown()
    torch.cuda.empty_cache()
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s on {card}")
    return {"losses": losses, "step_ms": ms, "steady_ms_median": steady,
            "phase3_step_ms_median": main_path["step_ms_median"],
            "capture_ms": ms[0], "captured_flops": cap.flops,
            "dense_flops": cap.dense_flops, "kernel_flops": cap.kernel_flops,
            "model_flops": flops, "mfu": mfu, "hfu": hfu,
            "step_seconds": step_s, "peak_bytes": peak,
            "captures": caps, "pressure": frac,
            "findings": [(f["rank"], f["category"], f["severity"])
                         for f in rep["findings"]],
            "launches": launches}


# ---------------------------------------------------------------- phase 19

BLACKBOX_WORKER_LAYERS = 4   # (b) and (c): GPT-2 medium's width, 4 layers
BLACKBOX_WAIT_S = 120.0      # (b) and (c): a worker's whole life
# (a)'s watchdog: well under the triggered capture's ~3 s stop, whose hold
# it must not read as a second stall. At phase 6's 0.2 s a real bucket's
# dispatch, delayed while the stall's bundle was written on the watchdog's
# thread, read as a second stall on the H100 (PERF.md section 6).
BLACKBOX_STALL_TIMEOUT_S = 1.0


def _bundle_bytes(bundle):
    import os
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(bundle) for f in files)


def _blackbox_worker(root, name, plan=None, steps=5):
    """Phase 19 (b) / (c): ``tools/torch_elastic_worker.py`` at GPT-2
    medium's width, ``BLACKBOX_WORKER_LAYERS`` deep, one rank, under
    ``HOROVOD_BLACKBOX=1`` and a timeline, in a directory of its own;
    returns (its directory, the process)."""
    import os
    d = os.path.join(root, name)
    os.makedirs(os.path.join(d, "state"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "HVD_TPU_"))
           and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_SIZE",
                         "MASTER_ADDR", "MASTER_PORT")}
    env.update(HOROVOD_BLACKBOX="1",
               HOROVOD_BLACKBOX_DIR=os.path.join(d, "blackbox"),
               HOROVOD_TIMELINE=os.path.join(d, "timeline.json"),
               HVD_TPU_ELASTIC_STATE_DIR=os.path.join(d, "state"))
    if plan:
        env["HOROVOD_FAULT_PLAN"] = plan
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "torch_elastic_worker.py")
    log = open(os.path.join(d, "worker.log"), "w")
    p = subprocess.Popen(
        [sys.executable, tool, "--model", "gpt2_medium", "--layers",
         str(BLACKBOX_WORKER_LAYERS), "--steps", str(steps)],
        env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=log, stderr=subprocess.STDOUT)
    return d, p


def _unlisted(bundle, manifest):
    """The files a bundle holds that its manifest does not list, and those
    it lists that the bundle does not hold."""
    import os
    held = {os.path.relpath(os.path.join(d, f), bundle)
            for d, _, files in os.walk(bundle) for f in files}
    listed = set(manifest["files"])
    return sorted(held - listed), sorted(listed - held)


def _worker_steps(d):
    import os
    path = os.path.join(d, "state", "steps.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip() and '"step"' in x]


def _one_bundle(d, trigger, tag):
    import os
    from horovod_tpu_torch import blackbox
    found = blackbox.find_bundles(os.path.join(d, "blackbox"))
    if len(found) != 1:
        with open(os.path.join(d, "worker.log")) as f:
            tail = f.read()[-3000:]
        fail(f"phase 19 {tag}: {len(found)} bundles ({found}), not one; the "
             f"worker's log ends: {tail}")
    with open(os.path.join(found[0], "manifest.json")) as f:
        manifest = json.load(f)
    extra, missing = _unlisted(found[0], manifest)
    if extra or missing:
        fail(f"phase 19 {tag}: the bundle holds {extra} beyond its "
             f"manifest, which lists {missing} not in it")
    if manifest["trigger"] != trigger:
        fail(f"phase 19 {tag}: the bundle's trigger is "
             f"{manifest['trigger']!r}, not {trigger!r}")
    return found[0], manifest


def phase_blackbox(card, main_path):
    """Phase 19: the flight recorder on the card. (a) phase 3's GPT-2
    medium under ``HOROVOD_BLACKBOX=1`` and a timeline on a new one-rank
    NCCL world, a stall planted while it trains; (b) a fault-plan kill and
    (c) SIGTERM of the elastic worker. Without phase 3 it runs phase 3's
    path itself first."""
    import faulthandler
    import os
    import tempfile
    import threading
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import blackbox, config, metrics, profiler
    from horovod_tpu_torch import trace_merge
    from horovod_tpu_torch.models.gpt2 import loss_fn
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    t_phase = time.perf_counter()
    if main_path is None:
        main_path = phase_main_path(card)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase19_")
    bb = os.path.join(tmp, "blackbox")
    # One triggered capture more than the process has taken (phase 18's
    # count against the same budget).
    env = dict(HOROVOD_BLACKBOX="1", HOROVOD_BLACKBOX_DIR=bb,
               HOROVOD_PROFILE_ON_STALL="1",
               HOROVOD_PROFILE_SECONDS=str(PROFILE_SECONDS),
               HOROVOD_PROFILE_DIR=os.path.join(tmp, "profile"),
               HOROVOD_PROFILE_MAX_CAPTURES=str(
                   profiler.profile_capture_count() + 1))
    os.environ.update(env)
    hooks = (signal.getsignal(signal.SIGTERM),
             signal.getsignal(signal.SIGABRT), sys.excepthook)
    blackbox.reset()
    hvd.start_timeline(os.path.join(tmp, "trace.json"))
    hvd.init()
    rec = blackbox.get()
    if hvd.backend() != "nccl" or hvd.size() != 1 or rec is None or \
            (rec.rank, rec.world) != (0, 1) or \
            signal.getsignal(signal.SIGTERM) != rec._on_fatal_signal or \
            not faulthandler.is_enabled():
        fail(f"phase 19 (a): init under HOROVOD_BLACKBOX=1 gave "
             f"{hvd.backend()} x {hvd.size()}, recorder {rec}, SIGTERM "
             f"handler {signal.getsignal(signal.SIGTERM)}")
    dev = hvd.device()
    model, opt, _, info = build_path("gpt2_medium", dev)
    tokens = info["inputs"]

    def step():
        opt.zero_grad()
        loss = loss_fn(model(tokens), tokens)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        return loss

    # (a) phase 3's path with the recorder armed: its rings fill from the
    # timeline's tap and the sampler thread while the steps run
    torch.cuda.synchronize()
    fa.reset_launches()
    losses, ms = [], []
    for i in range(5):
        before = dict(fa.launches)
        t0 = time.perf_counter()
        loss = step()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        grew = {k: fa.launches[k] - before[k] for k in fa.KERNELS}
        if grew != info["launches"]:
            fail(f"phase 19 (a): step {i} launched {grew}, not "
                 f"{info['launches']}")
    launches = dict(fa.launches)
    if losses != main_path["losses"]:
        fail(f"phase 19 (a): losses {losses} are not phase 3's "
             f"{main_path['losses']} bit for bit")
    armed_ms = statistics.median(ms[1:])
    rings = (len(rec.timeline_ring), rec.timeline_ring.nbytes,
             len(rec.snapshots))
    # The recorder's cost in this process's state: its feeds (the timeline
    # tap and the sampler thread) stopped for 5 steps, then armed again.
    ab = {}
    for tag in ("feeds_off", "armed_again"):
        (rec.stop if tag == "feeds_off" else rec.start)()
        ab[tag] = []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            ab[tag].append((time.perf_counter() - t0) * 1e3)
    ab = {k: statistics.median(v[1:]) for k, v in ab.items()}
    log(f"phase 19 (a): GPT-2 medium under HOROVOD_BLACKBOX=1 and a "
        f"timeline: losses phase 3's bit for bit, launches a step "
        f"{info['launches']}; step {armed_ms:.2f} ms median (host clock after "
        f"synchronize) against phase 3's {main_path['step_ms_median']:.2f}; "
        f"then, on the same model, {ab['feeds_off']:.2f} ms with the "
        f"recorder's feeds stopped and {ab['armed_again']:.2f} armed again; "
        f"rings after the first 5 steps: {rings[0]} timeline events "
        f"({rings[1]} bytes), {rings[2]} snapshots; on {card}")

    # The planted stall (phase 6's pattern) while steps run, under
    # HOROVOD_PROFILE_ON_STALL=1: one report, one capture whose stop holds
    # the training loop while the watchdog keeps scanning, one bundle.
    def counts():
        snap = metrics.snapshot()
        return {t: _counter(snap, "blackbox_dumps_total", trigger=t)
                for t in ("stall", "manual")}, \
            _counter(snap, "profile_capture_total"), \
            _counter(snap, "stall_events_total")

    dumps0, captures0, stalls0 = counts()
    fires, dumped = [], []
    dump = rec.dump

    def timed_dump(*a, **kw):
        t0 = time.perf_counter()
        try:
            return dump(*a, **kw)
        finally:
            dumped.append((kw.get("trigger"), time.perf_counter() - t0))

    rec.dump = timed_dump
    dog = metrics.StallWatchdog(
        timeout_s=BLACKBOX_STALL_TIMEOUT_S, poll_s=0.05,
        on_stall=lambda report: fires.append(
            (report["tensor"], round(report["pending_s"], 3))))
    token = metrics.collective_begin("allreduce", name="phase19/stuck",
                                     nbytes=4)
    dog.start()
    n, after, step_ms = 0, None, []
    try:
        while n < 60:
            t0 = time.perf_counter()
            step()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            n += 1
            if after is None and fires and not profiler._PROFILE_ACTIVE \
                    and rec.last_bundle is not None:
                after = n
            if after is not None and n >= after + 3:
                break
    finally:
        metrics.collective_end(token)
        dog.stop()
    dumps1, captures1, stalls1 = counts()
    bundles = blackbox.find_bundles(bb)
    if [f[0] for f in fires] != ["phase19/stuck"] or \
            stalls1 - stalls0 != 1 or \
            captures1 - captures0 != 1 or dumps1["stall"] - \
            dumps0["stall"] != 1 or len(bundles) != 1 or after is None:
        fail(f"phase 19 (a): the planted stall gave reports {fires}, "
             f"+{stalls1 - stalls0} stall events, +{captures1 - captures0} "
             f"captures, +{dumps1['stall'] - dumps0['stall']} stall dumps, "
             f"bundles {bundles}, in {n} steps (dumps and their seconds "
             f"{dumped}); want one of each")
    bundle = bundles[0]
    with open(os.path.join(bundle, "manifest.json")) as f:
        manifest = json.load(f)
    extra, missing = _unlisted(bundle, manifest)
    if manifest["trigger"] != "stall" or extra or missing or \
            manifest["timeline_events"] < 1:
        fail(f"phase 19 (a): stall bundle manifest {manifest}; files not "
             f"listed {extra}, listed and missing {missing}")
    merged = trace_merge.merge_timelines(os.path.join(bundle, "trace"),
                                         feed_metrics=False)
    names = {e.get("name") for e in merged["traceEvents"]}
    if "collective_stall" not in names or "EXEC" not in names:
        fail(f"phase 19 (a): the trace tail merged to {len(names)} names "
             f"without the stall marker or an EXEC phase: "
             f"{sorted(map(str, names))[:40]}")
    with open(os.path.join(bundle, "metrics.window.json")) as f:
        window = json.load(f)
    doc = profiler.doctor(snapshot=window, trace=None, programs={})
    report = blackbox.postmortem_report(bundle)
    if "findings" not in doc or not report["findings"] or \
            report["findings"][0]["category"] != "stall" or \
            report["cause"] is None:
        fail(f"phase 19 (a): the postmortem of the stall bundle ranks "
             f"{[(f['category'], f['severity']) for f in report['findings']]}"
             f", not stall first")
    stall_bytes = _bundle_bytes(bundle)
    log(f"phase 19 (a): the planted stall: one report, one triggered "
        f"capture, one stall bundle in {n} steps (step ms median "
        f"{statistics.median(step_ms):.1f}, max {max(step_ms):.1f}: the "
        f"capture's stop held the loop while a {BLACKBOX_STALL_TIMEOUT_S} s "
        f"watchdog scanned); the stall's dump took {dumped[0][1]:.3f} s on "
        f"the watchdog's thread; the bundle {stall_bytes} bytes, "
        f"{len(manifest['files'])}"
        f" files, {manifest['snapshots']} snapshots, "
        f"{manifest['timeline_events']} timeline events; its trace tail "
        f"merged ({len(merged['traceEvents'])} events); "
        f"postmortem_report ranks "
        f"{[(f['rank'], f['category']) for f in report['findings']]}; "
        f"on {card}")

    # A dump while another thread holds the registry lock: it completes,
    # skips the final sample and defers its count.
    held, release = threading.Event(), threading.Event()

    def hog():
        with metrics.registry._lock:
            held.set()
            release.wait(30.0)

    t = threading.Thread(target=hog, daemon=True)
    t.start()
    held.wait(10.0)
    t0 = time.perf_counter()
    try:
        manual = blackbox.dump_postmortem(note="phase 19 (a)")
    finally:
        dump_s = time.perf_counter() - t0
        release.set()
        t.join(10.0)
    rec.dump = dump
    if manual is None:
        fail("phase 19 (a): the dump with the registry lock held was "
             "refused")
    with open(os.path.join(manual, "manifest.json")) as f:
        sampled = json.load(f)["sampled_final"]
    deadline = time.monotonic() + 10.0
    while counts()[0]["manual"] - dumps0["manual"] < 1 and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    dumps2 = counts()[0]
    if sampled is not False or {k: dumps2[k] - dumps0[k] for k in dumps2} \
            != {"stall": 1, "manual": 1}:
        fail(f"phase 19 (a): the locked dump's sampled_final {sampled}; "
             f"blackbox_dumps_total grew {dumps0} -> {dumps2}")
    log(f"phase 19 (a): a dump_postmortem() with the registry lock held by "
        f"another thread completed in {dump_s * 1e3:.1f} ms "
        f"(sampled_final false, {_bundle_bytes(manual)} bytes); "
        f"blackbox_dumps_total counts stall 1 and manual 1; on {card}")
    del model, opt
    hvd.stop_timeline()
    hvd.shutdown()
    torch.cuda.empty_cache()
    blackbox.reset()
    signal.signal(signal.SIGTERM, hooks[0])
    signal.signal(signal.SIGABRT, hooks[1])
    sys.excepthook = hooks[2]
    faulthandler.disable()
    for k in env:
        os.environ.pop(k)
    config.refresh()

    # (b) a fault-plan kill and (c) SIGTERM, two workers side by side
    kill_dir, killed = _blackbox_worker(tmp, "kill", "kill@rank=0,step=3")
    term_dir, termed = _blackbox_worker(tmp, "sigterm", steps=1000)
    deadline = time.monotonic() + BLACKBOX_WAIT_S
    while len(_worker_steps(term_dir)) < 2 and termed.poll() is None and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    sent = time.time()
    termed.send_signal(signal.SIGTERM)
    try:
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
               for p in (killed, termed)]
    except subprocess.TimeoutExpired:
        for p in (killed, termed):
            p.kill()
            p.wait()
        fail("phase 19 (b)-(c): a worker outlived "
             f"{BLACKBOX_WAIT_S:.0f} s")
    kill_steps = [r["step"] for r in _worker_steps(kill_dir)]
    if rcs[0] != -signal.SIGKILL or kill_steps != [0, 1, 2]:
        fail(f"phase 19 (b): the planted kill exited {rcs[0]} after steps "
             f"{kill_steps}; want -9 after 0, 1, 2")
    kill_bundle, kill_manifest = _one_bundle(kill_dir, "fault", "(b)")
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "torch_postmortem.py")
    r = subprocess.run([sys.executable, tool, "--json", "--dir",
                        os.path.join(kill_dir, "blackbox")],
                       capture_output=True, text=True, timeout=120)
    cause = json.loads(r.stdout)["cause"] if r.stdout.strip() else None
    if r.returncode != 2 or cause is None or \
            cause["category"] != "fault_kill" or \
            not cause["title"].startswith("rank 0 kill") or \
            "kill@rank=0,step=3" not in cause["detail"]:
        fail(f"phase 19 (b): tools/torch_postmortem.py exited "
             f"{r.returncode} with cause {cause}; {r.stderr[-2000:]}")
    log(f"phase 19 (b): the elastic worker (GPT-2 medium width, "
        f"{BLACKBOX_WORKER_LAYERS} layers) under kill@rank=0,step=3 exited "
        f"-9 after steps 0-2 and published a fault bundle first "
        f"({_bundle_bytes(kill_bundle)} bytes, "
        f"{kill_manifest['timeline_events']} timeline events); "
        f"tools/torch_postmortem.py --json exits 2: {cause['title']} "
        f"({cause['detail']}); on {card}")
    term_steps = _worker_steps(term_dir)
    if rcs[1] != -signal.SIGTERM or len(term_steps) < 2:
        fail(f"phase 19 (c): SIGTERM after {len(term_steps)} steps gave exit "
             f"{rcs[1]}, not -{int(signal.SIGTERM)}")
    term_bundle, term_manifest = _one_bundle(term_dir, "signal", "(c)")
    with open(os.path.join(term_bundle, "stacks.txt")) as f:
        stacks = f.read()
    main_stack = stacks.split("(MainThread):\n", 1)[-1].split("\n\n", 1)[0]
    if "torch_elastic_worker.py" not in main_stack or \
            "in train" not in main_stack:
        fail(f"phase 19 (c): stacks.txt holds no training frame on the main "
             f"thread: {main_stack[-2000:]}")
    waited = term_manifest["ts"] - sent
    # The frame the handler interrupted: the one just above the handler's.
    frames = main_stack.split("  File ")
    handler = next(i for i, f in enumerate(frames)
                   if "in _on_fatal_signal" in f)
    interrupted = " ".join(frames[handler - 1].split())
    log(f"phase 19 (c): SIGTERM to the worker after {len(term_steps)} "
        f"steps: exit -{int(signal.SIGTERM)} kept (the handler re-delivers "
        f"it), a signal bundle ({_bundle_bytes(term_bundle)} bytes) whose "
        f"stacks hold the training frame; the handler ran {waited:.3f} s "
        f"after the signal was sent, behind {interrupted}; on {card}")
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s on {card}")
    return {"losses": losses, "step_ms": ms, "armed_ms_median": armed_ms,
            "feeds_off_ms_median": ab["feeds_off"],
            "armed_again_ms_median": ab["armed_again"],
            "phase3_step_ms_median": main_path["step_ms_median"],
            "stall_steps": n, "stall_step_ms_max": max(step_ms),
            "stall_dump_s": dumped[0][1],
            "stall_bundle_bytes": stall_bytes, "locked_dump_s": dump_s,
            "kill_bundle_bytes": _bundle_bytes(kill_bundle),
            "signal_bundle_bytes": _bundle_bytes(term_bundle),
            "signal_wait_s": waited, "signal_interrupted": interrupted,
            "launches": launches}


# ---------------------------------------------------------------- phase 20

CONFBUS_STALL_TIMEOUT_S = 1.0   # (a)'s retargeted watchdog (phase 19's)
CONFBUS_HOLD_S = 30.0           # (a)'s bound on a held stall's wait: under
                                # the old 60 s timeout it would not fire


def phase_confbus(card, main_path):
    """Phase 20: the config bus (``confbus.py``) on phase 3's path, on a
    new one-rank NCCL world with ``metrics_http`` up, an auth token, a
    ledger file, ``HOROVOD_BLACKBOX=1`` and a timeline: (a) live retarget
    and refusals between steps, (b) the math untouched, (c) one audit
    trail, (d) time. Without phase 3 it runs phase 3's path first."""
    import logging
    import os
    import secrets
    import tempfile
    import faulthandler
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import blackbox, confbus, config, metrics
    from horovod_tpu_torch.models.gpt2 import loss_fn
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    t_phase = time.perf_counter()
    if main_path is None:
        main_path = phase_main_path(card)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase20_")
    ledger = os.path.join(tmp, "config_ledger.jsonl")
    trace_path = os.path.join(tmp, "trace.json")
    token = secrets.token_hex(16)
    env = dict(HOROVOD_SERVE_AUTH_TOKEN=token, HOROVOD_CONFIG_LEDGER=ledger,
               HOROVOD_BLACKBOX="1",
               HOROVOD_BLACKBOX_DIR=os.path.join(tmp, "blackbox"))
    before_env = {k: os.environ.get(k) for k in env}
    hooks = (signal.getsignal(signal.SIGTERM),
             signal.getsignal(signal.SIGABRT), sys.excepthook)
    # The knobs this phase sets come in by env before the world forms; the
    # bus audits that refresh, then starts from epoch 0 and an empty ledger.
    os.environ.update(env)
    config.refresh()
    confbus.reset()
    blackbox.reset()
    if os.path.exists(ledger):
        os.remove(ledger)
    logged = []

    class _Keep(logging.Handler):
        def emit(self, record):
            logged.append(record)

    keep = _Keep(level=logging.WARNING)
    logging.getLogger("horovod_tpu_torch").addHandler(keep)
    hvd.start_timeline(trace_path)
    hvd.init()
    srv = hvd.metrics_http(0)
    dog = metrics.get_stall_watchdog()
    if hvd.backend() != "nccl" or hvd.size() != 1 or blackbox.get() is None \
            or dog is None or confbus.epoch() != 0:
        fail(f"phase 20: init gave {hvd.backend()} x {hvd.size()}, "
             f"recorder {blackbox.get()}, watchdog {dog}, config epoch "
             f"{confbus.epoch()}")
    old_timeout = dog.timeout_s
    dev = hvd.device()
    model, opt, _, info = build_path("gpt2_medium", dev)
    tokens = info["inputs"]
    bodies = []      # every HTTP reply body, for the token check

    def step():
        opt.zero_grad()
        loss = loss_fn(model(tokens), tokens)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        return loss

    def checked_step(i):
        before = dict(fa.launches)
        buckets0 = _counter(metrics.snapshot(), "fusion_buckets_total")
        t0 = time.perf_counter()
        loss = step()
        ms.append((time.perf_counter() - t0) * 1e3)
        grew = {k: fa.launches[k] - before[k] for k in fa.KERNELS}
        if grew != info["launches"]:
            fail(f"phase 20: step {i} launched {grew}, not "
                 f"{info['launches']}")
        buckets.append(_counter(metrics.snapshot(), "fusion_buckets_total")
                       - buckets0)
        return loss.item()

    def post(doc, tok=token):
        code, raw, _ = _http(srv.url + "/config", json.dumps(doc).encode(),
                             {"X-Auth-Token": tok} if tok else None)
        bodies.append(raw)
        return code, json.loads(raw or b"{}")

    torch.cuda.synchronize()
    fa.reset_launches()
    losses, ms, buckets = [], [], []
    # (a) the retarget, and the refusals, between steps
    losses.append(checked_step(0))
    want = {"name": "HOROVOD_STALL_CHECK_TIME_SECONDS",
            "value": CONFBUS_STALL_TIMEOUT_S, "reason": "phase 20"}
    refused = [post(want, None), post(want, "not-the-token-" + "0" * 8)]
    if [c for c, _ in refused] != [401, 401] or confbus.epoch() != 0:
        fail(f"phase 20 (a): POST /config without the token answered "
             f"{refused}, epoch {confbus.epoch()}; want 401 twice, epoch 0")
    code, res = post(want)
    if code != 200 or res.get("outcome") != "applied" or \
            dog.timeout_s != CONFBUS_STALL_TIMEOUT_S or \
            metrics.get_stall_watchdog() is not dog or \
            os.environ.get("HOROVOD_STALL_CHECK_TIME_SECONDS") != \
            str(CONFBUS_STALL_TIMEOUT_S):
        fail(f"phase 20 (a): the retarget answered {code} {res}; the "
             f"watchdog's timeout is {dog.timeout_s} s")
    losses.append(checked_step(1))
    fusion_env = os.environ.get("HOROVOD_FUSION_THRESHOLD")
    code, shape = post({"name": "HOROVOD_FUSION_THRESHOLD",
                        "value": 1 << 20})
    losses.append(checked_step(2))
    if code != 200 or (shape.get("outcome"), shape.get("code")) != \
            ("refused", "shape_affecting") or \
            os.environ.get("HOROVOD_FUSION_THRESHOLD") != fusion_env or \
            len(set(buckets)) != 1 or \
            buckets[0] != main_path["buckets_per_step"]:
        fail(f"phase 20 (a): HOROVOD_FUSION_THRESHOLD answered {code} "
             f"{shape}; buckets a step {buckets}, phase 3's plan "
             f"{main_path['buckets_per_step']}")
    code, bad = post({"name": "HOROVOD_STALL_CHECK_TIME_SECONDS",
                      "value": "soon"})
    if code != 200 or (bad.get("outcome"), bad.get("code")) != \
            ("rejected", "invalid") or \
            os.environ.get("HOROVOD_STALL_CHECK_TIME_SECONDS") != \
            str(CONFBUS_STALL_TIMEOUT_S) or \
            dog.timeout_s != CONFBUS_STALL_TIMEOUT_S:
        fail(f"phase 20 (a): an invalid value answered {code} {bad}; env "
             f"{os.environ.get('HOROVOD_STALL_CHECK_TIME_SECONDS')!r}, "
             f"timeout {dog.timeout_s}")
    losses.append(checked_step(3))
    # (c) an env change and a re-resolve after init (hvd.init() again:
    # re-entrant, it re-reads the environment), then a second re-resolve
    n_logged = len(logged)
    os.environ["HOROVOD_METRICS_INTERVAL"] = "5"
    hvd.init()
    config.refresh()
    refresh_warns = [r.getMessage() for r in logged[n_logged:]
                     if "refresh() changed" in r.getMessage()]
    losses.append(checked_step(4))
    # (b) the math: phase 3's losses bit for bit
    if losses != main_path["losses"]:
        fail(f"phase 20 (b): losses {losses} are not phase 3's "
             f"{main_path['losses']} bit for bit")
    bus_ms = statistics.median(ms[1:])
    # (a) the held step under the retargeted watchdog
    stalls0 = _counter(metrics.snapshot(), "stall_events_total")
    held = metrics.collective_begin("allreduce", name="phase20/held",
                                    nbytes=4)
    t_held = time.perf_counter()
    n = 0
    try:
        while time.perf_counter() - t_held < CONFBUS_HOLD_S and _counter(
                metrics.snapshot(), "stall_events_total") == stalls0:
            checked_step(5 + n)
            n += 1
    finally:
        metrics.collective_end(held)
    held_s = time.perf_counter() - t_held
    stalls = _counter(metrics.snapshot(), "stall_events_total") - stalls0
    launches = dict(fa.launches)
    if stalls != 1 or held_s >= old_timeout:
        fail(f"phase 20 (a): the held step gave {stalls} stall reports in "
             f"{held_s:.2f} s ({n} steps); want one under the "
             f"{CONFBUS_STALL_TIMEOUT_S} s timeout, not the old "
             f"{old_timeout} s")
    # (c) one audit trail: ledger file, GET /config, the timeline's
    # CONFIG markers and a bundle's "config" records (dumped once the
    # stall's own bundle is out)
    deadline = time.monotonic() + 60.0
    while blackbox.get().last_bundle is None and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    bundle = blackbox.dump_postmortem(note="phase 20")
    code, body, _ = _http(srv.url + "/config")
    bodies.append(body)
    view = json.loads(body)
    srv.stop()
    hvd.stop_timeline()
    with open(ledger) as f:
        ledger_text = f.read()
    lines = [json.loads(x) for x in ledger_text.splitlines() if x.strip()]
    with open(trace_path) as f:
        trace_text = f.read()
    marks = [e["args"] for e in json.loads(trace_text)["traceEvents"]
             if e.get("name") == "CONFIG"]
    stall_marks = [e["args"] for e in json.loads(trace_text)["traceEvents"]
                   if e.get("name") == "collective_stall"]
    with open(os.path.join(bundle, "events.jsonl")) as f:
        recs = [json.loads(x) for x in f if x.strip()]
    recs = [r for r in recs if r["type"] == "config"]
    applied = [r for r in lines if r["outcome"] == "applied"]

    def trail(items):
        return [(r["knob"], r.get("outcome", "applied"), r.get("origin"))
                for r in items]

    want_trail = [("HOROVOD_STALL_CHECK_TIME_SECONDS", "applied", "http"),
                  ("HOROVOD_FUSION_THRESHOLD", "refused", "http"),
                  ("HOROVOD_STALL_CHECK_TIME_SECONDS", "rejected", "http"),
                  ("HOROVOD_METRICS_INTERVAL", "applied", "env-refresh")]
    if len(refresh_warns) != 1 or \
            "HOROVOD_METRICS_INTERVAL" not in refresh_warns[0] or \
            confbus.epoch() != len(applied) or len(applied) != 2 or \
            view["epoch"] != confbus.epoch() or \
            _gauge_value(metrics.snapshot(), "config_epoch") != \
            float(len(applied)) or \
            trail(lines) != want_trail or \
            trail(view["ledger_tail"]) != want_trail or \
            trail(marks) != want_trail or trail(recs) != want_trail:
        fail(f"phase 20 (c): the audit trail disagrees: WARN lines "
             f"{refresh_warns}, epoch {confbus.epoch()} for {len(applied)} "
             f"applied; ledger {trail(lines)}, GET /config "
             f"{trail(view['ledger_tail'])}, CONFIG markers {trail(marks)},"
             f" bundle {trail(recs)}; want {want_trail}")
    if not stall_marks or stall_marks[0]["tensor"] != "phase20/held" or \
            not CONFBUS_STALL_TIMEOUT_S <= stall_marks[0]["pending_s"] \
            < old_timeout:
        fail(f"phase 20 (a): the stall markers {stall_marks}")
    bundle_text = ""
    for d, _, files in os.walk(os.path.join(tmp, "blackbox")):
        for name in files:
            with open(os.path.join(d, name), errors="replace") as f:
                bundle_text += f.read()
    log_text = "\n".join(r.getMessage() for r in logged)
    leaks = [where for where, text in (
        ("ledger", ledger_text), ("http", b"".join(bodies).decode()),
        ("bundle", bundle_text), ("log", log_text),
        ("timeline", trace_text)) if token in text]
    if leaks:
        fail(f"phase 20 (c): the auth token appears in {leaks}")
    logging.getLogger("horovod_tpu_torch").removeHandler(keep)
    epoch = confbus.epoch()
    del model, opt
    hvd.shutdown()
    torch.cuda.empty_cache()
    blackbox.reset()
    signal.signal(signal.SIGTERM, hooks[0])
    signal.signal(signal.SIGABRT, hooks[1])
    sys.excepthook = hooks[2]
    faulthandler.disable()
    for k in list(env) + ["HOROVOD_STALL_CHECK_TIME_SECONDS",
                          "HOROVOD_METRICS_INTERVAL"]:
        if before_env.get(k) is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = before_env[k]
    config.refresh()
    confbus.reset()
    phase_s = time.perf_counter() - t_phase
    log(f"phase 20 (a): POST /config without the token: 401 twice; with "
        f"it, HOROVOD_STALL_CHECK_TIME_SECONDS {old_timeout:g} -> "
        f"{CONFBUS_STALL_TIMEOUT_S:g} s applied live, and a held step was "
        f"reported once after {held_s:.2f} s ({n} steps, marker pending_s "
        f"{stall_marks[0]['pending_s']}); HOROVOD_FUSION_THRESHOLD refused "
        f"shape_affecting with {buckets[0]} buckets a step before and "
        f"after (phase 3's plan); an invalid value rejected, the env and "
        f"the watchdog kept at {CONFBUS_STALL_TIMEOUT_S:g} s; on {card}")
    log(f"phase 20 (b): losses phase 3's bit for bit, launches a step "
        f"{info['launches']}, {launches} in the phase's "
        f"{len(ms)} steps; on {card}")
    log(f"phase 20 (c): one env change + hvd.init() + refresh(): one WARN, "
        f"config_epoch {epoch} for "
        f"{len(applied)} applied mutations; ledger, GET /config, CONFIG "
        f"markers and the bundle's config records all {want_trail}; the "
        f"token in none of ledger, HTTP bodies, bundle, log, timeline")
    log(f"phase 20 (d): {phase_s:.1f} s; step {bus_ms:.2f} ms median "
        f"(steps 1-4, host clock after synchronize) with the bus live, "
        f"against phase 3's {main_path['step_ms_median']:.2f}; on {card}")
    return {"losses": losses, "step_ms": ms, "bus_ms_median": bus_ms,
            "phase3_step_ms_median": main_path["step_ms_median"],
            "held_s": held_s, "held_steps": n,
            "stall_pending_s": stall_marks[0]["pending_s"],
            "buckets_per_step": buckets[0], "trail": want_trail,
            "config_epoch": epoch, "phase_s": phase_s,
            "launches": launches}


def _gauge_value(snap, name, **labels):
    for s in snap["gauges"].get(name, []):
        if all(str(s["labels"].get(k)) == str(v) for k, v in labels.items()):
            return s["value"]
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,"
                            "19,20",
                    help="comma-separated phases to run (default "
                         "1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19,"
                         "20; 6, 7 and 8 need 3)")
    args = ap.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",")}
    if phases & {6, 7, 8} and 3 not in phases:
        fail("phases 6, 7 and 8 compare their losses with phase 3's: run 3")

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the GPU")
    try:
        import horovod_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"horovod_tpu_torch is not importable ({e}); run from the "
             "repository root")
    card = phase_build()
    report = phase_kernels() if 2 in phases else {}
    launches = {}     # path -> {kernel: launches in that path's run}
    if 3 in phases:
        phase_reference_check()
        main_path = phase_main_path(card)
        launches["gpt2_medium"] = main_path.pop("launches")
        print(json.dumps({"main_path": main_path}), flush=True)
    if 4 in phases:
        print(json.dumps({"models": phase_models(card)}), flush=True)
    shapes = {}
    if 5 in phases:
        new = phase_new_paths(card)
        shapes = new.pop("kernels")
        for name, run in new["trained"].items():
            launches[name] = run.pop("launches")
        print(json.dumps({"phase5": new}), flush=True)
    ctl = None
    if 6 in phases:
        ctl = phase_controller(card, main_path)
        launches["gpt2_medium_controller"] = ctl.pop("launches")
        print(json.dumps({"phase6": ctl}), flush=True)
    if 7 in phases:
        depth = phase_collective_depth(card, main_path)
        launches.update(depth.pop("launches"))
        print(json.dumps({"phase7": depth}), flush=True)
    if 8 in phases:
        el = phase_elastic(card, main_path)
        launches.update(el.pop("launches"))
        print(json.dumps({"phase8": el}), flush=True)
    long_run = None
    if 9 in phases:
        zoo = phase_zoo(card, main_path if 3 in phases else None)
        launches.update(zoo.pop("launches"))
        shapes.update(zoo.pop("kernels"))
        long_run = zoo["trained"]["gpt2_long"]
        print(json.dumps({"phase9": zoo}), flush=True)
    if 10 in phases:
        lc = phase_long_context(card, long_run)
        launches.update(lc.pop("launches"))
        shapes.update(lc.pop("kernels"))
        print(json.dumps({"phase10": lc}), flush=True)
    zero1 = None
    if 11 in phases:
        fs = phase_functional_step(card, main_path if 3 in phases else None)
        launches.update(fs.pop("launches"))
        zero1 = fs["zero1"]
        print(json.dumps({"phase11": fs}), flush=True)
    if 12 in phases:
        z = phase_fsdp(card, main_path if 3 in phases else None, zero1,
                       remat_full=None if 9 not in phases else
                       zoo["trained"]["gpt2_medium_remat_full"])
        launches.update(z.pop("launches"))
        print(json.dumps({"phase12": z}), flush=True)
    if 13 in phases:
        tp = phase_tensor_parallel(card, main_path if 3 in phases else None)
        launches.update(tp.pop("launches"))
        shapes.update(tp.pop("kernels"))
        print(json.dumps({"phase13": tp}), flush=True)
    if 14 in phases:
        mesh = phase_mesh(card, main_path if 3 in phases else None,
                          zoo["trained"]["llama_moe"] if 9 in phases
                          else None)
        launches.update(mesh.pop("launches"))
        shapes.update(mesh.pop("kernels"))
        print(json.dumps({"phase14": mesh}), flush=True)
    if 15 in phases:
        t5_tp = phase_t5_tp(card)
        launches.update(t5_tp.pop("launches"))
        print(json.dumps({"phase15": t5_tp}), flush=True)
    if 16 in phases:
        pp = phase_pipeline(card)
        launches.update(pp.pop("launches"))
        shapes.update(pp.pop("kernels"))
        print(json.dumps({"phase16": pp}), flush=True)
    if 17 in phases:
        obs = phase_observability(card, main_path if 3 in phases else None,
                                  ctl)
        launches["gpt2_medium_observed"] = obs.pop("launches")
        print(json.dumps({"phase17": obs}), flush=True)
    if 18 in phases:
        prof = phase_profiler(card, main_path if 3 in phases else None)
        launches["gpt2_medium_instrumented"] = prof.pop("launches")
        print(json.dumps({"phase18": prof}, default=str), flush=True)
    if 19 in phases:
        box = phase_blackbox(card, main_path if 3 in phases else None)
        launches["gpt2_medium_blackbox"] = box.pop("launches")
        print(json.dumps({"phase19": box}, default=str), flush=True)
    if 20 in phases:
        bus = phase_confbus(card, main_path if 3 in phases else None)
        launches["gpt2_medium_confbus"] = bus.pop("launches")
        print(json.dumps({"phase20": bus}, default=str), flush=True)
    for name, row in report.items():
        row["launches_per_path"] = {p: n.get(name, 0)
                                    for p, n in launches.items()}
        row["launches"] = sum(row["launches_per_path"].values())
        row["paths"] = {p: k[name] for p, k in shapes.items()}
    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
