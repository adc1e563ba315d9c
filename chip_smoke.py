#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training (single-device and ZeRO),
checkpoint-to-serving, HTTP serving, load-test, Hugging Face interop,
multi-LoRA serving, Mixtral (mixture-of-experts), model-parallel and
replica-fleet paths on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run if its check fails:

1. Card and build: the card's name and power limit, then every kernel of
   ``dlti_tpu_torch/csrc`` built with ``nvcc`` for ``sm_90a`` (one process
   per source, all started together).
2. The paged decode kernel (K4) against its plain PyTorch version at the
   decode shapes of the presets it serves (llama2_7b, llama3_8b's GQA,
   mistral_7b's window, head_dim 256, a float32 pool, poisoned pool rows and
   garbage table entries), with each case's error, kernel time, bound, plain
   time and the time of ``F.scaled_dot_product_attention`` over the gathered
   window (a yardstick the port never calls). Then K4's int8 program (K4q)
   the same way on int8 pools with float32 row scales: llama2_7b, llama3_8b's
   GQA, mistral_7b's window, head_dim 256, and NaN in the scales of every
   row that is not live with garbage table entries (SDPA over the window
   dequantized once, outside the timed call). Float16 pools too: llama2_7b,
   llama3_8b's GQA with a bf16 query, mistral_7b's window with poisoned
   rows, head_dim 256. bf16 and float16 outputs are held to an absolute
   limit and to one relative to each batch row's largest output (one step
   of the type); a planted 25% scale fault in a late tile must fail the
   second. Each case prints its program and its split-K plan (splits x
   tokens a split).
3. The engine at full width: llama2_7b in bfloat16 from
   ``init_params(seed=0)``, its decode iteration captured as a CUDA graph
   (``warmup_decode_ladder``), 12 requests (prompts of 16 to 300 tokens,
   greedy and seeded sampling) submitted to ``InferenceEngine`` and driven
   by ``step`` with 8 slots, so admission happens mid-flight. Every request
   must finish with its token count, and K4 must have been launched once per
   layer per decode step (graph replays credit the counter with what the
   capture counted). Then an equality script (8 requests of 24-96 tokens,
   greedy and seeded, admitted in one wave) four ways: steps_per_sync 1
   eager (``EngineExecutor(cuda_graphs=False)``), 1, 8 and 64 graphed. Every
   request's tokens and logprobs must be identical across the four; each
   run prints ms per device step (host clock over each window / k), decode
   tok/s, windows and host syncs per token.
4. Inside the model, on the k = 8 graphed engine: one decode step's logits
   through K4 against the same step through the plain gather path
   (``paged_attention_impl="gather"``), and K4 against its plain version on
   the engine's real pool, tables and lengths, where its time is taken for
   the record, and again on a float16 copy of that pool with a float16
   query (the fp16 path's K4 at this decode state). Then
   ``torch.cuda.set_sync_debug_mode("error")`` around the dispatch of an
   8-step window: nothing in it may wait on the card.
5. Profile: ``torch.profiler`` over the next 8-step graphed window, for the
   device's busy share and the kernels by device time; K4's split kernel
   and its combine kernel must run inside the replays, as many times as the
   launch counter says. Then the LM head (F2): a decode forward profiled
   with shapes must show the head's GEMM on bf16 inputs, and its memory
   peak must stay under the float32 head copy (524 MB) it used to make. The
   engine and its KV pool are then released.
6. Flash attention K1 (forward), K2 (dq) and K3 (dk/dv) against their plain
   versions: llama2_7b's training shape, llama3_8b's GQA at s 2048,
   mistral_7b's window 4096 at s 8192, head_dim 256 and 64, float32, and a
   packed batch at the unaligned length 1000 with padding rows; then in
   float16 the training shape, head_dim 256 and 64, the packed case, and
   the training shape with dO at 2**12 (a gradient of 2**-4 under the
   default loss scale), v at 2**5 and q, k at 2**-4, whose ds pass
   float16's 65504 (the plain version's max |ds| must exceed it) while dq,
   dk and dv stay finite; those are compared in units of 2**12. Each
   kernel's program in each case (``kernel_design``: wgmma on the tensor
   cores for bf16 and float16 K1 and K2, and K3 at d 64/128, which 2-byte K2
   must run; the CUDA cores otherwise), time, bound, plain time and SDPA's
   time (forward for K1, its autograd backward for K2 and K3).
7. The trainer at full width: llama2_7b bf16 with LoRA r=16 on q/k/v/o
   (dropout 0.05) from ``init_params(seed=0)``, 8 steps of
   ``Trainer.train`` over ``make_batches`` (byte tokenizer, texts from a
   seeded generator, seq 512, micro-batch 4, grad-accum 2, warmup 2, lr
   2e-4, remat on), with ``save_strategy="no"`` so its numbers stay
   comparable; each step one replay of the step's CUDA graph (one capture).
   Losses and grad norms finite, every ``lora_b`` moved off zero, and K1
   launched 2 x 32 x 2 x 9 times (forward and remat recompute, over the 8
   replayed steps and the capture's eager warm-up step), K2 and K3 32 x 2 x
   9. Before it, and released before it, its first 4 steps through an eager
   ``Trainer(cuda_graphs=False)`` from the same weights: losses and grad
   norms must be bit-equal. Prints
   both runs' step ms, tokens/s, MFU (4N FLOPs per token), peak memory and
   host syncs per step. Its losses and grad norms are phase 13's and phase
   14's reference.
8. Kernel path against reference path: one step's loss and LoRA grads with
   the kernels and with ``attention_impl="reference"``, same weights and
   batch, dropout off; then known-wrong controls (the kernels' outputs given
   seeded multiplicative noise), which the same gate must refuse.
9. Profiles: one eager train step, then a window of 2 graph replays
   (``StepWindow``, captured before the profile): wall and device busy time
   a step, busy share, kernels a step, time by kernel group; K1, K2 and K3
   must appear as their wgmma kernels in both. The trainer is then
   released.
14. Windows, eval and the chunked loss (run after phase 9, before phase 13),
    llama2_7b at full width and depth: phase 7's configuration over 2
    epochs of its 12 steps with ``steps_per_sync`` 8, ``max_steps`` 16 and
    ``eval_steps`` 8 on 4 eval batches (windows of 8, 4 at the epoch's end
    and 4 to ``max_steps``; evals at steps 8 and 16): steps 1-8 must be
    bit-equal to phase 7's. Then ``loss_chunk=128`` over the first window (8
    steps; cut from 16 in PR 11 to make room for phase 17): step 1's loss
    within 1e-4 of the run without, the peak memory below that run's, and
    K1-K3 launches a step unchanged.
    Prints each run's step ms, tokens/s, peak memory and host syncs per
    step.
10. The OpenAI server at full width on an int8 KV pool: llama2_7b from the
    serve CLI's own builder (``--random-init llama2_7b --tokenizer byte
    --kv-cache-dtype int8`` and the CLI's defaults: 8 slots, 2048 blocks of
    16, max_model_len 2048) behind ``make_server`` on a free port. 12
    concurrent requests (6 greedy completions of 32 tokens with prompts of
    16-300 bytes, 2 streamed, 2 chat, 1 seeded ``n: 2``, 1 with a ``stop``
    string), then one greedy prompt twice and streamed, one at a time. Every
    response 200 with no SSE error frame or ``error`` finish, ``usage``
    agreeing with the tokens, the repeated prompt identical, the streamed
    deltas the completion's text, ``/health`` 200, ``/metrics`` with
    ``dlti_requests`` >= 12 and the TTFT histogram; K4q launched exactly 32
    x decode steps and the float K4 never. Prints requests/s, output tok/s,
    TTFT p50/p99 and mean TPOT from ``/stats``, and the pool's bytes. Then
    the same again as the reference's documented serving configuration
    (``--max-seqs 28 --steps-per-sync 64 --quantization int8``: int8
    weights), followed by the sync check on its int8 pool.
11. Inside the model on the int8 pool: one decode step's logits through K4q
    against the gather path (dequantized in float32), gated; against the
    same step on a bf16 pool, printed only (quantization error). Then K4q
    against its plain version on the engine's pool and tables, timed.
12. (In a thread beside phase 17, whose subprocesses leave the host and
    the card room.) The entry points themselves, as subprocesses on the card, on
    ``llama_300m`` (head dim 64, which K1-K3 take): ``cli.train --max-steps
    4 --save-steps 2 --output-dir D --export-dir E`` exits 0 leaving steps 2
    and 4 in D; ``cli.export --checkpoint-dir D --out E2`` prints the digest
    of E's params; ``cli.serve --model-dir E --kv-cache-dtype int8
    --steps-per-sync 4 --port 0`` answers ``/health`` and a completion and
    exits 0 on SIGTERM (until phase 21 needed the room, a ``--random-init
    llama_tiny`` server with those flags did so first: phase 10 builds
    ``--random-init`` servers through the same builder).
13. Train -> checkpoint -> resume -> export -> serve (run after phase 14,
    before the servers), llama2_7b at full width and full depth (``layers
    32 of 32``; a checkpoint is ~13.7 GB, and ``shutil.disk_usage`` must
    show room for two checkpoints and an export, ~41 GB, or the phase
    fails with the number), in a temporary directory the phase removes. A
    fresh ``Trainer`` (phase 7's config, ``save_steps=4``,
    ``save_total_limit=2``, async) commits step 4; a second fresh one,
    from other random weights, resumes from step 4 (its log says so), runs
    steps 5-8 (each trainer its own CUDA graph of the step), whose losses
    and grad norms must be bit-equal to phase 7's, and commits step 8. ``verify_checkpoint`` passes step 8 (the resume re-hashed step 4). The step-8
    checkpoint is exported through ``cli.export``'s function, merged on the
    card; its manifest digest must equal that of ``merge_lora_params`` of
    the live resumed state, and its ``config.json`` has LoRA off. An engine
    from ``cli.serve.build --model-dir <export> --tokenizer byte`` (bf16
    pool, the CLI's defaults: 8 slots, max_model_len 2048, so 128-block
    tables) serves 4 greedy requests, with K4 counted 32 x decode steps.
    Then phase 4's check on that engine, whose tables give K4 a split plan
    no other phase holds: one decode step's logits through K4 against the
    gather path, and K4 against its plain version on the engine's own pool
    and tables (these launches are not counted).
    Prints the host's rates (SHA-256, pinning, copies from the card), the
    loop's stall per save, the writer's seconds and GB per save, write+hash
    GB/s, restore, export and load seconds, and free disk, beside the
    card's name and power limit.

15. The fp16 path (run after phase 13, before the servers), llama2_7b at
    full width: ``cli.train``'s own configuration with ``--fp16`` (the model
    in float16 under the dynamic loss scaler from 2**16) and phase 7's
    settings for 16 graphed steps at full depth (32 until PR 11, cut to make
    room for phase 17; at 2**16 its first steps
    overflow and the scale halves until the grads fit: the scales must
    follow the scaler's rule replayed on the host, and a later step must
    apply), K1-K3 in float16 counted as in phase 7, its step ms, tokens/s,
    MFU and peak memory printed beside phase 7's bf16 step; then a run from
    2**40 (4 layers, 72 steps, windows of 8, graphed) that must skip and
    halve until the grads fit, its first 16 steps bit-equal to an eager
    run's (losses, grad norms, scales); then, at 8 layers, a checkpoint at
    step 4 and a fresh trainer's resume whose steps 5-8 (and scaler) are
    bit-equal to an uninterrupted run, ``cli.export --fp16`` and
    ``cli.serve.build --model-dir --kv-cache-dtype float16`` serving 4
    greedy requests with K4 counted layers x decode steps, and phase 4's
    check on that engine.

16. ZeRO on one card (run last): phase 7's configuration, llama2_7b LoRA at
    full width and depth, graphed, 3 steps (8 until phase 20 needed the
    room, 4 until phase 23 did) under ``baseline``, ``zero1``,
    ``zero2``, ``zero3``, ``zero3`` with both host offloads and ``zero3`` on
    the tensor-parallel path (a tensor group of one, phase 23 (c): the ZeRO-3
    optimizer and step beside every tensor collective, captured; phase 21
    (c) runs that path under ``baseline``), in a NCCL
    process group of one joined through the launcher's env
    (``launcher.maybe_initialize_from_env``): every run's losses and grad
    norms bit-equal to the group's baseline (and that to phase 7's first 3
    steps without a group), K1-K3 counted per run as in phase 7, every offloaded
    leaf a pinned host tensor. Prints each strategy's step ms, tokens/s,
    peak memory and launches; each run appends its row to one metrics CSV
    (``TrainConfig.metrics_csv``), and ``analysis.compare`` prints the six
    rows' table (no plot); the group is destroyed at the end.
17. The README Quickstart through the port's CLIs as subprocesses (run
    last): ``cli.prepare_dataset --synthetic 2000 --write-token-store S``;
    ``cli.train --model llama2_7b --preset baseline --dataset-path S
    --tokenizer byte --lora-r 16 --quantize-base int8 --remat-policy none
    --steps-per-sync 2 --max-steps 4 --metrics-csv C --step-log L
    --export-dir E`` (the CLI's batch defaults: micro-batch 1 x accum 16,
    seq 512; full width and depth); the same without ``--quantize-base`` as
    the yardstick; ``cli.compare_training --csv C --no-plots``; ``cli.serve
    --model-dir E`` with the documented flags (int8 weights, int8 KV, 28
    slots, k 64) answering phase 10's 12 requests over HTTP; the engine
    built from E with int8 and with bf16 weights, 28 greedy requests each;
    ``cli.run_experiments --model llama2_7b --strategies baseline,zero3
    --device-counts 1 --max-steps 1 --gradient-accumulation-steps 2`` into
    its own CSV, compared, both rows' final losses equal (cut from 20 steps
    at 10 a sync, 64 engine tokens to 16, the matrix's 2 steps of 16
    microbatches, and 56 step-5 requests to make room for phase 20). Each run
    must take 2 windows and 1 capture, launch K1-K3 32 x 16 = 512 times a
    step each (no remat: nothing recomputed), and log 6 lines; the int8
    run must peak 5 GB below the bf16 run, and the int8-weight engine 5 GB
    below the bf16-weight engine. Prints each run's step ms, tokens/s, MFU,
    peak and launches a step, the server's TTFT and TPOT, both engines'
    peaks, and the CSVs' tables. The server then takes Quickstart step 5
    as a subprocess, ``cli.benchmark_serving --num-requests 28
    --concurrency 28 --max-tokens 256`` (the README's 112 and 56, cut to
    make room for phases 19 and 20): 28 ok, none failed; prints
    requests/s, output tok/s, TTFT p50/p99 and mean TPOT.
18. The engine features at llama2_7b width (run last; phase 21's world runs
    beside it: both leave the card and the host room). First each feature
    against the engine without it, at full width cut to 8 layers in float32
    (TF32 off), from one ``init_params(seed=0)``: chunked prefill (256
    tokens a step, prompts of 600-1000 tokens) and ragged prefill (fewer
    prefill calls) against one call a bucket; prefix caching with a shared
    410-token prefix (the second wave must reuse it); a 100-block pool with
    a host tier that evicts the prefix and restores it; n-gram speculation
    (k 4, 8 rounds a sync, graphed) against plain decode, and against its
    rounds run eagerly. Greedy tokens identical in every pair; K4 launched
    layers x plain decode steps, as the decode graph credits; a spec
    window's dispatch under ``set_sync_debug_mode("error")``. Then over HTTP
    at the same width and depth (an export of ``init_params(seed=0)`` in
    bf16; cut from full depth to make room for phase 19):
    ``cli.serve --model-dir E --quantization int8
    --kv-cache-dtype int8 --max-seqs 28 --num-blocks 910 --steps-per-sync 32
    --max-prefill-tokens 256 --ragged-prefill --enable-prefix-caching
    --prefix-host-blocks 256 --speculative ngram --num-draft-tokens 4``
    under ``cli.benchmark_serving --sessions 8 --turns 4`` (prefix hit rate
    > 0) and ``--qps 1.5 --num-requests 8 --max-tokens 256
    --long-prompt-frac 0.25 --long-prompt-tokens 1024
    --scrape-server-metrics`` (spec proposed > 0), then the same flags
    without the features under the second: no request may fail. Prints
    TTFT p50/p99, TPOT, output tok/s, the hit rate, spec acceptance and
    tokens per slot-round, spec round and plain step ms, and the graph
    pool's size.
19. Hugging Face checkpoints, PEFT adapters and multi-LoRA serving (run
    last), llama2_7b at full width and depth: ``save_hf_checkpoint`` of
    ``init_params(seed=0)`` in bf16 (4 shards and an index) and
    ``load_hf_checkpoint`` back onto the card, every tensor bit-equal, GB
    and seconds each way; ``cli.train --init-from-hf DIR --lora-r 16`` (phase
    7's batch, 4 graphed steps, 2 a sync) with ``--export-peft`` and
    ``--export-hf``, K1-K3 counted as in phase 7, the HF export bit-equal to
    ``merge_lora_params`` of the run's base and the factors its PEFT export
    holds; the trained adapter (``load_peft_adapter`` -> ``save_adapter``)
    and a seeded one registered with ``--adapter`` and in the catalog; 8
    slots of base rows and both adapters in one decode batch (bf16 pool, k
    8, a row load under ``set_sync_debug_mode("error")``): base rows
    token-identical to the adapter-off engine's, K4 32 x decode steps, the
    pool's bytes the plan's, the decode step with and without the adapter
    branch; at 8 layers in float32 every row token-identical to an engine
    holding its adapter as static LoRA leaves; over HTTP on an int8 pool,
    ``POST /v1/adapters``, ``X-Adapter`` completions (K4q 32 x decode
    steps), a 404 for an unknown name and the ``dlti_adapter_*`` series on
    ``/metrics``. Every directory it writes is removed.

20. Mixtral-8x7B at full width and depth on one card (run last), its
    weights from ``init_params_int8(seed=0)`` (46.7 B parameters drawn and
    quantized leaf by leaf: 46.7 GB of int8 weights; the bf16 tree, 93 GB,
    would not fit). (a) Served through ``InferenceEngine``: int8 weights, a
    bf16 pool, 8 slots, the default capacity factor 1.25, the decode
    iteration as a CUDA graph; phase 3's 12 requests (prompts of 16-300
    tokens, 16 tokens each, greedy and seeded, 4 admitted mid-flight), K4
    32 x decode steps; then an 8-request equality script eager k 1, graphed
    k 1 and graphed k 8 (tokens and logprobs identical; every request runs
    9 tokens, so all 8 slots are busy at every step of both k: a free
    slot's row routes tokens of its own, zeros at k 1 and its draws inside
    a window, which under a dropping capacity moves the others'), and
    ``set_sync_debug_mode("error")`` around the k = 8 engine's 8-step
    window's dispatch; prints ms a device step, decode tok/s, the weight
    bytes and the peak. The engine is released. (b) Trained: phase 7's
    batch (micro-batch 4 x accum 2, seq 512, remat) with LoRA r=16 on
    q/k/v/o over the int8 base, 2 eager steps through ``Trainer(cuda_graphs=
    False)`` on ``cli.train``'s own config and dataset (released), then
    ``cli.train --model mixtral_8x7b --quantize-base int8 --lora-r 16 ...
    --max-steps 3 --step-log L --export-peft P`` as a subprocess, the step
    one CUDA graph: its first 2 steps' losses and grad norms bit-equal to
    the eager ones, K1 2 x 32 x 2 launches a step and K2/K3 32 x 2 (the
    capture's warm-up step once more), the router's load-balance loss finite
    and between 0.9 and 2.2 a layer, every exported ``lora_B`` nonzero;
    prints step ms, tokens/s, MFU on the 12.88 B active parameters and the
    peak. A witness for that loss (``mixtral_aux_witness``): one forward of
    the eager run's first microbatch, every layer's loss recomputed plainly
    in float64 from the states its router saw (within 1e-3) and, through
    the same router, on isotropic inputs (the reference's 0.9-1.6); prints
    each layer's values and how far its states share one direction. (c)
    The int8 weights' error: Mixtral-8x7B at full width cut to 2 layers, in
    bf16 from ``init_params(seed=0)`` and int8 quantized from the same draw,
    one no-grad forward of 4 prompts of 128 tokens each; prints the logits'
    largest difference relative to their scale and the argmax agreement (a
    reading, not gated; the logits must be finite).

21. Tensor parallelism on one card (before phase 22). (a) and (b) in a world of
    two ranks on this card over gloo, run in the background beside phase 18
    (``python -m dlti_tpu_torch.launcher --one-device --num-processes 2 --
    python chip_smoke.py --tensor-rank DIR``; NCCL refuses two ranks on one
    device), each joining through
    ``cli.serve``'s ``--tensor 2`` mesh: (a) llama2_7b at full width and
    depth from ``init_params(seed=0)`` sliced as drawn, 16 of 32 heads and
    KV heads a rank, a bf16 pool, eager decode, rank 0 scheduling and rank
    1 following: phase 3's first 4 requests (greedy and seeded) at 16
    tokens and their prompts' first-step logits; the same 4 at 16 tokens
    and 8 layers in float32; 4 requests of 8 tokens on an int8 pool (K4q).
    (b) Phase 7's LoRA training at ``tensor`` 2, 1 eager step, each rank's
    K1-K3 and peak. (c) In this process, a NCCL group of one with a tensor
    group of one (every tensor collective issued and captured): phase 3's
    12 requests through the decode graph, tokens and logprobs equal to
    phase 3's, and 4 graphed steps of phase 7's configuration, losses and
    grad norms bit-equal to phase 7's. (a)'s first-step logits within
    ``TP_LOGITS_REL_TOL`` of the one-rank engine's (relative to their
    scale); every token decoded on the bf16 and on the int8 pool scored
    teacher-forced by one rank on the same pool type (its prefix
    prefilled): each logprob within that bound, each greedy token one
    rank's argmax wherever one rank's top-2 margin exceeds it; the float32
    tokens a one-rank engine's; (b)'s loss and grad norm within
    ``TP_LOSS_RTOL``/``TP_GRAD_NORM_RTOL`` of phase 7's eager steps.
22. Sequence and pipeline parallelism on one card (run last). Phase 21's
    world of two ranks on this card over gloo runs them after its
    tensor-parallel runs (one launch, so the second world's start and its
    draw are saved), llama2_7b at full width and depth drawn once a rank:
    (a) LoRA r=16 at ``sequence`` 2, seq 4096 (phase 7's texts packed),
    micro-batch 1 x accum 2, 1 eager step (2 until phase 23 needed the
    room), each rank 2048 tokens of every row and attention the ring
    (``parallel.ring_attention``, plain
    arithmetic: no K1-K3); (b) LoRA at ``pipe`` 2, 16 layers a stage,
    phase 7's 8 rows of 512 as 8 microbatches of 1 row, 1 eager step
    through the GPipe schedule. Then here one rank's eager references on
    the same rows and microbatches: each run's losses and grad norms within
    ``SEQPIPE_RTOL`` of them, (b)'s losses within it of phase 7's; K1-K3 0
    under the ring and 2 x 16 x 8 / 16 x 8 a step on each stage; each
    rank's step seconds and peak printed.
23. ZeRO-3 with the model axes on one card (checked last; its world runs
    in the background beside phase 17, whose subprocesses leave the host and
    the card room). A world of four ranks on this card over gloo
    (``python -m dlti_tpu_torch.launcher --one-device --num-processes 4 --
    python chip_smoke.py --zero3-rank DIR``), each drawing llama2_7b at full
    width and depth leaf by leaf and
    keeping only its part (``init_params(mesh=)``): (a) ``zero3`` at ``fsdp``
    2 x ``tensor`` 2 (the README's ``--preset zero3 --tensor 2``), phase 7's
    LoRA configuration and batch, 1 eager step, held to phase 7's eager
    step (loss and grad norm within ``ZERO3_RTOL``, relative); (b)
    ``zero3`` at ``fsdp`` 2 x ``pipe`` 2, 16 layers a stage, phase 22 (b)'s
    8 rows as 2 microbatches of 4, 2 rows of each a fsdp rank (4
    microbatches of 1 row a rank until the room was needed), 1 eager step:
    its loss held
    to phase 22 (b)'s one-rank 8 x 1 reference and its loss and grad norm
    to one rank's step on the same microbatches (phase 22's references
    draw it: LoRA dropout follows the microbatches), both within
    ``ZERO3_RTOL``. Each rank prints its parameter bytes at rest (about a
    quarter of the whole model: the split), its peak, step seconds and
    K1-K3 counts, each stage twice 16 x 2 / 16 x 2 and each (a) rank twice
    32 x 2 / 32 x 2. (c) runs in phase 16's group, at ``fsdp`` 1: nothing is
    sharded, so on one card no phase runs ZeRO-3's ``fsdp`` gathers, their
    prefetch a block ahead or their reduce-scatters inside a CUDA graph over
    NCCL. (d) With four or more cards visible, those run:
    ``tests/test_torch_cuda.py -k across_cards`` (the five ZeRO-3 meshes,
    each graphed over NCCL, a rank a card, against one card's eager steps)
    as a subprocess, which must pass every case; with fewer, (d) is
    skipped and says so.
24. The replica fleet behind the admission gateway on one card (last):
    ``cli.serve``'s own builder with the documented configuration (int8
    weights, int8 KV, 28 slots, 64 steps a sync) and ``--replicas 2 --device
    cuda:0 --gateway --max-queued-requests 8 --self-heal --probation 0``:
    llama2_7b at full width and depth, two replicas on this card, each
    owning its weights, pool and decode graph, behind ``make_server``. (a)
    Admission: fillers hold every slot, then a burst of 24 greedy requests
    (a ``batch`` one queued first): 429s with ``Retry-After``, every
    admitted request 200, the batch request dequeued after the interactive
    ones queued with it, both replicas taking work, each admitted request's
    tokens equal to one replica's alone (teacher-forced within phase 21's
    bound where a bf16 near-tie flips one, and said so). (e) Drain on the
    same server: in-flight requests finish 200, a new one 503 and
    ``/health`` 503 ``draining``. Then offline: (b) a ``raise`` at replica
    1's fourth step (``fault_inject_step`` "1:4"): its requests finish on
    replica 0 without errors, the replica is rebuilt from the host copy of
    its weights (its old engine freed first), passes its canary and is live
    (rebuild seconds, peak memory); (c) ``"0:4:preempt"``: greedy and
    seeded decodes migrate by paged-KV handoff, byte-equal to the unfaulted
    run (ms a migration); (d) a rolling reload of the same weights from a
    ``save_pytree`` export (written in a thread beside (a)-(c)), loaded
    digest-verified and re-verified before each swap: outputs byte-equal
    before, during and after, 0 errors, 2 live. (f) With two or more cards,
    ``tests/test_torch_cuda.py -k replica_fleet_across_cards`` as a
    subprocess (one replica a card); with one, skipped and said so. K4q
    counted through (a)-(d) (layers x decode steps in (a), per replica);
    readings: the burst through the fleet and through one replica offline
    (requests/s, mean TPOT).

Prints ``[time]`` lines with each group of phases' wall clock, a
``{"kernels": [...]}`` line (each kernel's float16 mode a row of
its own), and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero without that line when
there is no CUDA device, when the package is not beside this file, or when
any check fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import logging
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, dense bf16
# tensor-core rate, float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

# Kernel output against the plain version on identical inputs, by the
# output's (the query's) type. float32: the two sum in different orders
# (1e-5 absolute). bfloat16: both round an fp32 result to bf16, whose
# spacing below |x| = 4 is at most 2**-6, so they may land one bf16 step
# apart. float16: the same with 3 more bits, one float16 step, 2**-9.
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6, "float16": 2.0 ** -9}
# The same bound per batch row, relative to the row's largest |output|: one
# step of an element x is at most 2**-7 |x| in bf16, 2**-10 |x| in float16.
# Long rows average many tokens into small outputs, where the absolute limit
# would not see a fault.
ROW_REL_TOL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
# Whole-model logits, kernel path against gather path in bfloat16: the two
# attention outputs may differ by one bf16 step per element and 32 layers
# carry that on, so the bound is relative to the logits' scale.
LOGITS_REL_TOL = 5e-2

KERNEL_REPLACES = "dlti_tpu/ops/pallas/paged_attention.py:46"


def log(*args):
    print(*args, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


# ----------------------------------------------------------------------
# Timing and bounds
# ----------------------------------------------------------------------

# GPU cycles the card spins before each timed call (about 0.5 ms): the host
# prepares the call meanwhile, so the start event does not wait on it.
HOST_COVER_CYCLES = 1_000_000


def time_ms(torch, fn, iters: int = 20, flush=None) -> float:
    """Mean device time of ``fn`` by CUDA events around each call. With
    ``flush`` (a large buffer), L2 is overwritten before every call, as the
    next layer's decode finds it. A spin kernel queued ahead of the start
    event covers the wrapper's host time (argument checks, ctypes), so a
    short kernel's reading is the card's time, not the host's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(HOST_COVER_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def decode_work(q, k_pool, block_tables, seq_lens, window):
    """Bytes the paged decode must move and operations it must do for
    these inputs: K and V of every live (token, kv head) once (with their
    two float32 scales on an int8 pool), q and the output once, the live
    table entries and the lengths; two multiply-adds per (token, query
    head, channel)."""
    batch, _, heads, d = q.shape
    bs, kvh = k_pool.shape[1], k_pool.shape[2]
    lens = seq_lens.long().clamp(min=0, max=block_tables.shape[1] * bs)
    start = (lens - window).clamp(min=0) if window else lens * 0
    tokens = int((lens - start).sum())
    first_blk, last_blk = start // bs, (lens + bs - 1) // bs
    live_blocks = int((last_blk - first_blk).clamp(min=0).sum())
    kv_bytes = 2 * tokens * kvh * d * k_pool.element_size()
    if not k_pool.dtype.is_floating_point:  # int8: a float32 scale per row
        kv_bytes += 2 * 4 * tokens * kvh
    qo_bytes = 2 * q.numel() * q.element_size()
    meta_bytes = 4 * (live_blocks + batch)
    ops = 4 * tokens * heads * d
    return kv_bytes + qo_bytes + meta_bytes, ops


def bound(nbytes: int, ops: int, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_over_gathered(torch, q, k_pool, v_pool, block_tables, seq_lens, window,
                       k_scale=None, v_scale=None):
    """The library yardstick: ``scaled_dot_product_attention`` over the
    window gathered from the pool (the gather, and an int8 pool's
    dequantization, done once, outside the timed call). Returns the timed
    closure."""
    import torch.nn.functional as F

    batch, _, heads, d = q.shape
    nb, bs, kvh, _ = k_pool.shape
    bt = block_tables.long().clamp(0, nb - 1)
    max_len = bt.shape[1] * bs
    k = k_pool[bt].float() if k_scale is not None else k_pool[bt]
    v = v_pool[bt].float() if v_scale is not None else v_pool[bt]
    if k_scale is not None:
        k = k * k_scale[bt][..., None]
        v = v * v_scale[bt][..., None]
    k = k.reshape(batch, max_len, kvh, d).transpose(1, 2).to(q.dtype)
    v = v.reshape(batch, max_len, kvh, d).transpose(1, 2).to(q.dtype)
    pos = torch.arange(max_len, device=q.device)[None, :]
    lens = seq_lens.long()[:, None]
    valid = pos < lens
    if window:
        valid &= pos >= lens - window
    mask = valid[:, None, None, :]
    qh = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(
        qh, k, v, attn_mask=mask, enable_gqa=kvh != heads)


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------

def phase_card_and_build(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from dlti_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build()
    log(f"[build] {len(paths)} source(s) in {time.perf_counter() - t0:.2f} s")
    for name, info in _build.build_log.items():
        usage = sorted({line.split(":", 1)[1].strip() for line in info["log"].splitlines()
                        if "registers" in line})
        log(f"[build] csrc/{name}.cu nvcc {info['seconds']:.2f} s; ptxas: "
            + "; ".join(usage))
    return card


def make_decode_case(torch, gen, *, heads, kv_heads, d, dtype, block_size,
                     seq_lens, max_blocks, window=None, poison=False, int8=False,
                     q_dtype=None):
    """A pool holding exactly the blocks the sequences use (a random
    permutation of them), plus block tables. With ``poison``, every pool row
    that is not live holds NaN (on an int8 pool: its scales do) and table
    entries past each sequence point at random (poisoned) blocks; otherwise
    they are -1. With ``int8`` the pools are quantized as ``paged_update``
    stores them and the scales come back in a dict. The query is ``dtype``
    unless ``q_dtype`` names another."""
    dev = torch.device("cuda")
    batch = len(seq_lens)
    need = [-(-n // block_size) for n in seq_lens]
    num_blocks = sum(need) + 8
    k_pool = torch.randn(num_blocks, block_size, kv_heads, d, device=dev,
                         generator=gen).to(dtype)
    v_pool = torch.randn(num_blocks, block_size, kv_heads, d, device=dev,
                         generator=gen).to(dtype)
    perm = torch.randperm(num_blocks, device=dev, generator=gen).to(torch.int32)
    if poison:
        tables = torch.randint(0, num_blocks, (batch, max_blocks), device=dev,
                               generator=gen, dtype=torch.int32)
    else:
        tables = torch.full((batch, max_blocks), -1, device=dev, dtype=torch.int32)
    live = torch.zeros(num_blocks * block_size, dtype=torch.bool, device=dev)
    nxt = 0
    for b, n in enumerate(seq_lens):
        blocks = perm[nxt:nxt + need[b]]
        tables[b, :need[b]] = blocks
        t = torch.arange(max(0, n - window) if window else 0, n, device=dev)
        live[blocks[t // block_size].long() * block_size + t % block_size] = True
        nxt += need[b]
    scales = {}
    if int8:
        from dlti_tpu_torch.ops.kv_cache import _quantize_rows

        (k_pool, scales["k_scale"]), (v_pool, scales["v_scale"]) = (
            _quantize_rows(k_pool), _quantize_rows(v_pool))
    if poison:
        live = live.view(num_blocks, block_size)
        for t in (scales.values() if int8 else (k_pool, v_pool)):
            t[~live] = float("nan")
    q = torch.randn(batch, 1, heads, d, device=dev, generator=gen).to(q_dtype or dtype)
    lens = torch.tensor(seq_lens, device=dev, dtype=torch.int32)
    return q, k_pool, v_pool, tables, lens, scales


def decode_errors(torch, out, ref):
    """(max abs error, max over batch rows of the row's max abs error over
    its max |ref|). A row whose reference is all zero (seq_len 0) must be
    exactly zero: any error there reads as infinite."""
    diff = (out.float() - ref.float()).abs().flatten(1).amax(1)
    scale = ref.float().abs().flatten(1).amax(1)
    row_rel = torch.where(scale > 0, diff / scale.clamp(min=1e-30),
                          torch.where(diff > 0, float("inf"), 0.0))
    return diff.max().item(), row_rel.max().item()


def measure_kernel(torch, tpa, q, k_pool, v_pool, tables, lens, window, flush,
                   scales=None):
    """Error against the plain version, and the four times. ``scales``: an
    int8 pool's ``k_scale``/``v_scale``; its tolerance and peak rate are
    those of q's dtype, in which both versions compute."""
    kw = dict(window=window, **(scales or {}))
    out = tpa.paged_decode_attention(q, k_pool, v_pool, tables, lens, **kw)
    splits, chunk = tpa.last_plan  # the plan this launch ran
    torch.cuda.synchronize()
    ref = tpa.paged_decode_attention_reference(q, k_pool, v_pool, tables, lens, **kw)
    check(torch.isfinite(out).all().item(), "kernel output is not finite")
    err, row_rel = decode_errors(torch, out, ref)
    out_name = str(q.dtype).split(".")[-1]  # the output's type: the tolerance's
    rate_name = str(q.dtype if scales else k_pool.dtype).split(".")[-1]
    nbytes, ops = decode_work(q, k_pool, tables, lens, window)
    bound_ms, bound_by = bound(nbytes, ops, rate_name)
    ms = time_ms(torch, lambda: tpa.paged_decode_attention(
        q, k_pool, v_pool, tables, lens, **kw), flush=flush)
    plain_ms = time_ms(torch, lambda: tpa.paged_decode_attention_reference(
        q, k_pool, v_pool, tables, lens, **kw), flush=flush)
    library_ms = time_ms(torch, sdpa_over_gathered(
        torch, q, k_pool, v_pool, tables, lens, window, **(scales or {})), flush=flush)
    return {"max_abs_err": err, "tol": TOL[out_name], "row_rel_tol": ROW_REL_TOL.get(out_name),
            "row_rel_err": row_rel, "pool": str(k_pool.dtype).split(".")[-1],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "bytes": nbytes, "ops": ops, "splits": splits,
            "chunk": chunk, "design": tpa.kernel_design(k_pool.dtype, q.shape[3])}


def planted_scale_fault(torch, tpa, q, k_pool, v_pool, tables, lens, scales):
    """Known-wrong control for the int8 gate: K4q reads ``v_scale`` 25% high
    on the last block of the longest sequence (a scale misread in a late
    tile) and is held against the plain version on the true scales. The
    row-relative limit must refuse it; the absolute one, which such a fault
    can pass, is printed beside."""
    row = int(lens.argmax())
    block = int(tables[row, (int(lens[row]) - 1) // k_pool.shape[1]])
    bad = scales["v_scale"].clone()
    bad[block] *= 1.25
    out = tpa.paged_decode_attention(q, k_pool, v_pool, tables, lens,
                                     k_scale=scales["k_scale"], v_scale=bad)
    ref = tpa.paged_decode_attention_reference(q, k_pool, v_pool, tables, lens, **scales)
    err, row_rel = decode_errors(torch, out, ref)
    log(f"[kernel] control, v_scale x1.25 on row {row}'s last block: max_abs_err "
        f"{err:.3e} (abs tol {TOL['bfloat16']:.3e}), row rel {row_rel:.3e} "
        f"(tol {ROW_REL_TOL['bfloat16']:.3e}): must be refused")
    check(row_rel > ROW_REL_TOL["bfloat16"],
          "the row-relative gate passed a planted scale fault")


def phase_kernel_cases(torch, flush):
    """K4 on float pools (float16 ones with float16 and bf16 queries), then
    its int8 program (K4q) on int8 pools with float32 row scales and bf16
    queries, against their plain version. Returns (float cases, int8
    cases)."""
    from dlti_tpu_torch.ops import paged_attention as tpa

    gen = torch.Generator(device="cuda").manual_seed(1234)
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    # Decode batches of 8 at block_size 16 with a ragged mix: a seq_len of 0
    # (an idle slot), single tokens, tails inside a block, a full table.
    lens_1k = [0, 1, 17, 100, 255, 316, 600, 1024]
    lens_8k = [0, 5, 100, 4095, 4097, 5000, 6000, 8192]
    int8 = dict(dtype=bf16, int8=True)
    cases = [
        ("llama2_7b", dict(heads=32, kv_heads=32, d=128, dtype=bf16,
                           seq_lens=lens_1k, max_blocks=64)),
        ("llama3_8b_gqa", dict(heads=32, kv_heads=8, d=128, dtype=bf16,
                               seq_lens=lens_1k, max_blocks=64)),
        ("mistral_7b_window", dict(heads=32, kv_heads=8, d=128, dtype=bf16,
                                   seq_lens=lens_8k, max_blocks=512, window=4096)),
        ("gemma_7b_d256", dict(heads=16, kv_heads=16, d=256, dtype=bf16,
                               seq_lens=lens_1k, max_blocks=64)),
        ("llama2_7b_fp32", dict(heads=32, kv_heads=32, d=128, dtype=f32,
                                seq_lens=lens_1k, max_blocks=64)),
        ("poisoned_rows_garbage_tables", dict(heads=32, kv_heads=8, d=128,
                                              dtype=bf16, seq_lens=lens_1k,
                                              max_blocks=64, poison=True)),
        ("fp16_llama2_7b", dict(heads=32, kv_heads=32, d=128, dtype=f16,
                                seq_lens=lens_1k, max_blocks=64)),
        ("fp16_pool_bf16_q_llama3_8b_gqa", dict(heads=32, kv_heads=8, d=128, dtype=f16,
                                                q_dtype=bf16, seq_lens=lens_1k,
                                                max_blocks=64)),
        ("fp16_mistral_7b_window_poisoned", dict(heads=32, kv_heads=8, d=128, dtype=f16,
                                                 seq_lens=lens_8k, max_blocks=512,
                                                 window=4096, poison=True)),
        ("fp16_d256", dict(heads=16, kv_heads=16, d=256, dtype=f16, seq_lens=lens_1k,
                           max_blocks=64)),
        ("int8_llama2_7b", dict(heads=32, kv_heads=32, d=128, seq_lens=lens_1k,
                                max_blocks=64, **int8)),
        ("int8_llama3_8b_gqa", dict(heads=32, kv_heads=8, d=128, seq_lens=lens_1k,
                                    max_blocks=64, **int8)),
        ("int8_mistral_7b_window", dict(heads=32, kv_heads=8, d=128, seq_lens=lens_8k,
                                        max_blocks=512, window=4096, **int8)),
        ("int8_d256", dict(heads=16, kv_heads=16, d=256, seq_lens=lens_1k,
                           max_blocks=64, **int8)),
        ("int8_nan_scales_garbage_tables", dict(heads=32, kv_heads=8, d=128,
                                                seq_lens=lens_1k, max_blocks=64,
                                                poison=True, **int8)),
    ]
    results, int8_results = {}, {}
    for name, kw in cases:
        window = kw.get("window")
        *inputs, scales = make_decode_case(torch, gen, block_size=16, **kw)
        r = measure_kernel(torch, tpa, *inputs, window, flush, scales=scales)
        (int8_results if scales else results)[name] = r
        log(f"[kernel] {name} ({r['design']}; {r['splits']} splits of {r['chunk']} "
            f"tokens): max_abs_err {r['max_abs_err']:.3e} (tol "
            f"{r['tol']:.3e}), row rel {r['row_rel_err']:.3e}; kernel {r['ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, plain "
            f"{r['plain_ms']:.4f} ms, sdpa"
            f"{' over the dequantized window' if scales else ''} "
            f"{r['library_ms']:.4f} ms")
        check(r["max_abs_err"] <= r["tol"],
              f"kernel disagrees with its plain version on {name}: "
              f"{r['max_abs_err']} > {r['tol']}")
        if r["row_rel_tol"] is not None:
            check(r["row_rel_err"] <= r["row_rel_tol"],
                  f"kernel disagrees with its plain version on {name}: row rel "
                  f"{r['row_rel_err']} > {r['row_rel_tol']}")
        if name == "int8_llama2_7b":
            planted_scale_fault(torch, tpa, *inputs[:5], scales)
        del inputs, scales
    torch.cuda.empty_cache()
    return results, int8_results


def card_engine(cfg, params, ec, graphs=True):
    """An engine on the card; ``graphs=False`` runs the decode iteration
    eagerly (the executor's constructor argument, for comparisons only)."""
    from dlti_tpu_torch.serving.engine import EngineExecutor, InferenceEngine

    ex = EngineExecutor(cfg, params, ec, device="cuda", cuda_graphs=graphs)
    return InferenceEngine(cfg, params, ec, device="cuda", executor=ex)


def window_clock(engine) -> list:
    """(k, seconds) of each decode window on the host clock, from the start
    of its dispatch to the end of its completion (which waits for it)."""
    spans, t = [], {}
    dispatch, complete = engine._decode_dispatch, engine._decode_complete

    def timed_dispatch():
        t["start"] = time.perf_counter()
        return dispatch()

    def timed_complete(pending):
        out = complete(pending)
        spans.append((pending[1], time.perf_counter() - t["start"]))
        return out

    engine._decode_dispatch, engine._decode_complete = timed_dispatch, timed_complete
    return spans


def free_memory(torch):
    """Return the memory of objects just dropped to the card."""
    gc.collect()
    torch.cuda.empty_cache()


# Phase 3's equality script: one wave of 8 requests (every slot admitted in
# the first step, so prefill groups and batch shapes match across runs),
# greedy and seeded, run four ways.
EQUALITY_RUNS = (("k=1 eager", 1, False), ("k=1 graph", 1, True),
                 ("k=8 graph", 8, True), ("k=64 graph", 64, True))
EQUALITY_LENGTHS = [16, 40, 77, 128, 200, 255, 300, 511]
EQUALITY_MAX_TOKENS = [24, 96, 33, 64, 48, 80, 57, 72]


def equality_requests(cfg):
    import numpy as np

    from dlti_tpu_torch.serving.sampling import SamplingParams

    rng = np.random.default_rng(2)
    out = []
    for i, (n, m) in enumerate(zip(EQUALITY_LENGTHS, EQUALITY_MAX_TOKENS)):
        sp = (SamplingParams(temperature=0.0, max_tokens=m) if i % 2 == 0 else
              SamplingParams(temperature=0.8, top_p=0.95, top_k=50, max_tokens=m,
                             seed=2000 + i))
        out.append((rng.integers(3, cfg.vocab_size, n).tolist(), sp))
    return out


ENGINE_MAX_TOKENS = 32


def engine_requests(cfg):
    """Phase 3's 12 requests: prompts of 16-300 tokens, 32 tokens each,
    greedy and seeded in turn."""
    import numpy as np

    from dlti_tpu_torch.serving.sampling import SamplingParams

    rng = np.random.default_rng(0)
    lengths = [16, 300] + rng.integers(16, 301, 10).tolist()
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in lengths]
    return [(p, SamplingParams(temperature=0.0, max_tokens=ENGINE_MAX_TOKENS) if i % 2 == 0
             else SamplingParams(temperature=0.8, top_p=0.95, top_k=50,
                                 max_tokens=ENGINE_MAX_TOKENS, seed=1000 + i))
            for i, p in enumerate(prompts)]


def engine_config(**kw):
    """Phase 3's engine sizing: 8 slots, a 1024-block bf16 pool, every
    request run to its max_tokens."""
    from dlti_tpu_torch.serving.engine import EngineConfig

    return EngineConfig(**{**dict(max_seqs=8, block_size=16, num_blocks=1024,
                                  max_model_len=1024, cache_dtype="bfloat16",
                                  eos_token_id=-1), **kw})


def phase_engine(torch):
    from dlti_tpu_torch.config import MODEL_PRESETS
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import paged_attention as tpa

    import numpy as np

    cfg = MODEL_PRESETS["llama2_7b"]
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    check(n_params == cfg.num_params(), f"{n_params} params, expected {cfg.num_params()}")
    log(f"[engine] llama2_7b: {n_params / 1e9:.3f} B params "
        f"({cfg.num_layers} layers, hidden {cfg.hidden_size}, {cfg.num_heads} "
        f"heads, vocab {cfg.vocab_size}) in {cfg.param_dtype}, made on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    ec = engine_config()
    engine = card_engine(cfg, params, ec)
    t0 = time.perf_counter()
    engine.warmup_decode_ladder()  # captures the decode graph, as the CLI does
    torch.cuda.synchronize()
    log(f"[engine] KV pool {sum(c['k'].numel() * 2 * c['k'].element_size() for c in engine.cache) / 1e9:.2f} GB, "
        f"decode graph captured in {time.perf_counter() - t0:.2f} s, device memory "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    reqs = engine_requests(cfg)
    lengths = [len(p) for p, _ in reqs]
    max_tokens = ENGINE_MAX_TOKENS

    # Device time of each prefill call and decode window, by CUDA events on
    # the stream around the executor's two calls.
    ex = engine.executor
    spans = {"prefill": [], "decode": []}

    def timed(kind, fn):
        def call(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            spans[kind].append((a, b))
            return out
        return call

    ex.prefill = timed("prefill", ex.prefill)
    ex.decode_window = timed("decode", ex.decode_window)

    tpa.launches = tpa.launches_int8 = 0  # the main path's counts start here
    t0 = time.perf_counter()
    results = []
    for p, sp in reqs:
        results.append(engine.submit(p, sp))
    while engine.has_work:
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, launches_int8 = tpa.launches, tpa.launches_int8  # ... and are read here
    del ex.prefill, ex.decode_window
    check(launches_int8 == 0, f"a bf16 pool launched the int8 kernel {launches_int8} times")

    stats = dict(engine.stats)
    for r, n in zip(results, lengths):
        check(r.finish_reason == "length" and len(r.output_token_ids) == max_tokens,
              f"request {r.request_id} (prompt {n}) finished {r.finish_reason} "
              f"with {len(r.output_token_ids)} tokens, expected {max_tokens}")
        check(all(0 <= t < cfg.vocab_size for t in r.output_token_ids),
              f"request {r.request_id} produced an out-of-vocabulary token")
        check(np.isfinite(r.output_logprobs).all(), "nonfinite logprobs")
    expected = cfg.num_layers * stats["decode_steps"]
    log(f"[engine] {len(results)} requests done in {wall:.2f} s (decode graph, "
        f"steps_per_sync 1); decode steps {stats['decode_steps']}, prefill batches "
        f"{stats['prefill_batches']}, preemptions {stats['preemptions']}; decode state "
        f"uploads {stats['decode_state_uploads']} ({stats['decode_state_rows']} rows), "
        f"clean syncs {stats['decode_state_clean_syncs']}; kernel launches {launches} "
        f"(expected {cfg.num_layers} layers x {stats['decode_steps']} steps = {expected})")
    check(launches == expected, f"kernel launches {launches} != {expected}")
    check(engine.block_manager.num_free == ec.num_blocks - 1, "blocks leaked")

    prefill_s = sum(a.elapsed_time(b) for a, b in spans["prefill"]) / 1e3
    decode_s = sum(a.elapsed_time(b) for a, b in spans["decode"]) / 1e3
    decode_tokens = stats["decode_slot_steps"]
    perf = {
        "requests": len(results),
        "prompt_tokens": stats["prefill_tokens"],
        "generated_tokens": stats["generated_tokens"],
        "decode_steps": stats["decode_steps"],
        "prefill_calls": len(spans["prefill"]),
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "prefill_tok_s": stats["prefill_tokens"] / prefill_s,
        "decode_tok_s": decode_tokens / decode_s,
        "decode_step_ms": 1e3 * decode_s / stats["decode_steps"],
        "wall_s": wall,
        "wall_generated_tok_s": stats["generated_tokens"] / wall,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log(f"[engine] prefill {perf['prefill_tok_s']:.1f} tok/s "
        f"({stats['prefill_tokens']} tokens in {prefill_s:.3f} s device time over "
        f"{perf['prefill_calls']} calls); decode {perf['decode_tok_s']:.1f} tok/s "
        f"({decode_tokens} tokens in {decode_s:.3f} s, {perf['decode_step_ms']:.2f} "
        f"ms/step at up to {ec.max_seqs} slots, CUDA events around each window)")
    log("[engine] perf " + json.dumps(perf))
    # Phase 21 holds its tensor-parallel engines to these.
    perf["outputs"] = [(r.output_token_ids, r.output_logprobs) for r in results]
    del engine
    free_memory(torch)

    # The equality script, four ways. Tokens and logprobs must be identical.
    runs, keep = {}, None
    for name, k, graphs in EQUALITY_RUNS:
        eng = card_engine(cfg, params, dataclasses.replace(ec, steps_per_sync=k), graphs)
        eng.warmup_decode_ladder()
        tpa.launches = 0
        windows = window_clock(eng)
        reqs = [eng.submit(p, sp) for p, sp in equality_requests(cfg)]
        while eng.has_work:
            eng.step()
        torch.cuda.synchronize()
        st = eng.stats
        check(all(r.finish_reason == "length" for r in reqs), f"{name}: a request stopped early")
        check(tpa.launches == cfg.num_layers * st["decode_steps"],
              f"{name}: K4 launches {tpa.launches} != {cfg.num_layers} x {st['decode_steps']}")
        secs = sum(s for _, s in windows)
        run = {"ms_per_device_step": 1e3 * secs / st["decode_steps"],
               "decode_tok_s": st["decode_slot_steps"] / secs,
               "windows": len(windows), "decode_steps": st["decode_steps"],
               "decode_tokens": st["decode_slot_steps"],
               "host_syncs_per_token": len(windows) / st["decode_slot_steps"],
               "k4_launches": tpa.launches,
               "state_uploads": st["decode_state_uploads"],
               "clean_syncs": st["decode_state_clean_syncs"],
               "outputs": [(r.output_token_ids, r.output_logprobs) for r in reqs]}
        runs[name] = run
        log(f"[equality] {name}: {run['ms_per_device_step']:.3f} ms per device step "
            f"(host clock over each window / k), decode {run['decode_tok_s']:.1f} tok/s, "
            f"{run['windows']} windows over {run['decode_steps']} device steps, "
            f"{run['host_syncs_per_token']:.4f} host syncs per token; K4 launches "
            f"{tpa.launches}; state uploads {run['state_uploads']}, clean syncs "
            f"{run['clean_syncs']}")
        del eng._decode_dispatch, eng._decode_complete
        if k == 8:
            keep = eng  # phases 4 and 5 run on the k = 8 graphed engine
        del eng
        free_memory(torch)
    first = runs[EQUALITY_RUNS[0][0]]["outputs"]
    for name, run in runs.items():
        for i, (got, want) in enumerate(zip(run["outputs"], first)):
            check(got[0] == want[0], f"{name}: request {i}'s tokens differ from "
                  f"{EQUALITY_RUNS[0][0]}'s")
            check(got[1] == want[1], f"{name}: request {i}'s logprobs differ from "
                  f"{EQUALITY_RUNS[0][0]}'s")
    log(f"[equality] tokens and logprobs identical across {', '.join(runs)} "
        f"({sum(len(t) for t, _ in first)} tokens, max_tokens {EQUALITY_MAX_TOKENS})")
    perf["equality"] = {n: {k: v for k, v in r.items() if k != "outputs"}
                        for n, r in runs.items()}
    log("[equality] perf " + json.dumps(perf["equality"]))
    return keep, launches, perf


def phase_in_model(torch, engine, flush, max_tokens=4, fp16_pool=False):
    """One decode step's logits, kernel path against gather path (an int8
    pool's window dequantized in float32), gated, on a batch of 8 freshly
    prefilled sequences (``max_tokens`` each, so the engine's later windows
    can run on). On an int8 pool also against the same step on a bf16 pool,
    printed only: that is quantization error, not a kernel fault. Then the
    kernel against its plain version on the engine's layer-0 pool and
    tables, timed, with a query in the model's dtype. With ``fp16_pool``,
    also K4 on a float16 copy of that pool with a float16 query (the fp16
    path's decode at this engine's state), returned as ``fp16``."""
    import numpy as np

    from dlti_tpu_torch.models.interop import load_model
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.ops.kv_cache import init_paged_cache
    from dlti_tpu_torch.serving.sampling import SamplingParams

    cfg = engine.model_cfg
    layer = engine.cache[0]
    int8 = layer["k"].dtype == torch.int8
    tag, kname = ("[int8-in-model]", "K4q") if int8 else ("[in-model]", "kernel")
    # No slot may finish at its first token: the step below needs all 8.
    engine.cfg = dataclasses.replace(engine.cfg, eos_token_id=-1)
    rng = np.random.default_rng(1)
    for n in [40, 77, 128, 129, 200, 255, 300, 511]:
        engine.submit(rng.integers(3, cfg.vocab_size, n).tolist(),
                      SamplingParams(temperature=0.0, max_tokens=max_tokens))
    engine.step()  # no slot was active: admission prefill only
    check(engine.num_active == 8, f"expected 8 active slots, got {engine.num_active}")

    dev = engine.device
    ids = torch.tensor([[s.last_token] for s in engine.slots], device=dev)
    pos = torch.tensor([[s.seq_len] for s in engine.slots], device=dev)
    tables = torch.tensor(engine._block_tables, device=dev)
    gather_model = load_model(dataclasses.replace(cfg, paged_attention_impl="gather"),
                              dict(engine.model.state_dict()), dev)
    with torch.no_grad():
        if int8:  # the same prompts prefilled into a bf16 pool at the same blocks
            bf16_cache = init_paged_cache(cfg.num_layers, engine.cfg.num_blocks,
                                          engine.cfg.block_size, cfg.num_kv_heads,
                                          cfg.resolved_head_dim, torch.bfloat16, device=dev)
            prompts = [s.request.prompt_token_ids for s in engine.slots]
            width = max(len(p) for p in prompts)
            pre_ids = torch.zeros(8, width, dtype=torch.long, device=dev)
            pre_pos = torch.full((8, width), -1, dtype=torch.long, device=dev)
            for r, p in enumerate(prompts):
                pre_ids[r, :len(p)] = torch.tensor(p, device=dev)
                pre_pos[r, :len(p)] = torch.arange(len(p), device=dev)
            engine.model(pre_ids, positions=pre_pos, cache=bf16_cache, block_tables=tables)
            bf16_logits = engine.model(ids, positions=pos, cache=bf16_cache,
                                       block_tables=tables)[:, 0]
            del bf16_cache
        # Both write the same K/V rows at the same slots before attending.
        kernel_logits = engine.model(ids, positions=pos, cache=engine.cache,
                                     block_tables=tables)[:, 0]
        gather_logits = gather_model(ids, positions=pos, cache=engine.cache,
                                     block_tables=tables)[:, 0]
    del gather_model
    torch.cuda.empty_cache()
    check(torch.isfinite(kernel_logits).all().item(), f"nonfinite {kname}-path logits")
    scale = gather_logits.abs().max().item()
    diff = (kernel_logits - gather_logits).abs().max().item()
    agree = (kernel_logits.argmax(-1) == gather_logits.argmax(-1)).float().mean().item()
    log(f"{tag} decode logits {kname} vs gather path: max_abs_diff {diff:.4e}, "
        f"max |logit| {scale:.4e}, rel {diff / scale:.3e} (tol {LOGITS_REL_TOL:.1e}); "
        f"argmax agreement {agree:.3f}")
    extra = {"logits_rel": diff / scale, "argmax_agree": agree}
    if int8:
        qdiff = (kernel_logits - bf16_logits).abs().max().item()
        qagree = (kernel_logits.argmax(-1) == bf16_logits.argmax(-1)).float().mean().item()
        log(f"{tag} int8 pool vs bf16 pool (quantization error, not gated): "
            f"max_abs_diff {qdiff:.4e}, rel {qdiff / scale:.3e}, argmax agreement "
            f"{qagree:.3f}")
        extra.update(bf16_pool_rel=qdiff / scale, bf16_pool_argmax_agree=qagree)
    check(diff <= LOGITS_REL_TOL * scale,
          f"{kname}-path logits differ from gather-path by {diff} (scale {scale})")

    # The kernel on the engine's own pool, tables and lengths (positions
    # seq_len + 1 after the step above wrote them), with a random query.
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(8, 1, cfg.num_heads, cfg.resolved_head_dim, device=dev,
                    generator=gen).to(engine.model.model.embed_tokens.dtype)
    lens = (pos[:, 0] + 1).to(torch.int32)
    scales = {k: layer[k] for k in ("k_scale", "v_scale") if k in layer}
    pools = [(kname, layer["k"], layer["v"], q, scales)]
    if fp16_pool:
        pools.append(("K4 on a float16 copy", layer["k"].half(), layer["v"].half(),
                      q.half(), {}))
    results = []
    for label, k_pool, v_pool, q_in, sc in pools:
        r = measure_kernel(torch, tpa, q_in, k_pool, v_pool, tables, lens,
                           cfg.sliding_window, flush, scales=sc)
        log(f"{tag} {label} on the engine's pool ({k_pool.dtype} pool, {q_in.dtype} q; "
            f"seq_lens {lens.tolist()}; {r['design']}; {r['splits']} splits of "
            f"{r['chunk']} tokens): max_abs_err {r['max_abs_err']:.3e} (tol "
            f"{r['tol']:.3e}), row rel {r['row_rel_err']:.3e} (tol {r['row_rel_tol']:.3e}); "
            f"kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms")
        check(r["max_abs_err"] <= r["tol"], f"{label} disagrees on the engine's pool")
        check(r["row_rel_err"] <= r["row_rel_tol"], f"{label} disagrees on the engine's "
              f"pool relative to its rows: {r['row_rel_err']}")
        results.append(r)
    out = {**results[0], **extra}
    if fp16_pool:
        out["fp16"] = results[1]
    return out


def sync_check(torch, engine, tag, submit=False):
    """``torch.cuda.set_sync_debug_mode("error")`` around the dispatch of an
    8-step decode window: growing tables, syncing the resident state,
    uploading ids and positions and replaying the graph must not wait on
    the card. With ``submit``, first admits 8 greedy requests of 9 tokens
    (8 left after prefill: an 8-step window)."""
    import numpy as np

    from dlti_tpu_torch.serving.sampling import SamplingParams

    if submit:
        rng = np.random.default_rng(3)
        for n in [40, 77, 128, 129, 200, 255, 300, 511]:
            engine.submit(rng.integers(3, engine.model_cfg.vocab_size, n).tolist(),
                          SamplingParams(temperature=0.0, max_tokens=9))
        engine.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = engine._decode_dispatch()
    except RuntimeError as e:
        raise CheckFailed(f"{tag}: the decode dispatch synchronized: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(pending is not None and pending[1] == 8,
          f"{tag}: expected an 8-step window, got {pending and pending[1]}")
    engine._decode_complete(pending)
    log(f"{tag} sync check: set_sync_debug_mode('error') around the dispatch of an "
        f"8-step graphed window on a {engine.cfg.cache_dtype} pool "
        f"({len(pending[0])} active slots): no synchronization")


def phase_profile(torch, engine):
    """Where a graphed decode window's time goes: ``torch.profiler`` over
    the engine's remaining decode window (8 active slots, k = 8). Device
    busy time is the sum of the kernels' own device time; the rest of the
    wall time the card idles. K4's split and combine kernels must appear
    inside the replays, once per layer per device step each, as the launch
    counter says."""
    from torch.profiler import ProfilerActivity, profile

    from dlti_tpu_torch.ops import paged_attention as tpa

    steps0, calls, launches0 = engine.stats["decode_steps"], 0, tpa.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while engine.has_work:
            engine.step()
            calls += 1
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    steps = engine.stats["decode_steps"] - steps0
    launches = tpa.launches - launches0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    check(steps > 0, "no decode step left to profile")
    if not kernels or busy_ms == 0:
        log("[profile] the profiler recorded no device time: not measured")
        return None
    n_kernels = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[profile] {steps} device decode steps in {calls} engine step(s) under "
        f"torch.profiler (graph replays): wall {wall_ms / steps:.2f} ms/step, device "
        f"busy {busy_ms / steps:.2f} ms/step ({100 * busy_ms / wall_ms:.1f}% busy, "
        f"{100 - 100 * busy_ms / wall_ms:.1f}% idle), {n_kernels / steps:.0f} kernels/step")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
            f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% x{e.count // steps:<4d} "
            f"{e.key[:90]}")
    # K4 as split-K: its split kernel and its combine kernel, each once per
    # layer per device step.
    k4 = {}
    for e in kernels:
        for name in ("paged_decode_kernel", "paged_decode_combine_kernel"):
            if name in e.key:
                t, c = k4.get(name, (0.0, 0))
                k4[name] = (t + e.self_device_time_total / 1e3, c + e.count)
    log("[profile] K4 by kernel: " + "; ".join(
        f"{n} {t / steps:.3f} ms/step, {c} launches" for n, (t, c) in sorted(k4.items()))
        + f"; launch counter {launches} (= {launches // max(steps, 1)} x {steps} steps)")
    check(set(k4) == {"paged_decode_kernel", "paged_decode_combine_kernel"},
          f"the graphed window did not run K4's split and combine kernels: {sorted(k4)}")
    layers = engine.model_cfg.num_layers
    check(launches == layers * steps, f"K4 counter {launches} != {layers} x {steps}")
    check(all(c == launches for _, c in k4.values()),
          f"the profiler's K4 kernels {k4} disagree with the counter {launches}")
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "busy_ms_per_step": busy_ms / steps, "busy_share": busy_ms / wall_ms,
            "kernels_per_step": n_kernels / steps,
            "k4_ms_per_step": sum(t for t, _ in k4.values()) / steps}


def phase_head(torch, engine):
    """F2: one decode-shaped forward of the engine's model (8 rows, every
    K/V write into the trash block), profiled with shapes. The LM head's
    GEMM must take bf16 inputs, and the forward's memory peak must stay
    under the float32 head copy it used to make."""
    from torch.profiler import ProfilerActivity, profile

    cfg = engine.model_cfg
    dev = engine.device
    S = 8
    ids = torch.ones((S, 1), dtype=torch.long, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[:, None]
    tables = torch.zeros((S, engine.cfg.max_blocks_per_seq), dtype=torch.int32, device=dev)
    head_f32 = cfg.hidden_size * cfg.vocab_size * 4
    with torch.no_grad():
        engine.model(ids, positions=pos, cache=engine.cache, block_tables=tables)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        engine.model(ids, positions=pos, cache=engine.cache, block_tables=tables)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            engine.model(ids, positions=pos, cache=engine.cache, block_tables=tables)
            torch.cuda.synchronize()
    # The trace's op events carry their inputs' dims and types.
    trace_path = ROOT / "build" / "head_profile.json"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    shape = [cfg.hidden_size, cfg.vocab_size]
    heads = [e for e in events if e.get("name") == "aten::mm"
             and shape in (e.get("args", {}).get("Input Dims") or [])]
    check(len(heads) == 1, f"expected one head GEMM in the profile, found {len(heads)}")
    args = heads[0]["args"]
    dtypes = args.get("Input type") or []
    op_id = args.get("External id")
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"
                      and e.get("args", {}).get("External id") == op_id})
    log(f"[head] LM head GEMM: aten::mm input dims {args.get('Input Dims')}, input "
        f"types {dtypes}, kernels {kernels}")
    check(len(dtypes) >= 2 and all("BFloat16" in str(d) for d in dtypes[:2]),
          f"the head GEMM's inputs are {dtypes}, not bf16")
    log(f"[head] decode forward memory peak over the allocated base: {peak / 1e6:.1f} MB "
        f"(the float32 head copy alone was {head_f32 / 1e6:.1f} MB)")
    check(peak < head_f32, f"a decode forward still peaks at {peak} B >= {head_f32} B")
    return {"head_input_dtypes": dtypes, "head_kernels": kernels,
            "decode_forward_peak_mb": peak / 1e6, "f32_head_copy_mb": head_f32 / 1e6}


# ----------------------------------------------------------------------
# Training slice: flash attention K1-K3 and the LoRA trainer
# ----------------------------------------------------------------------

FLASH_REPLACES = {
    "flash_fwd": "dlti_tpu/ops/pallas/flash_attention.py:132",
    "flash_bwd_dq": "dlti_tpu/ops/pallas/flash_attention.py:366",
    "flash_bwd_dkv": "dlti_tpu/ops/pallas/flash_attention.py:424",
}
# Kernel against plain version on identical inputs, elementwise
# |got - want| <= atol + rtol |want|. Both compute in float32 and differ
# only in summation order; in bfloat16 both then round to bf16 (relative
# spacing 2**-7), so they may land one bf16 step apart. float16 keeps 3 more
# bits: rtol 2**-10, 8x tighter; atol stays 1e-3, since near zero it covers
# the float32 sums' order, which does not depend on the output's type (a
# GQA 64/1 dk or dv sums 64 heads' rows; the card read up to 4.9e-4 there).
# The float16 kernels' hi/lo split carries ~22 bits of p and ds; rounding p
# once to float16 would take 48-100% of this limit on CPU emulations
# (tests/test_torch_flash_attention.py), so they keep the split.
FLASH_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 2.0 ** -7),
             "float16": (1e-3, 2.0 ** -10)}
# The float16 case whose ds passes float16's 65504 (the kernels rescale it):
# dO of a gradient of 2**-4 under the default loss scale 2**16, v at 2**5,
# q and k at 2**-4 (near-uniform p); dq, dk and dv stay finite. Compared in
# units of dO's scale (dividing both by 2**12 is exact), where FLASH_TOL
# applies as at unit scale.
DS_CASE_SCALES = {"do": 2.0 ** 12, "v": 2.0 ** 5, "qk": 2.0 ** -4}
# Kernel path against reference path, one llama2_7b train step in bf16. The
# reference path rounds the softmax probabilities to bf16 before p @ v and
# the kernels do not, so the two attention outputs differ by about one bf16
# step (2**-8 relative) in every layer; 32 layers carry that on. Gates: the
# loss relative difference, and the LoRA grads (all factors as one vector)
# by cosine and relative L2. On an H100 the sound path read loss rel
# 2.7e-5 and 1.3e-4, rel L2 3.8e-3 and 4.3e-3, 1 - cosine 7e-6 to 9.3e-6.
# The grad limits lie between those and the 10% controls below (rel L2
# 2.2e-2 and 6.9e-2, 1 - cosine 2.4e-4 and 2.0e-3), which must be refused.
# The loss barely moves on random weights (the 10% forward control read
# 2.0e-4), so its limit only catches gross faults. The 2% control reads
# within the limits (rel L2 6.1e-3): it is printed, not gated.
STEP_LOSS_RTOL = 5e-4
STEP_GRAD_COS = 0.9999
STEP_GRAD_REL_L2 = 0.012
# Known-wrong controls (kernels, eps, must be refused): the kernel path with
# the named kernels' outputs multiplied elementwise by (1 + eps * N(0, 1))
# from a seeded generator.
STEP_CONTROLS = [(("flash_fwd",), 0.1, True),
                 (("flash_bwd_dq", "flash_bwd_dkv"), 0.1, True),
                 (("flash_bwd_dq", "flash_bwd_dkv"), 0.02, False)]


def allowed_pairs(torch, b, s, causal, window, segs):
    """(query, key) pairs the mask allows, counted from this case's data."""
    if segs is None and not window:
        return b * (s * (s + 1) // 2 if causal else s * s)
    total = 0
    qi = torch.arange(s, device="cuda")[:, None]
    kj = torch.arange(s, device="cuda")[None, :]
    allowed = (kj <= qi) if causal else torch.ones(s, s, dtype=torch.bool, device="cuda")
    if causal and window:
        allowed &= kj > qi - window
    for row in range(b):
        m = allowed
        if segs is not None:
            m = m & (segs[row][:, None] == segs[row][None, :]) & (segs[row][None, :] != 0)
        total += int(m.sum())
    return total


def flash_work(q, k, segs, pairs):
    """Bytes each kernel must move (inputs read once, outputs written once)
    and operations it must do (2 per multiply-add; K1 two products per
    allowed pair and channel, K2 three, K3 four) for these inputs."""
    b, s, h, d = q.shape
    e = q.element_size()
    qb, kb = q.numel() * e, k.numel() * e
    rowb = b * h * s * 4                      # lse or D, float32
    segb = 0 if segs is None else segs.numel() * 4
    reads_bwd = 2 * qb + 2 * kb + 2 * rowb + segb       # q, k, v, dO, lse, D
    return {
        "flash_fwd": (qb + 2 * kb + segb + qb + rowb, 4 * h * d * pairs),
        "flash_bwd_dq": (reads_bwd + qb, 6 * h * d * pairs),
        "flash_bwd_dkv": (reads_bwd + 2 * kb, 8 * h * d * pairs),
    }


def sdpa_calls(torch, q, k, v, do, causal, window, segs):
    """The library yardstick, timed and never used by the port:
    ``F.scaled_dot_product_attention`` forward, and its backward through
    autograd (dq, dk and dv together)."""
    import torch.nn.functional as F

    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    kw = dict(enable_gqa=k.shape[2] != q.shape[2])
    if segs is None and not window:
        kw["is_causal"] = causal
    else:
        s = q.shape[1]
        qi = torch.arange(s, device="cuda")[:, None]
        kj = torch.arange(s, device="cuda")[None, :]
        m = (kj <= qi) & (kj > qi - window) if window else (kj <= qi)
        m = m[None, None]
        if segs is not None:
            m = m & ((segs[:, :, None] == segs[:, None, :]) & (segs[:, None, :] != 0))[:, None]
        kw["attn_mask"] = m
    out = F.scaled_dot_product_attention(qh, kh, vh, **kw)
    dout = do.transpose(1, 2)
    fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh, **kw)  # noqa: E731
    bwd = lambda: torch.autograd.grad(out, (qh, kh, vh), dout, retain_graph=True)  # noqa: E731
    return fwd, bwd


def within(got, want, dtype_name, unit=1.0):
    atol, rtol = FLASH_TOL[dtype_name]
    got, want = got.float() / unit, want.float() / unit
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    return ok, err.max().item()


def max_abs_ds(torch, q, k, v, do, o, lse, chunk=64):
    """max |ds| of the float32 backward the plain version computes
    (causal, no window or segments), ``chunk`` query rows at a time."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)       # (b, h, s)
    kf, vf = k.float(), v.float()
    top = 0.0
    for lo in range(0, s, chunk):
        hi = min(s, lo + chunk)
        qg = q[:, lo:hi].float().reshape(b, hi - lo, hkv, h // hkv, d)
        dog = do[:, lo:hi].float().reshape(b, hi - lo, hkv, h // hkv, d)
        sc = torch.einsum("bqngd,bknd->bngqk", qg, kf) * d ** -0.5
        qi = torch.arange(lo, hi, device=q.device)[:, None]
        allowed = torch.arange(s, device=q.device)[None, :] <= qi
        ls = lse[:, :, lo:hi].reshape(b, hkv, h // hkv, hi - lo, 1)
        p = torch.where(allowed, torch.exp(sc - ls), 0.0)
        dp = torch.einsum("bqngd,bknd->bngqk", dog, vf)
        dl = delta[:, :, lo:hi].reshape(b, hkv, h // hkv, hi - lo, 1)
        top = max(top, (p * (dp - dl) * d ** -0.5).abs().max().item())
    return top


def phase_flash_cases(torch, flush):
    from dlti_tpu_torch.ops import flash_attention as tfa

    gen = torch.Generator(device="cuda").manual_seed(4321)
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16

    def packed(b, s):
        segs = torch.zeros(b, s, dtype=torch.int32, device="cuda")
        cpu = torch.Generator().manual_seed(5)
        for row in range(b):
            cuts = sorted((torch.randperm(s - 200, generator=cpu)[:4] + 20).tolist())
            prev = 0
            for i, c in enumerate(cuts):  # 4 documents, then padding rows
                segs[row, prev:c] = i + 1
                prev = c
        return segs

    cases = [
        ("llama2_7b_train", dict(b=4, s=512, h=32, hkv=32, d=128, dtype=bf16)),
        ("llama3_8b_gqa", dict(b=1, s=2048, h=32, hkv=8, d=128, dtype=bf16)),
        ("mistral_7b_window", dict(b=1, s=8192, h=32, hkv=8, d=128, dtype=bf16,
                                   window=4096)),
        ("gemma_7b_d256", dict(b=2, s=1024, h=16, hkv=16, d=256, dtype=bf16)),
        ("d64", dict(b=2, s=1024, h=16, hkv=16, d=64, dtype=bf16)),
        ("llama2_7b_fp32", dict(b=1, s=512, h=32, hkv=32, d=128, dtype=f32)),
        ("packed_unaligned_1000", dict(b=2, s=1000, h=32, hkv=8, d=128, dtype=bf16,
                                       packed=True)),
        # The fp16 path: llama2_7b's training shape, d 64 and 256, the packed
        # unaligned case, and the training shape with ds past 65504.
        ("llama2_7b_train_fp16", dict(b=4, s=512, h=32, hkv=32, d=128, dtype=f16)),
        ("gemma_7b_d256_fp16", dict(b=2, s=1024, h=16, hkv=16, d=256, dtype=f16)),
        ("d64_fp16", dict(b=2, s=1024, h=16, hkv=16, d=64, dtype=f16)),
        ("packed_unaligned_1000_fp16", dict(b=2, s=1000, h=32, hkv=8, d=128, dtype=f16,
                                            packed=True)),
        ("llama2_7b_train_fp16_ds_past_65504", dict(b=4, s=512, h=32, hkv=32, d=128,
                                                    dtype=f16, scales=DS_CASE_SCALES)),
    ]
    results = {}
    for name, c in cases:
        b, s, h, hkv, d, dtype = c["b"], c["s"], c["h"], c["hkv"], c["d"], c["dtype"]
        window = c.get("window")
        sc = c.get("scales", {})
        q = (torch.randn(b, s, h, d, device="cuda", generator=gen) * sc.get("qk", 1)).to(dtype)
        k = (torch.randn(b, s, hkv, d, device="cuda", generator=gen) * sc.get("qk", 1)).to(dtype)
        v = (torch.randn(b, s, hkv, d, device="cuda", generator=gen) * sc.get("v", 1)).to(dtype)
        do = (torch.randn(b, s, h, d, device="cuda", generator=gen) * sc.get("do", 1)).to(dtype)
        segs = packed(b, s) if c.get("packed") else None
        kw = dict(causal=True, window=window, segment_ids=segs)
        chunk = 1024 if s > 2048 else None    # bound the plain version's memory
        dtype_name = str(dtype).split(".")[-1]

        o, lse = tfa.flash_fwd(q, k, v, **kw)
        delta = tfa.backward_delta(o, do)
        dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        ro, rlse = tfa.flash_attention_reference(q, k, v, q_chunk=chunk, **kw)
        rdq, rdk, rdv = tfa.flash_attention_backward_reference(
            q, k, v, o, lse, do, q_chunk=chunk, **kw)
        errs = {}
        for label, got, want in (("o", o, ro), ("dq", dq, rdq), ("dk", dk, rdk),
                                 ("dv", dv, rdv)):
            check(torch.isfinite(got).all().item(), f"{name}: nonfinite {label}")
            unit = sc.get("do", 1) if label != "o" else 1
            ok, errs[label] = within(got, want, dtype_name, unit)
            check(ok, f"flash {label} disagrees with its plain version on {name}: "
                      f"max abs err {errs[label]}{' in units of 2**12' if unit != 1 else ''}")
        ds_top = None
        if sc:
            ds_top = max_abs_ds(torch, q, k, v, do, o, lse)
            log(f"[flash] {name}: the plain version's max |ds| {ds_top:.4g} (float16 max "
                f"65504); max |dq| {rdq.float().abs().max().item():.4g}, |dk| "
                f"{rdk.float().abs().max().item():.4g}, |dv| "
                f"{rdv.float().abs().max().item():.4g}; errors in units of 2**12")
            check(ds_top > 65504, f"{name}: max |ds| {ds_top} does not pass 65504")
        masked = rlse == tfa.MASKED_LSE
        check(torch.equal(lse == tfa.MASKED_LSE, masked),
              f"{name}: fully masked rows differ")
        lse_err = (lse[~masked] - rlse[~masked]).abs().max().item()
        check(lse_err <= 1e-3, f"{name}: lse err {lse_err}")
        if segs is not None:
            check(not o[segs == 0].any().item(), f"{name}: padding rows not zero")

        pairs = allowed_pairs(torch, b, s, True, window, segs)
        work = flash_work(q, k, segs, pairs)
        sdpa_fwd, sdpa_bwd = sdpa_calls(torch, q, k, v, do, True, window, segs)
        iters = 5 if s > 2048 else 20
        times = {
            "flash_fwd": time_ms(torch, lambda: tfa.flash_fwd(q, k, v, **kw),
                                 iters, flush),
            "flash_bwd_dq": time_ms(torch, lambda: tfa.flash_bwd_dq(
                q, k, v, do, lse, delta, **kw), iters, flush),
            "flash_bwd_dkv": time_ms(torch, lambda: tfa.flash_bwd_dkv(
                q, k, v, do, lse, delta, **kw), iters, flush),
        }
        plain_fwd = time_ms(torch, lambda: tfa.flash_attention_reference(
            q, k, v, q_chunk=chunk, **kw), 3, flush)
        plain_bwd = time_ms(torch, lambda: tfa.flash_attention_backward_reference(
            q, k, v, o, lse, do, q_chunk=chunk, **kw), 3, flush)
        lib_fwd = time_ms(torch, sdpa_fwd, iters, flush)
        lib_bwd = time_ms(torch, sdpa_bwd, iters, flush)
        r = {"errs": errs, "lse_err": lse_err, "pairs": pairs, "max_abs_ds": ds_top,
             "dtype": dtype_name}
        for kname in FLASH_REPLACES:
            nbytes, ops = work[kname]
            bound_ms, bound_by = bound(nbytes, ops, dtype_name)
            fwd = kname == "flash_fwd"
            r[kname] = {"design": tfa.kernel_design(kname, dtype, d),
                        "ms": times[kname], "bound_ms": bound_ms, "bound_by": bound_by,
                        "plain_ms": plain_fwd if fwd else plain_bwd,
                        "library_ms": lib_fwd if fwd else lib_bwd,
                        "max_abs_err": errs["o"] if fwd else (
                            errs["dq"] if kname == "flash_bwd_dq"
                            else max(errs["dk"], errs["dv"])),
                        "bytes": nbytes, "ops": ops}
        if dtype in (bf16, f16):
            check(r["flash_bwd_dq"]["design"].startswith("wgmma"),
                  f"{name}: {dtype_name} K2 did not run its wgmma program")
        results[name] = r
        log(f"[flash] {name} (b {b}, s {s}, h {h}/{hkv}, d {d}, {dtype_name}"
            f"{', window %d' % window if window else ''}{', packed' if segs is not None else ''}): "
            f"max abs err o {errs['o']:.3e} dq {errs['dq']:.3e} dk {errs['dk']:.3e} "
            f"dv {errs['dv']:.3e} lse {lse_err:.2e}")
        for kname, label in zip(FLASH_REPLACES, ("K1", "K2", "K3")):
            x = r[kname]
            log(f"[flash]   {label} {kname} ({dtype_name}: "
                f"{x['design']}): {x['ms']:.4f} ms, bound {x['bound_ms']:.4f} ms by "
                f"{x['bound_by']}, plain {x['plain_ms']:.4f} ms, sdpa {x['library_ms']:.4f} ms")
        del q, k, v, do, o, lse, delta, dq, dk, dv, ro, rlse, rdq, rdk, rdv
        del sdpa_fwd, sdpa_bwd
        torch.cuda.empty_cache()
    return results


def training_texts(n=96, seed=0):
    """Texts of 40 to 1400 characters from a seeded generator: with the byte
    tokenizer some fill seq 512 and some leave padding."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = ["def", "return", "the", "model", "tokens", "(x)", "=", "+", "loss",
             "grad", "lora", "attention", "\n", "    ", "for", "in", "range"]
    return [" ".join(rng.choice(words, rng.integers(8, 280))) for _ in range(n)]


TRAIN_STEPS = 8
# Phase 7's eager yardstick: its first steps (8 until phase 21 needed the
# room), held bit-equal to the graphed run's.
EAGER_STEPS = 4
MODEL_LAYERS = 32  # llama2_7b


def train_config(checkpoint, max_steps, num_layers=None):
    """Phase 7's configuration (and phase 13's): llama2_7b LoRA r=16 on
    q/k/v/o, bf16, seq 512, micro-batch 4 x accum 2, warmup 2, lr 2e-4,
    remat, with an explicit checkpoint config."""
    from dlti_tpu_torch.config import (
        MODEL_PRESETS, Config, DataConfig, LoRAConfig, OptimizerConfig, TrainConfig,
    )

    mcfg = MODEL_PRESETS["llama2_7b"]
    if num_layers is not None:
        mcfg = dataclasses.replace(mcfg, num_layers=num_layers)
    return Config(model=mcfg, lora=LoRAConfig(),
                  optimizer=OptimizerConfig(learning_rate=2e-4, warmup_steps=2),
                  data=DataConfig(max_seq_len=512, tokenizer="byte"),
                  checkpoint=checkpoint,
                  train=TrainConfig(micro_batch_size=4, grad_accum_steps=2,
                                    max_steps=max_steps, logging_steps=1))


def train_perf(record, mcfg) -> dict:
    return {
        "steps": record.steps, "losses": record.losses, "grad_norms": record.grad_norms,
        "step_times_s": record.step_times_s, "step_ms": 1e3 * record.step_time_s,
        "tokens_per_step": record.tokens_per_step,
        "tokens_per_s": record.tokens_per_second, "mfu_percent": record.mfu_percent,
        "peak_memory_gb": record.peak_memory_gb, "windows": record.windows,
        "host_syncs_per_step": record.host_syncs_per_step, "captures": record.captures,
        "num_params": mcfg.num_params(), "trainable_params": record.trainable_params,
    }


def log_train_perf(tag, perf, mcfg):
    log(f"{tag} losses {[round(x, 4) for x in perf['losses']]}")
    log(f"{tag} grad norms {[round(x, 4) for x in perf['grad_norms']]}")
    log(f"{tag} step {perf['step_ms']:.1f} ms (mean of the steps after the first window "
        f"and step 2), {perf['tokens_per_s']:.1f} tokens/s, MFU {perf['mfu_percent']:.2f}% "
        f"(4N FLOPs/token, N = {mcfg.num_params():,}, vs 989 TFLOP/s bf16), peak memory "
        f"{perf['peak_memory_gb']:.2f} GB, {perf['windows']} windows, host syncs per step "
        f"{perf['host_syncs_per_step']:.3f}, graph captures {perf['captures']}")


def flash_counts(tfa) -> dict:
    return {"flash_fwd": tfa.fwd_launches, "flash_bwd_dq": tfa.dq_launches,
            "flash_bwd_dkv": tfa.dkv_launches}


def flash_expected(layers, accum, steps) -> dict:
    """K1 twice per layer per microbatch under remat (forward and
    recompute), K2 and K3 once."""
    n = layers * accum * steps
    return {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}


def phase_training(torch):
    """llama2_7b LoRA (r=16, bf16, seq 512, micro-batch 4 x accum 2, remat)
    for ``EAGER_STEPS`` steps through an eager ``Trainer(cuda_graphs=False)``
    (the yardstick, released), then 8 through ``Trainer.train`` on the same
    weights and ``make_batches`` output with the step as a CUDA graph (the
    main path, whose launches are counted)."""
    from dlti_tpu_torch.config import CheckpointConfig
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.training import Trainer

    # Phase 7 keeps its numbers comparable with earlier runs: no checkpoints.
    cfg = train_config(CheckpointConfig(save_strategy="no"), max_steps=TRAIN_STEPS)
    mcfg = cfg.model
    steps, accum, micro, seq = (TRAIN_STEPS, cfg.train.grad_accum_steps,
                                cfg.train.micro_batch_size, cfg.data.max_seq_len)
    check(mcfg.remat and mcfg.remat_policy == "nothing_saveable"
          and mcfg.attention_impl == "auto", "llama2_7b preset changed")
    dataset = make_batches(training_texts(), ByteTokenizer(), seq_len=seq,
                           micro_batch_size=micro, grad_accum_steps=accum)
    check(dataset.steps_per_epoch() >= steps, "dataset too small")
    first = next(dataset.epoch(0))
    pad_share = 1 - first["loss_mask"].mean()
    t0 = time.perf_counter()
    params = init_params(mcfg, seed=0, device="cuda", lora=cfg.lora)
    torch.cuda.synchronize()
    log(f"[train] llama2_7b + LoRA r={cfg.lora.r}: {sum(p.numel() for p in params.values()) / 1e9:.3f} B "
        f"params made on the card in {time.perf_counter() - t0:.1f} s; first batch "
        f"{100 * pad_share:.1f}% padding")
    # The yardstick first, released before the main path: the first steps
    # eagerly, from the same weights.
    eager_cfg = cfg.replace(train=dataclasses.replace(cfg.train, max_steps=EAGER_STEPS))
    eager_trainer = Trainer(eager_cfg, params=params, device="cuda", cuda_graphs=False)
    eager_state, eager = eager_trainer.train(dataset=dataset)
    del eager_state, eager_trainer, params
    free_memory(torch)

    trainer = Trainer(cfg, params=init_params(mcfg, seed=0, device="cuda", lora=cfg.lora),
                      device="cuda")
    state = trainer.init_state()
    tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
    tpa.launches = 0  # the main path's counts start here ...
    state, record = trainer.train(dataset=dataset, state=state)
    torch.cuda.synchronize()
    launches = flash_counts(tfa)  # ... and are read here
    check(tpa.launches == 0, "training launched the decode kernel")
    layers = mcfg.num_layers
    # The capture's eager warm-up step launches K1-K3 once for real.
    want = flash_expected(layers, accum, steps + record.captures)
    log(f"[train] {record.steps} steps as a CUDA graph ({record.captures} capture); "
        f"launches {launches} (expected {want}: K1 twice per layer per microbatch under "
        f"remat, K2/K3 once, over {steps} replayed steps and the capture's warm-up step)")
    check(record.captures == 1, f"{record.captures} graph captures, expected 1")
    check(launches == want, f"flash launches {launches} != {want}")
    check(record.steps == steps, f"{record.steps} steps, expected {steps}")
    check(all(math.isfinite(x) for x in record.losses + record.grad_norms),
          f"nonfinite losses {record.losses} or grad norms {record.grad_norms}")
    check(record.skipped_updates == 0, "an update was skipped")
    lora_b = {n: p for n, p in state.model.named_parameters() if n.endswith("lora_b")}
    check(len(lora_b) == 4 * layers, f"{len(lora_b)} lora_b leaves")
    still_zero = [n for n, p in lora_b.items() if not p.detach().abs().max().item() > 0]
    check(not still_zero, f"lora_b still zero: {still_zero[:3]}")
    perf = train_perf(record, mcfg)
    log_train_perf("[train]", perf, mcfg)
    perf["eager"] = train_perf(eager, mcfg)
    log_train_perf("[train-eager]", perf["eager"], mcfg)
    same = (eager.losses == record.losses[:EAGER_STEPS]
            and eager.grad_norms == record.grad_norms[:EAGER_STEPS])
    log(f"[train] graphed {perf['step_ms']:.1f} ms a step, {perf['tokens_per_s']:.1f} "
        f"tokens/s, peak {perf['peak_memory_gb']:.2f} GB; eager "
        f"{perf['eager']['step_ms']:.1f} ms, {perf['eager']['tokens_per_s']:.1f} tokens/s, "
        f"peak {perf['eager']['peak_memory_gb']:.2f} GB; losses and grad norms of the "
        f"first {EAGER_STEPS} steps bit-equal: {same}")
    check(same, f"graphed losses {record.losses} / grad norms {record.grad_norms} differ "
          f"from eager {eager.losses} / {eager.grad_norms}")
    log("[train] perf " + json.dumps(perf))
    return state, dataset, cfg.lora, launches, perf


def lora_loss_and_grads(torch, model, batch):
    """One step's token-mean loss and LoRA grads (float32), dropout off."""
    from dlti_tpu_torch.training.step import causal_lm_loss

    names = [n for n, p in model.named_parameters() if p.requires_grad]
    leaves = [p for n, p in model.named_parameters() if p.requires_grad]
    grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    loss_sum, n_tok = 0.0, 0.0
    for a in range(batch["input_ids"].shape[0]):
        ids = batch["input_ids"][a]
        logits = model(ids)
        ls, nt = causal_lm_loss(logits, ids, batch["loss_mask"][a])
        del logits
        for acc, g in zip(grads, torch.autograd.grad(ls, leaves)):
            acc += g.float()
        loss_sum += ls.item()
        n_tok += nt.item()
    return loss_sum / n_tok, {n: g / n_tok for n, g in zip(names, grads)}


@contextlib.contextmanager
def noisy_kernels(torch, names, eps, seed):
    """Within the block, each named kernel wrapper of ``ops.flash_attention``
    returns its outputs (o, not lse, for K1) times (1 + eps * N(0, 1))."""
    from dlti_tpu_torch.ops import flash_attention as tfa

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def noisy(t):
        z = torch.randn(t.shape, device=t.device, generator=gen)
        return (t.float() * (1 + eps * z)).to(t.dtype)

    def wrap(name, fn):
        def f(*args, **kw):
            out = fn(*args, **kw)
            if name == "flash_fwd":
                return noisy(out[0]), out[1]
            return tuple(map(noisy, out)) if isinstance(out, tuple) else noisy(out)
        return f

    saved = {n: getattr(tfa, n) for n in names}
    for n, fn in saved.items():
        setattr(tfa, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(tfa, n, fn)


def path_difference(torch, loss_a, grads_a, loss_b, grads_b):
    ga = torch.cat([g.flatten() for g in grads_a.values()])
    gb = torch.cat([grads_b[n].flatten() for n in grads_a])
    return {"loss_rel": abs(loss_a - loss_b) / abs(loss_b),
            "grad_cosine": torch.nn.functional.cosine_similarity(ga, gb, dim=0).item(),
            "grad_rel_l2": ((ga - gb).norm() / gb.norm()).item()}


def within_step_gate(d):
    return (d["loss_rel"] <= STEP_LOSS_RTOL and d["grad_cosine"] >= STEP_GRAD_COS
            and d["grad_rel_l2"] <= STEP_GRAD_REL_L2)


def phase_train_paths(torch, state, dataset, lora):
    """The same train step (weights, batch, dropout off) through the flash
    kernels and through ``attention_impl="reference"``; then the known-wrong
    controls, each of which the gate must refuse."""
    from dlti_tpu_torch.models.interop import load_model

    model = state.model
    ref_model = load_model(dataclasses.replace(model.cfg, attention_impl="reference"),
                           dict(model.named_parameters()), "cuda", lora=lora,
                           trainable_lora=True)
    host = next(dataset.epoch(1))
    batch = {k: torch.from_numpy(host[k]).cuda() for k in ("input_ids", "loss_mask")}
    loss_k, grads_k = lora_loss_and_grads(torch, model, batch)
    loss_r, grads_r = lora_loss_and_grads(torch, ref_model, batch)
    del ref_model
    d = path_difference(torch, loss_k, grads_k, loss_r, grads_r)
    log(f"[train-paths] loss kernels {loss_k:.6f} vs reference {loss_r:.6f} (rel "
        f"{d['loss_rel']:.3e}, tol {STEP_LOSS_RTOL:.0e}); LoRA grads cosine "
        f"{d['grad_cosine']:.7f} (>= {STEP_GRAD_COS}), rel L2 {d['grad_rel_l2']:.3e} "
        f"(<= {STEP_GRAD_REL_L2})")
    controls = []
    for i, (names, eps, gated) in enumerate(STEP_CONTROLS):
        with noisy_kernels(torch, names, eps, seed=77 + i):
            loss_c, grads_c = lora_loss_and_grads(torch, model, batch)
        c = {"kernels": list(names), "eps": eps, "gated": gated,
             **path_difference(torch, loss_c, grads_c, loss_r, grads_r)}
        controls.append(c)
        log(f"[train-paths] control {'+'.join(names)} x (1 + {eps} N(0,1)): loss rel "
            f"{c['loss_rel']:.3e}, grads cosine {c['grad_cosine']:.7f}, rel L2 "
            f"{c['grad_rel_l2']:.3e} -> {'passes' if within_step_gate(c) else 'refused'}"
            f"{'' if gated else ' (not gated)'}")
    check(math.isfinite(loss_k) and d["loss_rel"] <= STEP_LOSS_RTOL,
          f"kernel-path loss {loss_k} vs reference {loss_r}")
    check(d["grad_cosine"] >= STEP_GRAD_COS and d["grad_rel_l2"] <= STEP_GRAD_REL_L2,
          f"kernel-path grads differ: {d}")
    passed = [c for c in controls if c["gated"] and within_step_gate(c)]
    check(not passed, f"the gate let known-wrong controls through: {passed}")
    return {"loss_kernels": loss_k, "loss_reference": loss_r, **d, "controls": controls}


def train_profile_groups(torch, prof, wall_ms, steps, tag):
    """Device time by kernel group of a profiled run of ``steps`` train
    steps; K1, K2 and K3 must show up as their wgmma kernels."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels or busy_ms == 0:
        log(f"{tag} the profiler recorded no device time: not measured")
        return None
    n_kernels = sum(e.count for e in kernels)
    log(f"{tag} {steps} train step(s) under torch.profiler: wall {wall_ms / steps:.1f} ms "
        f"a step, device busy {busy_ms / steps:.1f} ms a step ({100 * busy_ms / wall_ms:.1f}% "
        f"busy), {n_kernels / steps:.0f} kernels a step")
    groups, flash_names = {}, {}
    for e in kernels:
        key = e.key
        # K1, K2 and K3 in bf16 are flash_fwd_wgmma_kernel,
        # flash_bwd_dq_wgmma_kernel and flash_bwd_dkv_wgmma_kernel; the
        # CUDA-core programs drop "_wgmma".
        kernel = re.search(r"flash_\w+_kernel", key)
        for label, name in (("K1", "flash_fwd"), ("K2", "flash_bwd_dq"),
                            ("K3", "flash_bwd_dkv")):
            if kernel and kernel.group(0).startswith(name + "_"):
                g = f"{label} {name}"
                flash_names.setdefault(label, set()).add(kernel.group(0))
                break
        else:
            if "gemm" in key.lower() or "nvjet" in key or "cutlass" in key.lower():
                g = "matmul (cuBLAS)"
            else:
                g = "other"
        t, c = groups.get(g, (0.0, 0))
        groups[g] = (t + e.self_device_time_total / 1e3, c + e.count)
    for g, (t, c) in sorted(groups.items(), key=lambda x: -x[1][0]):
        log(f"{tag}   {t / steps:9.2f} ms a step {100 * t / busy_ms:5.1f}% x{c // steps:<6d} {g}")
    log(f"{tag} flash kernels by name: "
        + "; ".join(f"{k}: {', '.join(sorted(v))}" for k, v in sorted(flash_names.items())))
    for label in ("K1", "K2", "K3"):
        check(any("wgmma" in n for n in flash_names.get(label, ())),
              f"{tag} the train step's {label} did not run its wgmma kernel: {flash_names}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        log(f"{tag}   top {e.self_device_time_total / 1e3 / steps:9.2f} ms a step "
            f"x{e.count // steps:<5d} {e.key[:90]}")
    return {"wall_ms": wall_ms / steps, "busy_ms": busy_ms / steps,
            "busy_share": busy_ms / wall_ms, "kernels": n_kernels / steps,
            "groups": {g: t / steps for g, (t, _) in groups.items()}}


PROFILE_WINDOW = 2


def phase_train_profile(torch, state, dataset):
    """Where a train step's time goes: ``torch.profiler`` over one eager
    optimizer step of the trainer's own step function, then over a window
    of ``PROFILE_WINDOW`` graph replays (``StepWindow``, captured before
    the profile)."""
    from torch.profiler import ProfilerActivity, profile

    from dlti_tpu_torch.training.step import StepWindow, make_train_step, step_seed
    from dlti_tpu_torch.utils.device import to_host

    step_fn = make_train_step(state.model, accum_steps=2)
    hosts = list(dataset.epoch(2))[:2 + PROFILE_WINDOW]
    batch = {k: torch.from_numpy(v).cuda() for k, v in hosts[0].items()}
    step_fn(state, batch, step_seed(43, 100))  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch, step_seed(43, 101))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    eager = train_profile_groups(torch, prof, wall_ms, 1, "[train-profile eager]")

    window = StepWindow(state.model, accum_steps=2, seed=43, capacity=PROFILE_WINDOW)
    to_host(window.run(state, hosts[1:2], 102))  # the capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rows = to_host(window.run(state, hosts[2:], 103))[0]
        wall_ms = 1e3 * (time.perf_counter() - t0)
    window.release()
    check(all(math.isfinite(x) for x in rows[:, 0]), f"graphed window losses {rows[:, 0]}")
    graphed = train_profile_groups(torch, prof, wall_ms, PROFILE_WINDOW,
                                   "[train-profile graph]")
    return {"eager": eager, "graph": graphed}


# ----------------------------------------------------------------------
# Train-window slice 8: steps_per_sync windows, eval, loss_chunk
# ----------------------------------------------------------------------

WINDOW_K = 8
WINDOW_STEPS = 16
WINDOW_EVAL_BATCHES = 4
LOSS_CHUNK = 128
# Step 1 of the loss_chunk run against the run without, the same weights
# and batch: the chunked loss sums the same token losses in another order
# and its head GEMMs have other shapes, so cuBLAS may round the float32
# logits differently; the relative difference stays far below this.
LOSS_CHUNK_STEP1_RTOL = 1e-4


def phase_train_window(torch, reference):
    """Phase 14 (run after phase 9): llama2_7b at full width and depth,
    ``steps_per_sync`` 8 over 16 steps with ``eval_steps`` 8 on 4 eval
    batches, then ``loss_chunk=128`` over the first window of 8; see the
    module docstring."""
    from dlti_tpu_torch.config import CheckpointConfig
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.training import Trainer

    base = train_config(CheckpointConfig(save_strategy="no"), max_steps=WINDOW_STEPS)
    base = dataclasses.replace(base, train=dataclasses.replace(base.train, num_epochs=2))
    mcfg, accum = base.model, base.train.grad_accum_steps
    # Phase 7's batches: 12 steps an epoch, so the 16 steps run as windows
    # of 8, 4 (the epoch's end) and 4 (max_steps).
    dataset = make_batches(training_texts(), ByteTokenizer(), seq_len=512,
                           micro_batch_size=4, grad_accum_steps=accum)
    check(dataset.steps_per_epoch() == 12, "phase 7's dataset changed")
    windows = {"window": 3, "loss_chunk": 1}
    eval_dataset = make_batches(training_texts(4 * WINDOW_EVAL_BATCHES, seed=11),
                                ByteTokenizer(), seq_len=512, micro_batch_size=4,
                                grad_accum_steps=1, shuffle_seed=None)
    check(eval_dataset.steps_per_epoch() == WINDOW_EVAL_BATCHES, "eval dataset size")
    perf = {}
    runs = {"window": dataclasses.replace(base, train=dataclasses.replace(
                base.train, steps_per_sync=WINDOW_K, eval_steps=WINDOW_K)),
            "loss_chunk": dataclasses.replace(base, train=dataclasses.replace(
                base.train, steps_per_sync=WINDOW_K, loss_chunk=LOSS_CHUNK,
                max_steps=WINDOW_K))}
    for name, cfg in runs.items():
        trainer = Trainer(cfg, params=init_params(mcfg, seed=0, device="cuda",
                                                  lora=cfg.lora), device="cuda")
        tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
        state, rec = trainer.train(dataset=dataset, eval_dataset=eval_dataset)
        torch.cuda.synchronize()
        launches = flash_counts(tfa)
        del state, trainer
        free_memory(torch)
        steps = cfg.train.max_steps
        p = train_perf(rec, mcfg)
        p.update(launches=launches, eval_steps=rec.eval_steps, eval_losses=rec.eval_losses)
        perf[name] = p
        log_train_perf(f"[train-{name}]", p, mcfg)
        want = flash_expected(mcfg.num_layers, accum, steps + rec.captures)
        # Each eval runs K1 once per layer per eval batch (no backward).
        want["flash_fwd"] += mcfg.num_layers * WINDOW_EVAL_BATCHES * len(rec.eval_steps)
        log(f"[train-{name}] launches {launches} (expected {want}); evals at steps "
            f"{rec.eval_steps}, losses {[round(x, 4) for x in rec.eval_losses]}")
        # Both runs: K1-K3 launches a step as phase 7's, loss_chunk or not.
        check(rec.steps == steps and rec.captures == 1 and launches == want,
              f"{name}: {rec.steps} steps, {rec.captures} captures, launches {launches}")
        check(rec.windows == windows[name], f"{name}: {rec.windows} windows, "
              f"expected {windows[name]}")
        check(all(math.isfinite(x) for x in rec.losses + rec.eval_losses),
              f"{name}: losses {rec.losses}, eval losses {rec.eval_losses}")
    win, chunk = perf["window"], perf["loss_chunk"]
    first = reference["losses"][:TRAIN_STEPS]
    check(win["losses"][:TRAIN_STEPS] == first
          and win["grad_norms"][:TRAIN_STEPS] == reference["grad_norms"][:TRAIN_STEPS],
          f"k={WINDOW_K} steps 1-{TRAIN_STEPS} {win['losses'][:TRAIN_STEPS]} are not "
          f"bit-equal to phase 7's k=1 graphed {first}")
    check(win["eval_steps"] == [WINDOW_K, WINDOW_STEPS], f"evals at {win['eval_steps']}")
    rel = [abs(a - b) / abs(b) for a, b in zip(chunk["losses"], win["losses"])]
    log(f"[train-loss_chunk] losses against the run without: relative differences "
        f"{[f'{r:.2e}' for r in rel]} (step 1 limit {LOSS_CHUNK_STEP1_RTOL:.0e}); peak "
        f"memory {chunk['peak_memory_gb']:.2f} GB against {win['peak_memory_gb']:.2f} GB "
        f"without loss_chunk")
    check(rel[0] <= LOSS_CHUNK_STEP1_RTOL, f"loss_chunk step 1 loss rel {rel[0]:.2e}")
    check(chunk["peak_memory_gb"] < win["peak_memory_gb"],
          f"loss_chunk peak {chunk['peak_memory_gb']:.2f} GB is not below "
          f"{win['peak_memory_gb']:.2f} GB")
    perf["losses_bit_equal_to_k1"] = True
    perf["loss_chunk_loss_rel"] = rel
    log("[train-window] perf " + json.dumps(perf))
    return perf


# ----------------------------------------------------------------------
# Checkpoint slice 7: train -> checkpoint -> resume -> export -> serve
# ----------------------------------------------------------------------

# Phase 13's depth: llama2_7b at full width and full depth. A checkpoint is
# ~13.7 GB (the 13.5 GB bf16 base, LoRA factors and float32 moments); two
# checkpoints and an export need ~41 GB of disk.
CKPT_LAYERS = 32
CKPT_SAVE_STEPS = 4
CKPT_REQUESTS = 4
CKPT_NEW_TOKENS = 16
# Free space the phase needs beyond its three artifacts.
CKPT_DISK_MARGIN = 2 << 30


class LogLines(logging.Handler):
    """Keeps the messages of the records it is handed."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def tree_bytes(step_dir) -> int:
    """Bytes of every file a manifest lists."""
    manifest = json.loads((Path(step_dir) / "MANIFEST.json").read_text())
    return sum(e["size"] for e in manifest["leaves"]) + sum(
        m["size"] for m in manifest["meta_files"].values())


def host_rates(torch) -> dict:
    """The host's side of a checkpoint, on 1 GiB: SHA-256 on one core,
    pinning a fresh host buffer, and copies from the card into pinned and
    into pageable memory (GB/s)."""
    n = 1 << 30
    src = torch.empty(n, dtype=torch.uint8, device="cuda")
    data = bytes(n)
    t0 = time.perf_counter()
    hashlib.sha256(data).hexdigest()
    rates = {"sha256_gb_s": n / (time.perf_counter() - t0) / 1e9}
    del data
    t0 = time.perf_counter()
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    rates["pin_gb_s"] = n / (time.perf_counter() - t0) / 1e9
    for name, dst in (("d2h_pinned_gb_s", pinned),
                      ("d2h_pageable_gb_s", torch.empty(n, dtype=torch.uint8))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst.copy_(src)
        torch.cuda.synchronize()
        rates[name] = n / (time.perf_counter() - t0) / 1e9
    return rates


def phase_checkpoint(torch, reference, card, flush):
    """Phase 13: llama2_7b LoRA trained on the card, checkpointed, resumed,
    verified, exported through ``cli.export`` and served from the export
    through ``cli.serve.build``; see the module docstring."""
    import shutil
    import tempfile

    from dlti_tpu_torch.checkpoint import store
    from dlti_tpu_torch.checkpoint.export import merged_tree
    from dlti_tpu_torch.cli import export as export_cli
    from dlti_tpu_torch.cli import serve as serve_cli
    from dlti_tpu_torch.config import CheckpointConfig
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.serving import SamplingParams
    from dlti_tpu_torch.training import Trainer

    root = Path(tempfile.mkdtemp(prefix="dlti-ckpt-"))
    ck_dir, ex_dir = root / "ckpt", root / "export"
    ckpt = CheckpointConfig(output_dir=str(ck_dir), save_strategy="steps",
                            save_steps=CKPT_SAVE_STEPS, save_total_limit=2,
                            async_save=True)
    first = train_config(ckpt, max_steps=CKPT_SAVE_STEPS, num_layers=CKPT_LAYERS)
    mcfg, lora = first.model, first.lora
    perf = {"card": card, "layers": mcfg.num_layers, **host_rates(torch)}
    t_phase = time.perf_counter()
    log(f"[ckpt] {card}; llama2_7b layers {mcfg.num_layers} of "
        f"{MODEL_LAYERS}, full width")
    log(f"[ckpt] host rates on 1 GiB: SHA-256 {perf['sha256_gb_s']:.2f} GB/s (one core), "
        f"pinning {perf['pin_gb_s']:.2f} GB/s, card to pinned {perf['d2h_pinned_gb_s']:.1f}"
        f" GB/s, card to pageable {perf['d2h_pageable_gb_s']:.2f} GB/s")
    handler, port_log = LogLines(), logging.getLogger("dlti_tpu_torch")
    level = port_log.level
    port_log.addHandler(handler)
    port_log.setLevel(logging.INFO)
    try:
        # Two checkpoints and an export, all of the model's size, plus margin.
        model_bytes = 2 * mcfg.num_params()
        need = 3 * model_bytes + CKPT_DISK_MARGIN
        free0 = shutil.disk_usage(root).free
        perf["free_gb_before"] = free0 / 1e9
        check(free0 >= need, f"phase 13 needs {need / 1e9:.1f} GB free under {root}, "
              f"the disk has {free0 / 1e9:.1f} GB")
        dataset = make_batches(training_texts(), ByteTokenizer(), seq_len=512,
                               micro_batch_size=4, grad_accum_steps=2)
        tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
        tpa.launches = 0  # this path's counts start here ...

        # 1. Save: steps 1-4 from phase 7's weights, step 4 committed async.
        sum0 = store.save_seconds.snapshot()[1]
        trainer = Trainer(first, params=init_params(mcfg, seed=0, device="cuda", lora=lora),
                          device="cuda")
        state, rec1 = trainer.train(dataset=dataset)
        sum1 = store.save_seconds.snapshot()[1]
        check(rec1.save_steps == [CKPT_SAVE_STEPS] and rec1.resumed_from is None,
              f"first run saved {rec1.save_steps}, resumed from {rec1.resumed_from}")
        check(store.list_checkpoint_steps(ck_dir) == [CKPT_SAVE_STEPS],
              f"checkpoints {store.list_checkpoint_steps(ck_dir)}")
        del state, trainer
        free_memory(torch)

        # 2. Resume: a fresh trainer (other random weights, which the restore
        # replaces) continues to step 8.
        second = dataclasses.replace(first, train=dataclasses.replace(
            first.train, max_steps=TRAIN_STEPS))
        trainer = Trainer(second, params=init_params(mcfg, seed=1, device="cuda", lora=lora),
                          device="cuda")
        state, rec2 = trainer.train(dataset=dataset)
        sum2 = store.save_seconds.snapshot()[1]
        check(rec2.resumed_from == CKPT_SAVE_STEPS and any(
            f"resumed from verified checkpoint step {CKPT_SAVE_STEPS}" in ln
            for ln in handler.lines), f"no resume from step {CKPT_SAVE_STEPS}: "
              f"{rec2.resumed_from}, log {handler.lines[-5:]}")
        check(rec2.save_steps == [TRAIN_STEPS], f"second run saved {rec2.save_steps}")
        steps = list(range(CKPT_SAVE_STEPS + 1, TRAIN_STEPS + 1))
        log(f"[ckpt] resumed losses {rec2.losses} / phase 7 "
            f"{reference['losses'][CKPT_SAVE_STEPS:]}")
        log(f"[ckpt] resumed grad norms {rec2.grad_norms} / phase 7 "
            f"{reference['grad_norms'][CKPT_SAVE_STEPS:]}")
        if mcfg.num_layers == MODEL_LAYERS:
            check(rec2.losses == reference["losses"][CKPT_SAVE_STEPS:]
                  and rec2.grad_norms == reference["grad_norms"][CKPT_SAVE_STEPS:],
                  f"steps {steps} after the resume are not bit-equal to phase 7's")
        check(store.list_checkpoint_steps(ck_dir) == [CKPT_SAVE_STEPS, TRAIN_STEPS],
              f"checkpoints {store.list_checkpoint_steps(ck_dir)}")
        train_launches = {"flash_fwd": tfa.fwd_launches, "flash_bwd_dq": tfa.dq_launches,
                          "flash_bwd_dkv": tfa.dkv_launches}
        # 8 replayed steps and each trainer's capture warm-up step.
        want = flash_expected(mcfg.num_layers, 2,
                              TRAIN_STEPS + rec1.captures + rec2.captures)
        check(train_launches == want, f"training launches {train_launches} != {want}")

        # 3. Verify step 8 (re-hash every file; the resume re-hashed step 4
        # already).
        t0 = time.perf_counter()
        ok = store.verify_checkpoint(ck_dir, TRAIN_STEPS)
        check(ok == (True, "ok"), f"verify_checkpoint step {TRAIN_STEPS}: {ok}")
        verify_s = time.perf_counter() - t0

        # 4. Export step 8 through cli.export; its params must be byte-equal
        # to the merge of the live resumed state, run on the card.
        with torch.no_grad():
            live = merged_tree(dict(state.model.named_parameters()), second)
            live_digest = hashlib.sha256(store.manifest_of(live)).hexdigest()
        del live, state, trainer
        free_memory(torch)
        t0 = time.perf_counter()
        digest = export_cli.export(export_cli.parse_args([
            "--checkpoint-dir", str(ck_dir), "--step", str(TRAIN_STEPS),
            "--model", "llama2_7b", "--lora-r", str(lora.r), "--out", str(ex_dir)]))
        export_s = time.perf_counter() - t0
        check(digest == live_digest, f"export digest {digest} != live merge {live_digest}")
        exported = json.loads((ex_dir / "config.json").read_text())
        check(exported["lora"]["enabled"] is False, "the export's config keeps LoRA on")
        free_memory(torch)

        # 5. Serve 4 greedy requests from the export (bf16 pool, CLI defaults).
        argv = ["--model-dir", str(ex_dir), "--tokenizer", "byte"]
        if mcfg.num_layers != MODEL_LAYERS:  # the cut model's config names its depth
            check(exported["model"]["num_layers"] == mcfg.num_layers, "export depth")
        t0 = time.perf_counter()
        engine, tok, _ = serve_cli.build(serve_cli.parse_args(argv))
        load_s = time.perf_counter() - t0
        engine.warmup_decode_ladder()
        launches_before = tpa.launches
        decode_before = engine.stats["decode_steps"]
        prompts = [tok.encode(t[:96]) for t in training_texts(CKPT_REQUESTS, seed=7)]
        results = engine.generate(prompts, SamplingParams(temperature=0.0,
                                                          max_tokens=CKPT_NEW_TOKENS))
        decode_steps = engine.stats["decode_steps"] - decode_before
        k4 = tpa.launches - launches_before
        check(len(results) == CKPT_REQUESTS and all(r.output_token_ids for r in results),
              "a request from the export produced no tokens")
        check(k4 == mcfg.num_layers * decode_steps,
              f"K4 launches {k4} != {mcfg.num_layers} x {decode_steps} decode steps")
        log(f"[ckpt] served {CKPT_REQUESTS} greedy requests from the export: "
            f"{[len(r.output_token_ids) for r in results]} tokens, {decode_steps} decode "
            f"steps, K4 {k4} launches (+ the warm-up's)")
        launches = {**train_launches, "paged_decode_attention": tpa.launches}
        # ... and are read here, with the serve's warm-up. Then the engine's
        # state (the export's weights, 128-block tables) is checked.
        log("[ckpt] the served export's engine, checked as in phase 4:")
        in_model = phase_in_model(torch, engine, flush)
        perf["in_model"] = {k: in_model[k] for k in (
            "max_abs_err", "row_rel_err", "logits_rel", "argmax_agree", "splits",
            "chunk", "ms", "plain_ms", "bound_ms")}
        del engine
        free_memory(torch)

        gb = [tree_bytes(ck_dir / str(s)) / 1e9 for s in (CKPT_SAVE_STEPS, TRAIN_STEPS)]
        writer_s = [sum1 - sum0, sum2 - sum1]
        free1 = shutil.disk_usage(root).free
        perf.update({
            "losses_bit_equal": rec2.losses == reference["losses"][CKPT_SAVE_STEPS:],
            "save_stall_ms": [1e3 * rec1.save_stall_s[0], 1e3 * rec2.save_stall_s[0]],
            "writer_s": writer_s, "gb_written": gb,
            "write_hash_gb_s": [g / w for g, w in zip(gb, writer_s)],
            "restore_s": rec2.restore_s, "verify_s": verify_s, "export_s": export_s,
            "export_gb": tree_bytes(ex_dir / "model") / 1e9, "load_s": load_s,
            "free_gb_after": free1 / 1e9, "launches": launches,
            "train_step_ms": [1e3 * x for x in rec1.step_times_s + rec2.step_times_s]})
        log(f"[ckpt] save stall {perf['save_stall_ms'][0]:.1f} ms at step "
            f"{CKPT_SAVE_STEPS} (cold: the whole state copied) and "
            f"{perf['save_stall_ms'][1]:.1f} ms at step {TRAIN_STEPS} (the frozen base's "
            f"host copy kept from the restore)")
        log(f"[ckpt] writer {writer_s[0]:.2f} s / {writer_s[1]:.2f} s per save for "
            f"{gb[0]:.3f} / {gb[1]:.3f} GB: write+hash {perf['write_hash_gb_s'][0]:.3f} / "
            f"{perf['write_hash_gb_s'][1]:.3f} GB/s")
        log(f"[ckpt] restore {rec2.restore_s:.2f} s (scan, re-hash, read, placement on the "
            f"card); verify {verify_s:.2f} s a step; export {export_s:.2f} s "
            f"({perf['export_gb']:.3f} GB); --model-dir load {load_s:.2f} s")
        perf["phase_s"] = time.perf_counter() - t_phase
        log(f"[ckpt] free disk {perf['free_gb_before']:.1f} GB before, "
            f"{perf['free_gb_after']:.1f} GB with both checkpoints and the export; "
            f"phase {perf['phase_s']:.1f} s")
    finally:
        port_log.removeHandler(handler)
        port_log.setLevel(level)
        shutil.rmtree(root, ignore_errors=True)
    log("[ckpt] perf " + json.dumps(perf))
    return launches, perf


# ----------------------------------------------------------------------
# The fp16 path: --fp16 through train -> checkpoint -> export -> serve
# ----------------------------------------------------------------------

# Phase 15's runs. The fp16 step at full depth is phase 7's run in float16;
# the run from 2**40 and the checkpoint leg cut the depth (full width), so
# the phase stays within about 90 s: the checkpoint leg's llama2_7b of 8
# layers writes ~3.5 GB a checkpoint where phase 13's writes 13.7 GB.
# The reference scales the loss's sum over tokens (not its mean), so at
# 2**16 llama2_7b's float16 gradients overflow (the LoRA factors' gradients
# in the compute dtype sum a microbatch's 2,048 tokens): the full-depth run
# takes 32 steps, two a halving (hysteresis 2), to reach a scale that fits.
FP16_TRAIN_STEPS = 16  # its first applied step is 15 (PR 9-11 runs)
FP16_OVERFLOW_LAYERS = 4
FP16_OVERFLOW_STEPS = 72       # from 2**40 down to 2**4 at most
FP16_OVERFLOW_EAGER_STEPS = 16  # the eager yardstick: two windows, all skipped
FP16_OVERFLOW_POWER = 40
FP16_CKPT_LAYERS = 8
FP16_CKPT_PRESET = "llama2_7b_8_layers"


def fp16_train_config(output_dir, max_steps, num_layers=None, extra=()):
    """``cli.train``'s configuration (its own ``build_config``) with
    ``--fp16`` and phase 7's settings: llama2_7b LoRA r=16, seq 512,
    micro-batch 4 x accum 2, warmup 2, lr 2e-4, remat; the model in float16
    under the dynamic loss scaler from 2**16."""
    from dlti_tpu_torch.cli import train as train_cli

    args = train_cli.parse_args([
        "--model", "llama2_7b", "--tokenizer", "byte", "--fp16", "--max-seq-len", "512",
        "--per-device-batch-size", "4", "--gradient-accumulation-steps", "2",
        "--warmup-steps", "2", "--learning-rate", "2e-4", "--max-steps", str(max_steps),
        "--logging-steps", "1", "--output-dir", str(output_dir), *extra])
    cfg = train_cli.build_config(args)
    if num_layers is not None:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, num_layers=num_layers))
    check(cfg.train.fp16 and cfg.model.dtype == cfg.model.param_dtype == "float16",
          "cli.train --fp16 did not give a float16 model under the scaler")
    return cfg


def scaler_replay(overflow, scale, window, hysteresis=2, min_scale=1.0):
    """The loss scale after each step, by the reference's rule
    (``apply_loss_scaler``) replayed on the host from the steps' overflow
    flags."""
    good, hyst, out = 0, hysteresis, []
    for bad in overflow:
        shrink = bad and hyst <= 1
        hyst = max(hyst - 1, 0) if bad else hyst
        scale = max(scale * 0.5, min_scale) if shrink else scale
        good = 0 if bad else good + 1
        grow = good >= window
        if grow:
            scale, good = scale * 2.0, 0
        if shrink or grow:
            hyst = hysteresis
        out.append(scale)
    return out


def same_floats(a, b) -> bool:
    """Bit-equal lists of floats, NaN equal to NaN (an overflowing step's
    loss or grad norm)."""
    return len(a) == len(b) and all(x == y or (math.isnan(x) and math.isnan(y))
                                    for x, y in zip(a, b))


def phase_fp16(torch, bf16_perf, card, flush):
    """Phase 15 (run after phase 13): the fp16 path on llama2_7b at full
    width; see the module docstring. Returns (launches, perf)."""
    import shutil
    import tempfile

    from dlti_tpu_torch.checkpoint import store
    from dlti_tpu_torch.cli import export as export_cli
    from dlti_tpu_torch.cli import serve as serve_cli
    from dlti_tpu_torch.config import MODEL_PRESETS
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.serving import SamplingParams
    from dlti_tpu_torch.training import Trainer

    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="dlti-fp16-"))
    perf = {"card": card}
    dataset = make_batches(training_texts(), ByteTokenizer(), seq_len=512,
                           micro_batch_size=4, grad_accum_steps=2)
    for name in FLASH_REPLACES:
        design = tfa.kernel_design(name, torch.float16, 128)
        check(design.startswith("wgmma f16"), f"{name} in float16 at d 128 runs {design}")
    launches = {}
    try:
        # 1. cli.train --fp16's configuration, graphed steps at full depth.
        cfg = fp16_train_config(root / "unused", FP16_TRAIN_STEPS,
                                extra=["--save-strategy", "no", "--num-train-epochs", "3"])
        mcfg = cfg.model
        trainer = Trainer(cfg, params=init_params(mcfg, seed=0, device="cuda", lora=cfg.lora),
                          device="cuda")
        state = trainer.init_state()
        check(float(state.scaler["scale"]) == 2.0 ** 16, "the scaler does not start at 2**16")
        tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
        tpa.launches = 0  # the fp16 training path's counts start here ...
        state, rec = trainer.train(dataset=dataset, state=state)
        torch.cuda.synchronize()
        launches.update(flash_counts(tfa))  # ... and are read here
        want = flash_expected(mcfg.num_layers, 2, FP16_TRAIN_STEPS + rec.captures)
        check(rec.captures == 1 and {k: launches[k] for k in want} == want,
              f"fp16 flash launches {launches} != {want}")
        check(tpa.launches == 0, "fp16 training launched the decode kernel")
        p = train_perf(rec, mcfg)
        p.update(loss_scales=rec.loss_scales, overflows=rec.skipped_updates)
        log_train_perf("[fp16]", p, mcfg)
        # An overflow is a step whose grad norm is not finite (its loss is).
        overflow = [not math.isfinite(x) for x in rec.grad_norms]
        first_applied = next((i + 1 for i, o in enumerate(overflow) if not o), None)
        log(f"[fp16] log2 loss scale after each step "
            f"{[int(math.log2(x)) for x in rec.loss_scales]}; {rec.skipped_updates} of "
            f"{rec.steps} steps overflowed; first applied step {first_applied}")
        check(rec.loss_scales == scaler_replay(overflow, 2.0 ** 16, window=1000),
              "the graphed scaler's scales differ from the rule replayed on the host")
        check(first_applied is not None and all(math.isfinite(x) for x in rec.losses),
              f"every fp16 step overflowed ({rec.loss_scales}) or a loss is not finite")
        check(all(t.detach().abs().max().item() > 0 for n, t in state.model.named_parameters()
                  if n.endswith("lora_b")), "an fp16 lora_b is still zero")
        log(f"[fp16] step {p['step_ms']:.1f} ms, {p['tokens_per_s']:.1f} tokens/s, MFU "
            f"{p['mfu_percent']:.2f}%, peak {p['peak_memory_gb']:.2f} GB; bf16 (phase 7, this "
            f"call) {bf16_perf['step_ms']:.1f} ms, {bf16_perf['tokens_per_s']:.1f} tokens/s, "
            f"MFU {bf16_perf['mfu_percent']:.2f}%, peak {bf16_perf['peak_memory_gb']:.2f} GB: "
            f"fp16/bf16 step {p['step_ms'] / bf16_perf['step_ms']:.4f}")
        p["first_applied_step"] = first_applied
        perf["train"] = p
        del state, trainer
        free_memory(torch)

        # 2. From 2**40 (depth cut): every step overflows until the scale
        # fits, skipping and halving; the eager run's first 16 steps are
        # bit-equal to the graphed run's.
        over = fp16_train_config(root / "unused", FP16_OVERFLOW_STEPS, FP16_OVERFLOW_LAYERS,
                                 extra=["--save-strategy", "no", "--steps-per-sync", "8",
                                        "--num-train-epochs", "6"])
        over = over.replace(train=dataclasses.replace(
            over.train, fp16_initial_scale_power=FP16_OVERFLOW_POWER))
        runs = {}
        for graphs in (True, False):
            cfg_run = over if graphs else over.replace(train=dataclasses.replace(
                over.train, max_steps=FP16_OVERFLOW_EAGER_STEPS))
            trainer = Trainer(cfg_run, params=init_params(over.model, seed=0, device="cuda",
                                                          lora=over.lora),
                              device="cuda", cuda_graphs=graphs)
            st, r = trainer.train(dataset=dataset)
            runs[graphs] = (r, {k: float(t) for k, t in st.scaler.items()})
            del st, trainer
            free_memory(torch)
        (g, gs), (e, es) = runs[True], runs[False]
        scales = g.loss_scales
        first_fit = next((i for i, x in enumerate(g.grad_norms) if math.isfinite(x)), None)
        check(g.loss_scales == scaler_replay([not math.isfinite(x) for x in g.grad_norms],
                                             2.0 ** FP16_OVERFLOW_POWER, window=1000),
              "the scales from 2**40 differ from the rule replayed on the host")
        log(f"[fp16-overflow] llama2_7b layers {FP16_OVERFLOW_LAYERS}, from 2**"
            f"{FP16_OVERFLOW_POWER}: {g.skipped_updates} of {g.steps} steps skipped; scale "
            f"after each step {[int(math.log2(x)) for x in scales]} (log2); first applied "
            f"step {None if first_fit is None else first_fit + 1}; final scaler {gs}")
        n = FP16_OVERFLOW_EAGER_STEPS
        same = (e.steps == n and same_floats(g.losses[:n], e.losses)
                and same_floats(g.grad_norms[:n], e.grad_norms)
                and g.loss_scales[:n] == e.loss_scales)
        log(f"[fp16-overflow] eager steps 1-{n} bit-equal to the graphed run's (losses, "
            f"grad norms, scales): {same}; eager scaler after step {n}: {es}")
        check(g.skipped_updates >= 2 and scales[1] == 2.0 ** (FP16_OVERFLOW_POWER - 1)
              and first_fit is not None,
              f"the run from 2**{FP16_OVERFLOW_POWER} did not skip, halve and fit: "
              f"{scales[:4]}, first applied step {first_fit}")
        check(same, "the graphed fp16 run from 2**40 differs from the eager one")
        perf["overflow"] = {"layers": FP16_OVERFLOW_LAYERS, "steps": g.steps,
                            "skipped": g.skipped_updates,
                            "log2_scales": [math.log2(x) for x in scales],
                            "first_applied_step": None if first_fit is None else first_fit + 1,
                            "bit_equal": same}

        # 3. Checkpoint at step 4, resume steps 5-8 (depth cut), export
        # through cli.export --fp16, serve through cli.serve --model-dir
        # --kv-cache-dtype float16.
        MODEL_PRESETS[FP16_CKPT_PRESET] = dataclasses.replace(
            MODEL_PRESETS["llama2_7b"], num_layers=FP16_CKPT_LAYERS)
        ck_dir, ex_dir = root / "ckpt", root / "export"
        ref_cfg = fp16_train_config(root / "ref", TRAIN_STEPS, FP16_CKPT_LAYERS,
                                    extra=["--save-strategy", "no"])
        ref_tr = Trainer(ref_cfg, params=init_params(ref_cfg.model, seed=0, device="cuda",
                                                     lora=ref_cfg.lora), device="cuda")
        ref_state, ref = ref_tr.train(dataset=dataset)
        ref_scaler = {k: float(t) for k, t in ref_state.scaler.items()}
        del ref_state, ref_tr
        free_memory(torch)
        save = ["--save-steps", str(CKPT_SAVE_STEPS), "--save-total-limit", "2"]
        first = fp16_train_config(ck_dir, CKPT_SAVE_STEPS, FP16_CKPT_LAYERS, extra=save)
        tr = Trainer(first, params=init_params(first.model, seed=0, device="cuda",
                                               lora=first.lora), device="cuda")
        _, r1 = tr.train(dataset=dataset)
        del tr
        free_memory(torch)
        second = fp16_train_config(ck_dir, TRAIN_STEPS, FP16_CKPT_LAYERS, extra=save)
        tr = Trainer(second, params=init_params(second.model, seed=1, device="cuda",
                                                lora=second.lora), device="cuda")
        st2, r2 = tr.train(dataset=dataset)
        scaler2 = {k: float(t) for k, t in st2.scaler.items()}
        del st2, tr
        free_memory(torch)
        meta = store.load_train_meta(str(ck_dir), CKPT_SAVE_STEPS)
        resumed = (same_floats(r2.losses, ref.losses[CKPT_SAVE_STEPS:])
                   and same_floats(r2.grad_norms, ref.grad_norms[CKPT_SAVE_STEPS:])
                   and r2.loss_scales == ref.loss_scales[CKPT_SAVE_STEPS:]
                   and scaler2 == ref_scaler)
        log(f"[fp16-ckpt] layers {FP16_CKPT_LAYERS}: saved {r1.save_steps}, resumed from "
            f"{r2.resumed_from} (sidecar fp16 {meta and meta.get('fp16')}); steps 5-8 "
            f"losses {r2.losses} / uninterrupted {ref.losses[CKPT_SAVE_STEPS:]}; scales "
            f"{r2.loss_scales} / {ref.loss_scales[CKPT_SAVE_STEPS:]}; bit-equal {resumed}")
        check(r1.save_steps == [CKPT_SAVE_STEPS] and r2.resumed_from == CKPT_SAVE_STEPS
              and meta and meta.get("fp16") is True, "the fp16 checkpoint did not resume")
        check(resumed, "fp16 steps 5-8 after the resume differ from the uninterrupted run")
        # The resume re-hashed step 4; step 8 is re-hashed here.
        check(store.verify_checkpoint(ck_dir, TRAIN_STEPS) == (True, "ok"),
              f"verify {TRAIN_STEPS}")
        t0 = time.perf_counter()
        export_cli.export(export_cli.parse_args([
            "--checkpoint-dir", str(ck_dir), "--model", FP16_CKPT_PRESET, "--lora-r", "16",
            "--fp16", "--out", str(ex_dir)]))
        export_s = time.perf_counter() - t0
        exported = json.loads((ex_dir / "config.json").read_text())
        check(exported["model"]["dtype"] == "float16", "the export is not a float16 model")
        engine, tok, _ = serve_cli.build(serve_cli.parse_args([
            "--model-dir", str(ex_dir), "--tokenizer", "byte", "--kv-cache-dtype", "float16"]))
        check(engine.cache[0]["k"].dtype == torch.float16
              and engine.model.model.embed_tokens.dtype == torch.float16,
              "the served export is not float16 on a float16 pool")
        engine.warmup_decode_ladder()
        tpa.launches = tpa.launches_int8 = 0  # the fp16 serving path's counts start here ...
        decode0 = engine.stats["decode_steps"]
        prompts = [tok.encode(t[:96]) for t in training_texts(CKPT_REQUESTS, seed=7)]
        results = engine.generate(prompts, SamplingParams(temperature=0.0,
                                                          max_tokens=CKPT_NEW_TOKENS))
        torch.cuda.synchronize()
        decode_steps = engine.stats["decode_steps"] - decode0
        launches["paged_decode_attention"] = tpa.launches  # ... and are read here
        check(len(results) == CKPT_REQUESTS and all(r.output_token_ids for r in results)
              and all(math.isfinite(x) for r in results for x in r.output_logprobs),
              "the fp16 export served no tokens or nonfinite logprobs")
        check(tpa.launches == FP16_CKPT_LAYERS * decode_steps and tpa.launches_int8 == 0,
              f"K4 launches {tpa.launches} != {FP16_CKPT_LAYERS} x {decode_steps}")
        log(f"[fp16-serve] {CKPT_REQUESTS} greedy requests from the fp16 export on a "
            f"float16 pool: {[len(r.output_token_ids) for r in results]} tokens, "
            f"{decode_steps} decode steps, K4 {tpa.launches} launches; export "
            f"{export_s:.2f} s")
        in_model = phase_in_model(torch, engine, flush)
        perf["ckpt"] = {"layers": FP16_CKPT_LAYERS, "resumed_bit_equal": resumed,
                        "export_s": export_s, "decode_steps": decode_steps,
                        "in_model": {k: in_model[k] for k in (
                            "max_abs_err", "row_rel_err", "logits_rel", "argmax_agree",
                            "ms", "plain_ms", "bound_ms")}}
        del engine
        free_memory(torch)
    finally:
        MODEL_PRESETS.pop(FP16_CKPT_PRESET, None)
        shutil.rmtree(root, ignore_errors=True)
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"[fp16] phase {perf['phase_s']:.1f} s")
    log("[fp16] perf " + json.dumps(perf))
    return launches, perf


# ----------------------------------------------------------------------
# Serving slice 3: the OpenAI server and serve CLI on an int8 KV pool (K4q)
# ----------------------------------------------------------------------

SERVE_ARGS = ["--random-init", "llama2_7b", "--tokenizer", "byte",
              "--kv-cache-dtype", "int8", "--host", "127.0.0.1", "--port", "0"]
# The reference's documented serving configuration (README's serve command):
# int8 weights, int8 KV, 28 slots, 64 decode steps a host sync.
DOCUMENTED_FLAGS = ["--max-seqs", "28", "--steps-per-sync", "64", "--quantization", "int8"]
DOCUMENTED_ARGS = SERVE_ARGS + DOCUMENTED_FLAGS


def http_request(addr, method, path, body=None, timeout=600, headers=None):
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request(method, path, json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def post_json(addr, path, body):
    status, data = http_request(addr, "POST", path, body)
    check(status == 200, f"POST {path} {body} answered {status}: {data[:300]!r}")
    obj = json.loads(data)
    for c in obj["choices"]:
        check(c["finish_reason"] in ("length", "stop"),
              f"POST {path}: finish_reason {c['finish_reason']!r}")
    return obj


def post_stream(addr, path, body):
    """(deltas, final chunk) of an SSE completion; any error frame fails."""
    status, raw = http_request(addr, "POST", path, {**body, "stream": True})
    check(status == 200, f"stream {path} answered {status}")
    events = [ln[len("data: "):] for ln in raw.decode().splitlines()
              if ln.startswith("data: ")]
    check(events and events[-1] == "[DONE]", "stream did not end with [DONE]")
    chunks = [json.loads(e) for e in events[:-1]]
    check(not any("error" in c for c in chunks), f"SSE error frame: {chunks[-1]}")
    deltas = [c["choices"][0]["delta"].get("content", "") if "delta" in c["choices"][0]
              else c["choices"][0].get("text", "") for c in chunks]
    final = chunks[-1]
    check(final["choices"][0]["finish_reason"] in ("length", "stop"),
          f"stream finish_reason {final['choices'][0]['finish_reason']!r}")
    return deltas, final


def incremental_text(tok, ids):
    """The text the server streams for these token ids: the suffix of the
    running decode, token by token (a replacement character, once
    streamed, is not taken back)."""
    emitted = ""
    for i in range(1, len(ids) + 1):
        emitted += tok.decode(ids[:i])[len(emitted):]
    return emitted


def server_requests(seed=0):
    """The phase's 12 requests: 6 greedy completions of 32 tokens (prompts
    of 16-300 bytes), 2 streamed, 2 chat, 1 n=2 seeded, 1 with a stop."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = ["serve", "the", "model", "int8", "cache", "token", "decode", "page",
             "block", "attention", "kernel", "of", "a", "query"]

    def text(n):
        out = ""
        while len(out) < n:
            out += str(rng.choice(words)) + " "
        return out[:n]

    lengths = [16, 300] + rng.integers(16, 301, 6).tolist()
    greedy = dict(max_tokens=32, temperature=0.0, logprobs=True)
    reqs = [("completion", "/v1/completions", {"prompt": text(n), **greedy})
            for n in lengths[:6]]
    reqs += [("stream", "/v1/completions", {"prompt": text(n), "max_tokens": 32,
                                            "temperature": 0.0})
             for n in lengths[6:8]]
    reqs += [("chat", "/v1/chat/completions", {
        "messages": [{"role": "system", "content": "Answer briefly."},
                     {"role": "user", "content": text(n)}], **greedy})
        for n in (40, 120)]
    reqs.append(("n2", "/v1/completions", {"prompt": text(64), "n": 2, "seed": 7,
                                           "max_tokens": 32, "temperature": 0.8,
                                           "top_p": 0.95, "logprobs": True}))
    reqs.append(("stop", "/v1/completions", {"prompt": text(90), "stop": ["e "],
                                             **greedy}))
    return reqs


def phase_server(torch, argv=SERVE_ARGS, tag="[server]"):
    """llama2_7b from the serve CLI's own builder on an int8 pool (the CLI's
    defaults, or ``argv``), warmed up as the CLI warms it, behind
    ``make_server`` on a free port: 12 concurrent requests, then a greedy
    prompt twice and streamed, one at a time."""
    import threading

    from dlti_tpu_torch.cli import serve as cli
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.serving import make_server
    from dlti_tpu_torch.serving.server import llama2_chat_prompt

    args = cli.parse_args(argv)
    if argv is SERVE_ARGS:
        check((args.max_seqs, args.num_blocks, args.block_size, args.max_model_len,
               args.steps_per_sync) == (8, 2048, 16, 2048, 1),
              "the serve CLI's defaults changed")
    t0 = time.perf_counter()
    engine, tok, sc = cli.build(args)
    engine.warmup_decode_ladder()
    torch.cuda.synchronize()
    cfg = engine.model_cfg
    pool_bytes = sum(t.numel() * t.element_size() for c in engine.cache for t in c.values())
    scale_bytes = sum(c[k].numel() * 4 for c in engine.cache for k in ("k_scale", "v_scale"))
    check(engine.cache[0]["k"].dtype == torch.int8, "the CLI did not build an int8 pool")
    log(f"{tag} {' '.join(argv)}: {args.random_init} engine from the serve CLI "
        f"builder, warmed up, in "
        f"{time.perf_counter() - t0:.1f} s: int8 KV pool {pool_bytes / 1e9:.3f} GB "
        f"({scale_bytes / 1e9:.3f} GB of it float32 scales; {args.num_blocks} blocks x "
        f"{args.block_size} tokens x {cfg.num_layers} layers), device memory "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    # Host time of each engine step on the stepper thread (a step ends by
    # reading its tokens back, so the device work is inside it).
    step_s = []
    real_step = engine.step

    def timed_step():
        t = time.perf_counter()
        try:
            return real_step()
        finally:
            step_s.append(time.perf_counter() - t)

    engine.step = timed_step
    httpd, aeng = make_server(engine, tok, sc)
    addr = ("127.0.0.1", httpd.server_address[1])
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        reqs = server_requests()
        results = [None] * len(reqs)
        errors = []

        def run(i, kind, path, body):
            try:
                results[i] = (post_stream(addr, path, body) if kind == "stream"
                              else post_json(addr, path, body))
            except Exception as e:  # reported, and fails the phase below
                errors.append(f"{kind} {i}: {type(e).__name__}: {e}")

        # The main path's counts start here ...
        tpa.launches = tpa.launches_int8 = 0
        tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i, *r)) for i, r in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "a request did not finish")
        check(not errors, f"server requests failed: {errors}")

        # One at a time: a greedy prompt twice, then streamed.
        kind, path, body = reqs[0]
        first = post_json(addr, path, body)
        again = post_json(addr, path, body)
        deltas, final = post_stream(addr, path, {k: v for k, v in body.items()
                                                  if k != "logprobs"})
        torch.cuda.synchronize()
        launches_int8, launches_float = tpa.launches_int8, tpa.launches  # ... read here
        flash = tfa.fwd_launches + tfa.dq_launches + tfa.dkv_launches
        decode_steps = engine.stats["decode_steps"]

        completion_tokens = 0
        for (kind, path, body), res in zip(reqs, results):
            if kind == "stream":
                deltas_i, fin = res
                usage = fin["usage"]
                check(0 < usage["completion_tokens"] <= 32, f"stream usage {usage}")
            else:
                usage = res["usage"]
                n_tok = sum(len(c["logprobs"]["tokens"]) for c in res["choices"])
                check(usage["completion_tokens"] == n_tok,
                      f"{kind}: usage {usage} but {n_tok} tokens")
                check(all(len(c["logprobs"]["tokens"]) <= 32 for c in res["choices"]),
                      f"{kind}: more than max_tokens")
                check(len(res["choices"]) == body.get("n", 1), f"{kind}: choices")
                if kind == "stop":
                    check("e " not in res["choices"][0]["text"], "stop string returned")
            prompt = (body["prompt"] if "prompt" in body
                      else llama2_chat_prompt(body["messages"]))
            check(usage["prompt_tokens"] == len(tok.encode(prompt, add_bos=True)),
                  f"{kind}: prompt_tokens {usage['prompt_tokens']}")
            check(usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"],
                  f"{kind}: total_tokens")
            completion_tokens += usage["completion_tokens"]
        ids = first["choices"][0]["logprobs"]["tokens"]
        check(again["choices"][0]["logprobs"]["tokens"] == ids
              and again["choices"][0]["text"] == first["choices"][0]["text"],
              "the same greedy prompt gave two different completions")
        check("".join(deltas) == incremental_text(tok, ids),
              "streamed deltas do not concatenate to the completion's text")
        check(final["usage"]["completion_tokens"] == len(ids), "streamed usage")

        status, data = http_request(addr, "GET", "/health")
        check(status == 200 and json.loads(data) == {"status": "ok"}, f"/health {status}")
        status, metrics = http_request(addr, "GET", "/metrics")
        metrics = metrics.decode()
        n_req = [float(ln.split()[1]) for ln in metrics.splitlines()
                 if ln.startswith("dlti_requests ")]
        check(status == 200 and n_req and n_req[0] >= 12, f"/metrics dlti_requests {n_req}")
        check("# TYPE dlti_request_ttft_seconds histogram" in metrics
              and "dlti_request_ttft_seconds_count" in metrics, "no TTFT histogram")
        stats = json.loads(http_request(addr, "GET", "/stats")[1])
    finally:
        httpd.shutdown()
        aeng.shutdown()
        httpd.server_close()
        del engine.step

    expected = cfg.num_layers * decode_steps
    log(f"{tag} 12 concurrent requests in {wall:.2f} s, then 3 one at a time; decode "
        f"steps {decode_steps}; K4q launches {launches_int8} (expected {cfg.num_layers} "
        f"layers x {decode_steps} steps = {expected}), float K4 launches {launches_float}")
    check(launches_int8 == expected, f"K4q launches {launches_int8} != {expected}")
    check(launches_float == 0, f"the float K4 ran {launches_float} times on an int8 pool")
    check(flash == 0, f"serving launched the flash kernels {flash} times")
    ttft, tpot = stats["request_ttft_seconds"], stats["request_tpot_seconds"]
    perf = {"requests": 12, "wall_s": wall, "requests_per_s": 12 / wall,
            "completion_tokens": completion_tokens,
            "output_tok_s": completion_tokens / wall,
            "ttft_p50_s": ttft["p50"], "ttft_p99_s": ttft["p99"],
            "tpot_mean_s": tpot["mean"], "decode_steps": decode_steps,
            "engine_steps": len(step_s), "step_ms_p50": 1e3 * sorted(step_s)[len(step_s) // 2],
            "step_ms_mean": 1e3 * sum(step_s) / len(step_s),
            "kv_pool_bytes": pool_bytes, "kv_scale_bytes": scale_bytes,
            "max_seqs": args.max_seqs, "steps_per_sync": args.steps_per_sync,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"{tag} {perf['requests_per_s']:.3f} requests/s, {perf['output_tok_s']:.1f} "
        f"output tok/s ({completion_tokens} tokens); TTFT p50 {ttft['p50']:.4f} s, p99 "
        f"{ttft['p99']:.4f} s (/stats, bucket-interpolated); mean TPOT "
        f"{1e3 * tpot['mean']:.2f} ms; engine step on the stepper thread p50 "
        f"{perf['step_ms_p50']:.2f} ms, mean {perf['step_ms_mean']:.2f} ms over "
        f"{len(step_s)} steps")
    log(f"{tag} perf " + json.dumps(perf))
    return engine, launches_int8, perf


def serve_subprocess(cmd, tag, drive=None):
    """Run a serve CLI command as a subprocess on the card: it must print its
    port, answer /health and one greedy completion (or what ``drive(addr)``
    sends, whose result is returned beside the output lines), and exit 0 on
    SIGTERM."""
    import os
    import queue
    import signal
    import threading

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                              daemon=True)
    reader.start()
    seen, port = [], None
    try:
        deadline = time.monotonic() + 240
        while port is None and time.monotonic() < deadline:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                check(proc.poll() is None, f"{tag} the serve CLI exited early:\n"
                      + "".join(seen))
                continue
            seen.append(line)
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        check(port is not None, f"{tag} the serve CLI never printed its port:\n"
              + "".join(seen))
        check(any("on cuda" in ln for ln in seen), f"{tag} the serve CLI did not run on "
              "the card")
        addr = ("127.0.0.1", port)
        status, data = http_request(addr, "GET", "/health", timeout=60)
        check(status == 200, f"{tag} CLI /health answered {status}")
        if drive is not None:
            out = drive(addr)
        else:
            out = post_json(addr, "/v1/completions", {"prompt": "hello", "max_tokens": 8,
                                                      "temperature": 0.0})
            check(out["usage"]["completion_tokens"] > 0, f"{tag} CLI completion {out}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        check(rc == 0, f"{tag} the serve CLI exited {rc} on SIGTERM:\n"
              + "".join(seen[-20:]))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=10)
        proc.stdout.close()
    log(f"{tag} {' '.join(cmd[1:])}: port {port}, /health 200, "
        + ("driven" if drive is not None else f"one completion 200 ({out['usage']})")
        + f", exit 0 on SIGTERM; {time.perf_counter() - t0:.1f} s")
    return (seen, out) if drive is not None else seen


class Beside:
    """``fn(*args)`` in a thread beside the phases that follow it;
    :meth:`join` waits for it and returns its wall clock in seconds, or
    raises what it raised."""

    def __init__(self, fn, *args):
        import threading

        self.error = None
        self.seconds = None
        self.thread = threading.Thread(target=self._run, args=(fn, args), daemon=True)
        self.thread.start()

    def _run(self, fn, args):
        t0 = time.perf_counter()
        try:
            fn(*args)
        except BaseException as e:  # re-raised by join
            self.error = e
        self.seconds = round(time.perf_counter() - t0, 1)

    def join(self, quiet: bool = False) -> float:
        self.thread.join()
        if self.error is not None and not quiet:
            raise self.error
        return self.seconds


def run_cli(cmd, tag, timeout=600):
    """A CLI as a subprocess that must exit 0; returns its stdout."""
    import os

    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=timeout)
    check(proc.returncode == 0, f"{tag} {' '.join(cmd[1:])} exited {proc.returncode}:\n"
          + proc.stdout[-2000:] + proc.stderr[-3000:])
    log(f"{tag} {' '.join(cmd[1:])}: exit 0 in {time.perf_counter() - t0:.1f} s")
    return proc.stdout


def phase_cli_round_trip(torch):
    """The three entry points as subprocesses on the card, on llama_300m (d
    64, which K1-K3 take): ``cli.train`` (2 microbatches a step)
    checkpoints steps 2 and 4 and exports; ``cli.export`` of the checkpoints prints the export's digest;
    ``cli.serve --model-dir`` serves the export on an int8 pool, 4 decode
    steps a sync."""
    import shutil
    import tempfile

    from dlti_tpu_torch.checkpoint import list_checkpoint_steps, manifest_digest

    root = Path(tempfile.mkdtemp(prefix="dlti-cli-"))
    data, ck, ex, ex2 = (root / n for n in ("data.jsonl", "ckpt", "export", "export2"))
    data.write_text("".join(json.dumps({"text": t}) + "\n" for t in training_texts()))
    py = [sys.executable, "-m"]
    try:
        out = run_cli(py + ["dlti_tpu_torch.cli.train", "--model", "llama_300m",
                            "--tokenizer", "byte", "--dataset-path", str(data),
                            "--max-steps", "4", "--save-steps", "2",
                            # 2 microbatches a step (the CLI's 16 until phase 20
                            # needed the room): the checkpoints are the check.
                            "--gradient-accumulation-steps", "2",
                            "--output-dir", str(ck), "--export-dir", str(ex)], "[cli]")
        check(list_checkpoint_steps(ck) == [2, 4],
              f"cli.train left checkpoints {list_checkpoint_steps(ck)}")
        digest = manifest_digest(ex / "model")
        check(digest is not None and f"manifest sha256: {digest}" in out,
              f"cli.train's export digest {digest} is not in its output")
        out = run_cli(py + ["dlti_tpu_torch.cli.export", "--checkpoint-dir", str(ck),
                            "--model", "llama_300m", "--out", str(ex2)], "[cli]")
        check(out.strip().splitlines()[-1] == f"manifest sha256: {digest}",
              f"cli.export printed {out.strip().splitlines()[-1:]}, the export is {digest}")
        seen = serve_subprocess(py + ["dlti_tpu_torch.cli.serve", "--model-dir", str(ex),
                                      "--tokenizer", "byte", "--kv-cache-dtype", "int8",
                                      "--steps-per-sync", "4", "--host", "127.0.0.1",
                                      "--port", "0"], "[cli]")
        check(any("loaded export" in ln for ln in seen), "cli.serve did not load the export")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def h2d_pinned_gb_s(torch, nbytes=1 << 30, reps=3) -> float:
    """Host-to-card copy rate from pinned memory (CUDA events, best of
    ``reps`` 1 GiB copies)."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    best = float("inf")
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return nbytes / best / 1e9


# Phase 16's strategies: (name, preset, offload_optimizer, offload_params).
# Phase 16's steps a strategy: phase 7's first 3, the last one timed (8
# until phase 20 needed the room, 4 until phase 23 did).
ZERO_STEPS = 3
# "zero3_tensor" is phase 23 (c): ZeRO-3 on the tensor-parallel path (a
# tensor group of one), its step one CUDA graph.
ZERO_RUNS = (("baseline", "baseline", False, False), ("zero1", "zero1", False, False),
             ("zero2", "zero2", False, False), ("zero3", "zero3", False, False),
             ("zero3_offload", "zero3", True, True), ("zero3_tensor", "zero3", False, False))


def phase_zero(torch, reference, card):
    """Phase 16, ZeRO on one card: phase 7's configuration (llama2_7b LoRA
    r=16 at full width and depth, seq 512, micro-batch 4 x accum 2, remat,
    the step as a CUDA graph) for ``ZERO_STEPS`` steps under each of ``ZERO_RUNS`` in a
    NCCL process group of one, joined as the launcher's env describes it
    (``launcher.maybe_initialize_from_env``). Every run's losses and grad
    norms must be bit-equal to the group's baseline run (at a world of 1
    every collective is a copy), K1-K3 counted as in phase 7 (counters set
    to 0 before each run and read after it), and under offload every frozen
    leaf and every moment a pinned host tensor. The baseline in the group
    is also held against phase 7's run without a group. Prints each run's
    step ms, tokens/s, peak memory and launches beside the card."""
    import os
    import shutil
    import socket
    import tempfile

    import torch.distributed as dist

    from dlti_tpu_torch import launcher
    from dlti_tpu_torch.analysis import compare
    from dlti_tpu_torch.config import CheckpointConfig, ParallelConfig, ZeROStage, preset
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.parallel.mesh import build_mesh
    from dlti_tpu_torch.training import Trainer

    t_phase = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = launcher.worker_env(f"127.0.0.1:{port}", 1, 0, base={}, local_rank=0)
    os.environ.update(env)
    csv_dir = Path(tempfile.mkdtemp(prefix="dlti-zero-csv-"))
    metrics_csv = csv_dir / "training_metrics.csv"
    try:
        check(launcher.maybe_initialize_from_env("cuda"), "no process group was formed")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"group {dist.get_backend()} of {dist.get_world_size()}")
        base = train_config(CheckpointConfig(save_strategy="no"), max_steps=ZERO_STEPS)
        mcfg, accum = base.model, base.train.grad_accum_steps
        dataset = make_batches(training_texts(), ByteTokenizer(), seq_len=512,
                               micro_batch_size=4, grad_accum_steps=accum)
        runs = {}
        for name, preset_name, off_opt, off_params in ZERO_RUNS:
            stage = ZeROStage(preset(preset_name).parallel.zero_stage)
            cfg = dataclasses.replace(base, parallel=ParallelConfig(
                zero_stage=stage, offload_optimizer=off_opt, offload_params=off_params),
                experiment_name=name, train=dataclasses.replace(
                    base.train, metrics_csv=str(metrics_csv)))
            mesh = None
            if name == "zero3_tensor":
                mesh = build_mesh(cfg.parallel, torch.device("cuda", torch.cuda.current_device()),
                                  True, tensor_group=True)
                check(mesh.tensor_parallel and mesh.fsdp_extent == 1,
                      "[zero] zero3_tensor: no tensor group of one")
            trainer = Trainer(cfg, params=init_params(mcfg, seed=0, device="cuda",
                                                      lora=cfg.lora), device="cuda", mesh=mesh)
            state = trainer.init_state()
            if off_params or off_opt:
                frozen = [p for n, p in state.model.named_parameters()
                          if not n.endswith(("lora_a", "lora_b"))]
                # What a step streams: each block's base twice a microbatch
                # (forward and remat recompute), the rest once.
                in_blocks = sum(p.numel() * p.element_size()
                                for n, p in state.model.named_parameters()
                                if n.startswith("model.layers.")
                                and not n.endswith(("lora_a", "lora_b")))
                outside = sum(p.numel() * p.element_size() for p in frozen) - in_blocks
                streamed = accum * (2 * in_blocks + outside)
                moments = [*state.opt_state.mu.values(), *state.opt_state.nu.values()]
                host = [t.device.type == "cpu" and t.is_pinned() for t in frozen + moments]
                log(f"[zero] {name}: {len(frozen)} frozen leaves "
                    f"({sum(t.numel() * t.element_size() for t in frozen) / 1e9:.2f} GB) and "
                    f"{len(moments)} moments in pinned host memory: {all(host)}")
                check(all(host), f"{name}: {host.count(False)} offloaded leaves are not "
                      "pinned host tensors")
            free_memory(torch)
            tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
            state, record = trainer.train(dataset=dataset, state=state)
            torch.cuda.synchronize()
            launches = flash_counts(tfa)
            want = flash_expected(mcfg.num_layers, accum, ZERO_STEPS + record.captures)
            perf = train_perf(record, mcfg)
            perf["launches"] = launches
            perf["strategy"], perf["world"] = record.strategy, record.world
            runs[name] = perf
            log(f"[zero] {name} ({record.strategy}, world {record.world}, offload optimizer "
                f"{off_opt}, params {off_params}): step {perf['step_ms']:.1f} ms, "
                f"{perf['tokens_per_s']:.1f} tokens/s, peak {perf['peak_memory_gb']:.2f} GB, "
                f"{record.captures} capture, launches {launches} (expected {want})")
            if off_params:
                rate = h2d_pinned_gb_s(torch)
                perf["streamed_gb_a_step"], perf["h2d_pinned_gb_s"] = streamed / 1e9, rate
                perf["copy_bound_ms"] = streamed / 1e9 / rate * 1e3
                log(f"[zero] {name}: the base streamed {streamed / 1e9:.2f} GB a step; pinned "
                    f"host-to-card copies {rate:.1f} GB/s, so the copies alone take "
                    f"{perf['copy_bound_ms']:.1f} ms a step")
            check(record.captures == 1, f"{name}: {record.captures} captures")
            check(launches == want, f"{name}: flash launches {launches} != {want}")
            check(record.steps == ZERO_STEPS and record.skipped_updates == 0,
                  f"{name}: {record.steps} steps, {record.skipped_updates} skipped")
            check(record.strategy == preset_name.split("_")[0], record.strategy)
            del state, trainer
            free_memory(torch)
        ref = runs["baseline"]
        for name, perf in runs.items():
            same = perf["losses"] == ref["losses"] and perf["grad_norms"] == ref["grad_norms"]
            log(f"[zero] {name}: losses and grad norms bit-equal to the baseline in the "
                f"group: {same}")
            check(same, f"{name} losses {perf['losses']} / grad norms {perf['grad_norms']} "
                  f"differ from the baseline's {ref['losses']} / {ref['grad_norms']}")
        no_group = (ref["losses"] == reference["losses"][:ZERO_STEPS]
                    and ref["grad_norms"] == reference["grad_norms"][:ZERO_STEPS])
        log(f"[zero] the baseline in the group against phase 7's without one: bit-equal "
            f"{no_group}")
        check(no_group, "the baseline in a group of one differs from phase 7's run")
        # The reference's comparison over the five rows the runs appended.
        rows = compare(str(metrics_csv))
        check([r["experiment"] for r in rows] == [r[0] for r in ZERO_RUNS],
              f"the metrics CSV holds {[r['experiment'] for r in rows]}")
        check(all(r["peak_memory_source"] == "device" and r["num_gpus"] == 1
                  for r in rows), "the CSV rows are not the card's")
        for r in rows:
            runs[r["experiment"]]["csv"] = {k: r[k] for k in (
                "training_time_hours", "samples_per_second", "peak_memory_gb",
                "final_loss", "speedup", "tokens_per_second_per_chip", "mfu_percent")}
        log(f"[zero] metrics CSV: {len(rows)} rows compared ({metrics_csv.name})")
        log(f"[zero] card {card}; phase {time.perf_counter() - t_phase:.1f} s")
        return runs
    finally:
        shutil.rmtree(csv_dir, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            if k.startswith("DLTI_"):
                os.environ.pop(k, None)


# ----------------------------------------------------------------------
# Quickstart slice 11: prepare -> int8-base train -> CSV -> compare ->
# export -> serve int8 weights, and the experiment matrix
# ----------------------------------------------------------------------

# The README Quickstart's 7B recipe at the CLI's batch defaults (micro-batch
# 1 x accum 16, seq 512), cut from 300 steps to two windows of 10, and to
# two windows of 2 to make room for phase 20.
QUICKSTART_STEPS = 4
QUICKSTART_SYNC = 2
QUICKSTART_ACCUM = 16
# The engines' peak readings: 28 greedy requests of this many tokens (64
# until phase 20 needed the room).
ENGINE_PEAK_TOKENS = 16
# The matrix's runs, baseline and zero3: one step of 2 microbatches each
# (the CLI's 16 and 2 steps until phase 20 needed the room; its two runs
# took 119.6 s at 16).
MATRIX_ACCUM = 2
# The prepared corpus: 2000 synthetic QA pairs, 125 steps an epoch at 16
# rows a step, so 20 steps stay in the first epoch.
QUICKSTART_PAIRS = 2000
# The int8 base must free at least this much of the bf16 base's peak (the
# base is 13.5 GB in bf16 and ~6.7 GB in int8), in training and serving.
INT8_SAVING_GB = 5.0
# Disk phase 17 needs: the 13.5 GB merged export, the token store and the
# CSVs, with room to spare.
QUICKSTART_DISK_GB = 20.0


def run_train_cli(cmd, tag):
    """A ``cli.train`` subprocess that must exit 0; its last stdout line,
    the JSON summary."""
    out = run_cli(cmd, tag, timeout=900)
    return json.loads(out.strip().splitlines()[-1]), out


def quickstart_run_perf(summary, log_path) -> dict:
    """One ``cli.train`` run's readings from its JSON summary and its step
    log; launches a step over the steps and the capture's eager warm-up
    step, which launches once more."""
    lines = [json.loads(ln) for ln in Path(log_path).read_text().splitlines()]
    steps = sum(r["type"] == "step" for r in lines)
    launches = summary["flash_launches"]
    return {"step_ms": 1e3 * summary["step_time_s"], "tokens_per_s": summary["tokens_per_second"],
            "mfu_percent": summary["mfu_percent"], "peak_memory_gb": summary["peak_memory_gb"],
            "windows": summary["windows"], "captures": summary["captures"],
            "final_loss": summary["final_loss"], "steps": steps, "launches": launches,
            "launches_per_step": {k: v / (steps + summary["captures"])
                                  for k, v in launches.items()},
            "step_log_lines": len(lines),
            "host_syncs_per_step": summary["host_syncs_per_step"]}


def engine_peak(torch, export_dir, quantization):
    """The documented serving configuration's engine from the export, built
    by the serve CLI's builder with ``--quantization``, warmed up, then 28
    greedy requests of ``ENGINE_PEAK_TOKENS`` through ``generate``: peak device memory
    (GB) over build and serving, weight bytes and output tokens/s."""
    from dlti_tpu_torch.cli import serve as cli
    from dlti_tpu_torch.serving import SamplingParams

    free_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    args = cli.parse_args(["--model-dir", str(export_dir), "--tokenizer", "byte",
                           "--kv-cache-dtype", "int8", "--port", "0", "--quantization",
                           quantization] + DOCUMENTED_FLAGS[:4])
    engine, tok, _ = cli.build(args)
    engine.warmup_decode_ladder()
    weights = sum(p.numel() * p.element_size() for p in engine.executor.model.parameters())
    prompts = [tok.encode(f"request {i}: " + "serve the model " * (1 + i % 9), add_bos=True)
               for i in range(28)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate(prompts, SamplingParams(temperature=0.0,
                                                  max_tokens=ENGINE_PEAK_TOKENS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(len(r.output_token_ids) for r in out)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    del engine, out
    free_memory(torch)
    return {"peak_memory_gb": peak, "weights_gb": weights / 1e9, "tokens": tokens,
            "output_tok_s": tokens / wall, "wall_s": wall}


def dequant_time(torch, flush):
    """``models.quantization.dequantize`` of one llama2_7b block's seven
    kernels (int8 -> bf16, the expansion each use of an int8 weight runs),
    timed as the kernels are (``time_ms``): ms a block, ms for the 32 blocks
    and the head (one forward's expansions), and the rate at 3 bytes an
    element (1 read, 2 written)."""
    from dlti_tpu_torch.models.quantization import dequantize, quantize_int8

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(4096, 4096)] * 4 + [(4096, 11008)] * 2 + [(11008, 4096)]
    pairs = [quantize_int8(torch.randn(s, generator=gen, device="cuda") * 0.02)
             for s in shapes]
    elems = sum(q.numel() for q, _ in pairs)
    block_ms = time_ms(torch, lambda: [dequantize(q, s, torch.bfloat16) for q, s in pairs],
                       flush=flush)
    head_elems = 4096 * 32000
    model_ms = block_ms * (MODEL_LAYERS + head_elems / elems)
    out = {"block_ms": block_ms, "model_ms": model_ms,
           "gb_s": 3 * elems / block_ms / 1e6,
           "model_gb": 3 * (MODEL_LAYERS * elems + head_elems) / 1e9}
    log(f"[quickstart] dequantize one block's kernels {block_ms:.3f} ms, a forward's "
        f"expansions {model_ms:.1f} ms ({out['model_gb']:.1f} GB at 3 bytes an element, "
        f"{out['gb_s']:.0f} GB/s against the card's 3350)")
    del pairs
    return out


def phase_quickstart(torch, card, flush):
    """Phase 17, the README Quickstart through the port's CLIs, as a user
    types them, each a subprocess on the card: prepare a token store from
    2000 synthetic pairs; train llama2_7b (full width and depth) with LoRA
    r=16 on an int8 frozen base without remat, 2 steps a sync, 4 steps,
    appending to a metrics CSV and a step log and exporting; the same run
    on the bf16 base as the yardstick; compare the CSV; serve the export
    with the documented flags (int8 weights and KV, 28 slots, k 64) to 12
    concurrent requests over HTTP; then the experiment matrix (baseline
    and zero3 at one card, 1 step of 2 microbatches each, their final
    losses equal) into its own CSV, compared. K1-K3 must run
    32 x 16 = 512 times a step each (no remat: nothing recomputed), the
    int8 run must peak ``INT8_SAVING_GB`` below the bf16 run, and the
    int8-weight engine below the bf16-weight engine by as much."""
    import shutil
    import tempfile

    from dlti_tpu_torch.analysis import compare

    t_phase = time.perf_counter()
    free_memory(torch)
    root = Path(tempfile.mkdtemp(prefix="dlti-quickstart-"))
    data, store, ex = root / "data", root / "store", root / "export"
    csv_path, csv_matrix = root / "training_metrics.csv", root / "matrix.csv"
    py = [sys.executable, "-m"]
    perf = {"card": card, "dequant": dequant_time(torch, flush)}
    try:
        free0 = shutil.disk_usage(root).free / 1e9
        check(free0 >= QUICKSTART_DISK_GB, f"phase 17 needs {QUICKSTART_DISK_GB} GB free "
              f"under {root}, the disk has {free0:.1f} GB")
        # 1. Data prep.
        run_cli(py + ["dlti_tpu_torch.cli.prepare_dataset", "--synthetic",
                      str(QUICKSTART_PAIRS), "--output-dir", str(data),
                      "--write-token-store", str(store)], "[quickstart]")
        meta = json.loads((store / "meta.json").read_text())
        check(meta["n_rows"] == QUICKSTART_PAIRS and meta["seq_len"] == 512
              and (data / "data.jsonl").is_file(), f"token store meta {meta}")

        # 2-3. The 7B recipe on the int8 base, then on the bf16 base.
        def train_cmd(tag, int8):
            cmd = py + ["dlti_tpu_torch.cli.train", "--model", "llama2_7b", "--preset",
                        "baseline", "--dataset-path", str(store), "--tokenizer", "byte",
                        "--lora-r", "16", "--remat-policy", "none",
                        "--steps-per-sync", str(QUICKSTART_SYNC),
                        "--max-steps", str(QUICKSTART_STEPS), "--metrics-csv", str(csv_path),
                        "--step-log", str(root / f"{tag}.jsonl"),
                        "--output-dir", str(root / f"ck_{tag}")]
            if int8:
                cmd += ["--quantize-base", "int8", "--export-dir", str(ex)]
            return cmd

        runs = {}
        for tag, int8 in (("int8", True), ("bf16", False)):
            summary, out = run_train_cli(train_cmd(tag, int8), f"[quickstart {tag}]")
            run = quickstart_run_perf(summary, root / f"{tag}.jsonl")
            runs[tag] = run
            want = QUICKSTART_ACCUM * MODEL_LAYERS
            log(f"[quickstart {tag}] {QUICKSTART_STEPS} steps in {run['windows']} windows: "
                f"step {run['step_ms']:.1f} ms, {run['tokens_per_s']:.1f} tokens/s, MFU "
                f"{run['mfu_percent']:.2f}%, peak {run['peak_memory_gb']:.2f} GB, K1/K2/K3 "
                f"launches a step {run['launches_per_step']} (expected {want} each, "
                f"{run['captures']} capture), step log {run['step_log_lines']} lines, "
                f"final loss {run['final_loss']:.4f}")
            check(run["steps"] == QUICKSTART_STEPS and run["windows"] == 2
                  and run["captures"] == 1, f"{tag}: {run['steps']} steps, "
                  f"{run['windows']} windows, {run['captures']} captures")
            check(all(v == want for v in run["launches_per_step"].values()),
                  f"{tag}: flash launches a step {run['launches_per_step']} != {want}")
            check(run["step_log_lines"] == QUICKSTART_STEPS + 2,
                  f"{tag}: the step log has {run['step_log_lines']} lines")
            check(math.isfinite(run["final_loss"]), f"{tag}: final loss {run['final_loss']}")
            if int8:
                check("manifest sha256:" in out and (ex / "model").is_dir(),
                      "the int8 run wrote no export")
        saving = runs["bf16"]["peak_memory_gb"] - runs["int8"]["peak_memory_gb"]
        log(f"[quickstart] int8 base against bf16 base: step x"
            f"{runs['int8']['step_ms'] / runs['bf16']['step_ms']:.3f}, peak "
            f"{runs['int8']['peak_memory_gb']:.2f} against {runs['bf16']['peak_memory_gb']:.2f} "
            f"GB ({saving:.2f} GB less)")
        check(saving >= INT8_SAVING_GB, f"the int8 base saved {saving:.2f} GB of peak")
        perf["train"] = runs

        # 4. Compare the two rows.
        out = run_cli(py + ["dlti_tpu_torch.cli.compare_training", "--csv", str(csv_path),
                            "--no-plots"], "[quickstart]")
        log(out.rstrip())
        rows = compare(str(csv_path))
        check(len(rows) == 2 and all(r["peak_memory_source"] == "device" for r in rows),
              f"the metrics CSV holds {len(rows)} rows")
        perf["csv"] = [{k: r[k] for k in ("experiment", "training_time_hours",
                                          "samples_per_second", "peak_memory_gb",
                                          "final_loss", "tokens_per_second_per_chip",
                                          "mfu_percent", "speedup")} for r in rows]

        # 5. Serve the export with the documented flags, 12 requests over HTTP.
        def drive(addr):
            import threading

            reqs = server_requests()
            results, errors = [None] * len(reqs), []

            def one(i, kind, path, body):
                try:
                    results[i] = (post_stream(addr, path, body) if kind == "stream"
                                  else post_json(addr, path, body))
                except Exception as e:  # reported, and fails the phase below
                    errors.append(f"{kind} {i}: {type(e).__name__}: {e}")

            t0 = time.perf_counter()
            threads = [threading.Thread(target=one, args=(i, *r))
                       for i, r in enumerate(reqs)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            check(not errors and all(r is not None for r in results),
                  f"quickstart server requests failed: {errors}")
            stats = json.loads(http_request(addr, "GET", "/stats")[1])
            # Quickstart step 5 (STEP5_FLAGS), as a subprocess.
            step5 = run_loadgen(addr, STEP5_FLAGS, "[quickstart loadgen]")
            check(step5["num_requests"] == STEP5_REQUESTS,
                  f"step 5 sent {step5['num_requests']}")
            return {"wall_s": wall, "requests": len(reqs),
                    "ttft_p50_s": stats["request_ttft_seconds"]["p50"],
                    "ttft_p99_s": stats["request_ttft_seconds"]["p99"],
                    "tpot_mean_s": stats["request_tpot_seconds"]["mean"],
                    "loadgen": loadgen_summary(step5)}

        seen, served = serve_subprocess(
            py + ["dlti_tpu_torch.cli.serve", "--model-dir", str(ex), "--tokenizer", "byte",
                  "--kv-cache-dtype", "int8", "--host", "127.0.0.1", "--port", "0"]
            + DOCUMENTED_FLAGS, "[quickstart serve]", drive=drive)
        check(any("quantization int8" in ln for ln in seen), "the server's weights are not int8")
        log(f"[quickstart serve] {served['requests']} concurrent requests in "
            f"{served['wall_s']:.2f} s; TTFT p50 {served['ttft_p50_s']:.4f} s, p99 "
            f"{served['ttft_p99_s']:.4f} s; mean TPOT {1e3 * served['tpot_mean_s']:.2f} ms "
            "(/stats, bucket-interpolated)")
        perf["serve"] = served
        engines = {q: engine_peak(torch, ex, q) for q in ("int8", "none")}
        saving = engines["none"]["peak_memory_gb"] - engines["int8"]["peak_memory_gb"]
        log(f"[quickstart serve] engine from the export, documented flags, 28 greedy "
            f"requests of {ENGINE_PEAK_TOKENS} tokens: int8 weights {engines['int8']['weights_gb']:.2f} GB, "
            f"peak {engines['int8']['peak_memory_gb']:.2f} GB, "
            f"{engines['int8']['output_tok_s']:.1f} tok/s; bf16 weights "
            f"{engines['none']['weights_gb']:.2f} GB, peak "
            f"{engines['none']['peak_memory_gb']:.2f} GB, "
            f"{engines['none']['output_tok_s']:.1f} tok/s ({saving:.2f} GB less)")
        check(saving >= INT8_SAVING_GB, f"int8 weights saved {saving:.2f} GB of peak")
        perf["engines"] = engines

        # 6. The experiment matrix, then its comparison.
        out = run_cli(py + ["dlti_tpu_torch.cli.run_experiments", "--model", "llama2_7b",
                            "--strategies", "baseline,zero3", "--device-counts", "1",
                            "--max-steps", "1", "--gradient-accumulation-steps",
                            str(MATRIX_ACCUM), "--dataset-path", str(store),
                            "--tokenizer", "byte", "--metrics-csv", str(csv_matrix),
                            "--output-root", str(root / "matrix_ck"),
                            "--log-dir", str(root / "matrix_logs"), "--no-plots"],
                      "[quickstart matrix]", timeout=900)
        rows = compare(str(csv_matrix))
        check([r["experiment"] for r in rows] == ["baseline", "zero3_1dev"],
              f"the matrix CSV holds {[r['experiment'] for r in rows]}")
        check([r["strategy"] for r in rows] == ["baseline", "zero3"],
              f"the matrix ran {[r['strategy'] for r in rows]}")
        losses = [float(r["final_loss"]) for r in rows]
        # At a world of 1 ZeRO-3 shards nothing: phase 16's bit-equality.
        check(all(math.isfinite(x) for x in losses) and losses[0] == losses[1],
              f"the matrix's final losses {losses}")
        perf["matrix"] = [{k: r[k] for k in ("experiment", "strategy", "training_time_hours",
                                             "peak_memory_gb", "final_loss",
                                             "tokens_per_second_per_chip", "speedup")}
                          for r in rows]
        log(f"[quickstart matrix] {perf['matrix']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"[quickstart] card {card}; phase {perf['phase_s']:.1f} s")
    return perf


# ----------------------------------------------------------------------
# Slice 12: the load test and the engine features it measures
# ----------------------------------------------------------------------

# README Quickstart step 5's flags at a quarter of its requests and half its
# concurrency (112 and 56; cut to 56 for phase 19, to 28 for phase 20): one
# wave of the server's 28 slots.
STEP5_REQUESTS = 28
STEP5_FLAGS = ["--num-requests", str(STEP5_REQUESTS), "--concurrency", "28",
               "--max-tokens", "256"]
LOADGEN_KEYS = ("num_requests", "num_ok", "num_shed", "requests_per_s",
                "output_tokens_per_s", "ttft_p50_s", "ttft_p99_s", "tpot_mean_ms",
                "latency_p50_s", "latency_p99_s", "cache_hit_rate", "num_warm",
                "warm_ttft_p50_s", "cold_ttft_p50_s", "spec", "interference", "engine")


def loadgen_summary(report) -> dict:
    return {k: report[k] for k in LOADGEN_KEYS}


def run_loadgen(addr, flags, tag, timeout=900):
    """``python -m dlti_tpu_torch.cli.benchmark_serving`` as a subprocess
    against ``addr``: every request must come back ok (none failed, none
    shed). Returns its ``--json-out`` report, with ``engine``: the server's
    own mean TTFT and TPOT over this run (its ``/stats`` histograms' sum and
    count, before and after). The client stamps TTFT at the first streamed
    text, and a random model's tokens past the byte tokenizer's 259 render
    as no text, so the client's TTFT and TPOT cover only the requests that
    showed some (``timed`` of them); the engine's cover every request."""
    import os
    import tempfile

    def hist(stats, name):
        return stats[name]["sum"], stats[name]["count"]

    before = json.loads(http_request(addr, "GET", "/stats")[1])
    fd, out = tempfile.mkstemp(prefix="dlti-loadgen-", suffix=".json")
    os.close(fd)
    try:
        run_cli([sys.executable, "-m", "dlti_tpu_torch.cli.benchmark_serving",
                 "--host", addr[0], "--port", str(addr[1]), *flags, "--json-out", out],
                tag, timeout=timeout)
        report = json.loads(Path(out).read_text())
    finally:
        Path(out).unlink(missing_ok=True)
    after = json.loads(http_request(addr, "GET", "/stats")[1])
    check(report["num_ok"] == report["num_requests"] > 0 and not report["errors"],
          f"{tag} {report['num_requests'] - report['num_ok']} of "
          f"{report['num_requests']} requests failed: {report['errors'][:5]}")
    engine = {}
    for key, name in (("ttft_mean_s", "request_ttft_seconds"),
                      ("tpot_mean_s", "request_tpot_seconds")):
        (s0, n0), (s1, n1) = hist(before, name), hist(after, name)
        engine[key] = (s1 - s0) / (n1 - n0) if n1 > n0 else None
    engine["requests"] = after["requests"] - before["requests"]
    engine["generated_tokens"] = after["generated_tokens"] - before["generated_tokens"]
    report["engine"] = engine
    fmt = lambda v, scale=1.0: "n/a" if v is None else f"{scale * v:.4f}"  # noqa: E731
    log(f"{tag} {' '.join(flags)}: {report['num_ok']} ok, 0 failed; "
        f"{report['requests_per_s']:.3f} requests/s, {report['output_tokens_per_s']:.1f} "
        f"output tok/s; client (requests with visible text) TTFT p50 "
        f"{report['ttft_p50_s']:.4f} s p99 {report['ttft_p99_s']:.4f} s, mean TPOT "
        f"{report['tpot_mean_ms']:.2f} ms; engine mean TTFT {fmt(engine['ttft_mean_s'])} s, "
        f"mean TPOT {fmt(engine['tpot_mean_s'], 1e3)} ms over {engine['requests']} requests")
    return report


# Phase 18's equality engines: llama2_7b at full width, cut to 8 layers, in
# float32 (TF32 off), from init_params(seed=0).
FEATURE_LAYERS = 8
FEATURE_SIZES = {
    "ec": dict(max_seqs=8, block_size=16, num_blocks=512, max_model_len=1280,
               cache_dtype="float32", eos_token_id=-1),
    "long": [600, 777, 1000],        # prompts chunked prefill cuts
    "short": [24, 90, 200, 350, 480],
    "chunk": 256,                    # max_prefill_tokens_per_step
    "prefix": 410,                   # the shared prefix, as in the 7B A/B
    "suffix": [12, 40, 75, 130, 16, 60],
    "evict_blocks": 100,             # a pool that evicts the prefix
    "host_blocks": 256,
    "filler": [700, 650, 600],
    "max_tokens": 24,
    "spec_k": 4, "spec_sync": 8, "spec_tokens": 96,
    "spec_plain": [50, 300],         # prompts with no built-in repeats
}


def prompts_of(rng, lengths, vocab):
    return [rng.integers(3, vocab, n).tolist() for n in lengths]


def run_engine(engine, waves, max_tokens):
    """Submit each wave of greedy prompts and drain it; returns every
    request in order."""
    from dlti_tpu_torch.serving.sampling import SamplingParams

    reqs = []
    for wave in waves:
        reqs += [engine.submit(p, SamplingParams(temperature=0.0, max_tokens=max_tokens))
                 for p in wave]
        while engine.has_work:
            engine.step()
    return reqs


def feature_pairs(torch, cfg, params, device, sizes):
    """Phase 18's first half on any device: each engine feature against the
    engine without it, greedy tokens identical in every pair. Returns the
    readings (prefill batches, cached and restored tokens, spec counters,
    spec round and plain step ms, the spec graphs' pool). On the card also
    K4 counted once per layer per plain decode step (the decode graph's
    credit), the spec window's dispatch under ``set_sync_debug_mode
    ("error")`` and the spec graphs against spec rounds run eagerly."""
    import numpy as np

    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.serving.engine import EngineConfig, EngineExecutor, InferenceEngine
    from dlti_tpu_torch.serving.sampling import SamplingParams

    cuda = torch.device(device).type == "cuda"
    rng = np.random.default_rng(18)
    vocab = cfg.vocab_size
    out = {}

    def engine(graphs=True, **over):
        ec = EngineConfig(**{**sizes["ec"], **over})
        ex = EngineExecutor(cfg, params, ec, device=device, cuda_graphs=graphs)
        return InferenceEngine(cfg, params, ec, device=device, executor=ex)

    def tokens(reqs):
        return [r.output_token_ids for r in reqs]

    def ttft_ms(reqs):
        return 1e3 * float(np.mean([r.first_token_time - r.arrival_time for r in reqs]))

    def pair(name, a, b):
        check(tokens(a) == tokens(b), f"[features] {name}: greedy tokens differ")

    # Chunked and ragged prefill: one wave of long and short prompts.
    wave = prompts_of(rng, sizes["long"] + sizes["short"], vocab)
    runs = {}
    for name, over in (("plain", {}),
                       ("chunked", dict(max_prefill_tokens_per_step=sizes["chunk"])),
                       ("ragged", dict(ragged_prefill=True)),
                       ("chunked+ragged", dict(max_prefill_tokens_per_step=sizes["chunk"],
                                               ragged_prefill=True))):
        eng = engine(**over)
        reqs = run_engine(eng, [wave], sizes["max_tokens"])
        runs[name] = (reqs, dict(eng.stats))
        del eng
    for name in ("chunked", "ragged", "chunked+ragged"):
        pair(name, runs["plain"][0], runs[name][0])
    batches = {k: v[1]["prefill_batches"] for k, v in runs.items()}
    check(batches["ragged"] < batches["plain"]
          and batches["chunked+ragged"] < batches["chunked"],
          f"[features] ragged prefill took no fewer calls: {batches}")
    out["prefill_batches"] = batches
    out["ttft_ms"] = {k: ttft_ms(v[0]) for k, v in runs.items()}
    log(f"[features] chunked ({sizes['chunk']} tokens a step) and ragged prefill: "
        f"{len(wave)} prompts of {min(map(len, wave))}-{max(map(len, wave))} tokens, "
        f"tokens identical to one call a bucket; prefill calls {batches}; mean TTFT ms "
        + json.dumps({k: round(v, 1) for k, v in out["ttft_ms"].items()}))

    # Prefix caching: a shared prefix, then a wave that reuses it.
    prefix = prompts_of(rng, [sizes["prefix"]], vocab)[0]
    waves = [[prefix + s for s in prompts_of(rng, sizes["suffix"][:1], vocab)],
             [prefix + s for s in prompts_of(rng, sizes["suffix"][1:], vocab)]]
    cached = {}
    for on in (False, True):
        eng = engine(enable_prefix_caching=on)
        cached[on] = (run_engine(eng, waves, sizes["max_tokens"]), dict(eng.stats))
        del eng
    pair("prefix caching", cached[False][0], cached[True][0])
    hit = cached[True][1]["prefix_cached_tokens"]
    check(hit > 0, "[features] the second wave reused no cached prefix")
    out["prefix"] = {"cached_tokens": hit,
                     "prefill_tokens": {str(k): v[1]["prefill_tokens"]
                                        for k, v in cached.items()},
                     "ttft_ms_wave2": {str(k): ttft_ms(v[0][1:]) for k, v in cached.items()}}
    log(f"[features] prefix caching, a {sizes['prefix']}-token prefix shared by "
        f"{len(waves[1])} requests: tokens identical; prefix_cached_tokens {hit}; "
        f"prefill tokens {out['prefix']['prefill_tokens']}; wave-2 mean TTFT ms "
        + json.dumps({k: round(v, 1) for k, v in out["prefix"]["ttft_ms_wave2"].items()}))

    # The host tier: a pool small enough that filler traffic evicts the
    # prefix, then the prefix again.
    tier_waves = [waves[0], prompts_of(rng, sizes["filler"], vocab),
                  [prefix + s for s in prompts_of(rng, [33], vocab)]]
    tiered = {}
    for on in (False, True):
        eng = engine(num_blocks=sizes["evict_blocks"], enable_prefix_caching=on,
                     prefix_host_blocks=sizes["host_blocks"] if on else 0)
        tiered[on] = (run_engine(eng, tier_waves, sizes["max_tokens"]), dict(eng.stats),
                      eng.prefix_cache and dict(eng.prefix_cache.stats))
        del eng
    pair("host tier", tiered[False][0], tiered[True][0])
    restored = tiered[True][1]["prefix_restored_tokens"]
    check(restored > 0, f"[features] nothing restored from the host tier: {tiered[True][2]}")
    out["tier"] = {"restored_tokens": restored, **tiered[True][2]}
    log(f"[features] host tier ({sizes['host_blocks']} blocks) under a "
        f"{sizes['evict_blocks']}-block pool: tokens identical; prefix_restored_tokens "
        f"{restored}; allocator {tiered[True][2]}")

    # N-gram speculation, graphed, against plain decode; then eager rounds.
    spec_wave = [p * (4 + i) for i, p in enumerate(prompts_of(rng, [7, 11, 5, 13], vocab))]
    spec_wave += prompts_of(rng, sizes["spec_plain"], vocab)
    spec = dict(speculative="ngram", num_draft_tokens=sizes["spec_k"],
                steps_per_sync=sizes["spec_sync"])
    spec_runs = {}
    for name, over, graphs in (("plain", dict(steps_per_sync=sizes["spec_sync"]), True),
                               ("spec", spec, True), ("spec eager", spec, False)):
        eng = engine(graphs=graphs, **over)
        eng.warmup_decode_ladder()
        plain_steps, spans = [0], []
        window = eng.executor.decode_window

        def counted(k, *a, window=window, plain_steps=plain_steps):
            plain_steps[0] += k
            return window(k, *a)

        eng.executor.decode_window = counted
        dispatch, complete = eng._decode_dispatch, eng._decode_complete
        clock = {}

        def timed_dispatch(dispatch=dispatch, clock=clock):
            if cuda:
                torch.cuda.synchronize()
            clock["t"] = time.perf_counter()
            return dispatch()

        def timed_complete(pending, complete=complete, clock=clock, spans=spans):
            res = complete(pending)
            n = (pending[3].shape[0] if pending[0] == "spec" else pending[1])
            spans.append((pending[0] == "spec", n, time.perf_counter() - clock["t"]))
            return res

        eng._decode_dispatch, eng._decode_complete = timed_dispatch, timed_complete
        if cuda:
            torch.cuda.synchronize()
            tpa.launches = tpa.launches_int8 = 0
        reqs = run_engine(eng, [spec_wave], sizes["spec_tokens"])
        rec = {"reqs": reqs, "stats": dict(eng.stats), "plain_steps": plain_steps[0],
               "pool_gb": eng.executor.graph_pool_bytes / 1e9,
               "graphs": len(eng.executor.spec_graphs),
               "round_ms": [1e3 * t / n for s, n, t in spans if s],
               "step_ms": [1e3 * t / n for s, n, t in spans if not s]}
        if cuda:
            torch.cuda.synchronize()
            layers = cfg.num_layers
            per_replay = eng.executor.launches.per_replay[0]
            check(tpa.launches == layers * plain_steps[0] and tpa.launches_int8 == 0,
                  f"[features] {name}: K4 launched {tpa.launches} times for "
                  f"{plain_steps[0]} plain decode steps of {layers} layers")
            check(not graphs or per_replay == layers,
                  f"[features] {name}: the decode graph credits {per_replay} K4 a step")
            if name == "spec":
                # A spec window's dispatch under the sync check.
                eng.submit(spec_wave[0], SamplingParams(temperature=0.0, max_tokens=16))
                eng.step()
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    pending = dispatch()
                except RuntimeError as e:
                    raise CheckFailed(f"[features] the spec dispatch synchronized: {e}") from e
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                check(pending is not None and pending[0] == "spec",
                      "[features] the sync check's window was not a spec window")
                complete(pending)
                while eng.has_work:
                    eng.step()
        spec_runs[name] = rec
        del eng
    pair("speculative", spec_runs["plain"]["reqs"], spec_runs["spec"]["reqs"])
    pair("spec graph against eager rounds", spec_runs["spec eager"]["reqs"],
         spec_runs["spec"]["reqs"])
    st = spec_runs["spec"]["stats"]
    check(st["spec_proposed"] > 0 and st["spec_accepted"] > 0,
          f"[features] speculation proposed {st['spec_proposed']}, accepted "
          f"{st['spec_accepted']}")
    check(not cuda or spec_runs["spec"]["graphs"] > 0, "[features] no spec graph captured")
    med = lambda xs: float(np.median(xs)) if xs else None  # noqa: E731
    out["spec"] = {
        "proposed": st["spec_proposed"], "accepted": st["spec_accepted"],
        "acceptance": st["spec_accepted"] / st["spec_proposed"],
        "tokens_per_slot_round": (st["generated_tokens"] - len(spec_wave))
        / max(1, st["decode_slot_steps"]),
        "round_ms_median": med(spec_runs["spec"]["round_ms"]),
        "plain_step_ms_median": med(spec_runs["plain"]["step_ms"]),
        "spec_plain_step_ms_median": med(spec_runs["spec"]["step_ms"]),
        "decode_steps": {k: v["stats"]["decode_steps"] for k, v in spec_runs.items()},
        "plain_steps_in_spec_run": spec_runs["spec"]["plain_steps"],
        "graph_pool_gb": spec_runs["spec"]["pool_gb"],
        "plain_graph_pool_gb": spec_runs["plain"]["pool_gb"]}
    log(f"[features] n-gram speculation (k {sizes['spec_k']}, {sizes['spec_sync']} rounds "
        f"a sync, graphed) against plain decode and against eager rounds: tokens identical; "
        + json.dumps(out["spec"]))
    return out


# Phase 18's server: the latency-bounded configuration with the features on,
# and the same flags without them as the yardstick, serving an export of
# llama2_7b at full width cut to FEATURE_LAYERS layers (the full depth's
# load tests took 210 s of the run; cut to make room for phase 19).
FEATURE_BASE_ARGS = ["--tokenizer", "byte",
                     "--quantization", "int8", "--kv-cache-dtype", "int8",
                     "--max-seqs", "28", "--num-blocks", "910", "--steps-per-sync", "32",
                     "--host", "127.0.0.1", "--port", "0"]
FEATURE_FLAGS = ["--max-prefill-tokens", "256", "--ragged-prefill",
                 "--enable-prefix-caching", "--prefix-host-blocks", "256",
                 "--speculative", "ngram", "--num-draft-tokens", "4"]
SESSION_FLAGS = ["--sessions", "8", "--turns", "4"]
# The open-loop mix at a quarter of its requests (32 until phase 20 needed
# the room, 16 until phase 21 did).
MIXED_FLAGS = ["--qps", "1.5", "--num-requests", "8", "--max-tokens", "256",
               "--long-prompt-frac", "0.25", "--long-prompt-tokens", "1024",
               "--scrape-server-metrics"]


def phase_features(torch, card):
    """Phase 18: the engine features at llama2_7b width. First each feature
    against the engine without it at 8 layers in float32 (``feature_pairs``);
    then over HTTP on an export at the same depth in bf16, the serve CLI
    with the features on under two load tests (sessions; an open-loop mix
    with long prompts), and the same flags without the features under the
    second as the yardstick."""
    import dataclasses as dc
    import shutil
    import tempfile

    from dlti_tpu_torch.checkpoint import export_merged_model
    from dlti_tpu_torch.config import MODEL_PRESETS, CheckpointConfig, Config, LoRAConfig
    from dlti_tpu_torch.models.interop import init_params

    t_phase = time.perf_counter()
    free_memory(torch)
    cfg = dc.replace(MODEL_PRESETS["llama2_7b"], num_layers=FEATURE_LAYERS,
                     dtype="float32", param_dtype="float32")
    params = init_params(cfg, seed=0, device="cuda")
    log(f"[features] llama2_7b at full width (hidden {cfg.hidden_size}, {cfg.num_heads} "
        f"heads, vocab {cfg.vocab_size}), layers {cfg.num_layers} of 32, float32, TF32 off")
    perf = {"card": card, "pairs": feature_pairs(torch, cfg, params, "cuda", FEATURE_SIZES)}
    del params
    free_memory(torch)
    perf["pairs_s"] = time.perf_counter() - t_phase
    # The servers' model: the same width and depth in bf16, as an export.
    root = Path(tempfile.mkdtemp(prefix="dlti-features-"))
    bf16 = dc.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")
    params = init_params(bf16, seed=0, device="cuda")
    export_merged_model(str(root / "export"), params,
                        Config(model=bf16, lora=LoRAConfig(enabled=False),
                               checkpoint=CheckpointConfig(output_dir=str(root / "ck"),
                                                           save_strategy="no")))
    del params
    free_memory(torch)
    model_args = ["--model-dir", str(root / "export")]

    def pool_gb(seen):
        for ln in seen:
            m = re.search(r"graph pool ([0-9.]+) GB", ln)
            if m:
                return float(m.group(1))
        return None

    def drive_on(addr):
        sessions = run_loadgen(addr, SESSION_FLAGS, "[features serve on]")
        check(sessions["cache_hit_rate"] > 0, "[features serve on] prefix hit rate "
              f"{sessions['cache_hit_rate']}")
        mixed = run_loadgen(addr, MIXED_FLAGS, "[features serve on]")
        check(mixed["spec"].get("proposed", 0) > 0,
              f"[features serve on] spec proposed nothing: {mixed['spec']}")
        stats = json.loads(http_request(addr, "GET", "/stats")[1])
        return {"sessions": loadgen_summary(sessions), "mixed": loadgen_summary(mixed),
                "stats": {k: stats[k] for k in (
                    "prefix_cached_tokens", "prefix_restored_tokens", "prefill_tokens",
                    "prefill_batches", "spec_proposed", "spec_accepted",
                    "spec_paused_rounds", "decode_steps", "decode_slot_steps",
                    "generated_tokens", "requests", "preemptions")}}

    py = [sys.executable, "-m", "dlti_tpu_torch.cli.serve"] + model_args
    try:
        seen, on = serve_subprocess(py + FEATURE_BASE_ARGS + FEATURE_FLAGS,
                                    "[features serve on]", drive=drive_on)
        st = on["stats"]
        on["graph_pool_gb"] = pool_gb(seen)
        on["spec_acceptance"] = st["spec_accepted"] / max(1, st["spec_proposed"])
        on["tokens_per_slot_round"] = ((st["generated_tokens"] - st["requests"])
                                       / max(1, st["decode_slot_steps"]))
        seen, off = serve_subprocess(
            py + FEATURE_BASE_ARGS, "[features serve off]",
            drive=lambda addr: {"mixed": loadgen_summary(
                run_loadgen(addr, MIXED_FLAGS, "[features serve off]"))})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    off["graph_pool_gb"] = pool_gb(seen)
    perf["serve"] = {"on": on, "off": off}
    for name, rec in (("on", on), ("off", off)):
        r = rec["mixed"]
        log(f"[features serve {name}] mixed run: client TTFT p50 {r['ttft_p50_s']:.4f} s, "
            f"p99 {r['ttft_p99_s']:.4f} s, TPOT {r['tpot_mean_ms']:.2f} ms; engine "
            f"{json.dumps(r['engine'])}; output tok/s {r['output_tokens_per_s']:.1f}; "
            f"graph pool {rec['graph_pool_gb']} GB")
    log(f"[features serve on] sessions prefix hit rate "
        f"{on['sessions']['cache_hit_rate']:.4f}, engine {json.dumps(on['sessions']['engine'])}"
        f"; spec acceptance {on['spec_acceptance']:.4f}, tokens per slot-round "
        f"{on['tokens_per_slot_round']:.3f}; /stats {json.dumps(st)}")
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"[features] card {card}; phase {perf['phase_s']:.1f} s")
    return perf


# ----------------------------------------------------------------------
# Phase 19: Hugging Face checkpoints in and out, PEFT adapters, multi-LoRA
# ----------------------------------------------------------------------

HF_SHARDS = 4          # llama2_7b in bf16 over 4 GiB shards
HF_TRAIN_STEPS = 4
ADAPTER_RANK = 16
ADAPTER_LAYERS = 8     # the float32 static-LoRA comparison's depth
# Phase 19's mixed batch: the slot each request takes and its adapter ("" =
# the base), greedy, 33 tokens each (one from the prefill, four windows of 8).
ADAPTER_ASSIGN = ["", "trained", "seeded", "", "trained", "seeded", "", "seeded"]
ADAPTER_MAX_TOKENS = 33
ADAPTER_SERVE_ARGS = ["--random-init", "llama2_7b", "--tokenizer", "byte",
                      "--max-seqs", "8", "--num-blocks", "512", "--steps-per-sync", "8",
                      "--host", "127.0.0.1", "--port", "0"]


def lora_names(cfg, targets=("q_proj", "k_proj", "v_proj", "o_proj"), layers=None):
    """``{name: (shape)}`` of the LoRA factors at rank ``ADAPTER_RANK``."""
    hd = cfg.resolved_head_dim
    out_dim = {"q_proj": cfg.num_heads * hd, "k_proj": cfg.num_kv_heads * hd,
               "v_proj": cfg.num_kv_heads * hd, "o_proj": cfg.hidden_size}
    in_dim = {"q_proj": cfg.hidden_size, "k_proj": cfg.hidden_size,
              "v_proj": cfg.hidden_size, "o_proj": cfg.num_heads * hd}
    out = {}
    for i in range(cfg.num_layers if layers is None else layers):
        for p in targets:
            pre = f"model.layers.{i}.attn.{p}"
            out[f"{pre}.lora_a"] = (in_dim[p], ADAPTER_RANK)
            out[f"{pre}.lora_b"] = (ADAPTER_RANK, out_dim[p])
    return out


def adapter_run(torch, engine, prompts, assign):
    """The mixed batch on ``engine`` (one wave: every slot admitted in the
    first step): each request's tokens, the decode steps, K4 or K4q launches
    (counted from 0 here) and each window's (k, seconds)."""
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.serving.sampling import SamplingParams

    engine.warmup_decode_ladder()
    torch.cuda.synchronize()
    spans = window_clock(engine)
    tpa.launches = tpa.launches_int8 = 0
    steps0 = engine.stats["decode_steps"]
    sp = SamplingParams(temperature=0.0, max_tokens=ADAPTER_MAX_TOKENS)
    reqs = [engine.submit(p, sp, adapter=a) for p, a in zip(prompts, assign)]
    while engine.has_work:
        engine.step()
    torch.cuda.synchronize()
    return {"tokens": [r.output_token_ids for r in reqs],
            "finish": [r.finish_reason for r in reqs],
            "decode_steps": engine.stats["decode_steps"] - steps0,
            "k4": tpa.launches, "k4q": tpa.launches_int8, "spans": list(spans)}


def step_ms(spans) -> float:
    """Median ms per device step over full windows (k > 1)."""
    import statistics

    per = [1e3 * s / k for k, s in spans if k > 1]
    return statistics.median(per) if per else float("nan")


def phase_hf_adapters(torch, card):
    """Phase 19: an HF checkpoint of llama2_7b written and read back; the
    train CLI from it with PEFT and HF exports; the trained and a seeded
    adapter served over one base in one decode batch (bf16 pool, full
    depth), held against the adapter-off engine and, at 8 layers in
    float32, against static-LoRA engines; then over HTTP on an int8 pool."""
    import os
    import shutil
    import tempfile
    import threading

    from dlti_tpu_torch.cli import serve as cli
    from dlti_tpu_torch.config import MODEL_PRESETS, LoRAConfig
    from dlti_tpu_torch.models import hf_interop as hf
    from dlti_tpu_torch.models import merge_lora_params
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, make_server
    from dlti_tpu_torch.serving import adapters as ad

    t_phase = time.perf_counter()
    free_memory(torch)
    cfg = MODEL_PRESETS["llama2_7b"]
    layers = cfg.num_layers
    root = Path(tempfile.mkdtemp(prefix="dlti-hf-"))
    perf = {"card": card}
    try:
        # 1. the HF directory, written and read back
        params = init_params(cfg, seed=0, device="cuda")
        gb = sum(t.numel() * t.element_size() for t in params.values()) / 1e9
        hf_dir = root / "hf"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hf.save_hf_checkpoint(str(hf_dir), params, cfg)
        write_s = time.perf_counter() - t0
        shards = sorted(f for f in os.listdir(hf_dir) if f.endswith(".safetensors"))
        check(len(shards) == HF_SHARDS,
              f"[hf] expected {HF_SHARDS} shards and an index, got {os.listdir(hf_dir)}")
        t0 = time.perf_counter()
        back, back_cfg = hf.load_hf_checkpoint(str(hf_dir), device="cuda")
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        arch = ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
                "num_kv_heads", "resolved_head_dim", "rope_theta", "rms_norm_eps",
                "tie_embeddings", "max_seq_len")
        check(all(getattr(back_cfg, f) == getattr(cfg, f) for f in arch),
              f"[hf] config.json read back as {back_cfg}")
        # Every leaf comes back in param_dtype (the norm scales too, as in the
        # reference's mapping); compared in the written leaf's dtype.
        bad = [n for n, t in params.items()
               if back[n].dtype != torch.bfloat16 or not torch.equal(back[n].to(t.dtype), t)]
        check(sorted(back) == sorted(params) and not bad,
              f"[hf] {len(bad)} leaves differ after the round trip: {bad[:4]}")
        perf["hf_io"] = {"gb": gb, "write_s": write_s, "read_s": read_s,
                         "write_gb_s": gb / write_s, "read_gb_s": gb / read_s,
                         "shards": len(shards)}
        log(f"[hf] llama2_7b init_params(seed=0), {gb:.3f} GB in {len(shards)} shards: "
            f"save_hf_checkpoint {write_s:.2f} s ({gb / write_s:.2f} GB/s, fsynced), "
            f"load_hf_checkpoint to the card {read_s:.2f} s ({gb / read_s:.2f} GB/s); "
            f"{len(params)} tensors bit-equal")
        del params, back
        free_memory(torch)

        # 2. cli.train from the HF directory, with both exports
        data = root / "data.jsonl"
        data.write_text("".join(json.dumps({"text": t}) + "\n" for t in training_texts()))
        peft_dir, hf_out = root / "peft", root / "hf_out"
        py = [sys.executable, "-m", "dlti_tpu_torch.cli.train"]
        summary, out = run_train_cli(py + [
            "--model", "llama2_7b", "--preset", "baseline", "--tokenizer", "byte",
            "--dataset-path", str(data), "--max-seq-len", "512",
            "--per-device-batch-size", "4", "--gradient-accumulation-steps", "2",
            "--max-steps", str(HF_TRAIN_STEPS), "--steps-per-sync", "2",
            "--warmup-steps", "2", "--learning-rate", "2e-4",
            "--lora-r", str(ADAPTER_RANK), "--save-strategy", "no",
            "--output-dir", str(root / "ck"),
            "--metrics-csv", str(root / "m.csv"), "--step-log", str(root / "steps.jsonl"),
            "--init-from-hf", str(hf_dir), "--export-peft", str(peft_dir),
            "--export-hf", str(hf_out)], "[hf train]")
        run = quickstart_run_perf(summary, root / "steps.jsonl")
        n = flash_expected(layers, 2, HF_TRAIN_STEPS + run["captures"])
        want = {"fwd": n["flash_fwd"], "dq": n["flash_bwd_dq"], "dkv": n["flash_bwd_dkv"]}
        check(run["launches"] == want,
              f"[hf train] K1-K3 launches {run['launches']}, expected {want}")
        check(run["steps"] == HF_TRAIN_STEPS and math.isfinite(run["final_loss"])
              and "PEFT adapter ->" in out and "HF checkpoint ->" in out,
              f"[hf train] run {run}")
        perf["train"] = run
        log(f"[hf train] cli.train --init-from-hf: {run['steps']} steps, step "
            f"{run['step_ms']:.1f} ms, {run['tokens_per_s']:.1f} tokens/s, peak "
            f"{run['peak_memory_gb']} GB, {run['captures']} capture, K1-K3 launches "
            f"{run['launches']} (= 32 layers x 2 microbatches x {HF_TRAIN_STEPS} steps + "
            f"the capture's warm-up step, K1 twice under remat)")
        # The HF export against merge_lora_params of the trained state: the
        # base the run started from with the factors its PEFT export holds.
        lora = {n: torch.zeros(s, device="cuda") for n, s in lora_names(cfg).items()}
        hf.load_peft_adapter(str(peft_dir), lora)
        check(all(bool(t.any()) for n, t in lora.items() if n.endswith("lora_b")),
              "[hf train] a trained lora_b is still zero")
        base, _ = hf.load_hf_checkpoint(str(hf_dir), device="cuda")
        merged = merge_lora_params({**base, **lora}, alpha=2 * ADAPTER_RANK)
        del base
        exported, _ = hf.load_hf_checkpoint(str(hf_out), device="cuda")
        bad = [n for n in merged if not torch.equal(exported[n], merged[n])]
        check(sorted(exported) == sorted(merged) and not bad,
              f"[hf train] the HF export differs from the merged state at {bad[:4]}")
        log(f"[hf train] load_hf_checkpoint(--export-hf) bit-equal to merge_lora_params "
            f"of the trained state ({len(merged)} tensors); PEFT adapter "
            f"{sum(t.numel() for t in lora.values()) * 4 / 1e6:.1f} MB")
        del merged, exported
        free_memory(torch)

        # 3. the adapters: the trained one through load_peft_adapter, a seeded one
        gen = torch.Generator(device="cuda").manual_seed(1)
        seeded = {}
        for n, s in lora_names(cfg).items():
            t = torch.empty(s, device="cuda")
            if n.endswith("lora_a"):
                t.uniform_(-s[0] ** -0.5, s[0] ** -0.5, generator=gen)
            else:
                t.normal_(0.0, 0.05, generator=gen)
            seeded[n] = t
        dirs = {"trained": str(root / "ad_trained"), "seeded": str(root / "ad_seeded")}
        ad.save_adapter(dirs["trained"], lora, alpha=2 * ADAPTER_RANK)
        ad.save_adapter(dirs["seeded"], seeded, alpha=2 * ADAPTER_RANK)

        # 4. one decode batch of base rows and both adapters, full depth, bf16 pool
        rng = __import__("numpy").random.default_rng(19)
        prompts = [rng.integers(3, cfg.vocab_size, n).tolist()
                   for n in (16, 40, 77, 128, 200, 255, 300, 100)]
        ad.get_catalog().clear()
        args = cli.parse_args(ADAPTER_SERVE_ARGS + [
            "--adapter-slots", "2", "--adapter-rank", str(ADAPTER_RANK),
            "--adapter", f"trained={dirs['trained']}"])
        engine, _, _ = cli.build(args)
        ad.register_adapter("seeded", dirs["seeded"])
        # A row load queues its copies without waiting on the card.
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            row, loaded = engine.adapter_pool.acquire("seeded")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(row > 0 and loaded, f"[adapters] acquire gave {(row, loaded)}")
        engine.adapter_pool.release(row)
        on = adapter_run(torch, engine, prompts, ADAPTER_ASSIGN)
        pool_bytes = engine.adapter_pool.nbytes
        plan = ad.plan_pool_bytes(cfg, engine.cfg.adapter_targets, ADAPTER_RANK, 2)
        graph_pool = engine.executor.graph_pool_bytes
        del engine
        free_memory(torch)
        engine, _, _ = cli.build(cli.parse_args(ADAPTER_SERVE_ARGS))
        off = adapter_run(torch, engine, prompts, [""] * len(prompts))
        del engine
        free_memory(torch)
        check(all(f in ("length", "stop") for f in on["finish"] + off["finish"]),
              f"[adapters] finishes {on['finish']} / {off['finish']}")
        check(pool_bytes == plan, f"[adapters] pool {pool_bytes} B, plan {plan} B")
        for run_, name in ((on, "adapters on"), (off, "adapters off")):
            check(run_["k4"] == layers * run_["decode_steps"] > 0 and not run_["k4q"],
                  f"[adapters] {name}: K4 {run_['k4']} launches for "
                  f"{run_['decode_steps']} decode steps")
        base_rows = [i for i, a in enumerate(ADAPTER_ASSIGN) if not a]
        check(all(on["tokens"][i] == off["tokens"][i] for i in base_rows),
              "[adapters] a base row's tokens differ from the adapter-off engine's")
        changed = sum(on["tokens"][i] != off["tokens"][i]
                      for i, a in enumerate(ADAPTER_ASSIGN) if a)
        check(changed > 0, "[adapters] no adapter row changed its tokens")
        perf["decode"] = {"on_ms": step_ms(on["spans"]), "off_ms": step_ms(off["spans"]),
                          "pool_bytes": pool_bytes, "k4_on": on["k4"], "k4_off": off["k4"],
                          "decode_steps": on["decode_steps"], "adapter_rows_changed": changed,
                          "graph_pool_bytes": graph_pool}
        log(f"[adapters] llama2_7b, 8 slots (3 base rows, 2 'trained', 3 'seeded'), k 8, "
            f"bf16 pool: decode step {perf['decode']['on_ms']:.3f} ms with the adapter "
            f"branch against {perf['decode']['off_ms']:.3f} ms without (median over full "
            f"windows); pool {pool_bytes / 1e6:.2f} MB = plan_pool_bytes; K4 {on['k4']} = 32 "
            f"layers x {on['decode_steps']} decode steps; base rows token-identical to the "
            f"adapter-off engine; {changed} of 5 adapter rows changed; a row load under "
            f"set_sync_debug_mode('error'); graph pool {graph_pool / 1e9:.2f} GB")

        # 5. at 8 layers in float32: each adapter's rows against an engine
        # holding it as static LoRA leaves
        cfg8 = dataclasses.replace(cfg, num_layers=ADAPTER_LAYERS, dtype="float32",
                                   param_dtype="float32")
        base8 = init_params(cfg8, seed=0, device="cuda")
        keep = lora_names(cfg8)
        trees = {"trained": {n: lora[n] for n in keep}, "seeded": {n: seeded[n] for n in keep}}
        ad.get_catalog().clear()
        for name, tree in trees.items():
            d = str(root / f"ad8_{name}")
            ad.save_adapter(d, tree, alpha=2 * ADAPTER_RANK)
            ad.register_adapter(name, d)
        ec = dict(max_seqs=8, block_size=16, num_blocks=256, max_model_len=1024,
                  cache_dtype="float32", steps_per_sync=8, eos_token_id=-1)
        shared = InferenceEngine(cfg8, base8, EngineConfig(
            adapter_slots=2, adapter_rank=ADAPTER_RANK, **ec), device="cuda")
        mixed = adapter_run(torch, shared, prompts, ADAPTER_ASSIGN)
        del shared
        lcfg = LoRAConfig(r=ADAPTER_RANK, alpha=2 * ADAPTER_RANK, dropout=0.0)
        static = {}
        for name, tree in trees.items():
            eng = InferenceEngine(cfg8, {**base8, **tree}, EngineConfig(**ec),
                                  lora_cfg=lcfg, device="cuda")
            static[name] = adapter_run(torch, eng, prompts, [""] * len(prompts))
            del eng
        eng = InferenceEngine(cfg8, base8, EngineConfig(**ec), device="cuda")
        static[""] = adapter_run(torch, eng, prompts, [""] * len(prompts))
        del eng, base8
        free_memory(torch)
        for i, name in enumerate(ADAPTER_ASSIGN):
            check(mixed["tokens"][i] == static[name]["tokens"][i],
                  f"[adapters f32] row {i} ({name or 'base'}) differs from the engine "
                  f"holding it as static LoRA leaves")
        check(mixed["k4"] == ADAPTER_LAYERS * mixed["decode_steps"],
              f"[adapters f32] K4 {mixed['k4']} for {mixed['decode_steps']} steps")
        log(f"[adapters f32] llama2_7b width, {ADAPTER_LAYERS} layers, float32, TF32 off: "
            f"every row of the mixed batch token-identical to the engine holding its "
            f"adapter as static LoRA leaves (base rows: the adapter-off engine); K4 "
            f"{mixed['k4']} = {ADAPTER_LAYERS} x {mixed['decode_steps']}")

        # 6. over HTTP on an int8 pool
        ad.get_catalog().clear()
        args = cli.parse_args(ADAPTER_SERVE_ARGS + [
            "--kv-cache-dtype", "int8", "--adapter-slots", "2",
            "--adapter-rank", str(ADAPTER_RANK), "--adapter", f"trained={dirs['trained']}"])
        engine, tok, sc = cli.build(args)
        engine.warmup_decode_ladder()
        httpd, aeng = make_server(engine, tok, sc)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        addr = ("127.0.0.1", httpd.server_address[1])
        try:
            status, data = http_request(addr, "POST", "/v1/adapters",
                                        {"name": "seeded", "directory": dirs["seeded"]})
            check(status == 200, f"[adapters http] POST /v1/adapters {status} {data[:200]}")
            listed = json.loads(http_request(addr, "GET", "/v1/adapters")[1])["data"]
            check(listed == ["seeded", "trained"], f"[adapters http] listed {listed}")
            tpa.launches = tpa.launches_int8 = 0
            steps0 = engine.stats["decode_steps"]
            body = {"prompt": "def model(x):", "max_tokens": 24, "temperature": 0.0}
            results, errors = {}, []

            def one(name):
                try:
                    status, data = http_request(addr, "POST", "/v1/completions", body,
                                                headers={"X-Adapter": name} if name else None)
                    results[name] = (status, json.loads(data))
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(repr(e))

            threads = [threading.Thread(target=one, args=(n,)) for n in ("", "trained", "seeded")]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            check(not errors and all(s == 200 and r["usage"]["completion_tokens"] == 24
                                     for s, r in results.values()),
                  f"[adapters http] {errors} {results}")
            status, data = http_request(addr, "POST", "/v1/completions", body,
                                        headers={"X-Adapter": "ghost"})
            check(status == 404 and b"unknown adapter" in data,
                  f"[adapters http] unknown adapter answered {status}")
            metrics = http_request(addr, "GET", "/metrics")[1].decode()
            series = {ln.split()[0]: float(ln.split()[1]) for ln in metrics.splitlines()
                      if ln.startswith("dlti_adapter")}
            check(set(ad.ADAPTER_METRIC_NAMES) <= set(series)
                  and series["dlti_adapter_pool_bytes"] == engine.adapter_pool.nbytes,
                  f"[adapters http] /metrics adapter series {series}")
            steps = engine.stats["decode_steps"] - steps0
            check(tpa.launches_int8 == layers * steps > 0 and not tpa.launches,
                  f"[adapters http] K4q {tpa.launches_int8} for {steps} decode steps")
            perf["http"] = {"k4q": tpa.launches_int8, "decode_steps": steps,
                            "series": series}
            log(f"[adapters http] int8 pool: POST /v1/adapters 200, GET lists {listed}; "
                f"3 concurrent completions (base, X-Adapter trained, seeded) 200, an "
                f"unknown X-Adapter 404; K4q {tpa.launches_int8} = 32 x {steps} decode "
                f"steps; /metrics {json.dumps(series)}")
        finally:
            httpd.shutdown()
            aeng.shutdown()
            httpd.server_close()
            ad.get_catalog().clear()
        del engine
        free_memory(torch)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"[hf] card {card}; phase {perf['phase_s']:.1f} s")
    return perf


# ----------------------------------------------------------------------
# Slice 15: Mixtral-8x7B at full width and depth on int8 weights
# ----------------------------------------------------------------------

# Phase 20's serving runs: the 12-request run (phase 3's prompts of 16-300
# tokens, MIXTRAL_SERVE_TOKENS each), then the equality script three ways.
MIXTRAL_EQUALITY_RUNS = EQUALITY_RUNS[:3]
MIXTRAL_EQ_LENGTHS = [16, 40, 77, 128, 200, 255, 300, 120]
# Every slot busy for every decode step at k 1 and at k 8 (the first token
# from the prefill, then one 8-step window): a free or finished slot's row
# takes tokens of its own (zeros at k 1, its draws inside a window), and
# under a capacity that drops tokens its routing moves the others'.
MIXTRAL_EQ_MAX_TOKENS = 9
MIXTRAL_TRAIN_STEPS = 3      # graphed, 1 a sync (the CLI's default)
MIXTRAL_EAGER_STEPS = 2      # the yardstick's
# A router drawn at random balances the load roughly: the loss of each layer
# is near its balanced value 1, far below E = 8 (every token on one expert).
# The JAX package's bound for isotropic inputs to one layer is 0.9-1.6
# (tests/test_moe.py): phase 20 holds each layer's router to it on isotropic
# Gaussian inputs (AUX_ISOTROPIC). On the model's own hidden states,
# Mixtral-8x7B at init reads more: 1.66-1.74 a layer on average while the
# experts were drawn sqrt(E) too wide, 1.96-2.03 since they are drawn as flax
# draws them (fan in E * h), where the witness shows the same routers at
# 1.000-1.002 on isotropic inputs and every layer's states sharing one
# direction more (|mean unit|^2 0.77-0.82 past layer 0, from 0.61). The
# model's loss is held just above that; mixtral_aux_witness recomputes every
# layer's loss plainly from the states its router saw, within AUX_WITNESS_TOL.
AUX_PER_LAYER = (0.9, 2.2)
# The int8 weights' error reading: depth and (prompts, tokens).
MIXTRAL_INT8_ERR_LAYERS, MIXTRAL_INT8_ERR_BATCH = 2, (4, 128)
AUX_ISOTROPIC = (0.9, 1.6)
# One reassigned token moves a layer's loss by E * |P_a - P_b| / (n k), below
# 1e-4 at n ~ 1,400 valid tokens; float32 against float64 probabilities
# differ by ~1e-7.
AUX_WITNESS_TOL = 1e-3


# Tokens a Mixtral request runs (phase 3's 32 until phase 21 needed the
# room).
MIXTRAL_SERVE_TOKENS = 16


def mixtral_requests(cfg, seed=0):
    """Phase 3's 12 requests at Mixtral's vocabulary: prompts of 16-300
    tokens, greedy and seeded in turn, ``MIXTRAL_SERVE_TOKENS`` each."""
    import numpy as np

    from dlti_tpu_torch.serving.sampling import SamplingParams

    rng = np.random.default_rng(seed)
    lengths = [16, 300] + rng.integers(16, 301, 10).tolist()
    out = []
    for i, n in enumerate(lengths):
        sp = (SamplingParams(temperature=0.0, max_tokens=MIXTRAL_SERVE_TOKENS) if i % 2 == 0
              else SamplingParams(temperature=0.8, top_p=0.95, top_k=50,
                                  max_tokens=MIXTRAL_SERVE_TOKENS, seed=1000 + i))
        out.append((rng.integers(3, cfg.vocab_size, n).tolist(), sp))
    return out


def mixtral_equality_requests(cfg):
    import numpy as np

    from dlti_tpu_torch.serving.sampling import SamplingParams

    rng = np.random.default_rng(2)
    out = []
    m = MIXTRAL_EQ_MAX_TOKENS
    for i, n in enumerate(MIXTRAL_EQ_LENGTHS):
        sp = (SamplingParams(temperature=0.0, max_tokens=m) if i % 2 == 0 else
              SamplingParams(temperature=0.8, top_p=0.95, top_k=50, max_tokens=m,
                             seed=2000 + i))
        out.append((rng.integers(3, cfg.vocab_size, n).tolist(), sp))
    return out


def mixtral_serving(torch):
    """Phase 20 (a): Mixtral-8x7B through ``InferenceEngine`` on int8 weights
    (``init_params_int8(seed=0)``, drawn and quantized leaf by leaf), a bf16
    pool, 8 slots, the default capacity factor, the decode iteration as a
    CUDA graph: 12 requests with admission mid-flight (K4 32 x decode
    steps), then the equality script eager k 1, graphed k 1 and graphed k 8
    (identical tokens and logprobs; all 8 slots busy at every step, see
    ``MIXTRAL_EQ_MAX_TOKENS``), and a sync check around the k = 8 engine's
    8-step window."""
    from dlti_tpu_torch.config import MODEL_PRESETS
    from dlti_tpu_torch.models.interop import init_params_int8
    from dlti_tpu_torch.models.quantization import quant_bases
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.serving.engine import EngineConfig

    import numpy as np

    cfg = MODEL_PRESETS["mixtral_8x7b"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params_int8(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    scales = {f"{b}.scale" for b in quant_bases(params)}
    n_params = sum(t.numel() for n, t in params.items() if n not in scales)
    weight_bytes = sum(t.numel() * t.element_size() for t in params.values())
    check(n_params == cfg.num_params(), f"{n_params} params, expected {cfg.num_params()}")
    log(f"[mixtral] mixtral_8x7b: {n_params / 1e9:.3f} B params ({cfg.num_layers} layers, "
        f"{cfg.num_experts} experts of {cfg.intermediate_size}, top {cfg.num_experts_per_tok}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads), {cfg.num_active_params() / 1e9:.3f} B "
        f"active a token; int8 weights {weight_bytes / 1e9:.2f} GB drawn and quantized leaf "
        f"by leaf on the card in {init_s:.1f} s, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    perf_init_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()  # the serving peak from here
    ec = EngineConfig(max_seqs=8, block_size=16, num_blocks=520, max_model_len=1024,
                      cache_dtype="bfloat16", eos_token_id=-1, quantization="int8")
    check(cfg.moe_capacity_factor == 1.25, "the preset's capacity factor changed")

    engine = card_engine(cfg, params, ec)
    t0 = time.perf_counter()
    engine.warmup_decode_ladder()
    torch.cuda.synchronize()
    log(f"[mixtral] decode graph captured in {time.perf_counter() - t0:.2f} s, graph pool "
        f"{engine.executor.graph_pool_bytes / 1e9:.2f} GB, device memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    ex = engine.executor
    spans = {"prefill": [], "decode": []}

    def timed(kind, fn):
        def call(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            spans[kind].append((a, b))
            return out
        return call

    ex.prefill = timed("prefill", ex.prefill)
    ex.decode_window = timed("decode", ex.decode_window)
    reqs = mixtral_requests(cfg)
    tpa.launches = tpa.launches_int8 = 0  # the main path's counts start here
    t0 = time.perf_counter()
    results = [engine.submit(p, sp) for p, sp in reqs]
    while engine.has_work:
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, launches_int8 = tpa.launches, tpa.launches_int8  # ... and are read here
    del ex.prefill, ex.decode_window
    stats = dict(engine.stats)
    check(launches_int8 == 0, f"a bf16 pool launched the int8 kernel {launches_int8} times")
    for r, (p, _) in zip(results, reqs):
        check(r.finish_reason == "length"
              and len(r.output_token_ids) == MIXTRAL_SERVE_TOKENS,
              f"request {r.request_id} (prompt {len(p)}) finished {r.finish_reason} with "
              f"{len(r.output_token_ids)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output_token_ids),
              f"request {r.request_id} produced an out-of-vocabulary token")
        check(np.isfinite(r.output_logprobs).all(), "nonfinite logprobs")
    expected = cfg.num_layers * stats["decode_steps"]
    check(launches == expected, f"K4 launches {launches} != {cfg.num_layers} x "
          f"{stats['decode_steps']}")
    check(engine.block_manager.num_free == ec.num_blocks - 1, "blocks leaked")
    prefill_s = sum(a.elapsed_time(b) for a, b in spans["prefill"]) / 1e3
    decode_s = sum(a.elapsed_time(b) for a, b in spans["decode"]) / 1e3
    perf = {"init_s": init_s, "init_peak_gb": perf_init_peak, "num_params": n_params,
            "weight_gb": weight_bytes / 1e9,
            "requests": len(results), "decode_steps": stats["decode_steps"],
            "prefill_tokens": stats["prefill_tokens"],
            "prefill_tok_s": stats["prefill_tokens"] / prefill_s,
            "decode_tok_s": stats["decode_slot_steps"] / decode_s,
            "decode_step_ms": 1e3 * decode_s / stats["decode_steps"],
            "wall_s": wall, "k4_launches": launches,
            "graph_pool_gb": engine.executor.graph_pool_bytes / 1e9}
    log(f"[mixtral] {len(results)} requests in {wall:.2f} s (4 admitted mid-flight), "
        f"decode steps {stats['decode_steps']}, prefill batches {stats['prefill_batches']}; "
        f"K4 launches {launches} (expected {cfg.num_layers} x {stats['decode_steps']}); "
        f"decode {perf['decode_step_ms']:.2f} ms a device step, {perf['decode_tok_s']:.1f} "
        f"tok/s at up to 8 slots; prefill {perf['prefill_tok_s']:.1f} tok/s (CUDA events)")
    del engine, ex
    free_memory(torch)

    runs = {}
    for name, k, graphs in MIXTRAL_EQUALITY_RUNS:
        eng = card_engine(cfg, params, dataclasses.replace(ec, steps_per_sync=k), graphs)
        eng.warmup_decode_ladder()
        tpa.launches = 0
        windows = window_clock(eng)
        rs = [eng.submit(p, sp) for p, sp in mixtral_equality_requests(cfg)]
        while eng.has_work:
            eng.step()
        torch.cuda.synchronize()
        st = eng.stats
        check(all(r.finish_reason == "length" for r in rs), f"{name}: a request stopped early")
        check(tpa.launches == cfg.num_layers * st["decode_steps"],
              f"{name}: K4 launches {tpa.launches} != {cfg.num_layers} x {st['decode_steps']}")
        secs = sum(s for _, s in windows)
        runs[name] = {"ms_per_device_step": 1e3 * secs / st["decode_steps"],
                      "decode_tok_s": st["decode_slot_steps"] / secs,
                      "windows": len(windows), "decode_steps": st["decode_steps"],
                      "k4_launches": tpa.launches,
                      "outputs": [(r.output_token_ids, r.output_logprobs) for r in rs]}
        log(f"[mixtral equality] {name}: {runs[name]['ms_per_device_step']:.2f} ms per "
            f"device step (host clock over each window / k), {runs[name]['decode_tok_s']:.1f} "
            f"tok/s, {len(windows)} windows over {st['decode_steps']} steps; K4 "
            f"{tpa.launches}")
        del eng._decode_dispatch, eng._decode_complete
        if k == 8:
            sync_check(torch, eng, "[mixtral]", submit=True)
            while eng.has_work:
                eng.step()
        del eng
        free_memory(torch)
    first_name = MIXTRAL_EQUALITY_RUNS[0][0]
    first = runs[first_name]["outputs"]
    for name, run in runs.items():
        for i, (got, want) in enumerate(zip(run["outputs"], first)):
            check(got[0] == want[0], f"{name}: request {i}'s tokens differ from {first_name}'s")
            check(got[1] == want[1], f"{name}: request {i}'s logprobs differ from "
                  f"{first_name}'s")
    log(f"[mixtral equality] tokens and logprobs identical across {', '.join(runs)} "
        f"({sum(len(t) for t, _ in first)} tokens)")
    perf["equality"] = {n: {k: v for k, v in r.items() if k != "outputs"}
                        for n, r in runs.items()}
    del params
    free_memory(torch)
    perf["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[mixtral] serving peak {perf['peak_memory_gb']:.2f} GB (the init's "
        f"{perf_init_peak:.2f} GB apart)")
    return perf


def mixtral_aux_witness(torch, model, input_ids, token_mask):
    """A second source for the router's load-balance loss: one no-grad
    forward of ``input_ids (b, s)`` at full depth, each ``MoEMLP`` hooked.
    For every layer: the module's loss; the same loss recomputed plainly in
    float64 from the hidden states its router saw (``torch.topk``, no port
    code); the plain loss of isotropic Gaussian inputs of the same shape
    through the same router (the reference's unit-test setting); and how
    far the hidden states share one direction, the squared norm of the mean
    of their unit vectors (about 1/T for isotropic states, 1 for one
    direction). Returns the rows, by layer."""
    import torch.nn.functional as F

    from dlti_tpu_torch.models.moe import MoEMLP

    mlps = [m for m in model.modules() if isinstance(m, MoEMLP)]
    k = mlps[0].cfg.num_experts_per_tok
    rows = []
    gen = torch.Generator(device=input_ids.device).manual_seed(0)

    def plain_aux(x64, router64, valid):
        E = router64.shape[1]
        probs = torch.softmax(x64 @ router64, dim=-1)
        hits = F.one_hot(probs.topk(k, dim=-1).indices, E).sum(1).double()
        n = valid.sum()
        frac = (hits * valid[:, None]).sum(0) / (n * k)
        return float(E * (frac * (probs * valid[:, None]).sum(0) / n).sum())

    def hook(mod, args, out):
        x, mask = args[0], args[1]
        xt = x.reshape(-1, x.shape[-1]).double()
        valid = (torch.ones(xt.shape[0], dtype=torch.float64, device=xt.device)
                 if mask is None else mask.reshape(-1).double())
        router = mod.router.detach().double()
        unit = xt / xt.norm(dim=-1, keepdim=True)
        mean = (unit * valid[:, None]).sum(0) / valid.sum()
        iso = torch.randn(xt.shape, generator=gen, dtype=torch.float64, device=xt.device)
        rows.append({"module": float(out[1]), "plain": plain_aux(xt, router, valid),
                     "isotropic": plain_aux(iso, router, valid),
                     "shared": float(mean.square().sum())})

    handles = [m.register_forward_hook(hook) for m in mlps]
    try:
        with torch.no_grad():
            _, aux = model(input_ids, token_mask=token_mask, return_aux=True)
    finally:
        for h in handles:
            h.remove()
    check(len(rows) == len(mlps), f"{len(rows)} hooked layers of {len(mlps)}")
    check(abs(float(aux) - sum(r["module"] for r in rows)) <= AUX_WITNESS_TOL,
          f"the forward's aux {float(aux)} is not its layers' sum")
    return rows


def mixtral_train_args(data, root, steps):
    """``cli.train``'s arguments for phase 20 (b): Mixtral-8x7B LoRA r=16 on
    q/k/v/o over an int8 frozen base, phase 7's batch (micro-batch 4 x
    accum 2, seq 512, remat, lr 2e-4, warmup 2), no checkpoints."""
    return ["--model", "mixtral_8x7b", "--preset", "baseline", "--dataset-path", str(data),
            "--tokenizer", "byte", "--max-seq-len", "512", "--per-device-batch-size", "4",
            "--gradient-accumulation-steps", "2", "--lora-r", "16", "--quantize-base", "int8",
            "--learning-rate", "2e-4", "--warmup-steps", "2", "--logging-steps", "1",
            "--save-strategy", "no", "--max-steps", str(steps),
            "--metrics-csv", str(root / "metrics.csv"), "--output-dir", str(root / "ck")]


def mixtral_training(torch):
    """Phase 20 (b): the yardstick first, ``MIXTRAL_EAGER_STEPS`` eager steps
    through ``Trainer(cuda_graphs=False)`` on ``cli.train``'s own config and
    dataset (released); then ``cli.train`` as a subprocess for
    ``MIXTRAL_TRAIN_STEPS`` graphed steps from the same seeded int8 weights
    with a step log and a PEFT export. Its first steps' losses and grad norms
    must be bit-equal to the yardstick's; K1 2 x 32 x 2 launches a step, K2
    and K3 32 x 2; the load-balance loss finite and in ``AUX_PER_LAYER`` a
    layer, and equal to its plain recomputation (``mixtral_aux_witness``);
    every ``lora_b`` moved off zero."""
    import shutil
    import tempfile

    from dlti_tpu_torch.cli import train as cli_train
    from dlti_tpu_torch.data import get_tokenizer, make_batches
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.training import Trainer
    from dlti_tpu_torch.utils.safetensors import load_file

    root = Path(tempfile.mkdtemp(prefix="dlti-mixtral-"))
    perf = {}
    try:
        data = root / "data"
        data.mkdir()
        (data / "data.jsonl").write_text(
            "".join(json.dumps({"text": t}) + "\n" for t in training_texts()))
        args = cli_train.parse_args(mixtral_train_args(data, root, MIXTRAL_EAGER_STEPS))
        cfg = cli_train.build_config(args)
        mcfg = cfg.model
        check(mcfg.remat and mcfg.num_experts == 8 and cfg.train.quantize_frozen_base == "int8"
              and cfg.lora.r == 16, f"phase 20's config changed: {cfg}")
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, metrics_csv=""))
        dataset = make_batches(cli_train.load_texts(str(data)),
                               get_tokenizer(cfg.data.tokenizer),
                               seq_len=cfg.data.max_seq_len,
                               micro_batch_size=cfg.train.micro_batch_size,
                               grad_accum_steps=cfg.train.grad_accum_steps,
                               shuffle_seed=cfg.data.shuffle_seed,
                               pack=cfg.data.pack_sequences)
        free_memory(torch)
        tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
        trainer = Trainer(cfg, device="cuda", cuda_graphs=False)
        state, eager = trainer.train(dataset=dataset)
        torch.cuda.synchronize()
        eager_launches = flash_counts(tfa)
        # The router's loss from a second source, on the trained weights and
        # the first microbatch (its launches are not the main path's).
        first = next(dataset.epoch(0))
        check("segment_ids" not in first, "phase 20's rows are packed")
        witness = mixtral_aux_witness(
            torch, state.model, torch.as_tensor(first["input_ids"][0], device="cuda"),
            torch.as_tensor(first["loss_mask"][0], device="cuda"))
        # The subprocess needs the card: release the 46.7 GB base first.
        del state, trainer
        free_memory(torch)
        want_eager = flash_expected(mcfg.num_layers, cfg.train.grad_accum_steps,
                                    MIXTRAL_EAGER_STEPS)
        check(eager_launches == want_eager, f"eager flash launches {eager_launches} != "
              f"{want_eager}")
        perf["eager"] = {"losses": eager.losses, "grad_norms": eager.grad_norms,
                         "aux_losses": eager.aux_losses,
                         "step_ms": 1e3 * (sum(eager.step_times_s[1:])
                                           / max(len(eager.step_times_s) - 1, 1)),
                         "peak_memory_gb": eager.peak_memory_gb}
        log(f"[mixtral train-eager] losses {eager.losses}, grad norms {eager.grad_norms}, "
            f"aux {eager.aux_losses}; step {perf['eager']['step_ms']:.1f} ms (the second), "
            f"peak {eager.peak_memory_gb:.2f} GB; flash launches {eager_launches}")
        fmt = lambda key: " ".join(f"{r[key]:.3f}" for r in witness)  # noqa: E731
        log(f"[mixtral aux] by layer, the module's: {fmt('module')}")
        log(f"[mixtral aux] by layer, plain float64 on the same states: {fmt('plain')}")
        log(f"[mixtral aux] by layer, isotropic inputs through the same router: "
            f"{fmt('isotropic')}")
        log(f"[mixtral aux] by layer, the states' shared direction |mean unit|^2: "
            f"{fmt('shared')}")
        worst = max(abs(r["module"] - r["plain"]) for r in witness)
        log(f"[mixtral aux] module against plain: worst {worst:.3g} (tolerance "
            f"{AUX_WITNESS_TOL}); mean a layer {sum(r['module'] for r in witness) / len(witness):.4f}, "
            f"isotropic {sum(r['isotropic'] for r in witness) / len(witness):.4f}")
        check(worst <= AUX_WITNESS_TOL, f"the module's aux differs from the plain loss by {worst}")
        iso_out = [i for i, r in enumerate(witness)
                   if not AUX_ISOTROPIC[0] < r["isotropic"] < AUX_ISOTROPIC[1]]
        check(not iso_out, f"layers {iso_out}: isotropic aux outside {AUX_ISOTROPIC}")
        perf["aux_witness"] = witness
        for aux in eager.aux_losses:
            per_layer = aux / mcfg.num_layers
            check(math.isfinite(aux) and AUX_PER_LAYER[0] < per_layer < AUX_PER_LAYER[1],
                  f"aux_loss {aux} ({per_layer:.4f} a layer) outside {AUX_PER_LAYER} a layer")
        del eager, dataset

        steplog, peft = root / "steps.jsonl", root / "peft"
        cmd = ([sys.executable, "-m", "dlti_tpu_torch.cli.train"]
               + mixtral_train_args(data, root, MIXTRAL_TRAIN_STEPS)
               + ["--step-log", str(steplog), "--export-peft", str(peft)])
        summary, _ = run_train_cli(cmd, "[mixtral train]")
        run = quickstart_run_perf(summary, steplog)
        rows = [json.loads(ln) for ln in steplog.read_text().splitlines()]
        steps = [r for r in rows if r["type"] == "step"]
        losses = [r["loss"] for r in steps]
        norms = [r["grad_norm"] for r in steps]
        want = {"fwd": 2 * mcfg.num_layers * cfg.train.grad_accum_steps,
                "dq": mcfg.num_layers * cfg.train.grad_accum_steps,
                "dkv": mcfg.num_layers * cfg.train.grad_accum_steps}
        log(f"[mixtral train] {run['steps']} graphed steps ({run['captures']} capture): step "
            f"{run['step_ms']:.1f} ms, {run['tokens_per_s']:.1f} tokens/s, MFU "
            f"{run['mfu_percent']:.2f}% (4N FLOPs a token, N = {mcfg.num_active_params():,} "
            f"active, vs 989 TFLOP/s bf16), peak {run['peak_memory_gb']:.2f} GB; K1/K2/K3 "
            f"launches a step {run['launches_per_step']} (expected {want}); losses {losses}, "
            f"grad norms {norms}, final aux {summary.get('final_aux_loss')}")
        check(run["steps"] == MIXTRAL_TRAIN_STEPS and run["captures"] == 1,
              f"{run['steps']} steps, {run['captures']} captures")
        check(run["launches_per_step"] == {k: float(v) for k, v in want.items()},
              f"flash launches a step {run['launches_per_step']} != {want}")
        same = (losses[:MIXTRAL_EAGER_STEPS] == perf["eager"]["losses"]
                and norms[:MIXTRAL_EAGER_STEPS] == perf["eager"]["grad_norms"])
        log(f"[mixtral train] graphed steps 1-{MIXTRAL_EAGER_STEPS} against the eager "
            f"yardstick: losses and grad norms bit-equal: {same}")
        check(same, f"graphed {losses} / {norms} differ from eager "
              f"{perf['eager']['losses']} / {perf['eager']['grad_norms']}")
        aux = summary.get("final_aux_loss")
        check(aux is not None and math.isfinite(aux)
              and AUX_PER_LAYER[0] < aux / mcfg.num_layers < AUX_PER_LAYER[1],
              f"final aux_loss {aux}")
        check(all(math.isfinite(x) for x in losses + norms), "nonfinite loss or grad norm")
        factors = load_file(str(peft / "adapter_model.safetensors"))
        lora_b = {n: t for n, t in factors.items() if "lora_B" in n}
        check(len(lora_b) == 4 * mcfg.num_layers, f"{len(lora_b)} lora_B factors exported")
        still = [n for n, t in lora_b.items() if not t.abs().max().item() > 0]
        check(not still, f"lora_B still zero: {still[:3]}")
        perf["train"] = {**run, "losses": losses, "grad_norms": norms, "final_aux_loss": aux,
                         "active_params": mcfg.num_active_params(),
                         "bit_equal_to_eager": same}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return perf


def mixtral_int8_error(torch) -> dict:
    """Phase 20 (c): int8 weights against bf16 on one batch, Mixtral-8x7B at
    full width cut to ``MIXTRAL_INT8_ERR_LAYERS`` layers (the bf16 tree at
    full depth, 93 GB, does not fit the card): ``init_params(seed=0)`` and
    the same draw quantized, one no-grad forward each of
    ``MIXTRAL_INT8_ERR_BATCH`` prompts; the logits' largest difference
    relative to the bf16 logits' scale, and the argmax agreement."""
    import numpy as np

    from dlti_tpu_torch.config import MODEL_PRESETS
    from dlti_tpu_torch.models.interop import init_params, load_model
    from dlti_tpu_torch.models.quantization import quantize_params_int8

    cfg = dataclasses.replace(MODEL_PRESETS["mixtral_8x7b"],
                              num_layers=MIXTRAL_INT8_ERR_LAYERS)
    b, s = MIXTRAL_INT8_ERR_BATCH
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        3, cfg.vocab_size, (b, s))).to("cuda")
    params = init_params(cfg, seed=0, device="cuda")
    logits = {}
    for name in ("bf16", "int8"):
        if name == "int8":
            params = quantize_params_int8(params, donate=True)
        model = load_model(cfg, params, "cuda")
        with torch.no_grad():
            logits[name] = model(ids).float()
        del model
    del params
    ref, got = logits["bf16"], logits["int8"]
    check(bool(torch.isfinite(got).all()), "[mixtral int8] the int8 logits are not finite")
    scale = float(ref.abs().max())
    out = {"layers": cfg.num_layers, "max_abs_diff": float((got - ref).abs().max()),
           "scale": scale,
           "argmax_agree": float((got.argmax(-1) == ref.argmax(-1)).float().mean())}
    out["rel"] = out["max_abs_diff"] / scale
    log(f"[mixtral int8] {cfg.num_layers} layers at full width, {b} x {s} tokens: int8 "
        f"weights against bf16, logits max_abs_diff {out['max_abs_diff']:.4e} at scale "
        f"{scale:.4f} (rel {out['rel']:.3e}), argmax agreement {out['argmax_agree']:.4f} "
        f"(quantization error, not gated)")
    del logits, ref, got
    free_memory(torch)
    return out


def phase_mixtral(torch, card):
    """Phase 20: Mixtral-8x7B at full width and depth on one card, int8
    weights from the one-leaf-at-a-time seeded init: (a) served, then
    released; (b) trained with LoRA on the int8 base; (c) the int8 weights'
    error at 2 layers (:func:`mixtral_int8_error`)."""
    t_phase = time.perf_counter()
    free_memory(torch)
    perf = {"card": card, "serve": mixtral_serving(torch)}
    free_memory(torch)
    perf.update(mixtral_training(torch))
    perf["int8_error"] = mixtral_int8_error(torch)
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"[mixtral] card {card}; phase {perf['phase_s']:.1f} s")
    return perf



# ----------------------------------------------------------------------
# Phase 21: tensor parallelism
# ----------------------------------------------------------------------

# TP-2 against one rank in bfloat16: logits may part by what the
# row-parallel sums' rounding carries through 32 layers, relative to the
# logits' scale (as the kernel path against the gather path). It bounds the
# first step's logits, and each token's logprob teacher-forced: one rank
# prefills every prefix of what TP-2 decoded and scores its token.
TP_LOGITS_REL_TOL = LOGITS_REL_TOL
# The bf16 run (phase 3's first requests, greedy and seeded in turn, cut to
# fewer tokens; their prompts' first-step logits are compared too) and the
# int8-pool run: requests and tokens.
TP_REQUESTS, TP_TOKENS = 4, 16
TP_INT8_REQUESTS, TP_INT8_TOKENS = 4, 8
# The float32 run's depth, requests (phase 3's first) and tokens.
TP_F32_LAYERS, TP_F32_REQUESTS, TP_F32_TOKENS = 8, 4, 16
# TP-2 LoRA training against phase 7's eager steps (bfloat16, the same batch
# and seed): relative limits on the loss and the grad norm (PR 16's runs
# read 1.13e-4 and 1.16e-4).
# One step (two until phase 22's runs needed the room).
TP_TRAIN_STEPS = 1
TP_LOSS_RTOL, TP_GRAD_NORM_RTOL = 1e-3, 1e-3
# The tensor path in a NCCL group of one: graphed steps held bit-equal to
# phase 7's first steps.
TP_GRAPHED_STEPS = 4


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def prefill_arrays(prompts, cfg, block_size=16):
    """``EngineExecutor.prefill``'s arguments for ``prompts`` in rows of
    their own blocks (from block 1): ids, positions (-1 past the prompt),
    block tables and each row's last index."""
    import numpy as np

    bucket = 1 << (max(len(p) for p in prompts) - 1).bit_length()
    width = -(-bucket // block_size)
    ids = np.zeros((len(prompts), bucket), np.int32)
    pos = np.full((len(prompts), bucket), -1, np.int32)
    bt = np.zeros((len(prompts), width), np.int32)
    for r, p in enumerate(prompts):
        ids[r, :len(p)] = p
        pos[r, :len(p)] = np.arange(len(p))
        bt[r] = 1 + r * width + np.arange(width)
    return ids, pos, bt, np.array([len(p) - 1 for p in prompts], np.int32)


def tensor_serve(torch, mesh, cfg, ec, reqs, logit_prompts=()):
    """One TP engine on this rank (``mesh``'s part of ``init_params(seed=0)``,
    sliced as drawn, decoding eagerly: gloo); rank 0 computes the first-step
    logits of ``logit_prompts``, runs ``reqs`` and releases the follower,
    which follows. Returns this rank's K4/K4q launches and, on rank 0, the
    outputs, the logits, the decode steps and ms a step (CUDA events around
    each window)."""
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.serving.engine import EngineExecutor, InferenceEngine

    params = init_params(cfg, seed=0, device=mesh.device, mesh=mesh)
    ex = EngineExecutor(cfg, params, ec, device=mesh.device, cuda_graphs=False,
                        donate_params=True, mesh=mesh)
    engine = InferenceEngine(cfg, None, ec, device=mesh.device, executor=ex)
    del params
    kv_heads = engine.cache[0]["k"].shape[2]
    tpa.launches = tpa.launches_int8 = 0  # this rank's counts start here
    out = {"kv_heads": kv_heads, "weight_gb": sum(
        p.numel() * p.element_size() for p in ex.model.parameters()) / 1e9}
    if engine.follower:
        engine.follow()
    else:
        if logit_prompts:
            logits = ex.prefill(*prefill_arrays(logit_prompts, cfg))
            out["logits"] = logits.float().cpu().tolist()
        windows = []
        decode = ex.decode_window

        def timed(*args):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            res = decode(*args)
            b.record()
            windows.append((a, b))
            return res

        ex.decode_window = timed
        t0 = time.perf_counter()
        results = [engine.submit(p, sp) for p, sp in reqs]
        while engine.has_work:
            engine.step()
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        engine.stop_followers()
        del ex.decode_window
        out["decode_steps"] = engine.stats["decode_steps"]
        out["decode_step_ms"] = (sum(a.elapsed_time(b) for a, b in windows)
                                 / engine.stats["decode_steps"])
        out["outputs"] = [(r.output_token_ids, r.output_logprobs) for r in results]
    torch.cuda.synchronize()
    out["k4"], out["k4q"] = tpa.launches, tpa.launches_int8  # ... and are read here
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del engine, ex
    free_memory(torch)
    return out


def tensor_train(torch):
    """Phase 7's configuration at ``tensor`` 2 (LoRA r=16, seq 512,
    micro-batch 4 x accum 2, remat), ``TP_TRAIN_STEPS`` eager steps from
    phase 7's weights on phase 7's batches; this rank's launches and peak."""
    from dlti_tpu_torch.config import CheckpointConfig, ParallelConfig
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.training import Trainer

    cfg = train_config(CheckpointConfig(save_strategy="no"), max_steps=TP_TRAIN_STEPS)
    cfg = cfg.replace(parallel=ParallelConfig(tensor=2))
    dataset = make_batches(training_texts(), ByteTokenizer(), seq_len=cfg.data.max_seq_len,
                           micro_batch_size=cfg.train.micro_batch_size,
                           grad_accum_steps=cfg.train.grad_accum_steps)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, params=init_params(cfg.model, seed=0, device="cuda",
                                              lora=cfg.lora),
                      device="cuda", cuda_graphs=False)
    state = trainer.init_state()
    tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
    state, record = trainer.train(dataset=dataset, state=state)
    torch.cuda.synchronize()
    q = state.model.model.layers[0].attn.q_proj.kernel
    out = {"launches": flash_counts(tfa), "losses": record.losses,
           "grad_norms": record.grad_norms, "step_times_s": record.step_times_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "q_kernel_shape": list(q.shape),
           "heads": state.model.model.layers[0].attn.num_heads}
    del state, trainer
    free_memory(torch)
    return out


def tp_requests(cfg, n, tokens):
    """Phase 3's first ``n`` requests cut to ``tokens`` each."""
    return [(p, dataclasses.replace(sp, max_tokens=tokens))
            for p, sp in engine_requests(cfg)[:n]]


def tensor_rank_main(out_dir: str) -> int:
    """One rank of phase 21's TP-2 world (``launcher --one-device``: both on
    this card over gloo): (a) serving, (b) LoRA training. Writes its
    results to ``out_dir/rank{r}.json``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dlti_tpu_torch.cli.serve import parse_args, tensor_mesh
    from dlti_tpu_torch.config import MODEL_PRESETS

    t0 = time.perf_counter()
    mesh = tensor_mesh(parse_args(["--random-init", "llama2_7b", "--tensor", "2"]))
    cfg = MODEL_PRESETS["llama2_7b"]
    out = {"backend": dist.get_backend(), "device": str(mesh.device), "rank": mesh.rank,
           "start_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    reqs = tp_requests(cfg, TP_REQUESTS, TP_TOKENS)
    out["bf16"] = tensor_serve(torch, mesh, cfg, engine_config(), reqs,
                               [p for p, _ in reqs])
    f32 = dataclasses.replace(cfg, num_layers=TP_F32_LAYERS, dtype="float32",
                              param_dtype="float32")
    out["f32"] = tensor_serve(torch, mesh, f32, engine_config(cache_dtype="float32"),
                              tp_requests(cfg, TP_F32_REQUESTS, TP_F32_TOKENS))
    out["int8"] = tensor_serve(torch, mesh, cfg, engine_config(cache_dtype="int8"),
                               tp_requests(cfg, TP_INT8_REQUESTS, TP_INT8_TOKENS))
    out["serve_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["train"] = tensor_train(torch)
    out["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["seqpipe"] = seqpipe_world(torch)
    out["seqpipe_s"] = time.perf_counter() - t0
    with open(Path(out_dir) / f"rank{mesh.rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def teacher_forced(torch, ex, cfg, reqs, outputs, tag) -> dict:
    """Hold what a TP engine decoded (``outputs``: each request's tokens and
    logprobs) to one rank's executor ``ex`` teacher-forced: one prefill a
    request, a row for each token with every token before it, scores each
    token under one rank's unscaled distribution (what ``sample_tokens``
    reports). Every logprob must be within ``TP_LOGITS_REL_TOL`` of the
    logits' scale of one rank's; a greedy request's token must be one
    rank's argmax wherever one rank's top-2 margin exceeds that bound.
    Returns the worst difference, the bound and the positions checked."""
    rows, worst, scale = [], 0.0, 0.0
    for (prompt, sp), (toks, lps) in zip(reqs, outputs):
        check(len(toks) == sp.max_tokens, f"{tag} {len(toks)} tokens of {sp.max_tokens}")
        logits = ex.prefill(*prefill_arrays([prompt + toks[:j] for j in range(len(toks))],
                                            cfg)).float()
        top = torch.topk(logits, 2)
        one = torch.log_softmax(logits, -1)[torch.arange(len(toks)), torch.tensor(toks)]
        rows.append((sp.temperature == 0.0, toks, lps, one.tolist(),
                     (top.values[:, 0] - top.values[:, 1]).tolist(),
                     top.indices[:, 0].tolist()))
        scale = max(scale, float(logits.abs().max()))
    bound = TP_LOGITS_REL_TOL * scale
    held = 0
    for i, (greedy, toks, lps, one, margins, argmax) in enumerate(rows):
        for j, (tok, lp, ref, m, a) in enumerate(zip(toks, lps, one, margins, argmax)):
            worst = max(worst, abs(lp - ref))
            check(abs(lp - ref) <= bound, f"{tag} request {i} token {j}: logprob {lp:.4f} "
                  f"against one rank's {ref:.4f} teacher-forced (bound {bound:.4f})")
            if greedy and m > bound:
                held += 1
                check(tok == a, f"{tag} greedy request {i} token {j} is {tok}, one rank's "
                      f"argmax {a} leads by {m:.4f} > {bound:.4f}")
    return {"worst_logprob_diff": worst, "bound": bound, "scale": scale,
            "tokens": sum(len(r[1]) for r in rows), "greedy_margin_held": held,
            "min_margin": min(min(r[4]) for r in rows)}


def phase_tensor(torch, engine_perf, train_perf, card, ranks):
    """Phase 21, tensor parallelism on one card (before phase 22).

    (a)+(b): ``ranks``, the results of ``python -m dlti_tpu_torch.launcher
    --one-device --num-processes 2 -- python chip_smoke.py --tensor-rank
    DIR`` (:func:`start_world`, run beside phase 18): two ranks
    on this card over gloo (NCCL refuses two ranks on one device), each
    joining through ``cli.serve``'s ``--tensor 2`` mesh. (a) llama2_7b at
    full width and depth, bf16 pool, 16 of 32 heads a rank, eager decode:
    phase 3's first 4 requests (greedy and seeded) at 16 tokens, and their
    prompts' first-step logits; at 8 layers in float32 the same 4 at 16
    tokens; on an int8 pool 4 requests of 8 tokens (K4q). (b) Phase 7's
    LoRA training at ``tensor`` 2, 1 eager step; then phase 22's runs
    (:func:`seqpipe_world`). (c) In this process, a
    NCCL group of one with its tensor group (extent 1, every tensor
    collective issued): the decode graph over phase 3's 12 requests, tokens
    and logprobs equal to phase 3's; then phase 7's configuration for 4
    graphed steps, losses and grad norms bit-equal to phase 7's. Held:
    (a)'s first-step logits within ``TP_LOGITS_REL_TOL`` of the tensor-1
    engine's, relative to their scale; every token TP-2 decoded on the bf16
    and the int8 pool scored teacher-forced by one rank on the same pool
    type (:func:`teacher_forced`); the float32 tokens equal to a one-rank
    engine's; each rank's K4 32 x decode steps (K4q on the int8 pool);
    (b)'s losses and grad norms within ``TP_LOSS_RTOL``/``TP_GRAD_NORM_RTOL``
    of phase 7's eager steps, K1-K3 as phase 7 counts them on each rank."""
    import torch.distributed as dist

    from dlti_tpu_torch.config import MODEL_PRESETS, CheckpointConfig, ParallelConfig
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.launcher import init_group_of_one
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.parallel.mesh import build_mesh
    from dlti_tpu_torch.serving.engine import EngineExecutor, InferenceEngine
    from dlti_tpu_torch.training import Trainer

    cfg = MODEL_PRESETS["llama2_7b"]
    layers = cfg.num_layers
    reqs = engine_requests(cfg)
    perf = {"card": card}
    try:
        # (a) + (b): the TP-2 world on this card.
        for ln in ranks[0]["joined"]:
            log(f"[tensor] {ln}")
        perf["world_s"] = ranks[0]["world_s"]
        perf["world_parts_s"] = {k: ranks[0][k]
                                 for k in ("start_s", "serve_s", "train_s", "seqpipe_s")}
        # Phase 22's runs in this world, held there.
        perf["seqpipe_ranks"] = [r.pop("seqpipe") for r in ranks]
        perf["world_parts_s"].update({f"{name}_wall_s": ranks[0][name]["wall_s"]
                                      for name in ("bf16", "f32", "int8")})
        log(f"[tensor] the TP-2 world took {perf['world_s']:.1f} s (beside phase 18): "
            + json.dumps(perf["world_parts_s"]))
        check(all(r["backend"] == "gloo" and r["device"] == "cuda:0" for r in ranks),
              f"[tensor] the ranks ran {[(r['backend'], r['device']) for r in ranks]}")
        lead = ranks[0]
        for name, heads in (("bf16", 16), ("f32", 16), ("int8", 16)):
            run = lead[name]
            check(all(r[name]["kv_heads"] == heads for r in ranks),
                  f"[tensor] {name}: KV heads a rank {[r[name]['kv_heads'] for r in ranks]}")
            kind = "k4q" if name == "int8" else "k4"
            want = (TP_F32_LAYERS if name == "f32" else layers) * run["decode_steps"]
            got = [r[name][kind] for r in ranks]
            other = [r[name]["k4" if kind == "k4q" else "k4q"] for r in ranks]
            check(got == [want, want] and other == [0, 0],
                  f"[tensor] {name}: {kind} launches by rank {got} (others {other}), "
                  f"expected {want} on each")
        bf = lead["bf16"]
        log(f"[tensor] (a) TP-2 llama2_7b bf16 pool, 16 of 32 heads a rank, eager over "
            f"gloo: {bf['decode_steps']} decode steps, {bf['decode_step_ms']:.2f} ms a "
            f"step (CUDA events around each window; phase 3's graphed k 1: "
            f"{engine_perf['decode_step_ms']:.2f} ms), K4 {bf['k4']} a rank; weights "
            f"{bf['weight_gb']:.2f} GB a rank, peaks {[round(r['bf16']['peak_gb'], 2) for r in ranks]} GB")
        tr = lead["train"]
        want = flash_expected(layers, 2, TP_TRAIN_STEPS)
        check(all(r["train"]["launches"] == want for r in ranks),
              f"[tensor] (b) flash launches by rank {[r['train']['launches'] for r in ranks]}, "
              f"expected {want} on each")
        check(tr["heads"] == 16 and tr["q_kernel_shape"] == [4096, 2048],
              f"[tensor] (b) rank 0 holds {tr['heads']} heads, q {tr['q_kernel_shape']}")
        check(ranks[1]["train"]["losses"] == tr["losses"], "[tensor] (b) ranks' losses differ")
        ref_l = train_perf["eager"]["losses"][:TP_TRAIN_STEPS]
        ref_g = train_perf["eager"]["grad_norms"][:TP_TRAIN_STEPS]
        dl = max(abs(a - b) / abs(b) for a, b in zip(tr["losses"], ref_l))
        dg = max(abs(a - b) / abs(b) for a, b in zip(tr["grad_norms"], ref_g))
        log(f"[tensor] (b) TP-2 LoRA r=16, {TP_TRAIN_STEPS} eager step over gloo: losses "
            f"{tr['losses']} "
            f"(phase 7 eager {ref_l}, worst relative {dl:.2e}), grad norms "
            f"{tr['grad_norms']} ({ref_g}, {dg:.2e}); step times {tr['step_times_s']} s; "
            f"K1-K3 {tr['launches']} a rank; peaks "
            f"{[round(r['train']['peak_gb'], 2) for r in ranks]} GB a rank")
        check(dl <= TP_LOSS_RTOL and dg <= TP_GRAD_NORM_RTOL,
              f"[tensor] (b) loss {dl:.2e} / grad norm {dg:.2e} beyond "
              f"{TP_LOSS_RTOL} / {TP_GRAD_NORM_RTOL}")

        # (c): the tensor path in a NCCL group of one, in this process.
        t0 = time.perf_counter()
        dev = torch.device("cuda", torch.cuda.current_device())
        init_group_of_one(dev)
        mesh = build_mesh(ParallelConfig(), dev, tensor_group=True)
        check(mesh.tensor_parallel and dist.get_backend(mesh.tensor_group) == "nccl",
              "[tensor] (c) no NCCL tensor group")
        engine = InferenceEngine(cfg, init_params(cfg, seed=0, device="cuda"),
                                 engine_config(), device="cuda", mesh=mesh)
        engine.warmup_decode_ladder()
        tpa.launches = 0
        results = [engine.submit(p, sp) for p, sp in reqs]
        while engine.has_work:
            engine.step()
        torch.cuda.synchronize()
        k4 = tpa.launches
        got = [(r.output_token_ids, r.output_logprobs) for r in results]
        check(k4 == layers * engine.stats["decode_steps"],
              f"[tensor] (c) K4 {k4} != {layers} x {engine.stats['decode_steps']}")
        check(got == engine_perf["outputs"], "[tensor] (c) the group-of-one decode graph's "
              "tokens or logprobs differ from phase 3's")
        log(f"[tensor] (c) the tensor path in a NCCL group of one, decode graph: phase 3's "
            f"12 requests token- and logprob-identical; K4 {k4}")
        # (a)'s checks against this engine (the single rank's arithmetic).
        ex = engine.executor
        tp_reqs = tp_requests(cfg, TP_REQUESTS, TP_TOKENS)
        one = ex.prefill(*prefill_arrays([p for p, _ in tp_reqs], cfg))
        two = torch.tensor(bf["logits"], device="cuda")
        scale = float(one.abs().max())
        diff = float((two - one.float()).abs().max())
        perf["logits"] = {"max_abs_diff": diff, "scale": scale, "rel": diff / scale}
        check(diff <= TP_LOGITS_REL_TOL * scale,
              f"[tensor] (a) first-step logits part by {diff} (scale {scale})")
        forced = teacher_forced(torch, ex, cfg, tp_reqs, bf["outputs"], "[tensor] (a) bf16")
        perf["bf16"] = {"teacher_forced": forced, "decode_step_ms": bf["decode_step_ms"],
                        "decode_steps": bf["decode_steps"], "k4_a_rank": bf["k4"],
                        "phase3_decode_step_ms": engine_perf["decode_step_ms"]}
        log(f"[tensor] (a) logits worst {diff:.4f} at scale {scale:.2f} "
            f"({diff / scale:.2e} relative, limit {TP_LOGITS_REL_TOL}); teacher-forced over "
            f"{forced['tokens']} tokens of {TP_REQUESTS} requests (greedy and seeded): "
            f"logprobs within {forced['worst_logprob_diff']:.4f} of one rank's (bound "
            f"{forced['bound']:.4f}); greedy tokens one rank's argmax at "
            f"{forced['greedy_margin_held']} positions past the bound (smallest one-rank "
            f"top-2 margin {forced['min_margin']:.4f})")
        del engine, ex, one, two
        free_memory(torch)
        int8_ex = EngineExecutor(cfg, init_params(cfg, seed=0, device="cuda"),
                                 engine_config(cache_dtype="int8"), device="cuda",
                                 cuda_graphs=False, donate_params=True)
        forced = teacher_forced(torch, int8_ex, cfg,
                                tp_requests(cfg, TP_INT8_REQUESTS, TP_INT8_TOKENS),
                                lead["int8"]["outputs"], "[tensor] (a) int8 pool")
        perf["int8"] = {"teacher_forced": forced, "k4q_a_rank": lead["int8"]["k4q"]}
        log(f"[tensor] (a) int8 pool, K4q at 16 KV heads a rank: teacher-forced over "
            f"{forced['tokens']} tokens against one rank's int8 pool, logprobs within "
            f"{forced['worst_logprob_diff']:.4f} (bound {forced['bound']:.4f}); greedy tokens "
            f"one rank's argmax at {forced['greedy_margin_held']} positions past the bound")
        del int8_ex
        free_memory(torch)
        f32 = dataclasses.replace(cfg, num_layers=TP_F32_LAYERS, dtype="float32",
                                  param_dtype="float32")
        single = card_engine(f32, init_params(f32, seed=0, device="cuda"),
                             engine_config(cache_dtype="float32"))
        results = [single.submit(p, sp)
                   for p, sp in tp_requests(cfg, TP_F32_REQUESTS, TP_F32_TOKENS)]
        while single.has_work:
            single.step()
        f32_same = [r.output_token_ids for r in results] == [
            t for t, _ in lead["f32"]["outputs"]]
        check(f32_same, "[tensor] (a) float32 TP-2 tokens differ from one rank's")
        log(f"[tensor] (a) {TP_F32_LAYERS} layers float32: TP-2 tokens identical to one "
            f"rank's over {TP_F32_REQUESTS} requests")
        del single
        free_memory(torch)

        tcfg = train_config(CheckpointConfig(save_strategy="no"), max_steps=TP_GRAPHED_STEPS)
        tmesh = build_mesh(tcfg.parallel, dev, True, tensor_group=True)
        dataset = make_batches(training_texts(), ByteTokenizer(),
                               seq_len=tcfg.data.max_seq_len,
                               micro_batch_size=tcfg.train.micro_batch_size,
                               grad_accum_steps=tcfg.train.grad_accum_steps)
        trainer = Trainer(tcfg, params=init_params(tcfg.model, seed=0, device="cuda",
                                                   lora=tcfg.lora),
                          device="cuda", mesh=tmesh)
        state = trainer.init_state()
        tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
        state, record = trainer.train(dataset=dataset, state=state)
        torch.cuda.synchronize()
        launches = flash_counts(tfa)
        want = flash_expected(layers, 2, TP_GRAPHED_STEPS + record.captures)
        check(record.captures == 1 and launches == want,
              f"[tensor] (c) {record.captures} captures, launches {launches} != {want}")
        same = (record.losses == train_perf["losses"][:TP_GRAPHED_STEPS]
                and record.grad_norms == train_perf["grad_norms"][:TP_GRAPHED_STEPS])
        log(f"[tensor] (c) {TP_GRAPHED_STEPS} graphed steps in the NCCL group of one: "
            f"losses {record.losses}, bit-equal to phase 7's: {same}; K1-K3 {launches}; "
            f"step {1e3 * record.step_time_s:.1f} ms (phase 7 {train_perf['step_ms']:.1f})")
        check(same, f"[tensor] (c) losses {record.losses} / grad norms {record.grad_norms} "
              f"differ from phase 7's")
        perf["graphed_train"] = {"losses": record.losses, "step_ms": 1e3 * record.step_time_s,
                                 "launches": launches}
        perf["group_of_one_s"] = time.perf_counter() - t0
        del state, trainer
        free_memory(torch)
        perf["train"] = {k: tr[k] for k in ("losses", "grad_norms", "step_times_s")}
        perf["train"].update(loss_rel=dl, grad_norm_rel=dg,
                             peaks_gb=[r["train"]["peak_gb"] for r in ranks],
                             launches_a_rank=tr["launches"],
                             phase7_eager_step_ms=train_perf["eager"]["step_ms"])
        perf["serve_peaks_gb"] = [r["bf16"]["peak_gb"] for r in ranks]
        perf["launches"] = {"paged_decode_attention": bf["k4"] + lead["f32"]["k4"],
                            "paged_decode_attention_int8": lead["int8"]["k4q"],
                            **tr["launches"]}
        return perf
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ----------------------------------------------------------------------
# Phase 22: sequence and pipeline parallelism on one card
# ----------------------------------------------------------------------

# (a) SP-2: LoRA r=16 at seq 4096 (packed rows of phase 7's texts), micro-batch
# 1 x accum 2, 2 steps; (b) PP-2: 16 layers a stage on phase 7's 8 rows of 512
# as 8 microbatches of 1 row, 2 steps. Both over gloo, eager.
SP_SEQ = 4096
SP_ACCUM = 2
PP_MICRO = 8
SEQPIPE_STEPS = 1  # 2 until phase 23 needed the room
# Loss and grad norm against one rank's step on the same rows (relative).
SEQPIPE_RTOL = 1e-3


def seqpipe_config(kind: str, parallel: bool):
    """Phase 22's configurations (phase 7's model, LoRA and optimizer):
    ``"sp"`` at seq ``SP_SEQ``, micro-batch 1 x accum ``SP_ACCUM``, on
    ``sequence`` 2 (``parallel``) or one rank; ``"pp"`` at seq 512,
    micro-batch 1 x accum ``PP_MICRO``, on ``pipe`` 2 or one rank."""
    from dlti_tpu_torch.config import CheckpointConfig, ParallelConfig

    cfg = train_config(CheckpointConfig(save_strategy="no"), max_steps=SEQPIPE_STEPS)
    if kind == "sp":
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, max_seq_len=SP_SEQ),
                          train=dataclasses.replace(cfg.train, micro_batch_size=1,
                                                    grad_accum_steps=SP_ACCUM))
        par = ParallelConfig(sequence=2)
    else:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, micro_batch_size=1,
                                                    grad_accum_steps=PP_MICRO))
        par = ParallelConfig(pipe=2)
    return cfg.replace(parallel=par) if parallel else cfg


def seqpipe_dataset(cfg):
    """``"sp"``: phase 7's texts packed into rows of ``SP_SEQ`` (segment ids
    and per-document positions ride the ring); ``"pp"``: phase 7's rows."""
    from dlti_tpu_torch.data import ByteTokenizer, make_batches

    return make_batches(training_texts(), ByteTokenizer(), seq_len=cfg.data.max_seq_len,
                        micro_batch_size=cfg.train.micro_batch_size,
                        grad_accum_steps=cfg.train.grad_accum_steps,
                        pack=cfg.data.max_seq_len == SP_SEQ)


def seqpipe_train(torch, cfg, params) -> dict:
    """``SEQPIPE_STEPS`` eager steps of ``cfg`` from ``params`` (fresh LoRA
    factors each run): losses, grad norms, step times, this process's peak
    and the flash kernels' launches."""
    from dlti_tpu_torch.models.lora import is_lora_name
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.training import Trainer

    fresh = {n: t.clone() if is_lora_name(n) else t for n, t in params.items()}
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, params=fresh, device="cuda", cuda_graphs=False)
    del fresh
    state = trainer.init_state()
    tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
    t0 = time.perf_counter()
    state, record = trainer.train(dataset=seqpipe_dataset(cfg), state=state)
    torch.cuda.synchronize()
    out = {"losses": record.losses, "grad_norms": record.grad_norms,
           "step_times_s": record.step_times_s, "train_s": time.perf_counter() - t0,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": flash_counts(tfa), "layers": len(state.model.model.layers),
           "strategy": record.strategy, "world": record.world}
    del state, trainer
    free_memory(torch)
    return out


def seqpipe_world(torch) -> dict:
    """This rank's part of phase 22, run in phase 21's world (both ranks on
    this card over gloo) after its tensor-parallel runs: llama2_7b drawn
    once, then (a) SP-2 and (b) PP-2."""
    from dlti_tpu_torch.models.interop import init_params

    t0 = time.perf_counter()
    cfg = seqpipe_config("sp", True)
    params = init_params(cfg.model, seed=0, device="cuda", lora=cfg.lora)
    out = {"draw_s": time.perf_counter() - t0}
    for kind in ("sp", "pp"):
        out[kind] = seqpipe_train(torch, seqpipe_config(kind, True), params)
    del params
    free_memory(torch)
    return out


def rel_diff(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def phase_seqpipe(torch, train_perf, card, ranks):
    """Phase 22, sequence and pipeline parallelism on one card (run last).

    The two ranks of phase 21's world (``launcher --one-device``: both on
    this card over gloo) ran, after its tensor-parallel runs, llama2_7b
    drawn once a rank: (a) ``SEQPIPE_STEPS`` eager steps at ``sequence`` 2,
    seq ``SP_SEQ`` (packed rows, micro-batch 1 x accum ``SP_ACCUM``; each
    rank 2048 tokens of every row, attention the ring's plain arithmetic)
    and (b) at ``pipe`` 2 (16 layers a stage, GPipe over phase 7's rows as
    ``PP_MICRO`` microbatches of 1 row); ``ranks`` holds their results.
    Here one rank's eager references from phase 7's weights on the same
    rows and microbatches (attention through K1-K3; graphed they took
    longer, the capture of 8 microbatches dearer than 2 eager steps).
    Held: each run's losses and grad norms
    within ``SEQPIPE_RTOL`` of the one-rank run's, the ranks' equal; (b)'s
    losses within ``SEQPIPE_RTOL`` of phase 7's (the same rows; LoRA's
    ``lora_b`` is 0 through step 2, so the loss does not see dropout's
    masks, which follow the microbatches); K1-K3 counted on each stage,
    twice a layer forward under remat, and none under the ring."""
    from dlti_tpu_torch.models.interop import init_params

    perf = {"card": card}
    t0 = time.perf_counter()
    cfg = seqpipe_config("sp", False)
    params = init_params(cfg.model, seed=0, device="cuda", lora=cfg.lora)
    ref = {kind: seqpipe_train(torch, seqpipe_config(kind, False), params)
           for kind in ("sp", "pp")}
    # Phase 23 (b)'s one-rank reference on its microbatches (LoRA dropout
    # follows the microbatches, so the 8 x 1 step's grad norm is another).
    ref["zero3_pp"] = seqpipe_train(torch, zero3_config("pp", False), params)
    del params
    free_memory(torch)
    perf["reference_s"] = time.perf_counter() - t0
    layers = MODEL_LAYERS
    for kind, tag in (("sp", "(a) SP-2"), ("pp", "(b) PP-2")):
        got, one = ranks[0][kind], ref[kind]
        check(ranks[1][kind]["losses"] == got["losses"]
              and ranks[1][kind]["grad_norms"] == got["grad_norms"],
              f"[seqpipe] {tag}: the ranks' losses or grad norms differ")
        dl = rel_diff(got["losses"], one["losses"])
        dg = rel_diff(got["grad_norms"], one["grad_norms"])
        perf[kind] = {
            "losses": got["losses"], "grad_norms": got["grad_norms"],
            "one_rank_losses": one["losses"], "one_rank_grad_norms": one["grad_norms"],
            "loss_rel": dl, "grad_norm_rel": dg,
            "step_times_s": [r[kind]["step_times_s"] for r in ranks],
            "peaks_gb": [r[kind]["peak_gb"] for r in ranks],
            "launches_a_rank": [r[kind]["launches"] for r in ranks],
            "train_s": [r[kind]["train_s"] for r in ranks],
            "one_rank_step_times_s": one["step_times_s"],
            "one_rank_peak_gb": one["peak_gb"], "one_rank_launches": one["launches"],
            "strategy": got["strategy"], "world": got["world"]}
        log(f"[seqpipe] {tag} LoRA r=16, {SEQPIPE_STEPS} eager steps over gloo: losses "
            f"{got['losses']} (one rank {one['losses']}, worst relative {dl:.2e}), "
            f"grad norms {got['grad_norms']} ({one['grad_norms']}, {dg:.2e}); step times by "
            f"rank {perf[kind]['step_times_s']} s (one rank {one['step_times_s']}); "
            f"peaks {[round(x, 2) for x in perf[kind]['peaks_gb']]} GB (one rank "
            f"{one['peak_gb']:.2f}); K1-K3 by rank {perf[kind]['launches_a_rank']} "
            f"(one rank {one['launches']})")
        check(dl <= SEQPIPE_RTOL and dg <= SEQPIPE_RTOL,
              f"[seqpipe] {tag}: loss {dl:.2e} / grad norm {dg:.2e} beyond {SEQPIPE_RTOL}")
    none = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    check(perf["sp"]["launches_a_rank"] == [none, none],
          f"[seqpipe] (a) flash launched under the ring: {perf['sp']['launches_a_rank']}")
    check(ref["sp"]["launches"] == flash_expected(layers, SP_ACCUM, SEQPIPE_STEPS),
          f"[seqpipe] (a) one rank's flash launches {ref['sp']['launches']}")
    want = flash_expected(layers // 2, PP_MICRO, SEQPIPE_STEPS)
    check(all(r["pp"]["launches"] == want and r["pp"]["layers"] == layers // 2
              for r in ranks),
          f"[seqpipe] (b) flash launches by stage {perf['pp']['launches_a_rank']}, "
          f"expected {want} on each")
    p7 = train_perf["losses"][:SEQPIPE_STEPS]
    d7 = rel_diff(perf["pp"]["losses"], p7)
    perf["pp"].update(phase7_losses=p7, phase7_loss_rel=d7,
                      phase7_grad_norms=train_perf["grad_norms"][:SEQPIPE_STEPS])
    log(f"[seqpipe] (b) losses against phase 7's on the same rows {p7}: worst relative "
        f"{d7:.2e}; grad norms {perf['pp']['grad_norms']} (phase 7's "
        f"{perf['pp']['phase7_grad_norms']}: other dropout masks, microbatches of 1 row "
        f"against 4)")
    check(d7 <= SEQPIPE_RTOL, f"[seqpipe] (b) loss {d7:.2e} off phase 7's")
    perf["launches"] = dict(want)
    perf["draw_s"] = [r["draw_s"] for r in ranks]
    log(f"[seqpipe] references {perf['reference_s']:.1f} s here; in phase 21's world the "
        f"7B draw {perf['draw_s']} s, (a) {perf['sp']['train_s']} s, (b) "
        f"{perf['pp']['train_s']} s")
    perf["references"] = {kind: {k: ref[kind][k] for k in ("losses", "grad_norms")}
                          for kind in ("pp", "zero3_pp")}
    return perf


# ----------------------------------------------------------------------
# Phase 23: ZeRO-3 with the model axes on one card
# ----------------------------------------------------------------------

# One eager step a run: (a) fsdp 2 x tensor 2 on phase 7's batch; (b) fsdp 2
# x pipe 2 on phase 22 (b)'s 8 rows, 4 rows a microbatch (2 a fsdp rank) x 2
# (2 x 4 until the room was needed: each microbatch gathers every stage's
# base twice through gloo).
ZERO3_STEPS = 1
ZERO3_PP_MICRO, ZERO3_PP_ACCUM = 4, 2
# Loss and grad norm against the one-rank references (relative), as phases
# 21-22 hold theirs.
ZERO3_RTOL = 1e-3
# A rank's parameter bytes at rest over the whole model's: a quarter, plus
# the leaves fsdp alone halves (norms, and under pipe the embedding and the
# head every stage holds).
ZERO3_REST_SHARE = (0.24, 0.28)


def zero3_config(kind: str, parallel: bool = True):
    """Phase 23's configurations (phase 7's model, LoRA and optimizer, 1
    step): ``"tp"`` phase 7's batch at ``zero3``, ``fsdp`` 2 x ``tensor`` 2;
    ``"pp"`` micro-batch 4 x accum 2 at ``zero3``, ``fsdp`` 2 x ``pipe`` 2, or
    (not ``parallel``) on one rank."""
    from dlti_tpu_torch.config import CheckpointConfig, ParallelConfig, ZeROStage

    cfg = train_config(CheckpointConfig(save_strategy="no"), max_steps=ZERO3_STEPS)
    z3 = ZeROStage.ZERO3
    if kind == "tp":
        return cfg.replace(parallel=ParallelConfig(zero_stage=z3, fsdp=2, tensor=2))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, micro_batch_size=ZERO3_PP_MICRO,
                                                grad_accum_steps=ZERO3_PP_ACCUM))
    return cfg.replace(parallel=ParallelConfig(zero_stage=z3, fsdp=2, pipe=2)) if parallel else cfg


def zero3_train(torch, cfg) -> dict:
    """``ZERO3_STEPS`` eager steps of ``cfg`` on this rank of phase 23's
    world: llama2_7b drawn leaf by leaf, this rank's part of each leaf kept
    (``init_params(mesh=)``); the parameter bytes at rest against the whole
    model's, the peak, step times, losses and the flash kernels' launches."""
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.parallel.mesh import build_mesh
    from dlti_tpu_torch.training import Trainer

    mesh = build_mesh(cfg.parallel, torch.device("cuda", torch.cuda.current_device()),
                      cfg.lora.enabled)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg.model, seed=0, device="cuda", lora=cfg.lora, mesh=mesh)
    trainer = Trainer(cfg, params=params, device="cuda", cuda_graphs=False, mesh=mesh)
    del params
    state = trainer.init_state()
    draw_s = time.perf_counter() - t0
    named = dict(state.model.named_parameters())
    rest = sum(p.numel() * p.element_size() for p in named.values())
    whole = sum(math.prod(pl.shape) * named[n].element_size() * (mesh.pp if pl.stage else 1)
                for n, pl in state.layout.leaves.items())
    if cfg.parallel.pipe > 1:
        dataset = seqpipe_dataset(cfg)
    else:
        dataset = make_batches(training_texts(), ByteTokenizer(), seq_len=cfg.data.max_seq_len,
                               micro_batch_size=cfg.train.micro_batch_size,
                               grad_accum_steps=cfg.train.grad_accum_steps)
    tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
    t0 = time.perf_counter()
    state, record = trainer.train(dataset=dataset, state=state)
    torch.cuda.synchronize()
    out = {"losses": record.losses, "grad_norms": record.grad_norms,
           "step_times_s": record.step_times_s, "train_s": time.perf_counter() - t0,
           "draw_s": draw_s, "rest_gb": rest / 1e9, "whole_gb": whole / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": flash_counts(tfa),
           "layers": len(state.model.model.layers), "strategy": record.strategy,
           "world": record.world,
           "q_kernel_shape": list(state.model.model.layers[0].attn.q_proj.kernel.shape)}
    del state, trainer, named
    free_memory(torch)
    return out


def zero3_rank_main(out_dir: str) -> int:
    """One rank of phase 23's world (``launcher --one-device
    --num-processes 4``: every rank on this card over gloo): (a), then (b).
    Writes its results to ``out_dir/rank{r}.json``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dlti_tpu_torch import launcher

    t0 = time.perf_counter()
    launcher.maybe_initialize_from_env("cuda")
    rank = dist.get_rank()
    out = {"backend": dist.get_backend(), "device": f"cuda:{torch.cuda.current_device()}",
           "rank": rank, "start_s": time.perf_counter() - t0}
    for kind in ("tp", "pp"):
        out[kind] = zero3_train(torch, zero3_config(kind))
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def start_world(flag: str, ranks: int) -> dict:
    """Start a world of ``ranks`` ranks on this card over gloo (``launcher
    --one-device``), each ``chip_smoke.py flag DIR``, in the background:
    phase 23's (``--zero3-rank``) beside phase 17 and phase 21's
    (``--tensor-rank``) beside phase 18, whose work leaves the card and the
    host room; :func:`finish_world` collects it."""
    import os
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="world-")
    cmd = [sys.executable, "-m", "dlti_tpu_torch.launcher", "--one-device",
           "--num-processes", str(ranks), "--port", str(free_port()), "--",
           sys.executable, str(ROOT / "chip_smoke.py"), flag, out_dir]
    # Output to a file: nothing reads a pipe while the phases beside it run.
    with open(Path(out_dir) / "world.log", "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                                env=dict(os.environ, PYTHONPATH=str(ROOT)))
    return {"proc": proc, "dir": out_dir, "ranks": ranks, "t0": time.perf_counter()}


def finish_world(world: dict, tag: str, abort: bool = False) -> list:
    """Wait for a :func:`start_world` world (at most 600 s from its start)
    and return its ranks' results, each with the world's wall clock and the
    launcher's lines saying how each rank joined; ``abort``: stop it at once (a phase
    beside it failed). Every process it started is gone on return."""
    import shutil

    proc, out_dir = world["proc"], Path(world["dir"])
    try:
        if abort:
            return []
        proc.wait(timeout=max(1.0, 600 - (time.perf_counter() - world["t0"])))
        world_s = time.perf_counter() - world["t0"]
        out = (out_dir / "world.log").read_text()
        check(proc.returncode == 0,
              f"{tag} the world of {world['ranks']} exited {proc.returncode}:\n" + out[-8000:])
        joined = [ln for ln in out.splitlines()
                  if ln.startswith("rank ") and "process group over" in ln]
        ranks = [json.load(open(out_dir / f"rank{r}.json")) for r in range(world["ranks"])]
        return [dict(r, world_s=world_s, joined=joined) for r in ranks]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)


def phase_zero3(train_perf, card, pp_refs, ranks):
    """Phase 23, ZeRO-3 with the model axes on one card (run last): the
    results of the world of four ranks (:func:`start_world`, run
    beside phase 17), held to phase 7's eager step ((a)) and to phase 22's
    references ((b): ``pp_refs``, the 8 x 1 reference and one rank's step
    on (b)'s microbatches)."""
    perf = {"card": card, "world_s": ranks[0]["world_s"]}
    check(all(r["backend"] == "gloo" and r["device"] == "cuda:0" for r in ranks),
          f"[zero3] the ranks ran {[(r['backend'], r['device']) for r in ranks]}")
    refs = {"tp": {"losses": train_perf["eager"]["losses"][:ZERO3_STEPS],
                   "grad_norms": train_perf["eager"]["grad_norms"][:ZERO3_STEPS],
                   "name": "phase 7's eager step"},
            "pp": dict(pp_refs["zero3_pp"], name="one rank on the same microbatches")}
    want = {"tp": (MODEL_LAYERS, flash_expected(MODEL_LAYERS, 2, ZERO3_STEPS)),
            "pp": (MODEL_LAYERS // 2,
                   flash_expected(MODEL_LAYERS // 2, ZERO3_PP_ACCUM, ZERO3_STEPS))}
    for kind, tag in (("tp", "(a) fsdp 2 x tensor 2"), ("pp", "(b) fsdp 2 x pipe 2")):
        got, ref = ranks[0][kind], refs[kind]
        check(all(r[kind]["losses"] == got["losses"]
                  and r[kind]["grad_norms"] == got["grad_norms"] for r in ranks),
              f"[zero3] {tag}: the ranks' losses or grad norms differ")
        check(all(r[kind]["strategy"] == "zero3" if kind == "tp" else
                  r[kind]["strategy"] == "pipe2" for r in ranks)
              and got["world"] == 4, f"[zero3] {tag}: {got['strategy']} over {got['world']}")
        dl = rel_diff(got["losses"], ref["losses"])
        dg = rel_diff(got["grad_norms"], ref["grad_norms"])
        shares = [r[kind]["rest_gb"] / r[kind]["whole_gb"] for r in ranks]
        layers, launches = want[kind]
        perf[kind] = {
            "losses": got["losses"], "grad_norms": got["grad_norms"],
            "reference": ref["name"], "reference_losses": ref["losses"],
            "reference_grad_norms": ref["grad_norms"], "loss_rel": dl, "grad_norm_rel": dg,
            "step_times_s": [r[kind]["step_times_s"] for r in ranks],
            "rest_gb": [r[kind]["rest_gb"] for r in ranks], "whole_gb": got["whole_gb"],
            "rest_share": shares, "peaks_gb": [r[kind]["peak_gb"] for r in ranks],
            "launches_a_rank": [r[kind]["launches"] for r in ranks],
            "draw_s": [r[kind]["draw_s"] for r in ranks],
            "train_s": [r[kind]["train_s"] for r in ranks],
            "q_kernel_shape": got["q_kernel_shape"]}
        for r in ranks:
            x = r[kind]
            log(f"[zero3] {tag} rank {r['rank']}: parameters at rest {x['rest_gb']:.3f} GB "
                f"of the model's {x['whole_gb']:.3f} GB ({x['rest_gb'] / x['whole_gb']:.4f}), "
                f"peak {x['peak_gb']:.2f} GB, step {x['step_times_s']} s, K1-K3 "
                f"{x['launches']}, q_proj kernel {x['q_kernel_shape']}; card {card}")
        log(f"[zero3] {tag} LoRA r=16, {ZERO3_STEPS} eager step over gloo: losses "
            f"{got['losses']} ({ref['name']} {ref['losses']}, relative {dl:.2e}), grad "
            f"norms {got['grad_norms']} ({ref['grad_norms']}, {dg:.2e})")
        check(dl <= ZERO3_RTOL and dg <= ZERO3_RTOL,
              f"[zero3] {tag}: loss {dl:.2e} / grad norm {dg:.2e} beyond {ZERO3_RTOL}")
        lo, hi = ZERO3_REST_SHARE
        check(all(lo <= x <= hi for x in shares),
              f"[zero3] {tag}: parameter bytes at rest {shares} of the model's, not "
              f"within {ZERO3_REST_SHARE}")
        check(all(r[kind]["launches"] == launches and r[kind]["layers"] == layers
                  for r in ranks),
              f"[zero3] {tag}: flash launches by rank {perf[kind]['launches_a_rank']} "
              f"(layers {[r[kind]['layers'] for r in ranks]}), expected {launches}")
    # (a) holds half of q_proj's heads, and half of those rows.
    check(perf["tp"]["q_kernel_shape"] == [2048, 2048],
          f"[zero3] (a) rank 0 holds q_proj as {perf['tp']['q_kernel_shape']}")
    p22 = pp_refs["pp"]["losses"][:ZERO3_STEPS]
    d22 = rel_diff(perf["pp"]["losses"], p22)
    perf["pp"].update(phase22_losses=p22, phase22_loss_rel=d22)
    log(f"[zero3] (b) loss against phase 22 (b)'s 8 x 1 reference on the same rows "
        f"{p22}: relative {d22:.2e}")
    check(d22 <= ZERO3_RTOL, f"[zero3] (b) loss {d22:.2e} off phase 22 (b)'s")
    perf["launches"] = {name: perf["tp"]["launches_a_rank"][0][name]
                        + perf["pp"]["launches_a_rank"][0][name]
                        for name in perf["tp"]["launches_a_rank"][0]}
    perf["start_s"] = [r["start_s"] for r in ranks]
    log(f"[zero3] the world of 4 took {perf['world_s']:.1f} s (beside phase 17); "
        f"card {card}")
    perf["across_cards"] = zero3_across_cards()
    return perf


# Phase 23 (d)'s card tests: their cases, and the most seconds they may take.
ACROSS_CARDS_CASES = 9
ACROSS_CARDS_TIMEOUT_S = 900


def zero3_across_cards() -> dict:
    """Phase 23 (d): with four or more cards, ``tests/test_torch_cuda.py -k
    across_cards`` as a subprocess (NCCL worlds of 2 and 4, a rank a card,
    each step one CUDA graph: among them the five ZeRO-3 meshes, whose
    ``fsdp`` gathers run a block ahead and whose reduce-scatters run inside
    the capture), every case passed; with fewer, skipped and said so."""
    import os

    import torch

    cards = torch.cuda.device_count()
    if cards < 4:
        log(f"[zero3] (d) {cards} card(s) visible: ZeRO-3's fsdp gathers over NCCL inside "
            "a graph are not run here (tests/test_torch_cuda.py -k across_cards needs 4)")
        return {"cards": cards, "run": False}
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p", "no:cacheprovider",
           "tests/test_torch_cuda.py", "-k", "across_cards and not replica_fleet"]
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=ACROSS_CARDS_TIMEOUT_S)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    passed = re.search(r"(\d+) passed", tail[0])
    check(proc.returncode == 0 and passed and int(passed.group(1)) == ACROSS_CARDS_CASES
          and "skipped" not in tail[0],
          f"[zero3] (d) across_cards on {cards} cards exited {proc.returncode}: "
          f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    log(f"[zero3] (d) tests/test_torch_cuda.py -k across_cards on {cards} cards: {tail[0]} "
        f"in {time.perf_counter() - t0:.1f} s")
    return {"cards": cards, "run": True, "summary": tail[0]}


# ----------------------------------------------------------------------
# Phase 24: replicas behind the admission gateway on one card
# ----------------------------------------------------------------------

# The serve CLI's fleet: the documented configuration (int8 weights, int8
# KV, 28 slots, 64 steps a sync), two replicas on this card, the gateway's
# queue bounded at 8, self-healing with probation 0.
FLEET_ARGS = DOCUMENTED_ARGS + ["--replicas", "2", "--device", "cuda:0", "--gateway",
                                "--max-queued-requests", str(8), "--self-heal",
                                "--probation", "0"]
# (a): fillers holding every slot of both replicas, then a burst of 24
# (one batch request queued first, 23 interactive) against the queue of 8.
FLEET_FILLER_TOKENS, FLEET_BURST, FLEET_TOKENS = 24, 24, 16
# (b)-(d): waves of requests, a fleet step after each (so the replica the
# chaos hook names still decodes at its fourth step), greedy and seeded.
FLEET_WAVES, FLEET_WAVE_TOKENS = 4, 8


def finished(reason, n, max_tokens) -> bool:
    """A request that ended without an error: ``length`` at its budget, or
    ``stop`` at the end-of-sequence token (a random model samples it at
    times)."""
    return (reason == "length" and n == max_tokens) or (reason == "stop" and n <= max_tokens)


def fleet_prompt(tok, i, n=24):
    return tok.encode(" ".join(["replica", "gateway", "token", "decode"][j % 4]
                               for j in range(i % 7 + n // 4)) + f" {i}", add_bos=True)


def fleet_waves(fleet, tok, tag, per_wave=4):
    """(b)-(d)'s script: ``FLEET_WAVES`` waves of ``per_wave`` requests
    (greedy and seeded in turn), a fleet step after each, then steps until
    the fleet is idle and every replica live. The dispatch counter is reset
    first, so a run and its unfaulted twin place their requests alike until
    the fault."""
    from dlti_tpu_torch.serving import SamplingParams

    fleet._rr = 0
    reqs = []
    for w in range(FLEET_WAVES):
        for i in range(per_wave):
            # Greedy, greedy, seeded, seeded: dispatched in turn, each
            # replica gets one of each.
            sp = (SamplingParams(temperature=0.0, max_tokens=FLEET_WAVE_TOKENS)
                  if i < per_wave // 2 else
                  SamplingParams(temperature=0.8, top_p=0.95, seed=100 * w + i,
                                 max_tokens=FLEET_WAVE_TOKENS))
            reqs.append(fleet.submit(fleet_prompt(tok, 10 * w + i), sp))
        fleet.step()
    for _ in range(200):
        if not fleet.has_work and not fleet.lifecycle_pending:
            break
        fleet.step()
    check(not fleet.has_work and not fleet.lifecycle_pending, f"{tag} the fleet did not settle")
    return reqs


def one_at_a_time(fleet):
    """A step for ``fleet`` (no faults, no lifecycle) that runs each live
    replica's whole step in turn, launch, admission and completion: the
    yardstick of the fleet's own step, which launches every replica's
    decode round before it waits on any."""
    def step():
        done = []
        for eng in fleet.live_engines():
            if eng.has_work:
                done.extend(eng.step())
        return done

    return step


def phase_fleet(torch, card):
    """Phase 24, the replica fleet behind the admission gateway on one card:
    ``cli.serve``'s builder with ``FLEET_ARGS`` (llama2_7b at full width and
    depth, two replicas on ``cuda:0`` each owning its int8 weights, int8
    pool and decode graph) behind ``make_server``.

    (a) Admission: 56 fillers hold every slot; then a burst of 24 greedy
    requests (one ``batch`` queued first, 23 ``interactive``) against the
    queue of 8: 429s with ``Retry-After``, every admitted request 200
    ``length``, the batch request dispatched after every interactive one
    queued with it, each admitted request's tokens equal to one replica's
    alone on its prompt (or, where a bf16 near-tie flips one, its logprobs
    teacher-forced within phase 21's bound, and said so). (e) Drain, on the
    same server: in-flight requests finish 200 while a new one gets 503 and
    ``/health`` 503 ``draining``. Then, offline on the same fleet: (b) a
    ``raise`` at replica 1's fourth step: its requests finish ``length`` on
    replica 0, 0 errors; the replica is rebuilt (its old engine freed
    first), passes its canary and is live (rebuild seconds, peak memory);
    (c) a ``preempt`` at replica 0's fourth step: every migrated request's
    tokens byte-equal to the unfaulted run's, greedy and seeded (ms a
    migration); (d) a rolling reload of the same weights from a
    ``save_pytree`` directory (written in a thread since the fleet was
    built), asked for from another thread (as the server's request thread
    asks) while traffic flows, loaded there digest-verified and re-verified
    before each swap: outputs byte-equal before, during and after, 2 live
    replicas; the fleet steps on while the export loads, and the longest
    step while a live replica decodes (the longest a survivor's client
    waits for a token) is read before and during the roll. (f) With two or
    more cards, ``tests/test_torch_cuda.py -k replica_fleet_across_cards``
    (one replica a card) and the requests/s of a replica a card against
    one replica; with one, skipped and said so. K4q is counted on the
    fleet's path alone: (a) (per replica, exactly), the fleet's burst and
    (b)-(d); replica 0's runs alone, which the fleet is compared with, are
    left out."""
    import shutil
    import tempfile
    import threading

    from dlti_tpu_torch.checkpoint.store import (
        load_pytree, manifest_digest, save_pytree, verify_pytree_dir,
    )
    from dlti_tpu_torch.cli import serve as cli
    from dlti_tpu_torch.models.interop import params_from_jax, params_to_jax
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.serving import SamplingParams, make_server
    from dlti_tpu_torch.serving.replicas import parse_fault_inject

    perf = {"card": card}
    t_phase = time.perf_counter()

    def uncounted(fn, *a):
        """``fn(*a)``, a run of replica 0 alone that the fleet is compared
        with: the kernel counters are put back after it, so they count the
        fleet's path alone."""
        saved = (tpa.launches, tpa.launches_int8,
                 tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches)
        try:
            return fn(*a)
        finally:
            (tpa.launches, tpa.launches_int8,
             tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches) = saved

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args = cli.parse_args(FLEET_ARGS)
    fleet, tok, sc = cli.build(args)
    fleet.warmup_decode_ladder()
    torch.cuda.synchronize()
    cfg = fleet.engines[0].model_cfg
    perf["build_s"] = time.perf_counter() - t0
    firsts = [next(e.model.parameters()) for e in fleet.engines]
    check([e.device for e in fleet.engines] == [torch.device(args.device)] * 2,
          f"[fleet] replicas on {[e.device for e in fleet.engines]}")
    check(firsts[0].data_ptr() != firsts[1].data_ptr(), "[fleet] the replicas share weights")
    check(all(e.cache[0]["k"].dtype == torch.int8 for e in fleet.engines),
          "[fleet] not an int8 pool")
    perf["memory_after_build_gb"] = torch.cuda.memory_allocated() / 1e9
    log(f"[fleet] {' '.join(FLEET_ARGS)}: 2 replicas on cuda:0 built and warmed up in "
        f"{perf['build_s']:.1f} s; device memory allocated {perf['memory_after_build_gb']:.2f} GB")

    # (d)'s export, written beside (a)-(c): the weights as served (int8).
    root = Path(tempfile.mkdtemp(prefix="dlti-fleet-"))
    export = str(root / "weights")
    model = fleet.engines[0].model

    def save_export():
        save_pytree(export, params_to_jax({n: p.detach().to("cpu")
                                           for n, p in model.named_parameters()}))

    saver = Beside(save_export)
    del model

    # The main path's counts start here ...
    tpa.launches = tpa.launches_int8 = 0
    tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
    steps0 = [e.stats["decode_steps"] for e in fleet.engines]
    requests0 = [e.stats["requests"] for e in fleet.engines]

    # (a) Admission over HTTP.
    httpd, aeng = make_server(fleet, tok, sc)
    addr = ("127.0.0.1", httpd.server_address[1])
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    dispatched = []
    direct_submit = aeng.submit

    def recording_submit(*a, **kw):
        req, q = direct_submit(*a, **kw)
        dispatched.append(req.request_id)
        return req, q

    aeng.submit = recording_submit  # the gateway dispatches through it
    try:
        fill = SamplingParams(temperature=0.0, max_tokens=FLEET_FILLER_TOKENS)
        # 8 more fillers than slots wait in the replicas' queues: a filler
        # that meets the end-of-sequence token early frees no room.
        fillers = [direct_submit(fleet_prompt(tok, 1000 + i), fill)[0]
                   for i in range(2 * fleet.cfg.max_seqs + 8)]
        # Send the burst once the fillers hold the slots: mid-admission an
        # engine's queue and slots both miss the requests it is admitting,
        # so the gateway's room check reads free slots that are not there.
        deadline = time.monotonic() + 120
        while fleet.num_active < 2 * fleet.cfg.max_seqs:
            check(time.monotonic() < deadline, "[fleet] (a) the fillers were never admitted")
            time.sleep(0.005)
        burst = {}

        def send(i, priority):
            import http.client

            body = {"prompt": f"burst {i} " + "replica gateway " * (i % 5 + 2),
                    "max_tokens": FLEET_TOKENS, "temperature": 0.0, "logprobs": True,
                    "priority": priority}
            conn = http.client.HTTPConnection(*addr, timeout=600)
            conn.request("POST", "/v1/completions", json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            burst[i] = (priority, body["prompt"], resp.status, resp.read(),
                        resp.getheader("Retry-After"))
            conn.close()

        t0 = time.perf_counter()
        first = threading.Thread(target=send, args=(0, "batch"))
        first.start()
        deadline = time.monotonic() + 60
        while json.loads(http_request(addr, "GET", "/stats")[1]).get(
                "gateway_queue_depth", 0) < 1:
            check(time.monotonic() < deadline and 0 not in burst,
                  "[fleet] (a) the batch request never queued behind the fillers")
            time.sleep(0.005)
        threads = [threading.Thread(target=send, args=(i, "interactive"))
                   for i in range(1, FLEET_BURST)]
        for t in threads:
            t.start()
        # The queue fills (the batch request and 7 interactive ones) before
        # the fillers leave: those dequeue together, interactive first.
        deadline = time.monotonic() + 60
        together = 0
        while together < 8 and time.monotonic() < deadline:
            if any(r.startswith("cmpl-") for r in dispatched):
                break  # dispatch has begun
            together = max(together, json.loads(http_request(addr, "GET", "/stats")[1]).get(
                "gateway_queue_depth", 0))
            time.sleep(0.002)
        for t in [first] + threads:
            t.join(timeout=600)
        perf["burst_wall_s"] = time.perf_counter() - t0
        check(len(burst) == FLEET_BURST, "[fleet] (a) a burst request did not finish")

        # Shed ones: 429 with Retry-After; admitted ones: 200, length.
        admitted = {i: r for i, r in burst.items() if r[2] == 200}
        shed = {i: r for i, r in burst.items() if r[2] == 429}
        check(len(admitted) + len(shed) == FLEET_BURST and admitted and shed,
              f"[fleet] (a) statuses {sorted(r[2] for r in burst.values())}")
        check(all(r[4] is not None and int(r[4]) >= 1 for r in shed.values()),
              f"[fleet] (a) a 429 without Retry-After: {[r[4] for r in shed.values()]}")
        for i, (prio, prompt, status, data, _) in admitted.items():
            obj = json.loads(data)
            check(finished(obj["choices"][0]["finish_reason"],
                           obj["usage"]["completion_tokens"], FLEET_TOKENS),
                  f"[fleet] (a) request {i}: {obj['choices'][0]['finish_reason']}")
        ids = [r for r in dispatched if r.startswith("cmpl-")]
        check(len(ids) == len(admitted), f"[fleet] (a) {len(ids)} dispatched of {len(admitted)}")
        order = {json.loads(r[3])["id"]: r[0] for r in admitted.values()}
        prios = [order[r] for r in ids]
        check(together >= 2 and prios[:together] == ["interactive"] * (together - 1) + ["batch"],
              f"[fleet] (a) dispatch order by class {prios} ({together} queued together)")
        deadline = time.monotonic() + 120
        while not all(f.done for f in fillers):
            check(time.monotonic() < deadline, "[fleet] (a) the fillers never finished")
            time.sleep(0.01)
        for f in fillers:
            check(finished(f.finish_reason, len(f.output_token_ids), FLEET_FILLER_TOKENS),
                  f"[fleet] (a) filler finished {f.finish_reason}")
        took = [e.stats["requests"] - r0 for e, r0 in zip(fleet.engines, requests0)]
        check(all(n > 0 for n in took), f"[fleet] (a) requests a replica {took}")
        metrics = http_request(addr, "GET", "/metrics")[1].decode()
        rejected = sum(float(ln.split()[-1]) for ln in metrics.splitlines()
                       if ln.startswith("dlti_gateway_rejected_total{"))
        check(rejected >= len(shed), f"[fleet] (a) dlti_gateway_rejected_total {rejected}")
        perf["a"] = {"admitted": len(admitted), "shed_429": len(shed),
                     "queued_together": together, "requests_a_replica": took,
                     "dispatch_order": prios}
        log(f"[fleet] (a) burst of {FLEET_BURST} against a queue of 8 behind "
            f"{len(fillers)} fillers: {len(admitted)} admitted (200), {len(shed)} x 429 with "
            f"Retry-After; dispatch order by class {prios} ({together} queued together); "
            f"requests a replica {took}")

        # (e) Drain on the same server: in flight finishes, new gets 503.
        inflight = {}

        def inflight_send(i):
            inflight[i] = http_request(addr, "POST", "/v1/completions", {
                "prompt": f"drain {i}", "max_tokens": 32, "temperature": 0.0})

        threads = [threading.Thread(target=inflight_send, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while len([r for r in dispatched if r.startswith("cmpl-")]) < len(ids) + 4:
            check(time.monotonic() < deadline, "[fleet] (e) the in-flight requests never ran")
            time.sleep(0.005)
        httpd.gateway.drain()
        import http.client

        conn = http.client.HTTPConnection(*addr, timeout=60)
        conn.request("POST", "/v1/completions", json.dumps({"prompt": "late", "max_tokens": 4}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        late = (resp.status, resp.getheader("Retry-After"), resp.read())
        conn.close()
        health = http_request(addr, "GET", "/health")
        for t in threads:
            t.join(timeout=600)
        check(late[0] == 503 and late[1] is not None, f"[fleet] (e) a new request got {late}")
        check(health[0] == 503 and json.loads(health[1])["status"] == "draining",
              f"[fleet] (e) /health {health}")
        check(all(s == 200 for s, _ in inflight.values()) and len(inflight) == 4,
              f"[fleet] (e) in-flight statuses {[s for s, _ in inflight.values()]}")
        check(httpd.gateway.wait_idle(60), "[fleet] (e) the drained gateway never went idle")
        perf["e"] = {"new_request": [late[0], late[1]], "health": json.loads(health[1]),
                     "inflight_200": 4}
        log(f"[fleet] (e) drain: 4 in-flight requests 200, a new one {late[0]} "
            f"(Retry-After {late[1]}), /health {health[0]} {health[1].decode()}")
    finally:
        httpd.shutdown()
        httpd.gateway.shutdown()
        aeng.shutdown()
        httpd.server_close()
    steps_a = [e.stats["decode_steps"] - s0 for e, s0 in zip(fleet.engines, steps0)]
    k4q_a = tpa.launches_int8
    check(k4q_a == cfg.num_layers * sum(steps_a),
          f"[fleet] (a) K4q {k4q_a} != {cfg.num_layers} layers x {steps_a} steps")
    perf["k4q_a_replica"] = [cfg.num_layers * s for s in steps_a]

    # (a) against one replica alone (the server is down: the engine is idle).
    greedy = SamplingParams(temperature=0.0, max_tokens=FLEET_TOKENS)
    adm = [r for _, r in sorted(admitted.items())]
    prompts = [tok.encode(r[1], add_bos=True) for r in adm]
    got = [json.loads(r[3])["choices"][0]["logprobs"]["tokens"] for r in adm]
    lps = [json.loads(r[3])["choices"][0]["logprobs"]["token_logprobs"] for r in adm]
    alone = [r.output_token_ids
             for r in uncounted(fleet.engines[0].generate, prompts, greedy)]
    differ = [j for j, (g, a) in enumerate(zip(got, alone)) if g != a]
    perf["a"]["tokens_equal_one_replica"] = len(adm) - len(differ)
    if differ:
        tf = uncounted(teacher_forced, torch, fleet.engines[0].executor, cfg,
                       [(prompts[j], dataclasses.replace(greedy, max_tokens=len(got[j])))
                        for j in differ],
                       [(got[j], lps[j]) for j in differ], "[fleet] (a)")
        perf["a"]["teacher_forced"] = tf
        log(f"[fleet] (a) {len(differ)} of {len(adm)} admitted requests part from one replica's "
            f"tokens (a bf16 near-tie): held teacher-forced instead, worst logprob "
            f"{tf['worst_logprob_diff']:.4f} (bound {tf['bound']:.4f})")
    else:
        log(f"[fleet] (a) every admitted request's tokens equal one replica's alone")

    # Readings: the same burst through the fleet, through one replica, and
    # through the fleet stepped one replica at a time (replica 0 alone and
    # the yardstick leave the counters as they were).
    burst_prompts = [tok.encode(f"burst {i} " + "replica gateway " * (i % 5 + 2), add_bos=True)
                     for i in range(FLEET_BURST)]

    def yardstick(*a):
        fleet.step = one_at_a_time(fleet)
        try:
            return uncounted(fleet.generate, *a)
        finally:
            del fleet.step

    for name, gen in (("fleet", fleet.generate),
                      ("one_replica", lambda *a: uncounted(fleet.engines[0].generate, *a)),
                      ("one_at_a_time", yardstick)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = gen(burst_prompts, greedy)
        wall = time.perf_counter() - t0
        tpot = [(r.latency_s - r.ttft_s) / (len(r.output_token_ids) - 1) for r in res]
        perf[f"{name}_burst"] = {"requests_per_s": FLEET_BURST / wall, "wall_s": wall,
                                 "tpot_mean_ms": 1e3 * sum(tpot) / len(tpot)}
    log(f"[fleet] reading: the burst of {FLEET_BURST} offline, two replicas "
        f"{perf['fleet_burst']['requests_per_s']:.2f} requests/s (mean TPOT "
        f"{perf['fleet_burst']['tpot_mean_ms']:.1f} ms) against one "
        f"{perf['one_replica_burst']['requests_per_s']:.2f} requests/s "
        f"({perf['one_replica_burst']['tpot_mean_ms']:.1f} ms) and two stepped one at a time "
        f"{perf['one_at_a_time_burst']['requests_per_s']:.2f} requests/s "
        f"({perf['one_at_a_time_burst']['tpot_mean_ms']:.1f} ms)")

    # (b) Failover and self-healing, offline.
    rebuilds = []
    rebuild = fleet._rebuild_replica

    def timed_rebuild(idx, host_params=None):
        t = time.perf_counter()
        rebuild(idx, host_params)
        torch.cuda.synchronize()
        rebuilds.append(time.perf_counter() - t)

    fleet._rebuild_replica = timed_rebuild
    torch.cuda.reset_peak_memory_stats()
    # Re-arm the chaos hook (what fault_inject_step arms at construction).
    fleet._fault_inject, fleet._step_counts = parse_fault_inject("1:4"), [0, 0]
    counters = dict(fleet.lifecycle.counters)
    reqs = fleet_waves(fleet, tok, "[fleet] (b)")
    over = [r for r in reqs if r.num_retries]
    check(all(finished(r.finish_reason, len(r.output_token_ids), FLEET_WAVE_TOKENS)
              for r in reqs) and over
          and all(r.replica == 0 for r in over), "[fleet] (b) failover outcome "
          + str([(r.finish_reason, r.num_retries, r.replica) for r in reqs]))
    check(fleet.lifecycle.counters["quarantines"] == counters["quarantines"] + 1
          and fleet.lifecycle.counters["reinstates"] == counters["reinstates"] + 1
          and fleet.lifecycle_counts()["live"] == 2 and fleet.failover["failover_errors"] == 0,
          f"[fleet] (b) lifecycle {fleet.lifecycle.counters} {fleet.lifecycle_counts()}")
    perf["b"] = {"failed_over": len(over), "errors": 0, "rebuild_s": rebuilds[-1],
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[fleet] (b) raise at replica 1's step 4: {len(over)} request(s) failed over to "
        f"replica 0, all {len(reqs)} finished, 0 errors; replica 1 rebuilt in "
        f"{rebuilds[-1]:.2f} s, canary passed, live; peak {perf['b']['peak_gb']:.2f} GB")

    # (c) Live migration against the unfaulted run.
    fleet._fault_inject = None
    base = [r.output_token_ids for r in fleet_waves(fleet, tok, "[fleet] (c) unfaulted")]
    drains = []
    drain = fleet.drain_replica

    def timed_drain(idx, **kw):
        t = time.perf_counter()
        out = drain(idx, **kw)
        torch.cuda.synchronize()
        drains.append(time.perf_counter() - t)
        return out

    fleet.drain_replica = timed_drain
    fleet._fault_inject, fleet._step_counts = parse_fault_inject("0:4:preempt"), [0, 0]
    migrations0 = fleet.lifecycle.counters["migrations"]
    reqs = fleet_waves(fleet, tok, "[fleet] (c)")
    fleet._fault_inject = None
    moved = [j for j, r in enumerate(reqs) if r.num_migrations]
    check(moved and all(reqs[j].output_token_ids == base[j] for j in moved)
          and all(finished(r.finish_reason, len(r.output_token_ids), FLEET_WAVE_TOKENS)
                  for r in reqs),
          "[fleet] (c) migrated requests part from the unfaulted run: "
          + str([(j, reqs[j].output_token_ids, base[j]) for j in moved]))
    kinds = sorted({"greedy" if reqs[j].params.temperature == 0.0 else "seeded" for j in moved})
    check(kinds == ["greedy", "seeded"], f"[fleet] (c) only {kinds} requests migrated")
    n_moved = fleet.lifecycle.counters["migrations"] - migrations0
    perf["c"] = {"migrated": n_moved, "kinds": kinds, "byte_equal": True,
                 "ms_a_migration": 1e3 * drains[0] / max(1, n_moved),
                 "rebuild_s": rebuilds[-1]}
    log(f"[fleet] (c) preempt at replica 0's step 4: {n_moved} decode(s) migrated by KV "
        f"handoff ({', '.join(kinds)}), tokens byte-equal to the unfaulted run; the drain "
        f"took {1e3 * drains[0]:.1f} ms ({perf['c']['ms_a_migration']:.1f} ms a migration); "
        f"replica 0 rebuilt in {rebuilds[-1]:.2f} s and live")
    del fleet.drain_replica

    # (d) Rolling reload of the same weights from the save_pytree export.
    perf["d"] = {"save_s": saver.join(),
                 "export_gb": sum(f.stat().st_size for f in Path(export).rglob("*")
                                  if f.is_file()) / 1e9}
    digest = manifest_digest(export)

    def verify():
        return manifest_digest(export) == digest and verify_pytree_dir(export)[0]

    def once(reload=False):
        """Every request admitted in one step (so each run prefills them in
        the same groups), then the fleet stepped until idle. With
        ``reload`` the reload is asked for from another thread, as the
        server's request thread asks (the export loads there), and more
        requests keep the replicas decoding until the roll ends. Returns
        the 8 requests' tokens and each step's (wall s, a live replica was
        decoding, the export was loading)."""
        fleet._rr = 0
        reqs = [fleet.submit(fleet_prompt(tok, 50 + i), SamplingParams(
            temperature=0.0 if i % 2 == 0 else 0.8, seed=i, max_tokens=FLEET_WAVE_TOKENS))
            for i in range(8)]
        fleet.step()
        asked = {}

        def ask():
            t = time.perf_counter()
            asked["ok"] = fleet.request_reload(
                lambda: params_from_jax(load_pytree(export, verify=True)), verify=verify)
            asked["load_s"] = time.perf_counter() - t

        loader = threading.Thread(target=ask)
        if reload:
            loader.start()
        steps, extra = [], []
        for _ in range(5000):
            loading = loader.is_alive()
            rolling = loading or fleet._reload is not None
            if not rolling and not fleet.has_work:
                break
            if rolling and fleet.num_active + len(fleet.waiting) < 8:
                extra.append(fleet.submit(fleet_prompt(tok, 300 + len(extra)), SamplingParams(
                    temperature=0.0, max_tokens=FLEET_WAVE_TOKENS)))
            decoding = any(not s.free and not s.prefilling
                           for e in fleet.live_engines() for s in e.slots)
            t = time.perf_counter()
            fleet.step()
            # A step in which the load ended may have run the first swap.
            steps.append((time.perf_counter() - t, decoding, loading and loader.is_alive()))
        if reload:
            loader.join()
            check(asked.get("ok"), "[fleet] (d) a reload was already in flight")
            perf["d"]["load_s"] = asked["load_s"]
        check(all(finished(r.finish_reason, len(r.output_token_ids), FLEET_WAVE_TOKENS)
                  for r in reqs + extra), "[fleet] (d) a request failed")
        return [r.output_token_ids for r in reqs], steps, len(extra)

    before, steps_before, _ = once()
    t0 = time.perf_counter()
    during, steps_during, n_extra = once(reload=True)
    check(fleet._reload is None and fleet.last_reload_ok, "[fleet] (d) the roll did not complete")
    perf["d"]["roll_s"] = time.perf_counter() - t0
    after, _, _ = once()
    check(before == during == after, "[fleet] (d) outputs changed across the reload")
    check(fleet.lifecycle_counts() == {"live": 2, "quarantined": 0, "draining": 0, "dead": 0}
          and fleet.failover["failover_errors"] == 0, f"[fleet] (d) {fleet.lifecycle_counts()}")
    loading_steps = [w for w, dec, ld in steps_during if ld and dec]
    check(loading_steps, "[fleet] (d) the fleet took no step while the export loaded")
    perf["d"].update({
        "rebuild_s": rebuilds[-2:], "requests_during": 8 + n_extra,
        "steps_while_loading": len(loading_steps),
        "longest_step_before_s": max(w for w, dec, _ in steps_before if dec),
        "longest_step_while_loading_s": max(loading_steps),
        "longest_step_in_roll_s": max((w for w, dec, ld in steps_during if dec and not ld),
                                      default=0.0)})
    d = perf["d"]
    log(f"[fleet] (d) rolling reload from a save_pytree export ({d['export_gb']:.2f} GB, "
        f"written in {d['save_s']:.1f} s beside (a)-(c)), asked for from another thread: "
        f"loaded there in {d['load_s']:.1f} s while the fleet took {len(loading_steps)} "
        f"decoding steps (longest {d['longest_step_while_loading_s']:.3f} s); roll "
        f"{d['roll_s']:.1f} s (rebuilds {', '.join(f'{x:.2f}' for x in rebuilds[-2:])} s), "
        f"the longest step while a survivor decoded {d['longest_step_in_roll_s']:.2f} s "
        f"(before the reload {d['longest_step_before_s']:.3f} s); {8 + n_extra} requests, "
        f"the first 8 byte-equal before, during and after, 0 errors, 2 live")
    torch.cuda.synchronize()
    launches_int8, launches_float = tpa.launches_int8, tpa.launches  # ... read here
    flash = tfa.fwd_launches + tfa.dq_launches + tfa.dkv_launches
    check(launches_float == 0 and flash == 0,
          f"[fleet] the float K4 ran {launches_float} times, flash {flash}")
    check(launches_int8 > k4q_a, f"[fleet] K4q {launches_int8} through (d)")
    perf["k4q_launches"] = launches_int8  # (a), the fleet's burst, (b)-(d)
    del fleet, saver
    shutil.rmtree(root, ignore_errors=True)
    free_memory(torch)
    perf["f"] = fleet_across_cards()
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"[fleet] K4q launches on the fleet's path {launches_int8} ((a): "
        f"{perf['k4q_a_replica']} a replica); "
        f"phase {perf['phase_s']:.1f} s")
    return perf


FLEET_ACROSS_CASES = 3
FLEET_ACROSS_TIMEOUT_S = 600
# (f)'s reading: a full batch of requests of this many greedy tokens for
# every replica.
FLEET_ACROSS_TOKENS = 64


def fleet_across_reading(torch, cards: int) -> dict:
    """Phase 24 (f)'s reading: ``cli.serve``'s fleet in the documented
    configuration with a replica a card (llama2_7b, int8 weights and KV, 28
    slots, k 64), and the same burst (28 requests a card, greedy) through
    the fleet, through replica 0 alone and through the fleet stepped one
    replica at a time (:func:`one_at_a_time`): requests/s and mean TPOT.
    The fleet launches every replica's decode round before it waits on any,
    so its requests/s should approach ``cards`` times one replica's."""
    from dlti_tpu_torch.cli import serve as cli
    from dlti_tpu_torch.serving import SamplingParams

    t0 = time.perf_counter()
    fleet, tok, _ = cli.build(cli.parse_args(DOCUMENTED_ARGS + ["--replicas", str(cards)]))
    fleet.warmup_decode_ladder()
    for i in range(cards):
        torch.cuda.synchronize(i)
    build_s = time.perf_counter() - t0
    check([e.device.index for e in fleet.engines] == list(range(cards)),
          f"[fleet] (f) replicas on {[e.device for e in fleet.engines]}")
    prompts = [fleet_prompt(tok, 500 + i) for i in range(cards * fleet.cfg.max_seqs)]
    greedy = SamplingParams(temperature=0.0, max_tokens=FLEET_ACROSS_TOKENS)
    out = {"cards": cards, "requests": len(prompts), "build_s": build_s}
    def yardstick(*a):
        fleet.step = one_at_a_time(fleet)
        try:
            return fleet.generate(*a)
        finally:
            del fleet.step

    for name, gen in (("fleet", fleet.generate), ("one_replica", fleet.engines[0].generate),
                      ("one_at_a_time", yardstick)):
        for i in range(cards):
            torch.cuda.synchronize(i)
        t0 = time.perf_counter()
        res = gen(prompts, greedy)
        wall = time.perf_counter() - t0
        check(all(finished(r.finish_reason, len(r.output_token_ids), FLEET_ACROSS_TOKENS)
                  for r in res), f"[fleet] (f) {name}: a request failed")
        tpot = [(r.latency_s - r.ttft_s) / (len(r.output_token_ids) - 1) for r in res
                if len(r.output_token_ids) > 1]
        out[name] = {"requests_per_s": len(prompts) / wall, "wall_s": wall,
                     "tpot_mean_ms": 1e3 * sum(tpot) / len(tpot)}
    took = [e.stats["requests"] for e in fleet.engines]
    check(all(n > 0 for n in took), f"[fleet] (f) requests a replica {took}")
    out["ratio"] = out["fleet"]["requests_per_s"] / out["one_replica"]["requests_per_s"]
    log(f"[fleet] (f) reading: {len(prompts)} requests of {FLEET_ACROSS_TOKENS} tokens, a "
        f"replica a card on {cards} cards {out['fleet']['requests_per_s']:.2f} requests/s "
        f"(mean TPOT {out['fleet']['tpot_mean_ms']:.1f} ms) against replica 0 alone "
        f"{out['one_replica']['requests_per_s']:.2f} ({out['one_replica']['tpot_mean_ms']:.1f} "
        f"ms): {out['ratio']:.2f}x; stepped one replica at a time "
        f"{out['one_at_a_time']['requests_per_s']:.2f} "
        f"({out['one_at_a_time']['tpot_mean_ms']:.1f} ms); built in {build_s:.1f} s")
    del fleet
    free_memory(torch)
    return out


def fleet_across_cards() -> dict:
    """Phase 24 (f): with two or more cards, ``tests/test_torch_cuda.py -k
    replica_fleet_across_cards`` as a subprocess (one replica a card, a
    ``raise`` failing over and a ``preempt`` migrating KV across cards, held
    to the fleet on one card), every case passed, then
    :func:`fleet_across_reading`; with one, skipped and said so."""
    import os

    import torch

    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"[fleet] (f) {cards} card visible: a replica a card is not run here "
            "(tests/test_torch_cuda.py -k replica_fleet_across_cards needs 2 or more)")
        return {"cards": cards, "run": False}
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p", "no:cacheprovider",
           "tests/test_torch_cuda.py", "-k", "replica_fleet_across_cards"]
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=FLEET_ACROSS_TIMEOUT_S)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    passed = re.search(r"(\d+) passed", tail[0])
    check(proc.returncode == 0 and passed and int(passed.group(1)) == FLEET_ACROSS_CASES,
          f"[fleet] (f) on {cards} cards exited {proc.returncode}: "
          f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    log(f"[fleet] (f) tests/test_torch_cuda.py -k replica_fleet_across_cards on {cards} "
        f"cards: {tail[0]} in {time.perf_counter() - t0:.1f} s")
    return {"cards": cards, "run": True, "summary": tail[0],
            "reading": fleet_across_reading(torch, cards)}


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this smoke test runs on the card only")
    if not (ROOT / "dlti_tpu_torch" / "csrc").is_dir():
        return fail(f"the dlti_tpu_torch package is not beside {__file__}")
    if sys.argv[1:2] == ["--tensor-rank"]:  # one rank of phase 21's world
        return tensor_rank_main(sys.argv[2])
    if sys.argv[1:2] == ["--zero3-rank"]:  # one rank of phase 23's world
        return zero3_rank_main(sys.argv[2])
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    phase_times = {}

    @contextlib.contextmanager
    def lap(name):
        """Book the wall clock of the phases run inside under ``name``."""
        t0 = time.perf_counter()
        yield
        phase_times[name] = round(time.perf_counter() - t0, 1)
        log(f"[time] {name} {phase_times[name]:.1f} s (run "
            f"{time.perf_counter() - t_start:.1f} s)")

    try:
        with lap("phases 1-2"):
            card = phase_card_and_build(torch)
            # 256 MB written before each timed launch: more than the 50 MB L2.
            flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
            cases, int8_cases = phase_kernel_cases(torch, flush)
        with lap("phases 3-5"):
            engine, launches, engine_perf = phase_engine(torch)
            # Phases 4 and 5 on the k = 8 graphed engine: 17 tokens a request
            # leave two 8-step windows after the prefill, one dispatched under
            # the sync check and one profiled.
            main_path = phase_in_model(torch, engine, flush, max_tokens=17,
                                       fp16_pool=True)
            sync_check(torch, engine, "[in-model]")
            profile_perf = phase_profile(torch, engine)
            head_perf = phase_head(torch, engine)
            # The serving phases hold ~23 GB (weights and KV pool): release
            # them before the training phases build their own llama2_7b.
            del engine
            free_memory(torch)
        with lap("phase 6"):
            flash = phase_flash_cases(torch, flush)
        with lap("phases 7-9"):
            state, dataset, lora, flash_launches, train_perf = phase_training(torch)
            paths = phase_train_paths(torch, state, dataset, lora)
            train_profile = phase_train_profile(torch, state, dataset)
            # The trainer holds ~16 GB: release it before phases 14 and 13.
            del state, dataset
            gc.collect()
            torch.cuda.empty_cache()
        with lap("phase 14"):
            window_perf = phase_train_window(torch, train_perf)
        with lap("phase 13"):
            ckpt_launches, ckpt_perf = phase_checkpoint(torch, train_perf, card, flush)
        with lap("phase 15"):
            fp16_launches, fp16_perf = phase_fp16(torch, train_perf, card, flush)
        with lap("phases 10-11"):
            engine, int8_launches, server_perf = phase_server(torch)
            int8_main = phase_in_model(torch, engine, flush)
            del engine
            free_memory(torch)
            engine, _, documented_perf = phase_server(torch, DOCUMENTED_ARGS,
                                                      "[server-documented]")
            sync_check(torch, engine, "[server-documented]", submit=True)
            while engine.has_work:
                engine.step()
            del engine
            free_memory(torch)
        with lap("phase 16"):
            zero_perf = phase_zero(torch, train_perf, card)
            free_memory(torch)
        with lap("phase 17 (phase 12 and phase 23's world beside it)"):
            # Both mostly wait on subprocesses or gloo, as phase 17 does on
            # its CLIs: run together, they share the wait.
            world23 = start_world("--zero3-rank", 4)
            cli12 = Beside(phase_cli_round_trip, torch)
            try:
                quickstart_perf = phase_quickstart(torch, card, flush)
                free_memory(torch)
                phase_times["phase 12 (ran beside phase 17)"] = cli12.join()
            except BaseException:
                cli12.join(quiet=True)
                finish_world(world23, "[zero3]", abort=True)
                raise
            zero3_ranks = finish_world(world23, "[zero3]")
        with lap("phase 18 (phase 21's world beside it)"):
            # Phase 21's world waits on gloo; phase 18 leaves the card room
            # (8 layers), unlike phases 19-20.
            world21 = start_world("--tensor-rank", 2)
            try:
                features_perf = phase_features(torch, card)
                free_memory(torch)
            except BaseException:
                finish_world(world21, "[tensor]", abort=True)
                raise
            tensor_ranks = finish_world(world21, "[tensor]")
        with lap("phase 19"):
            hf_perf = phase_hf_adapters(torch, card)
            free_memory(torch)
        with lap("phase 20"):
            mixtral_perf = phase_mixtral(torch, card)
            free_memory(torch)
        with lap("phase 21"):
            tensor_perf = phase_tensor(torch, engine_perf, train_perf, card, tensor_ranks)
            free_memory(torch)
        with lap("phase 22"):
            seqpipe_perf = phase_seqpipe(torch, train_perf, card,
                                         tensor_perf.pop("seqpipe_ranks"))
        with lap("phase 23 (its world ran beside phase 17)"):
            zero3_perf = phase_zero3(train_perf, card, seqpipe_perf.pop("references"),
                                     zero3_ranks)
        with lap("phase 24"):
            fleet_perf = phase_fleet(torch, card)
    except CheckFailed as e:
        return fail(str(e))
    mix_serve, mix_train = mixtral_perf["serve"], mixtral_perf["train"]

    f16 = lambda r: r["pool"] == "float16"  # noqa: E731
    worst = max([r["max_abs_err"] for r in cases.values() if not f16(r)]
                + [main_path["max_abs_err"], ckpt_perf["in_model"]["max_abs_err"]])
    kernels = [{
        "name": "paged_decode_attention",
        "design": main_path["design"],
        "route": "cuda",
        "source": "dlti_tpu_torch/csrc/paged_attention.cu",
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": worst,
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": main_path["library_ms"],
        "mixtral_launches": mix_serve["k4_launches"],
        "tensor_launches": tensor_perf["launches"]["paged_decode_attention"],
    }]
    # K4 on float16 pools: times and bound at the llama2_7b engine's decode
    # state (phase 4, a float16 copy of its pool, a float16 query); launches
    # from phase 15's fp16 export served on a float16 pool; the error is the
    # worst over phase 2's float16-pool cases and both states.
    at16 = main_path["fp16"]
    kernels.append({
        "name": "paged_decode_attention_float16",
        "design": at16["design"],
        "route": "cuda",
        "source": "dlti_tpu_torch/csrc/paged_attention.cu",
        "replaces": KERNEL_REPLACES + " (float16 pools)",
        "launches": fp16_launches["paged_decode_attention"],
        "max_abs_err": max([r["max_abs_err"] for r in cases.values() if f16(r)]
                           + [at16["max_abs_err"],
                              fp16_perf["ckpt"]["in_model"]["max_abs_err"]]),
        "ms": at16["ms"],
        "plain_ms": at16["plain_ms"],
        "bound_ms": at16["bound_ms"],
        "bound_by": at16["bound_by"],
        "library_ms": at16["library_ms"],
    })
    # K4q: times and bound at the int8 engine's decode state (phase 11); the
    # error is the worst over phase 2's int8 cases and that state.
    kernels.append({
        "name": "paged_decode_attention_int8",
        "design": int8_main["design"],
        "route": "cuda",
        "source": "dlti_tpu_torch/csrc/paged_attention.cu",
        "replaces": KERNEL_REPLACES + " (quantized=True)",
        "launches": int8_launches,
        "max_abs_err": max([r["max_abs_err"] for r in int8_cases.values()]
                           + [int8_main["max_abs_err"]]),
        "ms": int8_main["ms"],
        "plain_ms": int8_main["plain_ms"],
        "bound_ms": int8_main["bound_ms"],
        "bound_by": int8_main["bound_by"],
        "library_ms": int8_main["library_ms"],
        "tensor_launches": tensor_perf["launches"]["paged_decode_attention_int8"],
        "fleet_launches": fleet_perf["k4q_launches"],
    })
    # K1-K3: times and bound at the training path's shape (llama2_7b,
    # b 4, s 512, causal), bf16 (phase 7's launches) and float16 (phase
    # 15's); the error is the worst over the cases of that mode (float32
    # with bf16; the float16 ds case's, in units of 2**12, is printed in its
    # own line). "design" is the program that shape runs.
    mixtral_flash = {"flash_fwd": mix_train["launches"]["fwd"],
                     "flash_bwd_dq": mix_train["launches"]["dq"],
                     "flash_bwd_dkv": mix_train["launches"]["dkv"]}
    for suffix, at, counts, mode in (
            ("", flash["llama2_7b_train"], flash_launches, ("bfloat16", "float32")),
            ("_float16", flash["llama2_7b_train_fp16"], fp16_launches, ("float16",))):
        for name, replaces in FLASH_REPLACES.items():
            extra = {} if suffix else {"mixtral_launches": mixtral_flash[name],
                                       "tensor_launches": tensor_perf["launches"][name],
                                       "pipe_stage_launches": seqpipe_perf["launches"][name],
                                       "zero3_launches": zero3_perf["launches"][name]}
            kernels.append({
                "name": name + suffix,
                "design": at[name]["design"],
                "route": "cuda",
                "source": "dlti_tpu_torch/csrc/flash_attention.cu",
                "replaces": replaces + (" (float16)" if suffix else ""),
                "launches": counts[name],
                "max_abs_err": max(r[name]["max_abs_err"] for r in flash.values()
                                   if r["dtype"] in mode and not r["max_abs_ds"]),
                "ms": at[name]["ms"],
                "plain_ms": at[name]["plain_ms"],
                "bound_ms": at[name]["bound_ms"],
                "bound_by": at[name]["bound_by"],
                "library_ms": at[name]["library_ms"],
                **extra,
            })
    keys = ("step_ms", "tokens_per_s", "mfu_percent", "peak_memory_gb",
            "host_syncs_per_step")
    log("[train] summary " + json.dumps({
        "graph": {k: train_perf[k] for k in keys},
        "eager": {k: train_perf["eager"][k] for k in keys},
        "busy_share": {k: v and v["busy_share"] for k, v in train_profile.items()},
        "profile_ms_a_step": {k: v and {"wall": v["wall_ms"], "busy": v["busy_ms"]}
                              for k, v in train_profile.items()},
        **{f"k{WINDOW_K}" if name == "window" else name: {k: window_perf[name][k]
                                                          for k in keys}
           for name in ("window", "loss_chunk")},
        **paths}))
    log("[engine] summary " + json.dumps({
        "decode_step_ms_k1_graph_events": engine_perf["decode_step_ms"],
        **{name: {k: r[k] for k in ("ms_per_device_step", "decode_tok_s", "windows",
                                   "host_syncs_per_token")}
           for name, r in engine_perf["equality"].items()},
        "profile_k8": profile_perf, "head": head_perf}))
    log("[server] summary " + json.dumps(server_perf))
    log("[server-documented] summary " + json.dumps(documented_perf))
    log("[ckpt] summary " + json.dumps({k: ckpt_perf[k] for k in (
        "card", "layers", "losses_bit_equal", "save_stall_ms", "writer_s", "gb_written",
        "write_hash_gb_s", "restore_s", "export_s", "load_s", "free_gb_before",
        "free_gb_after", "phase_s", "sha256_gb_s", "pin_gb_s", "d2h_pinned_gb_s",
        "d2h_pageable_gb_s", "in_model")}))
    log("[ckpt] launches on the train -> checkpoint -> resume -> export -> serve path "
        + json.dumps(ckpt_launches))
    keys16 = keys + ("loss_scales", "overflows")
    log("[fp16] summary " + json.dumps({
        "fp16": {k: fp16_perf["train"][k] for k in keys16},
        "bf16": {k: train_perf[k] for k in keys},
        "fp16_over_bf16_step": fp16_perf["train"]["step_ms"] / train_perf["step_ms"],
        "overflow_run": fp16_perf["overflow"], "ckpt": fp16_perf["ckpt"],
        "launches": fp16_launches}))
    log("[zero] summary " + json.dumps({name: {k: r[k] for k in keys + (
        "launches", "strategy", "world", "streamed_gb_a_step", "h2d_pinned_gb_s",
        "copy_bound_ms") if k in r} for name, r in zero_perf.items()}))
    log("[quickstart] summary " + json.dumps(quickstart_perf))
    log("[features] summary " + json.dumps(features_perf))
    log("[hf] summary " + json.dumps(hf_perf))
    log("[mixtral] summary " + json.dumps(mixtral_perf))
    log("[tensor] summary " + json.dumps(tensor_perf))
    log("[seqpipe] summary " + json.dumps(seqpipe_perf))
    log("[zero3] summary " + json.dumps(zero3_perf))
    log("[fleet] summary " + json.dumps(fleet_perf))
    log("[time] summary " + json.dumps(phase_times))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
