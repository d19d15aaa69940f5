"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only probe 6b 6b_lamb 6d 6d_lamb
    python3 chip_smoke.py --only serve
    python3 chip_smoke.py --only audit
    python3 chip_smoke.py --only families
    python3 chip_smoke.py --only moe          (10c on four cards only)
    python3 chip_smoke.py --only ssm
    python3 chip_smoke.py --only vlm_encdec
    python3 chip_smoke.py --only moe_serve    (13d on four cards only)
    python3 chip_smoke.py --only precision
    python3 chip_smoke.py --only examples

Needs one card; on a machine with up to four, phase 6b puts one rank on
each, and on four phase 6c runs its 2 pods x 2 ranks over NCCL and phase
6d trains bert-large FULL in four ranks. ``--only`` runs, after the
build, just the named checks of phases 4n, 5, 6, 7, 8, 9, 10, 13, 14 and 15 (the
second line: the four-card paths, on four cards; the third: phase 7;
the fourth: phase 8; the fifth: 3e, phase 5's rotary-family checks and
phase 9, 9d on four cards only; the sixth: 3f and phase 10; the
seventh: 3g, phase 5's state-space checks and phase 11; the eighth: 3h,
phase 5's vlm and encoder-decoder checks and phase 12; the ninth: phase
5's MoE serving checks and phase 13; the tenth: 3i and phase 14; the
eleventh: phase 15) and prints no kernels or result line.

1. Prints the card (nvidia-smi name and power limit) and torch/CUDA.
2. Builds the port's CUDA kernels from src/repro_torch/kernels/csrc with
   nvcc for sm_90a.
3. Checks every kernel against its plain PyTorch version on the card and
   times both, with the byte bound and, where one PyTorch call computes
   the same function, that call's time (a kernel's "ms" is one wrapper
   call per event pair, host overhead included; its "batched_ms" 20
   calls back to back, which reads the device's time on the large
   frames): the four kernels of the gpt2 path on the frames one step of
   gpt2 FULL with 4 simulated workers gives them (all 19 leaves, worker
   and server frames; abs_rowsum with the scale of each stacked worker,
   which must be the same bits from that worker's rows alone, and
   ef_quantize against those scales); ef_compress on the six 3-D frames
   of BERT-Base FULL (plus a frame with pad rows, checked only),
   fused_local_step_sgd on all 20 BERT-Base frames and decompress (both
   decodes of a sync) on the same 20 frames, and fused_local_step on the
   same 20 frames as 0/1 LAMB runs it (its delta then scaled by each
   worker's trust, held to the trust times the plain delta). Kernel 1
   runs in place as the optimizer calls it (``fused_local_step_`` and
   ``fused_local_step_sgd_``: m and u updated through the same pointers,
   the delta written over the gradient), on copies, held to the plain
   version of the inputs; then (3c)
   the frames of the
   two-level exchange at 2 pods x 2 workers, stacked workers owning
   different inner slices: abs_rowsum and ef_quantize (tensor scales) on
   every gpt2-FULL worker-side slice frame and server chunk frame,
   decompress on the inter-pod receive and gather frames, ef_compress on
   the six 3-D BERT-Base slice frames (row scales). At every gpt2-FULL
   frame (3a) the plain step of the baselines' single-rounding
   multiply-adds (``fused_adam.fma``) is held to the exact emulation.
   3d: the frames of the bucketed exchange, gpt2 FULL at ``--bucket-mb
   25``: the three fused buckets of more than one leaf (views (4, 4608),
   (4, 4608) and (4, 384); the other 13 units are leaves 3a checks),
   flat and at 2 pods x 2, worker and server frames, checked and timed
   as 3a and 3c.
   3e: kernels 1-4 on every frame of one step of each training run of
   phase 9, at the depth and workers it runs (worker and server frames):
   9a's granite-3-8b FULL width, 1 layer, 2 stacked workers; 9b's
   chatglm3-6b, 1 layer, one worker; one rank of 9d's gemma3-12b, 1
   layer, 4 ranks (its view, every rank's chunk), checked and timed as
   3a (kernel 1's plain version by row slabs), with the byte bound and
   the share of it; and
   ``dispatch.frame_precheck`` on every unit of granite-3-8b,
   phi4-mini-3.8b, chatglm3-6b and gemma3-12b FULL at full depth, at 2
   and 4 stacked workers (metadata only), every unit passing.
   3f: the same for one rank of 10c (deepseek-v2-236b FULL width, 2
   layers, 4 ranks, EP 4): kernels 1-4 on each of its DP units' frames,
   the 102400 x 5120 embedding and head among them (the experts take
   the plain local step).
   3g: the same for one step of 11a (mamba2-2.7b FULL width, 8 layers, 2
   stacked workers: the (8, 2560, 5120) projections and the (8, 80)
   A_log, D and dt_bias among its frames) and 11b (zamba2-1.2b FULL, 38
   layers, one worker), with ``dispatch.frame_precheck`` on every unit of
   both FULL configs at full depth, at 2 and 4 stacked workers.
   3h: the same for one step of 12a (qwen2-vl-2b FULL, 28 layers, one
   worker: the (152064, 1536) embedding and head, the (28, 1536, 8960)
   MLP stacks, the (28, 256) k/v biases) and 12b (whisper-large-v3 FULL
   width, 8 + 8 layers, 2 stacked workers: the (32768, 1280) position
   table and the always-zero (8, 1280) cross biases among its frames),
   with ``dispatch.frame_precheck`` on every unit of both FULL configs.
   3i: production precision: the kernels that read or write optimizer
   state at bf16 operands (kernel 1 with a bf16 gradient, m, u and v,
   u' into bf16 and, as a sync step takes it, into f32; abs_rowsum and
   ef_quantize with a bf16 err and err_out) at every gpt2-FULL frame,
   worker and server side, and the SGD kernel and ef_compress at the
   BERT-Base FULL frames, 4 workers stacked: bf16 outputs and packed
   bytes bit for bit the plain versions', sums within 64 ulp, the Adam
   delta within 2 ulp; call and batched times against the byte bound
   at bf16, reported under each kernel's "production_precision"; then
   the same five kernels again at fp16 state (the paper's: m, u, v and
   the error feedback in fp16, the gradient bf16), reported under
   "production_precision_fp16".
4. Drives the main paths, each through the trainer and CLI config a
   user would call, 4 simulated data-parallel workers, 8 steps (0/1
   Adam and 0/1-SGD: syncs at 0-4 and 6; variance at 0, 1, 3 where the
   base has one; local-only steps 5 and 7; the baselines exchange on
   every step), the launch counts set to 0 just before each and read
   just after:
   a. gpt2 FULL, zero_one_adam, tensor scales, global batch 16, seq 1024
      (then step 6, a sync step, again under torch.profiler);
   b. bert-base FULL (12 layers, d=768), masked-LM data at 15%, global
      batch 32, seq 512, zero_one_adam with row scales;
   c. the same model and data with zero_one_sgd, tensor scales;
   d. run (a) with the two-level exchange, ``--hierarchy 2`` (2 pods x 2
      workers: bf16 reduce-scatter and all_gather inside a pod, 1-bit
      Algorithm 2 across pods on the owned slice);
   e. run (a) under the baseline ``adam``: a bf16 gradient mean and a
      variance update every step, no kernel of the port;
   f. run (a) under the baseline ``one_bit_adam --onebit-warmup 2``: that
      for steps 0-1, then the 1-bit exchange of the gradient (kernels
      2-4) with the variance frozen;
   g. run (a) with the bucketed exchange, ``--bucket-mb 25``: 16
      exchange units (three fused buckets), 32 launches of each of
      kernels 2-4 a sync;
   h. run (a) with one leaf per bucket (``--bucket-mb 1e-6``): its
      final losses and params must be bit for bit (a)'s (a SHA-256 of
      the params, printed for (a));
   j. run (b)'s model and data under ``zero_one_lamb`` with tensor
      scales: kernel 1 with each worker's trust after it on every local
      step, kernels 2-4 on the syncs; the min and max trust over the
      leaves at each sync, finite and in [0, 10];
   k. the same under ``lamb`` (a bf16 mean every step, no kernel);
   l. the same under ``one_bit_lamb --onebit-warmup 2`` (kernels 2-4 on
      the 1-bit steps 2-7);
   m. run (a) with the dense codecs: ``--codec topk --codec-arg 0.01``,
      ``--codec qint8`` and ``--codec qint4`` (kernel 1 only: these
      codecs are plain torch ops, as in the reference), each with its
      bytes per sync next to sign1bit's;
   (e) and (f) profile their step 6 as (a) does.
   Each run checks its losses, its step kinds and its launch counts, and
   prints its step and optimizer ms per step kind. Each of (a)-(h) and
   (j)-(m) runs on a ``repro_torch.analysis.RecordingComm`` around its
   SimComm, which logs every collective and passes on its result
   unchanged, and is audited after its 8 steps
   (``analysis.audit_trainer``: each step's collectives against the
   declared sync and full-precision manifests, in order, dtype and shape;
   every round the style declares seen; the bytes one worker sent in a
   sync and in a variance round, per level, equal to ``comm_accounting``'s
   as the audit's docstring reconciles them, and printed beside them; no
   float64); a violation raises.
   i. A checkpoint round trip, gpt2 FULL width at 1 of its 12 layers
      (``FILE_LAYERS``) in ``--mode single`` at batch 4 x 1024 with
      (a)'s flags, per leaf and at ``--bucket-mb 25``: 4
      steps and ``--save`` into a temporary directory, ``Trainer.restore``
      into a fresh trainer, steps 4-7; the params and losses must be bit
      for bit those of 8 uninterrupted steps. Prints the file's size and
      the save and restore seconds, and deletes the file.
   n. Elastic data parallelism (``repro_torch.elastic``), gpt2 FULL with
      (a)'s flags: (i) ``--resize 3:4`` through the CLI's elastic path,
      bit for bit (a) (losses, a SHA-256 of the params, launch counts);
      (ii) FleetSim killing workers 1 and 3 and shrinking to 2 workers
      before step 3, growing back to 4 before step 5: each resize's report
      the static ``reshard_report``, the worker EF's mass conserved by the
      shrink (rtol 1e-5, atol 1e-7), the joiners' ``u`` zero and their
      params a survivor's bits after the grow, steps 0-2 and the launch
      counts (a)'s; step and optimizer ms per step kind and width, and
      each reshard's ms; (iii) 3 steps of (d) and of (g), then a reshard
      at m = n, bit for bit the identity, and BENCH_elastic.json's
      ``hier_4to2_podkill`` / ``bucketed_4to2_kill1`` (its geometry, the
      mass conserved); (iv) 4 steps at 2 workers (batch 8 x 1024, 1 of
      the 12 layers: ``FILE_LAYERS``) with
      ``--save`` under build/, ``restore_resharded`` into 4 workers bit
      for bit ``reshard_trainer`` of the in-memory state, 4 more steps;
      the file's size and the save and restore seconds (file deleted).
5. Checks the card against the CPU on small inputs: the gpt2-smoke
   trainer (flat, with ``--hierarchy 2``, under ``adam`` and
   ``one_bit_adam``, with ``--bucket-mb 4`` flat and with
   ``--hierarchy 2``, and over each dense codec flat and with
   ``--hierarchy 2``), and the bert-smoke trainer under both BERT
   configurations and the three LAMB optimizers, from the same start on
   both devices. qint8 and qint4 dither from a hash of each value's
   bits, so their trajectories are chaotic in the last bit of the
   gradients, which the two devices do not share: what holds them is one
   optimizer sync step bit for bit the CPU's from the same params,
   gradients and state, at step 0 and at step 6 after six CPU steps
   (carried error feedback, ``u`` and anchor); their trainers' loss and
   param gaps only have a sanity bound, three times the card's own
   spread from params one ulp up.
   Elastic resharding: the five BENCH_elastic.json geometries and 4 -> 3
   on gpt2-smoke state trained on the CPU, resharded on both devices, bit
   for bit; FleetSim shrinking 4 -> 2 before step 4 and growing back
   before step 8, 12 steps at a peak lr of 3e-4, within the bars above.
6. Data parallel in processes (``--mode dist``, one paper-worker per
   process, spawned): first the exchange collectives of DistComm against
   SimComm's, bit for bit, over gloo with CUDA tensors and over NCCL;
   then gpt2 FULL with phase 4a's flags, the launch counts of every rank
   read after its run. The runs of each of 6a, 6b and 6c first run their
   references in this process, then share one spawn of ranks, which run
   them one after another (each with its own process group), so that a
   rank's start-up is paid once per group:
   a. four ranks on this one card over gloo (asked for explicitly; the
      exchange goes through host memory), micro-batches 2, gpt2 FULL
      width at 1 of its 12 layers (``DIST_LAYERS``: the script's time
      limit), against a sim run of the same settings in this process;
      then the same under
      ``one_bit_adam``, ``zero_one_lamb``, ``--codec qint8`` (int8
      payloads through gloo with CUDA tensors), and with
      ``--bucket-mb 25``;
   b. NCCL, one rank per card, on min(device count, 4) cards: on one
      card a world of one at batch 4 x 1024, 1 of the 12 layers
      (``DIST_LAYERS``), against ``--mode single``,
      on four the 4-rank run without micro-batches against a sim run;
      under zero_one_adam, ``adam``, ``one_bit_adam`` and
      ``zero_one_lamb``, and zero_one_adam with ``--bucket-mb 25``;
   c. run 4d in processes, 2 pods x 2 ranks over process subgroups,
      against a sim run of the same flags: NCCL with one rank per card
      on a machine with four cards, else four ranks on this card over
      gloo with micro-batches 2 at 2 layers, as 6a; each rank's exchange
      split into its intra-pod and inter-pod parts;
   d. on four cards only: bert-large FULL (24 layers, d=1024), masked-LM
      data at 15%, zero_one_adam and then zero_one_lamb, tensor scales,
      global batch 32 x 512, one rank per card over NCCL; finite losses,
      a first loss near log(padded vocab), each rank's launch counts,
      peak memory and exchange ms. No run in one process holds it: four
      simulated workers of bert-large do not fit on one card.
   Each rank's losses and params must be bit for bit its simulated
   worker's in 6a and, on one card, 6c; elsewhere they are held to phase
   5's bars, and bitwise equality is printed with the first step and
   leaf that differ. Each rank's launch counts must equal that worker's.
   Every rank of 6a-6c runs ``rank_main(audit=True)``: its recorded
   collectives must pass the audit and equal, collective for collective,
   those its simulated worker recorded in the run it is held to (itself
   audited), and so must its bytes per round. Every step is timed as phase
   4's are (``launch.train``), and each rank's exchange collectives as
   ``DistComm.exchange_ms`` times them (NCCL: CUDA events on the
   collective stream; gloo: the host clock from issue to completion).
   Every rank issues each exchange unit from the last micro-batch's
   backward (``TrainerConfig.peel_last_microbatch``, the default), and
   three runs have a sequential twin (``peel_last_microbatch=False``) in
   the same spawn, right after them: 6a, 6b, and 6a at gpt2 FULL's full
   depth (12 layers) with ``--bucket-mb 25`` and the units packed and
   issued in reverse flat order (``pack_order="reverse_backward"``),
   which has no in-process run. Each pair must be bit for bit (losses,
   params), record the same collectives in the same order, pass both
   audits, launch as many kernels, and peak within 1 GB of each other;
   its step times by kind, exchange ms and peaks are printed, and for
   step 6 of the early run each unit's first-collective time against the
   end of the backward (CUDA events, ``probe_issue``).
7. Serves gpt2 FULL (params from the port's init, f32 cache) through
   ``repro_torch.launch.serve``'s own setup and loop (``build``,
   ``serve``), each run with its ticks timed (host clock; a tick ends in
   a host read of its tokens), tokens/s and peak memory:
   a. ``--slots 8 --max-seq 1024 --requests 16 --prompt-len 512 --gen
      128``: decode ms a tick (median, range), admission ticks; 4 of the
      requests again alone at batch 1 through ``Server.prefill_fn`` /
      ``decode_fn`` (teacher-forced with the batched tokens): tokens
      equal except at top-2 logit gaps under 1e-4 (counted), logits
      within 1e-4 of the batched ones;
   b. (a) with ``--publish-every 32 --codec qint8`` (PublishConfig
      defaults): bytes per delta and snapshot against
      ``full_f32_bytes``, publish, apply and swap-tick ms; after every
      apply the subscriber's anchors bit for bit the publisher's, the
      served params their bits and within one quantization step of the
      trainer's; ``weight_swaps`` counted;
   c. (a) with ``--kv-quant qint8 --kv-page 16``: ``pages_quantized``
      those the requests filled; a page quantized on the card bit for
      bit the CPU's ``quant_page`` of the same lane;
   d. prefill_32k: ``--slots 1 --requests 1 --prompt-len 32704 --gen 64
      --max-seq 32768`` (a blockwise prefill, decodes against the full
      cache); at S = 8192 the blockwise forward's logits within 1e-4 of
      ``dot_attn``'s;
   e. a snapshot and two deltas of gpt2 FULL per codec (sign1bit, qint4,
      topk, identity): bytes equal ``wire_bytes``, anchors in lockstep,
      identity bit for bit; sign1bit's launches of kernels 2-4 counted
      per publish and per apply (one of each a bucket), its packed bytes
      bit for bit the CPU plain path's for the first, a middle and the
      last bucket, scales within 64 ulp.
   Phase 5 also serves gpt2-smoke on the card against the CPU (prefill
   + 8 decodes: logits within 1e-4, greedy tokens equal), and trains the
   rotary family's smoke configs (granite, phi4, chatglm3, gemma3: seq
   32 past gemma3-smoke's window of 8) under its flags at a peak lr of
   3e-4, on the card against the CPU under its bars; and the state-space
   family's smoke configs (mamba2, zamba2: seq 32, four chunks of 8) the
   same way, each also served (a prefill of 16 tokens, 8 decodes: logits
   within 1e-4, greedy tokens equal); and both MoE smoke configs
   (llama4-smoke, deepseek-smoke with MLA's latent cache) served through
   the Scheduler on the card and on the CPU from the same params, 3
   slots, 5 requests, paged qint8 KV, a sign1bit delta publish swapped in
   mid-run (kernels 2-4 on the MoE leaves' frames, one launch of each a
   bucket, counted into the kernels line; packed bytes bit for bit the
   CPU's, scales within 64 ulp): tokens and stats equal.
8. Runs ``python -m repro_torch.launch.audit --matrix --lints`` on the
   card (in this process): the reference's audit matrix without its
   tensor-parallel entries, 12 gpt2-smoke configurations of 8 recorded
   steps each, and the port's lints; it must exit 0.
9. The dense rotary family at full width (depth cut to fit):
   a. granite-3-8b (d 4096, 32 heads, kv 8, ff 12800, vocab 49155), 2 of
      its 40 layers, zero_one_adam with tensor scales, 2 simulated
      workers, global batch 8 x 1024, phase 4's 8-step schedule, remat
      on, through ``run_main_path`` as phase 4 (step, fwd/bwd and
      optimizer ms per step kind, launches of kernels 1-4 against
      ``expected_launches``, peak memory and its GB per 1e9 stacked
      elements, audited: the bytes a worker sends a round equal to
      ``comm_accounting``; ``--only 9a_1layer`` runs it at 1 layer);
   b. chatglm3-6b (partial rotary 0.5, QKV bias, kv 2), 1 of its 28
      layers, as (a) but in ``--mode single`` (one worker, batch 4 x
      1024: two workers of it do not fit the card);
   c. gemma3-12b, 6 of its 48 layers (5 sliding, 1 global), from the
      port's seeded init, served through the Scheduler (4 slots, 8
      requests of 1536-2048 prompt tokens, past the 1024 window, + 64
      new tokens; f32 cache) with the dense cache and with
      ``window_cache=True``: decode ms a tick, prefill ms and peak memory
      for each; tokens equal a lone run's (7a's check, 2 requests) and
      each other's but at top-2 gaps under 1e-4;
   d. on four cards only: gemma3-12b, 2 layers (sliding), batch 4 x 2048,
      four NCCL ranks with one worker each, zero_one_adam, 8 steps;
      every rank audited, its losses finite, its launches and step kinds
      4a's schedule.
10. Mixture of experts with expert parallelism (llama4-scout,
   deepseek-v2 with MLA and a dense first layer; the router, dispatch,
   expert FFN and MLA are plain torch, as they reach no Pallas kernel in
   the reference; the DP leaves go through kernels 1-4):
   a. both smoke configs in sim mode, 4 workers (EP 4: each worker run
      against the merged experts), 8 steps at a peak lr of 3e-4, on the
      card against the CPU under phase 5's bars;
   b. llama4-smoke in four gloo ranks on this card with the real expert
      exchange (``all_to_all`` both ways, forward and backward), each
      rank against its simulated worker (losses within 1e-5, params
      within 1e-4: the merged experts sum an expert's gradient in
      another order), launch counts equal, audited clean with the
      exchanges classified as expert-parallel dispatch;
   c. on four cards only: deepseek-v2-236b FULL width, 2 layers (the
      dense first and one MoE layer of 160 experts, 40 a rank), four
      NCCL ranks, EP 4, zero_one_adam with 4a's schedule, 1 x 2048 tokens
      a rank, remat on, 8 steps: audited, losses finite, the first near
      log(102400) + 0.02**2 * 5120 / 2 plus the aux term, launches 4a's
      schedule over the DP leaves; peak memory (under 79.18 GiB), times
      by step kind, the EP exchange's ms, dropped_frac and aux a step.
11. The state-space family (Mamba2's chunked SSD and O(1) decode,
   zamba2's shared attention block: plain torch, as the reference
   computes them outside any Pallas kernel; the DP leaves go through
   kernels 1-4) at full width, each run through ``run_main_path`` as
   9a (zero_one_adam, tensor scales, phase 4's 8-step schedule, remat
   on, seq 1024, audited, launches against ``expected_launches``, peak
   memory), every gradient of step 0 asserted finite (the reference's
   scan gives NaN at the chunk of 256):
   a. mamba2-2.7b (d 2560, 80 SSM heads x 64, state 128, chunk 256,
      vocab 50280 padded to 50432, untied head), 8 of its 64 layers, 2
      simulated workers, global batch 8;
   b. zamba2-1.2b at full depth (38 layers, the shared block applied 6
      times), ``--mode single``, batch 4;
   c. both FULL configs at full width from the port's seeded init,
      mamba2 at 4 of its 64 layers and zamba2 at 6 of its 38 (the
      shared block applied once; ``SERVE_LAYERS``: full depth until
      phase 13 joined the script's time limit, cut again as phase 14
      did), served through the
      Scheduler: 4 slots, 8 requests of 1024, 1536 or 2048 prompt tokens
      + 64 new ones, f32 cache; decode ms a tick, prefill ms, peak
      memory, and 2 requests against a lone run (7a's check).
12. The vlm and the encoder-decoder (M-RoPE, the vision prefix, the
   encoder and cross-attention: plain torch, as the reference computes
   them outside any Pallas kernel; the DP leaves go through kernels
   1-4) at full width, each run through ``run_main_path`` as 11a
   (zero_one_adam, tensor scales, phase 4's 8-step schedule, remat on,
   audited, launches against ``expected_launches``, peak memory, every
   gradient of step 0 finite):
   a. qwen2-vl-2b FULL at full depth (28 layers, M-RoPE sections 16 +
      24 + 24, vocab 151936 padded to 152064), ``--mode single``, batch
      2 x 2048: a 1024-token vision prefix of seeded embeddings (with
      the CLI's zeros the 28-layer gradient overflows to NaN, in the
      reference too) and 1024 text tokens;
   b. whisper-large-v3 FULL width with ``--layers 8`` (8 encoder and 8
      decoder layers), 2 simulated workers, batch 4 x 1024 decoder
      tokens and 1500 zero frames a row;
   c. both FULL configs at full width from the port's seeded init
      (qwen2-vl at 4 of its 28 layers, whisper at 2 + 2 of its 32 + 32:
      ``SERVE_LAYERS``), f32 cache: qwen2-vl through the Scheduler as
      11c (tokens only), and both through
      ``Server.prefill_fn``/``decode_fn`` at batch 4 with 64 greedy
      decodes (qwen2-vl: a seeded 1024-token vision prefix and 512 text
      tokens; whisper: seeded frames encoded
      once, a 4-token prompt, every decode given ``enc_out``), every
      row then alone at batch 1 (7a's check); prefill ms, decode ms a
      tick, peak memory.
13. MoE and MLA serving at full width (the latent cache and the
   absorbed decode, the dense-prefix cache, each Scheduler slot routed
   alone, expert parallelism in processes: plain torch, as the
   reference computes them outside any Pallas kernel), from the port's
   seeded init in f32, f32 caches, 8 requests of 1024 prompt tokens;
   every line with the card's name and power limit:
   a. deepseek-v2-236b, 2 layers (the dense first one and an MoE layer
      of 160 experts, top 6; 3 layers until phase 14 joined the script's
      time limit), through the Scheduler over 8
      slots with 64 greedy tokens each; every row then alone at batch 1
      (7a's check, no token may differ: the largest logit gap and the
      smallest top-2 gap printed); ``Server.decode_fn`` at batch 8 over
      the same prompts (the batch-wide capacity: its dropped fraction a
      tick against the Scheduler's none); prefill and decode ms, peak
      memory, the latent cache's bytes against per-head K/V's;
   b. llama4-scout-17b-a16e, 2 layers (16 experts, top 1; 4 until phase
      14), the same;
   c. (a)'s model in 2 gloo ranks on this card (``Server(comm=)``, EP
      2, 80 experts a rank): each rank prefills its 4 of the 8 rows and
      decodes 32 greedy tokens, its tokens equal and its logits within
      1e-4 of a one-card engine run of its rows at batch 4 (run in this
      process before the spawn, that model freed); the EP all_to_all's
      ms a tick (CUDA events), peak memory a rank;
   d. on four cards only: the same over NCCL, EP 4, 40 experts and 2
      rows a rank.
14. Production precision (bf16 parameters, compute and optimizer
   state: ``launch.train.production``, the reference's dry-run config),
   each run through phase 4's ``run_main_path`` (audited, launches
   against ``expected_launches``, state bytes a stacked element, peak
   memory a 1e9 stacked elements), every line with the card:
   a. run 4a at production precision: its launch counts 4a's;
   b. (a) with ``store_anchor=False``: losses within
      PRECISION_LOSS_BAR of (a)'s at every step, its peak below (a)'s;
   c. phi4-mini-3.8b FULL width (4.45e9 parameters), ``--mode single``,
      batch 4 x 1024, production precision without the anchor, 4a's
      schedule: full depth (32 layers) if it fits, else the deepest of
      PHI4_DEPTHS that does;
   d. gpt2-smoke at production precision, card against CPU: one
      optimizer step from equal params, gradients and state (steps 0, 5
      and 6, with and without the anchor): the local step bit for bit,
      the sync steps at most SYNC_UNEQUAL of elements unequal; the
      8-step trainers within three times the card's own spread from
      params one bf16 ulp up; the one-step check again at fp16 state
      (with the anchor);
   e. run (a) with fp16 optimizer state (``state_dtype=torch.float16``,
      the paper's; bf16 params and compute): its losses, its state bytes
      a stacked element, its peak, the share of v at exactly zero (fp16
      underflows squared gradients, as in the reference), its launch
      counts (a)'s;
   f. gpt2 FULL served at the reference's serving precision (bf16
      params and compute, a bf16 cache) through the Scheduler, 8 slots,
      8 prompts of 512, 64 new tokens each: every request alone at batch
      1 (teacher-forced), its greedy tokens the batched run's except at
      a top-2 gap under BF16_LOGIT_ULPS bf16 ulps of the logits' scale;
      tick times and peak beside 7a's.
15. The port's three examples (``repro_torch.examples``: quickstart,
   compare_optimizers, serve_decode), each through its ``main`` on the
   card at REPRO_EXAMPLE_STEPS=4 (quickstart at fp16 state too).
16. Prints the kernels line (kernels 2-4 with their 7e and phase-5
   publish launches), the card line and the result line.

Any failure raises; there is no CPU fallback. Exits non-zero without a
result when there is no CUDA device or the repository's src/ is missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth
# and f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
N_WORKERS, STEPS = 4, 8
BATCH, SEQ = 16, 1024               # gpt2 run
BERT_BATCH, BERT_SEQ = 32, 512      # bert runs
REPS, PLAIN_REPS = 20, 5
# kernel 1's plain version runs on row slabs of at most this many
# elements (every gpt2 and bert frame is one slab)
PLAIN_SLAB = 1 << 28
TIME_BATCH, TIME_BATCH_REPS = 20, 5   # batched kernel time: 5 x 20 launches
PROFILED_STEP = 6          # a sync step without a variance refresh (the
                           # baselines: a bf16 step, a 1-bit step)
# abs_rowsum: both sides sum up to 50,432 terms in different orders (the
# kernel: <= ~60 sequential adds per thread, then an 8-level tree; torch's
# reduction has a similar depth); rounding errors of random sign add like
# a random walk, so 64 ulp of the row sum bounds the gap with margin
ROWSUM_ULPS = 64
# delta = (lr*m')/sqrt(v+eps): both sides IEEE-round the product, the
# square root and the divide; held to the same 2 ulp as the reference
DELTA_ULPS = 2

KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "fused_local_step": ("src/repro_torch/kernels/csrc/fused_adam.cu",
                         "src/repro/kernels/fused_adam.py:55"),
    "abs_rowsum": ("src/repro_torch/kernels/csrc/onebit.cu",
                   "src/repro/kernels/onebit.py:120"),
    "ef_quantize": ("src/repro_torch/kernels/csrc/onebit.cu",
                    "src/repro/kernels/onebit.py:155"),
    "decompress": ("src/repro_torch/kernels/csrc/onebit.cu",
                   "src/repro/kernels/onebit.py:197"),
    "ef_compress": ("src/repro_torch/kernels/csrc/onebit.cu",
                    "src/repro/kernels/onebit.py:81"),
    "fused_local_step_sgd": ("src/repro_torch/kernels/csrc/fused_adam.cu",
                             "src/repro/kernels/fused_adam.py:100"),
}
# decompress at the BERT-Base frames: a second tally row, reported in the
# decompress entry under "bert_sync"
BERT_DECOMPRESS = "decompress (bert-base)"
KERNEL_ROWS = {k: k for k in KERNELS}
# kernel 1 at the BERT-Base frames under 0/1 LAMB (phase 3b): a further
# tally row, reported in the fused_local_step entry under "bert_lamb"
BERT_LAMB = "fused_local_step (bert-base, lamb)"
# the trust-scaled delta: kernel 1's delta (<= 2 ulp of the plain one)
# times the trust, one more rounding
TRUST_DELTA_ULPS = DELTA_ULPS + 1
# the frames of a gpt2 sync at 2 pods x 2 workers (phase 3c), and the
# BERT-Base slice frames of ef_compress: further tally rows, reported in
# each kernel's entry under "hier_sync"
HIER = {k: f"{k} (2 pods x 2)" for k in ("abs_rowsum", "ef_quantize",
                                         "decompress", "ef_compress")}
# the fused-bucket frames of phase 3d, flat and at 2 pods x 2: reported
# in each kernel's entry under "bucket_frames" and "bucket_frames_hier"
BUCKET = {k: f"{k} (buckets)" for k in ("abs_rowsum", "ef_quantize",
                                        "decompress")}
BUCKET_HIER = {k: f"{k} (buckets, 2 pods x 2)" for k in BUCKET}
# the kernels phase 3e holds at the frames of each training run of phase
# 9 (FRAMES_3E): further tally rows, reported in each entry under
# "family_frames"
FAMILY_KERNELS = ("fused_local_step", "abs_rowsum", "ef_quantize",
                  "decompress")
# the round each kernel's "ms" sums over, on its own path
PER = {"fused_local_step": "step (gpt2)", "abs_rowsum": "sync (gpt2)",
       "ef_quantize": "sync (gpt2)", "decompress": "sync (gpt2)",
       "ef_compress": "sync (bert-base, row scales)",
       "fused_local_step_sgd": "step (bert-base)"}
# (label, arch, extra CLI flags, batch, seq, data kind)
# phase 6: spawned ranks that have not finished by then are killed
DIST_TIMEOUT_S = 600
# step kinds of each optimizer's 8 steps under phase 4a's flags; step 0
# is the first call of every path (it carries one-time costs) and its
# own kind. 0/1 Adam: syncs at 0-4 and 6, variance at 0, 1 and 3 (none
# for 0/1-SGD). adam: a bf16 mean and a variance update every step.
# one_bit_adam (--onebit-warmup 2): full precision and variance at 0-1,
# then a 1-bit exchange every step.
STEP_KINDS = {"first (0)": [0], "sync + variance (1, 3)": [1, 3],
              "sync (2, 4, 6)": [2, 4, 6], "local only (5, 7)": [5, 7]}
BASELINE_KINDS = {
    "adam": {"first (0)": [0], "bf16 mean + variance (1-7)": [1, 2, 3, 4,
                                                               5, 6, 7]},
    "one_bit_adam": {"first (0)": [0], "full precision + variance (1)": [1],
                     "1-bit (2-7)": [2, 3, 4, 5, 6, 7]}}
# LAMB's styles keep their Adam counterparts' schedules
BASELINE_KINDS["lamb"] = BASELINE_KINDS["adam"]
BASELINE_KINDS["one_bit_lamb"] = BASELINE_KINDS["one_bit_adam"]
ONEBIT = ["--optimizer", "one_bit_adam", "--onebit-warmup", "2"]
LAMB = ["--optimizer", "zero_one_lamb"]
QINT8 = ["--codec", "qint8"]
# the dense codecs of run 4m and phase 5 (topk at its default density)
CODECS = {"topk": ["--codec", "topk", "--codec-arg", "0.01"],
          "qint8": QINT8, "qint4": ["--codec", "qint4"]}
# the phase-4 runs whose final params are digested (4h against 4a)
GPT2_DIGESTS = ("gpt2", "gpt2_bucketed", "gpt2_one_leaf")
# phase 3i: the kernels that read or write optimizer state, at bf16
# operands; further tally rows, reported in each kernel's entry under
# "production_precision"
PRECISION = {k: f"{k} (bf16 state)" for k in (
    "fused_local_step", "abs_rowsum", "ef_quantize", "ef_compress",
    "fused_local_step_sgd")}
# the same kernels at fp16 state (the paper's), after the bf16 rows
PRECISION_FP16 = {k: f"{k} (fp16 state)" for k in PRECISION}
# 14b's losses against 14a's, at every step: the anchor-free re-anchor
# differs from the stored one by f32 and bf16 roundings, which the
# bf16 params carry on (the reference's own two gpt2-smoke runs differ by
# 5.4e-4 at step 3)
PRECISION_LOSS_BAR = 0.05
# 14d: the share of bf16 params and state elements a sync step from
# equal inputs may leave unequal between the card and the CPU: the
# kernel's scales are f32 sums in another order than torch's (within
# ROWSUM_ULPS), and a bf16 rounding passes an ulp on rarely (measured
# 1.1e-5 to 2.3e-5 on an H100; a kernel fault in a tail or a slab
# touches more)
SYNC_UNEQUAL = 1e-4
# 14c: phi4-mini-3.8b FULL width in single mode, deepest depth that fits
PHI4_DEPTHS = (32, 28, 24, 16)
PHI4_BATCH = 4
# the two-level exchange of runs 4d, 6c and phase 3c: pods of 2 workers
INNER = 2
# the bucketed exchange of runs 4g, 4i, 6a, 6b and phase 3d: 25 MiB
# buckets (gpt2 FULL: 16 exchange units at any budget from 0.25 to 25)
BUCKET_MB = 25
BUCKETED = ["--bucket-mb", str(BUCKET_MB)]
RUNS = [("gpt2", "gpt2", [], BATCH, SEQ, "lm"),
        ("bert_row", "bert-base", ["--scale-mode", "row"], BERT_BATCH,
         BERT_SEQ, "mlm"),
        ("bert_sgd", "bert-base", ["--optimizer", "zero_one_sgd"],
         BERT_BATCH, BERT_SEQ, "mlm"),
        ("gpt2_hier", "gpt2", ["--hierarchy", str(INNER)], BATCH, SEQ,
         "lm"),
        ("gpt2_adam", "gpt2", ["--optimizer", "adam"], BATCH, SEQ, "lm"),
        ("gpt2_onebit", "gpt2", ONEBIT, BATCH, SEQ, "lm"),
        ("gpt2_bucketed", "gpt2", BUCKETED, BATCH, SEQ, "lm"),
        ("gpt2_one_leaf", "gpt2", ["--bucket-mb", "1e-6"], BATCH, SEQ,
         "lm"),
        ("bert_lamb", "bert-base", LAMB, BERT_BATCH, BERT_SEQ, "mlm"),
        ("bert_lamb_mean", "bert-base", ["--optimizer", "lamb"],
         BERT_BATCH, BERT_SEQ, "mlm"),
        ("bert_onebit_lamb", "bert-base", ["--optimizer", "one_bit_lamb",
                                           "--onebit-warmup", "2"],
         BERT_BATCH, BERT_SEQ, "mlm")] + [
    (f"gpt2_{name}", "gpt2", flags, BATCH, SEQ, "lm")
    for name, flags in CODECS.items()]


def optimizer_of(argv) -> str:
    return (argv[argv.index("--optimizer") + 1] if "--optimizer" in argv
            else "zero_one_adam")


def step_kinds(argv):
    return BASELINE_KINDS.get(optimizer_of(argv), STEP_KINDS)


def schedule(optimizer, has_variance):
    """(sync, variance) flags of the 8 steps under phase 4a's flags."""
    if optimizer in ("adam", "lamb"):
        return [1] * STEPS, [1] * STEPS
    if optimizer in ("one_bit_adam", "one_bit_lamb"):
        return [1] * STEPS, [1, 1] + [0] * (STEPS - 2)
    return ([1, 1, 1, 1, 1, 0, 1, 0],
            [1, 1, 0, 1, 0, 0, 0, 0] if has_variance else [0] * STEPS)


def step_bytes(opt, records):
    """Bytes one worker sends in each step (static, from
    ``comm_accounting``): the codec's payloads on each 1-bit round (a T_u
    step of the accumulate style, a step of the gradient style past its
    full-precision stage) and one full-precision round (bf16, the
    reference's ring convention) on each variance round and each step
    of the mean style."""
    from repro_torch.core.compressed import comm_accounting

    acct, style = comm_accounting(opt), opt.cfg.style
    return [bool(r["sync"]) * (style == "accumulate" or not r["var"])
            * (style != "mean") * acct["compressed_bytes_per_sync"]
            + bool(r["var"] or style == "mean")
            * acct["fullprec_bytes_per_round"] for r in records]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int, batch: int = 1) -> float:
    """Median CUDA-event time of one run of ``fn``, after one warm-up
    run: over ``reps`` event pairs, each around ``batch`` runs back to
    back. With batch 1 the time includes the host's call and launch
    overhead whenever the card is faster than the host; a batch lets the
    host enqueue while the card runs, so it reads the device's own time
    wherever the kernel is the slower of the two."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / batch)
    return statistics.median(ts)


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ai = a.contiguous().view(torch.int32).long()
    bi = b.contiguous().view(torch.int32).long()
    return int((ai - bi).abs().max().item()) if a.numel() else 0


class Tally:
    """Per-kernel totals over the launches of one step (or one sync)."""

    def __init__(self):
        self.rows = {k: {"ms": 0.0, "batched_ms": 0.0, "plain_ms": 0.0,
                         "bytes": 0.0, "ops": 0.0, "library_ms": None,
                         "max_abs_err": 0.0, "launches_per_round": 0}
                     for k in [*KERNELS, BERT_DECOMPRESS, BERT_LAMB,
                               *HIER.values(), *PRECISION.values(),
                               *PRECISION_FP16.values(),
                               *(n for names in {**FAMILY_NAMES,
                                                 **MOE_NAMES,
                                                 **SSM_NAMES,
                                                 **VLM_ENCDEC_NAMES}.values()
                                 for n in names.values()),
                               *BUCKET.values(), *BUCKET_HIER.values()]}

    def add(self, name, fn, plain_fn, nbytes, ops, err, library=None,
            times=1):
        """Time the wrapper ``fn`` (one call per event pair, and in
        batches), its plain version and, where one PyTorch call computes
        the same function, that call ``library``; add ``times`` launches
        of this frame to the round."""
        r = self.rows[name]
        r["ms"] += times * time_ms(fn, REPS)
        r["batched_ms"] += times * time_ms(fn, TIME_BATCH_REPS, TIME_BATCH)
        r["plain_ms"] += times * time_ms(plain_fn, PLAIN_REPS)
        r["bytes"] += times * nbytes
        r["ops"] += times * ops
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["launches_per_round"] += times
        if library is not None:
            r["library_ms"] = ((r["library_ms"] or 0.0)
                               + times * time_ms(library, REPS))


def full_plan(arch, inner=None):
    from repro_torch.configs.base import get
    from repro_torch.core.comm import Hierarchy
    from repro_torch.core.leafwise import make_plan
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    tmpl = T.model_template(get(arch).config)
    return make_plan(L.param_shapes(tmpl), L.param_specs(tmpl),
                     L.dp_mask(tmpl), N_WORKERS,
                     Hierarchy(inner) if inner else None)


def bucket_layouts(inner=None):
    """The layouts of gpt2 FULL's fused buckets of more than one leaf at
    BUCKET_MB (the frames the bucketed exchange adds)."""
    from repro_torch.core import bucketing as BK

    bp = BK.make_bucket_plan(full_plan("gpt2", inner), BUCKET_MB)
    return [b.layout for b in bp.buckets if len(b.members) > 1]


def n_units(arch="gpt2", bucket_mb=BUCKET_MB, pack_order="flat"):
    """Exchange units of ``arch`` FULL at ``bucket_mb`` (4 workers)."""
    from repro_torch.core import bucketing as BK

    return len(BK.make_bucket_plan(full_plan(arch), bucket_mb,
                                   pack_order=pack_order).buckets)


def flat_frames(lo, n=N_WORKERS):
    """(rows, row counts, denominators, decode) of a flat tensor-scale
    sync's two frames of ``lo``, ``n`` workers stacked: the worker side
    on the views, the server side on the chunks."""
    from repro_torch.core import compressor as C

    rows, _ = C.view_rows_cols(lo)
    total, _ = C.true_counts(lo)
    return [(n * rows, np.tile(C.view_row_counts(lo), n),
             np.full(n, total), True),
            (rows, C.chunk_row_counts(lo).reshape(-1),
             np.full(n, total), False)]


def hier_frames(lo):
    """The same at pods of INNER: stacked workers w = k * INNER + j own
    inner slice j (the worker side), worker w serves chunk j * n_outer +
    k (the server side)."""
    from repro_torch.core import compressor as C

    rows, _ = C.view_rows_cols(lo)
    j = np.arange(N_WORKERS) % INNER
    widx = j * (N_WORKERS // INNER) + np.arange(N_WORKERS) // INNER
    totals, _ = C.slice_true_counts(lo)
    chunks = C.chunk_row_counts(lo)[widx]
    return [(N_WORKERS * rows // INNER,
             C.slice_row_counts(lo)[j].reshape(-1),
             np.maximum(totals[j], 1.0), True),
            (rows, chunks.reshape(-1), np.maximum(chunks.sum(1), 1.0),
             False)]


def row_slabs(rows, cols):
    """Row slices of a (rows, cols) frame of at most PLAIN_SLAB elements
    each (one slice where the frame fits), over which kernel 1's plain
    version runs: its exact multiply-add holds ~7 float64 temporaries of
    the frame's size."""
    step = max(1, PLAIN_SLAB // max(cols, 1))
    return [slice(r, min(r + step, rows)) for r in range(0, rows, step)]


def inplace_step(g, m, u, v, lr, b1):
    """Kernel 1 in place, as the optimizer calls it, on copies of ``g``,
    ``m`` and ``u``: m and u updated, the delta written over the copy of
    the gradient (``v`` None: the SGD kernel). Returns its (m', u',
    delta) and a closure that repeats the in-place call on the same
    copies (for timing; it overwrites them, so compare first)."""
    from repro_torch.kernels import fused_adam as FA

    gk, mk, uk = g.clone(), m.clone(), u.clone()
    if v is None:
        def call():
            return FA.fused_local_step_sgd_(gk, mk, uk, lr, b1, d=gk)
    else:
        def call():
            return FA.fused_local_step_(gk, mk, uk, v, lr, b1, d=gk)
    dk = call()
    assert dk.data_ptr() == gk.data_ptr(), "the delta is not over g"
    return (mk, uk, dk), call


def check_kernels(dev, tally, plan=None, names=KERNEL_ROWS, n=N_WORKERS,
                  frames=None):
    """Phase 3a: the gpt2 path's kernels vs their plain versions at
    gpt2-FULL frames, ``n`` workers stacked (3e: ``plan``'s frames,
    tallied under ``names``; ``frames(lo)`` the compress frames of leaf
    ``lo``, by default :func:`flat_frames`)."""
    from repro_torch.core import compressor as C
    from repro_torch.kernels import fused_adam as FA

    plan = full_plan("gpt2") if plan is None else plan
    gen = torch.Generator(device=dev).manual_seed(0)
    lr, b1 = np.float32(1.5e-4), 0.9
    for lo in plan.layouts:
        rows, cols = C.view_rows_cols(lo)
        R = n * rows
        cnt = torch.as_tensor(np.tile(C.view_row_counts(lo), n),
                              device=dev)
        mask = torch.arange(cols, device=dev)[None, :] < cnt[:, None]

        def rnd(scale=1.0):
            return (torch.randn(R, cols, device=dev, generator=gen)
                    * scale * mask)

        # --- fused local step (once per leaf per step), in place as the
        # optimizer calls it: m and u updated, the delta over g ---------
        g, m, u = rnd(), rnd(), rnd(1e-3)
        v = rnd(1e-2).square()
        fk, step_ = inplace_step(g, m, u, v, lr, b1)
        slabs, err = row_slabs(R, cols), 0.0
        for sl in slabs:
            fp = FA.fused_local_step_plain(g[sl], m[sl], u[sl], v[sl], lr, b1)
            torch.cuda.synchronize()
            assert torch.equal(fk[0][sl], fp[0]), (lo.shape, "m' differs")
            assert torch.equal(fk[1][sl], fp[1]), (lo.shape, "u' differs")
            assert ulps(fk[2][sl], fp[2]) <= DELTA_ULPS, (lo.shape, "delta")
            err = max([err] + [float((a[sl] - b).abs().max())
                               for a, b in zip(fk, fp)])
            del fp
            # the baselines' plain step: its multiply-adds on the card are
            # single-rounding, bit for bit the exact emulation (at f32
            # scalars, as the step passes them)
            gs, ms, vs = g[sl], m[sl], v[sl]
            for a_, b_, c_ in ((ms, float(np.float32(b1)), gs * 0.1),
                               (gs * 1e-3, gs, vs * 0.999),
                               (fk[2][sl], -1.0, ms)):
                assert torch.equal(FA.fma(a_, b_, c_),
                                   FA.fma_f32(a_, b_, c_)), (lo.shape, "fma")

        def plain():
            for sl in slabs:
                FA.fused_local_step_plain(g[sl], m[sl], u[sl], v[sl], lr, b1)

        ne = R * cols
        tally.add(names["fused_local_step"], step_, plain, 28.0 * ne,
                  7.0 * ne, err)
        del g, m, u, v, fk, step_

        # --- worker and server compress (once each per leaf per sync) --
        check_compress_frames(dev, gen, tally, names, lo, cols,
                              flat_frames(lo, n) if frames is None
                              else frames(lo), n)
        torch.cuda.empty_cache()
        print(f"  leaf {lo.shape}: frame ({R}, {cols}) ok", flush=True)


def check_compress_frames(dev, gen, tally, names, lo, cols, frames,
                          n=N_WORKERS, err_dtype=torch.float32):
    """The two-pass compress of one sync's frames of leaf ``lo``, each
    kernel against its plain version, tallied under ``names[kernel]``
    (``names`` None: checked only): abs_rowsum with its scale groups (G
    groups of equal consecutive rows, group g's row sums over
    ``denoms[g]``), then ef_quantize against those compact scales, and
    where ``decode`` is set both decodes of a sync on that frame's shape.
    Each of the ``n`` stacked workers' scales (its G / n groups) must also
    be the same bits from its own rows alone as from the stack (what makes
    a rank of the multi-process regime bitwise its simulated worker).
    ``frames``: (rows, row counts, denoms, decode). ``err_dtype``: the
    error feedback's dtype (the optimizer's state_dtype; err_out comes
    back in it)."""
    from repro_torch.kernels import onebit as OB

    esize = torch.tensor([], dtype=err_dtype).element_size()
    for frame_rows, cnt_np, denom, decode in frames:
        counts = torch.as_tensor(cnt_np, device=dev)
        fmask = torch.arange(cols, device=dev)[None, :] < counts[:, None]
        z = torch.randn(frame_rows, cols, device=dev, generator=gen) * fmask
        e = (torch.randn(frame_rows, cols, device=dev,
                         generator=gen) * 0.3 * fmask).to(err_dtype)
        d = torch.as_tensor(denom, dtype=torch.float32, device=dev)
        groups = d.numel()
        gr, gw = frame_rows // groups, groups // n
        rk, sk = OB.abs_rowsum_scales(z, e, counts, gr, d)
        rp, sp = OB.abs_rowsum_scales_plain(z, e, counts, gr, d)
        torch.cuda.synchronize()
        assert ulps(rk, rp) <= ROWSUM_ULPS, (lo.shape, "abs_rowsum rows")
        assert ulps(sk, sp) <= ROWSUM_ULPS, (lo.shape, "abs_rowsum scales")
        for w in range(n):
            own = slice(w * gw * gr, (w + 1) * gw * gr)
            _, sw = OB.abs_rowsum_scales(z[own].clone(), e[own].clone(),
                                         counts[own].clone(), gr,
                                         d[w * gw:(w + 1) * gw].clone())
            assert torch.equal(sw, sk[w * gw:(w + 1) * gw]), (
                lo.shape, frame_rows, w, "a worker's scale depends on the "
                "stack")
        pk, ek = OB.ef_quantize(z, e, sk, counts, gr)
        pp, ep = OB.ef_quantize_plain(z, e, sk, counts, gr)
        torch.cuda.synchronize()
        assert torch.equal(pk, pp), (lo.shape, "packed bytes differ")
        assert torch.equal(ek, ep), (lo.shape, "err_out differs")
        if names is None:
            del z, e, rk, rp, sk, sp, pk, pp, ek, ep
            continue
        true_elems = float(counts.sum())
        tally.add(names["abs_rowsum"],
                  lambda: OB.abs_rowsum_scales(z, e, counts, gr, d),
                  lambda: OB.abs_rowsum_scales_plain(z, e, counts, gr, d),
                  (4.0 + esize) * true_elems + 8.0 * (frame_rows + groups),
                  3.0 * true_elems,
                  max(float((rk - rp).abs().max()),
                      float((sk - sp).abs().max())),
                  library=lambda: (z + e).abs().sum(1))
        ne = frame_rows * cols
        tally.add(names["ef_quantize"],
                  lambda: OB.ef_quantize(z, e, sk, counts, gr),
                  lambda: OB.ef_quantize_plain(z, e, sk, counts, gr),
                  (4.125 + 2.0 * esize) * ne + 4.0 * (frame_rows + groups),
                  3.0 * ne, 0.0)
        if decode:
            # the all_to_all receive and the gathered results
            s = sk.repeat_interleave(gr)
            dk = OB.decompress(pk, s)
            dp = OB.decompress_plain(pk, s)
            torch.cuda.synchronize()
            assert torch.equal(dk, dp), (lo.shape, "decompress")
            tally.add(names["decompress"], lambda: OB.decompress(pk, s),
                      lambda: OB.decompress_plain(pk, s),
                      4.125 * ne + 4.0 * frame_rows, 1.0 * ne, 0.0,
                      times=2)
            del dk, dp, s
        del z, e, rk, rp, sk, sp, pk, pp, ek, ep


def row_scale_frames(lo, dev):
    """(rows, row counts, group denominators, decode False) of the
    two-pass frames of leaf ``lo`` in a row-scale sync of N_WORKERS
    stacked workers (run bert_row), as kernels/dispatch.py builds them:
    the worker side wherever the single pass does not take the view (chunk
    scales on a 2-D view, one group per (chunk, chunk row) on a 4-D one),
    and the server chunks of views of 3 or more dims (row groups; a 2-D
    view's server side is per element, plain torch)."""
    from repro_torch.core import compressor as C
    from repro_torch.kernels import dispatch as K

    rows, _ = C.view_rows_cols(lo)
    vs, rf, d = lo.view_shape, lo.rest_factor, str(dev)
    out = []
    if not (len(vs) == 3 and rf == 1):
        cnts, *denoms = K._worker_counts(lo, N_WORKERS, None, d)
        g, _ = K._scale_groups(vs, "chunk" if len(vs) == 2 else "row", rf,
                               denoms, N_WORKERS, d)
        out.append((N_WORKERS * rows, cnts, g, False))
    if len(vs) >= 3:
        cnts, _ = K._server_counts(lo, tuple(range(N_WORKERS)), d)
        g, _ = K._scale_groups((1,) + tuple(lo.chunk_shape), "row", rf, None,
                               N_WORKERS, d)
        out.append((N_WORKERS * (rows // lo.n), cnts, g, False))
    return out


def check_ef_compress_frame(z, e, cnt):
    """ef_compress against its plain version on one frame; returns the
    largest scale difference."""
    from repro_torch.kernels import onebit as OB

    pk, sk, ek = OB.ef_compress(z, e, cnt)
    pp, sp, _ = OB.ef_compress_plain(z, e, cnt)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp), (tuple(z.shape), "packed bytes differ")
    assert ulps(sk, sp) <= ROWSUM_ULPS, (tuple(z.shape), "scales")
    # same scales, same residual: err_out against the plain quantizer
    # given the kernel's own scales
    assert torch.equal(ek, OB.ef_quantize_plain(z, e, sk, cnt)[1]), (
        tuple(z.shape), "err_out differs")
    return float((sk - sp).abs().max())


def check_bert_kernels(dev, tally):
    """Phase 3b: ef_compress at the 3-D frames of BERT-Base FULL (where
    row scales take the single pass) plus a frame with pad rows,
    fused_local_step_sgd, decompress and fused_local_step (with 0/1
    LAMB's trust scaling after it) at all 20 BERT-Base frames, and
    abs_rowsum and ef_quantize at the row-scale run's two-pass worker and
    server frames (:func:`row_scale_frames`), 4 workers stacked."""
    from repro_torch.core import compressor as C
    from repro_torch.kernels import fused_adam as FA
    from repro_torch.kernels import onebit as OB

    gen = torch.Generator(device=dev).manual_seed(1)
    lr, b1 = np.float32(1.5e-4), 0.9
    compress_frame = check_ef_compress_frame

    # a frame with whole pad rows, ragged tails and one-element rows: only
    # checked (no BERT-Base frame has pad rows)
    cols = 3072
    cnt = torch.tensor([cols, cols // 2 + 1, 0, 1] * 16, dtype=torch.int32,
                       device=dev)
    z = torch.randn(64, cols, device=dev, generator=gen)
    compress_frame(z, z.flip(0) * 0.3, cnt)
    print(f"  ef_compress pad-row frame (64, {cols}) ok", flush=True)

    for lo in full_plan("bert-base").layouts:
        rows, cols = C.view_rows_cols(lo)
        R, n = N_WORKERS * rows, N_WORKERS * rows * cols
        cnt = torch.as_tensor(np.tile(C.view_row_counts(lo), N_WORKERS),
                              device=dev)
        mask = torch.arange(cols, device=dev)[None, :] < cnt[:, None]

        def rnd(scale=1.0):
            return (torch.randn(R, cols, device=dev, generator=gen)
                    * scale * mask)

        # --- fused SGD local step (once per leaf per step), in place ---
        g, m, u = rnd(), rnd(), rnd(1e-3)
        fk, step_ = inplace_step(g, m, u, None, lr, b1)
        fp = FA.fused_local_step_sgd_plain(g, m, u, lr, b1)
        torch.cuda.synchronize()
        for what, a, b in zip(("m'", "u'", "delta"), fk, fp):
            assert torch.equal(a, b), (lo.shape, what + " differs")
        tally.add("fused_local_step_sgd", step_,
                  lambda: FA.fused_local_step_sgd_plain(g, m, u, lr, b1),
                  24.0 * n, 6.0 * n, 0.0)
        del fk, fp, step_

        # --- the Adam kernel as 0/1 LAMB's local step (once per leaf per
        # step): its delta then scaled by each stacked worker's trust
        v = rnd(1e-2).square()
        trust = (torch.rand(N_WORKERS, device=dev, generator=gen) * 10
                 ).repeat_interleave(rows)[:, None]
        fk, step_ = inplace_step(g, m, u, v, lr, b1)
        fp = FA.fused_local_step_plain(g, m, u, v, lr, b1)
        torch.cuda.synchronize()
        assert torch.equal(fk[0], fp[0]), (lo.shape, "lamb m' differs")
        assert torch.equal(fk[1], fp[1]), (lo.shape, "lamb u' differs")
        assert ulps(fk[2], fp[2]) <= DELTA_ULPS, (lo.shape, "lamb delta")
        assert ulps(trust * fk[2], trust * fp[2]) <= TRUST_DELTA_ULPS, (
            lo.shape, "trust-scaled delta")
        err = max(float((a - b).abs().max()) for a, b in zip(fk, fp))
        tally.add(BERT_LAMB, step_,
                  lambda: FA.fused_local_step_plain(g, m, u, v, lr, b1),
                  28.0 * n, 7.0 * n, err)
        del g, m, u, v, fk, fp, trust, step_

        # --- both decodes of a sync (run (b): every leaf; run (a) leaves
        # the gathered results of the 8 flatten leaves to torch ops) ----
        pk = torch.randint(0, 256, (R, cols // 8), dtype=torch.uint8,
                           device=dev, generator=gen)
        s = torch.rand(R, device=dev, generator=gen)
        dk = OB.decompress(pk, s)
        torch.cuda.synchronize()
        assert torch.equal(dk, OB.decompress_plain(pk, s)), (lo.shape,
                                                            "decompress")
        tally.add(BERT_DECOMPRESS, lambda: OB.decompress(pk, s),
                  lambda: OB.decompress_plain(pk, s),
                  4.125 * n + 4.0 * R, 1.0 * n, 0.0, times=2)
        del pk, s, dk

        # --- the two-pass frames of the row-scale run (checked only) ----
        check_compress_frames(dev, gen, None, None, lo, cols,
                              row_scale_frames(lo, dev))

        # --- single-pass worker compress (once per 3-D leaf per sync) --
        if len(lo.view_shape) == 3:
            z, e = rnd(), rnd(0.3)
            err = compress_frame(z, e, cnt)
            tally.add("ef_compress", lambda: OB.ef_compress(z, e, cnt),
                      lambda: OB.ef_compress_plain(z, e, cnt),
                      12.125 * n + 8.0 * R, 3.0 * n, err)
            del z, e
        torch.cuda.empty_cache()
        print(f"  leaf {lo.shape}: frame ({R}, {cols}) ok", flush=True)


def check_hier_kernels(dev, tally):
    """Phase 3c: the kernels at the frames of the two-level exchange,
    4 workers in pods of INNER, stacked workers w = k * INNER + j owning
    inner slice j (their row counts differ: the last slice holds the pad).
    gpt2 FULL, tensor scales: abs_rowsum and ef_quantize on each leaf's
    worker-side slice frame and on the server chunk frame (worker w
    serves chunk j * n_outer + k), decompress on the inter-pod receive
    and gather frames (both the slice frame's shape); BERT-Base FULL, row
    scales: ef_compress on the six 3-D slice frames."""
    from repro_torch.core import compressor as C
    from repro_torch.kernels import onebit as OB

    gen = torch.Generator(device=dev).manual_seed(2)
    j = np.arange(N_WORKERS) % INNER

    for lo in full_plan("gpt2", INNER).layouts:
        rows, cols = C.view_rows_cols(lo)
        check_compress_frames(dev, gen, tally, HIER, lo, cols,
                              hier_frames(lo))
        torch.cuda.empty_cache()
        print(f"  leaf {lo.shape}: slice frame "
              f"({N_WORKERS * rows // INNER}, {cols}), chunk frame "
              f"({rows}, {cols}) ok", flush=True)

    for lo in full_plan("bert-base", INNER).layouts:
        if len(lo.view_shape) != 3:
            continue
        rows, cols = C.view_rows_cols(lo)
        R = N_WORKERS * rows // INNER
        counts = torch.as_tensor(C.slice_row_counts(lo)[j].reshape(-1),
                                 device=dev)
        m = torch.arange(cols, device=dev)[None, :] < counts[:, None]
        z = torch.randn(R, cols, device=dev, generator=gen) * m
        e = torch.randn(R, cols, device=dev, generator=gen) * 0.3 * m
        err = check_ef_compress_frame(z, e, counts)
        n = R * cols
        tally.add(HIER["ef_compress"], lambda: OB.ef_compress(z, e, counts),
                  lambda: OB.ef_compress_plain(z, e, counts),
                  12.125 * n + 8.0 * R, 3.0 * n, err)
        del z, e
        torch.cuda.empty_cache()
        print(f"  bert-base leaf {lo.shape}: slice frame ({R}, {cols}) ok",
              flush=True)


def check_bucket_kernels(dev, tally):
    """Phase 3d: abs_rowsum, ef_quantize and decompress at the frames of
    gpt2 FULL's fused buckets (BUCKET_MB), worker and server side, flat
    and at 2 pods x 2, each against its plain version and timed as 3a
    and 3c (with each stacked worker's scales from its rows alone)."""
    from repro_torch.core import compressor as C

    gen = torch.Generator(device=dev).manual_seed(4)
    for inner, names, frames in ((None, BUCKET, flat_frames),
                                 (INNER, BUCKET_HIER, hier_frames)):
        for lo in bucket_layouts(inner):
            _, cols = C.view_rows_cols(lo)
            fr = frames(lo)
            check_compress_frames(dev, gen, tally, names, lo, cols, fr)
            print(f"  bucket {lo.view_shape}"
                  f"{' at 2 pods x 2' if inner else ''}: frames "
                  f"{[(r, cols) for r, *_ in fr]} ok", flush=True)


def expected_launches(label, layouts, units=None):
    """Launches each kernel makes in one run of RUNS[label], from the
    reference's routing: 8 steps, 6 syncs (one_bit_adam: 6 1-bit
    rounds), every leaf one launch per phase (the stacked workers share
    it). The two-level exchange (gpt2_hier) makes as many: its worker
    side compresses the owned slice where the flat one compresses the
    view, its server side one chunk each, its two decodes are inter-pod,
    and its intra-pod phases and full-precision rounds launch no
    kernel. With a bucketed exchange (``units``: its exchange units) the
    local step still launches per leaf and the exchange per unit
    (tensor scales)."""
    n_syncs = 6
    nd = [len(lo.view_shape) for lo in layouts]
    leaves, flat = len(nd), nd.count(2)
    units = leaves if units is None else units
    if label in ("gpt2_adam", "bert_lamb_mean"):
        return {}       # bf16 means and a plain step: no kernel
    if label in [f"gpt2_{c}" for c in CODECS]:
        # the dense codecs are plain torch ops: the local step only
        return {"fused_local_step": STEPS * leaves}
    if label in ("gpt2_onebit", "bert_onebit_lamb"):
        # six 1-bit rounds of the gradient (steps 2-7); the plain step
        # never reaches the fused local step
        return {k: n_syncs * 2 * leaves
                for k in ("abs_rowsum", "ef_quantize", "decompress")}
    if label == "bert_row":
        single = nd.count(3)            # worker side, row scales on 3-D
        two_pass = (leaves - single) + (leaves - flat)   # worker + server
        return {"fused_local_step": STEPS * leaves,
                "ef_compress": n_syncs * single,
                "abs_rowsum": n_syncs * two_pass,
                "ef_quantize": n_syncs * two_pass,
                # all_to_all decode of every leaf; gather decode except
                # the per-element scales of 2-D views (plain torch ops)
                "decompress": n_syncs * (2 * leaves - flat)}
    step = ("fused_local_step_sgd" if label == "bert_sgd"
            else "fused_local_step")
    return {step: STEPS * leaves, "abs_rowsum": n_syncs * 2 * units,
            "ef_quantize": n_syncs * 2 * units,
            "decompress": n_syncs * 2 * units}


def first_loss(cfg) -> float:
    """The loss expected at a random init (scale 0.02): log(padded vocab)
    plus half the variance of the logits, 0.02**2 * d_model for the
    rotary family's unit-RMS final norm (gpt2 and bert: log(padded
    vocab), the check they always had)."""
    lv = float(np.log(cfg.padded_vocab))
    return lv + (0.5 * 0.02 ** 2 * cfg.d_model
                 if cfg.norm_type == "rmsnorm" else 0.0)


def run_main_path(dev, label, arch, extra, batch, seq, kind,
                  workers=N_WORKERS, n_layers=None, check_first_grads=False,
                  configure=None):
    """Phase 4: one main path, 4 simulated workers, 8 steps, through
    ``launch.train``, on a recording comm whose log is audited after the
    run (:func:`audit_run`). Returns the per-step records, the launch
    counts, the peak memory, the audit's summary and, for the gpt2 runs
    4a, 4e and 4f, the profile of step 6. Phase 9 runs the rotary family
    through it at ``workers`` simulated workers (one: single mode), cut
    to ``n_layers``; phase 11 asks ``check_first_grads``: every gradient
    of step 0 finite (:func:`finite_first_grads`); phase 14 a
    ``configure`` (``launch.make_trainer``'s). Each run also reports its
    state bytes a stacked parameter element (:func:`state_report`) and
    its peak memory a 1e9 stacked elements."""
    from repro_torch import analysis
    from repro_torch.core.comm import NullComm, SimComm
    from repro_torch.kernels import build
    from repro_torch.launch import train as launch

    mode = (["--mode", "sim", "--workers", str(workers)] if workers > 1
            else ["--mode", "single"])
    args = launch.parse_args([
        "--arch", arch, *mode, "--steps", str(STEPS), "--batch", str(batch),
        "--seq", str(seq), "--sync-warmup", "2", "--double-every", "2",
        "--kappa", "1", "--log-every", "1"] + extra)
    comm = analysis.RecordingComm(SimComm(workers) if workers > 1
                                  else NullComm())
    with cut_depth(n_layers):
        tr = launch.make_trainer(args, device=dev, comm=comm,
                                 configure=configure)
    trace = analysis.watch(tr)
    trusts = (track_trust(tr) if tr.opt.base.has_trust
              and tr.opt.cfg.style == "accumulate" else None)
    torch.cuda.synchronize()
    before_gb = torch.cuda.memory_allocated() / 1e9
    parts = track_peaks(tr)
    grads0 = finite_first_grads(tr) if check_first_grads else None
    build.launch_counts.clear()
    res = launch.train(args, tr, kind=kind, keep_step=(
        PROFILED_STEP if label in ("gpt2", "gpt2_adam", "gpt2_onebit")
        else None))
    counts = dict(build.launch_counts)
    for obj, attr in ((tr, "init"), (tr, "grads"), (tr.opt, "step")):
        delattr(obj, attr)          # the class's own methods again
    peak_gb = max(parts.values())
    print(f"  launches {json.dumps(counts)}; peak memory {peak_gb:.1f} GB "
          f"(init {parts['init']:.2f}, fwd/bwd {parts['fwd_bwd']:.2f}, "
          f"optimizer {parts['optimizer']:.2f}; allocated before the run "
          f"{before_gb:.2f})", flush=True)
    audit = audit_run(label, tr, trace)

    steps = res["records"]
    losses = [float(np.mean(s["losses"])) for s in steps]
    assert all(np.isfinite(losses)), losses
    # random init at scale 0.02: near-uniform logits over the padded vocab
    assert abs(losses[0] - first_loss(tr.model_cfg)) < 0.5, (
        losses[0], first_loss(tr.model_cfg))
    syncs, vars_ = schedule(args.optimizer, tr.opt.base.has_variance)
    assert [s["sync"] for s in steps] == syncs
    assert [s["var"] for s in steps] == vars_
    expect = expected_launches(label, tr.opt.layouts, len(tr.opt.units))
    assert counts == expect, (label, counts, expect)
    if trusts is not None:
        # one (min, max) over every leaf and worker per sync
        print(f"  trust at the syncs (min, max): "
              f"{[(round(a, 5), round(b, 5)) for a, b in trusts]}",
              flush=True)
        assert len(trusts) == sum(syncs), trusts
        assert all(np.isfinite([a, b]).all() and 0 <= a <= b <= 10
                   for a, b in trusts), trusts
    if label.startswith("gpt2_") and label[5:] in CODECS:
        from repro_torch.core.compressed import comm_accounting

        acct = comm_accounting(tr.opt)
        print(f"  {acct['codec']}: {acct['compressed_bytes_per_sync'] / 2**20:.2f}"
              f" MiB a worker sends per sync (sign1bit: "
              f"{sign1bit_sync_mib():.2f} MiB)", flush=True)
    if label == "gpt2_bucketed":
        from repro_torch.core.compressed import comm_accounting

        acct = comm_accounting(tr.opt)
        print(f"  exchange units {acct['exchange_units']:.0f} over "
              f"{acct['dp_leaves']:.0f} leaves; "
              f"{acct['collectives_per_sync']:.0f} collective phases a "
              f"sync", flush=True)
        assert acct["exchange_units"] == 16, acct
    digest = (params_sha256(res["params"]) if label in GPT2_DIGESTS
              else None)
    if digest:
        print(f"  final params sha256 {digest}", flush=True)
    print_times(times_by_kind(steps, step_kinds(extra)))
    wire = step_bytes(tr.opt, steps)
    print(f"  wire MiB per worker and step "
          f"{[round(b / 2**20, 2) for b in wire]}; total {sum(wire) / 2**20:.2f} MiB in "
          f"{sum(1 for b in wire if b)} steps that exchange", flush=True)
    state = state_report(res["params"], res["state"])
    per_1e9 = peak_gb / (state["stacked_elements"] / 1e9)
    print(f"  {state['stacked_elements'] / 1e9:.4f}e9 stacked elements; "
          f"state {state['state_bytes_per_element']:.2f} B an element; peak "
          f"{per_1e9:.2f} GB a 1e9 stacked elements", flush=True)
    kept = res["kept"]
    del res
    profile = profile_step(tr, *kept) if kept is not None else None
    del kept, tr
    if grads0 is not None:
        print(f"  step 0: {grads0['leaves']} gradient leaves, "
              f"{grads0['elements']:,} elements, all finite", flush=True)
    return {"steps": steps, "launches": counts, "peak_memory_gb": peak_gb,
            "first_grads": grads0, "state": state,
            "peak_gb_per_1e9_elements": per_1e9,
            "peak_parts_gb": parts, "allocated_before_gb": before_gb,
            "wire_bytes": wire, "profile": profile,
            "params_sha256": digest, "trust_at_syncs": trusts,
            "audit": audit}


def track_peaks(tr):
    """Peak device memory (GB) of each part of ``tr``'s run: ``init``,
    ``fwd_bwd`` (``Trainer.grads``) and ``optimizer`` (the optimizer's
    step), each the largest over its calls, the peak statistic reset
    before each call; their maximum is the run's peak (allocations
    between the parts stay allocated into the next)."""
    peaks = {"init": 0.0, "fwd_bwd": 0.0, "optimizer": 0.0}

    def wrap(obj, attr, part):
        fn = getattr(obj, attr)

        def measured(*a, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            peaks[part] = max(peaks[part],
                              torch.cuda.max_memory_allocated() / 1e9)
            return out
        setattr(obj, attr, measured)

    wrap(tr, "init", "init")
    wrap(tr, "grads", "fwd_bwd")
    wrap(tr.opt, "step", "optimizer")
    return peaks


def finite_first_grads(tr):
    """Wrap ``tr.grads`` so that its first call asserts every gradient
    finite (all stacked workers); returns the record it fills."""
    from repro_torch.core.leafwise import flatten_tree

    rec = {}
    fn = tr.grads

    def checked(*a, **k):
        losses, grads = fn(*a, **k)
        if not rec:
            leaves = flatten_tree(grads)[1]
            bad = [i for i, g in enumerate(leaves)
                   if not bool(torch.isfinite(g).all())]
            assert not bad, f"non-finite gradients at step 0: leaves {bad}"
            rec.update(leaves=len(leaves),
                       elements=sum(g.numel() for g in leaves))
        return losses, grads
    tr.grads = checked
    return rec


def audit_run(label, tr, trace):
    """The communication audit of a recorded run
    (``repro_torch.analysis.audit_trainer``): its collectives step by step
    against the declared manifests, the bytes each round sent against
    ``comm_accounting`` per level, dtypes. Prints the recorded bytes one
    worker sent in a sync and in a variance round, per level, beside
    ``comm_accounting``'s; raises on any violation. Returns the report's
    summary."""
    from repro_torch import analysis

    rep = analysis.audit_trainer(tr, trace=trace)
    s = rep.summary
    acct = s["accounting"]
    for name, key in (("sync", "compressed_bytes_per_sync"),
                      ("fullprec", "fullprec_bytes_per_round")):
        got = s["recorded_bytes"].get(name)
        if got is not None:
            print(f"  audit: {name} round recorded {got['inner']} B "
                  f"intra-pod + {got['outer']} B across = {got['total']} B "
                  f"a worker; comm_accounting {acct[key + '_inner']:.0f} + "
                  f"{acct[key + '_outer']:.0f}, headline {acct[key]:.0f}",
                  flush=True)
    print(f"  audit: {len(rep.collectives)} collectives recorded over "
          f"{s['steps']} steps ({', '.join(s['rounds'])}), "
          f"{s['sync_collectives_declared']} declared a sync, "
          f"{s['fullprec_collectives_declared']} a full-precision round: "
          f"{'clean' if rep.ok else 'VIOLATIONS'}", flush=True)
    assert rep.ok, (label, [v.to_dict() for v in rep.violations[:5]])
    return {**s, "collectives": len(rep.collectives)}


def track_trust(tr):
    """Wrap ``tr.step`` so that each sync appends the (min, max) of the
    carried trust over every leaf and worker to the returned list (read
    after the step's own timing)."""
    trusts, step = [], tr.step

    def traced(params, state, batch):
        params, state, met = step(params, state, batch)
        if met["synced"]:
            t = torch.cat([x.reshape(-1) for x in state.slots["trust"]])
            trusts.append((float(t.min()), float(t.max())))
        return params, state, met

    tr.step = traced
    return trusts


def sign1bit_sync_mib() -> float:
    """MiB one of 4 workers sends per sync of gpt2 FULL under sign1bit
    with tensor scales (``comm_accounting``)."""
    from repro_torch.configs.base import get
    from repro_torch.core import api
    from repro_torch.core.compressed import comm_accounting
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    tmpl = T.model_template(get("gpt2").config)
    opt = api.build_optimizer(api.OptimizerConfig(), L.param_shapes(tmpl),
                              specs=L.param_specs(tmpl),
                              dp_mask=L.dp_mask(tmpl), n_workers=N_WORKERS)
    return comm_accounting(opt)["compressed_bytes_per_sync"] / 2 ** 20


def params_sha256(params) -> str:
    """SHA-256 over the bytes of every parameter leaf, in flatten order:
    equal digests are bit-for-bit equal params."""
    import hashlib

    from repro_torch.core.leafwise import flatten_tree

    h = hashlib.sha256()
    for x in flatten_tree(params)[1]:
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def run_checkpoint(extra):
    """Phase 4i: gpt2 FULL width at FILE_LAYERS of its 12 layers, single
    mode, batch 4 x SEQ, 4a's flags (``extra``: the exchange's): 8
    uninterrupted steps, then 4
    steps with ``--save`` into a temporary directory in the checkout,
    ``Trainer.restore`` into a fresh trainer and steps 4-7 from it. The
    resumed run's losses and final params must be bit for bit the
    uninterrupted run's. Returns the file's size and the save and
    restore seconds; the file is deleted."""
    from repro_torch.launch import train as launch

    flags = ["--arch", "gpt2", "--mode", "single", "--batch", "4",
             "--seq", str(SEQ), "--sync-warmup", "2", "--double-every", "2",
             "--kappa", "1", "--log-every", str(STEPS), "--layers",
             str(FILE_LAYERS)] + extra
    whole = launch.parse_args(flags + ["--steps", str(STEPS)])
    ref = launch.train(whole, launch.make_trainer(whole))
    want = ([r["losses"] for r in ref["records"]],
            params_sha256(ref["params"]))
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    with scratch_dir() as tmp:
        path = os.path.join(tmp, "ck.npz")
        first = launch.parse_args(flags + ["--steps", "4", "--save", path])
        head = launch.train(first, launch.make_trainer(first))
        save_s, size = head["save_s"], os.path.getsize(path)
        losses = [r["losses"] for r in head["records"]]
        del head
        gc.collect()
        torch.cuda.empty_cache()
        tr = launch.make_trainer(whole)
        t0 = time.perf_counter()
        params, state, step, meta = tr.restore(path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        assert step == 4 and meta == {"arch": tr.model_cfg.name,
                                      "n_workers": 1}, (step, meta)
        tail = launch.train(whole, tr, start=(params, state, step))
    got = (losses + [r["losses"] for r in tail["records"]],
           params_sha256(tail["params"]))
    del tail, tr, params, state
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  checkpoint {' '.join(extra) or 'per leaf'}: {size / 1e9:.3f} "
          f"GB, save {save_s:.2f} s, restore {restore_s:.2f} s; resumed "
          f"losses bitwise {got[0] == want[0]}, params bitwise "
          f"{got[1] == want[1]} (sha256 {got[1]})", flush=True)
    assert got == want, ("the resumed run is not the uninterrupted one",
                         extra, got, want)
    return {"file_bytes": size, "save_s": save_s, "restore_s": restore_s,
            "params_sha256": got[1]}


# ----------------------------------------------------------------------- #
# phase 4n: elastic data parallelism (repro_torch.elastic) on gpt2 FULL
# ----------------------------------------------------------------------- #

# (ii): kill workers 1 and 3 before step 3 (4 -> 2), rejoin before 5
FLEET_EVENTS = [(3, 2, (0, 2)), (5, 4)]
# (iii): steps trained before the reshards; per BENCH_elastic.json
# scenario, the run's flags and the survivors of its 4 -> 2 resize
GEOMETRY_STEPS = 3
GEOMETRIES = {"hier_4to2_podkill": (["--hierarchy", str(INNER)], (0, 1)),
              "bucketed_4to2_kill1": (BUCKETED, (0, 2))}
# the fields of a reshard report that the resize alone decides, not the
# model's size (BENCH_elastic.json records them for gpt2-smoke)
GEOMETRY_KEYS = ("n_from", "n_to", "inner_from", "inner_to",
                 "entities_from", "entities_to", "carried_entities",
                 "dead_entities", "joiner_workers", "ef_fold", "dp_leaves")
# the true elements of gpt2 FULL's DP leaves
GPT2_ELEMS = 148_944_384
# phase 5: the BENCH_elastic.json scenarios on gpt2-smoke plus 4 -> 3
# (scenario: flags, n_from, n_to, survivors)
SMALL_RESHARDS = {
    "flat_4to4_identity": ([], 4, 4, None),
    "flat_4to2_kill1": ([], 4, 2, (0, 2)),
    "flat_2to4_grow": ([], 2, 4, None),
    "hier_4to2_podkill": (["--hierarchy", str(INNER)], 4, 2, (0, 1)),
    "bucketed_4to2_kill1": (["--bucket-mb", "0.25"], 4, 2, (0, 2)),
    "flat_4to3_kill2": ([], 4, 3, (0, 1, 3))}


def bench_elastic():
    """The elastic_reshard rows of BENCH_elastic.json by scenario."""
    with open(os.path.join(ROOT, "BENCH_elastic.json")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return {r["scenario"]: r for r in rows if r["bench"] == "elastic_reshard"}


def sim_args(batch, workers, extra=(), steps=STEPS):
    """4a's flags in sim mode at ``workers`` workers and global batch
    ``batch``."""
    from repro_torch.launch import train as launch

    return launch.parse_args(gpt2_argv(batch, [
        "--mode", "sim", "--workers", str(workers), *extra,
        "--steps", str(steps)]))


def tree_bits(params, state):
    """(paths, leaves) of a stacked (params, state) in the checkpoint's
    tree layout (tensors where they are, host scalars as arrays)."""
    from repro_torch import interop
    from repro_torch.checkpointing import io as ckpt_io

    paths, leaves, _ = ckpt_io.flatten(
        {"params": params, "state": interop.state_to_reference(state)})
    return paths, leaves


def bitwise(a, b) -> bool:
    """Two (params, state) pairs hold the same paths, dtypes, shapes and
    bytes (so -0 and +0 differ), on any devices."""
    (pa, la), (pb, lb) = tree_bits(*a), tree_bits(*b)
    if pa != pb:
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            y = y.to(x.device)
            if (x.dtype, x.shape) != (y.dtype, y.shape) or not torch.equal(
                    x.contiguous().view(torch.uint8),
                    y.contiguous().view(torch.uint8)):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


def ef_mass(err_w, entities):
    """Each exchange unit's pending worker-side correction
    (1/entities)·Σ err_w, summed in f64."""
    return np.array([float(e.double().sum()) / entities for e in err_w
                     if e is not None])


def check_mass(before, after, rep, what):
    """The fold conserves the worker EF's mass per unit (the reference
    test's bar), and the run left some residual to conserve."""
    src = ef_mass(before, rep["entities_from"])
    dst = ef_mass(after, rep["entities_to"])
    gap = float(np.abs(dst - src).max())
    print(f"  {what}: EF mass per unit conserved within {gap:.2e} (largest "
          f"|mass| {float(np.abs(src).max()):.3e})", flush=True)
    assert np.abs(src).max() > 0, what
    np.testing.assert_allclose(dst, src, rtol=1e-5, atol=1e-7,
                               err_msg=what)
    return gap


def times_by_kind_width(records):
    """:func:`times_by_kind` per step kind and fleet width."""
    kinds = {}
    for kind, steps in STEP_KINDS.items():
        for t in steps:
            w = records[t]["workers"]
            kinds.setdefault(f"{kind} @ {w} workers", []).append(t)
    return times_by_kind(records, kinds)


def print_times(times):
    """Print the medians of :func:`times_by_kind` (or of
    :func:`times_by_kind_width`), one line per step kind."""
    for kind, t in times.items():
        print(f"    {kind}: step {t['step_ms']:.1f} ms (fwd/bwd "
              f"{t['fwd_bwd_ms']:.1f}, optimizer {t['optimizer_ms']:.1f})",
              flush=True)


def run_elastic_cli(dev, a):
    """4n(i): ``--resize 3:4`` through the CLI's elastic path
    (``launch._run_elastic``, FleetSim) with 4a's flags: the identity
    resize; losses, params and launch counts those of 4a (``a``)."""
    from repro_torch.kernels import build
    from repro_torch.launch import train as launch

    args = sim_args(BATCH, N_WORKERS, ["--resize", "3:4"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    res = launch._run_elastic(args, device=dev)
    counts = dict(build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    (rep,) = res["resizes"]
    digest = params_sha256(res["params"])
    same = ([r["losses"] for r in res["records"]]
            == [r["losses"] for r in a["steps"]]
            and digest == a["params_sha256"])
    print(f"  (i) --resize 3:4: launches {json.dumps(counts)}; peak memory "
          f"{peak_gb:.1f} GB; reshard {rep['reshard_ms']:.1f} ms; losses "
          f"and params bit for bit 4a: {same} (sha256 {digest})", flush=True)
    print_times(times_by_kind(res["records"]))
    assert same, "4n(i): the identity resize is not run 4a"
    assert counts == a["launches"], (counts, a["launches"])
    assert (rep["n_from"], rep["n_to"], rep["ef_fold"]) == (4, 4, False)
    return {"steps": res["records"], "launches": counts,
            "peak_memory_gb": peak_gb, "reshard_ms": rep["reshard_ms"],
            "params_sha256": digest}


def run_fleet(dev, a):
    """4n(ii): FleetSim, kill workers 1 and 3 and shrink 4 -> 2 before
    step 3, rejoin 2 -> 4 before step 5. Each resize's report is the
    static reshard_report; right after the shrink the worker EF's mass is
    conserved; after the grow the joiners' ``u`` is zero and their params
    a survivor's bits; steps 0-2 are 4a's bit for bit; the launch counts
    are 4a's (the stacked workers share each launch at every width)."""
    from repro_torch.configs.base import get
    from repro_torch.core.leafwise import clone_tree, flatten_tree
    from repro_torch.elastic import FleetSim, ResizeEvent, reshard_report
    from repro_torch.elastic import simulate
    from repro_torch.kernels import build
    from repro_torch.launch import train as launch

    args = sim_args(BATCH, N_WORKERS)
    kept, real = [], simulate.reshard_trainer

    def keep(src, dst, params, state, *, survivors=None):
        # hold what the checks read; they run after the timed reshards.
        # The destination's first step updates its params and state in
        # place, so copies of them are taken just before it (outside the
        # reshard's and the step's timings); the source state is not
        # stepped again
        out = real(src, dst, params, state, survivors=survivors)
        held = [src.opt, dst.opt, survivors, state.err_w, out[1].err_w,
                out[0], out[1].u]
        kept.append(held)
        step = dst.step

        def first_step(*a, **k):
            held[4] = [None if e is None else e.clone() for e in held[4]]
            held[5] = clone_tree(held[5])
            held[6] = [None if x is None else x.clone() for x in held[6]]
            del dst.step            # the class's own step again
            return step(*a, **k)

        dst.step = first_step
        return out

    simulate.reshard_trainer = keep
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.launch_counts.clear()
        res = FleetSim(get("gpt2").config, launch.build_opt_cfg(args),
                       N_WORKERS, seed=args.seed, device=dev).run(
            STEPS, global_batch=BATCH, seq=SEQ,
            events=[ResizeEvent(*e) for e in FLEET_EVENTS])
        counts = dict(build.launch_counts)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        simulate.reshard_trainer = real
    records, losses, resizes = res["records"], res["losses"], res["resizes"]
    del res
    print(f"  (ii) kill 1, 3 and shrink 4 -> 2 before step 3, rejoin 2 -> 4 "
          f"before step 5: launches {json.dumps(counts)}; peak memory "
          f"{peak_gb:.1f} GB (with the checked tensors held); reshard "
          f"{[round(r['reshard_ms'], 2) for r in resizes]} ms", flush=True)
    print(f"  losses {[round(x, 5) for x in losses]}; widths "
          f"{[r['workers'] for r in records]}", flush=True)
    print_times(times_by_kind_width(records))
    assert np.isfinite(losses).all(), losses
    assert [r["losses"] for r in records[:3]] == [
        r["losses"] for r in a["steps"][:3]], "4n(ii): steps 0-2 are not 4a's"
    assert counts == a["launches"], (counts, a["launches"])
    assert [r["workers"] for r in records] == [4, 4, 4, 2, 2, 4, 4, 4]
    mass_gap = None
    for (src, dst, survivors, ew, ew2, params, u), got in zip(kept, resizes):
        rep = reshard_report(src, dst, survivors=survivors)
        assert {k: v for k, v in got.items()
                if k not in ("step", "reshard_ms")} == rep, (got, rep)
        if dst.n < src.n:
            assert (rep["carried_entities"], rep["dead_entities"],
                    rep["ef_fold"]) == (2, 2, True), rep
            mass_gap = check_mass(ew, ew2, rep,
                                  f"(ii) shrink before step {got['step']}")
        else:
            assert (rep["joiner_workers"], rep["ef_fold"]) == (2, True), rep
            joiners = list(range(src.n, dst.n))
            clone = all(torch.equal(x[k].contiguous().view(torch.uint8),
                                    x[0].contiguous().view(torch.uint8))
                        for x in flatten_tree(params)[1] for k in joiners)
            zero_u = all(bool((x[joiners] == 0).all()) for x in u
                         if x is not None)
            print(f"  (ii) grow before step {got['step']}: joiners {joiners}"
                  f" hold a survivor's params bit for bit: {clone}; their u"
                  f" is zero: {zero_u}", flush=True)
            assert clone and zero_u
    del kept
    return {"steps": records, "losses": losses, "launches": counts,
            "peak_memory_gb": peak_gb, "resizes": resizes,
            "mass_gap": mass_gap}


def run_geometries(dev):
    """4n(iii): per BENCH_elastic.json scenario of another exchange (2
    pods x 2, and 25 MiB buckets), GEOMETRY_STEPS steps of gpt2 FULL with
    4 workers, then a reshard at m = n (bit for bit the identity on every
    params and state leaf) and the scenario's 4 -> 2 (its report's
    geometry the file's, the worker EF's mass conserved)."""
    from repro_torch.elastic import reshard_report, reshard_trainer
    from repro_torch.launch import train as launch

    bench, out = bench_elastic(), {}
    for scenario, (extra, survivors) in GEOMETRIES.items():
        args = sim_args(BATCH, N_WORKERS, extra, steps=GEOMETRY_STEPS)
        tr = launch.make_trainer(args, device=dev)
        res = launch.train(args, tr)
        params, state = res["params"], res["state"]
        del res
        ms = {}
        for m, sv in ((N_WORKERS, None), (2, survivors)):
            dst = launch.make_trainer(
                sim_args(BATCH, m, extra, steps=GEOMETRY_STEPS), device=dev)
            rep = reshard_report(tr.opt, dst.opt, survivors=sv)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p2, s2 = reshard_trainer(tr, dst, params, state, survivors=sv)
            torch.cuda.synchronize()
            ms[m] = 1e3 * (time.perf_counter() - t0)
            if m == N_WORKERS:
                same = bitwise((params, state), (p2, s2))
                print(f"  (iii) {scenario}: reshard at m = n bit for bit the"
                      f" identity: {same} ({ms[m]:.1f} ms)", flush=True)
                assert same, scenario
            else:
                row = bench[scenario]
                geometry = {k: rep[k] for k in GEOMETRY_KEYS}
                print(f"  (iii) {scenario}: 4 -> 2 survivors {sv} in "
                      f"{ms[m]:.1f} ms; report {json.dumps(rep)}",
                      flush=True)
                assert geometry == {k: row[k] for k in GEOMETRY_KEYS}, (
                    geometry, row)
                assert rep["exchange_units"] == len(tr.opt.units)
                assert rep["true_elems"] == GPT2_ELEMS
                gap = check_mass(state.err_w, s2.err_w, rep,
                                 f"(iii) {scenario}")
            del p2, s2
            gc.collect()
            torch.cuda.empty_cache()
        out[scenario] = {"identity_ms": ms[N_WORKERS], "reshard_ms": ms[2],
                         "report": rep, "mass_gap": gap}
        del params, state, tr
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_restore_resharded(dev):
    """4n(iv): 4 steps of gpt2 FULL width at FILE_LAYERS layers, 2
    workers (batch 8 x SEQ, 4a's flags) and ``--save`` under the
    git-ignored build/; restore_resharded
    into a 4-worker trainer, bit for bit reshard_trainer of the in-memory
    state; then steps 4-7 at 4 workers, finite losses. Returns the file's
    size and the save and restore seconds; the file is deleted."""
    from repro_torch.elastic import reshard_trainer, restore_resharded
    from repro_torch.launch import train as launch

    with scratch_dir() as tmp:
        path = os.path.join(tmp, "ck.npz")
        cut = ["--layers", str(FILE_LAYERS)]
        a2 = sim_args(8, 2, cut + ["--save", path], steps=4)
        tr2 = launch.make_trainer(a2, device=dev)
        res = launch.train(a2, tr2)
        save_s, size = res["save_s"], os.path.getsize(path)
        a4 = sim_args(8, N_WORKERS, cut)
        tr4 = launch.make_trainer(a4, device=dev)
        want = reshard_trainer(tr2, tr4, res["params"], res["state"])
        del res
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, step, meta = restore_resharded(path, tr4)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = bitwise(want, (params, state))
        del want
        assert step == 4 and meta == {"arch": tr4.model_cfg.name,
                                      "n_workers": 2}, (step, meta)
    print(f"  (iv) 2 workers -> file -> 4 workers: {size / 1e9:.3f} GB, save "
          f"{save_s:.2f} s, restore_resharded {restore_s:.2f} s; bit for bit"
          f" the in-memory reshard: {same}", flush=True)
    assert same, "4n(iv): restore_resharded is not the in-memory reshard"
    gc.collect()
    torch.cuda.empty_cache()
    tail = launch.train(a4, tr4, start=(params, state, step))
    losses = [float(np.mean(r["losses"])) for r in tail["records"]]
    print(f"  (iv) steps 4-7 at 4 workers: losses "
          f"{[round(x, 5) for x in losses]}", flush=True)
    assert len(losses) == 4 and np.isfinite(losses).all(), losses
    del tail, params, state
    return {"file_bytes": size, "save_s": save_s, "restore_s": restore_s,
            "losses": losses}


def run_elastic_phase(dev, a):
    """Phase 4n (i)-(iv); ``a``: run 4a's summary."""
    out = {}
    for key, run in (("cli_identity", lambda: run_elastic_cli(dev, a)),
                     ("fleet", lambda: run_fleet(dev, a)),
                     ("geometries", lambda: run_geometries(dev)),
                     ("restore_resharded",
                      lambda: run_restore_resharded(dev))):
        out[key] = run()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _moved(params, state, d):
    from repro_torch.core.leafwise import flatten_tree, unflatten_tree

    paths, xs = flatten_tree(params)
    return (unflatten_tree(paths, [x.to(d, copy=True) for x in xs]),
            state_to(state, d))


def check_small_reshards(dev):
    """Phase 5: SMALL_RESHARDS on gpt2-smoke from one state trained on the
    CPU (7 steps, the last a local one; 2 workers: the CPU's 4 -> 2 of
    it), resharded on the card and on the CPU: every params and state
    leaf bit for bit; each report the file's (4 -> 3: its own)."""
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.elastic import reshard_report, reshard_trainer
    from repro_torch.launch import train as launch

    cpu, bench, trained, out = torch.device("cpu"), bench_elastic(), {}, {}

    def trainer(extra, n, d):
        args = smoke_args("gpt2", extra + ["--workers", str(n)])
        return launch.make_trainer(args, device=d)

    for scenario, (extra, n, m, survivors) in SMALL_RESHARDS.items():
        key = tuple(extra)
        if key not in trained:
            tr = trainer(extra, N_WORKERS, cpu)
            params, state = tr.init(0)
            data = SyntheticLM(DataConfig(vocab=tr.model_cfg.vocab,
                                          seq_len=32, global_batch=8,
                                          seed=0))
            for t in range(7):
                params, state, _ = tr.step(params, state, data.batch(t))
            trained[key] = (params, state)
        params, state = trained[key]
        if n != N_WORKERS:
            params, state = reshard_trainer(
                trainer(extra, N_WORKERS, cpu), trainer(extra, n, cpu),
                params, state, survivors=(0, 2))
        got = []
        for d in (dev, cpu):
            src, dst = trainer(extra, n, d), trainer(extra, m, d)
            got.append(reshard_trainer(src, dst, *_moved(params, state, d),
                                       survivors=survivors))
        rep = reshard_report(src.opt, dst.opt, survivors=survivors)
        same = bitwise(*got)
        print(f"  gpt2-smoke reshard {scenario}: card vs cpu bit for bit "
              f"{same}", flush=True)
        assert same, scenario
        if scenario in bench:
            row = bench[scenario]
            assert rep == {k: v for k, v in row.items() if k in rep}, (
                rep, row)
        out[scenario] = same
    return out


def check_small_fleet(dev):
    """Phase 5: FleetSim on gpt2-smoke, 12 steps of phase 5's flags at a
    peak lr of 3e-4, shrink 4 -> 2 (survivors 0, 2) before step 4 and grow
    back before step 8, on the card and on the CPU from the same init:
    phase 5's bars (losses within 1e-4, params 99% within 1e-4 and all
    within 0.05), the reports equal. At 3e-3 the 12-step run is chaotic in
    the last bit (the CPU against itself from params one ulp up: 1.6e-4
    by step 12 without resizes)."""
    from repro_torch.configs.base import get
    from repro_torch.core.leafwise import flatten_tree
    from repro_torch.elastic import FleetSim, ResizeEvent
    from repro_torch.launch import train as launch

    args = smoke_args("gpt2", ["--lr", "3e-4", "--steps", "12"])
    runs = []
    for d in (dev, torch.device("cpu")):
        res = FleetSim(get("gpt2").smoke, launch.build_opt_cfg(args),
                       N_WORKERS, seed=0, device=d).run(
            12, global_batch=8, seq=32,
            events=[ResizeEvent(4, 2, (0, 2)), ResizeEvent(8, 4)])
        runs.append((res["losses"], [x.cpu() for x in flatten_tree(
            res["params"])[1]], [{k: v for k, v in r.items()
                                  if k != "reshard_ms"}
                                 for r in res["resizes"]]))
    (lk, pk, rk), (lc, pc, rc) = runs
    gap = max(abs(a - b) for a, b in zip(lk, lc))
    diff = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(pk, pc)])
    frac = float((diff <= 1e-4).double().mean())
    print(f"  gpt2-smoke FleetSim 4 -> 2 -> 4: losses card "
          f"{[round(x, 5) for x in lk]}", flush=True)
    print(f"  max loss gap card-cpu {gap:.2e}; params within 1e-4: "
          f"{frac:.5f}; max param gap {float(diff.max()):.2e}", flush=True)
    assert rk == rc, (rk, rc)
    assert gap < 1e-4 and frac >= 0.99 and float(diff.max()) <= 0.05
    return {"max_loss_gap": gap, "params_within_1e-4": frac,
            "max_param_gap": float(diff.max())}


def _device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def profile_step(tr, params, state, batch):
    """Phase 4, gpt2 (4a, 4e, 4f): repeat the forward/backward and the
    optimizer step of step 6 under torch.profiler; per part, the wall time, the
    summed device time of its kernels and the kernels that take the
    most."""
    from torch.profiler import ProfilerActivity, profile

    out, grads = {}, []
    for part, fn in (("fwd_bwd", lambda: grads.append(
                          tr.grads(params, batch)[1])),
                     ("optimizer_sync", lambda: tr.opt.step(
                         tr.comm, params, grads[0], state))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        del res
        # kernels only: an aten op's device time is its kernels' again
        evts = [(e.key, _device_us(e) / 1e3, e.count)
                for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
        evts.sort(key=lambda x: -x[1])
        busy = sum(ms for _, ms, _ in evts)
        out[part] = {"wall_ms": wall_ms, "device_ms": busy,
                     "top": [[k[:90], round(ms, 3), c]
                             for k, ms, c in evts[:12]]}
        print(f"  profiled {part}: wall {wall_ms:.1f} ms, kernels "
              f"{busy:.1f} ms (device busy {busy / wall_ms:.0%})")
        for k, ms, c in evts[:12]:
            print(f"    {ms:9.3f} ms  x{c:<5d} {k[:90]}")
    return out


def smoke_args(arch, extra):
    """The CLI flags of phase 5's smoke trainers (4 simulated workers, 8
    steps of batch 8 x 32, phase 4's schedule)."""
    from repro_torch.launch import train as launch

    return launch.parse_args([
        "--arch", arch, "--smoke", "--mode", "sim", "--workers",
        str(N_WORKERS), "--steps", "8", "--batch", "8", "--seq", "32",
        "--sync-warmup", "2", "--double-every", "2", "--kappa", "1"] + extra)


def smoke_run(args, d, kind, nudge=False, configure=None):
    """Phase 5: 8 steps of the smoke trainer of ``args`` on device ``d``
    from seed 0 (each param one ulp up with ``nudge``), its configs
    through ``configure`` (``launch.make_trainer``'s): the losses and the
    final params (on the CPU)."""
    from repro_torch.configs.base import get
    from repro_torch.core.comm import SimComm
    from repro_torch.core.leafwise import flatten_tree, unflatten_tree
    from repro_torch.data.synthetic import (DataConfig, SyntheticLM,
                                            add_model_inputs)
    from repro_torch.launch import train as launch
    from repro_torch.train.step import Trainer

    cfg, opt_cfg = get(args.arch).smoke, launch.build_opt_cfg(args)
    if configure is not None:
        cfg, opt_cfg = configure(cfg, opt_cfg)
    tr = Trainer(cfg, opt_cfg, comm=SimComm(N_WORKERS), device=d)
    params, state = tr.init(0)
    if nudge:
        paths, xs = flatten_tree(params)
        params = unflatten_tree(paths, nudged(xs))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=8, seed=0, kind=kind),
                       device=d)
    losses = []
    for t in range(8):
        batch = data.batch(t)
        if cfg.enc_layers or cfg.vision_tokens:
            # the CLI's zero frames / vision embeddings
            batch = add_model_inputs(batch, cfg, d)
        params, state, met = tr.step(params, state, batch)
        losses.append(float(met["loss"]))
    return losses, [x.cpu() for x in flatten_tree(params)[1]]


def check_small_input(dev, arch, extra, kind):
    """Phase 5: a smoke trainer on the card (kernels) against the same
    trainer on the CPU (plain versions), same start and batches.
    Losses within 1e-4 and parameters 99% within 1e-4, all within 0.05:
    the bars the CPU tests hold the CPU path to against the JAX reference,
    for the same reasons (sum order; near-zero sign flips)."""
    from repro_torch.configs.base import get

    args = smoke_args(arch, extra)
    cfg = get(arch).smoke
    (lk, pk), (lc, pc) = (smoke_run(args, d, kind)
                          for d in (dev, torch.device("cpu")))
    gap = max(abs(a - b) for a, b in zip(lk, lc))
    diff = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(pk, pc)])
    frac = float((diff <= 1e-4).double().mean())
    print(f"  {cfg.name} {' '.join(extra)}: losses card "
          f"{[round(x, 5) for x in lk]}")
    print(f"  max loss gap card-cpu {gap:.2e}; params within 1e-4: "
          f"{frac:.5f}; max param gap {float(diff.max()):.2e}", flush=True)
    assert gap < 1e-4 and frac >= 0.99 and float(diff.max()) <= 0.05
    return {"max_loss_gap": gap, "params_within_1e-4": frac,
            "max_param_gap": float(diff.max())}


def state_to(state, d):
    """An optimizer state with every tensor copied to device ``d`` (a copy
    on its own device too: the optimizer's step updates its state in
    place)."""

    def move(xs):
        return [None if x is None else x.to(d, copy=True) for x in xs]

    return dataclasses.replace(
        state, slots={k: move(v) for k, v in state.slots.items()},
        u=move(state.u), err_w=move(state.err_w), err_s=move(state.err_s),
        anchor=move(state.anchor))


def check_small_qint(dev, extra):
    """Phase 5 for qint8 / qint4 (``extra``: the codec's flags and the
    topology's): their dither hashes each value's bits, so a trajectory
    is chaotic in the last bit of the gradients, which the card and the
    CPU do not share. What holds the card to the CPU is (1) one optimizer
    sync step from the same params, gradients and state on both devices,
    params and state bit for bit: at step 0 from ``opt.init``'s state (a
    variance round too), and at step 6 after six steps on the CPU, whose
    state carries the error feedback of five syncs, the ``u`` of local
    step 5 and the anchor of step 4 (kernels 1-4 where they run). (2) A
    sanity bound on the gpt2-smoke trainer from the same start: the loss
    gap and the largest param gap each at most three times the card's own
    spread from params one ulp up. That bound cannot catch a wrong
    multi-step path (the spread is of the size of the params); (1) can."""
    from repro_torch.configs.base import get
    from repro_torch.core import api
    from repro_torch.core.comm import SimComm
    from repro_torch.core.leafwise import flatten_tree, unflatten_tree
    from repro_torch.launch import train as launch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    args = smoke_args("gpt2", extra)
    cfg = get("gpt2").smoke
    tmpl = T.model_template(cfg)
    shapes = L.param_shapes(tmpl)
    paths, leaves = flatten_tree(shapes)
    cpu = torch.device("cpu")
    rng = np.random.default_rng(7)

    def draw(sc):
        return [torch.from_numpy((rng.standard_normal(
            (N_WORKERS,) + tuple(sh)) * sc).astype(np.float32))
            for sh in leaves]

    def to(xs, d):   # copies: the optimizer steps its params in place
        return unflatten_tree(paths, [x.to(d, copy=True) for x in xs])

    params, grads = draw(0.02), [draw(1.0) for _ in range(7)]
    opts = {d: api.build_optimizer(launch.build_opt_cfg(args), shapes,
                                   specs=L.param_specs(tmpl),
                                   dp_mask=L.dp_mask(tmpl),
                                   n_workers=N_WORKERS) for d in (dev, cpu)}
    state = opts[cpu].init(to(params, cpu))
    step_bitwise = {}
    for t in range(7):
        if t in (0, 6):
            if t == 6:
                assert all(float(e.abs().max()) > 0 for e in state.err_w)
                assert all(float(u.abs().max()) > 0 for u in state.u)
            out = []
            for d in (dev, cpu):
                p, st, met = opts[d].step(SimComm(N_WORKERS), to(params, d),
                                          to(grads[t], d),
                                          state_to(state, d))
                assert met["synced"] and met["var_round"] == (t == 0)
                out.append([x.cpu() for x in flatten_tree(p)[1]] + [
                    x.cpu() for name in ("u", "err_w", "err_s", "anchor")
                    for x in getattr(st, name)] + [
                    x.cpu() for v in st.slots.values() for x in v])
            same = all(torch.equal(a, b) for a, b in zip(*out))
            print(f"  {' '.join(extra)}: sync step {t} card vs cpu bit for "
                  f"bit: {same}", flush=True)
            assert same, (extra, t)
            step_bitwise[t] = same
        p, state, _ = opts[cpu].step(SimComm(N_WORKERS), to(params, cpu),
                                     to(grads[t], cpu), state)
        params = flatten_tree(p)[1]

    (lk, pk), (ln, pn), (lc, pc) = (
        smoke_run(args, dev, "lm"), smoke_run(args, dev, "lm", nudge=True),
        smoke_run(args, cpu, "lm"))
    gap = max(abs(a - b) for a, b in zip(lk, lc))
    own = max(abs(a - b) for a, b in zip(lk, ln))
    pgap = max(float((a - b).abs().max()) for a, b in zip(pk, pc))
    pown = max(float((a - b).abs().max()) for a, b in zip(pk, pn))
    print(f"  gpt2-smoke {' '.join(extra)}: losses card "
          f"{[round(x, 5) for x in lk]}")
    print(f"  max loss gap card-cpu {gap:.2e} against the card's own spread"
          f" from params one ulp up {own:.2e}; max param gap {pgap:.2e} "
          f"against {pown:.2e}", flush=True)
    assert np.isfinite(lk).all() and 0 < own and gap <= 3 * own, (gap, own)
    assert pgap <= 3 * pown, (pgap, pown)
    return {"max_loss_gap": gap, "own_spread": own, "max_param_gap": pgap,
            "own_param_spread": pown, "step_bitwise": step_bitwise}


def small_parts(dev):
    """Phase 5's checks by name, each a callable returning its summary,
    in the order phase 5 runs them."""
    # bert at a peak lr of 3e-4: at the CLI's default 3e-3 the row-scale
    # run is unstable on bert-smoke (loss 6.31 -> 6.87 at step 6), and a
    # near-zero element whose sign differs between the card's and the
    # CPU's gradients moves its whole row's scale and grew to a 1.75e-4
    # loss gap there (H100, see PERF.md); tests/test_torch_slice.py
    # holds the CPU path to the reference in the same regime
    slow = ["--lr", "3e-4"]

    def check(arch, extra, kind="lm"):
        return lambda: check_small_input(dev, arch, extra, kind)

    parts = {"gpt2": check("gpt2", []),
             "gpt2_hier": check("gpt2", ["--hierarchy", str(INNER)]),
             "gpt2_adam": check("gpt2", ["--optimizer", "adam"]),
             "gpt2_onebit": check("gpt2", ONEBIT),
             "gpt2_bucketed": check("gpt2", ["--bucket-mb", "4"]),
             "gpt2_bucketed_hier": check(
                 "gpt2", ["--bucket-mb", "4", "--hierarchy", str(INNER)]),
             "bert_row": check("bert-base", ["--scale-mode", "row"] + slow,
                               "mlm"),
             "bert_sgd": check("bert-base",
                               ["--optimizer", "zero_one_sgd"] + slow,
                               "mlm")}
    for name in ("zero_one_lamb", "one_bit_lamb", "lamb"):
        parts[f"bert_{name}"] = check(
            "bert-base", ["--optimizer", name, "--onebit-warmup", "2"],
            "mlm")
    for name, flags in CODECS.items():
        for topo in ([], ["--hierarchy", str(INNER)]):
            key = f"gpt2_{name}{'_hier' if topo else ''}"
            parts[key] = (check("gpt2", flags + topo) if name == "topk"
                          else (lambda f=flags + topo:
                                check_small_qint(dev, f)))
    parts["elastic_reshards"] = lambda: check_small_reshards(dev)
    parts["elastic_fleet"] = lambda: check_small_fleet(dev)
    parts["serve_smoke"] = lambda: check_small_serve(dev)
    return parts


def gpt2_argv(batch, extra):
    """The CLI flags of phase 4a's gpt2 run at global batch ``batch``;
    ``extra`` names the mode (the CLI's default is single)."""
    return ["--arch", "gpt2", "--steps", str(STEPS), "--batch", str(batch),
            "--seq", str(SEQ), "--sync-warmup", "2", "--double-every", "2",
            "--kappa", "1", "--log-every", str(STEPS)] + extra


def scratch_dir():
    """A directory for the ranks' rendezvous and results, inside the
    checkout (git-ignored), removed after use."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    return tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"))


def probe_exchange(backend, device, n, inner=None):
    """Phase 6: DistComm's all_to_all and all_gather in ``n`` spawned
    ranks against SimComm's, bit for bit, in f32, bf16, uint8, int8 and
    int32, from contiguous and strided views; with ``inner`` also those
    of both comms of its split into pods of ``inner`` (process
    subgroups)."""
    from repro_torch.launch import mesh

    with scratch_dir() as tmp:
        mesh.spawn(mesh.check_exchange, n,
                   (n, mesh.file_rendezvous(tmp), backend, device, tmp,
                    inner),
                   timeout_s=DIST_TIMEOUT_S)
        want = mesh.exchange_reference(mesh.exchange_payloads(n, "cpu"),
                                       inner)
        cases = {}
        for r in range(n):
            got = torch.load(os.path.join(tmp, f"exchange{r}.pt"))
            for name, ops in got.items():
                for op, t in ops.items():
                    ok = (t.dtype == want[name][op].dtype
                          and torch.equal(t[0], want[name][op][r]))
                    cases[f"{name} {op}"] = cases.get(f"{name} {op}",
                                                      True) and ok
    print(f"  {backend} on {device}, {n} rank(s)"
          f"{f', pods of {inner}' if inner else ''}: {json.dumps(cases)}",
          flush=True)
    assert all(cases.values()), (backend, device, cases)
    return cases


def times_by_kind(records, kinds=STEP_KINDS):
    """Median per step kind (``kinds``: name -> steps) of each time of the
    step records (the exchange's only where the comm timed one)."""
    keys = ["step_ms", "fwd_bwd_ms", "optimizer_ms"]
    keys += [k for k in ("exchange_ms", "exchange_ms_intra",
                         "exchange_ms_inter")
             if records[0].get(k) is not None]
    return {kind: {k: statistics.median(records[t][k] for t in steps)
                   for k in keys}
            for kind, steps in kinds.items()}


def run_in_process(argv):
    """Phase 6: the sim or single run the ranks are held to, in this
    process, its launch counts set to 0 just before it, its collectives
    recorded and audited (:func:`audit_run`)."""
    from repro_torch import analysis
    from repro_torch.core.comm import NullComm, SimComm
    from repro_torch.core.leafwise import flatten_tree
    from repro_torch.kernels import build
    from repro_torch.launch import train as launch

    args = launch.parse_args(argv)
    tr = launch.make_trainer(args, comm=analysis.RecordingComm(
        SimComm(args.workers) if args.mode == "sim" else NullComm()))
    trace = analysis.watch(tr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    res = launch.train(args, tr)
    out = {"records": res["records"], "launches": dict(build.launch_counts),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "params": [x.cpu() for x in flatten_tree(res["params"])[1]],
           "audit": audit_run(f"{args.mode} reference", tr, trace),
           "recorded": [c.to_dict() for c in trace.collectives]}
    del res, tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def cut_depth(n_layers):
    """``launch.train``'s configs cut to ``n_layers`` layers, widths
    unchanged, inside the block (``None``: as registered): a FULL config
    whose full depth does not fit the card trains through the CLI's own
    ``make_trainer``. (An encoder-decoder keeps as many encoder layers,
    as ``--layers`` cuts it.)"""
    from repro_torch.launch import train as launch
    from repro_torch.models.config import cut_layers

    get = launch.get
    if n_layers is not None:
        launch.get = lambda name: dataclasses.replace(
            get(name), config=cut_layers(get(name).config, n_layers))
    try:
        yield
    finally:
        launch.get = get


_PROBE = {}     # a spawned rank's issue-time probe (probe_issue)


def probe_issue(step):
    """Phase 6, in a spawned rank: note, on the device's clock, when each
    exchange unit of the next run's ``step`` has issued its first
    collective (a CUDA event on the unit thread's stream right after the
    issue, so it fires once the unit's local step and compress are done)
    and when the backward ended (an event on the trainer's stream as
    ``Trainer.grads`` returns). The wrappers go in once a process.
    Returns a function that gives, after the run, the backward's end and
    each unit's issue in ms from the step's start, in issue order."""
    from repro_torch.core.compressed import ComposedOptimizer
    from repro_torch.train.step import Trainer

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def at_step():
        return _PROBE["count"] == _PROBE["step"]

    def wrap_step(orig):
        def stepped(self, *a, **k):
            _PROBE["count"] += 1
            if at_step():
                _PROBE["start"] = event()
            return orig(self, *a, **k)
        return stepped

    def wrap_grads(orig):
        def grads(self, *a, **k):
            out = orig(self, *a, **k)
            if at_step():
                _PROBE["backward_end"] = event()
            return out
        return grads

    def wrap_exchange(orig):
        def phases(self, comm, unit, *a):
            gen = orig(self, comm, unit, *a)
            try:
                left = next(gen)
            except StopIteration as stop:
                return stop.value
            if at_step():
                _PROBE["units"].append(event())
            while True:
                yield left
                try:
                    left = next(gen)
                except StopIteration as stop:
                    return stop.value
        return phases

    if not _PROBE:
        Trainer.step = wrap_step(Trainer.step)
        Trainer.grads = wrap_grads(Trainer.grads)
        for name in ("_onebit_phases", "_fullprec_phases"):
            setattr(ComposedOptimizer, name,
                    wrap_exchange(getattr(ComposedOptimizer, name)))
    _PROBE.update(step=step, count=-1, units=[])

    def read():
        t0 = _PROBE["start"]
        return {"step": step,
                "backward_end_ms": t0.elapsed_time(_PROBE["backward_end"]),
                "units": [t0.elapsed_time(ev) for ev in _PROBE["units"]]}
    return read


def rank_jobs(rank, jobs, n):
    """Phase 6: one spawned rank that runs ``jobs`` one after another,
    each ``(argv, out_dir, kind, audit, n_layers, opts)`` through
    ``launch.rank_main`` (``opts``: its ``configure`` and
    ``trainer_cfg``, and with ``probe`` a step whose units' issue times
    :func:`probe_issue` notes, written to ``issue{rank}.json``) with its
    own rendezvous in ``out_dir`` (the process group is made and
    destroyed per job), and writes each job's wall seconds in this rank
    to ``wall{rank}.json`` there. The jobs share the process's start-up:
    the torch import, the CUDA context and the audit's first meta-tensor
    op (~6 s each on the card's host)."""
    from repro_torch.launch import mesh
    from repro_torch.launch import train as launch

    for argv, out_dir, kind, audit, n_layers, opts in jobs:
        t0 = time.time()
        read = None
        if opts.get("probe") is not None:
            read = probe_issue(opts["probe"])
        elif _PROBE:
            _PROBE["step"] = None   # an earlier job's probe: off
        with cut_depth(n_layers):
            launch.rank_main(rank, argv, n, mesh.file_rendezvous(out_dir),
                             out_dir, False, kind, audit,
                             opts.get("configure"), opts.get("trainer_cfg"))
        with open(os.path.join(out_dir, f"wall{rank}.json"), "w") as f:
            json.dump(time.time() - t0, f)
        if read is not None:
            with open(os.path.join(out_dir, f"issue{rank}.json"), "w") as f:
                json.dump(read(), f)
        gc.collect()
        torch.cuda.empty_cache()


def run_ranks(argvs, n, kind="lm", audit=True, n_layers=None, opts=None):
    """Phase 6: ``--mode dist`` runs of ``argvs`` in ``n`` spawned ranks,
    which run them one after another (:func:`rank_jobs`) on the
    synthetic stream of ``kind`` (the model cut to ``n_layers`` where
    given; ``opts``: each run's options, see :func:`rank_jobs`). Yields,
    per argv in order, every rank's results (params on the CPU; with
    ``audit`` its audit report and recorded collectives; with a probe,
    ``issue``) and the run's wall time (its slowest rank's); each run's
    files are deleted once yielded."""
    from repro_torch.launch import mesh

    opts = opts or [{}] * len(argvs)
    with scratch_dir() as tmp:
        dirs = [os.path.join(tmp, f"run{i}") for i in range(len(argvs))]
        for d in dirs:
            os.makedirs(d)
        mesh.spawn(rank_jobs, n, ([(argv, d, kind, audit, n_layers, o)
                                   for argv, d, o in zip(argvs, dirs, opts)],
                                  n),
                   timeout_s=DIST_TIMEOUT_S * len(argvs))
        for d in dirs:
            walls, ranks = [], []
            for r in range(n):
                with open(os.path.join(d, f"wall{r}.json")) as f:
                    walls.append(json.load(f))
                ranks.append(torch.load(os.path.join(d, f"rank{r}.pt")))
                issue = os.path.join(d, f"issue{r}.json")
                if os.path.exists(issue):
                    with open(issue) as f:
                        ranks[-1]["issue"] = json.load(f)
            yield ranks, max(walls)
            shutil.rmtree(d)


@dataclasses.dataclass
class DistRun:
    """A run of phase 6: its reference in this process and its ranks."""

    key: str          # its name among dist_parts
    label: str        # its name in the output
    header: str       # printed before its reference run
    ref_argv: list    # the reference run's CLI flags (sim or single mode)
    argv: list        # the ranks' CLI flags (--mode dist)
    n: int            # ranks
    transport: str
    expect: dict      # launch counts of the reference and of every rank
    bitwise: bool = False
    # the ranks' launch.train options: configure, trainer_cfg, and with
    # probe the step whose units' issue times are noted (probe_issue)
    opts: dict = dataclasses.field(default_factory=dict)
    twin: str = None  # the key of the early run this sequential one
                      # twins; it is held to that run, not to ref_argv


def run_dist(runs):
    """Phase 6: each of ``runs`` (all of one rank count) run in this
    process as its reference, then all their ranks in one spawn
    (:func:`run_ranks`), each held to its reference by
    :func:`compare_ranks` (bit for bit where ``bitwise``); a sequential
    twin (``twin``) has no reference run and is held to its early run by
    :func:`compare_twins`. Returns each run's summary by key."""
    refs = []
    for run in runs:
        print(run.header, flush=True)
        if run.ref_argv is None:
            refs.append(None)
            continue
        ref = run_in_process(run.ref_argv)
        assert ref["launches"] == run.expect, (run.label, ref["launches"],
                                               run.expect)
        print(f"  {run.label} reference run: peak "
              f"{ref['peak_memory_gb']:.2f} GB", flush=True)
        ref["times"] = times_by_kind(ref["records"], step_kinds(run.argv))
        for kind, t in ref["times"].items():
            print(f"    {kind}: step {t['step_ms']:.1f} ms (fwd/bwd "
                  f"{t['fwd_bwd_ms']:.1f}, optimizer "
                  f"{t['optimizer_ms']:.1f}; exchange in-process)")
        refs.append(ref)
    out, held = {}, {}
    twinned = {run.twin for run in runs if run.twin}
    ranks_of = run_ranks([run.argv for run in runs], runs[0].n,
                         opts=[run.opts for run in runs])
    for run, ref, (ranks, wall) in zip(runs, refs, ranks_of):
        print(f"phase {run.label}: {run.n} rank(s) over {run.transport}",
              flush=True)
        if run.twin:
            out[run.key] = {
                "transport": run.transport, "ranks_wall_s": wall,
                "twins": compare_twins(run.label, held.pop(run.twin), ranks,
                                       run.transport, run.expect,
                                       step_kinds(run.argv))}
            continue
        if ref is None:
            # an early run held only to its sequential twin below
            out[run.key] = {"transport": run.transport,
                            "ranks_wall_s": wall}
            for r, res in enumerate(ranks):
                assert res["launches"] == run.expect, (run.label, r)
                assert res["audit"]["ok"], (run.label, r)
        else:
            out[run.key] = {
                "transport": run.transport, "ranks_wall_s": wall,
                "reference": {"peak_memory_gb": ref["peak_memory_gb"],
                              "launches": ref["launches"],
                              "times": ref["times"]},
                "ranks": compare_ranks(run.label, run.transport, ref, ranks,
                                       run.bitwise, step_kinds(run.argv))}
        if run.key in twinned:
            held[run.key] = ranks
        del ranks
        gc.collect()
    return out


def compare_twins(label, early, seq, transport, expect, kinds=STEP_KINDS):
    """Phase 6: each rank of an early-issue run (the default,
    ``peel_last_microbatch``) against the same rank of its sequential
    twin: losses and params bit for bit (else the first step and leaf
    that differ), the same collectives recorded in the same order, both
    audits clean, the launch counts ``expect``; each run's step times by
    kind, exchange ms and peak memory, whose difference must stay within
    1 GB; and, where the early run was probed, each unit's issue time
    against the end of the backward in that step (ms; positive: issued
    before the backward ended, so its exchange could overlap it)."""
    from repro_torch.core.leafwise import flatten_tree

    rows = []
    for r, (a, b) in enumerate(zip(early, seq)):
        la = [rec["losses"][0] for rec in a["records"]]
        lb = [rec["losses"][0] for rec in b["records"]]
        first_step = next((t for t, (x, y) in enumerate(zip(la, lb))
                           if x != y), None)
        paths, xs = flatten_tree(a["params"])
        ys = flatten_tree(b["params"])[1]
        first_leaf = next(("/".join(map(str, p)) for p, x, y in zip(
            paths, xs, ys) if not torch.equal(x, y)), None)
        row = {"rank": r, "device": a["device"], "backend": a["backend"],
               "bitwise": first_step is None and first_leaf is None,
               "first_unequal_loss_step": first_step,
               "first_unequal_leaf": first_leaf,
               "sequence_equal": a["recorded"] == b["recorded"],
               "audits_ok": a["audit"]["ok"] and b["audit"]["ok"],
               "peak_memory_gb": {"early": a["peak_memory_bytes"] / 1e9,
                                  "sequential":
                                      b["peak_memory_bytes"] / 1e9},
               "times": {"early": times_by_kind(a["records"], kinds),
                         "sequential": times_by_kind(b["records"], kinds)},
               "launches": a["launches"]}
        if "issue" in a:
            iss = a["issue"]
            end = iss["backward_end_ms"]
            row["issue"] = {"step": iss["step"], "backward_end_ms": end,
                            "units_before_backward_end_ms": [
                                round(end - t, 3) for t in iss["units"]]}
        peaks = row["peak_memory_gb"]
        print(f"  {label} rank {r} on {a['device']} ({a['backend']}): "
              f"early vs sequential bitwise {row['bitwise']} (first "
              f"unequal: loss step {first_step}, leaf {first_leaf}); "
              f"collectives the same sequence {row['sequence_equal']}; "
              f"audits clean {row['audits_ok']}; peak "
              f"{peaks['early']:.2f} / {peaks['sequential']:.2f} GB",
              flush=True)
        for which in ("early", "sequential"):
            print(f"   {which}:", flush=True)
            print_rank_times(row["times"][which], transport)
        if "issue" in row:
            iss = row["issue"]
            print(f"    step {iss['step']}: backward ends at "
                  f"{iss['backward_end_ms']:.1f} ms; each unit's first "
                  f"collective issued this many ms before it (issue "
                  f"order): {json.dumps(iss['units_before_backward_end_ms'])}",
                  flush=True)
        assert row["bitwise"], (label, r, row)
        assert row["sequence_equal"] and row["audits_ok"], (label, r)
        assert a["launches"] == b["launches"] == expect, (
            label, r, a["launches"], b["launches"], expect)
        assert abs(peaks["early"] - peaks["sequential"]) <= 1.0, (label, r)
        rows.append(row)
    return rows


def print_rank_times(times, transport):
    for kind, t in times.items():
        levels = ("" if "exchange_ms_intra" not in t else
                  f": intra-pod {t['exchange_ms_intra']:.1f}, "
                  f"inter-pod {t['exchange_ms_inter']:.1f}")
        print(f"    {kind}: step {t['step_ms']:.1f} ms (fwd/bwd "
              f"{t['fwd_bwd_ms']:.1f}, optimizer {t['optimizer_ms']:.1f}"
              f", exchange {t['exchange_ms']:.1f}{levels} over "
              f"{transport})", flush=True)


def compare_ranks(label, transport, ref, ranks, bitwise=False,
                  kinds=STEP_KINDS):
    """Phase 6: every rank against the worker of its index in ``ref``:
    with ``bitwise`` losses and params bit for bit, else losses within
    1e-4, params 99% within 1e-4 and all within 0.05 (phase 5's bars),
    bitwise equality reported with the first step whose loss and the
    first leaf whose params differ; launch counts equal; where the rank
    was audited, its audit clean and its recorded collectives (op, level,
    dtype, one worker's shape and bytes, position, step) and bytes per
    round those of its simulated worker."""
    from repro_torch.core.leafwise import flatten_tree

    rows = []
    for r, res in enumerate(ranks):
        got = [rec["losses"][0] for rec in res["records"]]
        want = [rec["losses"][r] for rec in ref["records"]]
        assert [(a["sync"], a["var"]) for a in res["records"]] == [
            (b["sync"], b["var"]) for b in ref["records"]], (label, r)
        n = n_eq = n_close = 0
        max_gap = 0.0
        first_leaf = None
        paths, leaves = flatten_tree(res["params"])
        for path, a, b in zip(paths, leaves, ref["params"]):
            d = (a[0] - b[r]).abs()
            n += d.numel()
            eq = int((a[0] == b[r]).sum())
            if eq < d.numel() and first_leaf is None:
                first_leaf = "/".join(str(k) for k in path)
            n_eq += eq
            n_close += int((d <= 1e-4).sum())
            max_gap = max(max_gap, float(d.max()))
        first_step = next((t for t, (x, y) in enumerate(zip(got, want))
                           if x != y), None)
        row = {"rank": r, "device": res["device"],
               "backend": res["backend"],
               "losses_bitwise": got == want,
               "first_unequal_loss_step": first_step,
               "first_unequal_leaf": first_leaf,
               "max_loss_gap": max(abs(x - y) for x, y in zip(got, want)),
               "params_bitwise": n_eq == n, "params_equal_share": n_eq / n,
               "params_within_1e-4": n_close / n, "max_param_gap": max_gap,
               "peak_memory_gb": res["peak_memory_bytes"] / 1e9,
               "launches": res["launches"],
               "times": times_by_kind(res["records"], kinds)}
        print(f"  {label} rank {r} on {res['device']} ({res['backend']}): "
              f"losses bitwise {row['losses_bitwise']} (gap "
              f"{row['max_loss_gap']:.2e}); params bitwise "
              f"{row['params_bitwise']}, equal share "
              f"{row['params_equal_share']:.6f}, within 1e-4 "
              f"{row['params_within_1e-4']:.6f}, max gap {max_gap:.2e}"
              f" (first unequal: loss step {first_step}, leaf "
              f"{first_leaf}); "
              f"peak {row['peak_memory_gb']:.2f} GB; launches "
              f"{json.dumps(res['launches'])}", flush=True)
        print_rank_times(row["times"], transport)
        if bitwise:
            assert row["losses_bitwise"] and row["params_bitwise"], (
                label, r, "not bit for bit its simulated worker", row)
        assert row["max_loss_gap"] < 1e-4, (label, r, got, want)
        assert n_close / n >= 0.99 and max_gap <= 0.05, (label, r, row)
        assert res["launches"] == ref["launches"], (label, r)
        if "audit" in res:
            rec = res["audit"]["summary"]["recorded_bytes"]
            same = res["recorded"] == ref["recorded"]
            row["audit"] = {"ok": res["audit"]["ok"],
                            "collectives": len(res["recorded"]),
                            "recorded_bytes": rec,
                            "sequence_equal_sim": same}
            print(f"    audit: {len(res['recorded'])} collectives, "
                  f"{'clean' if res['audit']['ok'] else 'VIOLATIONS'}; "
                  f"the simulated worker's sequence: {same}; bytes a "
                  f"worker per round {json.dumps(rec)}", flush=True)
            assert res["audit"]["ok"], (label, r,
                                        res["audit"]["violations"][:5])
            assert same, (label, r, "recorded collectives differ")
            assert rec == ref["audit"]["recorded_bytes"], (label, r, rec)
        rows.append(row)
    return rows


# 6a, 6c and on one card 6b (four ranks on one card over gloo, their
# exchange through host memory; a world of one) run gpt2 FULL width at
# DIST_LAYERS of its 12 layers, and 4i and 4n(iv) (the paths through
# checkpoint files) at FILE_LAYERS, so that the script keeps its time
# limit as phases 12-14 join it (2 layers from PR 26, 1 from PR 28; the
# same 19 leaves and 16 buckets at any depth, so the same launches)
DIST_LAYERS, FILE_LAYERS = 1, 1


def dist_runs(cards):
    """The runs of phases 6a-6c by key, in the order phase 6 runs them
    (see the module docstring)."""
    layouts = full_plan("gpt2").layouts
    expect = expected_launches("gpt2", layouts)
    onebit = expected_launches("gpt2_onebit", layouts)
    bucketed = expected_launches("gpt2", layouts, n_units())
    local_only = expected_launches("gpt2_qint8", layouts)
    runs = {}
    gloo = f"gloo via host memory, {N_WORKERS} ranks on one card"
    on_card = ["--mode", "dist", "--backend", "gloo", "--device", "cuda:0"]
    for key, launches, extra in (
            ("6a", expect, []), ("6a_onebit", onebit, ONEBIT),
            ("6a_bucketed", bucketed, BUCKETED), ("6a_lamb", expect, LAMB),
            ("6a_qint8", local_only, QINT8)):
        label = run_label("6a", extra)
        flags = gpt2_argv(BATCH, ["--micro-batches", "2", "--layers",
                                  str(DIST_LAYERS), *extra])
        runs[key] = DistRun(
            key, label, f"phase {label}: gpt2 FULL width, {DIST_LAYERS} of "
            f"12 layers, {N_WORKERS} ranks on cuda:0 over gloo, batch "
            f"{BATCH}, seq {SEQ}, micro-batches 2, vs sim", flags + ["--mode", "sim", "--workers",
                                str(N_WORKERS), "--device", "cuda:0"],
            flags + on_card, N_WORKERS, gloo, launches, bitwise=True,
            opts={"probe": PROFILED_STEP} if key == "6a" else {})
        if key == "6a":
            runs["6a_sequential"] = sequential_twin(runs["6a"])
    # early issue at gpt2 FULL's full depth, the units packed and issued
    # in the order the backward makes their gradients final (a configure
    # of launch.train: no CLI flag, as in the reference), against its
    # sequential twin (no in-process run: the pair is held to itself)
    from repro_torch.launch import train as launch

    reverse = functools.partial(launch.optimizer_fields,
                                pack_order="reverse_backward")
    flags = gpt2_argv(BATCH, ["--micro-batches", "2", *BUCKETED]) + on_card
    runs["6a_full"] = DistRun(
        "6a_full", "6a full depth bucketed reverse_backward",
        f"phase 6a full depth: gpt2 FULL (12 layers), {N_WORKERS} ranks on "
        f"cuda:0 over gloo, batch {BATCH}, seq {SEQ}, micro-batches 2, "
        f"--bucket-mb {BUCKET_MB}, pack_order reverse_backward, early issue"
        f" vs sequential", None, flags, N_WORKERS, gloo,
        expected_launches("gpt2", layouts,
                          n_units(pack_order="reverse_backward")),
        opts={"configure": reverse, "probe": PROFILED_STEP})
    runs["6a_full_sequential"] = sequential_twin(runs["6a_full"])
    batch = BATCH // N_WORKERS * cards
    ref_mode = (["--mode", "single", "--layers", str(DIST_LAYERS)]
                if cards == 1 else ["--mode", "sim", "--workers", str(cards)])
    one = ["--layers", str(DIST_LAYERS)] if cards == 1 else []
    for key, launches, extra in (
            ("6b", expect, []), ("6b_bucketed", bucketed, BUCKETED),
            ("6b_adam", {}, ["--optimizer", "adam"]),
            ("6b_onebit", onebit, ONEBIT), ("6b_lamb", expect, LAMB)):
        label = run_label("6b", extra)
        runs[key] = DistRun(
            key, label, f"phase {label}: gpt2 FULL"
            f"{f' width, {DIST_LAYERS} of 12 layers' if one else ''}, "
            f"{cards} rank(s) over NCCL (one card each), batch {batch}, "
            f"seq {SEQ}, vs {ref_mode[1]}",
            gpt2_argv(batch, ref_mode + extra),
            gpt2_argv(batch, ["--mode", "dist", "--backend", "nccl",
                              "--device", "cuda", *one, *extra]), cards,
            f"NCCL, {cards} card(s)", launches,
            opts={"probe": PROFILED_STEP} if key == "6b" else {})
        if key == "6b":
            runs["6b_sequential"] = sequential_twin(runs["6b"])
    # 6c: run 4d in processes, 2 pods x 2 ranks over process subgroups:
    # NCCL with one rank per card where there are four cards, else four
    # ranks on cuda:0 over gloo (asked for) with micro-batches 2
    four = cards == N_WORKERS
    extra = ["--hierarchy", str(INNER)] + (
        [] if four else ["--micro-batches", "2", "--layers",
                         str(DIST_LAYERS)])
    transport = (f"NCCL, {N_WORKERS} cards" if four else
                 f"gloo via host memory, {N_WORKERS} ranks on one card")
    flags = gpt2_argv(BATCH, extra)
    runs["6c"] = DistRun(
        "6c", "6c", f"phase 6c: gpt2 FULL, {N_WORKERS // INNER} pods x "
        f"{INNER} ranks over {transport}, batch {BATCH}, seq {SEQ}, "
        f"{' '.join(extra)}, vs sim",
        flags + ["--mode", "sim", "--workers", str(N_WORKERS), "--device",
                 "cuda:0"],
        flags + ["--mode", "dist"] + (
            ["--backend", "nccl", "--device", "cuda"] if four else
            ["--backend", "gloo", "--device", "cuda:0"]), N_WORKERS,
        transport, expect, bitwise=not four)
    return runs


# the ranks' step without early issue (launch.train's trainer_cfg; no
# CLI flag, as in the reference)
SEQUENTIAL = {"peel_last_microbatch": False}


def sequential_twin(run):
    """The run ``run`` with ``peel_last_microbatch=False``, held to it by
    :func:`compare_twins`; it follows ``run`` in the same spawn."""
    return dataclasses.replace(
        run, key=f"{run.key}_sequential", label=f"{run.label} sequential",
        header=f"phase {run.label} sequential: as {run.label}, each unit "
        f"issued after the backward, one after another (held to "
        f"{run.label})", ref_argv=None,
        opts={**run.opts, "trainer_cfg": SEQUENTIAL, "probe": None},
        twin=run.key)


def dist_parts():
    """Phase 6's checks by name (see the module docstring), each a
    callable returning its summary; a run of 6a-6c alone spawns its own
    ranks (a run with a sequential twin, both)."""
    cards = min(torch.cuda.device_count(), N_WORKERS)
    parts = {"probe": lambda: {
        "nccl": probe_exchange("nccl", "cuda", cards,
                               INNER if cards == N_WORKERS else None),
        "gloo cuda:0": probe_exchange("gloo", "cuda:0", N_WORKERS, INNER)}}
    runs = dist_runs(cards)
    twins = {run.twin: run for run in runs.values() if run.twin}
    for key, run in runs.items():
        if run.twin:
            continue        # runs with the run it twins
        if key in twins:
            # the run and its sequential twin, in one spawn
            parts[key] = lambda pair=(run, twins[key]): run_dist(list(pair))
        else:
            parts[key] = lambda run=run: run_dist([run])[run.key]
    parts["6d"] = run_6d
    parts["6d_lamb"] = lambda: run_6d(LAMB)
    return parts


def run_dist_phase():
    """Phase 6 (see the module docstring): the probes, then 6a, 6b and
    6c, the runs of each of the three in one spawn of ranks, then 6d.
    Returns its summary."""
    t0 = time.time()
    parts = dist_parts()
    out = {"probe": parts["probe"]()}
    runs = dist_runs(min(torch.cuda.device_count(), N_WORKERS))
    for group in ("6a", "6b", "6c"):
        out.update(run_dist([run for key, run in runs.items()
                             if key.split("_")[0] == group]))
    out["6d"], out["6d_lamb"] = parts["6d"](), parts["6d_lamb"]()
    out["wall_s"] = time.time() - t0
    print(f"phase 6: {out['wall_s']:.1f} s", flush=True)
    return out


def run_label(part, extra):
    """``part`` and the optimizer of ``extra``, its codec where it names
    one, and "bucketed" where it fuses the exchange."""
    extra = list(extra)
    codec = extra[extra.index("--codec") + 1] if "--codec" in extra else ""
    return (f"{part} {optimizer_of(extra)}"
            f"{f' {codec}' if codec else ''}"
            f"{' bucketed' if '--bucket-mb' in extra else ''}")


def run_6d(extra=()):
    """Phase 6d, on four cards only: bert-large FULL in four NCCL ranks,
    one per card, masked-LM data, zero_one_adam (or the optimizer of
    ``extra``) with tensor scales, phase 4a's flags, global batch 32 x
    512. No run in this process holds it
    (four simulated workers of bert-large need ~43 GB of optimizer state
    before activations): each rank's losses are finite and start near
    log(padded vocab), its step kinds and launch counts are 4a's."""
    from repro_torch.configs.base import get

    if torch.cuda.device_count() < N_WORKERS:
        why = (f"needs {N_WORKERS} cards, one rank each; this machine has "
               f"{torch.cuda.device_count()}")
        print(f"phase {run_label('6d', extra)}: bert-large FULL in "
              f"processes not run: {why}", flush=True)
        return {"ran": False, "why": why}
    argv = ["--arch", "bert-large", "--steps", str(STEPS), "--batch",
            str(BERT_BATCH), "--seq", str(BERT_SEQ), "--sync-warmup", "2",
            "--double-every", "2", "--kappa", "1", "--log-every",
            str(STEPS), "--mode", "dist", "--backend", "nccl", "--device",
            "cuda", *extra]
    transport = f"NCCL, {N_WORKERS} cards"
    print(f"phase {run_label('6d', extra)}: bert-large FULL, {N_WORKERS} "
          f"ranks over {transport},"
          f" mlm data, batch {BERT_BATCH}, seq {BERT_SEQ}; no in-process "
          f"run to compare with (it does not fit on one card)", flush=True)
    ((ranks, wall),) = run_ranks([argv], N_WORKERS, kind="mlm",
                                 audit=False)
    expect = expected_launches("bert_large", full_plan("bert-large").layouts)
    log_vocab = float(np.log(get("bert-large").config.padded_vocab))
    syncs, vars_ = schedule("zero_one_adam", True)
    rows = []
    for r, res in enumerate(ranks):
        losses = [rec["losses"][0] for rec in res["records"]]
        row = {"rank": r, "device": res["device"], "losses": losses,
               "peak_memory_gb": res["peak_memory_bytes"] / 1e9,
               "launches": res["launches"],
               "times": times_by_kind(res["records"])}
        print(f"  {run_label('6d', extra)} rank {r} on {res['device']}: "
              f"losses "
              f"{[round(x, 4) for x in losses]}; peak "
              f"{row['peak_memory_gb']:.2f} GB; launches "
              f"{json.dumps(res['launches'])}", flush=True)
        print_rank_times(row["times"], transport)
        assert all(np.isfinite(losses)), (r, losses)
        assert abs(losses[0] - log_vocab) < 0.5, (r, losses[0], log_vocab)
        assert [rec["sync"] for rec in res["records"]] == syncs, r
        assert [rec["var"] for rec in res["records"]] == vars_, r
        assert res["launches"] == expect, (r, res["launches"], expect)
        rows.append(row)
    return {"ran": True, "transport": transport, "ranks_wall_s": wall,
            "ranks": rows}


# ----------------------------------------------------------------------- #
# phase 7: serving (repro_torch.serve through repro_torch.launch.serve),
# gpt2 FULL, params from the port's init
# ----------------------------------------------------------------------- #

# 7a: gpt2 at its native 1024 context, two waves of 8 requests
SERVE_BASE = ["--arch", "gpt2", "--slots", "8", "--max-seq", "1024",
              "--requests", "16", "--prompt-len", "512", "--gen", "128"]
SERVE_RUNS = {
    "7a": SERVE_BASE,
    "7b": SERVE_BASE + ["--publish-every", "32", "--codec", "qint8"],
    "7c": SERVE_BASE + ["--kv-quant", "qint8", "--kv-page", "16"],
    # prefill_32k: one request filling the 32768-position cache
    "7d": ["--arch", "gpt2", "--slots", "1", "--requests", "1",
           "--prompt-len", "32704", "--gen", "64", "--max-seq", "32768"],
}
LONE_REQUESTS = 4          # 7a's requests re-run alone at batch 1
SERVE_LOGIT_TOL = 1e-4     # batched against lone logits; a token may
                           # differ only where the top-2 gap is below it
BLOCKWISE_CHECK_S = 8192   # blockwise against dot_attn on the card
PUBLISH_CODECS = ("sign1bit", "qint4", "topk", "identity")   # 7e


def serve_build(argv):
    """``repro_torch.launch.serve``'s own setup of ``argv``, on the card."""
    from repro_torch.launch import serve as launch

    args = launch.parse_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return launch.build(args)


def serve_drive(run):
    """Tick ``run`` to the end through ``launch.serve.serve``; its ticks'
    times by kind: admission ticks (a prefill, then the batched decode)
    and pure decode ticks, with and without a weight swap."""
    from repro_torch.launch import serve as launch

    out = launch.serve(run)
    torch.cuda.synchronize()
    ticks = out["ticks"]
    decode = [t["ms"] for t in ticks if not t["prefills"]
              and not t["swapped"]]
    s = dict(run.scheduler.stats)
    res = {"stats": s, "seconds": out["seconds"],
           "tok_per_s": s["generated"] / out["seconds"],
           "decode_tick_ms": {"median": statistics.median(decode),
                              "min": min(decode), "max": max(decode),
                              "n": len(decode)},
           "admit_tick_ms": [t["ms"] for t in ticks if t["prefills"]],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "ticks": ticks}
    print(f"  {s['generated']} tokens in {out['seconds']:.3f} s "
          f"({res['tok_per_s']:.1f} tok/s); decode tick median "
          f"{res['decode_tick_ms']['median']:.3f} ms [{min(decode):.3f}-"
          f"{max(decode):.3f}] over {len(decode)} ticks; admission ticks "
          f"{[round(x, 1) for x in res['admit_tick_ms']]} ms; stats "
          f"{json.dumps(s)}; peak {res['peak_memory_gb']:.2f} GB",
          flush=True)
    return res


def record_logits(run, rids):
    """Wrap the scheduler's batched decode to keep, for the requests
    ``rids``, the logits row each decode gives: {(rid, token index):
    logits over the real vocab}."""
    sch, vocab, logs = run.scheduler, run.cfg.vocab, {}
    decode = sch._decode

    def recording(params, cache, tokens, pos, **kw):
        lg, cache = decode(params, cache, tokens, pos, **kw)
        for b, r in enumerate(sch.slots):
            if r is not None and r.rid in rids:
                logs[(r.rid, len(r.output))] = lg[b, 0, :vocab].clone()
        return lg, cache

    sch._decode = recording
    return logs


def top2_gap(logits) -> float:
    v = torch.topk(logits, 2).values
    return float(v[0] - v[1])


def check_lone(run, logs, n=LONE_REQUESTS, exact=False,
               cache_dtype=torch.float32, ulps_of_scale=None):
    """7a's check: the first ``n`` requests each alone at batch 1
    through ``Server.prefill_fn``/``decode_fn`` (a ``cache_dtype``
    cache), teacher-forced with the batched run's tokens: every greedy
    token equal, except where the lone logits' top-2 gap is under the
    tolerance (counted; ``exact``: none may differ), and every decode's
    logits within it of the batched ones; the smallest top-2 gap of the
    lone logits is kept. The tolerance is SERVE_LOGIT_TOL, or with
    ``ulps_of_scale`` that many bf16 ulps of the lone logits' largest
    magnitude (at bf16 compute). Times the lone prefills and decodes."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import Server

    cfg, dev, params = run.cfg, run.device, run.scheduler.params
    srv = Server(cfg, batch=1, max_seq=run.args.max_seq,
                 cache_dtype=cache_dtype, device=dev)

    def tol(lone):
        if ulps_of_scale is None:
            return SERVE_LOGIT_TOL
        return ulps_of_scale * 2.0 ** -7 * float(lone.abs().max())

    prefill, decode = srv.prefill_fn(), srv.decode_fn()
    V = cfg.vocab
    near_ties, worst, pre_ms, dec_ms, least = 0, 0.0, [], [], float("inf")
    for r in run.requests[:n]:
        cache = T.init_cache(cfg, 1, run.args.max_seq, cache_dtype, dev)
        tokens = torch.tensor([r.prompt], device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = prefill(params, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
        outs = [lg[0, -1, :V]]
        for i, tok in enumerate(r.output[:-1]):
            t0 = time.perf_counter()
            lg, cache = decode(params, cache, torch.tensor(
                [[tok]], device=dev), len(r.prompt) + i)
            outs.append(lg[0, 0, :V])
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t0) * 1e3)
        for i, lone in enumerate(outs):
            lone = lone.float()
            least = min(least, top2_gap(lone))
            if i:
                gap = float((lone - logs[(r.rid, i)].float()).abs().max())
                assert gap <= tol(lone), (r.rid, i, gap, tol(lone))
                worst = max(worst, gap)
            if int(lone.argmax()) != r.output[i]:
                gap = top2_gap(lone)
                assert gap < tol(lone), (r.rid, i, gap)
                near_ties += 1
    what = (SERVE_LOGIT_TOL if ulps_of_scale is None
            else f"{ulps_of_scale} bf16 ulps of the logits' scale")
    print(f"  lone check, {n} requests at batch 1: batched "
          f"logits within {worst:.2e} of the lone ones; {near_ties} "
          f"token(s) differ, each at a top-2 gap < {what}; "
          f"smallest top-2 gap {least:.3e}; lone prefill "
          f"{statistics.median(pre_ms):.3f} ms a request, decode "
          f"{statistics.median(dec_ms):.3f} ms a token", flush=True)
    assert not (exact and near_ties), near_ties
    return {"max_logit_gap": worst, "near_tie_tokens": near_ties,
            "min_top2_gap": least,
            "lone_prefill_ms": pre_ms,
            "lone_decode_ms_median": statistics.median(dec_ms)}


def run_7a(dev):
    print(f"phase 7a: {' '.join(SERVE_RUNS['7a'])}, f32 cache", flush=True)
    run = serve_build(SERVE_RUNS["7a"])
    logs = record_logits(run, set(range(LONE_REQUESTS)))
    res = serve_drive(run)
    assert all(r.done and len(r.output) == r.max_new_tokens
               for r in run.requests)
    res["lone"] = check_lone(run, logs)
    return res


def run_7b(dev):
    """7a with a qint8 delta publish every 32 ticks: after every apply the
    subscriber's anchors bit for bit the publisher's, the served tree
    their unbucketized bits, and within one quantization step (each
    chunk's scale, plus 2 ulp for the adds) of the trainer's params."""
    print(f"phase 7b: {' '.join(SERVE_RUNS['7b'])}, PublishConfig "
          f"defaults", flush=True)
    run = serve_build(SERVE_RUNS["7b"])
    pub, sub = run.publisher, run.subscriber
    trainer = {"params": run.params}
    log = {"apply_ms": [], "check_ms": [], "bytes": {}, "max_rel_step": 0.0}

    publish, apply = pub.publish, sub.apply

    def recorded_publish(params, step=0):
        trainer["params"] = params
        update = publish(params, step=step)
        log["bytes"][update.kind] = update.nbytes()
        return update

    def checked_apply(update):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = apply(update)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        log["apply_ms"].append((t1 - t0) * 1e3)
        assert all(torch.equal(a, b) for a, b in zip(sub._anchor,
                                                     pub._anchor))
        served = pub.wire.bucketize(params)
        assert all(torch.equal(a, b) for a, b in zip(served, pub._anchor))
        want = pub.wire.bucketize(trainer["params"])
        for k, (w, a) in enumerate(zip(want, served)):
            err = (w - a).abs()
            if update.kind == "snapshot":
                assert not err.any()
                continue
            step = torch.as_tensor(update.payloads[k]["scale"],
                                   device=a.device)
            bound = step + 2 * torch.nextafter(
                w.abs(), torch.full_like(w, np.inf)).sub(w.abs())
            assert (err <= bound).all(), k
            log["max_rel_step"] = max(log["max_rel_step"], float(
                (err / step.clamp_min(1e-30)).max()))
        torch.cuda.synchronize()
        log["check_ms"].append((time.perf_counter() - t1) * 1e3)
        return params

    pub.publish, sub.apply = recorded_publish, checked_apply
    res = serve_drive(run)
    checks, swap_ms = iter(log["check_ms"]), []
    for t in res["ticks"]:
        if t["swapped"]:
            ms = t["ms"] - next(checks)
            if not t["prefills"]:       # the first swap shares tick 0
                swap_ms.append(ms)      # with the first admissions
    n_pub = sum("publish_ms" in t for t in res["ticks"])
    res.update(
        publish_ms=[t["publish_ms"] for t in res["ticks"]
                    if "publish_ms" in t],
        apply_ms=log["apply_ms"], swap_tick_ms=swap_ms,
        bytes={"delta": log["bytes"].get("delta"),
               "snapshot": pub.wire.wire_bytes("snapshot"),
               "full_f32": pub.wire.full_f32_bytes(),
               "n_buckets": len(pub.wire.bp.buckets)},
        max_err_in_steps=log["max_rel_step"])
    print(f"  7b: {n_pub} publishes + the first snapshot, weight_swaps "
          f"{res['stats']['weight_swaps']}; bytes {json.dumps(res['bytes'])}"
          f"; publish ms {[round(x, 1) for x in res['publish_ms']]}; apply "
          f"ms {[round(x, 1) for x in log['apply_ms']]}; swap ticks "
          f"{[round(x, 1) for x in swap_ms]} ms (checks excluded); served "
          f"params within {log['max_rel_step']:.3f} quantization steps",
          flush=True)
    assert res["stats"]["weight_swaps"] == n_pub + 1
    assert len(log["apply_ms"]) == n_pub + 1 and n_pub >= 1
    return res


def run_7c(dev):
    """7a with the paged qint8 KV cache: the pages quantized are those
    each request filled while it ran, and one page of a lane, quantized
    on the card, is bit for bit the CPU's ``quant_page`` of it."""
    from repro_torch.serve.scheduler import quant_page

    print(f"phase 7c: {' '.join(SERVE_RUNS['7c'])}", flush=True)
    run = serve_build(SERVE_RUNS["7c"])
    res = serve_drive(run)
    a, sch = run.args, run.scheduler
    # a request quantizes after each token but its last, at positions
    # prompt .. prompt + gen - 2
    want = sum((len(r.prompt) + r.max_new_tokens - 2) // a.kv_page
               for r in run.requests)
    assert res["stats"]["pages_quantized"] == want, (res["stats"], want)
    # slot 0's last tenant left page (prompt + gen - 2) // page unquantized
    start = (a.prompt_len + a.gen - 2) // a.kv_page * a.kv_page
    lane = {k: c[:, :1].clone() for k, c in sch.cache.items()}
    cpu = {k: c.cpu() for k, c in lane.items()}
    assert all(c[:, 0, start:start + a.kv_page].any() for c in cpu.values())
    quant_page(lane, 0, start, a.kv_page, a.max_seq)
    quant_page(cpu, 0, start, a.kv_page, a.max_seq)
    same = all(torch.equal(lane[k].cpu(), cpu[k]) for k in lane)
    print(f"  7c: pages_quantized {res['stats']['pages_quantized']} "
          f"(expected {want}); page at {start} of slot 0 quantized on the "
          f"card bit for bit the CPU's: {same}", flush=True)
    assert same
    res["quant_page_bitwise"] = same
    return res


def run_7d(dev):
    """The long shapes (prefill_32k): one request of 32704 tokens, a
    blockwise prefill and 64 decodes against the full cache; then at S =
    BLOCKWISE_CHECK_S the blockwise forward's logits against dot_attn's."""
    import dataclasses

    from repro_torch.models import transformer as T

    print(f"phase 7d: {' '.join(SERVE_RUNS['7d'])}", flush=True)
    run = serve_build(SERVE_RUNS["7d"])
    res = serve_drive(run)
    res["prefill_s"] = res["admit_tick_ms"][0] / 1e3
    print(f"  7d: admission tick (prefill of {run.args.prompt_len} tokens "
          f"+ the first batched decode) {res['prefill_s']:.3f} s; decode "
          f"{res['decode_tick_ms']['median']:.3f} ms a token", flush=True)
    cfg, params = run.cfg, run.params
    del run
    gc.collect()
    torch.cuda.empty_cache()
    S = BLOCKWISE_CHECK_S
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, S))).to(dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        bw, _ = T.forward(params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dense, _ = T.forward(params, dataclasses.replace(
            cfg, blockwise_threshold=S + 1), {"tokens": tokens})
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    err = float((bw - dense).abs().max())
    print(f"  7d: forward at S={S}: blockwise {1e3 * (t1 - t0):.1f} ms, "
          f"dot_attn {1e3 * (t2 - t1):.1f} ms; logits within {err:.2e}",
          flush=True)
    assert err <= SERVE_LOGIT_TOL, err
    res.update(blockwise_vs_dot_max_err=err,
               forward_8k_ms={"blockwise": 1e3 * (t1 - t0),
                              "dot_attn": 1e3 * (t2 - t1)})
    return res


def run_7e(dev):
    """One snapshot and two deltas per codec at gpt2 FULL (PublishConfig
    defaults): payload bytes equal ``wire_bytes``, subscriber anchors bit
    for bit the publisher's; identity round-trips bit for bit; sign1bit
    launches kernels 2-4 (one of each per bucket for a delta's encode,
    one decompress per bucket for each side's anchor advance), and its
    packed bytes are the CPU plain path's for the first, a middle and the
    last bucket, scales within ROWSUM_ULPS."""
    from repro_torch.kernels import build
    from repro_torch.launch.serve import perturb
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.configs.base import get
    from repro_torch.serve import Publisher, PublishConfig, Subscriber

    cfg = get("gpt2").config
    p0 = init_params(T.model_template(cfg), 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    trees = [p0, perturb(p0, gen)]
    trees.append(perturb(trees[1], gen))
    out = {}
    for codec in PUBLISH_CODECS:
        pc = PublishConfig(codec=codec)
        pub, sub = Publisher(p0, pc), Subscriber(p0, pc)
        nb = len(pub.wire.bp.buckets)
        picks = sorted({0, nb // 2, nb - 1})
        rows = []
        for t, p in enumerate(trees):
            before = [None if pub._anchor is None else pub._anchor[k].cpu()
                      for k in picks]
            torch.cuda.synchronize()
            build.launch_counts.clear()
            t0 = time.perf_counter()
            u = pub.publish(p, step=t)
            torch.cuda.synchronize()
            pub_ms = (time.perf_counter() - t0) * 1e3
            pub_launches = dict(build.launch_counts)
            build.launch_counts.clear()
            t0 = time.perf_counter()
            got = sub.apply(u)
            torch.cuda.synchronize()
            apply_ms = (time.perf_counter() - t0) * 1e3
            apply_launches = dict(build.launch_counts)
            assert u.nbytes() == pub.wire.wire_bytes(u.kind)
            assert all(torch.equal(a, b) for a, b in zip(sub._anchor,
                                                         pub._anchor))
            row = {"kind": u.kind, "bytes": u.nbytes(),
                   "publish_ms": pub_ms, "apply_ms": apply_ms,
                   "publish_launches": pub_launches,
                   "apply_launches": apply_launches}
            if codec == "identity":
                from repro_torch.core.leafwise import flatten_tree
                assert all(torch.equal(a, b) for a, b in zip(
                    flatten_tree(got)[1], flatten_tree(p)[1]))
            if codec == "sign1bit":
                k2 = nb if u.kind == "delta" else 0
                assert pub_launches == ({"abs_rowsum": k2, "ef_quantize": k2,
                                         "decompress": k2} if k2 else {}), \
                    pub_launches
                assert apply_launches == ({"decompress": k2} if k2
                                          else {}), apply_launches
                if u.kind == "delta":
                    row["cpu_check"] = sign1bit_vs_cpu(pub, p, before,
                                                       picks, u)
            rows.append(row)
        print(f"  7e {codec}: {nb} buckets; " + "; ".join(
            f"{r['kind']} {r['bytes']} B, publish {r['publish_ms']:.1f} "
            f"ms, apply {r['apply_ms']:.1f} ms"
            + (f", launches {json.dumps(r['publish_launches'])} + apply "
               f"{json.dumps(r['apply_launches'])}"
               if codec == "sign1bit" else "") for r in rows), flush=True)
        out[codec] = {"n_buckets": nb, "publishes": rows,
                      "full_f32_bytes": pub.wire.full_f32_bytes()}
        del pub, sub
        gc.collect()
        torch.cuda.empty_cache()
    return out


def sign1bit_vs_cpu(pub, params, anchors, picks, update):
    """The CPU plain path's payload of buckets ``picks`` from the same
    params and anchors: packed bytes bit for bit the card's, scales
    within ROWSUM_ULPS."""
    bufs = pub.wire.bucketize(params)
    codec, worst = pub.wire.codec, 0
    for k, anchor in zip(picks, anchors):
        delta = (bufs[k].cpu() - anchor)[None]
        p, _ = codec.encode_worker(delta, torch.zeros_like(delta),
                                   pub.wire.bp.buckets[k].layout,
                                   pub.cfg.scale_mode)
        got = update.payloads[k]
        assert np.array_equal(p["packed"][0].numpy(), got["packed"]), k
        worst = max(worst, ulps(p["scales"][0].contiguous(),
                                torch.from_numpy(got["scales"])))
    assert worst <= ROWSUM_ULPS, worst
    return {"buckets": picks, "packed_bitwise": True, "scale_ulps": worst}


def serve_parts(dev):
    """Phase 7's runs by name, in order."""
    return {"7a": lambda: run_7a(dev), "7b": lambda: run_7b(dev),
            "7c": lambda: run_7c(dev), "7d": lambda: run_7d(dev),
            "7e": lambda: run_7e(dev)}


def run_serve_phase(dev):
    out = {}
    for name, run in serve_parts(dev).items():
        out[name] = run()
        for r in out[name].values() if name == "7e" else [out[name]]:
            r.pop("ticks", None)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def check_small_serve(dev, arch="gpt2", prompt_len=12):
    """Phase 5: ``arch``'s smoke config (gpt2; the state-space family at
    a prompt of 16, two chunks; whisper with seeded frames, encoded once,
    its decodes given ``enc_out``), prefill + 8 greedy decode steps, 2
    prompts, on the card against the CPU from the same params: logits
    within SERVE_LOGIT_TOL, greedy tokens equal."""
    from repro_torch.configs.base import get
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params

    cfg = get(arch).smoke
    cpu = torch.device("cpu")
    params = init_params(T.model_template(cfg), 0, device=cpu)
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, prompt_len)))
    frames = torch.from_numpy((0.02 * rng.standard_normal(
        (2, cfg.enc_frames, cfg.d_model))).astype(np.float32))
    runs = []
    for d in (dev, cpu):
        p = _to(params, d)
        cache = T.init_cache(cfg, 2, 32, torch.float32, d)
        enc = (T.encode(p, cfg, frames.to(d)) if cfg.enc_layers else None)
        batch = {"tokens": prompt.to(d)}
        if enc is not None:
            batch["enc_out"] = enc
        lg, cache = T.prefill(p, cfg, batch, cache)
        logits, toks = [lg[:, -1, :cfg.vocab].cpu()], []
        for i in range(8):
            toks.append(logits[-1].argmax(-1))
            lg, cache = T.decode(p, cfg, toks[-1][:, None].to(d), cache,
                                 prompt_len + i, enc_out=enc)
            logits.append(lg[:, 0, :cfg.vocab].cpu())
        runs.append((torch.stack(logits), torch.stack(toks)))
    gap = float((runs[0][0] - runs[1][0]).abs().max())
    same = torch.equal(runs[0][1], runs[1][1])
    print(f"  {cfg.name} serve: prefill + 8 decodes, logits card-cpu "
          f"within {gap:.2e}, greedy tokens equal: {same}", flush=True)
    assert gap <= SERVE_LOGIT_TOL and same
    return {"max_logit_gap": gap, "tokens_equal": same}


# ----------------------------------------------------------------------- #
# phase 8: the communication audit's matrix and the lints
# ----------------------------------------------------------------------- #

def run_audit_phase():
    """Phase 8: ``python -m repro_torch.launch.audit --matrix --lints`` on
    the card, in this process: the 12-entry gpt2-smoke matrix, 8 recorded
    steps each, and the port's AST lints. Raises unless it exits 0.
    Returns each entry's verdict and counts, and the wall time."""
    from repro_torch.launch import audit as LA

    t0 = time.time()
    with scratch_dir() as tmp:
        path = os.path.join(tmp, "audit.jsonl")
        rc = LA.main(["--config", "gpt2", "--matrix", "--lints", "--device",
                      "cuda", "--json", path])
        with open(path) as f:
            recs = [json.loads(line) for line in f]
    out = {"exit_code": rc, "wall_s": time.time() - t0, "entries": [
        {"config": r["config"], "ok": r["ok"],
         "collectives": r["n_collectives"],
         "recorded_bytes": r["summary"]["recorded_bytes"]} for r in recs]}
    print(f"  audit matrix: exit code {rc}, {len(recs)} entries in "
          f"{out['wall_s']:.1f} s", flush=True)
    assert rc == 0 and len(recs) == 12 and all(r["ok"] for r in recs), out
    return out


# ----------------------------------------------------------------------- #
# phase 3e and phase 9: the dense rotary family (granite-3-8b,
# phi4-mini-3.8b, chatglm3-6b, gemma3-12b) at full width
# ----------------------------------------------------------------------- #

FAMILIES = ("granite-3-8b", "phi4-mini-3.8b", "chatglm3-6b", "gemma3-12b")
# (label, arch, workers, layers kept, global batch) of runs 9a and 9b:
# full width, depth cut so that a sync step fits the card. The optimizer
# updates its state in place (~29 B an element: param, grad, m, v, u,
# anchor, the error feedback), so granite runs 2 layers x 2 workers
# (1.606e9 stacked elements; 1 layer held ~63 B an element while a sync
# step kept a second copy of the state); 9b runs one worker (single
# mode) at 9a's batch a worker
FAMILY_RUNS = (("9a", "granite-3-8b", 2, 2, 8), ("9b", "chatglm3-6b", 1, 1, 4))
FAMILY_SEQ = 1024
# 9c: gemma3-12b at full width, 6 of its 48 layers (5 sliding, 1 global;
# 12 until phase 13 joined the script's time limit), 4 slots, 8 requests
# of 1536-2048 prompt tokens (past the 1024-token window) and 64 new
# tokens each, dense and window cache
SERVE9_LAYERS, SERVE9_SLOTS, SERVE9_REQUESTS = 6, 4, 8
SERVE9_PROMPTS, SERVE9_GEN = (1536, 2048), 64
SERVE9_LONE = 2            # requests re-run alone at batch 1 per cache
# 9d (four cards): gemma3-12b at full width, 2 layers (sliding), one
# worker a rank over NCCL, batch 4 x 2048 (1.455e9 elements a rank; with
# the state updated in place a rank holds ~29 B an element)
DIST9_LAYERS, DIST9_BATCH, DIST9_SEQ = 2, 4, 2048
# 3e: the frames of each training run of phase 9, as (label, arch,
# layers, workers of the plan, workers stacked in one process): 9a and
# 9b as FAMILY_RUNS gives them, 9d's one rank of N_WORKERS
FRAMES_3E = tuple((label, arch, layers, workers, workers)
                  for label, arch, workers, layers, _ in FAMILY_RUNS) + (
    ("9d", "gemma3-12b", DIST9_LAYERS, N_WORKERS, 1),)
FAMILY_NAMES = {label: {k: f"{k} ({arch}, {label})" for k in FAMILY_KERNELS}
                for label, arch, *_ in FRAMES_3E}
# 3f: the frames of one rank of 10c (deepseek-v2-236b FULL width, 2
# layers: the dense first one and one MoE layer, 4 ranks, EP 4): its DP
# units, the 102400 x 5120 embedding and head among them
MOE_LAYERS, MOE_BATCH, MOE_SEQ = 2, 4, 2048
FRAMES_3F = (("10c", "deepseek-v2-236b", MOE_LAYERS, N_WORKERS, 1),)
MOE_NAMES = {"10c": {k: f"{k} (deepseek-v2-236b, 10c)"
                     for k in FAMILY_KERNELS}}


def family_plan(arch, n_layers=None, workers=N_WORKERS):
    """The comm plan of ``arch`` FULL at ``workers`` workers, cut to
    ``n_layers`` where given: its data-parallel leaves (a MoE model's
    experts, split over the workers, are in no exchange unit)."""
    from repro_torch.configs.base import get
    from repro_torch.core.leafwise import make_plan
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.train.step import choose_ep

    from repro_torch.models.config import cut_layers

    cfg = get(arch).config
    if n_layers is not None:
        cfg = cut_layers(cfg, n_layers)
    tmpl = T.model_template(cfg, ep_workers=choose_ep(cfg.n_experts,
                                                      workers, None))
    plan = make_plan(L.param_shapes(tmpl), L.param_specs(tmpl),
                     L.dp_mask(tmpl), workers)
    keep = [i for i, dp in enumerate(plan.dp_mask) if dp]
    return dataclasses.replace(plan, **{
        f: [getattr(plan, f)[i] for i in keep]
        for f in ("paths", "shapes", "specs", "dp_mask", "layouts")})


def frames_3e_text(label, runs=FRAMES_3E):
    """What 3e's (or 3f's) frames of run ``label`` are, for the printed
    lines and the kernels line."""
    label, arch, layers, workers, stacked = next(
        f for f in runs if f[0] == label)
    who = (f"{workers} stacked workers" if stacked > 1 else
           "one worker" if workers == 1 else
           f"one rank of {workers} (its view and the last rank's chunk)")
    return f"{label}: {arch} FULL width, {layers} layer(s), {who}"


def rank_frames(lo, rank):
    """(rows, row counts, denominators, decode) of the two frames of leaf
    ``lo`` that rank ``rank`` of a one-worker-a-rank sync compresses: its
    own view (the worker side; both decodes on its shape) and the chunk
    it serves."""
    from repro_torch.core import compressor as C

    rows, _ = C.view_rows_cols(lo)
    total, _ = C.true_counts(lo)
    chunk = C.chunk_row_counts(lo)[rank]
    return [(rows, C.view_row_counts(lo), np.full(1, total), True),
            (rows // lo.n, chunk, np.full(1, max(chunk.sum(), 1)), False)]


def check_run_frames(dev, tally, runs, names, phase):
    """Kernels 1-4 on every frame of one step of each run of ``runs``
    ((label, arch, layers, workers, stacked)), tallied under
    ``names[label]``; a rank of a run in processes (one stacked worker)
    is timed on the last rank's frames and the others' chunks checked."""
    from repro_torch.core import compressor as C

    for label, arch, layers, workers, stacked in runs:
        print(f"  {phase} {frames_3e_text(label, runs)}", flush=True)
        plan = family_plan(arch, layers, workers)
        last = workers - 1
        check_kernels(dev, tally, plan, names[label], stacked,
                      None if stacked == workers
                      else (lambda lo: rank_frames(lo, last)))
        if stacked == workers:
            continue
        gen = torch.Generator(device=dev).manual_seed(1)
        for lo in plan.layouts:
            chunks = [rank_frames(lo, r)[1] for r in range(last)]
            check_compress_frames(dev, gen, tally, None, lo,
                                  C.view_rows_cols(lo)[1], chunks, 1)
        torch.cuda.empty_cache()


def check_family_kernels(dev, tally):
    """Phase 3e: kernels 1-4 against their plain versions on every frame
    of one step of each training run of phase 9 (FRAMES_3E: 9a's stacked
    workers, 9b's single worker, a rank of 9d; worker and server frames),
    timed as 3a under FAMILY_NAMES (9d's under its last rank, whose chunk
    holds any pad; the other ranks' chunks checked only); then
    ``dispatch.frame_precheck`` on every unit of the four FULL configs at
    full depth, at 2 and 4 stacked workers (metadata only): every unit
    must pass. Returns the pre-check's counts."""
    check_run_frames(dev, tally, FRAMES_3E, FAMILY_NAMES, "3e")
    return precheck_units(FAMILIES)


def precheck_units(archs):
    """``dispatch.frame_precheck`` on every unit of ``archs``' FULL
    configs at full depth, at 2 and 4 stacked workers (metadata only):
    every unit must pass. Returns the counts and the largest frame."""
    from repro_torch.core import compressor as C
    from repro_torch.kernels import dispatch as K

    checked, largest = 0, (0, None)
    for a in archs:
        for n in (2, 4):
            plan = family_plan(a, workers=n)
            for path, lo in zip(plan.paths, plan.layouts):
                issues = K.frame_precheck(lo, stack=n)
                assert not issues, (a, n, path, issues)
                rows, cols = C.view_rows_cols(lo)
                largest = max(largest, (n * rows * cols,
                                        f"{a} {'/'.join(path)} x{n}"))
                checked += 1
    print(f"  frame_precheck: {checked} units of {', '.join(archs)} FULL at "
          f"2 and 4 stacked workers pass; the largest frame {largest[1]} "
          f"holds {largest[0]:,} elements", flush=True)
    return {"units_checked": checked, "largest_frame": largest[1],
            "largest_frame_elements": largest[0]}


def run_family_training(dev):
    """Runs 9a and 9b through :func:`run_main_path`: zero_one_adam with
    tensor scales, FAMILY_RUNS' workers (simulated; one: single mode) and
    batch of seq 1024, phase 4's 8-step schedule, remat on (the FULL
    configs set it), each audited, its launches of kernels 1-4 those
    ``expected_launches`` gives."""
    from repro_torch.configs.base import get

    out = {}
    for label, arch, workers, layers, batch in FAMILY_RUNS:
        cfg = get(arch).config
        print(f"phase {label}: {arch} FULL width (d {cfg.d_model}, "
              f"{cfg.n_heads} heads, kv {cfg.n_kv}, ff {cfg.d_ff}, vocab "
              f"{cfg.vocab}), {layers} of {cfg.n_layers} layers, "
              f"{workers} worker(s), batch {batch}, seq {FAMILY_SEQ}, "
              f"remat {cfg.remat}", flush=True)
        out[label] = run_main_path(dev, label, arch, [], batch, FAMILY_SEQ,
                                   "lm", workers, layers)
        report_density(out[label], arch, layers, workers)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def report_density(run, arch, layers, workers):
    """Print and keep a run's peak memory per 1e9 stacked elements (the
    params of every stacked worker)."""
    elements = workers * sum(
        int(np.prod(lo.shape)) for lo in family_plan(arch, layers,
                                                     workers).layouts)
    run["stacked_elements"] = elements
    run["gb_per_1e9_elements"] = run["peak_memory_gb"] / (elements / 1e9)
    print(f"  {arch} {layers} layer(s) x {workers} worker(s): "
          f"{elements / 1e9:.3f}e9 stacked elements, peak "
          f"{run['peak_memory_gb']:.2f} GB = "
          f"{run['gb_per_1e9_elements']:.2f} GB per 1e9", flush=True)


def run_9a_one_layer(dev):
    """9a as it ran before the in-place optimizer, at 1 layer: its peak
    against the 75.8 GB of the two-copy step."""
    label, arch, workers, _, batch = FAMILY_RUNS[0]
    run = run_main_path(dev, label, arch, [], batch, FAMILY_SEQ, "lm",
                        workers, 1)
    report_density(run, arch, 1, workers)
    return run


def serve9_run(dev, params, window_cache):
    """9c's serve of one cache kind through ``launch.serve.serve`` (the
    CLI's tick loop) over a Scheduler of gemma3-12b cut to SERVE9_LAYERS,
    the logits of every decode recorded."""
    from repro_torch.configs.base import get
    from repro_torch.launch import serve as launch
    from repro_torch.serve import Request, Scheduler, Server

    cfg = dataclasses.replace(get("gemma3-12b").config,
                              n_layers=SERVE9_LAYERS,
                              window_cache=window_cache)
    max_seq = SERVE9_PROMPTS[1] + SERVE9_GEN
    args = launch.parse_args([
        "--arch", "gemma3-12b", "--slots", str(SERVE9_SLOTS), "--max-seq",
        str(max_seq), "--requests", str(SERVE9_REQUESTS), "--gen",
        str(SERVE9_GEN)])
    rng = np.random.default_rng(args.seed + 1)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(n)).tolist(),
                    max_new_tokens=SERVE9_GEN)
            for i, n in enumerate(rng.integers(*SERVE9_PROMPTS,
                                               SERVE9_REQUESTS))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = Server(cfg, batch=SERVE9_SLOTS, max_seq=max_seq,
                 cache_dtype=torch.float32, device=dev)
    sch = Scheduler(srv, params)
    for r in reqs:
        sch.submit(r)
    run = launch.ServeRun(args=args, cfg=cfg, device=dev, params=params,
                          server=srv, scheduler=sch, requests=reqs)
    logs = record_logits(run, {r.rid for r in reqs})
    res = serve_drive(run)
    assert all(r.done and len(r.output) == SERVE9_GEN for r in reqs)
    res["lone"] = check_lone(run, logs, SERVE9_LONE)
    res.pop("ticks")
    return run, logs, res


def run_9c(dev):
    """9c: gemma3-12b at full width, SERVE9_LAYERS layers, from the port's
    own seeded init, served through the Scheduler with the dense cache
    and with ``window_cache=True``: each run's first requests against a
    lone run (phase 7's bar), and the two runs' tokens equal but where a
    top-2 gap under SERVE_LOGIT_TOL makes a near tie (the first such
    token ends that request's comparison). Decode ms a tick, prefill
    (admission tick) ms and peak memory for both caches."""
    from repro_torch.configs.base import get
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get("gemma3-12b").config,
                              n_layers=SERVE9_LAYERS)
    kinds = ["sliding" if f else "global" for f in T._layer_flags(cfg)]
    print(f"phase 9c: gemma3-12b FULL width, {SERVE9_LAYERS} of 48 layers "
          f"({kinds.count('sliding')} sliding, {kinds.count('global')} "
          f"global), {SERVE9_SLOTS} slots, {SERVE9_REQUESTS} requests of "
          f"{SERVE9_PROMPTS[0]}-{SERVE9_PROMPTS[1]} + {SERVE9_GEN} tokens, "
          f"f32 cache, dense and window", flush=True)
    t0 = time.time()
    params = L.init_params(T.model_template(cfg), 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    out, runs = {"init_s": init_s}, {}
    for name, wc in (("dense", False), ("window", True)):
        print(f"  9c {name} cache", flush=True)
        run, logs, res = serve9_run(dev, params, wc)
        runs[name] = (run, logs)
        out[name] = res
        del run
        gc.collect()
        torch.cuda.empty_cache()
    (dense, dlogs), (window, wlogs) = runs["dense"], runs["window"]
    near, compared = 0, 0
    for a, b in zip(dense.requests, window.requests):
        for i, (x, y) in enumerate(zip(a.output, b.output)):
            if x != y:
                # the first token comes from the prefill, the same
                # computation for both caches; later ones are recorded
                gaps = [top2_gap(lg[(a.rid, i)]) for lg in (dlogs, wlogs)
                        if (a.rid, i) in lg]
                assert gaps and min(gaps) < SERVE_LOGIT_TOL, (a.rid, i, gaps)
                near += 1
                break
            compared += 1
    print(f"  9c window cache against dense: {compared} tokens equal, "
          f"{near} request(s) part at a top-2 gap < {SERVE_LOGIT_TOL}; "
          f"params init {init_s:.1f} s", flush=True)
    out["tokens_equal"], out["near_tie_requests"] = compared, near
    del params, runs, dense, window
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_9d():
    """9d, on four cards only: gemma3-12b at full width, DIST9_LAYERS
    layers (both sliding), four NCCL ranks with one worker each,
    zero_one_adam with tensor scales, phase 4a's flags, batch DIST9_BATCH
    x DIST9_SEQ. No run in one process holds it (four workers of it do
    not fit one card): each rank is audited (clean, its bytes a round
    those ``comm_accounting`` gives), its losses finite and its first
    near the random-init loss, its step kinds and launch counts 4a's
    schedule over gemma3's leaves."""
    from repro_torch.configs.base import get

    if torch.cuda.device_count() < N_WORKERS:
        why = (f"needs {N_WORKERS} cards, one rank each; this machine has "
               f"{torch.cuda.device_count()}")
        print(f"phase 9d: gemma3-12b FULL in processes not run: {why}",
              flush=True)
        return {"ran": False, "why": why}
    argv = ["--arch", "gemma3-12b", "--steps", str(STEPS), "--batch",
            str(DIST9_BATCH), "--seq", str(DIST9_SEQ), "--sync-warmup",
            "2", "--double-every", "2", "--kappa", "1", "--log-every",
            str(STEPS), "--mode", "dist", "--backend", "nccl", "--device",
            "cuda"]
    transport = f"NCCL, {N_WORKERS} cards"
    print(f"phase 9d: gemma3-12b FULL width, {DIST9_LAYERS} layers, "
          f"{N_WORKERS} ranks over {transport}, batch {DIST9_BATCH}, seq "
          f"{DIST9_SEQ}", flush=True)
    # a rank's sync step needs ~70 of the card's 79 GiB: the ranks' caching
    # allocator maps expandable segments, so that freed blocks of the
    # 3.75 GiB embedding views are reused across sizes (a probe in single
    # mode on one card left 3.6 GiB reserved but unusable)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ((ranks, wall),) = run_ranks([argv], N_WORKERS,
                                     n_layers=DIST9_LAYERS)
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    cfg = dataclasses.replace(get("gemma3-12b").config, n_layers=DIST9_LAYERS)
    expect = expected_launches(
        "gemma3", family_plan("gemma3-12b", DIST9_LAYERS).layouts)
    syncs, vars_ = schedule("zero_one_adam", True)
    rows = []
    for r, res in enumerate(ranks):
        losses = [rec["losses"][0] for rec in res["records"]]
        rec = res["audit"]["summary"]["recorded_bytes"]
        row = {"rank": r, "device": res["device"], "losses": losses,
               "peak_memory_gb": res["peak_memory_bytes"] / 1e9,
               "launches": res["launches"], "audit_ok": res["audit"]["ok"],
               "recorded_bytes": rec,
               "times": times_by_kind(res["records"])}
        print(f"  9d rank {r} on {res['device']}: losses "
              f"{[round(x, 4) for x in losses]}; peak "
              f"{row['peak_memory_gb']:.2f} GB; launches "
              f"{json.dumps(res['launches'])}; audit "
              f"{'clean' if row['audit_ok'] else 'VIOLATIONS'}, "
              f"{len(res['recorded'])} collectives, bytes a round "
              f"{json.dumps(rec)}", flush=True)
        print_rank_times(row["times"], transport)
        assert row["audit_ok"], (r, res["audit"]["violations"][:5])
        assert all(np.isfinite(losses)), (r, losses)
        assert abs(losses[0] - first_loss(cfg)) < 0.5, (r, losses[0])
        assert [x["sync"] for x in res["records"]] == syncs, r
        assert [x["var"] for x in res["records"]] == vars_, r
        assert res["launches"] == expect, (r, res["launches"], expect)
        rows.append(row)
    return {"ran": True, "transport": transport, "ranks_wall_s": wall,
            "ranks": rows}


def family_parts(dev):
    """Phase 5's family checks by name: each smoke config's 8 steps on
    the card against the CPU, at a peak lr of 3e-4 (at the CLI's 3e-3
    these models are chaotic in the last bit on one device: granite-
    smoke's losses move by 5.1e-4 in 8 steps from params one ulp up on
    the CPU, 2.1e-5 at 3e-4); gemma3-smoke's seq of 32 runs past its
    window of 8."""
    return {f"family_{a.split('-')[0]}":
            (lambda a=a: check_small_input(dev, a, ["--lr", "3e-4"], "lm"))
            for a in FAMILIES}


def run_family_phase(dev):
    """``--only families``: 3e (its own tally, printed), phase 5's family
    checks, 9a-9d. The full run takes 3e in phase 3 and the family checks
    in phase 5, and runs 9a-9d as phase 9 (:func:`run_phase9`)."""
    tally = Tally()
    out = {"3e": check_family_kernels(dev, tally)}
    out["3e"]["rows"] = {label: tally_rows(tally, names)
                         for label, names in FAMILY_NAMES.items()}
    for label, rows in out["3e"]["rows"].items():
        print(f"  3e {label} " + json.dumps(rows), flush=True)
    out["5"] = {k: run() for k, run in family_parts(dev).items()}
    out.update(run_phase9(dev))
    return out


def run_phase9(dev):
    out = run_family_training(dev)
    out["9c"] = run_9c(dev)
    out["9d"] = run_9d()
    return out


# --------------------------------------------------------------------- #
# phase 10: mixture of experts with expert parallelism
# --------------------------------------------------------------------- #

MOE_SMOKES = ("llama4-scout-17b-a16e", "deepseek-v2-236b")
# 10b: the real expert exchange between processes, checked against the
# simulated workers (which run each worker against the merged experts:
# an expert's gradient summed in another order, tests/test_torch_dist.py)
MOE_LOSS_TOL, MOE_PARAM_TOL = 1e-5, 1e-4


def moe_parts(dev):
    """Phase 10a's checks by name: each MoE smoke config in sim mode, 4
    workers (EP 4: the experts split over the workers, each worker run
    against the merged experts), 8 steps on the card against the CPU
    under phase 5's bars, at a peak lr of 3e-4."""
    return {f"moe_{a.split('-')[0]}":
            (lambda a=a: check_small_input(dev, a, ["--lr", "3e-4"], "lm"))
            for a in MOE_SMOKES}


def ep_records(res):
    """The expert-parallel exchange's share of each step of a rank:
    (ep_a2a_ms, aux, dropped_frac) per step."""
    return [{k: rec.get(k) for k in ("ep_a2a_ms", "aux", "dropped_frac")}
            for rec in res["records"]]


def run_10b():
    """10b: llama4-smoke in four gloo ranks on this one card (the expert
    exchange through host memory), each rank against the worker of its
    index in a sim run of the same flags on the card: losses within
    MOE_LOSS_TOL, params within MOE_PARAM_TOL, launch counts equal, its
    audit clean with the exchanges classified as expert-parallel dispatch
    and its optimizer collectives those of its simulated worker."""
    arch = MOE_SMOKES[0]
    base = ["--arch", arch, "--smoke", "--steps", str(STEPS), "--batch",
            "8", "--seq", "32", "--sync-warmup", "2", "--double-every",
            "2", "--kappa", "1", "--lr", "3e-4", "--log-every",
            str(STEPS)]
    print(f"phase 10b: {arch} in {N_WORKERS} gloo ranks on cuda:0 with "
          f"the real expert exchange, against {N_WORKERS} simulated "
          f"workers", flush=True)
    ref = run_in_process(base + ["--mode", "sim", "--workers",
                                 str(N_WORKERS)])
    argv = base + ["--mode", "dist", "--backend", "gloo", "--device",
                   "cuda:0", "--workers", str(N_WORKERS)]
    ((ranks, wall),) = run_ranks([argv], N_WORKERS)
    from repro_torch.configs.base import get

    cfg = get(arch).smoke
    moe_layers = cfg.n_layers - cfg.first_k_dense
    key = ("op", "level", "dtype", "shape")
    want_seq = [tuple(c[k] for k in key) for c in ref["recorded"]]
    rows = []
    for r, res in enumerate(ranks):
        got = [rec["losses"][0] for rec in res["records"]]
        want = [rec["losses"][r] for rec in ref["records"]]
        gap = max(abs(a - b) for a, b in zip(got, want))
        pgap = max(float((a[0] - b[r]).abs().max()) for a, b in zip(
            flatten_params(res["params"]), ref["params"]))
        seq = [tuple(c[k] for k in key) for c in res["recorded"]
               if c["level"] != "ep"]
        allowed = res["audit"]["summary"]["allowed"]
        ep = ep_records(res)
        row = {"rank": r, "max_loss_gap": gap, "max_param_gap": pgap,
               "launches": res["launches"], "audit_ok": res["audit"]["ok"],
               "allowed": allowed, "sequence_equal_sim": seq == want_seq,
               "ep_a2a_ms": [x["ep_a2a_ms"] for x in ep],
               "times": times_by_kind(res["records"])}
        print(f"  10b rank {r}: loss gap {gap:.2e}, param gap {pgap:.2e}; "
              f"launches {json.dumps(res['launches'])}; audit "
              f"{'clean' if row['audit_ok'] else 'VIOLATIONS'}, allowed "
              f"{json.dumps(allowed)}; optimizer collectives those of its "
              f"simulated worker: {row['sequence_equal_sim']}; EP a2a ms "
              f"a step {[round(x, 2) for x in row['ep_a2a_ms']]}",
              flush=True)
        assert all(np.isfinite(got)), (r, got)
        assert gap <= MOE_LOSS_TOL and pgap <= MOE_PARAM_TOL, row
        assert res["launches"] == ref["launches"], (r, res["launches"])
        assert row["audit_ok"], (r, res["audit"]["violations"][:5])
        assert allowed.get("expert-parallel dispatch") == (
            STEPS * moe_layers * 4), allowed
        assert row["sequence_equal_sim"], r
        rows.append(row)
    return {"ranks_wall_s": wall, "reference_launches": ref["launches"],
            "ranks": rows}


def flatten_params(tree):
    from repro_torch.core.leafwise import flatten_tree

    return flatten_tree(tree)[1]


def run_10c():
    """10c, on four cards only: deepseek-v2-236b at full width (d 5120,
    128 MLA heads, 160 experts of d_ff 1536), MOE_LAYERS layers (the dense
    first one and one MoE layer, 40 experts a rank), one NCCL rank a
    card, EP 4, zero_one_adam with tensor scales and phase 4a's schedule,
    8 steps of 1 x MOE_SEQ tokens a rank, remat on. Each rank audited
    (clean, the expert exchange classified as expert-parallel dispatch),
    its losses finite, the first near log(102400) plus the aux term, its
    step kinds and launch counts 4a's schedule over its DP leaves; peak
    memory, times by step kind, the EP exchange's ms, dropped_frac and
    aux printed per rank."""
    from repro_torch.configs.base import get

    arch = "deepseek-v2-236b"
    if torch.cuda.device_count() < N_WORKERS:
        why = (f"needs {N_WORKERS} cards, one rank each; this machine has "
               f"{torch.cuda.device_count()}")
        print(f"phase 10c: {arch} FULL in processes not run: {why}",
              flush=True)
        return {"ran": False, "why": why}
    cfg = dataclasses.replace(get(arch).config, n_layers=MOE_LAYERS)
    argv = ["--arch", arch, "--layers", str(MOE_LAYERS), "--steps",
            str(STEPS), "--batch", str(MOE_BATCH), "--seq", str(MOE_SEQ),
            "--sync-warmup", "2", "--double-every", "2", "--kappa", "1",
            "--log-every", "1", "--mode", "dist", "--backend", "nccl",
            "--device", "cuda"]
    transport = f"NCCL, {N_WORKERS} cards"
    print(f"phase 10c: {arch} FULL width (d {cfg.d_model}, {cfg.n_heads} "
          f"MLA heads, {cfg.n_experts} experts of d_ff {cfg.moe_d_ff}, top "
          f"{cfg.top_k}), {MOE_LAYERS} of 60 layers, {N_WORKERS} ranks "
          f"over {transport}, EP {N_WORKERS}, batch {MOE_BATCH}, seq "
          f"{MOE_SEQ}, remat {cfg.remat}", flush=True)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ((ranks, wall),) = run_ranks([argv], N_WORKERS)
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    expect = expected_launches(
        "deepseek", family_plan(arch, MOE_LAYERS).layouts)
    syncs, vars_ = schedule("zero_one_adam", True)
    rows = []
    for r, res in enumerate(ranks):
        losses = [rec["losses"][0] for rec in res["records"]]
        ep = ep_records(res)
        allowed = res["audit"]["summary"]["allowed"]
        first = first_loss(cfg) + cfg.aux_loss_weight * ep[0]["aux"]
        row = {"rank": r, "device": res["device"], "losses": losses,
               "first_loss_expected": first,
               "peak_memory_gb": res["peak_memory_bytes"] / 1e9,
               "peak_memory_gib": res["peak_memory_bytes"] / 2 ** 30,
               "launches": res["launches"], "audit_ok": res["audit"]["ok"],
               "allowed": allowed, "ep": ep,
               "recorded_bytes": res["audit"]["summary"]["recorded_bytes"],
               "times": times_by_kind(res["records"])}
        print(f"  10c rank {r} on {res['device']}: losses "
              f"{[round(x, 4) for x in losses]} (first expected "
              f"{first:.4f}); peak {row['peak_memory_gb']:.2f} GB "
              f"({row['peak_memory_gib']:.2f} GiB); launches "
              f"{json.dumps(res['launches'])}; audit "
              f"{'clean' if row['audit_ok'] else 'VIOLATIONS'}, allowed "
              f"{json.dumps(allowed)}", flush=True)
        print(f"    EP a2a ms a step "
              f"{[round(x['ep_a2a_ms'], 2) for x in ep]}; dropped_frac "
              f"{[round(x['dropped_frac'], 4) for x in ep]}; aux "
              f"{[round(x['aux'], 4) for x in ep]}", flush=True)
        print_rank_times(row["times"], transport)
        assert row["audit_ok"], (r, res["audit"]["violations"][:5])
        assert allowed.get("expert-parallel dispatch", 0) > 0, allowed
        assert all(np.isfinite(losses)), (r, losses)
        assert abs(losses[0] - first) < 0.1, (r, losses[0], first)
        assert [x["sync"] for x in res["records"]] == syncs, r
        assert [x["var"] for x in res["records"]] == vars_, r
        assert res["launches"] == expect, (r, res["launches"], expect)
        assert row["peak_memory_gib"] < 79.18, row["peak_memory_gib"]
        rows.append(row)
    return {"ran": True, "transport": transport, "ranks_wall_s": wall,
            "ranks": rows}


def run_moe_only(dev):
    """``--only moe``: 3f (its own tally, printed), then phase 10."""
    tally = Tally()
    check_run_frames(dev, tally, FRAMES_3F, MOE_NAMES, "3f")
    out = {"3f": {label: tally_rows(tally, names)
                  for label, names in MOE_NAMES.items()}}
    for label, rows in out["3f"].items():
        print(f"  3f {label} " + json.dumps(rows), flush=True)
    out.update(run_moe_phase(dev))
    return out


def run_moe_phase(dev):
    """Phase 10: 10a (both smokes, card against CPU), 10b (gloo ranks on
    one card), 10c (four cards only)."""
    out = {k: run() for k, run in moe_parts(dev).items()}
    out["10b"] = run_10b()
    out["10c"] = run_10c()
    return out


# --------------------------------------------------------------------- #
# phase 11: the state-space family (mamba2, zamba2) at full width
# --------------------------------------------------------------------- #

SSM_ARCHS = ("mamba2-2.7b", "zamba2-1.2b")
# (label, arch, workers, layers kept, global batch) of runs 11a and 11b:
# full width, seq 1024. mamba2-2.7b: 8 of its 64 layers, 2 simulated
# workers (1.16e9 stacked elements); zamba2-1.2b at full depth (38
# layers, the shared block applied 6 times), one worker (1.17e9)
SSM_RUNS = (("11a", "mamba2-2.7b", 2, 8, 8), ("11b", "zamba2-1.2b", 1, 38, 4))
SSM_SEQ = 1024
# 3g: the frames of one step of 11a and 11b (stacked as they run)
FRAMES_3G = tuple((label, arch, layers, workers, workers)
                  for label, arch, workers, layers, _ in SSM_RUNS)
SSM_NAMES = {label: {k: f"{k} ({arch}, {label})" for k in FAMILY_KERNELS}
             for label, arch, *_ in FRAMES_3G}
# 11c: each FULL config at full width from the port's seeded init, served
# through the Scheduler: 4 slots, 8 requests of 1024, 1536 or 2048 prompt
# tokens (multiples of the chunk of 256) and 64 new tokens, f32 cache
SERVE11_SLOTS, SERVE11_REQUESTS = 4, 8
# the depth 11c and 12c serve at: cut (from full depth, PRs 25-26) for the
# script's time limit as phase 13 joined it, and by half again as phase 14
# did; zamba2 keeps one application of its shared block, whisper 2
# encoder and 2 decoder layers
SERVE_LAYERS = {"mamba2-2.7b": 4, "zamba2-1.2b": 6, "qwen2-vl-2b": 4,
                "whisper-large-v3": 2}
SERVE11_PROMPTS, SERVE11_GEN = (1024, 1536, 2048), 64
SERVE11_LONE = 2           # requests re-run alone at batch 1 per model


def check_ssm_kernels(dev, tally):
    """Phase 3g: kernels 1-4 against their plain versions on every frame
    of one step of 11a (2 stacked workers) and 11b (one worker), worker
    and server frames, timed as 3a under SSM_NAMES; then
    ``dispatch.frame_precheck`` on every unit of both FULL configs at full
    depth, at 2 and 4 stacked workers."""
    check_run_frames(dev, tally, FRAMES_3G, SSM_NAMES, "3g")
    return precheck_units(SSM_ARCHS)


def ssm_parts(dev):
    """Phase 5's state-space checks by name: each smoke config's 8 steps
    on the card against the CPU at a peak lr of 3e-4 (seq 32: four chunks
    of 8), and its serve (a prefill of 16 tokens, 8 decodes)."""
    parts = {}
    for a in SSM_ARCHS:
        short = a.split("-")[0]
        parts[f"ssm_{short}"] = (lambda a=a: check_small_input(
            dev, a, ["--lr", "3e-4"], "lm"))
        parts[f"ssm_serve_{short}"] = (lambda a=a: check_small_serve(
            dev, a, 16))
    return parts


def run_ssm_training(dev):
    """Runs 11a and 11b through :func:`run_main_path`: zero_one_adam with
    tensor scales, SSM_RUNS' workers (one: single mode), batch and seq,
    phase 4's 8-step schedule, remat on (the FULL configs set it), each
    audited, its launches of kernels 1-4 those ``expected_launches``
    gives, every gradient of step 0 finite (the reference's chunked scan
    gives NaN there at the chunk of 256)."""
    from repro_torch.configs.base import get

    out = {}
    for label, arch, workers, layers, batch in SSM_RUNS:
        cfg = get(arch).config
        shared = (f", the shared block (heads {cfg.n_heads}, ff {cfg.d_ff}) "
                  f"applied {layers // cfg.attn_every} times"
                  if cfg.attn_every else "")
        print(f"phase {label}: {arch} FULL width (d {cfg.d_model}, "
              f"{cfg.ssm_heads} SSM heads x {cfg.ssm_head_dim}, state "
              f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab} "
              f"-> {cfg.padded_vocab}){shared}, {layers} of "
              f"{cfg.n_layers} layers, {workers} worker(s), batch {batch}, "
              f"seq {SSM_SEQ}, remat {cfg.remat}", flush=True)
        out[label] = run_main_path(dev, label, arch, [], batch, SSM_SEQ,
                                   "lm", workers, layers,
                                   check_first_grads=True)
        report_density(out[label], arch, layers, workers)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve11_run(dev, arch, params):
    """11c's serve of ``arch`` FULL through ``launch.serve.serve`` (the
    CLI's tick loop) over a Scheduler, the logits of every decode
    recorded, the first SERVE11_LONE requests checked against a lone run
    (7a's check)."""
    from repro_torch.launch import serve as launch
    from repro_torch.serve import Request, Scheduler, Server

    max_seq = max(SERVE11_PROMPTS) + SERVE11_GEN
    args = launch.parse_args([
        "--arch", arch, "--layers", str(SERVE_LAYERS[arch]), "--slots",
        str(SERVE11_SLOTS), "--max-seq", str(max_seq), "--requests",
        str(SERVE11_REQUESTS), "--gen", str(SERVE11_GEN)])
    cfg = launch.config_of(args)
    rng = np.random.default_rng(args.seed + 1)
    lens = rng.choice(SERVE11_PROMPTS, SERVE11_REQUESTS)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(n)).tolist(),
                    max_new_tokens=SERVE11_GEN) for i, n in enumerate(lens)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = Server(cfg, batch=SERVE11_SLOTS, max_seq=max_seq,
                 cache_dtype=torch.float32, device=dev)
    sch = Scheduler(srv, params)
    for r in reqs:
        sch.submit(r)
    run = launch.ServeRun(args=args, cfg=cfg, device=dev, params=params,
                          server=srv, scheduler=sch, requests=reqs)
    logs = record_logits(run, {r.rid for r in reqs})
    res = serve_drive(run)
    assert all(r.done and len(r.output) == SERVE11_GEN for r in reqs)
    res["prompt_lens"] = [int(n) for n in lens]
    res["lone"] = check_lone(run, logs, SERVE11_LONE)
    res.pop("ticks")
    return res


def run_11c(dev):
    """11c: mamba2-2.7b and zamba2-1.2b FULL width at SERVE_LAYERS, each
    from the port's own seeded init, served
    through the Scheduler (SERVE11_SLOTS slots, SERVE11_REQUESTS requests
    of SERVE11_PROMPTS prompt tokens + SERVE11_GEN new ones, f32 cache):
    decode ms a tick, prefill (admission tick) ms, peak memory, tokens
    equal to a lone run's."""
    from repro_torch.configs.base import get
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.config import cut_layers

    out = {}
    for arch in SSM_ARCHS:
        cfg = cut_layers(get(arch).config, SERVE_LAYERS[arch])
        print(f"phase 11c: {arch} FULL width, {cfg.n_layers} layers, "
              f"{SERVE11_SLOTS} slots, {SERVE11_REQUESTS} requests of "
              f"{'/'.join(map(str, SERVE11_PROMPTS))} + {SERVE11_GEN} "
              f"tokens, f32 cache", flush=True)
        t0 = time.time()
        params = L.init_params(T.model_template(cfg), 0, device=dev)
        torch.cuda.synchronize()
        init_s = time.time() - t0
        elements = sum(x.numel() for x in flatten_params(params))
        print(f"  {elements:,} parameters ({elements * 4 / 1e9:.2f} GB in "
              f"f32), init {init_s:.1f} s", flush=True)
        out[arch] = {"params": elements, "init_s": init_s,
                     **serve11_run(dev, arch, params)}
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_phase11(dev):
    out = run_ssm_training(dev)
    out["11c"] = run_11c(dev)
    return out


def run_ssm_only(dev):
    """``--only ssm``: 3g (its own tally, printed), phase 5's state-space
    checks, then phase 11."""
    tally = Tally()
    out = {"3g": check_ssm_kernels(dev, tally)}
    out["3g"]["rows"] = {label: tally_rows(tally, names)
                         for label, names in SSM_NAMES.items()}
    for label, rows in out["3g"]["rows"].items():
        print(f"  3g {label} " + json.dumps(rows), flush=True)
    out["5"] = {k: run() for k, run in ssm_parts(dev).items()}
    out.update(run_phase11(dev))
    return out


# --------------------------------------------------------------------- #
# phase 12: the vlm (qwen2-vl) and the encoder-decoder (whisper)
# --------------------------------------------------------------------- #

VLM_ENCDEC_ARCHS = ("qwen2-vl-2b", "whisper-large-v3")
# (label, arch, workers, layers kept, global batch, seq, extra CLI flags)
# of runs 12a and 12b, at full width: qwen2-vl-2b at full depth (28
# layers, 1.777e9 elements), one worker, batch 2 x 2048 (a 1024-token
# vision prefix of seeded embeddings, see ``seeded_vision``, then 1024
# text tokens); whisper-large-v3 with ``--layers 8`` (8 encoder and 8 decoder
# layers, 0.544e9 elements a worker), 2 simulated workers, batch 4 x 1024
# decoder tokens and 1500 zero frames a row
VLM_ENCDEC_RUNS = (
    ("12a", "qwen2-vl-2b", 1, 28, 2, 2048, []),
    ("12b", "whisper-large-v3", 2, 8, 4, 1024, ["--layers", "8"]))
# 3h: the frames of one step of 12a and 12b (stacked as they run)
FRAMES_3H = tuple((label, arch, layers, workers, workers)
                  for label, arch, workers, layers, *_ in VLM_ENCDEC_RUNS)
VLM_ENCDEC_NAMES = {label: {k: f"{k} ({arch}, {label})"
                            for k in FAMILY_KERNELS}
                    for label, arch, *_ in FRAMES_3H}
# 12c: both FULL configs at full width (SERVE_LAYERS) from the port's
# seeded init, f32 cache: qwen2-vl through the Scheduler as 11c
# (SERVE11_*), and through Server.prefill_fn with a seeded 1024-token
# vision prefix and SERVE12_TEXT text tokens; whisper through Server with
# seeded frames, encoded once, and a SERVE12_PROMPT-token prompt. Each
# Server run: SERVE12_ROWS rows, SERVE12_GEN greedy decodes, every row
# then alone at batch 1
SERVE12_ROWS, SERVE12_GEN, SERVE12_TEXT, SERVE12_PROMPT = 4, 64, 512, 4


def check_vlm_encdec_kernels(dev, tally):
    """Phase 3h: kernels 1-4 against their plain versions on every frame
    of one step of 12a (one worker) and 12b (2 stacked workers), worker
    and server frames, timed as 3a under VLM_ENCDEC_NAMES (qwen2-vl's
    (152064, 1536) embedding and head, its (28, 1536, 8960) MLP stacks and
    (28, 256) k/v biases; whisper's (32768, 1280) position table and its
    always-zero (8, 1280) cross biases among them); then
    ``dispatch.frame_precheck`` on every unit of both FULL configs at full
    depth, at 2 and 4 stacked workers."""
    check_run_frames(dev, tally, FRAMES_3H, VLM_ENCDEC_NAMES, "3h")
    return precheck_units(VLM_ENCDEC_ARCHS)


def vlm_encdec_parts(dev):
    """Phase 5's vlm and encoder-decoder checks by name: each smoke
    config's 8 steps on the card against the CPU at a peak lr of 3e-4,
    with the CLI's zero vision embeddings or frames, and its serve (a
    prefill of 12 tokens, past qwen2vl-smoke's 8-token prefix; whisper's
    seeded frames encoded once; 8 decodes)."""
    parts = {}
    for a in VLM_ENCDEC_ARCHS:
        short = a.split("-")[0]
        parts[f"vlm_encdec_{short}"] = (lambda a=a: check_small_input(
            dev, a, ["--lr", "3e-4"], "lm"))
        parts[f"vlm_encdec_serve_{short}"] = (lambda a=a: check_small_serve(
            dev, a, 12))
    return parts


@contextlib.contextmanager
def seeded_vision(dev, seed=12):
    """Inside the block the CLI's batches carry seeded vision embeddings
    (normal at 0.02, new ones every step, as a vision tower would give)
    in place of its zeros. With the zeros the prefix rows stay exactly
    zero through every layer, and each RMSNorm passes their gradient on
    times ``rsqrt(eps)`` = 1000: at qwen2-vl's 28 layers the step-0
    gradient overflows to NaN, in the reference as in the port
    (``tests/test_torch_vlm.py``)."""
    from repro_torch.launch import train as launch

    zeros = launch.add_model_inputs
    gen = torch.Generator(device=dev).manual_seed(seed)

    def seeded(batch, cfg, device=None):
        batch = zeros(batch, cfg, device)
        if "vision_embeds" in batch:
            v = batch["vision_embeds"]
            batch["vision_embeds"] = 0.02 * torch.randn(
                v.shape, device=v.device, generator=gen)
        return batch

    launch.add_model_inputs = seeded
    try:
        yield
    finally:
        launch.add_model_inputs = zeros


def run_vlm_encdec_training(dev):
    """Runs 12a and 12b through :func:`run_main_path`: zero_one_adam with
    tensor scales, VLM_ENCDEC_RUNS' workers (one: single mode), batch,
    seq and flags (12b cuts both stacks with the CLI's ``--layers``),
    phase 4's 8-step schedule, remat on (the FULL configs set it), each
    audited, its launches of kernels 1-4 those ``expected_launches``
    gives, every gradient of step 0 finite (12a on seeded vision
    embeddings: :func:`seeded_vision`)."""
    from repro_torch.configs.base import get

    out = {}
    for label, arch, workers, layers, batch, seq, extra in VLM_ENCDEC_RUNS:
        cfg = get(arch).config
        what = (f"{layers} encoder + {layers} decoder layers of "
                f"{cfg.enc_layers} + {cfg.n_layers}, {cfg.enc_frames} zero "
                f"frames a row" if cfg.enc_layers else
                f"{layers} of {cfg.n_layers} layers, M-RoPE "
                f"{cfg.mrope_sections}, a {cfg.vision_tokens}-token seeded "
                f"vision prefix")
        print(f"phase {label}: {arch} FULL width (d {cfg.d_model}, "
              f"{cfg.n_heads} heads, kv {cfg.n_kv}, ff {cfg.d_ff}, vocab "
              f"{cfg.vocab} -> {cfg.padded_vocab}), {what}, {workers} "
              f"worker(s), batch {batch}, seq {seq}, remat {cfg.remat} "
              f"{' '.join(extra)}", flush=True)
        with (seeded_vision(dev) if cfg.vision_tokens
              else contextlib.nullcontext()):
            out[label] = run_main_path(dev, label, arch, extra, batch, seq,
                                       "lm", workers, check_first_grads=True)
        report_density(out[label], arch, layers, workers)
        gc.collect()
        torch.cuda.empty_cache()
    return out


@torch.no_grad()
def serve12_rows(dev, arch, params, batch, prompt_len):
    """12c's Server run of ``arch`` FULL: ``prefill_fn`` of ``batch``
    (SERVE12_ROWS rows; whisper's frames encoded once first) and
    SERVE12_GEN greedy decodes through ``decode_fn`` (whisper's given
    ``enc_out``), each tick timed; then every row alone at batch 1,
    teacher-forced with the batched tokens: its greedy tokens equal,
    except where the lone logits' top-2 gap is under SERVE_LOGIT_TOL
    (counted), and its logits within SERVE_LOGIT_TOL of the batched."""
    from repro_torch.configs.base import get
    from repro_torch.models import transformer as T
    from repro_torch.models.config import cut_layers
    from repro_torch.serve import Server

    cfg = cut_layers(get(arch).config, SERVE_LAYERS[arch])
    V, max_seq = cfg.vocab, prompt_len + SERVE12_GEN

    def run(rows, forced=None):
        srv = Server(cfg, batch=len(rows), max_seq=max_seq,
                     cache_dtype=torch.float32, device=dev)
        prefill, decode = srv.prefill_fn(), srv.decode_fn()
        cache = T.init_cache(cfg, len(rows), max_seq, torch.float32, dev)
        b = {k: v[rows] for k, v in batch.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = None
        if cfg.enc_layers:
            enc = T.encode(params, cfg, b.pop("frames"))
            b["enc_out"] = enc
        lg, cache = prefill(params, b, cache)
        logits, ticks = [lg[:, -1, :V]], []
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        for i in range(SERVE12_GEN):
            tok = (logits[-1].argmax(-1) if forced is None
                   else forced[:, i].to(dev))
            t0 = time.perf_counter()
            lg, cache = decode(params, cache, tok[:, None], prompt_len + i,
                               enc_out=enc)
            logits.append(lg[:, 0, :V])
            torch.cuda.synchronize()
            ticks.append((time.perf_counter() - t0) * 1e3)
        return torch.stack(logits, 1), prefill_ms, ticks

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = list(range(SERVE12_ROWS))
    logits, prefill_ms, ticks = run(rows)
    peak = torch.cuda.max_memory_allocated() / 1e9
    toks = logits.argmax(-1)                 # (rows, SERVE12_GEN + 1)
    near_ties, worst = 0, 0.0
    for r in rows:
        lone, _, _ = run([r], toks[r:r + 1])
        worst = max(worst, float((lone[0] - logits[r]).abs().max()))
        for i in torch.nonzero(lone[0].argmax(-1) != toks[r]).flatten():
            gap = top2_gap(lone[0, int(i)])
            assert gap < SERVE_LOGIT_TOL, (arch, r, int(i), gap)
            near_ties += 1
    tick = {"median": statistics.median(ticks), "min": min(ticks),
            "max": max(ticks), "n": len(ticks)}
    print(f"  {arch} Server, {SERVE12_ROWS} rows, prompt {prompt_len}: "
          f"prefill {prefill_ms:.1f} ms, decode tick median "
          f"{tick['median']:.3f} ms [{tick['min']:.3f}-{tick['max']:.3f}] "
          f"over {tick['n']}, peak {peak:.2f} GB; every row alone at batch "
          f"1: logits within {worst:.2e}, {near_ties} token(s) differ, "
          f"each at a top-2 gap < {SERVE_LOGIT_TOL}", flush=True)
    assert worst <= SERVE_LOGIT_TOL, worst
    return {"prefill_ms": prefill_ms, "decode_tick_ms": tick,
            "peak_memory_gb": peak, "max_logit_gap": worst,
            "near_tie_tokens": near_ties, "tokens": toks.tolist()}


def run_12c(dev):
    """12c: qwen2-vl-2b FULL width at SERVE_LAYERS through the Scheduler
    as 11c and through ``Server.prefill_fn`` with a seeded vision prefix;
    then whisper-large-v3 FULL width at SERVE_LAYERS through ``Server``
    with seeded frames; each from the port's own seeded init, f32 cache,
    the batched tokens held to each row's lone run."""
    from repro_torch.configs.base import get
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.config import cut_layers

    out = {}
    for arch in VLM_ENCDEC_ARCHS:
        cfg = cut_layers(get(arch).config, SERVE_LAYERS[arch])
        t0 = time.time()
        params = L.init_params(T.model_template(cfg), 0, device=dev)
        torch.cuda.synchronize()
        init_s = time.time() - t0
        elements = sum(x.numel() for x in flatten_params(params))
        print(f"phase 12c: {arch} FULL width, {cfg.n_layers} layers"
              f"{f' + {cfg.enc_layers} encoder layers' if cfg.enc_layers else ''}"
              f", {elements:,} parameters ({elements * 4 / 1e9:.2f} GB in "
              f"f32), init {init_s:.1f} s", flush=True)
        res = {"params": elements, "init_s": init_s}
        g = torch.Generator(device=dev).manual_seed(12)
        if cfg.vision_tokens:
            print(f"  Scheduler: {SERVE11_SLOTS} slots, {SERVE11_REQUESTS} "
                  f"requests of {'/'.join(map(str, SERVE11_PROMPTS))} + "
                  f"{SERVE11_GEN} tokens", flush=True)
            res["scheduler"] = serve11_run(dev, arch, params)
            n = cfg.vision_tokens + SERVE12_TEXT
            batch = {"tokens": torch.randint(
                         0, cfg.vocab, (SERVE12_ROWS, n), device=dev,
                         generator=g),
                     "vision_embeds": 0.02 * torch.randn(
                         SERVE12_ROWS, cfg.vision_tokens, cfg.d_model,
                         device=dev, generator=g)}
        else:
            n = SERVE12_PROMPT
            batch = {"tokens": torch.randint(
                         0, cfg.vocab, (SERVE12_ROWS, n), device=dev,
                         generator=g),
                     "frames": 0.02 * torch.randn(
                         SERVE12_ROWS, cfg.enc_frames, cfg.d_model,
                         device=dev, generator=g)}
        res["server"] = serve12_rows(dev, arch, params, batch, n)
        out[arch] = res
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_phase12(dev):
    out = run_vlm_encdec_training(dev)
    out["12c"] = run_12c(dev)
    return out


def run_vlm_encdec_only(dev):
    """``--only vlm_encdec``: 3h (its own tally, printed), phase 5's vlm
    and encoder-decoder checks, then phase 12."""
    tally = Tally()
    out = {"3h": check_vlm_encdec_kernels(dev, tally)}
    out["3h"]["rows"] = {label: tally_rows(tally, names)
                         for label, names in VLM_ENCDEC_NAMES.items()}
    for label, rows in out["3h"]["rows"].items():
        print(f"  3h {label} " + json.dumps(rows), flush=True)
    out["5"] = {k: run() for k, run in vlm_encdec_parts(dev).items()}
    out.update(run_phase12(dev))
    return out


# --------------------------------------------------------------------- #
# phase 13: MoE and MLA serving (the latent cache and absorbed decode,
# the dense-prefix cache, per-slot routing, expert-parallel processes)
# --------------------------------------------------------------------- #

# (label, arch, layers kept) of 13a and 13b: full width, the port's
# seeded init in f32, served through the Scheduler. deepseek-v2 keeps its
# dense first layer (``cut_layers``): 1 dense + 1 MoE layer of 160
# experts; llama4-scout 2 layers of 16 experts (3 and 4 layers until
# phase 14 joined the script's time limit)
MOE_SERVE_RUNS = (("13a", "deepseek-v2-236b", 2),
                  ("13b", "llama4-scout-17b-a16e", 2))
MOE_SERVE_SLOTS, MOE_SERVE_PROMPT, MOE_SERVE_GEN = 8, 1024, 64
# 13c (2 gloo ranks on one card) and 13d (4 NCCL ranks, four cards only):
# deepseek-v2 as 13a, each rank its share of the 8 rows and its block of
# the experts, prefill + MOE_EP_GEN greedy decodes, against a one-card
# engine run of its rows at its batch
MOE_EP_RUNS = (("13c", 2), ("13d", 4))
MOE_EP_GEN = 32
# phase 5: each MoE smoke served card against CPU, paged qint8 KV, one
# sign1bit publish swapped in before this tick
MOE_SERVE_SWAP_TICK = 2
# its buckets: the smoke models' expert stacks (0.6-0.8 MB each) take
# buckets of their own
MOE_SERVE_BUCKET_MB = 0.25


def moe_serve_argv(arch, layers, slots, gen, device="cuda"):
    """The serve CLI's flags of phase 13 (the prompts ``--requests`` of
    ``--prompt-len`` tokens from ``--seed`` 0, every run the same)."""
    return ["--arch", arch, "--layers", str(layers), "--slots", str(slots),
            "--requests", str(MOE_SERVE_SLOTS), "--prompt-len",
            str(MOE_SERVE_PROMPT), "--gen", str(gen), "--max-seq",
            str(MOE_SERVE_PROMPT + MOE_SERVE_GEN), "--device", device]


def cache_report(cfg, cache):
    """The cache's bytes, and for MLA those of a cache of the per-head
    keys and values the prefill expands (H (dn + dr) + H dv values a
    token and layer) at the same depth, slots and extent."""
    from repro_torch.serve.scheduler import cache_leaves

    got = sum(x.nbytes for x in cache_leaves(cache))
    out = {"cache_bytes": got}
    if cfg.attn_type == "mla":
        per = cfg.n_heads * (cfg.mla_qk_nope + cfg.mla_qk_rope
                             + cfg.mla_v_dim)
        latent = cfg.kv_lora_rank + cfg.mla_qk_rope
        out["per_head_kv_bytes"] = got * per // latent
        out["ratio"] = per / latent
    return out


@torch.no_grad()
def serve13_run(dev, card, label, arch, layers):
    """13a / 13b: ``arch`` FULL width at ``layers`` layers, from the
    port's seeded init: the Scheduler over MOE_SERVE_SLOTS slots (each
    slot's token routed alone), every row then alone at batch 1 (tokens
    equal, teacher-forced; the largest logit gap and the smallest top-2
    gap stated); ``Server.decode_fn`` at batch 8 over the same prompts
    (the batch-wide capacity) with its dropped fraction against the
    Scheduler's; for deepseek-v2 also the one-card engine runs of each
    13c / 13d rank's rows at its batch, returned for the ranks."""
    from repro_torch.launch import serve as launch
    from repro_torch.serve import Request, Scheduler, Server

    args = launch.parse_args(moe_serve_argv(arch, layers, MOE_SERVE_SLOTS,
                                            MOE_SERVE_GEN))
    cfg = launch.config_of(args)
    t0 = time.time()
    srv = Server(cfg, batch=MOE_SERVE_SLOTS, max_seq=args.max_seq,
                 cache_dtype=torch.float32, device=dev)
    params = srv.init_params(args.seed)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    elements = sum(x.numel() for x in flatten_params(params))
    print(f"phase {label}: {arch} FULL width, {layers} layers "
          f"({cfg.first_k_dense} dense), {cfg.n_experts} experts top "
          f"{cfg.top_k}, {cfg.attn_type}; {elements:,} parameters "
          f"({elements * 4 / 1e9:.2f} GB in f32), init {init_s:.1f} s; "
          f"{MOE_SERVE_SLOTS} slots, {MOE_SERVE_SLOTS} requests of "
          f"{MOE_SERVE_PROMPT} + {MOE_SERVE_GEN} tokens, f32 cache; {card}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    sch = Scheduler(srv, params)
    sch.moe_stats = []
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MOE_SERVE_GEN)
            for i, p in enumerate(launch.prompts_of(args, cfg))]
    for r in reqs:
        sch.submit(r)
    run = launch.ServeRun(args=args, cfg=cfg, device=dev, params=params,
                          server=srv, scheduler=sch, requests=reqs)
    logs = record_logits(run, {r.rid for r in reqs})
    res = serve_drive(run)
    assert all(r.done and len(r.output) == MOE_SERVE_GEN for r in reqs)
    res.pop("ticks")
    res["prefill_ms"] = res["admit_tick_ms"]
    per_slot = [float(m["dropped_frac"]) for m in sch.moe_stats]
    res.update(init_s=init_s, params=elements,
               **cache_report(cfg, sch.cache),
               scheduler_dropped_frac=max(per_slot))
    print(f"  {label} Scheduler: decode tick median "
          f"{res['decode_tick_ms']['median']:.3f} ms, admission tick "
          f"{res['admit_tick_ms'][0]:.1f} ms (8 prefills of "
          f"{MOE_SERVE_PROMPT}), peak {res['peak_memory_gb']:.2f} GB, cache "
          f"{res['cache_bytes']:,} B"
          + (f" against {res['per_head_kv_bytes']:,} B of per-head K/V "
             f"(1/{res['ratio']:.1f})" if "ratio" in res else "")
          + f"; per-slot dropped_frac at most {max(per_slot)}; {card}",
          flush=True)
    res["lone"] = check_lone(run, logs, MOE_SERVE_SLOTS, exact=True)
    del sch, run, logs
    gc.collect()
    torch.cuda.empty_cache()
    rows = launch.prompts_of(args, cfg)
    whole = launch.serve_rows(Server(cfg, batch=MOE_SERVE_SLOTS,
                                     max_seq=args.max_seq,
                                     cache_dtype=torch.float32, device=dev),
                              params, rows, MOE_EP_GEN)
    res["batch_wide"] = {
        "dropped_frac": whole["dropped_frac"],
        "decode_tick_ms": statistics.median(whole["tick_ms"]),
        "prefill_ms": whole["prefill_ms"]}
    print(f"  {label} Server.decode_fn at batch {MOE_SERVE_SLOTS} (the "
          f"batch-wide capacity): dropped_frac a tick "
          f"{[round(x, 4) for x in whole['dropped_frac']]} (mean "
          f"{statistics.mean(whole['dropped_frac']):.4f}) against the "
          f"Scheduler's at most {max(per_slot)}; prefill of "
          f"{MOE_SERVE_SLOTS} x {MOE_SERVE_PROMPT} "
          f"{whole['prefill_ms']:.1f} ms, decode tick median "
          f"{res['batch_wide']['decode_tick_ms']:.3f} ms; {card}",
          flush=True)
    del whole
    # a slot's token routes alone: its top-k experts are distinct, each
    # with a capacity of at least one
    assert max(per_slot) == 0.0, per_slot
    engine = {}
    if cfg.attn_type == "mla":
        for ep_label, n in MOE_EP_RUNS:
            if n > 2 and torch.cuda.device_count() < n:
                continue
            per = MOE_SERVE_SLOTS // n
            srv_n = Server(cfg, batch=per, max_seq=MOE_SERVE_PROMPT
                           + MOE_EP_GEN, cache_dtype=torch.float32,
                           device=dev)
            engine[ep_label] = []
            for r in range(n):
                out = launch.serve_rows(srv_n, params,
                                        rows[r * per:(r + 1) * per],
                                        MOE_EP_GEN)
                engine[ep_label].append({k: out[k] for k in (
                    "logits", "tokens", "prefill_ms", "tick_ms",
                    "dropped_frac")})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res, engine


def run_13_ep(card, label, n, engine):
    """13c / 13d: deepseek-v2 as 13a in ``n`` spawned ranks
    (``launch.train.rank_jobs`` with a serve job: 13c gloo on this one
    card, 13d NCCL a rank a card), EP ``n``: each rank's block of the
    experts from the same seeded init, its 8 / n rows, prefill +
    MOE_EP_GEN greedy decodes through ``Server(comm=)``, its dispatch
    buffers exchanged with the others; its tokens equal and its logits
    within SERVE_LOGIT_TOL of the one-card engine run of its rows
    (``engine``), its exchange ms a tick (CUDA events), peak memory."""
    from repro_torch.configs.base import get
    from repro_torch.launch import mesh
    from repro_torch.launch import train as launch

    arch, layers = MOE_SERVE_RUNS[0][1:]
    experts = get(arch).config.n_experts
    if label not in engine:
        why = (f"needs {n} cards, one rank each; this machine has "
               f"{torch.cuda.device_count()}")
        print(f"phase {label}: {arch} EP {n} in processes not run: {why}",
              flush=True)
        return {"ran": False, "why": why}
    per = MOE_SERVE_SLOTS // n
    device = "cuda:0" if n == 2 else "cuda"
    transport = ("gloo on one card" if n == 2
                 else f"NCCL, {n} cards")
    print(f"phase {label}: {arch} FULL width, {layers} layers, {n} ranks "
          f"over {transport}, EP {n} ({experts // n} experts a rank), {per} "
          f"rows of {MOE_SERVE_PROMPT} + {MOE_EP_GEN} tokens a rank; "
          f"{card}", flush=True)
    argv = moe_serve_argv(arch, layers, per, MOE_EP_GEN, device)
    t0 = time.time()
    with scratch_dir() as tmp:
        mesh.spawn(launch.rank_jobs, n, ([(argv, tmp, False, "serve",
                                          False, None)], n),
                   timeout_s=DIST_TIMEOUT_S)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(n)]
    wall = time.time() - t0
    rows = []
    for r, res in enumerate(ranks):
        want = engine[label][r]
        gap = float((res["logits"] - want["logits"]).abs().max())
        same = torch.equal(res["tokens"], want["tokens"])
        row = {"rank": r, "device": res["device"],
               "ep_degree": res["ep_degree"], "max_logit_gap": gap,
               "tokens_equal": same, "prefill_ms": res["prefill_ms"],
               "prefill_ep_ms": res["prefill_ep_ms"],
               "decode_tick_ms": statistics.median(res["tick_ms"]),
               "ep_ms_median": statistics.median(res["ep_ms"]),
               "ep_ms": res["ep_ms"],
               "engine_decode_tick_ms": statistics.median(want["tick_ms"]),
               "dropped_frac": res["dropped_frac"],
               "peak_memory_gb": res["peak_memory_bytes"] / 1e9}
        print(f"  {label} rank {r} on {res['device']}: EP "
              f"{res['ep_degree']}, logits within {gap:.2e} of the "
              f"one-card rows, tokens equal {same}; prefill "
              f"{res['prefill_ms']:.1f} ms (exchange "
              f"{res['prefill_ep_ms']:.1f}), decode tick median "
              f"{row['decode_tick_ms']:.3f} ms (one card at batch {per}: "
              f"{row['engine_decode_tick_ms']:.3f}), EP all_to_all "
              f"{row['ep_ms_median']:.3f} ms a tick; peak "
              f"{row['peak_memory_gb']:.2f} GB; {card}", flush=True)
        assert res["ep_degree"] == n, res["ep_degree"]
        assert same and gap <= SERVE_LOGIT_TOL, row
        rows.append(row)
    return {"ran": True, "transport": transport, "wall_s": wall,
            "ranks": rows}


def run_phase13(dev, card):
    """Phase 13: 13a, 13b, then 13c (13d on four cards only)."""
    out, engine = {}, {}
    for label, arch, layers in MOE_SERVE_RUNS:
        out[label], got = serve13_run(dev, card, label, arch, layers)
        engine.update(got)
    for label, n in MOE_EP_RUNS:
        out[label] = run_13_ep(card, label, n, engine)
    return out


def serve_small_swap(d, cfg, params, moved, mix, kv_quant):
    """One Scheduler run of phase 5's MoE serving on device ``d``: 3
    slots, ``mix``'s requests, ``kv_quant`` at pages of 8, a sign1bit
    delta to ``moved`` published before tick MOE_SERVE_SWAP_TICK. On the
    card each page is quantized as the CPU's ``quant_page`` would
    quantize the same lane (checked bit for bit, page by page). Returns
    the tokens, the stats, the delta, its launches (publish, apply), the
    bucket count and the pages checked."""
    from repro_torch.kernels import build
    from repro_torch.serve import (Publisher, PublishConfig, Request,
                                   Scheduler, Server, Subscriber)
    from repro_torch.serve import scheduler as S

    p, m = _to(params, d), _to(moved, d)
    pc = PublishConfig(codec="sign1bit", bucket_mb=MOE_SERVE_BUCKET_MB)
    pub, sub = Publisher(p, pc), Subscriber(p, pc)
    sub.push(pub.publish(p, step=0))
    sch = Scheduler(Server(cfg, batch=3, max_seq=64,
                           cache_dtype=torch.float32, device=d), p,
                    subscriber=sub, kv_quant=kv_quant, kv_page=8)
    reqs = [Request(rid=i, prompt=q, max_new_tokens=n)
            for i, (q, n) in enumerate(mix)]
    for r in reqs:
        sch.submit(r)
    plain, pages = S.quant_page, []

    def checked(cache, slot, start, page, max_seq):
        cpu = {k: c[:, slot:slot + 1].cpu() for k, c in cache.items()}
        plain(cpu, 0, start, page, max_seq)
        plain(cache, slot, start, page, max_seq)
        pages.append(all(torch.equal(c[:, slot:slot + 1].cpu(), cpu[k])
                         for k, c in cache.items()))

    if d.type == "cuda":
        S.quant_page = checked
    try:
        ticks, launches = 0, {}
        while not sch.idle:
            if ticks == MOE_SERVE_SWAP_TICK:
                build.launch_counts.clear()
                update = pub.publish(m, step=1)
                launches["publish"] = dict(build.launch_counts)
                sub.push(update)
                build.launch_counts.clear()
            sch.tick()
            if ticks == MOE_SERVE_SWAP_TICK:
                launches["apply"] = dict(build.launch_counts)
            ticks += 1
    finally:
        S.quant_page = plain
    return ([r.output for r in reqs], dict(sch.stats), update, launches,
            len(pub.wire.bp.buckets), pages)


@torch.no_grad()
def check_small_moe_serve(dev, arch):
    """Phase 5: ``arch``'s smoke config served through the Scheduler on
    the card and on the CPU from the same params: 3 slots, 5 requests, a
    sign1bit delta of the params plus seeded noise published before tick
    MOE_SERVE_SWAP_TICK and swapped in at its boundary, with the paged
    qint8 KV cache (pages of 8; MLA: ``ckv`` and ``kr``) and without.
    The publish runs kernels 2-4 on the frames of the MoE leaves' buckets
    (one launch of each a bucket; the apply one decompress a bucket), its
    packed bytes bit for bit the CPU's, its scales within ROWSUM_ULPS;
    the stats equal; every page the card quantizes bit for bit the CPU's
    ``quant_page`` of the same lane. Without qint8 the tokens equal the
    CPU's; with it they are counted, not held: its dither hashes each
    value's last bits, which the card's and the CPU's products do not
    share (as the qint codecs of phase 5)."""
    from repro_torch.configs.base import get
    from repro_torch.core.leafwise import flatten_tree, unflatten_tree
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params

    cfg = get(arch).smoke
    cpu = torch.device("cpu")
    params = init_params(T.model_template(cfg), 0, device=cpu)
    g = torch.Generator().manual_seed(5)
    paths, xs = flatten_tree(params)
    moved = unflatten_tree(paths, [x + 1e-3 * torch.randn(
        x.shape, generator=g) for x in xs])
    rng = np.random.default_rng(13)
    mix = [(rng.integers(0, cfg.vocab, (5, 9)[i % 2]).tolist(), 6 + i)
           for i in range(5)]
    out = {}
    for kv in ("qint8", None):
        (tok_a, st_a, up_a, la, nb, pages), (tok_b, st_b, up_b, _, _, _) = (
            serve_small_swap(d, cfg, params, moved, mix, kv)
            for d in (dev, cpu))
        worst = 0
        for k in range(nb):
            pa, pb = up_a.payloads[k], up_b.payloads[k]
            assert np.array_equal(pa["packed"], pb["packed"]), k
            worst = max(worst, ulps(torch.from_numpy(pa["scales"]),
                                    torch.from_numpy(pb["scales"])))
        equal = sum(a == b for a, b in zip(tok_a, tok_b))
        print(f"  {cfg.name} served card against CPU, KV {kv or 'f32'}, a "
              f"sign1bit swap before tick {MOE_SERVE_SWAP_TICK} ({nb} "
              f"buckets): stats equal {st_a == st_b}; {equal} of "
              f"{len(mix)} requests' tokens equal; {len(pages)} pages "
              f"quantized on the card, bit for bit the CPU's: "
              f"{all(pages)}; packed bytes bit for bit, scales within "
              f"{worst} ulp; launches publish {json.dumps(la['publish'])} "
              f"+ apply {json.dumps(la['apply'])}", flush=True)
        assert st_a == st_b and worst <= ROWSUM_ULPS, (st_a, st_b, worst)
        assert st_a["weight_swaps"] == 2, st_a
        assert all(pages) and len(pages) == st_a["pages_quantized"], pages
        assert bool(pages) == (kv is not None), pages
        assert kv is not None or tok_a == tok_b, (tok_a, tok_b)
        assert la["publish"] == {k: nb for k in (
            "abs_rowsum", "ef_quantize", "decompress")}, la
        assert la["apply"] == {"decompress": nb}, la
        out[kv or "f32"] = {
            "requests_equal": equal, "scale_ulps": worst, "n_buckets": nb,
            "pages_bitwise": len(pages), "publish_launches": la["publish"],
            "apply_launches": la["apply"], "stats": st_a}
    # the kernels line counts both runs' publishes
    out["publish_launches"] = {k: sum(r["publish_launches"].get(k, 0)
                                      for r in (out["qint8"], out["f32"]))
                               for k in out["f32"]["publish_launches"]}
    out["apply_launches"] = {k: sum(r["apply_launches"].get(k, 0)
                                    for r in (out["qint8"], out["f32"]))
                             for k in out["f32"]["apply_launches"]}
    return out


def moe_serve_parts(dev):
    """Phase 5's MoE serving checks by name (``check_small_moe_serve``)."""
    return {f"moe_serve_{a.split('-')[0]}":
            (lambda a=a: check_small_moe_serve(dev, a))
            for a in MOE_SMOKES}


def run_moe_serve_only(dev, card):
    """``--only moe_serve``: phase 5's MoE serving checks, then phase
    13."""
    out = {"5": {k: run() for k, run in moe_serve_parts(dev).items()}}
    out.update(run_phase13(dev, card))
    return out


# --------------------------------------------------------------------- #
# Phase 3i and phase 14: production precision (bf16 parameters, compute
# and optimizer state)
# --------------------------------------------------------------------- #

def lowp_inplace_step(g, m, u, v, lr, b1, u_out=None):
    """Kernel 1 at production precision, in place as the optimizer calls
    it, on copies of ``m`` and ``u`` (``v`` None: the SGD kernel): a bf16
    gradient and a 16-bit state, u' rounded into ``u`` or, for a sync
    step, into the f32 ``u_out``; the delta into a new f32 tensor.
    Returns (m', u', delta) and a closure repeating the call on the same
    copies."""
    from repro_torch.kernels import fused_adam as FA

    mk, uk = m.clone(), u.clone()
    uo = None if u_out is None else u_out.clone()
    if v is None:
        def call():
            return FA.fused_local_step_sgd_(g, mk, uk, lr, b1, u_out=uo)
    else:
        def call():
            return FA.fused_local_step_(g, mk, uk, v, lr, b1, u_out=uo)
    dk = call()
    return (mk, uk if uo is None else uo, dk), call


def lowp_plain_step(g, m, u, v, lr, b1, u_out=None):
    """The plain version of :func:`lowp_inplace_step` on copies."""
    from repro_torch.kernels import fused_adam as FA

    mp, up = m.clone(), u.clone()
    uo = None if u_out is None else u_out.clone()
    if v is None:
        d = FA.fused_local_step_sgd_plain_(g, mp, up, lr, b1, u_out=uo)
    else:
        d = FA.fused_local_step_plain_(g, mp, up, v, lr, b1, u_out=uo)
    return mp, up if uo is None else uo, d


def check_lowp_local_step(lo, rnd, tally, name, v_needed, lr, b1,
                          state=torch.bfloat16):
    """Kernel 1 (``v_needed``) or the SGD kernel on one frame at a bf16
    gradient and ``state`` (bf16 or fp16) m, u and v against its plain
    version, by row slabs: m' and u' (the state's dtype, and the f32 u'
    of a sync step) bit for bit, the delta within DELTA_ULPS (the SGD
    delta bit for bit). Tallies the local step's form (u' in the state's
    dtype) under ``name``."""
    bf = torch.bfloat16
    g, m, u = rnd().to(bf), rnd().to(state), rnd(1e-3).to(state)
    v = rnd(1e-2).square().to(state) if v_needed else None
    R, cols = g.shape
    tol = DELTA_ULPS if v_needed else 0
    slabs, err = row_slabs(R, cols), 0.0
    for u_out in (None, torch.zeros(R, cols, device=g.device)):
        fk, call = lowp_inplace_step(g, m, u, v, lr, b1, u_out)
        for sl in slabs:
            fp = lowp_plain_step(g[sl], m[sl], u[sl],
                                 None if v is None else v[sl], lr, b1,
                                 None if u_out is None else u_out[sl])
            torch.cuda.synchronize()
            assert torch.equal(fk[0][sl], fp[0]), (lo.shape, state, "m'")
            assert torch.equal(fk[1][sl], fp[1]), (lo.shape, state, "u'",
                                                   u_out is None)
            assert ulps(fk[2][sl], fp[2]) <= tol, (lo.shape, state,
                                                   "delta")
            err = max([err] + [float((a[sl].float() - b.float()).abs().max())
                               for a, b in zip(fk, fp)])
            del fp
        if u_out is not None:
            break

        def plain():
            for sl in slabs:
                lowp_plain_step(g[sl], m[sl], u[sl],
                                None if v is None else v[sl], lr, b1)

        ne = R * cols
        # reads g, m, u (, v) at 2 B; writes m, u at 2 B and d at 4 B
        tally.add(name, call, plain, (16.0 if v_needed else 14.0) * ne,
                  (7.0 if v_needed else 6.0) * ne, err)
        del fk, call


def check_precision_kernels(dev, tally, states=None):
    """Phase 3i: the kernels that read or write optimizer state, at bf16
    and then at fp16 state: kernel 1 (fused_local_step; a bf16 gradient)
    and the two-pass compress (abs_rowsum, ef_quantize; err in and
    err_out in the state's dtype) at every gpt2-FULL frame of 4 stacked
    workers, worker and server side; the SGD kernel and the single-pass
    ef_compress at the BERT-Base FULL frames. Each against its plain
    version: 16-bit outputs (m', u', err_out) and packed bytes bit for
    bit, the f32 u' of a sync step bit for bit, the delta within
    DELTA_ULPS, sums within ROWSUM_ULPS; tallied under PRECISION and
    PRECISION_FP16 (call and batched times against the byte bound at
    16-bit state). ``states``: (dtype, names) pairs, both by default.
    decompress reads no state: its output is f32."""
    for state, names in states or ((torch.bfloat16, PRECISION),
                                   (torch.float16, PRECISION_FP16)):
        check_state_kernels(dev, tally, state, names)


def check_state_kernels(dev, tally, state, names):
    """:func:`check_precision_kernels` at one state dtype."""
    from repro_torch.core import compressor as C
    from repro_torch.kernels import onebit as OB

    gen = torch.Generator(device=dev).manual_seed(14)
    lr, b1 = np.float32(1.5e-4), 0.9
    for arch in ("gpt2", "bert-base"):
        for lo in full_plan(arch).layouts:
            rows, cols = C.view_rows_cols(lo)
            R = N_WORKERS * rows
            cnt = torch.as_tensor(np.tile(C.view_row_counts(lo), N_WORKERS),
                                  device=dev)
            mask = torch.arange(cols, device=dev)[None, :] < cnt[:, None]

            def rnd(scale=1.0):
                return (torch.randn(R, cols, device=dev, generator=gen)
                        * scale * mask)

            if arch == "gpt2":
                check_lowp_local_step(lo, rnd, tally,
                                      names["fused_local_step"], True,
                                      lr, b1, state)
                check_compress_frames(
                    dev, gen, tally, names, lo, cols,
                    [f[:3] + (False,) for f in flat_frames(lo)],
                    err_dtype=state)
            else:
                check_lowp_local_step(lo, rnd, tally,
                                      names["fused_local_step_sgd"],
                                      False, lr, b1, state)
                if len(lo.view_shape) == 3:
                    z, e = rnd(), rnd(0.3).to(state)
                    err = check_ef_compress_frame(z, e, cnt)
                    n = R * cols
                    tally.add(names["ef_compress"],
                              lambda: OB.ef_compress(z, e, cnt),
                              lambda: OB.ef_compress_plain(z, e, cnt),
                              8.125 * n + 8.0 * R, 3.0 * n, err)
                    del z, e
            torch.cuda.empty_cache()
            print(f"  {arch} leaf {lo.shape}: frame ({R}, {cols}) at "
                  f"{str(state).removeprefix('torch.')} state ok",
                  flush=True)


def production(store_anchor=True, state_dtype=torch.bfloat16):
    """The reference's production precision (``launch.train.production``:
    bf16 params, compute and state), with or without the anchor, the
    state in ``state_dtype`` (fp16: the paper's), as a ``configure`` of
    ``launch.make_trainer``."""
    from repro_torch.launch import train as launch

    return functools.partial(launch.production, store_anchor=store_anchor,
                             state_dtype=state_dtype)


def state_report(params, state):
    """Bytes of the optimizer state a stacked parameter element, and the
    stacked elements (every tensor of the state, scalar slots included);
    where the base keeps a variance, the lowest, highest and overall
    share of its elements at exactly zero over the leaves."""
    from repro_torch.core.leafwise import flatten_tree

    elems = sum(x.numel() for x in flatten_tree(params)[1])
    tensors = [t for xs in (*state.slots.values(), state.u, state.err_w,
                            state.err_s, state.anchor)
               for t in xs if t is not None]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    out = {"stacked_elements": elems, "state_bytes": nbytes,
           "state_bytes_per_element": nbytes / elems,
           "param_bytes_per_element": sum(
               x.element_size() for x in flatten_tree(params)[1][:1])}
    vs = [v for v in state.slots.get("v", ()) if v is not None]
    if vs:
        zeros = [int((v == 0).sum()) for v in vs]
        shares = [z / v.numel() for z, v in zip(zeros, vs)]
        out["v_zero_share"] = {
            "min_leaf": min(shares), "max_leaf": max(shares),
            "all": sum(zeros) / sum(v.numel() for v in vs)}
    return out


def run_14c(dev):
    """14c: phi4-mini-3.8b at full width (4.45e9 parameters: d 3072, 32
    layers, vocab 200064, untied head), ``--mode single`` at batch
    PHI4_BATCH x SEQ, production precision without the anchor, 4a's
    8-step schedule; full depth if it fits the card, else the deepest of
    PHI4_DEPTHS that does (each failed depth printed)."""
    tried = []
    for layers in PHI4_DEPTHS:
        # what a failed depth held is garbage once its exception is gone
        gc.collect()
        torch.cuda.empty_cache()
        try:
            r = run_main_path(dev, "14c", "phi4-mini-3.8b", [], PHI4_BATCH,
                              SEQ, "lm", workers=1, n_layers=layers,
                              configure=production(False))
        except torch.cuda.OutOfMemoryError as e:
            tried.append(layers)
            print(f"  14c at {layers} layers does not fit the card: "
                  f"{str(e).splitlines()[0]}", flush=True)
            continue
        r["layers"], r["depths_that_did_not_fit"] = layers, tried
        return r
    raise AssertionError(f"14c: phi4-mini-3.8b fits at none of "
                         f"{PHI4_DEPTHS} layers")


def unequal_share(xs, ys):
    """The share of elements of the tensors ``xs`` unequal to ``ys``'s."""
    n = sum(x.numel() for x in xs)
    return sum(int((x != y).sum()) for x, y in zip(xs, ys)) / max(n, 1)


def nudged(xs):
    """Each tensor one ulp up (its dtype's)."""
    out = []
    for x in xs:
        if x.dtype == torch.bfloat16:
            out.append((x.view(torch.int16) + 1).view(torch.bfloat16))
        else:
            out.append(torch.nextafter(x, torch.full_like(x, np.inf)))
    return out


def check_small_precision(dev):
    """Phase 14d: gpt2-smoke at production precision (bf16 params,
    compute and state), card against CPU. (1) One optimizer step from the
    same bf16 params, gradients (the parameter dtype, as the trainer
    gives them) and state on both devices: at step 0 from ``opt.init``
    (a sync and a variance round), and at steps 5 (local) and 6 (sync)
    after CPU steps, whose state carries five syncs' error feedback,
    ``u`` and the anchor; with and without the anchor. The local step
    (kernel 1) bit for bit; a sync step's params and state at most
    SYNC_UNEQUAL unequal (its scales are f32 sums in the kernel's order,
    within ROWSUM_ULPS of torch's); (1) again at fp16 state with the
    anchor. (2) The 8-step trainer from the same start on both
    devices: bf16 products on the card (cuBLAS) and on the CPU round in
    other orders, so the bar is phase 5's qint one: the loss gap and the
    largest param gap each at most three times the card's own spread
    from params one bf16 ulp up."""
    from repro_torch.configs.base import get
    from repro_torch.core import api
    from repro_torch.core.comm import SimComm
    from repro_torch.core.leafwise import flatten_tree, unflatten_tree
    from repro_torch.launch import train as launch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    args = smoke_args("gpt2", [])
    cfg = get("gpt2").smoke
    tmpl = T.model_template(cfg)
    shapes = L.param_shapes(tmpl)
    paths, leaves = flatten_tree(shapes)
    cpu, bf = torch.device("cpu"), torch.bfloat16
    out = {}
    for label, prec in (("anchor", production()),
                        ("no_anchor", production(False)),
                        ("fp16_state", production(
                            state_dtype=torch.float16))):
        rng = np.random.default_rng(7)

        def draw(sc):
            return [torch.from_numpy((rng.standard_normal(
                (N_WORKERS,) + tuple(sh)) * sc).astype(np.float32)).to(bf)
                for sh in leaves]

        def to(xs, d):   # copies: the optimizer steps params in place
            return unflatten_tree(paths, [x.to(d, copy=True) for x in xs])

        _, opt_cfg = prec(cfg, launch.build_opt_cfg(args))
        params, grads = draw(0.02), [draw(1.0) for _ in range(7)]
        opts = {d: api.build_optimizer(opt_cfg, shapes,
                                       specs=L.param_specs(tmpl),
                                       dp_mask=L.dp_mask(tmpl),
                                       n_workers=N_WORKERS)
                for d in (dev, cpu)}
        state = opts[cpu].init(to(params, cpu))
        unequal = {}
        for t in range(7):
            if t in (0, 5, 6):
                res = []
                for d in (dev, cpu):
                    p, st, met = opts[d].step(SimComm(N_WORKERS),
                                              to(params, d), to(grads[t], d),
                                              state_to(state, d))
                    res.append([x.cpu() for x in flatten_tree(p)[1]] + [
                        x.cpu() for name in ("u", "err_w", "err_s", "anchor")
                        for x in getattr(st, name) if x is not None] + [
                        x.cpu() for name in ("m", "v") for x in st.slots[name]])
                # the state in its dtype, the anchor in the params'
                assert {x.dtype for x in res[1][len(leaves):]} == {
                    bf, opt_cfg.state_dtype}, t
                share = unequal_share(*res)
                unequal[t] = share
                print(f"  production precision ({label}): optimizer step "
                      f"{t} ({'local' if t == 5 else 'sync'}) card vs cpu: "
                      f"{share:.2e} of params and state elements unequal",
                      flush=True)
                # a local step is kernel 1 alone: bit for bit; a sync's
                # scales are f32 sums in the kernel's order on the card
                assert share <= (0.0 if t == 5 else SYNC_UNEQUAL), (label, t)
            p, state, _ = opts[cpu].step(SimComm(N_WORKERS), to(params, cpu),
                                         to(grads[t], cpu), state)
            params = flatten_tree(p)[1]
        out[label] = {"step_unequal_share": unequal}

    (lk, pk), (ln, pn), (lc, pc) = (
        smoke_run(args, dev, "lm", configure=production()),
        smoke_run(args, dev, "lm", nudge=True, configure=production()),
        smoke_run(args, cpu, "lm", configure=production()))
    gap = max(abs(a - b) for a, b in zip(lk, lc))
    own = max(abs(a - b) for a, b in zip(lk, ln))
    pgap = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(pk, pc))
    pown = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(pk, pn))
    print(f"  gpt2-smoke at production precision: losses card "
          f"{[round(x, 5) for x in lk]}")
    print(f"  max loss gap card-cpu {gap:.2e} against the card's own spread"
          f" from params one bf16 ulp up {own:.2e}; max param gap "
          f"{pgap:.2e} against {pown:.2e}", flush=True)
    assert np.isfinite(lk).all() and 0 < own and gap <= 3 * own, (gap, own)
    assert pgap <= 3 * pown, (pgap, pown)
    out.update({"max_loss_gap": gap, "own_spread": own,
                "max_param_gap": pgap, "own_param_spread": pown})
    return out


def run_14ab(dev, card, ref=None):
    """14a: run 4a (gpt2 FULL, 4 simulated workers, zero_one_adam, tensor
    scales, its data and schedule) with bf16 params, compute and state;
    14b: the same without the anchor (``store_anchor=False``). 14a's
    launch counts must equal 4a's (``ref``, when given), 14b's losses
    stay within PRECISION_LOSS_BAR of 14a's at every step, and its peak
    memory is below 14a's (one bf16 copy of the stacked params less)."""
    out = {}
    for label, prec in (("14a", production()), ("14b", production(False))):
        print(f"phase {label}: gpt2 FULL, {N_WORKERS} simulated workers, "
              f"production precision{' without the anchor' * (label == '14b')}"
              f"; {card}", flush=True)
        out[label] = run_main_path(dev, label, "gpt2", [], BATCH, SEQ, "lm",
                                   configure=prec)
        gc.collect()
        torch.cuda.empty_cache()
    a, b = out["14a"], out["14b"]
    if ref is not None:
        assert a["launches"] == ref["launches"], (a["launches"],
                                                  ref["launches"])
    gaps = [abs(float(np.mean(x["losses"])) - float(np.mean(y["losses"])))
            for x, y in zip(a["steps"], b["steps"])]
    print(f"  14b against 14a: loss gaps {[round(g, 5) for g in gaps]} "
          f"(bar {PRECISION_LOSS_BAR}); peak {b['peak_memory_gb']:.2f} GB "
          f"against {a['peak_memory_gb']:.2f} GB", flush=True)
    assert max(gaps) <= PRECISION_LOSS_BAR, gaps
    assert b["peak_memory_gb"] < a["peak_memory_gb"], (
        b["peak_memory_gb"], a["peak_memory_gb"])
    out["14b_loss_gaps"] = gaps
    return out


def run_14e(dev, card, ref):
    """14e: run 14a (``ref``: its result) with fp16 optimizer state, the
    paper's: its launch counts 14a's, its losses beside 14a's, its state
    bytes a stacked element, its peak and the share of v at exactly zero
    (squared gradients under fp16's smallest subnormal round to 0, in the
    reference as in the port)."""
    print(f"phase 14e: gpt2 FULL, {N_WORKERS} simulated workers, bf16 "
          f"params and compute, fp16 optimizer state; {card}", flush=True)
    r = run_main_path(dev, "14e", "gpt2", [], BATCH, SEQ, "lm",
                      configure=production(state_dtype=torch.float16))
    gc.collect()
    torch.cuda.empty_cache()
    assert r["launches"] == ref["launches"], (r["launches"],
                                              ref["launches"])
    losses = [float(np.mean(x["losses"])) for x in r["steps"]]
    gaps = [abs(a - float(np.mean(b["losses"])))
            for a, b in zip(losses, ref["steps"])]
    z = r["state"]["v_zero_share"]
    print(f"  14e losses {[round(x, 5) for x in losses]}; against 14a "
          f"{[round(g, 5) for g in gaps]}; v at zero {z['all']:.4f} of its "
          f"elements ({z['min_leaf']:.4f}-{z['max_leaf']:.4f} a leaf)",
          flush=True)
    r["losses"], r["loss_gaps_to_14a"] = losses, gaps
    return r


# 14f: gpt2 FULL served at bf16 params, compute and cache: the batched
# logits of a row may round otherwise than the lone row's (other GEMM
# shapes), so a greedy token may differ only where the lone logits'
# top-2 gap is under this many bf16 ulps of their largest magnitude
BF16_LOGIT_ULPS = 4
SERVE_14F = ["--arch", "gpt2", "--slots", "8", "--max-seq", "1024",
             "--requests", "8", "--prompt-len", "512", "--gen", "64"]


def run_14f(dev, card):
    """14f: gpt2 FULL served at the reference's serving precision (bf16
    params and compute, a bf16 cache: ``repro.serve.Server``'s defaults)
    through the Scheduler over 8 slots, with ``launch.serve``'s prompts
    and loop; then each request alone at batch 1 at the same precision,
    teacher-forced with the batched tokens (:func:`check_lone`): every
    greedy token equal except at a top-2 gap under BF16_LOGIT_ULPS bf16
    ulps of the lone logits' largest magnitude (counted). Tick times and
    peak as 7a's."""
    from repro_torch.launch import serve as launch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, Scheduler, Server

    bf = torch.bfloat16
    print(f"phase 14f: {' '.join(SERVE_14F)}, bf16 params, compute and "
          f"cache; {card}", flush=True)
    args = launch.parse_args(SERVE_14F)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(launch.config_of(args), param_dtype=bf,
                              compute_dtype=bf)
    params = L.init_params(T.model_template(cfg), args.seed, device=dev,
                           dtype=bf)
    srv = Server(cfg, batch=args.slots, max_seq=args.max_seq,
                 cache_dtype=bf, device=dev)
    sch = Scheduler(srv, params)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=args.gen)
            for i, p in enumerate(launch.prompts_of(args, cfg))]
    for r in reqs:
        sch.submit(r)
    run = launch.ServeRun(args=args, cfg=cfg, device=dev, params=params,
                          server=srv, scheduler=sch, requests=reqs)
    logs = record_logits(run, {r.rid for r in reqs})
    res = serve_drive(run)
    assert all(r.done and len(r.output) == r.max_new_tokens for r in reqs)
    res["lone"] = check_lone(run, logs, n=len(reqs), cache_dtype=bf,
                             ulps_of_scale=BF16_LOGIT_ULPS)
    del run, sch, srv, params, logs
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_phase14(dev, card, ref=None):
    """Phase 14: production precision: :func:`run_14ab` (against 4a's
    launches ``ref``), :func:`run_14c`, :func:`check_small_precision`
    (14d), :func:`run_14e` (fp16 state), :func:`run_14f` (bf16
    serving); every training run through :func:`run_main_path`
    (audited, launches against ``expected_launches``) with its state
    bytes a stacked element and its peak memory a 1e9 stacked elements,
    printed beside the card."""
    out = run_14ab(dev, card, ref)
    print(f"phase 14c: phi4-mini-3.8b FULL width, single mode, production "
          f"precision without the anchor; {card}", flush=True)
    out["14c"] = run_14c(dev)
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 14d: gpt2-smoke at production precision, card vs CPU",
          flush=True)
    out["14d"] = check_small_precision(dev)
    out["14e"] = run_14e(dev, card, out["14a"])
    out["14f"] = run_14f(dev, card)
    for label in ("14a", "14b", "14c", "14e"):
        r = out[label]
        print(f"  {label}: {card}; peak {r['peak_memory_gb']:.2f} GB = "
              f"{r['peak_gb_per_1e9_elements']:.2f} GB a 1e9 stacked "
              f"elements; state {r['state']['state_bytes_per_element']:.2f} "
              f"B an element", flush=True)
    return out


EXAMPLE_STEPS = 4      # phase 15: REPRO_EXAMPLE_STEPS of each example


def run_examples(dev):
    """Phase 15: the port's three examples through their ``main`` on the
    card at REPRO_EXAMPLE_STEPS=EXAMPLE_STEPS (quickstart at f32 and at
    fp16 state): finite losses, every request served (the example
    asserts it), each example's kernel launches and wall seconds."""
    from repro_torch.examples import (compare_optimizers, quickstart,
                                      serve_decode)
    from repro_torch.kernels import build

    old = os.environ.get("REPRO_EXAMPLE_STEPS")
    os.environ["REPRO_EXAMPLE_STEPS"] = str(EXAMPLE_STEPS)
    runs = {"quickstart": lambda: quickstart.main(str(dev)),
            "quickstart_fp16": lambda: quickstart.main(
                str(dev), state_dtype=torch.float16),
            "compare_optimizers": lambda: compare_optimizers.main(str(dev)),
            "serve_decode": lambda: serve_decode.main(str(dev))}
    out = {}
    try:
        for name, run in runs.items():
            print(f"phase 15 ({name}): python -m repro_torch.examples."
                  f"{name.removesuffix('_fp16')}"
                  f"{' --state-dtype float16' * name.endswith('_fp16')} "
                  f"at REPRO_EXAMPLE_STEPS={EXAMPLE_STEPS}", flush=True)
            build.launch_counts.clear()
            t0 = time.time()
            res = run()
            torch.cuda.synchronize()
            row = {"seconds": time.time() - t0,
                   "launches": dict(build.launch_counts)}
            if name.startswith("quickstart"):
                row["losses"] = res["losses"]
                assert np.isfinite(res["losses"]).all(), res["losses"]
            elif name == "compare_optimizers":
                row["losses"] = {k: v["losses"] for k, v in res.items()}
                assert all(np.isfinite(v["losses"]).all()
                           for v in res.values())
            else:
                row["stats"] = dict(res["stats"])
                row["outputs"] = [r.output for r in res["requests"]]
            print(f"  {name}: {row['seconds']:.1f} s; launches "
                  f"{json.dumps(row['launches'])}", flush=True)
            out[name] = row
            del res
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if old is None:
            os.environ.pop("REPRO_EXAMPLE_STEPS", None)
        else:
            os.environ["REPRO_EXAMPLE_STEPS"] = old
    # the fused local step runs on every 0/1 Adam step of quickstart
    assert out["quickstart"]["launches"].get("fused_local_step"), out
    return out


def run_3i_alone(dev, fp16_only=False):
    """Phase 3i with a tally of its own, printed (``--only precision``;
    ``3i_fp16``: its fp16 rows alone)."""
    tally = Tally()
    check_precision_kernels(dev, tally, ((torch.float16, PRECISION_FP16),)
                            if fp16_only else None)
    rows = {"fp16_state": tally_rows(tally, PRECISION_FP16)}
    if not fp16_only:
        rows["bf16_state"] = tally_rows(tally, PRECISION)
    print("3i " + json.dumps(rows), flush=True)
    return rows


def precision_parts(dev, card):
    """``--only precision`` and its parts."""
    def run_14abe():
        out = run_14ab(dev, card)
        out["14e"] = run_14e(dev, card, out["14a"])
        return out

    return {"precision": lambda: {
                "3i": run_3i_alone(dev), **run_phase14(dev, card)},
            "3i_fp16": lambda: run_3i_alone(dev, fp16_only=True),
            "14ab": lambda: run_14ab(dev, card),
            "14c": lambda: run_14c(dev),
            "14d": lambda: check_small_precision(dev),
            "14abe": run_14abe,
            "14f": lambda: run_14f(dev, card),
            "examples": lambda: run_examples(dev)}


def tally_rows(tally, names):
    """Each kernel's row of ``tally`` under ``names``, with its bound and
    the share of it the call and batched times reach."""
    rows = {}
    for k, name in names.items():
        r = tally.rows[name]
        b = max(r["bytes"] / PEAK_BYTES_PER_S, r["ops"] / PEAK_F32_PER_S) * 1e3
        rows[k] = {"ms": r["ms"], "batched_ms": r["batched_ms"],
                   "plain_ms": r["plain_ms"], "bound_ms": b,
                   "share": b / r["ms"], "batched_share": b / r["batched_ms"],
                   "library_ms": r["library_ms"],
                   "max_abs_err": r["max_abs_err"],
                   "launches_per_round": r["launches_per_round"]}
    return rows


def _to(tree, d):
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    return tree.to(d)


def parse_args(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--only", nargs="+", metavar="PART",
        help="after the build, run only these checks of phases 4n, 5, 6, "
             "7 and 8 (4n, names of small_parts and dist_parts, e.g. 'probe "
             "6b 6b_lamb 6d 6d_lamb' for the four-card paths, or "
             "'gpt2_qint8 gpt2_qint4_hier'; 'serve' for phase 7, or its "
             "runs '7a' ... '7e'; 'audit' for phase 8; 'families' for 3e, "
             "phase 5's family checks and phase 9, or '9ab', '9c', '9d', "
             "'9a_1layer'; 'moe' for 3f and phase 10, or '10ab', '10c'; "
             "'ssm' for 3g, phase 5's state-space checks and phase 11, or "
             "'11ab', '11c'; 'vlm_encdec' for 3h, phase 5's vlm and "
             "encoder-decoder checks and phase 12, or '12ab', '12c'; "
             "'moe_serve' for phase 5's MoE serving checks and phase 13; "
             "'precision' for 3i and phase 14, or '3i_fp16', '14ab', "
             "'14c', '14d', '14abe', '14f'; 'examples' for phase 15), "
             "print their summary and the card line, and no kernels or "
             "result line")
    return ap.parse_args(argv)


def run_only(dev, names, card, t_start):
    """``--only``: the named checks of phases 4n (after run 4a), 5, 6, 7
    (``serve``: all of it, or its runs ``7a`` ... ``7e``), 8 (``audit``),
    9 (``families``: 3e, phase 5's family checks and 9a-9d; or ``9ab``,
    ``9c``, ``9d``), 10 (``moe``) and 11 (``ssm``: 3g, phase 5's
    state-space checks and 11a-11c; or ``11ab``, ``11c``) and 12
    (``vlm_encdec``: 3h, phase 5's vlm and encoder-decoder checks and
    12a-12c; or ``12ab``, ``12c``) and 13 (``moe_serve``: phase 5's MoE
    serving checks and 13a-13d) and 14 (``precision``: 3i and 14a-14f;
    or ``3i_fp16``, ``14ab``, ``14c``, ``14d``, ``14abe``, ``14f``) and
    15 (``examples``), in that order."""
    parts = {"4n": lambda: run_elastic_phase(
        dev, run_main_path(dev, *RUNS[0])), **small_parts(dev),
        **family_parts(dev),
        **dist_parts(), **serve_parts(dev),
        "serve": lambda: run_serve_phase(dev), "audit": run_audit_phase,
        "families": lambda: run_family_phase(dev),
        "9a_1layer": lambda: run_9a_one_layer(dev),
        "9ab": lambda: run_family_training(dev), "9c": lambda: run_9c(dev),
        "9d": run_9d,
        **moe_parts(dev), "moe": lambda: run_moe_only(dev),
        "10ab": lambda: {**{k: run() for k, run in moe_parts(dev).items()},
                         "10b": run_10b()},
        "10c": run_10c,
        **ssm_parts(dev), "ssm": lambda: run_ssm_only(dev),
        "11ab": lambda: run_ssm_training(dev), "11c": lambda: run_11c(dev),
        **vlm_encdec_parts(dev),
        "vlm_encdec": lambda: run_vlm_encdec_only(dev),
        "12ab": lambda: run_vlm_encdec_training(dev),
        "12c": lambda: run_12c(dev),
        **moe_serve_parts(dev),
        "moe_serve": lambda: run_moe_serve_only(dev, card),
        **precision_parts(dev, card)}
    unknown = sorted(set(names) - set(parts))
    if unknown:
        sys.exit(f"chip_smoke: unknown parts {unknown}; choose from "
                 f"{list(parts)}")
    out = {}
    for name in parts:
        if name in names:
            print(f"part {name}", flush=True)
            out[name] = parts[name]()
            gc.collect()
            torch.cuda.empty_cache()
    print(f"chip_smoke: parts {list(out)} passed in "
          f"{time.time() - t_start:.1f} s", flush=True)
    print("summary " + json.dumps(out))
    print(card)


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's smoke run needs a "
                 "GPU")
    from repro_torch.kernels import build

    t_start = time.time()
    card = card_line()
    dev = torch.device("cuda")
    print(f"phase 1: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; python {sys.version.split()[0]}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    build.build_all()
    print(f"phase 2: built {list(build.SOURCES)} for sm_90a in "
          f"{time.time() - t0:.1f} s", flush=True)
    for name, log in build.build_logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}.cu ptxas: {regs}")
    if args.only:
        run_only(dev, args.only, card, t_start)
        return
    walls, mark = {}, [t_start]

    def lap(phase):
        """Note and print the wall seconds of ``phase`` (since the last
        lap)."""
        now = time.time()
        walls[phase] = now - mark[0]
        mark[0] = now
        print(f"  phase {phase} took {walls[phase]:.1f} s", flush=True)

    lap("1-2")
    print("phase 3: kernels vs plain versions at FULL frames, "
          f"{N_WORKERS} stacked workers; 3a: gpt2", flush=True)
    tally = Tally()
    check_kernels(dev, tally)
    print("phase 3b: bert-base", flush=True)
    check_bert_kernels(dev, tally)
    print(f"phase 3c: the two-level exchange's frames, "
          f"{N_WORKERS // INNER} pods x {INNER}", flush=True)
    check_hier_kernels(dev, tally)
    print(f"phase 3d: the bucketed exchange's fused-bucket frames at "
          f"{BUCKET_MB} MiB, flat and {N_WORKERS // INNER} pods x {INNER}",
          flush=True)
    check_bucket_kernels(dev, tally)
    print("phase 3e: every frame of a step of each run of phase 9 (9a, 9b, "
          "a rank of 9d); frame_precheck on the four FULL configs",
          flush=True)
    precheck = check_family_kernels(dev, tally)
    print("phase 3f: every DP frame of a step of one rank of 10c "
          "(deepseek-v2-236b FULL width, 2 layers, 4 ranks)", flush=True)
    check_run_frames(dev, tally, FRAMES_3F, MOE_NAMES, "3f")
    print("phase 3g: every frame of a step of 11a and 11b (mamba2-2.7b, "
          "zamba2-1.2b FULL width); frame_precheck on both FULL configs",
          flush=True)
    precheck_ssm = check_ssm_kernels(dev, tally)
    print("phase 3h: every frame of a step of 12a and 12b (qwen2-vl-2b, "
          "whisper-large-v3 FULL width); frame_precheck on both FULL "
          "configs", flush=True)
    precheck_vlm_encdec = check_vlm_encdec_kernels(dev, tally)
    print("phase 3i: production precision, the state-reading kernels at "
          "bf16 and fp16 state (gpt2 FULL and bert-base FULL frames)",
          flush=True)
    check_precision_kernels(dev, tally)
    lap("3")

    runs = {}
    for label, arch, extra, batch, seq, kind in RUNS:
        print(f"phase 4 ({label}): {arch} FULL {' '.join(extra)}, "
              f"{N_WORKERS} simulated workers, batch {batch}, seq {seq}, "
              f"{kind} data, {STEPS} steps", flush=True)
        runs[label] = run_main_path(dev, label, arch, extra, batch, seq,
                                    kind)
        gc.collect()
        torch.cuda.empty_cache()
    a, h = runs["gpt2"], runs["gpt2_one_leaf"]
    same = (a["params_sha256"] == h["params_sha256"]
            and [r["losses"] for r in a["steps"]]
            == [r["losses"] for r in h["steps"]])
    print(f"phase 4h: one leaf per bucket bit for bit 4a: {same}",
          flush=True)
    assert same, "4h: the per-unit loop is not the per-leaf path"
    lap("4")
    print(f"phase 4i: checkpoint round trips, gpt2 FULL width, "
          f"{FILE_LAYERS} of 12 layers, single mode, batch 4, seq {SEQ}",
          flush=True)
    checkpoints = {"per_leaf": run_checkpoint([]),
                   "bucketed": run_checkpoint(BUCKETED)}
    lap("4i")

    print(f"phase 4n: elastic data parallelism, gpt2 FULL with 4a's flags",
          flush=True)
    elastic = run_elastic_phase(dev, runs["gpt2"])
    lap("4n")

    print("phase 5: smoke trainers on the card vs on the CPU", flush=True)
    small = {name: run() for name, run in {**small_parts(dev),
                                           **family_parts(dev),
                                           **ssm_parts(dev),
                                           **vlm_encdec_parts(dev),
                                           **moe_serve_parts(dev)}.items()}
    lap("5")

    print("phase 6: data parallel in processes", flush=True)
    dist_phase = run_dist_phase()
    lap("6")

    print("phase 7: serving gpt2 FULL through repro_torch.launch.serve",
          flush=True)
    serve = run_serve_phase(dev)
    lap("7")

    print("phase 8: the communication audit's matrix (launch.audit "
          "--matrix --lints) on the card", flush=True)
    audit = run_audit_phase()
    lap("8")

    print("phase 9: the dense rotary family at full width", flush=True)
    families = run_phase9(dev)
    lap("9")

    print("phase 10: mixture of experts with expert parallelism",
          flush=True)
    moe = run_moe_phase(dev)
    lap("10")

    print("phase 11: the state-space family at full width", flush=True)
    ssm = run_phase11(dev)
    lap("11")

    print("phase 12: the vlm (qwen2-vl-2b) and the encoder-decoder "
          "(whisper-large-v3) at full width", flush=True)
    vlm_encdec = run_phase12(dev)
    lap("12")

    print("phase 13: MoE and MLA serving at full width (deepseek-v2-236b, "
          "llama4-scout-17b-a16e), expert parallel in processes",
          flush=True)
    moe_serve = run_phase13(dev, card)
    lap("13")

    print("phase 14: production precision (bf16 params, compute and "
          "optimizer state; fp16 state; bf16 serving)", flush=True)
    precision = run_phase14(dev, card, runs["gpt2"])
    lap("14")

    print("phase 15: the port's examples on the card", flush=True)
    examples = run_examples(dev)
    lap("15")

    def bound(r):
        t_bytes = r["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = r["ops"] / PEAK_F32_PER_S * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = tally.rows[name]
        bound_ms, bound_by = bound(r)
        by_run = {label: run["launches"].get(name, 0)
                  for label, run in runs.items()}
        for part in ("cli_identity", "fleet"):
            by_run[f"4n_{part}"] = elastic[part]["launches"].get(name, 0)
        for side in ("publish", "apply"):
            by_run[f"7e_sign1bit_{side}"] = sum(
                r[f"{side}_launches"].get(name, 0)
                for r in serve["7e"]["sign1bit"]["publishes"])
            for part in moe_serve_parts(dev):
                by_run[f"5_{part}_{side}"] = (
                    small[part][f"{side}_launches"].get(name, 0))
        for label in ("14a", "14b", "14c", "14e"):
            by_run[label] = precision[label]["launches"].get(name, 0)
        for label, *_ in FAMILY_RUNS:
            by_run[label] = families[label]["launches"].get(name, 0)
        for label, *_ in SSM_RUNS:
            by_run[label] = ssm[label]["launches"].get(name, 0)
        for label, *_ in VLM_ENCDEC_RUNS:
            by_run[label] = vlm_encdec[label]["launches"].get(name, 0)
        for row in families["9d"].get("ranks", []):
            by_run[f"9d_rank{row['rank']}"] = row["launches"].get(name, 0)
        for part in ("10b", "10c"):
            for row in moe[part].get("ranks", []):
                by_run[f"{part}_rank{row['rank']}"] = (
                    row["launches"].get(name, 0))
        for part, d in dist_phase.items():
            if not isinstance(d, dict) or "ranks" not in d:
                continue            # the probes, the wall time; 6d on
                                    # fewer cards
            if "reference" in d:
                by_run[f"{part}_reference"] = (
                    d["reference"]["launches"].get(name, 0))
            for row in d["ranks"]:
                by_run[f"{part}_rank{row['rank']}"] = (
                    row["launches"].get(name, 0))
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_run.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "batched_ms": r["batched_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": r["library_ms"],
            "per": PER[name], "launches_per_round": r["launches_per_round"],
            "launches_by_run": by_run})
        if name in HIER:
            rh = tally.rows[HIER[name]]
            kernels[-1]["hier_sync"] = {
                "per": ("sync (gpt2, 2 pods x 2)" if name != "ef_compress"
                        else "bert-base slice frames (row scales)"),
                "ms": rh["ms"], "batched_ms": rh["batched_ms"],
                "plain_ms": rh["plain_ms"], "bound_ms": bound(rh)[0],
                "library_ms": rh["library_ms"],
                "launches_per_round": rh["launches_per_round"]}
        for key, names in (("bucket_frames", BUCKET),
                           ("bucket_frames_hier", BUCKET_HIER)):
            if name in names:
                rb = tally.rows[names[name]]
                kernels[-1][key] = {
                    "per": (f"the three fused buckets' frames of a gpt2 "
                            f"sync at --bucket-mb {BUCKET_MB}"
                            f"{', 2 pods x 2' if 'hier' in key else ''}"),
                    "ms": rb["ms"], "batched_ms": rb["batched_ms"],
                    "plain_ms": rb["plain_ms"], "bound_ms": bound(rb)[0],
                    "library_ms": rb["library_ms"],
                    "max_abs_err": rb["max_abs_err"],
                    "launches_per_round": rb["launches_per_round"]}
        if name in FAMILY_KERNELS:
            kernels[-1]["vlm_encdec_frames"] = {
                label: {"per": "step (kernel 1) or sync (kernels 2-4) of "
                               + frames_3e_text(label, FRAMES_3H),
                        **tally_rows(tally, {name: names[name]})[name]}
                for label, names in VLM_ENCDEC_NAMES.items()}
            kernels[-1]["ssm_frames"] = {
                label: {"per": "step (kernel 1) or sync (kernels 2-4) of "
                               + frames_3e_text(label, FRAMES_3G),
                        **tally_rows(tally, {name: names[name]})[name]}
                for label, names in SSM_NAMES.items()}
            kernels[-1]["moe_frames"] = {
                label: {"per": "step (kernel 1) or sync (kernels 2-4) of "
                               + frames_3e_text(label, FRAMES_3F),
                        **tally_rows(tally, {name: names[name]})[name]}
                for label, names in MOE_NAMES.items()}
            kernels[-1]["family_frames"] = {
                label: {"per": "step (kernel 1) or sync (kernels 2-4) of "
                               + frames_3e_text(label),
                        **tally_rows(tally, {name: names[name]})[name]}
                for label, names in FAMILY_NAMES.items()}
        if name in PRECISION:
            kernels[-1]["production_precision"] = {
                "per": ("bf16 state operands; " + PER[name]),
                **tally_rows(tally, {name: PRECISION[name]})[name]}
            kernels[-1]["production_precision_fp16"] = {
                "per": ("fp16 state operands (a bf16 gradient); "
                        + PER[name]),
                **tally_rows(tally, {name: PRECISION_FP16[name]})[name]}
        if name == "fused_local_step":
            rb = tally.rows[BERT_LAMB]
            kernels[-1]["bert_lamb"] = {
                "per": "step (bert-base, zero_one_lamb; the trust scaling "
                       "after the kernel not included)",
                "ms": rb["ms"], "batched_ms": rb["batched_ms"],
                "plain_ms": rb["plain_ms"], "bound_ms": bound(rb)[0],
                "library_ms": rb["library_ms"],
                "max_abs_err": rb["max_abs_err"],
                "launches_per_round": rb["launches_per_round"]}
        if name == "decompress":
            rb = tally.rows[BERT_DECOMPRESS]
            kernels[-1]["bert_sync"] = {
                "per": "sync (bert-base, zero_one_sgd)", "ms": rb["ms"],
                "batched_ms": rb["batched_ms"],
                "plain_ms": rb["plain_ms"], "bound_ms": bound(rb)[0],
                "launches_per_round": rb["launches_per_round"]}
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    assert not missing, f"kernels never launched on a main path: {missing}"
    summary = {"runs": runs, "checkpoints": checkpoints, "4n": elastic,
               "3e_precheck": precheck, "families": families, "moe": moe,
               "3g_precheck": precheck_ssm, "ssm": ssm,
               "3h_precheck": precheck_vlm_encdec, "vlm_encdec": vlm_encdec,
               "moe_serve": moe_serve, "precision": precision,
               "examples": examples,
               "small_inputs": small,
               "data_parallel": dist_phase, "serve": serve,
               "audit": audit, "phase_wall_s": walls,
               "wall_s": time.time() - t_start}
    print(f"chip_smoke: all phases passed in {summary['wall_s']:.1f} s",
          flush=True)
    print("summary " + json.dumps(summary))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
