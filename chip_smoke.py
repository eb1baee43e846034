#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

  build   builds every hand-written kernel from the sources in this checkout
          (one nvcc per source, and per part of flash.cu, whose three
          parts link into one library; all started together) and prints
          ptxas's register / shared-memory / spill report;
  no_spills  fails if ptxas reports a spill in any kernel instance;
  kernel  holds the flash-attention kernel against its plain PyTorch
          version on the card -- f32 within 2e-5, bf16 within 2e-2 of
          max(1, max|plain|) -- in both of its forms (decode: Sq * G <= 8
          rows per kv head, keys split over warps and over a cluster for
          long caches; forward: bf16 on tensor cores, f32 on CUDA cores),
          full and partial, with GQA and without (H == KV), G = 1 and 8,
          every head_dim (16, 32, 64, 96, 128, 256; at 96 and 256 decode
          with G = 1 and 4 at 1-8 rows, a sequence-sharded partial, 2- and
          8-CTA clusters, forwards in CTAs of 1, 2 and 4 warps), windows,
          offsets, row and key counts off the tiles, causal forwards of 512
          that skip tiles, and rows that see no key (m = -1e30 and l = Sk,
          or the mean of v); it times two
          rows off the main path with their plain version, bound and SDPA
          (a 4096-key cache at decode, a 2048-token causal forward); and
          the reorder kernel (tile_swizzle) against its plain
          version bit for bit: f32 / bf16 / int32, G in {4, 8, 16}, b in
          {1, 8, 16}, D in {64, 128, 2048}, random perms, block_transpose,
          unaligned base pointers and an out-of-range perm entry; 128-,
          256- and 832-byte blocks at G = 132,096 and 16,384, 4-KiB,
          4,112-byte and 160-KiB blocks, 1.25-MiB blocks at 2-byte
          alignment, payloads just under and just over 2^31 words (32- and
          64-bit indices, 4.3 GB) with zero blocks (each launch's plan,
          index width and word, checked too); then the reorder sweep:
          blocks of 16 B to 1.25 MiB (REORDER_SWEEP) at about 64 MiB of
          payload each, timed beside index_select and the bytes bound,
          every launch bit for bit, and the launch floor (one 16-byte
          block); and the
          RWKV6 kernel against its plain version on o and the final state
          (f32 within 5e-4, bf16 within 5e-2 of max(1, max|plain|); in
          both types the final state also within RWKV6_STATE_TOL of the
          f64 recurrence, the kernel's f32 arithmetic): the
          JAX kernel sweep's shapes under its strong decay, the full head
          shape (4, 512, 64, 64) and (4, 2048, 64, 64) with a state coming
          in (both also timed, with their plain version and bound), S =
          144 (chunks of 72), the served shapes, lengths 1, 15, 16, 17 and
          37 around the 16-step sub-chunk, one u per folded PE, K = 16 and
          32, grids under and over the 132 SMs; and the flash backward
          kernel (flash_bwd.cu) against its plain version on dq, dk and dv
          (f32 within 1e-4, bf16 within 5e-2 of each output's own
          max|plain|), fed
          the forward kernel's output and row statistics (those held to
          the plain forward's, and the output bit-identical to a launch
          without them) at every head dim (16, 32, 64, 96, 128, 256): G =
          1, 2, 4 and 8, causal and not, windows, offsets, Sq and Sk off
          the tiles, rows that see no key, a 512-token causal run, a 3-row
          query, qwen3's 1-PE training shape (4 x 1,024 causal tokens, 16
          / 8 heads), phi3-mini's at 1 PE and tp 8 (hd 96), gemma3's at 1
          PE with its local window of 512 and its global mask and at data
          2 x tp 4 (hd 256, one kv head), a windowed G = 4 case at hd 256
          off the tiles, G * Sq and Sk off the bf16 passes' tiles, a key
          tile across the causal diagonal; two launches on the same inputs
          bit-identical at every head dim; the reorder under
          autograd (``TileSwizzle``): output and gradient bit-identical to
          autograd of index_select on random perms, and the pr and cm
          all_to_alls of the 8-PE cubes under autograd bit-identical to
          autograd of a plain transpose, each launching the kernel twice
          (forward, backward with the inverse perm); and the RWKV6
          backward kernels (rwkv6_bwd.cu: the state-gradient pass, the
          chunk pass, the du sum) on the states the forward kernel saves
          every 64 steps (held to the plain ones within 1e-5, the
          forward's o and state bit-identical to a launch without them)
          against the plain backward and against autograd of the plain
          forward: dr, dk, dv, dlogw, du and dstate each within 5e-4 (f32)
          / 5e-2 (bf16) of max(1, max|plain|), K = 16, 32 and 64, state in
          and out, lengths 1, 15, 16, 17, 37, 63, 64, 65, 129, 144 and
          1,024 around the sub-chunk and the 64-step chunk, the strong
          decay, one u per folded PE, one (batch, head) of 1,024 steps,
          two launches bit-identical; the training shape (4, 1024, 64, 64)
          bf16 timed with its plain version, its bound and each pass's
          device ms. Also internlm2's G = 6 (1,024 causal
          tokens at 48 / 8 and 6 / 1 heads, the 6-row decode form, the
          backward) and whisper's hd-64 non-causal shapes (the encoder's
          Sq = Sk = 1,024, the cross-attention's Sq != Sk, the cross decode
          with every key valid) in the flash and backward sweeps; and the
          flash kernel's int8 decode form (the int8 KV cache: int8 codes
          and an f32 scale a (key, kv head)) against its plain version on
          INT8_CASES (G = 1, 2, 4, 6, 8; every head dim; windows, rolling
          slots, sequence-sharded partials, 2- and 8-CTA clusters, the
          cross decode, zero keys of scale 1e-6 / 127; f32 and bf16 q,
          partial and full) within KERNEL_TOL of q's type, with qwen3's
          1-PE decode and a 4,096-key cache timed beside the bf16 decode
          form on the same shape, with their plain version and bound (no
          PyTorch call takes int8 K/V: no library yardstick);
  comm    every ported stage of all_reduce / all_gather / reduce_scatter on
          virtual 8-PE cubes on the card, and every stage of all_to_all on
          the 8-PE cubes and the 16-PE shapes, bit-identical to a plain
          reduction or transpose written here, on integer payloads; the
          non-stage all_reduce flows (hierarchical, tree, ring on single-dim
          groups, pidcomm and auto) on the 8-PE cubes and the 16-PE shapes
          bit-identical too, the int8 ``compressed`` flow on the pod-crossing
          groups within 1e-6 x max|plain| of a plain int8 version written
          here (and further than that from the exact sum), and the three
          fused ring flows (ring_fused, ag_prologue, rs_epilogue) on the
          8-PE cubes bit-identical;
  serve   full-width qwen3-1.7b through the launcher's function
          (batch 4, prompt 32, gen 16) at 1 and 8 PEs: decode logits track
          forward_logits of the same tokens within 5e-2 * max(1, max|ref|)
          (bf16), 1-PE and 8-PE logits agree within the same bound, the
          flash kernel's launches are counted in both, and a profile of
          three decode steps says where a step's time goes. The inputs of
          the kernel's last launch in each form (forward, decode) are kept;
  serve_f32  the same serve at 1 and 8 PEs in f32: logits agree within
          1e-4 * max(1, max|ref|) and the greedy tokens are identical;
  serve_moe  full-width qwen2-moe-a2.7b (bf16, MOE_SERVE_LAYERS = 12 of its
          24 layers, 64 padded experts
          top-4) through the launcher's function at 1 and 8 PEs, one
          topology's weights on the card at a time: ms/step, tok/s, peak
          memory, both kernels' launches (each run must launch the flash
          kernel 12 x 47 times, one per layer and decode step, and the 8-PE
          run the reorder kernel 2 x 12 x 47 times: two all_to_alls per
          layer and decode step), a decode profile, the 1-PE vs 8-PE logits error and
          the share of routing decisions that agree. The inputs of each
          kernel's last launch in each run are kept;
  serve_moe_f32  the same in f32 (TF32 off): 1-PE and 8-PE logits within
          1e-4 * max(1, max|ref|), identical greedy tokens, and identical
          top-k expert ids at every (step, layer, request);
  serve_rwkv  full-width rwkv6-7b (bf16, RWKV_SERVE_LAYERS = 16 of its 32
          layers, 64 heads of 64) at 1 and 8 PEs, one topology's weights on the card at a time: the
          launcher's loop (which decodes with the one-token recurrence and
          launches the RWKV6 kernel 0 times), forward_logits on the served
          tokens, and prefill_shard of the prompt followed by decode from
          its cache. The kernel must launch once per layer per forward and
          per prefill, and each launch is held against the plain version on its
          inputs (5e-2). The witness: the same forward and prefill with the
          plain version in the kernel's place (only the recurrence
          differs); the kernel's paths -- forward logits, prefill's
          last-position logits, state and shifts -- within 0.25 x max(1,
          max|ref|) of it (bf16 rounding flips alone move this random-weight
          model by about 0.12 of max over 32 layers), and prefill +
          decode's greedy tokens the loop's or a tie within that bound.
          Decode vs forward and prefill vs the loop are reported beside
          5e-2 x max(1, max|ref|), which they do not meet (bf16 vs f32 of
          the same tokens, also reported, is about a third of max). The
          inputs of the kernel's last launch on each path are kept;
  serve_rwkv_f32  the same in f32 (TF32 off): 1-PE and 8-PE logits within
          1e-4 * max(1, max|ref|) and identical greedy tokens; every
          launch against the plain version (5e-4) and the one-token
          recurrence (1e-4); the kernel's paths against the plain
          witness within 1e-4 * max(1, max|ref|); prefill's last logits
          and cache against the teacher-forced loop within 2e-4 * max(1,
          max|ref|) (1e-4 and the plain prefill's own distance reported
          beside it); prefill + decode's greedy tokens the loop's;
  serve_mixtral  mixtral-8x7b (4 of 32 layers at full width: 8 experts of
          d_ff 14,336, top-2, 32 / 8 heads of 128) through the launcher's
          function at 1 and 8 PEs (ep 8, etp 1: the reorder on both
          all_to_alls of every layer), bf16 and f32 (TF32 off), one
          topology's weights at a time: exact launches (flash 4 x 47 a
          decode run, reorder 2 x 4 x 47 at 8 PEs; the forward 4 and 8),
          decode against forward_logits of the served tokens within 5e-2
          (bf16) / 1e-4 (f32) x max(1, max|ref|) at the positions where no
          choice was dropped to the expert capacity in either path and the
          routings agree, at every layer, at and before them (capacity
          makes the two paths different functions elsewhere: the dropped
          choices are computed from the recorded routings); 1 PE against
          8 PEs in bf16 within 5e-2 x max(1, max|ref|) at the steps whose
          tokens and routings agreed so far; in f32 within 1e-4 x max(1,
          max|ref|) everywhere, identical greedy tokens and identical
          top-2 expert ids at every (step, layer, request); ms/step,
          tok/s, peak memory and a decode profile in bf16. The inputs of
          each kernel's last bf16 launch are kept;
  serve_dense  full-width phi3-mini-3.8b (hd 96, 32 heads, G = 1; 8 of its
          32 layers) at 1 and 8 PEs and gemma3-1b (hd 256, G = 4, 5:1
          local:global windows of 512; 13 of its 26 layers, two global) at
          1 and 4 PEs, bf16, through the launcher's function: decode
          within 5e-2 * max(1, max|ref|) of forward_logits, 1 PE vs n PEs
          the same, exactly n_layers x 47 flash launches per decode run and
          n_layers per forward, a decode profile per cell, bf16's distance
          from the f32 forward reported; and gemma3's 1,024-token forward at
          1 PE (the window masks keys and the bf16 forward skips tiles)
          against its witness, the same forward with the plain version in
          the kernel's place, within 5e-2 * max(1, max|ref|). The inputs of
          the kernel's last launch on each path and run are kept;
  serve_dense_f32  the same in f32 (TF32 off): 1-PE vs n-PE logits within
          1e-4 * max(1, max|ref|), identical greedy tokens, the same launch
          counts, and the 1,024-token forward within 1e-4 * max(1, max|ref|)
          of its witness;
  serve_internlm2  internlm2-20b (48 / 8 heads of 128: G = 6) at full
          width and 12 of its 48 layers through the launcher's function at
          1 PE and at 16 PEs (its own tp: its 8 KV heads under tp 16 sit on
          every PE with 3 query heads a PE), one topology's weights at a
          time: exactly n_layers x 47 flash launches a decode run and
          n_layers a forward; bf16 decode against its witness (the same
          decode with the plain attention in the kernel's place) within
          0.25 x max(1, max|ref|) at the steps whose inputs agree (bf16 vs
          f32 of the same tokens read about 0.11 of max at 36 layers of
          this width), decode vs forward and 1 vs 16 PEs reported beside
          5e-2; a
          decode profile per run;
  serve_internlm2_f32  the same in f32 (TF32 off): decode within 1e-4 x
          max(1, max|ref|) of forward_logits, 1 PE vs 16 PEs the same and
          identical greedy tokens;
  serve_whisper  whisper-base (6 encoder + 6 decoder layers, hd 64) at full
          width and depth at 1 and 8 PEs, bf16 and f32, on one model (its
          vocab's pad columns zeroed): the frames (S_ctx of them, from the
          seed) and the prompt through ``prefill_shard`` (the encoder, the
          self and cross caches), then 15 greedy decode steps; decode
          within 5e-2 (bf16) / 1e-4 (f32) x max(1, max|ref|) of
          forward_logits of the served tokens and frames, 1 vs 8 PEs the
          same (f32: identical tokens); exact launches (a prefill n_enc +
          2 L flash forwards, a decode step 2 L, a forward n_enc + 2 L; 2 L
          reorders a prefill at 8 PEs);
  serve_int8  qwen3-1.7b at full width and INT8_LAYERS = 14 of its 28
          layers from the int8 KV cache
          through the launcher's loop at 1 and 8 PEs beside the
          compute-dtype cache on the same weights, in bf16 and in f32:
          in f32 the int8 run within 5e-2 x max(1, max|ref|) of the f32
          cache's (JAX's own bound for the int8 cache) at the steps whose
          inputs agree, in bf16 that difference reported; exactly n_layers
          int8 decode launches a step and no other flash launch; ms/step
          and cache bytes of both; ``ServeEngine`` on the int8 plan at 1 PE
          giving the int8 launcher's tokens; the int8 form's last launch
          of each bf16 run checked and timed with its bound and the bf16
          form on the same shape;
  serve_resident  qwen3-1.7b at full width on a serve cube of data 2 x tp
          4 with resident weights (``Server(resident=True)``) and with the
          FSDP weights: logits bit-identical, tokens identical, zero data
          all_gathers a step with resident weights (from the
          ``CommTrace``), exact launches, ms/step of both;
  serve_prefill  ``Server.prefill_shard`` of attention layers into the
          decode cache, bf16 over f32 masters unless named: qwen3-1.7b at 1
          and 8 PEs on the serve cell (batch 4, prompt 32): the launcher's
          teacher-forced loop, then prefill of its prompt and 15 decode
          steps from the prefilled cache fed the loop's tokens, within
          5e-2 x max(1, max|ref|) of the loop's logits at positions 31-46
          with the share of greedy tokens that agree reported, and again
          in f32 (TF32 off) within 1e-4 with the greedy tokens identical;
          qwen3-1.7b at 1 and 8 PEs with a 2,048-token prompt (batch 4):
          prefill's last logits and 16 greedy decode steps from its cache
          within 5e-2 x max(1, max|ref|) of forward_logits of the prompt
          and the generated tokens, the prefill's wall s (synchronized,
          the second of two) and tok/s; gemma3-1b at 1 and 4 PEs the same
          with a 1,024-token prompt, past its local layers' 512 window.
          Exact launches: n_layers flash launches a prefill and n_layers a
          decode step; one reorder launch a layer and prefill where the KV
          heads are sharded over tp (the K/V reshard's all_to_all:
          qwen3 at 8 PEs), none at 1 PE or with gemma3's one KV head. And,
          on the 8-PE weights ``serve_moe`` holds, qwen2-moe-a2.7b's
          forward_logits and 4 decode steps under moe_dispatch "sort"
          against "scatter": the max differences reported (expected
          bit-identical), routing decisions identical, and 2 x n_layers
          reorder launches a forward and a decode step. The inputs of the
          kernels' last prefill launches are kept;
  serve_engine  the paged continuous-batching ``ServeEngine`` serving
          qwen3-1.7b at full width and 3 of its 28 layers (bf16 over f32
          master weights, random from seed 0; B = 4 lanes, S_ctx 48,
          page_size 3) at 1 and 8 PEs, one
          topology's weights on the card at a time: the launcher's four
          prompts, all at step 0, give the launcher's greedy tokens
          exactly; a 12-request Poisson trace completes with every
          request's tokens in the vocab, one recorded program a step,
          exactly one lowering and a lower-cache hit every step after;
          at 1 PE its first 6 requests served alone give the batched
          tokens and temperature 0.8 repeats under one seed; at 8 PEs
          lazy admission on pools of 4 pages a shard preempts and gives
          the reserve run's tokens. Every run launches the flash kernel
          exactly 7 times a step (counted from 0 just before the run).
          Reports steps, tok/s, p50 / p99 per-token seconds, ms/step,
          page occupancy, peak memory and a profile of three steps;
  apps    the paper's five applications (six APPS entries) on their JAX
          bench cubes at sizes that hold hundreds of MB to GB (APP_CASES:
          DLRM with 26 tables of 1,000,000 rows, GNN 32,768 nodes, BFS and
          CC 32,768 nodes, MLP 16,384 features; DLRM's, GNN's and MLP's
          inputs drawn from a seed, not the reference's constants), one at
          a time, under naive and pidcomm: the scalar against a plain
          single-tensor version written here on the app's own inputs
          (APP_TOL; BFS and CC exactly, and again at 1 and 2 iterations,
          before they saturate), ms per call, peak
          memory, the inputs' bytes, and the reorder kernel's launches
          (exactly 2 a DLRM pidcomm call);
  tune    ``Tuner.tune`` (``repro_torch.tuning``) on the card over three
          cubes -- ring8, the 2x2x2 cube (selections 010, 110, 011) and
          pod2x4x2 (innermost dim and whole cube) -- at 64 KiB, 1 MiB, 16
          MiB and 64 MiB a PE, 5 timed calls after 2 of warm-up a cell
          (CUDA events, median): each (flow, stage, domain) fit's alpha in
          us, 1 / beta in GB/s, r2 and sample count, the overlap factors,
          and per primitive, selection and size the planner's pick under
          the profile, the measured fastest and the ratio of their times
          (reported). Gates: the profile saves, reloads equal, and is
          refused on another cube's fingerprint; ``auto`` under the
          installed profile dispatches the flow the planner names,
          bit-identical to that flow on integer payloads, for the four
          PE primitives at 64 KiB and 16 MiB; every all_to_all cell
          launches the reorder kernel once a call of its cm flow;
          where the least bytes a cell's call moves through the card's
          memory (every PE's payload read and result written once; a
          rooted flow's: the host value's) exceed 4x the 50 MB L2, their
          rate stays under 3.35 TB/s (a missed synchronize reads
          faster); ``select`` on a cube never tuned takes its measuring
          fallback; and qwen3-1.7b's grad-sync program at tp 8 (one
          all_reduce of each replicated leaf), planned under its cube's
          profile, executed, and its planned against its measured
          seconds filed in a ``DriftMonitor``;
  fused_forward  full-width qwen3-1.7b forward_logits at 8 PEs with tp = 2
          and cp = 2 (global batch 2 of 2,048 tokens) with fused_comm on and
          off: bf16 within 5e-2 and f32 within 1e-4 x max(1, max|ref|),
          exactly n_layers x cp partial flash launches a fused forward (ring
          attention's hops) and n_layers unfused;
  train   full-width qwen3-1.7b (TRAIN_LAYERS = 14 of its 28 layers)
          training through ``Trainer`` at 1 PE, at
          8 PEs as the launcher lays them out (tp 8) and at 8 PEs as data
          2 x tp 4, one layout's weights on the card at a time: bf16 over
          f32 masters, int8 moments, a warm-up and 3 timed steps of 4 x
          1,024 tokens from TokenStream (ms/step, tok/s, mfu = 6 N tokens /
          s / 989e12, peak memory, a profile of one step), exactly 2 L
          forward-form and L backward launches a step, the grad-sync
          programs lowered on the first step and served from the lower
          cache after; one batch repeated 5 steps at 1 PE: the loss falls;
          f32 (TF32 off, fp32 moments, 2 x 256 tokens): the loss of 1 PE
          and both 8-PE layouts within 1e-5 relative, their synced
          gradients within 1e-4 x max|g| per leaf (no floor at 1: weight
          gradients lie far below 1) and the params after 2 steps within
          1e-4 x max(1, max|ref|) per leaf (each leaf's max reported
          beside its error), the 1-PE gradients against the witness (the
          plain forward and backward in the kernels' place, no launch)
          within 1e-4 x max|g| per leaf, two controls that the witness
          must catch (the backward kernel's gradients zeroed, and its dq
          scaled by 0.9), and at 8 PEs the barrier sync against the
          staged bucket dispatch on the same gradients (bit for bit) and
          the backward's bucket hooks (bit for bit on the synced leaves).
          The inputs of each layout's last forward and backward launch are
          kept;
  train_moe_rwkv  qwen2-moe-a2.7b (2 of 24 layers), rwkv6-7b (6 of 32),
          phi3-mini-3.8b (8 of 32: hd 96), gemma3-1b (12 of 26: hd 256,
          5:1 local windows of 512 and two global layers), mixtral-8x7b (2
          of 32), internlm2-20b (4 of 48: G = 6) and whisper-base (all 6 + 6:
          the encoder's non-causal hd-64 attention, the decoder's self- and
          cross-attention) training at full width through ``Trainer`` at 1
          PE and at 8 PEs as the launcher lays them out (MoE ep 8, the
          reorder on every all_to_all; RWKV6, phi3, internlm2 and whisper
          tp 8; gemma3 data 2 x tp 4), one cell's weights on the card at a
          time: bf16 over f32 masters, int8 moments, a warm-up and 3 timed
          steps of 4 x 1,024 tokens from TokenStream (ms/step, tok/s, mfu
          -- MoE's over active parameters --, peak memory, a profile of
          one step with the backward kernels' shares and each pass's
          device ms); exact launches a step (``_mr_expected``: flash 2 L /
          L, reorder 6 L at ep 8, RWKV6 2 L / L); one batch repeated 5
          steps at 1 PE: the loss falls; f32 (TF32 off) at 2 x 256 tokens
          and full width, RWKV6 at 4 layers (1 PE, tp 8), qwen2-moe at 2
          (ep 8), phi3 at 4 (1 PE, tp 8), gemma3 at 6 (1 PE, data 2 x tp
          4: five local layers and a global one), mixtral at 2 (ep 8),
          internlm2 at 2 and whisper at full depth (1 PE, tp 8):
          the synced gradients against the witness (every kernel's plain
          version in its place: autograd of index_select, of the plain
          attention and of the plain recurrence) within 1e-4 x each leaf's
          own max, MoE within the larger of that and twice the spread of
          two witness runs; controls: the flash backward's gradients
          zeroed and its dq scaled by 0.9 (every arch with attention), the
          RWKV6 backward with dlogw zeroed and the reorder's backward with
          the identity must fail it, the reorder's with perm in place of
          its inverse too unless every perm it ran is its own inverse. The
          inputs of each bf16 cell's last launch of every kernel of its
          path are kept: the flash forward (with row statistics) and
          backward; the reorder; RWKV6's forward (saving the sub-chunk
          states) and backward;
  serve_llava  llava-next-34b at full width (d_model 7,168, 56 / 8 heads
          of 128: G = 7) and LLAVA_SERVE_LAYERS = 12 of its 60 layers at 1
          and 8 PEs (tp 8), bf16: 4 prompts of its 2,880 patches (from the
          seed) and 128 text tokens through one ``prefill_shard``, then 15
          greedy decode steps; ``forward_logits`` of the served tokens and
          patches; the witness, the same serve with the flash kernel's
          plain version in its place, within RWKV_PATH_TOL x max(1,
          max|ref|) of the run at the steps whose inputs agree; decode vs
          forward and 1 vs 8 PEs reported beside SERVE_TOL; exact launches
          (flash: L a prefill, L a decode step, L a forward; reorder: L a
          prefill at 8 PEs, the K/V reshard); a decode profile;
  serve_jamba  jamba-1.5-large as one unit of 8 layers (7 Mamba, one
          attention with 64 / 8 heads of 128: G = 8; 4 MoE layers of 16
          experts top-2) at a cut width (JAMBA_SERVE: d_model 4,096, FFN
          12,288, expert capacity n_experts / top_k so that no choice
          drops) at 1 and 8 PEs (ep 8), bf16 and f32, through the
          launcher's loop: f32 decode within F32_TOL of forward_logits and
          1 vs 8 PEs within F32_TOL with identical greedy tokens; bf16
          against its witness within RWKV_PATH_TOL, decode vs forward
          reported; exact launches (flash one a step and forward; the
          reorder 2 x 4 a step and forward at 8 PEs); a decode profile;
  train_llava, train_jamba  llava at 6 of 60 layers (full width; batches
          of 2 x 4,096: 2,880 patches, then text) at 1 PE and tp 8, and
          jamba as one unit at d_model 2,048 / FFN 6,144 at 1 PE and ep 8,
          through ``Trainer`` as train_moe_rwkv's cells (``_train_cells``):
          exact launches a step, a falling loss on a repeated batch, the
          f32 witness cells with their controls (llava at 2 layers on 1 x
          3,072 tokens);
  checkpoint  ``repro_torch.checkpoint`` at qwen3-1.7b's full width and 4
          of its 28 layers (the checkpoint's bytes, the free bytes
          and host RAM where it goes, in the checkout's build/, printed
          before the first save, and two checkpoints must fit; keep_last=1;
          removed at the end).
          At 1 PE and at tp 8 (bf16, int8 moments, 4 x 1,024 tokens from
          TokenStream): steps 1-2 through ``Trainer`` with a topology-bound
          async manager saving at step 2, steps 3-4 behind the write (they
          must end before ``checkpoint-durable``; the save's blocking
          seconds, the seconds to durable, those steps' ms and
          ``ckpt.saved_bytes`` reported); two control runs of steps 3-4 from
          one in-memory clone of the step-2 state; restore of step 2 (every
          leaf bit for bit against the clone; seconds and
          ``ckpt.restored_bytes``); steps 3-4 resumed from it with a second
          save at step 4, whose gather programs come from the lower cache
          (lowered 2, then 0 and 2 hits). The step is deterministic (the
          embedding's backward sums in a fixed order): both controls and
          the resumed run must equal the uninterrupted run's losses and
          state bit for bit (where they do not, the gradients that differ
          between two backwards of one state are named). From the tp-8 checkpoint, params only onto the serve
          cube at 8 and 1 PEs: every leaf ``to_cube`` of the saved global
          arrays bit for bit, the ``ckpt-restore-params`` program traced,
          restore's and direct init's peak memory, and ``ServeEngine``
          lockstep on the launcher's 4 prompts (32 tokens, 16 greedy) from
          the restored and from the directly placed weights: identical
          tokens, 14 flash launches a step; at 8 PEs one ``prefill_shard``
          of the prompts against the loop (the serve_prefill bound, 14
          flash and 14 reorder launches). HF: the trained masters through
          ``export_state_dict`` into an F32 ``model.safetensors``, read
          back and imported onto the 8-PE serve cube by
          ``import_checkpoint`` (the ``hf-import`` program): bit for bit but
          the norms (1 + w in the file), within 2^-24; export, write, read
          and import seconds;
  lowp    the reference's low-precision modes (LOWP) on qwen3-1.7b at full
          width, the train cell's 14 layers, 1 PE: four train steps at
          mode 1 and four at mode 2 (finite losses; per step 2L forward
          launches, every one in the mode, and L backward launches), then
          a 512-token forward and prefill at mode 2 held to the same paths
          on the plain attention in mode 2 (SERVE_TOL); the mode is reset
          after. The kernel phase holds the bf16 forms in modes 1 and 2
          (decode and forward, full, partial and row statistics) to their
          plain versions on every FLASH_CASES row within 2e-2 of max(1,
          max|plain|); since that limit cannot tell the modes apart, it
          also holds the row statistics m and l per form within
          LOWP_STAT_TOL of the plain version in the same mode while the
          plain version in the mode below (the control) must fall outside
          it, and mode 2's rounded p in the forward form by acc = l on
          v = 1 (LOWP_P_TOL, mode 1 the control); mode 0 asked for by name
          bit for bit against the launch with no mode; and it times mode 2
          (and mode 1) at qwen3's
          training shape and the 2,048-token prefill beside mode 0, SDPA
          and the bound (LOWP_ROWS);
  dryrun  ``launch.dryrun`` on the meta device: qwen3-1.7b's train_4k,
          prefill_32k and decode_32k on the 256-PE cube and train_4k on
          512 PEs (per-PE argument and temp bytes, TFLOPs, collective
          bytes, trace seconds; no planner drift), and the dry run of the
          train cell's and the 1-PE serve cell's topology and batch, whose
          per-PE argument bytes must equal the bytes those cells hold on
          the card, exactly (the meta peak printed beside the card's
          max_memory_allocated of one step, ungated);
  main_path  each kernel on the inputs the serve, serve_mixtral,
          serve_prefill, serve_llava, serve_jamba, fused_forward, train,
          train_moe_rwkv, train_llava, train_jamba and apps phases kept
          (the G = 7 and G = 8 rows, llava's and jamba's, also listed
          apart in the kernels line's ``group_rows``; the
          shapes and positions the path gives it; for
          DLRM's AA(xyz), whose blocks repeat across the PEs, a random
          tensor of that shape): checked
          against the plain version, then timed with the plain version, the
          bound, and one PyTorch call as the library yardstick (SDPA for
          flash attention -- for a partial launch it computes the output
          only; ``is_causal`` where the mask is the aligned causal
          triangle --, autograd of SDPA for the backward, index_select for
          the reorder; none computes the RWKV6 recurrence), which the port
          never calls. The backward's dq, dk and dv are each held within
          FLASH_BWD_TOL of their own max|plain| (no floor at 1: a training
          step's gradients lie far below 1), on the step's own do and on a
          unit-scale do drawn from randn; the RWKV6 backward's outputs
          within RWKV6_TOL of their own max|plain| the same way; the RWKV6
          forward that saves the states on o and the final state within
          RWKV6_TOL and on the states within RWKV6_STATES_TOL of max(1,
          max|plain|). Every training layout's rows must be there: the
          flash forward and backward at qwen3's three and at qwen2-moe's,
          phi3's, gemma3's and mixtral's two, the RWKV6 forward with
          states and backward at rwkv6's two; the reorder at mixtral's
          8-PE decode and train step too. The
          RWKV6 backward's bound counts the function's bytes (its inputs
          and gradients); the design's own traffic (the saved states
          read, pass 1's chunk-end gradients written and read, the du
          scratch) is reported beside it, and each pass's device ms beside
          the call's.

Then the card's name and power limit, the kernels' JSON line, and as the
last line ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero without that line; so does a machine without CUDA, or a directory
that holds this script and nothing else of the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen3-1.7b"
MOE_ARCH = "qwen2-moe-a2.7b"
BATCH, PROMPT, GEN = 4, 32, 16
PES = (1, 8)
KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SERVE_TOL = 5e-2            # bf16 decode vs forward, x max(1, max|ref|)
F32_TOL = 1e-4              # f32 1-PE vs 8-PE logits, x max(1, max|ref|)
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s by the
# inputs' type (f32 runs outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TPU_KERNEL = "src/repro/kernels/attention/flash.py:115"
KERNEL_SOURCE = "src/repro_torch/kernels/attention/csrc/flash.cu"
REORDER_TPU_KERNEL = "src/repro/kernels/reorder/reorder.py:46"
REORDER_SOURCE = "src/repro_torch/kernels/reorder/csrc/reorder.cu"
RWKV_ARCH = "rwkv6-7b"
# Depth cuts of earlier paths for the run's 1,200 s limit, made when the
# llava and jamba phases came in: rwkv6 serves at 16 of its 32 layers,
# qwen2-moe at 12 of 24, qwen3's int8-cache and training phases at 14 of
# 28; each phase's gates compare runs on the same weights and count
# launches by the layer, and their steps take time by the layer
RWKV_SERVE_LAYERS = 16
MOE_SERVE_LAYERS = 12
INT8_LAYERS = 14
TRAIN_LAYERS = 14
# the dense archs with head dims 96 and 256, and the PE counts each serves
# at (gemma3's 4 query heads bound its head parallelism at 4)
DENSE_ARCHS = {"phi3-mini-3.8b": (1, 8), "gemma3-1b": (1, 4)}
# their serving depth: a quarter of phi3's 32 layers and half of gemma3's
# 26 (two global layers; the last, as at 26, a local one), to keep the run
# under its limit: the host-bound steps take time by the layer, and the
# gates compare runs on the same weights (decode vs forward, 1 vs n PEs)
DENSE_SERVE_LAYERS = {"phi3-mini-3.8b": 8, "gemma3-1b": 13}
LONG_ARCH, LONG_SEQ = "gemma3-1b", 1024   # a forward past the 512 window
# RWKV6 kernel vs its plain version, x max(1, max|plain|), on o and state
RWKV6_TOL = {torch.float32: 5e-4, torch.bfloat16: 5e-2}
# rwkv6-7b's forward and prefill with the kernel against the same paths
# with its plain version in its place, x max(1, max|ref|); bf16 rounding
# flips alone move the bf16 model by about 0.12 of max over 32 layers
RWKV_PATH_TOL = {torch.float32: F32_TOL, torch.bfloat16: 0.25}
# f32 prefill (last logits, cache) against the teacher-forced loop's,
# x max(1, max|ref|): the chunked form and the one-token steps round apart
# by up to 1.2e-4 of max at 8 PEs, on the plain version as on the kernel
RWKV_LOOP_F32_TOL = 2e-4
RWKV6_TPU_KERNEL = "src/repro/kernels/rwkv6/rwkv6.py:73"
# the JAX package has no Pallas backward: its train step differentiates the
# jnp chunked_attention; the backward kernel takes that autodiff's place
FLASH_BWD_SOURCE = "src/repro_torch/kernels/attention/csrc/flash_bwd.cu"
FLASH_BWD_REPLACES = "src/repro/models/layers.py:109"
RWKV6_SOURCE = "src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu"
# the kernel's final state against the one-token recurrence in f64, x
# max(1, max|f64|), in both types: its products keep f32 arithmetic by
# splitting operands into three bf16 pieces. Over RWKV6_CASES on an H100,
# three pieces read at most 1.5e-6, two pieces up to
# 4.4e-6 in bf16 and 1.4e-5 in f32 (tools/rwkv6_pieces.py)
RWKV6_STATE_TOL = 2.5e-6
# the forward kernel's states saved every 64 steps against
# ``ref.chunk_states``, x max(1, max|plain|)
RWKV6_STATES_TOL = 1e-5
# the serving engine: page size (S_loc = 48 / 8 = 6 at 8 PEs), the pool of
# the preemption run (pages per shard), and a bound on any run's steps
ENGINE_PAGE, ENGINE_TIGHT, ENGINE_MAX_STEPS = 3, 4, 400
# The engine's cells run qwen3 at 3 of its 28 layers: their gates
# compare runs on the same weights (the launcher's tokens, batching
# invariance, preemption), and their host-bound steps take time by the
# layer; the full-depth decode path is the serve phase's. At 28 layers the
# engine took 133 s of the run's 1,200 s limit, at 14 67 s, at 7 37.5 s.
ENGINE_LAYERS = 3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ------------------------------------------------------------------ timing
def time_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, replayed ``iters`` times between CUDA events (no host launch
    gaps)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


# ------------------------------------------------------------------- build
def phase_build() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    report = {name: [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln
                     or "Compiling entry" in ln] or [log.strip()]
              for name, log in logs.items()}
    # each library's nvcc wall seconds, all started together
    nvcc_s = {name: float(ln.split(":")[1]) for name, log in logs.items()
              for ln in log.splitlines()
              if ln.startswith("nvcc wall seconds:")}
    # the entry functions whose ptxas report shows a spill
    spilling = []
    for name, lines in report.items():
        entry = None
        for ln in lines:
            if "Compiling entry" in ln:
                entry = ln.split("'")[1] if "'" in ln else ln
            elif "spill" in ln and not ln.startswith("0 bytes stack frame, "
                                                      "0 bytes spill stores"):
                spilling.append([name, entry, ln])
    return {"seconds": round(time.perf_counter() - t0, 3),
            "libraries": sorted(logs), "nvcc_seconds": nvcc_s,
            "spilling": spilling, "ptxas": report}


# ------------------------------------------------------------------ kernel
def _attn_inputs(gen, dtype, B, Sq, Sk, H, KV, hd, dev):
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    return q, k, v


def _compare(got, want, partial) -> float:
    """Largest |kernel - plain| over max(1, max|plain|), per output."""
    pairs = zip(got, want) if partial else [(got, want)]
    worst = 0.0
    for g, w in pairs:
        g, w = g.float(), w.float()
        scale = max(1.0, float(w.abs().max()))
        worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def _bound(q, k, q_pos, k_pos, causal, window, partial,
           stats: bool = False) -> dict:
    """Least time the card could take: each input byte read once, each
    output byte written once, over HBM rate; 4 * hd FLOPs per visible
    (query head, key) pair of this run's positions, over the peak for the
    inputs' type. The larger of the two. ``stats``: the output and the
    f32 row statistics (m, l) are written."""
    from repro_torch.kernels.attention import ref
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    es = q.element_size()
    read = es * (q.numel() + 2 * k.numel()) + 4 * (q_pos.numel()
                                                    + k_pos.numel())
    write = 4 * B * H * Sq * (hd + 2) if partial else es * q.numel()
    if stats:
        write += 8 * B * H * Sq
    visible = int(ref.mask(q_pos, k_pos, causal, window).sum())
    flops = 4 * hd * H * visible
    t_bytes = (read + write) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": read + write, "flops": flops}


def _sdpa_forms(q_pos, k_pos, causal, window) -> dict:
    """SDPA's mask arguments that compute the kernel's mask, by name: the
    boolean mask, and ``is_causal`` as well where the mask is exactly the
    top-left causal triangle on every row (a training or prefill step's
    aligned positions)."""
    from repro_torch.kernels.attention import ref
    mask = ref.mask(q_pos, k_pos, causal, window)[:, None]
    forms = {"attn_mask": {"attn_mask": mask}}
    tri = torch.ones(mask.shape[-2:], dtype=torch.bool,
                     device=mask.device).tril()
    if bool((mask == tri).all()):
        forms["is_causal"] = {"is_causal": True}
    return forms


def _sdpa(q, k, v, form: dict):
    """One PyTorch call computing the normalized function (timed only)."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, **form)


def _library_ms(timer, make, q_pos, k_pos, causal, window) -> tuple:
    """The library yardstick: the fastest of SDPA's forms of the mask, each
    ``make(form)`` timed by ``timer``; and the form that set it."""
    times = {name: timer(make(form)) for name, form
             in _sdpa_forms(q_pos, k_pos, causal, window).items()}
    best = min(times, key=times.get)
    return times[best], best


# flash correctness sweep: B, Sq, Sk, H, KV, hd, causal, window, q0, k0,
# partial, shards (row r holds cache shard r). Both forms: decode (Sq * G
# <= 8 rows per kv head) and forward (bf16 on tensor cores, 16-64-row
# tiles of 64 keys; f32 on CUDA cores, 32-row tiles of 32 keys)
FLASH_CASES = [
    (2, 64, 64, 8, 2, 128, True, -1, 0, 0, False, False),
    (2, 40, 72, 8, 2, 128, True, 24, 48, 16, False, False),
    (1, 33, 33, 4, 4, 64, False, -1, 0, 0, False, False),
    (3, 16, 16, 4, 2, 16, True, 5, 0, 0, False, False),
    (8, 1, 6, 16, 8, 128, True, -1, 3, 0, True, True),   # rows 1-7 masked
    (4, 1, 48, 16, 8, 128, True, 8, 20, -4, True, False),  # rolling slots
    # no GQA (H == KV), as qwen2-moe decodes: 1 PE, and 8 PEs' shards
    (4, 1, 48, 16, 16, 128, True, -1, 30, 0, True, False),
    (32, 1, 6, 2, 2, 128, True, -1, 40, 0, True, True),  # rows 7-31 masked
    # forward: Sq * G off the row tile and across its edge, Sk off the key
    # tile, G = 1 and G = 8, every head_dim on the tensor cores
    (2, 37, 70, 8, 1, 32, True, -1, 40, 0, False, False),   # G = 8
    (2, 37, 70, 8, 1, 32, True, -1, 40, 0, True, False),
    (1, 9, 65, 8, 8, 128, True, -1, 56, 0, False, False),   # G = 1, 9 rows
    (3, 50, 130, 4, 2, 16, True, 40, 80, 0, False, False),
    (2, 70, 100, 6, 3, 64, False, -1, 0, 0, True, False),
    (2, 24, 24, 16, 8, 32, True, -1, 0, 0, False, False),
    # rows that see no key at all (positions 90-99 before k_pos 100): they
    # average v; with tiles skipped for the rows that do see keys
    (2, 30, 200, 4, 2, 64, True, -1, 90, 100, False, False),
    (2, 30, 200, 4, 2, 64, True, -1, 90, 100, True, False),
    # long causal forwards: tiles above the diagonal / outside the window
    (1, 512, 512, 4, 2, 128, True, -1, 0, 0, False, False),
    (1, 512, 512, 4, 2, 128, True, 100, 0, 0, False, False),
    # decode form: G = 8, 6 rows (Sq 3 x G 2), keys over a 2-CTA cluster,
    # and a 4096-key cache over 8-CTA clusters with a window
    (4, 1, 40, 8, 1, 64, True, -1, 39, 0, True, False),
    (1, 3, 300, 4, 2, 64, True, -1, 290, 0, True, False),
    (2, 1, 600, 16, 8, 128, True, -1, 599, 0, True, False),
    (1, 1, 4096, 16, 8, 128, True, 1000, 4095, 0, False, False),
    # internlm2's G = 6 (48 / 8 heads; 6 / 1 a PE at tp 8): 1,024 causal
    # tokens in the forward, 6 rows a kv head in the decode form (one
    # PE's cache, and the 16-PE serve cube's 3-slot shards)
    (1, 1024, 1024, 48, 8, 128, True, -1, 0, 0, False, False),
    (4, 1024, 1024, 6, 1, 128, True, -1, 0, 0, False, False),
    (4, 1, 48, 48, 8, 128, True, -1, 47, 0, True, False),
    (64, 1, 3, 48, 8, 128, True, -1, 40, 0, True, True),
    # whisper's encoder (hd 64, G = 1, non-causal, Sq = Sk = 1,024), its
    # cross-attention (non-causal, Sq != Sk), and the cross decode (the
    # decode form, non-causal, every key valid)
    (4, 1024, 1024, 8, 8, 64, False, -1, 0, 0, False, False),
    (4, 48, 1024, 8, 8, 64, False, -1, 0, 0, False, False),
    (4, 1, 48, 8, 8, 64, False, -1, 20, 0, True, False),
    (4, 1, 1500, 8, 8, 64, False, -1, 20, 0, True, False),
]
# head dims 96 (phi3-mini: 12 bf16 / 24 f32 pieces a key, padded lane
# groups) and 256 (gemma3: Q in shared memory in the bf16 forward, two
# pieces a lane in the f32 decode, warp partials in dynamic shared memory)
for _hd in (96, 256):
    FLASH_CASES += [
        # decode, G = 1 at 1, 2, 4 and 8 rows; G = 4 at 4 and 8 rows
        (4, 1, 48, 8, 8, _hd, True, -1, 47, 0, True, False),
        (2, 2, 40, 4, 4, _hd, True, -1, 38, 0, False, False),
        (2, 4, 33, 2, 2, _hd, True, 16, 29, 0, True, False),
        (1, 8, 70, 2, 2, _hd, True, -1, 62, 0, False, False),
        (4, 1, 48, 4, 1, _hd, True, -1, 47, 0, True, False),
        (2, 2, 600, 8, 2, _hd, True, 512, 598, 0, False, False),  # 2-CTA
        # a sequence-sharded partial decode: shards 4-7 see no key
        (8, 1, 6, 4, 1, _hd, True, -1, 20, 0, True, True),
        # a long windowed cache over an 8-CTA cluster
        (1, 1, 4096, 4, 1, _hd, True, 512, 4095, 0, True, False),
        # forward: causal 512 with window 128 (skips tiles), G = 4
        (1, 512, 512, 4, 1, _hd, True, 128, 0, 0, False, False),
        # rows that see no key, with tiles skipped for the others
        (2, 30, 200, 4, 2, _hd, True, -1, 90, 100, False, False),
        (2, 30, 200, 4, 2, _hd, True, -1, 90, 100, True, False),
        # G = 1 rows off the tile; non-causal partial with G = 4
        (2, 37, 70, 4, 4, _hd, True, -1, 40, 0, False, False),
        (1, 33, 65, 4, 1, _hd, False, -1, 0, 0, True, False),
        # CTAs of 4 and of 2 warps (64- and 32-row tiles), keys off the tile
        (4, 256, 300, 16, 8, _hd, True, -1, 44, 0, False, False),
        (2, 144, 150, 16, 8, _hd, True, 100, 6, 0, True, False),
    ]
# off the main path, timed beside it: a long cache at decode (bytes) and a
# long causal forward (operations); B, Sq, Sk, H, KV, partial
FLASH_LONG_ROWS = {"long_decode": (4, 1, 4096, 16, 8, True),
                   "long_forward": (4, 2048, 2048, 16, 8, False)}


def _case_positions(B, Sq, Sk, q0, k0, shards, dev) -> tuple:
    """A FLASH_CASES row's int32 positions: aligned runs from q0 / k0, or
    (``shards``) one query at q0 against batch row r's key shard r."""
    if shards:
        q_pos = torch.full((B, 1), q0, device=dev)
        k_pos = (torch.arange(B, device=dev)[:, None] * Sk
                 + torch.arange(Sk, device=dev))
    else:
        q_pos = (q0 + torch.arange(Sq, device=dev)).expand(B, -1)
        k_pos = (k0 + torch.arange(Sk, device=dev)).expand(B, -1)
    return tuple(p.to(torch.int32).contiguous() for p in (q_pos, k_pos))


def _dead_rows_ok(got, v, dead, partial: bool, tol: float) -> bool:
    """Rows that see no key (``dead``, (B, Sq)) hold m = -1e30 and l = Sk
    (partial), or the mean of v over all Sk keys within ``tol`` (full)."""
    if partial:
        m, l = (t.transpose(1, 2)[dead] for t in got[1:])
        return bool((m == -1e30).all() and (l == v.shape[1]).all())
    if not bool(dead.any()):
        return True
    B, Sq, H, hd = got.shape
    mean_v = v.float().mean(1).repeat_interleave(H // v.shape[2], dim=1)
    mean_v = mean_v[:, None].expand(B, Sq, H, hd)[dead]
    return float((got.float()[dead] - mean_v).abs().max()) <= tol


def _flash_checks(dev) -> dict:
    """The flash kernel against its plain version on FLASH_CASES, f32 and
    bf16. Rows that see no key must give m = -1e30 and l = Sk (partial)
    or the mean of v (full)."""
    from repro_torch.kernels.attention import flash, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checks, ok_all = [], True
    for dtype in (torch.float32, torch.bfloat16):
        for (B, Sq, Sk, H, KV, hd, causal, window, q0, k0, partial,
             shards) in FLASH_CASES:
            q, k, v = _attn_inputs(gen, dtype, B, Sq, Sk, H, KV, hd, dev)
            q_pos, k_pos = _case_positions(B, Sq, Sk, q0, k0, shards, dev)
            kw = dict(causal=causal, window=window, partial=partial)
            got = flash.flash_attention(q, k, v, q_pos, k_pos, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention(q, k, v, q_pos, k_pos, **kw)
            err = _compare(got, want, partial)
            dead = ~ref.mask(q_pos, k_pos, causal, window).expand(
                B, Sq, Sk).any(-1)                     # rows seeing no key
            ok = (err <= KERNEL_TOL[dtype]
                  and _dead_rows_ok(got, v, dead, partial, KERNEL_TOL[dtype]))
            ok_all &= ok
            geo = flash.launch_geometry(B, Sq, Sk, H, KV, hd, dtype)
            checks.append({"dtype": str(dtype).split(".")[-1],
                           "shape": [B, Sq, Sk, H, KV, hd], "causal": causal,
                           "partial": partial, "window": window,
                           "form": geo.form, "grid": list(geo.grid),
                           "rows_without_key": int(dead.sum()),
                           "err": err, "ok": ok})
    return {"ok": ok_all, "checks": checks}


def _flash_long_rows(dev) -> list:
    """The two long rows off the main path, bf16, checked then timed with
    the plain version, the bound and SDPA."""
    from repro_torch.kernels.attention import flash, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    for name, (B, Sq, Sk, H, KV, partial) in FLASH_LONG_ROWS.items():
        q, k, v = _attn_inputs(gen, torch.bfloat16, B, Sq, Sk, H, KV, 128,
                               dev)
        q_pos = (Sk - Sq + torch.arange(Sq, device=dev)).expand(B, -1)
        k_pos = torch.arange(Sk, device=dev).expand(B, -1)
        q_pos, k_pos = (p.to(torch.int32).contiguous() for p in (q_pos, k_pos))
        kw = dict(causal=True, window=-1, partial=partial)
        got = flash.flash_attention(q, k, v, q_pos, k_pos, **kw)
        want = ref.flash_attention(q, k, v, q_pos, k_pos, **kw)
        torch.cuda.synchronize()
        err = _compare(got, want, partial)
        del got, want
        rows.append({
            "name": name, "q": [B, Sq, H, 128], "kv": [B, Sk, KV, 128],
            "partial": partial, "err": err,
            "ok": err <= KERNEL_TOL[torch.bfloat16],
            "ms": time_ms(lambda: flash.flash_attention(q, k, v, q_pos, k_pos,
                                                        **kw)),
            "plain_ms": time_ms(lambda: ref.flash_attention(
                q, k, v, q_pos, k_pos, **kw), reps=2, iters=5),
            "library_ms": _library_ms(
                time_ms, lambda f: _sdpa(q, k, v, f), q_pos, k_pos, True,
                -1)[0],
            **_bound(q, k, q_pos, k_pos, True, -1, partial)})
        torch.cuda.empty_cache()
    return rows


def _stats_err(got, want) -> float:
    """(out, m, l) of a row-statistics launch against the plain version's:
    out and l over max(1, max|plain|), m on the rows that see a key (the
    others must hold -1e30 exactly: each such row adds 1)."""
    live = want[1] > -1e29
    m_err = (_compare(got[1][live], want[1][live], False)
             if bool(live.any()) else 0.0)
    m_err += float((got[1][~live] != -1e30).sum())
    return max(_compare(got[0], want[0], False), m_err,
               _compare(got[2], want[2], False))


# The row statistics of a mode-1 / 2 launch on the rows that see a key,
# as means over every FLASH_CASES row of one form (and over each LOWP_ROWS
# shape): m's |m - m_plain| / max(1, |m_plain|) and l's |l - l_plain| /
# l_plain. Against the plain version in the same mode they must lie within
# LOWP_STAT_TOL; against the plain version in LOWP_CONTROL's mode (the mode
# below, whose m and l lack the roundings this mode adds: 1 scales q in
# bf16, 2 rounds the scores and p to bf16) the same comparison must fail,
# which shows the tolerance tells the modes apart. The output alone does
# not: at bf16's 2e-2 a kernel that ignored the mode would pass. At hd 16,
# 64 and 256 the scale is a power of two, mode 1's q rounding is exact and
# its m and l are mode 0's, so mode 1's control pools hd 32, 96 and 128.
LOWP_STAT_TOL = {1: {"m": 1e-5, "l": 1e-4}, 2: {"m": 1e-5, "l": 1e-3}}
LOWP_CONTROL = {1: 0, 2: 1}
# Mode 2's p in the tensor-core forward: with v = 1 a partial launch's
# acc[..., 0] sums the p that l sums, rounded to bf16 for the mma. Mode 2
# rounds p before both sums, so the two agree to f32 order; modes 0 and 1
# round it for the mma alone, so they do not. Held as the mean over the
# rows that see a key of |acc[..., 0] - l| / l: mode 2 within LOWP_P_TOL,
# mode 1 (the control) beyond it. The decode form sums p unrounded in
# modes 0 and 2 alike, so this tells nothing there.
LOWP_P_TOL = 1e-5


def _stat_sums(got, want, control: bool = False) -> dict:
    """The rows that see a key and m's and l's deviations summed over them,
    of a partial or row-statistics launch ``got`` from ``want``: keys rows,
    m, l, or with ``control`` control_rows, m_control, l_control."""
    live = want[1] > -1e29
    m, l, mw, lw = got[1][live], got[2][live], want[1][live], want[2][live]
    tag = "_control" if control else ""
    return {"control_rows" if control else "rows": int(live.sum()),
            f"m{tag}": float(((m - mw).abs() / mw.abs().clamp_min(1)).sum()),
            f"l{tag}": float(((l - lw).abs() / lw).sum())}


def _p_sum_dev(got) -> tuple:
    """(rows that see a key, |acc[..., 0] - l| / l summed over them) of a
    partial launch on v = 1."""
    acc, m, l = got
    live = m > -1e29
    return int(live.sum()), float(((acc[..., 0] - l).abs() / l)[live].sum())


def _control_pooled(mode: int, hd: int) -> bool:
    """Whether the plain version in LOWP_CONTROL[mode] differs from mode
    ``mode``'s in m and l at head dim ``hd``: always at mode 2; at mode 1
    where hd ** -0.5 is not a power of two."""
    return mode == 2 or math.log2(hd) % 2 != 0


def _stat_verdict(mode: int, sums: dict) -> dict:
    """The means of ``sums`` (keys rows, m, l and control_rows, m_control,
    l_control) held to LOWP_STAT_TOL[mode]: the same mode within it, the
    control beyond it."""
    tol = LOWP_STAT_TOL[mode]
    dev = {s: sums[s] / max(1, sums["rows"]) for s in ("m", "l")}
    ctrl = {s: sums[f"{s}_control"] / max(1, sums["control_rows"])
            for s in ("m", "l")}
    ok = (sums["rows"] > 0 and sums["control_rows"] > 0
          and all(dev[s] <= tol[s] < ctrl[s] for s in ("m", "l")))
    return {"rows": sums["rows"], "dev": dev,
            "control_mode": LOWP_CONTROL[mode],
            "control_rows": sums["control_rows"], "control_dev": ctrl,
            "tol": tol, "ok": ok}


def _lowp_checks(dev) -> dict:
    """The bf16 forms in the low-precision modes (lowp 1 and 2, the
    reference's LOWP) against the plain version in the same mode on every
    FLASH_CASES row -- the decode and the tensor-core forward, full and
    partial, and each full row again with the row statistics the training
    forward writes (a partial launch in the decode form) -- within
    KERNEL_TOL (bf16) of max(1, max|plain|), and their row statistics per
    form within LOWP_STAT_TOL, beyond it against the control mode; mode
    2's p in the forward form by LOWP_P_TOL. Rows
    that see no key give m = -1e30 and l = Sk (partial) or the mean of v
    (full), as in mode 0. Mode 0 asked for by name is the launch with no
    mode, bit for bit."""
    from repro_torch.kernels.attention import flash, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    tol = KERNEL_TOL[torch.bfloat16]
    checks, ok_all, pools, p_sums = [], True, {}, {1: [0, 0.0], 2: [0, 0.0]}
    for (B, Sq, Sk, H, KV, hd, causal, window, q0, k0, partial,
         shards) in FLASH_CASES:
        q, k, v = _attn_inputs(gen, torch.bfloat16, B, Sq, Sk, H, KV, hd,
                               dev)
        q_pos, k_pos = _case_positions(B, Sq, Sk, q0, k0, shards, dev)
        kw = dict(causal=causal, window=window, partial=partial)
        base = flash.flash_attention(q, k, v, q_pos, k_pos, **kw)
        zero = flash.flash_attention(q, k, v, q_pos, k_pos, lowp=0, **kw)
        pairs = zip(base, zero) if partial else [(base, zero)]
        same0 = all(torch.equal(_bits(a), _bits(b)) for a, b in pairs)
        dead = ~ref.mask(q_pos, k_pos, causal, window).expand(
            B, Sq, Sk).any(-1)
        row = {"shape": [B, Sq, Sk, H, KV, hd], "causal": causal,
               "window": window, "partial": partial,
               "form": flash.launch_geometry(B, Sq, Sk, H, KV, hd,
                                             torch.bfloat16).form,
               "rows_without_key": int(dead.sum()),
               "mode0_bit_identical": same0}
        # the launch that gives the row statistics: the check's own when
        # partial, else one with the statistics (forward) or partial
        kind = ({} if partial else {"stats": True}
                if row["form"] == "forward" else {"partial": True})
        ok = same0
        for mode in (1, 2):
            got = flash.flash_attention(q, k, v, q_pos, k_pos, lowp=mode,
                                        **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention(q, k, v, q_pos, k_pos, lowp=mode,
                                       **kw)
            err = _compare(got, want, partial)
            good = err <= tol and _dead_rows_ok(got, v, dead, partial, tol)
            row[f"lowp{mode}_err"] = err
            st, st_want = got, want
            if kind:
                kw_st = dict(causal=causal, window=window, **kind)
                st = flash.flash_attention(q, k, v, q_pos, k_pos, lowp=mode,
                                           **kw_st)
                st_want = ref.flash_attention(q, k, v, q_pos, k_pos,
                                              lowp=mode, **kw_st)
            if "stats" in kind:
                row[f"lowp{mode}_stats_err"] = _stats_err(st, st_want)
                good = (good and row[f"lowp{mode}_stats_err"] <= tol
                        and torch.equal(st[0], got))
            pool = pools.setdefault((mode, row["form"]), dict.fromkeys(
                ("rows", "m", "l", "control_rows", "m_control",
                 "l_control"), 0))
            sums = _stat_sums(st, st_want)
            if _control_pooled(mode, hd):
                control = ref.flash_attention(
                    q, k, v, q_pos, k_pos, lowp=LOWP_CONTROL[mode],
                    causal=causal, window=window,
                    **(kind or {"partial": True}))
                sums.update(_stat_sums(st, control, control=True))
            for key, x in sums.items():
                pool[key] += x
            ok = ok and good
        if row["form"] == "forward":
            ones = torch.ones_like(v)
            for mode in (1, 2):
                n, dev_sum = _p_sum_dev(flash.flash_attention(
                    q, k, ones, q_pos, k_pos, causal=causal, window=window,
                    partial=True, lowp=mode))
                p_sums[mode][0] += n
                p_sums[mode][1] += dev_sum
        row["ok"] = ok
        ok_all &= ok
        checks.append(row)
    stats = {f"lowp{mode}/{form}": _stat_verdict(mode, sums)
             for (mode, form), sums in sorted(pools.items())}
    p_dev = {mode: x / max(1, n) for mode, (n, x) in p_sums.items()}
    p_check = {"rows": p_sums[2][0], "dev": p_dev[2],
               "control_mode": 1, "control_dev": p_dev[1],
               "tol": LOWP_P_TOL,
               "ok": p_sums[2][0] > 0 and p_dev[2] <= LOWP_P_TOL < p_dev[1]}
    ok_all &= all(s["ok"] for s in stats.values()) and p_check["ok"]
    return {"ok": ok_all, "tol": tol, "cases": len(checks),
            "row_stats": stats, "p_rounding": p_check, "checks": checks}


# the LOWP 2 forward timed beside mode 0, SDPA and the bound: qwen3's
# 1-PE training shape (with the row statistics the backward reads; mode 1
# too) and the 2,048-token prefill; B, Sq, H, KV, stats, modes
LOWP_ROWS = {"train_forward": (4, 1024, 16, 8, True, (0, 1, 2)),
             "prefill_2048": (4, 2048, 16, 8, False, (0, 2))}


def _lowp_rows(dev) -> list:
    """Each LOWP_ROWS shape at hd 128, causal: per mode, the kernel's ms,
    the plain version's in the same mode, SDPA (one call, bf16; it takes
    no mode) and the bound (the same bytes and operations in every
    mode); the error of a row-statistics launch against the plain version
    in the same mode, and in modes 1 / 2 its row statistics within
    LOWP_STAT_TOL, beyond it against the control mode."""
    from repro_torch.kernels.attention import flash, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    rows = []
    for name, (B, S, H, KV, stats, modes) in LOWP_ROWS.items():
        q, k, v = _attn_inputs(gen, torch.bfloat16, B, S, S, H, KV, 128, dev)
        pos = torch.arange(S, device=dev, dtype=torch.int32).expand(
            B, -1).contiguous()
        kw = dict(causal=True, window=-1, stats=stats)
        library_ms = _library_ms(time_ms, lambda f: _sdpa(q, k, v, f), pos,
                                 pos, True, -1)[0]
        bound = _bound(q, k, pos, pos, True, -1, False, stats=stats)
        for mode in modes:
            kw_st = dict(causal=True, window=-1, stats=True)
            got = flash.flash_attention(q, k, v, pos, pos, lowp=mode,
                                        **kw_st)
            want = ref.flash_attention(q, k, v, pos, pos, lowp=mode, **kw_st)
            torch.cuda.synchronize()
            err = _stats_err(got, want)
            ok = err <= KERNEL_TOL[torch.bfloat16]
            row_stats = None
            if mode:
                control = ref.flash_attention(
                    q, k, v, pos, pos, lowp=LOWP_CONTROL[mode], **kw_st)
                row_stats = _stat_verdict(mode, {
                    **_stat_sums(got, want),
                    **_stat_sums(got, control, control=True)})
                ok = ok and row_stats["ok"]
                del control
            del got, want
            rows.append({
                "name": f"{name}/lowp{mode}", "mode": mode,
                "q": [B, S, H, 128], "kv": [B, S, KV, 128], "stats": stats,
                "err": err, "row_stats": row_stats, "ok": ok,
                "ms": time_ms(lambda: flash.flash_attention(
                    q, k, v, pos, pos, lowp=mode, **kw)),
                "plain_ms": time_ms(lambda: ref.flash_attention(
                    q, k, v, pos, pos, lowp=mode, **kw), reps=2, iters=5),
                "library_ms": library_ms, **bound})
            torch.cuda.empty_cache()
    return rows


# flash backward sweep: B, Sq, Sk, H, KV, causal, window, q0, k0, hd.
# At hd 128: G = 1, 2 and 8; causal and not; windows; offsets; Sq and Sk off
# the 64-row / 64-key tiles; rows that see no key (q0 < k0); a 512-token
# causal run that skips tiles; a 3-row query (the forward's decode form);
# qwen3's 1-PE training shape (4 x 1,024 causal tokens, 16 query and 8 kv
# heads); G * Sq and Sk off the bf16 passes' CTA tiles (64 or 128 rows /
# keys) and their 64-key / 64-row ring stages, with 4-warp CTAs in both
# passes (2 x 200 x 8 / 4) and 8-warp ones (16 x 300 x 8 / 4: 600 rows, 300
# keys); a key tile that straddles the causal diagonal (q0 = 37) in both
# passes. At every other head dim the same kinds at smaller sizes (G = 1, 2
# and 4, full, windowed with offsets, rows with no key, ragged 4-warp
# tiles), and the training shapes of the archs that have it: phi3-mini
# (hd 96) at 1 PE and tp 8; gemma3 (hd 256, one kv head) at 1 PE with its
# local window of 512 and its global causal mask, at data 2 x tp 4 (the 8
# PEs folded into the batch, one query head a PE), and a windowed G = 4
# case off the tiles.
FLASH_BWD_CASES = [
    (2, 64, 64, 8, 8, True, -1, 0, 0, 128),
    (2, 100, 100, 16, 8, True, -1, 0, 0, 128),
    (1, 37, 130, 8, 1, True, -1, 93, 0, 128),
    (2, 50, 70, 4, 2, False, -1, 0, 0, 128),
    (2, 96, 96, 8, 4, True, 24, 0, 0, 128),
    (1, 40, 72, 8, 2, True, 24, 48, 16, 128),
    (2, 24, 48, 4, 2, True, -1, 0, 16, 128),
    (1, 130, 257, 16, 8, True, -1, 127, 0, 128),
    (2, 512, 512, 16, 8, True, -1, 0, 0, 128),
    (2, 3, 40, 4, 2, True, -1, 37, 0, 128),
    (4, 1024, 1024, 16, 8, True, -1, 0, 0, 128),
    (2, 200, 333, 8, 4, True, -1, 0, 0, 128),
    (16, 300, 300, 8, 4, True, -1, 0, 0, 128),
    (2, 192, 229, 8, 2, True, -1, 37, 0, 128),
    *[c + (hd,) for hd in (16, 32, 64, 96, 256) for c in (
        (2, 100, 130, 8, 2, True, -1, 30, 0),
        (2, 37, 70, 4, 4, False, -1, 0, 0),
        (1, 40, 72, 8, 2, True, 24, 48, 16),
        (2, 24, 48, 4, 2, True, -1, 0, 16),
        (2, 200, 333, 8, 4, True, -1, 0, 0))],
    (4, 1024, 1024, 32, 32, True, -1, 0, 0, 96),
    (32, 1024, 1024, 4, 4, True, -1, 0, 0, 96),
    (4, 1024, 1024, 4, 1, True, 512, 0, 0, 256),
    (4, 1024, 1024, 4, 1, True, -1, 0, 0, 256),
    (16, 1024, 1024, 1, 1, True, 512, 0, 0, 256),
    (2, 300, 300, 4, 1, True, 64, 0, 0, 256),
    # internlm2's G = 6 at 1 PE (48 / 8 heads) and tp 8 (6 / 1)
    (1, 1024, 1024, 48, 8, True, -1, 0, 0, 128),
    (4, 1024, 1024, 6, 1, True, -1, 0, 0, 128),
    # whisper's encoder (non-causal, Sq = Sk = 1,024, G = 1) and its
    # cross-attention (non-causal, Sq != Sk) at hd 64
    (4, 1024, 1024, 8, 8, False, -1, 0, 0, 64),
    (2, 300, 1024, 8, 8, False, -1, 0, 0, 64),
]
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _flash_bwd_checks(dev) -> dict:
    """The backward kernel against ``ref.flash_attention_backward`` on dq,
    dk and dv (each within FLASH_BWD_TOL of its own max|plain|, no floor at
    1, as the main-path rows are held), both fed the kernel
    forward's output and row statistics (the statistics themselves held
    to the plain forward's); two launches on the same inputs must give the
    same bits."""
    from repro_torch.kernels.attention import flash, flash_bwd, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    checks, ok_all = [], True
    for dtype in (torch.float32, torch.bfloat16):
        for B, Sq, Sk, H, KV, causal, window, q0, k0, hd in FLASH_BWD_CASES:
            q, k, v = _attn_inputs(gen, dtype, B, Sq, Sk, H, KV, hd, dev)
            do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
            q_pos = (q0 + torch.arange(Sq, device=dev)).expand(B, -1)
            k_pos = (k0 + torch.arange(Sk, device=dev)).expand(B, -1)
            q_pos, k_pos = (p.to(torch.int32).contiguous()
                            for p in (q_pos, k_pos))
            kw = dict(causal=causal, window=window)
            o, m, l = flash.flash_attention(q, k, v, q_pos, k_pos,
                                            stats=True, **kw)
            plain_o, plain_m, plain_l = ref.flash_attention(
                q, k, v, q_pos, k_pos, stats=True, **kw)
            base = flash.flash_attention(q, k, v, q_pos, k_pos, **kw)
            got = flash_bwd.flash_attention_backward(
                q, k, v, o, m, l, do, q_pos, k_pos, **kw)
            again = flash_bwd.flash_attention_backward(
                q, k, v, o, m, l, do, q_pos, k_pos, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention_backward(q, k, v, o, m, l, do, q_pos,
                                                k_pos, **kw)
            errs, peaks = _rel_to_peak(got, want)
            live = plain_m > -1e29      # rows that see a key
            m_err = (_compare(m[live], plain_m[live], False)
                     if bool(live.any()) else 0.0)
            m_err += float((m[~live] != -1e30).sum())   # dead rows: exact
            l_err = float(((l - plain_l).abs() / plain_l.abs().clamp_min(1))
                          .max())
            same = all(torch.equal(_bits(a), _bits(b))
                       for a, b in zip(got, again))
            dead = int((~ref.mask(q_pos, k_pos, causal, window).any(-1))
                       .sum())
            ok = (max(errs) <= FLASH_BWD_TOL[dtype] and same
                  and max(m_err, l_err) <= KERNEL_TOL[dtype]
                  and torch.equal(base, o)
                  and all(bool(torch.isfinite(g).all()) for g in got))
            ok_all &= ok
            checks.append({"dtype": str(dtype).split(".")[-1],
                           "shape": [B, Sq, Sk, H, KV, hd],
                           "causal": causal, "window": window,
                           "offsets": [q0, k0], "rows_without_key": dead,
                           "dq_err": errs[0], "dk_err": errs[1],
                           "dv_err": errs[2], "max_abs_plain": peaks,
                           "m_err": m_err,
                           "l_err": l_err, "out_as_without_stats":
                               bool(torch.equal(base, o)),
                           "deterministic": same, "ok": ok})
    return {"ok": ok_all, "checks": checks}


# the flash kernel's int8 decode form (the int8 KV cache: int8 codes, one
# f32 scale a (key, kv head)): B, Sq, Sk, H, KV, hd, causal, window, q0,
# k0, shards. G = 1, 2, 4, 6 and 8; every head dim (16 codes a lane: hd
# 128 is 8 lanes a key); windows and rolling slots (negative key
# positions); a sequence-sharded partial decode; a 2-CTA and an 8-CTA
# cluster; the cross decode (non-causal, every key valid). Every seventh
# slot holds a zero key (scale 1e-6 / 127, codes 0). Each in an f32 and a
# bf16 q, partial and full.
INT8_CASES = [
    (4, 1, 48, 16, 8, 128, True, -1, 47, 0, False),    # qwen3, 1 PE
    (32, 1, 6, 16, 8, 128, True, -1, 40, 0, True),     # qwen3, 8 PEs
    (4, 1, 48, 8, 8, 64, True, -1, 47, 0, False),      # G = 1, hd 64
    (4, 1, 48, 48, 8, 128, True, -1, 47, 0, False),    # G = 6
    (64, 1, 3, 48, 8, 128, True, -1, 40, 0, True),     # G = 6, 16 shards
    (2, 1, 40, 8, 1, 256, True, -1, 39, 0, False),     # G = 8, hd 256
    (4, 1, 48, 16, 8, 128, True, 8, 20, -4, False),    # rolling, window
    (2, 2, 40, 8, 2, 64, True, 16, 38, 0, False),      # 8 rows, window
    (4, 1, 48, 8, 8, 96, True, -1, 47, 0, False),      # hd 96
    (3, 1, 37, 4, 2, 16, True, -1, 36, 0, False),      # hd 16
    (2, 1, 70, 8, 1, 32, True, 30, 69, 0, False),      # hd 32, G = 8
    (4, 1, 48, 8, 8, 64, False, -1, 20, 0, False),     # cross decode
    (2, 1, 600, 16, 8, 128, True, -1, 599, 0, False),  # 2-CTA cluster
    (1, 1, 4096, 16, 8, 128, True, 1000, 4095, 0, False),  # 8-CTA
    (1, 1, 4096, 8, 1, 256, True, 512, 4095, 0, False),   # 8-CTA, hd 256
]
# timed beside the bf16 decode form on the same shape (its K/V the
# dequantized cache): qwen3's 1-PE decode and a 4,096-key cache; B, Sq, Sk,
# H, KV, hd
INT8_ROWS = {"int8_qwen3_decode_1pe": (4, 1, 48, 16, 8, 128),
             "int8_long_decode": (4, 1, 4096, 16, 8, 128)}


def _int8_inputs(gen, dtype, B, Sq, Sk, H, KV, hd, dev):
    """q in ``dtype`` and the int8 cache of random K/V (``quantize_kv``,
    the model's own quantizer), every seventh slot a zero key."""
    from repro_torch.models.blocks import quantize_kv
    q = torch.randn((B, Sq, H, hd), generator=gen, device=dev).to(dtype)
    kf, vf = (torch.randn((B, Sk, KV, hd), generator=gen, device=dev)
              for _ in range(2))
    kf[:, ::7] = 0
    (k, k_s), (v, v_s) = quantize_kv(kf), quantize_kv(vf)
    return q, k, v, k_s, v_s


def _int8_positions(B, Sq, Sk, q0, k0, shards, dev):
    if shards:
        q_pos = torch.full((B, 1), q0, device=dev)
        k_pos = (torch.arange(B, device=dev)[:, None] * Sk
                 + torch.arange(Sk, device=dev))
    else:
        q_pos = (q0 + torch.arange(Sq, device=dev)).expand(B, -1)
        k_pos = (k0 + torch.arange(Sk, device=dev)).expand(B, -1)
    return tuple(p.to(torch.int32).contiguous() for p in (q_pos, k_pos))


def _int8_checks(dev) -> dict:
    """The int8 decode form against its plain version (``ref`` on the
    dequantized cache) on INT8_CASES, f32 and bf16 q, partial and full,
    within KERNEL_TOL of q's type x max(1, max|plain|)."""
    from repro_torch.kernels.attention import flash, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    checks, ok_all = [], True
    for dtype in (torch.float32, torch.bfloat16):
        for (B, Sq, Sk, H, KV, hd, causal, window, q0, k0,
             shards) in INT8_CASES:
            q, k, v, k_s, v_s = _int8_inputs(gen, dtype, B, Sq, Sk, H, KV,
                                             hd, dev)
            q_pos, k_pos = _int8_positions(B, Sq, Sk, q0, k0, shards, dev)
            geo = flash.launch_geometry(B, Sq, Sk, H, KV, hd, dtype,
                                        torch.int8)
            for partial in (True, False):
                kw = dict(causal=causal, window=window, partial=partial,
                          k_scale=k_s, v_scale=v_s)
                got = flash.flash_attention(q, k, v, q_pos, k_pos, **kw)
                torch.cuda.synchronize()
                want = ref.flash_attention(q, k, v, q_pos, k_pos, **kw)
                err = _compare(got, want, partial)
                finite = all(bool(torch.isfinite(g).all()) for g in
                             (got if partial else (got,)))
                ok = err <= KERNEL_TOL[dtype] and finite
                ok_all &= ok
                checks.append({"dtype": str(dtype).split(".")[-1],
                               "shape": [B, Sq, Sk, H, KV, hd],
                               "causal": causal, "window": window,
                               "partial": partial, "grid": list(geo.grid),
                               "key_splits": geo.key_splits,
                               "zero_keys": int((k_s[0, :, 0] < 1e-7)
                                                .sum()),
                               "err": err, "ok": ok})
    return {"ok": ok_all, "checks": checks}


def _int8_bound(q, k, k_scale, q_pos, k_pos, causal, window,
                partial) -> dict:
    """``_bound`` of the int8 decode form: its cache bytes are the codes
    (one byte an element) and the two f32 scales a (key, kv head)."""
    b = _bound(q, k, q_pos, k_pos, causal, window, partial)
    es = q.element_size()
    read = (es * q.numel() + 2 * k.numel() + 8 * k_scale.numel()
            + 4 * (q_pos.numel() + k_pos.numel()))
    write = (4 * q.shape[0] * q.shape[2] * q.shape[1] * (q.shape[3] + 2)
             if partial else es * q.numel())
    t_bytes = (read + write) / HBM_BYTES_PER_S
    t_ops = b["flops"] / PEAK_FLOPS[q.dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": read + write, "flops": b["flops"]}


def _int8_row(name, q, k, v, q_pos, k_pos, kw) -> dict:
    """One int8 decode launch checked against its plain version, then
    timed with the plain version, its bound and the bf16 decode form on
    the same shape (K/V the dequantized cache in q's type); no PyTorch call
    takes int8 K/V, so there is no library yardstick."""
    from repro_torch.kernels.attention import flash, ref
    got = flash.flash_attention(q, k, v, q_pos, k_pos, **kw)
    want = ref.flash_attention(q, k, v, q_pos, k_pos, **kw)
    torch.cuda.synchronize()
    partial = kw.get("partial", False)
    gots, wants = (got, want) if partial else ((got,), (want,))
    abs_err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(gots, wants))
    err = _compare(got, want, partial)
    plain_kw = {a: b for a, b in kw.items() if a not in ("k_scale",
                                                         "v_scale")}
    kd = ref.dequantize(k, kw["k_scale"]).to(q.dtype)
    vd = ref.dequantize(v, kw["v_scale"]).to(q.dtype)
    b16 = _bound(q, kd, q_pos, k_pos, plain_kw.get("causal", True),
                 plain_kw.get("window", -1), partial)
    return {"name": name, "dtype": str(q.dtype).split(".")[-1],
            "q": list(q.shape), "kv": list(k.shape),
            "causal": kw.get("causal", True), "window": kw.get("window", -1),
            "partial": partial, "max_abs_err": abs_err, "err": err,
            "ok": err <= KERNEL_TOL[q.dtype],
            "ms": time_ms(lambda: flash.flash_attention(q, k, v, q_pos, k_pos,
                                                        **kw)),
            "plain_ms": time_ms(lambda: ref.flash_attention(
                q, k, v, q_pos, k_pos, **kw), reps=4, iters=5),
            "bf16_cache_ms": time_ms(lambda: flash.flash_attention(
                q, kd, vd, q_pos, k_pos, **plain_kw)),
            "bf16_cache_bound_ms": b16["bound_ms"],
            "library_ms": None, "library": "none (no PyTorch call takes "
            "int8 K/V)",
            **_int8_bound(q, k, kw["k_scale"], q_pos, k_pos,
                          kw.get("causal", True), kw.get("window", -1),
                          partial)}


def _int8_rows(dev) -> list:
    """INT8_ROWS in bf16 q, partial (the decode step's form)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    rows = []
    for name, (B, Sq, Sk, H, KV, hd) in INT8_ROWS.items():
        q, k, v, k_s, v_s = _int8_inputs(gen, torch.bfloat16, B, Sq, Sk, H,
                                         KV, hd, dev)
        q_pos, k_pos = _int8_positions(B, Sq, Sk, Sk - 1, 0, False, dev)
        rows.append(_int8_row(name, q, k, v, q_pos, k_pos, dict(
            causal=True, window=-1, partial=True, k_scale=k_s,
            v_scale=v_s)))
        torch.cuda.empty_cache()
    return rows


def phase_kernel(dev) -> dict:
    attn = _flash_checks(dev)
    int8 = _int8_checks(dev)
    int8_rows = _int8_rows(dev)
    long_rows = _flash_long_rows(dev)
    lowp = _lowp_checks(dev)
    lowp_rows = _lowp_rows(dev)
    bwd = _flash_bwd_checks(dev)
    reorder = _reorder_checks(dev)
    sweep = _reorder_sweep(dev)
    reorder_grad = _reorder_grad_checks(dev)
    rwkv = _rwkv6_checks(dev)
    rwkv_bwd = _rwkv6_bwd_checks(dev)
    return {"ok": (attn["ok"] and all(r["ok"] for r in long_rows)
                   and lowp["ok"] and all(r["ok"] for r in lowp_rows)
                   and int8["ok"] and all(r["ok"] for r in int8_rows)
                   and bwd["ok"] and reorder["ok"] and sweep["ok"]
                   and reorder_grad["ok"] and rwkv["ok"] and rwkv_bwd["ok"]),
            "checks": attn["checks"], "flash_long_rows": long_rows,
            "lowp": lowp, "lowp_rows": lowp_rows,
            "int8_decode": int8, "int8_rows": int8_rows,
            "flash_backward": bwd, "reorder": reorder,
            "reorder_sweep": sweep,
            "reorder_backward": reorder_grad, "rwkv6": rwkv,
            "rwkv6_backward": rwkv_bwd}


def _rwkv6_inputs(gen, dev, dtype, B, S, H, K, *, strong, state, G=0):
    """r, k, v ~ N(0, 1) and u ~ 0.1 N(0, 1) in ``dtype``; f32 logw, either
    the JAX kernel sweep's strong decay -exp(0.5 N(0, 1)) or the model's
    range -exp(U(-6, -1)); an f32 N(0, 1) state coming in, or None; u per
    group of rows when G (the cube's PEs folded into the batch)."""
    r, k, v = (torch.randn(B, S, H, K, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    if strong:
        logw = -torch.exp(0.5 * torch.randn(B, S, H, K, generator=gen,
                                            device=dev))
    else:
        logw = -torch.exp(torch.empty(B, S, H, K, device=dev).uniform_(
            -6.0, -1.0, generator=gen))
    u = (0.1 * torch.randn(((G,) if G else ()) + (H, K), generator=gen,
                           device=dev)).to(dtype)
    s0 = (torch.randn(B, H, K, K, generator=gen, device=dev) if state
          else None)
    return r, k, v, logw, u, s0


def _rwkv6_state_f64(r, k, v, logw, state) -> torch.Tensor:
    """The final state by the one-token recurrence S_t = diag(e^{logw_t})
    S_{t-1} + k_t v_t^T in f64 (u does not enter it)."""
    B, S, H, K = r.shape
    st = (torch.zeros((B, H, K, v.shape[-1]), dtype=torch.float64,
                      device=r.device) if state is None else state.double())
    kd, vd, wd = k.double(), v.double(), logw.double().exp()
    for t in range(S):
        kv = kd[:, t, :, :, None] * vd[:, t, :, None, :]
        st = wd[:, t, :, :, None] * st + kv
    return st


def _rwkv6_compare(got, want) -> float:
    """Largest |kernel - plain| over max(1, max|plain|), of o and state."""
    return max(float((g.float() - w.float()).abs().max())
               / max(1.0, float(w.float().abs().max()))
               for g, w in zip(got, want))


# RWKV6 correctness sweep: B, S, H, K, the plain version's chunk, strong
# decay, state in, u groups (0: one u). The JAX kernel sweep; the full head
# shape over many chunks; the served shapes; lengths around the kernel's
# 16-step sub-chunk (1, 15, 16, 17, 37); one u per folded PE; K = 16 and
# 32; grids under and over the 132 SMs
RWKV6_CASES = [
    (1, 128, 2, 16, 32, True, False, 0),
    (2, 64, 4, 32, 64, True, False, 0),
    (1, 256, 1, 64, 64, True, False, 0),
    (4, 512, 64, 64, 64, False, True, 0),
    (2, 144, 4, 64, 64, False, True, 0),
    (4, 48, 64, 64, 64, False, False, 0),
    (32, 32, 8, 64, 64, False, False, 8),
    (4, 37, 2, 64, 37, False, True, 2),
    (1, 1, 4, 64, 1, False, True, 0),
    (2, 15, 4, 64, 15, False, True, 2),
    (2, 16, 4, 32, 16, False, True, 0),
    (2, 17, 4, 16, 17, False, True, 2),
    (3, 17, 1, 32, 17, False, False, 3),
    (2, 40, 48, 64, 40, False, True, 2),
    (4, 2048, 64, 64, 64, False, True, 0),
]
# timed beside their plain version and bound (off the main path)
RWKV6_TIMED = ((4, 512, 64, 64), (4, 2048, 64, 64))


def _rwkv6_checks(dev) -> dict:
    """The RWKV6 kernel against its plain version on o and the final state,
    f32 within 5e-4 and bf16 within 5e-2 of max(1, max|plain|), over
    RWKV6_CASES (the kernel takes any length; the plain version keeps the
    reference's chunk rule). Under the strong decay the plain version runs
    chunks of 16, the kernel's own sub-chunk: a chunk of 64 can take
    e^{-cum} past f32's range in the reference form. In both types the
    final state is also held to the one-token recurrence in f64 within
    RWKV6_STATE_TOL x max(1, max|f64|), which a kernel that drops to
    bf16 products fails. The RWKV6_TIMED shapes are also timed, with
    their plain version and bound (``timed``)."""
    from repro_torch.kernels.rwkv6 import ref, rwkv6
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    checks, timed, ok_all = [], [], True
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, H, K, chunk, strong, state, G in RWKV6_CASES:
            x = _rwkv6_inputs(gen, dev, dtype, B, S, H, K, strong=strong,
                              state=state, G=G)
            got = rwkv6.rwkv6_chunked(*x)
            torch.cuda.synchronize()
            if strong:
                chunk = 16
            want = ref.rwkv6_chunked(*x, chunk=chunk)
            if (B, S, H, K) in RWKV6_TIMED:
                long = S > 512
                timed.append({
                    "dtype": str(dtype).split(".")[-1], "shape": [B, S, H, K],
                    "state_in": state,
                    "ms": time_ms(lambda: rwkv6.rwkv6_chunked(*x)),
                    "plain_ms": time_ms(lambda: ref.rwkv6_chunked(*x),
                                        reps=2 if long else 20,
                                        iters=5 if long else 10),
                    **_rwkv6_bound(*x)})
            finite = all(bool(torch.isfinite(t.float()).all())
                         for t in want + got)
            err = _rwkv6_compare(got, want)
            # the final state is f32 in both types: its distance from the
            # f64 recurrence shows the products' precision, which bf16's
            # rounding of o hides
            s64 = _rwkv6_state_f64(x[0], x[1], x[2], x[3], x[5])
            state_err = (float((got[1].double() - s64).abs().max())
                         / max(1.0, float(s64.abs().max())))
            ok = (finite and err <= RWKV6_TOL[dtype]
                  and state_err <= RWKV6_STATE_TOL)
            ok_all &= ok
            checks.append({"dtype": str(dtype).split(".")[-1],
                           "shape": [B, S, H, K], "chunk": chunk,
                           "strong_decay": strong, "state_in": state,
                           "u_groups": G, "err": err,
                           "state_err": state_err, "finite": finite,
                           "ok": ok})
            del x, got, want, s64
    return {"ok": ok_all, "cases": len(checks),
            "worst_err": max(c["err"] for c in checks),
            "worst_state_err": {d: max(c["state_err"] for c in checks
                                       if c["dtype"] == d)
                                for d in ("float32", "bfloat16")},
            "failed": [c for c in checks if not c["ok"]][:10],
            "timed": timed, "checks": checks}


# RWKV6 backward sweep: B, S, H, K, strong decay, state in (and its
# gradient out), u groups (0: one u). K = 16, 32 and 64; lengths 1, 15, 16,
# 17, 37, 63, 64, 65, 129 and 144 around the 16-step sub-chunk and the
# 64-step chunk; the JAX sweep's strong decay; one u per folded PE; one
# (batch, head) over 1,024 steps (one CTA of the chain); the training
# shape (4, 1024, 64, 64), timed
RWKV6_BWD_CASES = [
    (1, 128, 2, 16, True, False, 0),
    (2, 64, 4, 32, True, True, 0),
    (1, 1, 4, 64, False, True, 0),
    (2, 15, 4, 64, False, True, 2),
    (2, 16, 4, 32, False, True, 0),
    (2, 17, 4, 16, False, True, 2),
    (4, 37, 2, 64, False, True, 4),
    (2, 144, 4, 64, False, True, 0),
    (2, 63, 4, 64, False, True, 0),
    (2, 65, 4, 32, False, True, 2),
    (1, 129, 2, 16, True, True, 0),
    (1, 1024, 1, 64, False, False, 0),
    (4, 1024, 64, 64, False, False, 0),
]
RWKV6_BWD_TIMED = (4, 1024, 64, 64)
RWKV6_BWD_NAMES = ("dr", "dk", "dv", "dlogw", "du", "dstate")


def _rwkv6_bwd_bound(r, k, v, logw, u, state, do, dstate, states) -> dict:
    """Least time the card could take for the backward as a function of
    (r, k, v, logw, u, state, do, dstate): each input byte read once (r,
    k, v, u, do in their type; logw, an incoming state and its gradient in
    f32), each output byte written once (dr, dk, dv, du in their type,
    dlogw and the incoming state's gradient in f32), over HBM rate; the
    operations its algorithm needs per 16-step sub-chunk and (batch, head)
    -- the state products S0 do, dS v, kw dS and the dS update (4 C K V),
    the pair terms below the diagonal (P, dP, their products with kd, qd
    and do: 5 C (C - 1) / 2 x K), the diagonal terms and the state term of
    dtot -- at 2 FLOPs each, over the peak for the inputs' type. The
    larger of the two. The design's own traffic is not the function's and
    is reported beside the bound, not in it: the f32 states saved every
    64 steps (written by the forward, read here: ``saved_states_bytes``,
    ``saved_states_read_ms``), pass 1's f32 chunk-end gradients (written,
    then read by pass 2) and the f32 du scratch (written, then read):
    ``design_bytes``, ``design_ms`` their sum over HBM rate."""
    from repro_torch.kernels.rwkv6.ref import SUB
    B, S, H, K = r.shape
    es = r.element_size()
    n = -(-S // SUB)
    sb = 4 * B * H * K * K
    read = (es * (r.numel() + k.numel() + v.numel() + u.numel()
                  + do.numel()) + 4 * logw.numel()
            + (0 if state is None else sb) + (0 if dstate is None else sb))
    write = (es * (3 * r.numel() + u.numel()) + 4 * logw.numel()
             + (0 if state is None else sb))
    C = SUB
    flops = B * H * n * 2 * (4 * C * K * K + 5 * C * (C - 1) // 2 * K
                             + 4 * C * K + K * K)
    t_bytes = (read + write) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[r.dtype]
    saved = 4 * states.numel()
    design = {"saved_states_read": saved, "chunk_end_grads": 2 * saved,
              "du_scratch": 2 * 4 * B * H * states.shape[2] * K}
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": read + write, "flops": flops,
            "saved_states_bytes": saved,
            "saved_states_read_ms": saved / HBM_BYTES_PER_S * 1e3,
            "design_bytes": design,
            "design_ms": sum(design.values()) / HBM_BYTES_PER_S * 1e3}


# the RWKV6 backward's CUDA kernels, by pass
RWKV6_BWD_PASSES = {"pass1": "rwkv6_bwd_state_kernel",
                    "pass2": "rwkv6_bwd_chunk_kernel",
                    "du": "rwkv6_du_kernel"}


def _rwkv6_bwd_pass_ms(args, iters: int = 10) -> dict:
    """Device ms of each of the backward's kernels in one call (pass 1, pass
    2, the du sum) and of the call's kernels together, from ``iters`` calls
    under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.rwkv6 import rwkv6_bwd
    for _ in range(2):
        rwkv6_bwd.rwkv6_chunked_backward(*args)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                rwkv6_bwd.rwkv6_chunked_backward(*args)
            torch.cuda.synchronize()
        evs = [(ev.name, ev.time_range.elapsed_us()) for ev in prof.events()
               if ev.device_type == DeviceType.CUDA]
        if evs:
            out = {p: sum(us for name, us in evs if fn in name) / 1e3 / iters
                   for p, fn in RWKV6_BWD_PASSES.items()}
            out["device_ms"] = sum(us for _, us in evs) / 1e3 / iters
            return out
    raise RuntimeError("the profiler traced no device events")


def _rwkv6_autograd(r, k, v, logw, u, state, do, dstate, strong):
    """Gradients of sum(o * do) + sum(state_out * dstate) by autograd of
    the plain forward: under the strong decay, chunks of the largest
    divisor of S up to 16 (16 where it divides S; 3 at S = 129), which keeps
    e^{-cum} inside f32; else the reference's rule (chunks of up to 64), or
    the largest divisor of S up to 64 where that rule finds no split."""
    from repro_torch.kernels.rwkv6 import ref
    S = r.shape[1]
    if strong:
        chunk = max(c for c in range(1, 17) if S % c == 0)
    else:
        try:
            ref.chunk_len(S)
            chunk = 64
        except ValueError:
            chunk = max(c for c in range(1, 65) if S % c == 0)
    xs = [t.detach().clone().requires_grad_() for t in (r, k, v, logw, u)]
    s0 = None if state is None else state.detach().clone().requires_grad_()
    with torch.enable_grad():
        o, s = ref.rwkv6_chunked(*xs, state=s0, chunk=chunk)
        loss = (o.float() * do.float()).sum()
        if dstate is not None:
            loss = loss + (s * dstate).sum()
        grads = torch.autograd.grad(loss, xs + ([] if s0 is None else [s0]))
    return list(grads) + ([None] if s0 is None else [])


def _rwkv6_rel(got, want) -> list:
    """Per output, |kernel - ref| over max(1, max|ref|) (None where the
    reference has no such output)."""
    return [None if w is None else
            float((g.float() - w.float()).abs().max())
            / max(1.0, float(w.float().abs().max()))
            for g, w in zip(got, want)]


def _rwkv6_bwd_checks(dev) -> dict:
    """The RWKV6 backward kernel (rwkv6_bwd.cu) over RWKV6_BWD_CASES in f32
    and bf16, fed the states the forward kernel saves (held to
    ``ref.chunk_states`` within RWKV6_STATES_TOL x max(1, max|plain|); the
    forward's
    o and final state bit-identical to a launch without them): against
    the plain backward on the same inputs and against autograd of the
    plain forward, each of dr, dk, dv, dlogw, du and dstate within
    RWKV6_TOL x max(1, max|plain|); two launches bit-identical. The
    training shape is timed with its plain version and bound."""
    from repro_torch.kernels.rwkv6 import ref, rwkv6, rwkv6_bwd
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    checks, timed, ok_all = [], [], True
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, H, K, strong, state, G in RWKV6_BWD_CASES:
            r, k, v, logw, u, s0 = _rwkv6_inputs(
                gen, dev, dtype, B, S, H, K, strong=strong, state=state,
                G=G)
            do = torch.randn(B, S, H, K, generator=gen, device=dev).to(dtype)
            ds = (torch.randn(B, H, K, K, generator=gen, device=dev)
                  if state else None)
            o, s_out, states = rwkv6.rwkv6_chunked(r, k, v, logw, u, s0,
                                                   states=True)
            o2, s2 = rwkv6.rwkv6_chunked(r, k, v, logw, u, s0)
            args = (r, k, v, logw, u, s0, do, ds)
            got = rwkv6_bwd.rwkv6_chunked_backward(*args, states)
            again = rwkv6_bwd.rwkv6_chunked_backward(*args, states)
            torch.cuda.synchronize()
            want_states = ref.chunk_states(k, v, logw, s0)
            states_err = float((states - want_states).abs().max()) / max(
                1.0, float(want_states.abs().max()))
            plain = ref.rwkv6_chunked_backward(*args, states)
            auto = _rwkv6_autograd(*args, strong)
            err_plain = _rwkv6_rel(got, plain)
            err_auto = _rwkv6_rel(got, auto)
            same = all(torch.equal(a, b) for a, b in zip(got, again)
                       if a is not None)
            finite = all(bool(torch.isfinite(t.float()).all())
                         for t in got if t is not None)
            tol = RWKV6_TOL[dtype]
            ok = (finite and same and states_err <= RWKV6_STATES_TOL
                  and torch.equal(o, o2) and torch.equal(s_out, s2)
                  and all(e is None or e <= tol
                          for e in err_plain + err_auto))
            ok_all &= ok
            checks.append({
                "dtype": str(dtype).split(".")[-1], "shape": [B, S, H, K],
                "strong_decay": strong, "state_in": state, "u_groups": G,
                "err_vs_plain": dict(zip(RWKV6_BWD_NAMES, err_plain)),
                "err_vs_autograd": dict(zip(RWKV6_BWD_NAMES, err_auto)),
                "states_err": states_err, "deterministic": same,
                "forward_same_bits": bool(torch.equal(o, o2)
                                          and torch.equal(s_out, s2)),
                "finite": finite, "ok": ok})
            if (B, S, H, K) == RWKV6_BWD_TIMED and dtype == torch.bfloat16:
                a = args + (states,)
                timed.append({
                    "dtype": "bfloat16", "shape": [B, S, H, K],
                    "ms": time_ms(lambda: rwkv6_bwd.rwkv6_chunked_backward(
                        *a)),
                    "plain_ms": time_ms(
                        lambda: ref.rwkv6_chunked_backward(*a), reps=2,
                        iters=5),
                    "forward_states_ms": time_ms(lambda: rwkv6.rwkv6_chunked(
                        r, k, v, logw, u, s0, states=True)),
                    "forward_ms": time_ms(lambda: rwkv6.rwkv6_chunked(
                        r, k, v, logw, u, s0)),
                    "pass_ms": _rwkv6_bwd_pass_ms(a),
                    "library_ms": None, **_rwkv6_bwd_bound(*a)})
            del r, k, v, logw, u, s0, do, ds, got, again, plain, auto
            del states, want_states, o, o2
    worst = {n: max(max(c["err_vs_plain"][n] or 0.0,
                        c["err_vs_autograd"][n] or 0.0) for c in checks)
             for n in RWKV6_BWD_NAMES}
    return {"ok": ok_all, "cases": len(checks), "worst_err": worst,
            "failed": [c for c in checks if not c["ok"]][:10],
            "timed": timed, "checks": checks}


def _reorder_grad_checks(dev) -> dict:
    """The reorder under autograd (``TileSwizzle``): its output and
    gradient bit-identical to autograd of ``index_select`` on random
    perms (f32, bf16; its backward launches the kernel with the inverse
    perm), and every all_to_all of the pr and cm flows on the 8-PE cubes
    under autograd bit-identical to autograd of the plain transpose
    (integer payloads), each flow launching the kernel twice a call (the
    forward and the backward)."""
    from repro_torch.core.hypercube import Hypercube
    from repro_torch.kernels.reorder import ops, reorder
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    cases, failed = 0, []
    for dtype in (torch.float32, torch.bfloat16):
        for G, b, D in ((4, 8, 64), (16, 1, 128), (64, 4, 2048)):
            x = torch.randn(G * b, D, generator=gen, device=dev).to(dtype)
            dy = torch.randn(G * b, D, generator=gen, device=dev).to(dtype)
            perm = torch.randperm(G, generator=gen, device=dev)
            p32 = perm.to(torch.int32)
            inv = torch.argsort(perm).to(torch.int32)
            xa = x.clone().requires_grad_()
            n0 = reorder.LAUNCHES
            y = ops.tile_swizzle(xa, p32, inv)
            (g,) = torch.autograd.grad(y, xa, dy)
            launched = reorder.LAUNCHES - n0
            xb = x.clone().requires_grad_()
            yb = torch.index_select(xb.view(G, -1), 0, perm).view(x.shape)
            (gb,) = torch.autograd.grad(yb, xb, dy)
            cases += 1
            if not (torch.equal(_bits(y), _bits(yb))
                    and torch.equal(_bits(g), _bits(gb)) and launched == 2):
                failed.append(["swizzle", str(dtype), G, b, D, launched])
    for name, dims, bitmaps in CUBES:
        cube = Hypercube.build(dims)
        for bm in bitmaps:
            comm = cube.comm(bm)
            gs = comm.group_size
            axes = [i for i, c in enumerate(bm) if c == "1"]
            x = torch.randint(-4, 5, cube.dim_sizes + (2 * gs, gs, 64),
                              generator=gen, device=dev).float()
            dy = torch.randint(-4, 5, x.shape, generator=gen,
                               device=dev).float()
            for sa, ca in ((0, 1), (1, 0), (1, 2)):
                xp = x.clone().requires_grad_()
                want = _plain_all_to_all(xp, cube.dim_sizes, axes, sa, ca)
                (gw,) = torch.autograd.grad(want, xp, dy.reshape(want.shape))
                for flow in ("pr", "cm"):
                    xa = x.clone().requires_grad_()
                    n0 = reorder.LAUNCHES
                    got = comm.all_to_all(xa, split_axis=sa, concat_axis=ca,
                                          algorithm=flow)
                    (ga,) = torch.autograd.grad(got, xa,
                                                dy.reshape(got.shape))
                    launched = reorder.LAUNCHES - n0
                    cases += 1
                    if not (torch.equal(got, want) and torch.equal(ga, gw)
                            and launched == 2):
                        failed.append([name, bm, sa, ca, flow, launched])
    torch.cuda.synchronize()
    return {"ok": not failed, "cases": cases, "failed": failed[:10]}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit pattern (bit-exact comparison, -0.0 included)."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _reorder_checks(dev) -> dict:
    """The reorder kernel against its plain version, bit for bit."""
    from repro_torch.kernels.reorder import ref, reorder
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def payload(rows, D, dtype):
        if dtype == torch.int32:
            return torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, D),
                                 generator=gen, device=dev, dtype=dtype)
        return torch.randn(rows, D, generator=gen, device=dev).to(dtype)

    cases, failed = 0, []
    dtypes = (torch.float32, torch.bfloat16, torch.int32)
    for dtype in dtypes:
        for G in (4, 8, 16):
            for b in (1, 8, 16):
                for D in (64, 128, 2048):
                    x = payload(G * b, D, dtype)
                    perm = torch.randperm(G, generator=gen, device=dev).to(
                        torch.int32)
                    cases += 1
                    if not torch.equal(_bits(reorder.tile_swizzle(x, perm)),
                                       _bits(ref.tile_swizzle(x, perm))):
                        failed.append(["tile_swizzle", str(dtype), G, b, D])
        for g1, g2 in ((2, 2), (2, 4), (4, 2), (4, 4)):
            x = payload(g1 * g2 * 8, 128, dtype)
            cases += 1
            if not torch.equal(_bits(reorder.block_transpose(x, g1, g2)),
                               _bits(ref.block_transpose(x, g1, g2))):
                failed.append(["block_transpose", str(dtype), g1, g2])
        # base pointers off the 16-byte grid, odd widths: the narrow words
        for G, b, D, off in ((8, 1, 3, 1), (5, 3, 7, 1), (16, 8, 64, 2)):
            buf = payload(1, G * b * D + off, dtype).reshape(-1)
            x = buf[off:].view(G * b, D)
            perm = torch.randperm(G, generator=gen, device=dev).to(
                torch.int32)
            cases += 1
            if not torch.equal(_bits(reorder.tile_swizzle(x, perm)),
                               _bits(ref.tile_swizzle(x, perm))):
                failed.append(["unaligned", str(dtype), G, b, D, off])
    # a device perm entry outside [0, G) writes a zero block
    x = payload(16, 64, torch.float32)
    got = reorder.tile_swizzle(
        x, torch.tensor([1, -1, 3, 0], dtype=torch.int32, device=dev))
    cases += 1
    if not (torch.equal(got[4:8], torch.zeros_like(got[4:8]))
            and torch.equal(got[:4], x[4:8])):
        failed.append(["out_of_range"])

    def check(name, x, perm, bits=32, width=16, zero=()):
        """One launch bit for bit against the plain version on perm with
        the ``zero`` entries (indices into perm) put out of range, whose
        blocks must come out zero; and the launch's plan (its index width
        and word) as expected."""
        nonlocal cases
        G = perm.numel()
        want = ref.tile_swizzle(x, perm).view(G, -1)
        bad = perm.clone()
        for j, k in enumerate(zero):
            bad[k] = -1 - j if j % 2 == 0 else G + j      # below and above
            want[k] = 0
        got = reorder.tile_swizzle(x, bad)
        g = reorder.LAST_PLAN
        cases += 1
        if not (g.index_bits == bits and g.width == width and torch.equal(
                _bits(got.view(G, -1)), _bits(want))):
            failed.append([name, str(x.dtype), G, list(x.shape),
                           g.index_bits, g.width])

    def randperm(G):
        return torch.randperm(G, generator=gen, device=dev).to(torch.int32)

    # the prefill K/V reshards' (128 B, 256 B) and DLRM's (832 B) one-row
    # blocks at the reshard's and DLRM's block counts
    for G in (132096, 16384):
        for dtype, D in ((torch.bfloat16, 64), (torch.bfloat16, 128),
                         (torch.float32, 208)):
            check("rows", payload(G, D, dtype), randperm(G))
    # the MoE decode's 4-KiB blocks, 4,112-byte and 160-KiB ones
    for G, D in ((1024, 1024), (1024, 1028), (16, 40960)):
        check("blocks", payload(G, D, torch.int32), randperm(G))
    # 1.25-MiB blocks at 2-byte alignment: the 2-byte word
    G, D = 8, 655360
    buf = payload(1, G * D + 1, torch.bfloat16).reshape(-1)
    check("unaligned_large", buf[1:].view(G, D), randperm(G), 32, 2)
    del buf
    # 2,050-byte blocks in 2-byte words, just under 2^31 words (32-bit
    # indices) and just over (64-bit; 4.3 GB); random bits (NaNs included,
    # compared by their bits); a zero block from an entry below and one
    # above [0, G) on each side
    top = reorder.MAX_WORDS_32 + 1
    for G, bits in ((top // 1025, 32), (top // 1025 + 1, 64)):
        x = torch.randint(-2 ** 15, 2 ** 15, (G, 1025), generator=gen,
                          device=dev, dtype=torch.int16).view(torch.bfloat16)
        check("index_width", x, randperm(G), bits, 2, zero=(5, G - 7))
        del x
    check("zero_rows", payload(4096, 128, torch.bfloat16), randperm(4096),
          zero=(5, 4000))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"ok": not failed, "cases": cases, "failed": failed[:10]}


# block bytes of the reorder sweep: the launch floor's word, the prefill
# reshards' rows (whisper 128 B, qwen3 / llava 256 B), DLRM's 832 B, the
# MoE decode's 4 KiB, jamba's 32 KiB, the training steps' 160 KiB and
# 1.25 MiB; each row about REORDER_SWEEP_BYTES of payload
REORDER_SWEEP = (16, 128, 256, 832, 4096, 32768, 163840, 1310720)
REORDER_SWEEP_BYTES = 64 * 2 ** 20


def _reorder_row(x, perm) -> dict:
    """The reorder on x (G blocks) and perm, timed beside index_select and
    the bytes bound, its launch bit for bit against the plain version, with
    the launch's plan."""
    from repro_torch.kernels.reorder import ref, reorder
    G = perm.numel()
    exact = bool(torch.equal(_bits(reorder.tile_swizzle(x, perm)),
                             _bits(ref.tile_swizzle(x, perm))))
    g = reorder.LAST_PLAN
    ms = time_ms(lambda: reorder.tile_swizzle(x, perm))
    nbytes = 2 * x.numel() * x.element_size() + G * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {"block_bytes": x.numel() * x.element_size() // G, "blocks": G,
            "dtype": str(x.dtype).split(".")[-1], "x": list(x.shape),
            "width": g.width, "grid": g.grid, "exact": exact, "ms": ms,
            "library_ms": time_ms(
                lambda: torch.index_select(x.view(G, -1), 0, perm)),
            "bound_ms": bound, "bound_by": "bytes", "share_of_bound":
            bound / ms, "bytes": nbytes, "fits_l2": nbytes <= L2_BYTES}


def _reorder_sweep(dev) -> dict:
    """The reorder at each REORDER_SWEEP block size on bf16 one-row blocks
    and a random perm, about REORDER_SWEEP_BYTES of payload a row; and the
    launch floor, one 16-byte block (G = 1) timed the same way."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rows = []
    for nbytes in REORDER_SWEEP:
        G = REORDER_SWEEP_BYTES // nbytes
        x = torch.randn(G, nbytes // 2, generator=gen, device=dev).to(
            torch.bfloat16)
        perm = torch.randperm(G, generator=gen, device=dev).to(torch.int32)
        rows.append(_reorder_row(x, perm))
        del x
    floor = _reorder_row(
        torch.randn(1, 8, generator=gen, device=dev).to(torch.bfloat16),
        torch.zeros(1, dtype=torch.int32, device=dev))
    torch.cuda.empty_cache()
    return {"ok": all(r["exact"] for r in rows) and floor["exact"],
            "rows": rows, "launch_floor": floor}


# -------------------------------------------------------------------- comm
CUBES = [("ring8", {"d": 8}, ("1",)),
         ("2x4", {"r": 2, "c": 4}, ("01",)),
         ("2x2x2", {"a": 2, "b": 2, "c": 2}, ("010", "110", "011"))]


def _plain_group(x, sizes, axes):
    """(G, *instance, *payload) with members cube-major, and its inverse."""
    n = len(sizes)
    inst = [i for i in range(n) if i not in axes]
    perm = list(axes) + inst + list(range(n, x.dim()))
    y = x.permute(perm)
    gshape = [sizes[a] for a in axes]
    g = int(np.prod(gshape))
    y = y.reshape([g] + list(y.shape[len(axes):]))

    def back(z):
        z = z.reshape(gshape + list(z.shape[1:]))
        inv = [perm.index(i) for i in range(len(perm))]
        return z.permute(inv)
    return y, back


def _plain(primitive, x, sizes, axes, op, axis):
    y, back = _plain_group(x, sizes, axes)
    g = y.shape[0]
    red = {"add": lambda t: t.sum(0), "max": lambda t: t.amax(0),
           "min": lambda t: t.amin(0)}[op]
    pa = y.dim() - (x.dim() - len(sizes)) - 1 + axis   # axis without G
    if primitive == "all_reduce":
        return back(red(y).unsqueeze(0).expand_as(y))
    if primitive == "all_gather":
        full = torch.cat([y[r] for r in range(g)], dim=pa)
        return back(full.unsqueeze(0).expand((g,) + tuple(full.shape)))
    chunks = torch.chunk(red(y), g, dim=pa)
    return back(torch.stack(chunks, 0))


CUBES16 = [("4d16", {"w": 2, "x": 2, "y": 2, "z": 2}, 1,
            ("1100", "0110", "1010", "1111")),
           ("ring16", {"d": 16}, 1, ("1",)),
           ("pod2x4x2", {"pod": 2, "dp": 4, "tp": 2}, 2,
            ("110", "011", "100"))]


def _plain_all_to_all(x, sizes, axes, split_axis, concat_axis):
    """Member j's block i along concat_axis = member i's block j along
    split_axis (the NumPy oracle's transpose, in torch)."""
    y, back = _plain_group(x, sizes, axes)
    g = y.shape[0]
    pay0 = y.dim() - (x.dim() - len(sizes))
    blocks = torch.stack(torch.chunk(y, g, dim=pay0 + split_axis), dim=1)
    swapped = blocks.transpose(0, 1)                 # member j <- block j
    out = torch.cat([swapped[:, s] for s in range(g)],
                    dim=pay0 + concat_axis)
    return back(out)


def _comm_all_to_all(dev, gen) -> tuple[int, list]:
    """Every all_to_all stage on the 8-PE cubes and the 16-PE shapes."""
    from repro_torch.core.hypercube import Hypercube
    cubes = [(n, d, 1, bm) for n, d, bm in CUBES] + CUBES16
    cells, failed = 0, []
    for name, dims, pods, bitmaps in cubes:
        cube = Hypercube.build(dims, pods=pods)
        for bm in bitmaps:
            comm = cube.comm(bm)
            g = comm.group_size
            axes = [i for i, b in enumerate(bm) if b == "1"]
            x = torch.randint(-4, 5, cube.dim_sizes + (2 * g, g, 64),
                              generator=gen, device=dev)
            for dtype in (torch.float32, torch.bfloat16, torch.int32):
                xd = x.to(dtype)
                for sa, ca in ((0, 1), (1, 0), (0, 0), (1, 1)):
                    want = _plain_all_to_all(xd, cube.dim_sizes, axes, sa, ca)
                    for stage in ("naive", "pr", "im", "cm", "auto"):
                        got = comm.all_to_all(xd, split_axis=sa,
                                              concat_axis=ca, algorithm=stage)
                        cells += 1
                        if not torch.equal(got, want):
                            failed.append([name, bm, str(dtype), sa, ca,
                                           stage])
    return cells, failed


def phase_comm(dev) -> dict:
    from repro_torch.core.hypercube import Hypercube
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    stages = {"all_reduce": ("naive", "pr", "im", "auto"),
              "reduce_scatter": ("naive", "pr", "im", "auto"),
              "all_gather": ("naive", "pr", "im", "cm", "auto")}
    cells = failures = 0
    for name, dims, bitmaps in CUBES:
        cube = Hypercube.build(dims)
        x = torch.randint(-4, 5, cube.dim_sizes + (64, 128), generator=gen,
                          device=dev).to(torch.float32)
        for bm in bitmaps:
            comm = cube.comm(bm)
            axes = [i for i, b in enumerate(bm) if b == "1"]
            for prim, names in stages.items():
                for op in (("add", "max", "min") if prim != "all_gather"
                           else ("add",)):
                    for axis in (0, 1):
                        if prim == "all_reduce" and axis:
                            continue
                        want = _plain(prim, x, cube.dim_sizes, axes, op, axis)
                        for stage in names:
                            kw = {"algorithm": stage}
                            if prim != "all_gather":
                                kw["op"] = op
                            if prim != "all_reduce":
                                kw["axis"] = axis
                            got = getattr(comm, prim)(x, **kw)
                            cells += 1
                            if not torch.equal(got, want):
                                failures += 1
    a2a_cells, a2a_failed = _comm_all_to_all(dev, gen)
    flows = _comm_flows(dev, gen)
    torch.cuda.synchronize()
    return {"ok": (failures == 0 and not a2a_failed
                   and not flows["failed"]),
            "cells": cells, "failures": failures, "pes": 8,
            "all_to_all_cells": a2a_cells,
            "all_to_all_failed": a2a_failed[:10], "flows": flows}


# the compressed flow against the plain int8 version, relative to its max:
# the same roundings, f32 sums in another order (half an int8 step is
# max / 254; an uncompressed flow lands that far off and fails)
COMPRESSED_TOL = 1e-6


def _plain_int8_all_reduce(x, sizes, fast, slow, block=256):
    """The §V-C compressed all-reduce written plainly: each pod's ICI sum,
    split into |ICI| shards, quantized per PE by blocks of ``block`` to
    int8 (absmax / 127, round half to even), dequantized, summed over the
    pods, gathered back. x: (*cube, n) with n a multiple of |ICI| x block."""
    shard = (_plain("reduce_scatter", x, sizes, fast, "add", 0) if fast
             else x)
    blocks = shard.reshape(shard.shape[:-1] + (-1, block))
    step = blocks.abs().amax(-1, keepdim=True).div(127.0).clamp_min(1e-12)
    deq = (torch.round(blocks / step).clamp(-127, 127) * step).reshape(
        shard.shape)
    summed = _plain("all_reduce", deq, sizes, slow, "add", 0)
    full = (_plain("all_gather", summed, sizes, fast, "add", 0) if fast
            else summed)
    return full


def _comm_flows(dev, gen) -> dict:
    """The non-stage flows on the card, against the plain reductions above
    on integer payloads: all_reduce's hierarchical, ring (single-dim
    groups), tree, pidcomm and auto on the 8-PE cubes and the 16-PE shapes
    (bit-identical), compressed on the pod-crossing ones (within
    COMPRESSED_TOL x max|plain| of the plain int8 version, and further than
    that from the exact all-reduce), and the three fused
    ring flows on the 8-PE cubes (bit-identical)."""
    from repro_torch.core.hypercube import Hypercube
    cubes = [(n, d, 1, bm) for n, d, bm in CUBES] + CUBES16
    cells, failed, compressed = 0, [], []
    for name, dims, pods, bitmaps in cubes:
        cube = Hypercube.build(dims, pods=pods)
        sizes = cube.dim_sizes
        # a first axis off every group size: ring pads its chunks
        x = torch.randint(-4, 5, sizes + (37, 96), generator=gen,
                          device=dev).to(torch.float32)
        for bm in bitmaps:
            comm = cube.comm(bm)
            axes = [i for i, b in enumerate(bm) if b == "1"]
            want = _plain("all_reduce", x, sizes, axes, "add", 0)
            algs = ["hierarchical", "tree", "pidcomm", "auto"]
            if len(axes) == 1:
                algs.append("ring")
            for alg in algs:
                cells += 1
                if not torch.equal(comm.all_reduce(x, algorithm=alg), want):
                    failed.append([name, bm, "all_reduce", alg])
            fast = [i for i in axes if cube.dim_names[i] not in
                    cube.dcn_dims]
            slow = [i for i in axes if i not in fast]
            if slow:
                xf = x.reshape(sizes + (-1,))[..., :2048] * torch.rand(
                    sizes + (2048,), generator=gen, device=dev)
                got = comm.all_reduce(xf, algorithm="compressed")
                plain = _plain_int8_all_reduce(xf, sizes, fast, slow)
                err = float((got - plain).abs().max())
                bound = COMPRESSED_TOL * float(plain.abs().max())
                lossy = float((got - _plain("all_reduce", xf, sizes, axes,
                                            "add", 0)).abs().max())
                cells += 1
                compressed.append({"cube": name, "bitmap": bm, "err": err,
                                   "bound": bound, "gap_to_exact": lossy})
                if not (err <= bound and lossy > bound):
                    failed.append([name, bm, "all_reduce", "compressed"])
            if cube.ndev != 8:
                continue            # the fused flows: the 8-PE cubes
            for alg in ("ring_fused", "ag_prologue"):
                for axis in (0, 1):
                    cells += 1
                    got = comm.all_gather(x, axis=axis, algorithm=alg)
                    if not torch.equal(got, _plain("all_gather", x, sizes,
                                                   axes, "add", axis)):
                        failed.append([name, bm, "all_gather", alg, axis])
            y = x[..., :32, :]
            for op in ("add", "max", "min"):
                for axis in (0, 1):
                    cells += 1
                    got = comm.reduce_scatter(y, axis=axis, op=op,
                                              algorithm="rs_epilogue")
                    if not torch.equal(got, _plain("reduce_scatter", y,
                                                   sizes, axes, op, axis)):
                        failed.append([name, bm, "reduce_scatter",
                                       "rs_epilogue", op, axis])
    return {"cells": cells, "failed": failed[:10], "compressed": compressed}


# -------------------------------------------------------------------- apps
# The paper's five applications at sizes that hold their inputs in hundreds
# of MB to GB on the card, each on the cube of the JAX bench
# (benchmarks/apps.py). DLRM: 26 tables as in the Criteo Kaggle setting of
# facebookresearch/dlrm, emb_dim 16, 1,000,000 rows a table (a cut from
# Kaggle's largest table of about 10 M rows), 2,048 samples a shard. DLRM,
# GNN and MLP draw their inputs from ``seed`` (the reference's constants
# would leave the scalar blind to where the collectives put the data).
APP_CASES = {
    "dlrm": ((2, 2, 2), dict(n_tables=26, emb_dim=16, rows=1_000_000,
                             batch_per_shard=2048, seed=0)),
    "gnn_rs_ar": ((4, 2), dict(n_nodes=32768, feat=256, seed=0)),
    "gnn_ar_ag": ((4, 2), dict(n_nodes=32768, feat=256, seed=0)),
    "bfs": ((8,), dict(n_nodes=32768, iters=8)),
    "cc": ((8,), dict(n_nodes=32768, iters=8)),
    "mlp": ((8,), dict(features=16384, layers=5, batch=64, seed=0)),
}
# the app's scalar against its plain version, relative: f32 sums of up to
# 2 M terms in another order (BFS and CC count integers: exact)
# BFS and CC at 32,768 nodes saturate within 8 iterations (every node
# visited; every label 0), where a misplaced block changes nothing: they
# are also run at these depths, before they saturate, exactly
APP_SHALLOW_ITERS = (1, 2)
APP_TOL = {"dlrm": 1e-4, "gnn_rs_ar": 1e-4, "gnn_ar_ag": 1e-4, "bfs": 0.0,
           "cc": 0.0, "mlp": 1e-4}


def _app_bytes(name, sizes, kw) -> dict:
    """The app's inputs as held on the card (a replicated input once, a
    stride-0 view on every PE) and what holding them on every PE, as the
    reference's devices do, would take; f32 unless named."""
    ndev = int(np.prod(sizes))
    if name == "dlrm":
        Dl = max(kw["emb_dim"] // sizes[2], 1)
        b_l = max(kw["batch_per_shard"], ndev)
        held = 4 * kw["n_tables"] * kw["rows"] * Dl + 8 * kw["n_tables"] * b_l
    elif name.startswith("gnn"):
        n, f = kw["n_nodes"], kw["feat"]
        nr, nc = sizes
        held = 4 * (n // nr * n // nc + n // nc * f + f * f // nc)
    elif name == "bfs":
        held = 4 * kw["n_nodes"] // ndev * kw["n_nodes"]
    elif name == "cc":
        held = kw["n_nodes"] // ndev * kw["n_nodes"]          # bool
    else:
        held = 4 * kw["layers"] * kw["features"] // ndev * kw["features"]
    return {"inputs_held_bytes": held, "inputs_on_every_pe_bytes": held * ndev}


def _plain_app(name, sizes, kw, dev, inputs) -> float:
    """The app written plainly as single tensors (the cube flattened) on
    its ``inputs`` (the app callable's ``.inputs``; None for BFS and CC):
    no communicator, the collectives of DLRM's chain the plain ones
    above."""
    ndev = int(np.prod(sizes))
    if name == "dlrm":
        T, rows = kw["n_tables"], kw["rows"]
        Dl = max(kw["emb_dim"] // sizes[2], 1)
        b_l, F_ = max(kw["batch_per_shard"], ndev), T * Dl
        tables = inputs["tables"]
        idx = torch.arange(b_l * T, device=dev).reshape(T, b_l) % rows
        emb = tables[torch.arange(T, device=dev)[:, None], idx]
        emb = emb.transpose(0, 1).reshape(b_l, F_)
        x = emb.expand(tuple(sizes) + (b_l, F_))     # every PE the same
        ex = _plain_all_to_all(x, sizes, [0, 1, 2], 0, 1)
        red = _plain("reduce_scatter", ex, sizes, [1], "add", 1)
        rel = _plain_all_to_all(red, sizes, [0, 2], 1, 0)
        out = torch.relu(rel @ inputs["w0"]) @ inputs["w1"]
        return float(out.sum())
    if name.startswith("gnn"):
        nc = sizes[1]
        agg = nc * (inputs["adj"] @ inputs["feats"])   # summed over c
        if name == "gnn_rs_ar":                   # member r keeps block r
            out = sum(b @ inputs["w"] for b in torch.chunk(agg, nc, dim=1))
        else:
            comb = agg @ inputs["w"]
            out = torch.cat([comb] * nc, dim=1)
        return float(torch.relu(out).sum())
    if name in ("bfs", "cc"):
        n, n_l = kw["n_nodes"], kw["n_nodes"] // ndev
        i = torch.arange(n_l, device=dev)[:, None]
        j = torch.arange(n, device=dev)[None]
        if name == "bfs":
            adj = ((i * 31 + j * 17) % 97 < 3).to(torch.float32)
            v = torch.zeros(n, device=dev)
            v[0] = 1.0
            for _ in range(kw["iters"]):   # every PE relaxes the same rows
                v = torch.maximum(v, ((adj @ v) > 0).float().repeat(ndev))
            return float(v.sum())
        adj = (i * 13 + j * 7) % 89 < 3
        lab = torch.arange(n, dtype=torch.float32, device=dev)
        for _ in range(kw["iters"]):
            neigh = torch.where(adj, lab[None], float(n + 1)).amin(dim=1)
            lab = torch.minimum(lab, neigh.repeat(ndev))
        return float(lab.sum())
    x = inputs["x"]
    h = x.expand((ndev,) + tuple(x.shape))             # each PE's block
    for w in inputs["ws"]:
        full = torch.relu(h @ w).sum(0)                # reduce over the PEs
        h = torch.stack(torch.chunk(full, ndev, dim=1))  # PE r: block r
    return float(h[0].sum())


def _call_ms(run, reps: int = 3) -> float:
    """Device-timeline ms of one app call between CUDA events (each call
    ends in a synchronize, so host work between launches counts)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_apps(dev, kept_reorder: dict) -> dict:
    """The six apps under naive and pidcomm, one at a time: the scalar
    against the plain version on the first run's inputs (both runs draw
    the same from one seed; APP_TOL), ms per call, peak memory, the
    reorder kernel's launches (counted from 0 just before one call and read
    just after: exactly 2 a DLRM call under pidcomm, its AA(xyz) and AA(xz),
    whose first launch's inputs are kept for main_path)."""
    from repro_torch.apps import paper_apps
    from repro_torch.core.hypercube import Hypercube
    from repro_torch.kernels.reorder import reorder
    names = ("x", "y", "z")
    out, ok, dlrm_launches = {}, True, 0
    for name, (sizes, kw) in APP_CASES.items():
        make = paper_apps.APPS[name][0]
        cube = Hypercube.build(dict(zip(names, sizes)))
        rows, plain = {}, None
        for alg in ("naive", "pidcomm"):
            run = make(cube, algorithm=alg, device=dev, **kw)
            if plain is None:
                plain = _plain_app(name, sizes, kw, dev,
                                   getattr(run, "inputs", None))
                torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            run()                                        # warm
            first = []
            keep = (record_reorder(first) if name == "dlrm"
                    and alg == "pidcomm" else contextlib.nullcontext())
            reorder.LAUNCHES = 0
            with keep:
                value = run()
            launches = reorder.LAUNCHES
            if first:
                kept_reorder["dlrm_aa_xyz"] = first[0]
                dlrm_launches += launches
            ms = _call_ms(run)
            tol = APP_TOL[name] * abs(plain)
            row = {"value": value, "plain": plain,
                   "err": abs(value - plain), "bound": tol,
                   "ms": ms, "reorder_launches": launches,
                   "peak_mem_gb": torch.cuda.max_memory_allocated(dev)
                   / 2**30}
            row["ok"] = (row["err"] <= tol and np.isfinite(value)
                         and (launches == 2 if name == "dlrm"
                              and alg == "pidcomm" else True))
            ok &= row["ok"]
            rows[alg] = row
            del run, first
            gc.collect()
            torch.cuda.empty_cache()
        out[name] = {"cube": list(sizes), **kw, **_app_bytes(name, sizes, kw),
                     **rows,
                     "pidcomm_speedup": rows["naive"]["ms"]
                     / rows["pidcomm"]["ms"]}
        if name in ("bfs", "cc"):
            out[name]["shallow"] = shallow = _shallow_graph_app(
                make, cube, name, sizes, kw, rows["naive"]["value"], dev)
            ok &= all(r["ok"] for r in shallow)
    return {"ok": ok, "apps": out, "dlrm_reorder_launches": dlrm_launches}


def _shallow_graph_app(make, cube, name, sizes, kw, saturated, dev) -> list:
    """BFS or CC at APP_SHALLOW_ITERS under naive and pidcomm: the scalar
    equal to the plain version's and off the saturated full-depth one."""
    rows = []
    for iters in APP_SHALLOW_ITERS:
        at = {**kw, "iters": iters}
        plain = _plain_app(name, sizes, at, dev, None)
        for alg in ("naive", "pidcomm"):
            value = make(cube, algorithm=alg, device=dev, **at)()
            rows.append({"iters": iters, "algorithm": alg, "value": value,
                         "plain": plain,
                         "ok": value == plain and value != saturated})
    return rows


# ------------------------------------------------------------------- serve
@contextlib.contextmanager
def patched(module, name: str, wrap):
    """While open, ``module.<name>`` is ``wrap(original)``."""
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def keep_kernel_inputs(kept: dict, label: str):
    """While open, every launch of the flash wrapper also stores its inputs
    under ``label`` (the last launch wins), so the kernel can be checked and
    timed afterwards on exactly what the serving path gave it."""
    from repro_torch.kernels.attention import flash

    def wrap(launch):
        def keeping(q, k, v, q_pos, k_pos, **kw):
            kept[label] = (q, k, v, q_pos, k_pos, kw)
            return launch(q, k, v, q_pos, k_pos, **kw)
        return keeping

    return patched(flash, "flash_attention", wrap)


def keep_reorder_inputs(kept: dict, label: str):
    """While open, every launch of the reorder wrapper also stores its
    inputs under ``label`` (the last launch wins)."""
    from repro_torch.kernels.reorder import reorder

    def wrap(launch):
        def keeping(x, perm):
            kept[label] = (x, perm)
            return launch(x, perm)
        return keeping

    return patched(reorder, "tile_swizzle", wrap)


def record_reorder(calls: list):
    """While open, every launch of the reorder wrapper also appends its
    inputs to ``calls``."""
    from repro_torch.kernels.reorder import reorder

    def wrap(launch):
        def recording(x, perm):
            calls.append((x, perm))
            return launch(x, perm)
        return recording

    return patched(reorder, "tile_swizzle", wrap)


def watch_rwkv6(on_launch):
    """While open, every launch of the RWKV6 wrapper also calls
    ``on_launch(inputs, outputs)``."""
    from repro_torch.kernels.rwkv6 import rwkv6

    def wrap(launch):
        def watching(r, k, v, logw, u, state=None):
            out = launch(r, k, v, logw, u, state)
            on_launch((r, k, v, logw, u, state), out)
            return out
        return watching

    return patched(rwkv6, "rwkv6_chunked", wrap)


def record_routes(calls: list):
    """While open, every MoE routing appends its top-k expert ids per PE,
    ``(PEs, tokens, k)``, to ``calls`` (device tensors: no sync)."""
    from repro_torch.models import blocks

    def wrap(route):
        def recording(cfg, hn2d, router, cn):
            topi, topv, probs = route(cfg, hn2d, router, cn)
            calls.append(topi.reshape((-1,) + tuple(topi.shape[cn:])))
            return topi, topv, probs
        return recording

    return patched(blocks, "_route", wrap)


def _routes(calls: list, steps: int) -> torch.Tensor:
    """Recorded routings as (steps, layers, B, k) from PE 0; every PE of a
    run routes the same replicated tokens, so the PEs must agree."""
    r = torch.stack(calls)                          # (calls, PEs, B, k)
    if not bool((r == r[:, :1]).all()):
        raise RuntimeError("PEs of one run routed the same tokens apart")
    return r[:, 0].reshape((steps, -1) + tuple(r.shape[2:]))


# device kernels of the port, by the name of their CUDA function
KERNEL_NAMES = {"flash": ("flash_decode_kernel", "flash_fwd_mma_kernel",
                          "flash_fwd_f32_kernel"),
                "flash_bwd": ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel",
                              "flash_bwd_dq_mma_kernel",
                              "flash_bwd_dkdv_mma_kernel"),
                "reorder": ("tile_swizzle",),
                "rwkv6": ("rwkv6_kernel",),
                "rwkv6_bwd": ("rwkv6_bwd_state_kernel",
                              "rwkv6_bwd_chunk_kernel", "rwkv6_du_kernel")}


# the backward kernel's two passes (f32 and bf16 forms), by name prefix
FLASH_BWD_PASSES = {"dq": "flash_bwd_dq_", "dkdv": "flash_bwd_dkdv_"}


def profile_decode(run, dev, steps: int = 3) -> dict:
    """Where a decode step's time goes: ``steps`` steps of the same server
    under ``torch.profiler`` (after one warm step), device kernels summed by
    name, the flash kernel's share of device time, and the device's idle
    share of the profiled wall time (profiling adds host overhead, so the
    idle share is an upper bound)."""
    from repro_torch.models.serving import Server, init_cache
    cfg, topo, plan = run["cfg"], run["topo"], run["plan"]
    server = run.get("server") or Server(cfg, topo, plan)
    cache = init_cache(cfg, topo, plan, dtype=server.dtype, device=dev)
    cube, ba = topo.cube, plan.batch_axes or None
    toks = torch.from_numpy(run["tokens"]).to(dev)

    def step(t):
        pos = torch.full((BATCH,), t, dtype=torch.int64, device=dev)
        server.decode_shard(run["params"], cache,
                            cube.to_cube(toks[:, t], (ba,)),
                            cube.to_cube(pos, (ba,)))

    return profile_steps(step, steps)


def profile_steps(step, steps: int = 3) -> dict:
    """``step(0)`` once to warm, then ``step(1..steps)`` under
    ``torch.profiler``: device kernels summed by name, each kernel's share
    of device time, the backward kernel's device ms a step by pass, and
    the device's idle share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(1, 1 + steps):
            step(t)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            row = by_name.setdefault(ev.name, [0.0, 0])
            row[0] += ev.time_range.elapsed_us()
            row[1] += 1
    busy = sum(r[0] for r in by_name.values())
    if busy <= 0:
        raise RuntimeError("the profiler traced no device events")
    shares = {f"{k}_share_of_device":
              sum(r[0] for name, r in by_name.items()
                  if any(fn in name for fn in fns)) / busy
              for k, fns in KERNEL_NAMES.items()}
    passes = {p: sum(r[0] for name, r in by_name.items() if pre in name)
              / 1e3 / steps for p, pre in FLASH_BWD_PASSES.items()}
    rwkv_passes = {p: sum(r[0] for name, r in by_name.items() if fn in name)
                   / 1e3 / steps for p, fn in RWKV6_BWD_PASSES.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"steps": steps,
            "wall_ms_per_step": wall_us / 1e3 / steps,
            "device_busy_ms_per_step": busy / 1e3 / steps,
            "idle_share": max(0.0, 1.0 - busy / wall_us),
            **shares, "flash_bwd_pass_ms_per_step": passes,
            "rwkv6_bwd_pass_ms_per_step": rwkv_passes,
            "kernels_per_step": sum(r[1] for r in by_name.values()) / steps,
            "top": [[k[:80], v[0] / 1e3 / steps, v[1] // steps]
                    for k, v in top]}


def phase_serve(dev, kept: dict) -> dict:
    """The main path; ``kept`` receives the kernel's inputs per form."""
    from repro_torch.kernels.attention import flash
    from repro_torch.launch.serve import serve
    from repro_torch.models.lm import Model
    from repro_torch.models.topology import build_topology

    flash.LAUNCHES = 0          # the main path's run starts here
    runs, launches = {}, 0
    for pes in PES:
        torch.cuda.reset_peak_memory_stats(dev)
        n0 = flash.LAUNCHES
        t0 = time.perf_counter()
        with keep_kernel_inputs(kept, f"decode/{pes}pe"):
            run = serve(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                        pes=pes, device=dev, seed=0, keep_logits=True)
        serve_s = time.perf_counter() - t0
        n_dec = flash.LAUNCHES - n0
        cfg = dataclasses.replace(run["cfg"], tp=pes)
        ftopo = build_topology(cfg, pes)
        if ftopo.cube != run["topo"].cube:
            raise RuntimeError("forward and serve cubes differ")
        # forward over the whole sequence (its length must split over the
        # sequence-parallel PEs); position t's logits follow decode step t
        toks = torch.from_numpy(run["tokens"]).to(dev)
        n1 = flash.LAUNCHES
        with keep_kernel_inputs(kept, f"forward/{pes}pe"):
            fwd = Model(cfg, ftopo).forward_logits(
                run["params"],
                {"tokens": ftopo.cube.to_cube(toks, (ftopo.dp, None))})
        fwd = ftopo.cube.from_cube(fwd, (ftopo.dp, None, ftopo.tp))[:, :-1]
        torch.cuda.synchronize()
        n_fwd = flash.LAUNCHES - n1
        dec = torch.stack(run["logits"], dim=1)           # (B, S-1, Vp)
        scale = max(1.0, float(fwd.abs().max()))
        err = float((dec - fwd).abs().max())
        runs[pes] = {
            "tokens": run["tokens"], "dec": dec, "fwd": fwd,
            "summary": {
                "pes": pes, "cube": run["topo"].cube.describe(),
                "ms_per_step": run["ms_per_step"],
                "p75_ms_per_step": float(np.percentile(run["step_ms"][1:],
                                                       75)),
                "steps_timed": len(run["step_ms"]) - 1,
                "tok_per_s": run["tok_per_s"],
                "serve_s": serve_s,
                "flash_launches_decode": n_dec,
                "flash_launches_forward": n_fwd,
                "decode_vs_forward_err": err,
                "bound": SERVE_TOL * scale,
                "decode_greedy_matches_forward": float(
                    (dec.argmax(-1) == fwd.argmax(-1)).float().mean()),
                "finite": bool(torch.isfinite(dec).all()
                               and torch.isfinite(fwd).all()),
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30,
            }}
        launches += n_dec + n_fwd      # the profiled steps below are not
        runs[pes]["summary"]["profile"] = profile_decode(run, dev)
        del run
        torch.cuda.empty_cache()

    a, b = runs[PES[0]], runs[PES[-1]]
    # steps whose inputs agree: the prompt, then while greedy tokens agree
    same = np.cumprod(a["tokens"][:, :-1] == b["tokens"][:, :-1], axis=1)
    same = torch.from_numpy(same.astype(bool)).to(dev)
    scale = max(1.0, float(a["fwd"].abs().max()))
    pe_err = max(float((a[x] - b[x]).abs()[same].max()) for x in
                 ("dec", "fwd"))
    gen_agree = float((a["tokens"][:, PROMPT:] == b["tokens"][:, PROMPT:])
                      .mean())
    sums = [runs[p]["summary"] for p in PES]
    ok = (all(s["decode_vs_forward_err"] <= s["bound"] and s["finite"]
              and s["flash_launches_decode"] > 0
              and s["flash_launches_forward"] > 0 for s in sums)
          and pe_err <= SERVE_TOL * scale)
    return {"ok": ok, "arch": ARCH, "batch": BATCH, "prompt_len": PROMPT,
            "gen": GEN, "runs": sums, "pe1_vs_pe8_err": pe_err,
            "pe1_vs_pe8_bound": SERVE_TOL * scale,
            "compared_steps": int(same.sum()),
            "greedy_agreement_pe1_pe8": gen_agree,
            "flash_launches": launches}


# -------------------------------------------------------------- serve_engine
def _engine_tokens(m: dict) -> dict:
    return {r.rid: list(r.out_tokens) for r in m["finished"]}


def _fresh(reqs, **changes) -> list:
    """Copies of ``reqs`` as submitted (an engine fills its requests)."""
    return [dataclasses.replace(q, out_tokens=[], admitted_step=-1,
                                finished_step=-1, preemptions=0, **changes)
            for q in reqs]


def _engine_run(make, reqs, *, dev, keep=None, **kw) -> dict:
    """One ``ServeEngine.run`` of ``reqs`` on a fresh engine, with the
    flash launches counted from 0 just before it and read just after, the
    lower cache emptied first, the page occupancy after every step, and
    the peak device memory."""
    from repro_torch.core import program
    from repro_torch.kernels.attention import flash
    eng = make(**kw)
    occ = []
    step = eng.step

    def stepping():
        step()
        occ.append(eng.metrics.value("serve.page_occupancy"))

    eng.step = stepping
    program.clear_lower_cache()
    low0 = dict(program.LOWER_STATS)
    torch.cuda.reset_peak_memory_stats(dev)
    flash.LAUNCHES = 0
    with keep if keep is not None else contextlib.nullcontext():
        m = eng.run(_fresh(reqs), max_steps=ENGINE_MAX_STEPS)
    torch.cuda.synchronize()
    del eng.step                    # the wrapper's cycle would keep eng
    launches = flash.LAUNCHES
    m.update(
        launches=launches,
        lowered=program.LOWER_STATS["lowered"] - low0["lowered"],
        cache_hits=program.LOWER_STATS["cache_hits"] - low0["cache_hits"],
        occupancy_mean=float(np.mean(occ)), occupancy_max=float(max(occ)),
        ms_per_step=eng.metrics.quantile("serve.step_seconds", 0.5) * 1e3,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30,
        tokens=_engine_tokens(m))
    return m


def _engine_summary(m: dict, n_layers: int, vocab: int, reqs) -> dict:
    """The run's numbers and its gates: every request finished with its
    max_new tokens in the vocab, one program a step, one lowering and a
    cache hit every step after, one flash launch a layer and step."""
    want = {r.rid: r.max_new for r in reqs}
    done = {r.rid: r.out_tokens for r in m["finished"]}
    return {
        "steps": m["steps"], "wall_s": m["wall_s"],
        "generated_tokens": m["generated_tokens"],
        "tok_per_s": m["tokens_per_s"],
        "p50_token_s": m["p50_token_s"], "p99_token_s": m["p99_token_s"],
        "ms_per_step": m["ms_per_step"], "peak_mem_gb": m["peak_mem_gb"],
        "page_occupancy_mean": m["occupancy_mean"],
        "page_occupancy_max": m["occupancy_max"],
        "preemptions": m["preemptions"],
        "programs_recorded": m["programs_recorded"],
        "lowered": m["lowered"], "lower_cache_hits": m["cache_hits"],
        "flash_launches": m["launches"],
        "expected_launches": n_layers * m["steps"],
        "complete": (set(done) == set(want) and all(
            len(done[i]) == want[i] and all(0 <= t < vocab for t in done[i])
            for i in want)),
        "programs_ok": (m["programs_recorded"] == m["steps"]
                        and m["lowered"] == 1
                        and m["cache_hits"] == m["steps"] - 1),
        "launches_ok": m["launches"] == n_layers * m["steps"]}


def _summary_ok(s: dict) -> bool:
    return s["complete"] and s["programs_ok"] and s["launches_ok"]


def phase_serve_engine(dev, kept: dict) -> dict:
    """The paged continuous-batching engine, qwen3-1.7b at full width and
    ENGINE_LAYERS of its 28 layers (bf16 over f32 master weights, random
    from seed 0), B = 4 lanes, S_ctx 48,
    page_size 3, at 1 and 8 PEs with one topology's weights on the card at
    a time (``_engine_cell``). ``kept`` receives the kernel's inputs of the
    lockstep runs' last launch."""
    from repro_torch import configs
    from repro_torch.serving import poisson_trace

    cfg = dataclasses.replace(configs.get(ARCH), n_layers=ENGINE_LAYERS)
    trace = poisson_trace(12, rate=0.5, plen_range=(8, 32),
                          max_new_range=(8, 16), vocab=cfg.vocab_size,
                          seed=7)
    out, launches, ok = {}, 0, True
    for pes in PES:
        r, n, cell_ok = _engine_cell(dev, kept, cfg, trace, pes)
        out[f"{pes}pe"] = r
        launches += n
        ok &= cell_ok
        gc.collect()                # the cell's weights leave the card
        torch.cuda.empty_cache()
    return {"ok": bool(ok), "arch": ARCH, "batch": BATCH,
            "cut": f"{ENGINE_LAYERS} of {_full_depth(ARCH)} layers",
            "S_ctx": PROMPT + GEN, "page_size": ENGINE_PAGE,
            "tight_pages_per_shard": ENGINE_TIGHT, "runs": out,
            "flash_launches": launches}


def _engine_cell(dev, kept: dict, cfg, trace, pes: int):
    """One PE count. Lockstep: the launcher's four prompts, all at step 0,
    give the launcher's greedy tokens exactly. The Poisson trace: complete,
    one program a step lowered once. At 1 PE the first 6 requests served
    alone give the batched tokens, and temperature 0.8 repeats under one
    seed; at 8 PEs lazy admission on small pools preempts and gives the
    reserve run's tokens. Every engine run launches the flash kernel once a
    layer and step. Returns (summaries, flash launches, ok)."""
    from repro_torch.kernels.attention import flash
    from repro_torch.launch.serve import serve
    from repro_torch.models.params import init_params
    from repro_torch.models.serving import make_serve_plan
    from repro_torch.models.topology import build_serve_topology
    from repro_torch.serving import Request, ServeEngine

    L, V = cfg.n_layers, cfg.vocab_size
    topo = build_serve_topology(cfg, pes)
    plan = make_serve_plan(cfg, topo, S_ctx=PROMPT + GEN, global_batch=BATCH)
    params = init_params(cfg, topo, 0, device=dev)

    def make(**kw):
        return ServeEngine(cfg, topo, plan, params, page_size=ENGINE_PAGE,
                           device=dev, **kw)

    r, launches = {}, 0
    # 1. lockstep against the launcher (its prompts: seed 0)
    launcher = serve(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN, pes=pes,
                     device=dev, seed=0, params=params, n_layers=L)
    ref = launcher["tokens"]
    lock = [Request(rid=b, prompt=ref[b, :PROMPT].tolist(), max_new=GEN)
            for b in range(BATCH)]
    m = _engine_run(make, lock, dev=dev, keep=keep_kernel_inputs(
        kept, f"engine_decode/{pes}pe"))
    got = np.array([m["tokens"][b] for b in range(BATCH)])
    r["lockstep"] = s = _engine_summary(m, L, V, lock)
    s["tokens_equal_launcher"] = bool(np.array_equal(got, ref[:, PROMPT:]))
    s["launcher_ms_per_step"] = launcher["ms_per_step"]
    ok = _summary_ok(s) and s["tokens_equal_launcher"]
    launches += m["launches"]
    # 2. the Poisson trace under reserve admission
    pm = _engine_run(make, trace, dev=dev)
    r["poisson"] = s = _engine_summary(pm, L, V, trace)
    ok &= _summary_ok(s)
    launches += pm["launches"]
    if pes == 1:
        # 3. batching invariance: the first 6 requests alone, in turn
        solo = make()
        flash.LAUNCHES = 0
        alone = {}
        for q in trace[:6]:
            ms = solo.run(_fresh([q], arrival=solo.step_idx),
                          max_steps=solo.step_idx + ENGINE_MAX_STEPS)
            alone[q.rid] = list(ms["finished"][-1].out_tokens)
        torch.cuda.synchronize()
        n_solo = flash.LAUNCHES
        launches += n_solo
        r["batching_invariance"] = s = {
            "requests": len(alone), "steps": solo.step_idx,
            "flash_launches": n_solo,
            "tokens_equal_batched": all(
                alone[i] == pm["tokens"][i] for i in alone)}
        ok &= s["tokens_equal_batched"] and n_solo == L * solo.step_idx
        # 5. temperature 0.8: twice under one seed
        hot = _fresh(trace[:6], temperature=0.8)
        t1 = _engine_run(make, hot, dev=dev, seed=11)
        t2 = _engine_run(make, hot, dev=dev, seed=11)
        r["temperature"] = s = _engine_summary(t1, L, V, hot)
        s["repeats_under_seed"] = t1["tokens"] == t2["tokens"]
        s["differs_from_greedy"] = any(
            t1["tokens"][i] != pm["tokens"][i] for i in t1["tokens"])
        ok &= _summary_ok(s) and s["repeats_under_seed"]
        launches += t1["launches"] + t2["launches"]
    else:
        # 4. preemption: lazy admission on pools of ENGINE_TIGHT pages
        lm = _engine_run(make, trace, dev=dev, admission="lazy",
                         pages_per_shard=ENGINE_TIGHT)
        r["preemption"] = s = _engine_summary(lm, L, V, trace)
        s["tokens_equal_reserve"] = lm["tokens"] == pm["tokens"]
        ok &= (_summary_ok(s) and s["preemptions"] > 0
               and s["tokens_equal_reserve"])
        launches += lm["launches"]
    # where a step's time goes (not counted: off the gated runs)
    prof = make()
    for q in _fresh(lock):
        prof.submit(q)
    r["profile"] = profile_steps(lambda t: prof.step())
    return r, launches, bool(ok)


def phase_serve_f32(dev) -> dict:
    """1 PE against 8 PEs in f32 (TF32 off): the sharded path and the
    combine must agree with the unsharded one far inside bf16's noise."""
    from repro_torch.launch.serve import serve
    got = {}
    for pes in PES:
        run = serve(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN, pes=pes,
                    device=dev, seed=0, dtype=torch.float32, keep_logits=True)
        got[pes] = (run["tokens"], torch.stack(run["logits"], dim=1),
                    run["ms_per_step"])
        del run
        torch.cuda.empty_cache()
    (ta, la, ma), (tb, lb, mb) = got[PES[0]], got[PES[-1]]
    scale = max(1.0, float(la.abs().max()))
    err = float((la - lb).abs().max())
    same_tokens = bool((ta == tb).all())
    return {"ok": err <= F32_TOL * scale and same_tokens
            and bool(torch.isfinite(la).all() and torch.isfinite(lb).all()),
            "pe1_vs_pe8_err": err, "bound": F32_TOL * scale,
            "greedy_tokens_identical": same_tokens,
            "greedy_agreement_pe1_pe8": float(
                (ta[:, PROMPT:] == tb[:, PROMPT:]).mean()),
            "ms_per_step": {f"{PES[0]}pe": ma, f"{PES[-1]}pe": mb}}


# the fused forward: tp = 2 on 8 PEs with a global batch of 2 leaves
# data = 2 and cp = 2 (build_topology), so ring attention runs over cp
FUSED_PES, FUSED_BATCH, FUSED_SEQ = 8, 2, 2048


def watch_flash(forms: list, last: dict):
    """While open, every launch of the flash wrapper appends its form
    (True: partial) to ``forms``, and the last partial launch's inputs are
    ``last["partial"]``."""
    from repro_torch.kernels.attention import flash

    def wrap(launch):
        def watching(q, k, v, q_pos, k_pos, **kw):
            forms.append(bool(kw.get("partial")))
            if forms[-1]:
                last["partial"] = (q, k, v, q_pos, k_pos, kw)
            return launch(q, k, v, q_pos, k_pos, **kw)
        return watching

    return patched(flash, "flash_attention", wrap)


def phase_fused_forward(dev, kept: dict) -> dict:
    """Full-width qwen3-1.7b ``forward_logits`` at 8 PEs with tp = 2 and
    cp = 2 (global batch 2 of 2,048 tokens: 1,024 a cp shard), with
    ``fused_comm`` on (ring attention over cp, each hop one launch of the
    flash kernel's partial form; the norm in the tp gather ring; the
    out-projections' reduce_scatters as lazy-tile epilogues) and off: bf16
    within SERVE_TOL and f32 (TF32 off) within F32_TOL x max(1, max|ref|)
    of unfused; the flash kernel launched exactly n_layers x cp times a
    fused forward, all partial (counted from 0 just before each forward
    and read just after), n_layers times unfused. The inputs of the last
    partial launch are kept for main_path."""
    from repro_torch import configs
    from repro_torch.core.comm import CommTrace
    from repro_torch.kernels.attention import flash
    from repro_torch.models.lm import Model
    from repro_torch.models.params import init_params
    from repro_torch.models.topology import build_topology
    cfg = dataclasses.replace(configs.get(ARCH), tp=2)
    topo = build_topology(cfg, FUSED_PES, global_batch=FUSED_BATCH)
    cp = topo.size(topo.cp)
    if cp != 2:
        raise RuntimeError(f"expected cp = 2, got {topo.cube.describe()}")
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, topo, 0, device=dev)
    cube = topo.cube
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (FUSED_BATCH, FUSED_SEQ))).to(dev)
    batch = {"tokens": cube.to_cube(toks, (topo.dp, None))}

    def forward(fused: bool, dtype) -> dict:
        forms, last = [], {}
        c = dataclasses.replace(cfg, fused_comm=fused)
        flash.LAUNCHES = 0
        t0 = time.perf_counter()
        with watch_flash(forms, last), CommTrace() as tr:
            out = Model(c, topo, dtype=dtype).forward_logits(params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if fused and dtype == torch.bfloat16 and last:
            kept[f"ring_hop/{FUSED_PES}pe"] = last["partial"]
        return {"logits": cube.from_cube(out, (topo.dp, None, topo.tp)),
                "launches": flash.LAUNCHES, "partial_launches": sum(forms),
                "s": secs, "flows": sorted(tr.summary()["by_flow"])}

    runs, ok, launches = {}, True, 0
    for dtype, tol in ((torch.bfloat16, SERVE_TOL),
                       (torch.float32, F32_TOL)):
        base = forward(False, dtype)
        fused = forward(True, dtype)
        held = _held(fused["logits"], base["logits"], tol)
        row = {"fused_vs_unfused": held,
               "finite": bool(torch.isfinite(fused["logits"]).all()),
               "fused_launches": fused["launches"],
               "fused_partial_launches": fused["partial_launches"],
               "unfused_launches": base["launches"],
               "expected_fused_launches": cfg.n_layers * cp,
               "fused_s": fused["s"], "unfused_s": base["s"],
               "fused_flows": fused["flows"]}
        row["ok"] = (held["ok"] and row["finite"]
                     and fused["launches"] == fused["partial_launches"]
                     == cfg.n_layers * cp
                     and base["launches"] == cfg.n_layers
                     and base["partial_launches"] == 0)
        ok &= row["ok"]
        launches += fused["launches"] + base["launches"]
        runs[str(dtype).split(".")[-1]] = row
        del base, fused
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del params
    torch.cuda.empty_cache()
    return {"ok": ok and f"ring_hop/{FUSED_PES}pe" in kept, "arch": ARCH,
            "cube": cube.describe(), "tokens": [FUSED_BATCH, FUSED_SEQ],
            "s_loc": FUSED_SEQ // cp, "runs": runs,
            "flash_launches": launches, "peak_mem_gb": peak}


def _moe_run(dev, pes, dtype, kept=None, kept_reorder=None, *,
             arch=MOE_ARCH, layers=None, label="moe") -> dict:
    """One full-width MoE serve at ``pes`` PEs (``layers`` deep, else the
    arch's depth), both kernels' counts set to 0 just before it and read
    just after; the routings recorded, and with ``kept`` the inputs of each
    kernel's last launch (flash under ``<label>/decode/<pes>pe``, the
    reorder under ``decode/<pes>pe`` for qwen2-moe, else
    ``<label>/decode/<pes>pe``)."""
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.reorder import reorder
    from repro_torch.launch.serve import serve
    calls = []
    torch.cuda.reset_peak_memory_stats(dev)
    keep = contextlib.ExitStack()
    if kept is not None:
        keep.enter_context(keep_kernel_inputs(kept,
                                              f"{label}/decode/{pes}pe"))
        keep.enter_context(keep_reorder_inputs(
            kept_reorder, f"decode/{pes}pe" if arch == MOE_ARCH
            else f"{label}/decode/{pes}pe"))
    flash.LAUNCHES = reorder.LAUNCHES = 0       # this path's run starts here
    t0 = time.perf_counter()
    with keep, record_routes(calls):
        run = serve(arch, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                    pes=pes, device=dev, seed=0, dtype=dtype,
                    keep_logits=True, n_layers=layers)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    n_flash, n_reorder = flash.LAUNCHES, reorder.LAUNCHES
    steps = len(run["step_ms"])
    run.update(
        dec=torch.stack(run["logits"], dim=1), routes=_routes(calls, steps),
        summary={
            "pes": pes, "cube": run["topo"].cube.describe(),
            "dtype": str(dtype).split(".")[-1],
            "ms_per_step": run["ms_per_step"],
            "p75_ms_per_step": float(np.percentile(run["step_ms"][1:], 75)),
            "steps_timed": steps - 1, "tok_per_s": run["tok_per_s"],
            "serve_s": serve_s,
            "flash_launches": n_flash, "reorder_launches": n_reorder,
            "expected_flash_launches": run["cfg"].n_layers * steps,
            "expected_reorder_launches": (
                2 * run["cfg"].n_layers * steps if pes > 1 else 0),
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30,
            "card_mem_gb": torch.cuda.get_device_properties(dev)
            .total_memory / 2**30,
        })
    run["summary"]["finite"] = bool(torch.isfinite(run["dec"]).all())
    return run


def _moe_ok(s: dict) -> bool:
    return (s["finite"]
            and s["flash_launches"] == s["expected_flash_launches"]
            and s["reorder_launches"] == s["expected_reorder_launches"]
            and s["peak_mem_gb"] < s["card_mem_gb"])


def _drop(run, *extra) -> dict:
    """What the comparison needs of a run (tokens, decode logits, summary,
    and the ``extra`` keys); the weights leave the card."""
    out = {k: run[k] for k in ("tokens", "dec", "summary", *extra)}
    run.clear()
    torch.cuda.empty_cache()
    return out


def phase_serve_moe(dev, kept: dict, kept_reorder: dict,
                    moe_sort: dict) -> dict:
    """The MoE main path in bf16 at 1 and 8 PEs; ``kept`` and
    ``kept_reorder`` receive the inputs of each kernel's last launch, and
    ``moe_sort`` the sort-vs-scatter check on the 8-PE run's weights
    (reported by serve_prefill)."""
    runs = {}
    for pes in PES:
        run = _moe_run(dev, pes, torch.bfloat16, kept, kept_reorder,
                       layers=MOE_SERVE_LAYERS)
        run["summary"]["profile"] = profile_decode(run, dev)
        if pes == PES[-1]:
            moe_sort.update(_moe_sort_vs_scatter(run, dev))
        runs[pes] = _drop(run, "routes")
    a, b = runs[PES[0]], runs[PES[-1]]
    # steps whose inputs agree: the prompt, then while greedy tokens agree
    same = np.cumprod(a["tokens"][:, :-1] == b["tokens"][:, :-1], axis=1)
    same_t = torch.from_numpy(same.astype(bool)).to(dev)     # (B, steps)
    scale = max(1.0, float(a["dec"].abs().max()))
    pe_err = float((a["dec"] - b["dec"]).abs()[same_t].max())
    route_same = (a["routes"] == b["routes"]).all(-1)        # (S, L, B)
    agree = route_same.permute(0, 2, 1)[same_t.T]            # (n, L)
    sums = [runs[p]["summary"] for p in PES]
    return {"ok": all(_moe_ok(s) for s in sums), "arch": MOE_ARCH,
            "batch": BATCH, "prompt_len": PROMPT, "gen": GEN, "runs": sums,
            "pe1_vs_pe8_err": pe_err, "pe1_vs_pe8_scale": scale,
            "compared_steps": int(same_t.sum()),
            "routing_agreement_pe1_pe8": float(agree.float().mean()),
            "routing_agreement_by_layer": [
                round(float(v), 4) for v in agree.float().mean(0)],
            "greedy_agreement_pe1_pe8": float(
                (a["tokens"][:, PROMPT:] == b["tokens"][:, PROMPT:]).mean()),
            "reorder_launches": sum(s["reorder_launches"] for s in sums),
            "flash_launches": sum(s["flash_launches"] for s in sums)}


def phase_serve_moe_f32(dev) -> dict:
    """1 PE against 8 PEs in f32 (TF32 off): logits within 1e-4 x
    max(1, max|ref|), identical greedy tokens, identical top-k expert ids
    at every (step, layer, request)."""
    runs = {pes: _drop(_moe_run(dev, pes, torch.float32,
                                layers=MOE_SERVE_LAYERS), "routes")
            for pes in PES}
    a, b = runs[PES[0]], runs[PES[-1]]
    scale = max(1.0, float(a["dec"].abs().max()))
    err = float((a["dec"] - b["dec"]).abs().max())
    same_tokens = bool((a["tokens"] == b["tokens"]).all())
    same_routes = bool(torch.equal(a["routes"], b["routes"]))
    sums = [runs[p]["summary"] for p in PES]
    return {"ok": (err <= F32_TOL * scale and same_tokens and same_routes
                   and all(_moe_ok(s) for s in sums)),
            "pe1_vs_pe8_err": err, "bound": F32_TOL * scale,
            "greedy_tokens_identical": same_tokens,
            "routes_identical": same_routes,
            "routing_decisions": int(a["routes"][..., 0].numel()),
            "runs": sums}


# --------------------------------------------------------------- mixtral
# mixtral-8x7b served through the launcher's function at full width and 4 of
# its 32 layers: 1.45 B parameters a layer (8 experts of 3 x 4,096 x
# 14,336), 6.07 B with the embeddings, whose f32 masters (24.3 GB) and
# their bf16 copies fit one topology at a time; 8 layers would hold 47.6 GB
# of masters beside 23.8 GB of copies. Its window of 4,096 never binds at 48
# positions.
MIXTRAL_SERVE_LAYERS = 4


def _dropped(routes: torch.Tensor, C: int, n_experts: int) -> torch.Tensor:
    """(..., T) bool: whether token t lost a choice to its expert's
    capacity ``C``, from its routes (..., T, k), ranked as
    ``blocks._expert_ffn`` ranks them (by token order within the
    expert)."""
    *lead, T, k = routes.shape
    flat = routes.reshape(*lead, T * k).long()
    oh = F.one_hot(flat, n_experts)
    pos = (oh.cumsum(-2) - oh).gather(-1, flat[..., None])[..., 0]
    return (pos >= C).reshape(*lead, T, k).any(-1)


def _moe_forward(run, dtype, tokens) -> tuple:
    """``forward_logits`` of ``tokens`` (B, S) on an MoE run's weights on the
    forward topology of its cube, with the routings recorded: global logits
    (B, S, V_padded), the routes (layers, B, S, k) (from PE 0 where every
    PE routes the same replicated tokens; from each PE's positions where
    the sequence is split over the PEs), whether each (layer, b, s) lost a
    choice to capacity (each PE ranks its own tokens), and the flash and
    reorder launches of the forward."""
    from repro_torch.models.lm import Model
    from repro_torch.models.topology import build_topology
    topo = run["topo"]
    cfg = dataclasses.replace(run["cfg"], ep=topo.size(topo.ep),
                              etp=topo.size(topo.etp))
    ftopo = build_topology(cfg, topo.cube.ndev)
    if ftopo.cube != topo.cube:
        raise RuntimeError("forward and serve cubes differ")
    calls = []
    with record_routes(calls):
        out, nf, nr = _counted(lambda: Model(cfg, ftopo, dtype=dtype)
                               .forward_logits(run["params"], {
                                   "tokens": ftopo.cube.to_cube(
                                       tokens, (ftopo.dp, None))}))
    r = torch.stack(calls)               # (layers, PEs, tokens a PE, k)
    (L, P, n, k), (B, S) = r.shape, tokens.shape
    C = int(math.ceil(n * k / cfg.n_experts_padded * cfg.capacity_factor))
    drop = _dropped(r, C, cfg.n_experts_padded)          # (L, P, n)
    if n == B * S:       # replicated tokens: every PE routes them alike
        if not bool((r == r[:, :1]).all()):
            raise RuntimeError("PEs of one forward routed the same tokens "
                               "apart")
        routes, drop = r[:, 0].reshape(L, B, S, k), drop[:, 0].reshape(
            L, B, S)
    else:                # sequence-parallel: PE i holds positions i S / P ..
        routes = (r.reshape(L, P, B, S // P, k).permute(0, 2, 1, 3, 4)
                  .reshape(L, B, S, k))
        drop = (drop.reshape(L, P, B, S // P).permute(0, 2, 1, 3)
                .reshape(L, B, S))
    return (ftopo.cube.from_cube(out, (ftopo.dp, None, ftopo.tp)), routes,
            drop, nf, nr)


def _agreeing(same: torch.Tensor) -> torch.Tensor:
    """(B, steps) bool: the steps before which every step agreed (a step's
    inputs depend on every earlier step's)."""
    return torch.cumprod(same.int(), dim=1).bool()


def _mixtral_run(dev, pes: int, dtype, kept, kept_reorder) -> dict:
    """mixtral at ``pes`` PEs: the launcher's serve (exact launches: one
    flash launch per layer and step, two reorders at 8 PEs), then
    ``forward_logits`` of the served tokens (one flash launch and, at 8
    PEs, two reorders a layer). Decode is held to the forward at the
    positions whose routings agree with the forward's at every layer, at
    and before that position (a routing that differs is another function,
    and it feeds every later position through the cache): within SERVE_TOL
    (bf16) or F32_TOL (f32) x max(1, max|forward|). The expert capacity
    makes them different functions wherever a choice is dropped (decode
    ranks the B tokens of a step, the forward a PE's tokens of the whole
    sequence), so the positions compared also drop nothing, in either path
    and at any layer, at and before them."""
    run = _moe_run(dev, pes, dtype, kept, kept_reorder, arch=MIXTRAL_ARCH,
                   layers=MIXTRAL_SERVE_LAYERS, label="mixtral")
    cfg = run["cfg"]
    toks = torch.from_numpy(run["tokens"]).to(dev)
    fwd, f_routes, f_drop, nf, nr = _moe_forward(run, dtype, toks)
    fwd = fwd[:, :-1]
    torch.cuda.synchronize()
    B, steps = run["dec"].shape[:2]
    C_dec = max(int(math.ceil(B * cfg.top_k / cfg.n_experts_padded
                              * cfg.capacity_factor)), 1)
    d_drop = _dropped(run["routes"], C_dec, cfg.n_experts_padded)
    # decode step t routes position t: (steps, L, B, k) vs (L, B, S, k)
    same = (run["routes"].permute(2, 0, 1, 3)
            == f_routes[:, :, :steps].permute(1, 2, 0, 3)).all(-1).all(-1)
    no_drop = ~(d_drop.any(1).T | f_drop[:, :, :steps].any(0))  # (B, steps)
    mask = _agreeing(same & no_drop)
    tol = SERVE_TOL if dtype == torch.bfloat16 else F32_TOL
    scale = max(1.0, float(fwd.abs().max()))
    diff = (run["dec"] - fwd).abs().amax(-1)               # (B, steps)
    err = float(diff[mask].max()) if bool(mask.any()) else math.inf
    L = run["cfg"].n_layers
    s = run["summary"]
    s.update({
        "layers": L, "full_depth": _full_depth(MIXTRAL_ARCH),
        "forward_flash_launches": nf, "forward_reorder_launches": nr,
        "expected_forward_flash_launches": L,
        "expected_forward_reorder_launches": 2 * L if pes > 1 else 0,
        "decode_vs_forward_err": err, "decode_vs_forward_bound": tol * scale,
        "decode_vs_forward_err_everywhere": float(diff.max()),
        "positions_compared": int(mask.sum()),
        "positions": int(mask.numel()),
        "routing_agreement_decode_forward": float(same.float().mean()),
        "positions_dropping_a_choice": int((~no_drop).sum()),
        "forward_finite": bool(torch.isfinite(fwd).all())})
    s["ok"] = (_moe_ok(s) and s["forward_finite"]
               and nf == L and nr == s["expected_forward_reorder_launches"]
               and s["positions_compared"] > 0
               and err <= tol * scale)
    return run


def phase_serve_mixtral(dev, kept: dict, kept_reorder: dict) -> dict:
    """mixtral-8x7b (4 of 32 layers, full width, 8 experts top-2) through
    the launcher's function at 1 and 8 PEs (ep 8, etp 1: the reorder on
    both all_to_alls of every layer), one topology's weights on the card at
    a time, bf16 then f32 (TF32 off). Each run: ms/step, tok/s, peak
    memory, exact launches (flash 4 x 47 a decode run; reorder 2 x 4 x 47
    at 8 PEs), decode against forward_logits (``_mixtral_run``). 1 PE
    against 8 PEs: bf16 logits within SERVE_TOL x max(1, max|ref|) at the
    steps whose tokens and routings agreed so far; f32 logits within F32_TOL
    x max(1, max|ref|) everywhere, identical greedy tokens and identical
    top-2 expert ids at every (step, layer, request). bf16 keeps the
    kernels' inputs of each run's last launch and profiles three decode
    steps."""
    out, launches = {}, {"flash": 0, "reorder": 0}
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        runs = {}
        for pes in PES:
            run = _mixtral_run(dev, pes, dtype, kept if bf16 else None,
                               kept_reorder if bf16 else None)
            s = run["summary"]
            launches["flash"] += (s["flash_launches"]
                                  + s["forward_flash_launches"])
            launches["reorder"] += (s["reorder_launches"]
                                    + s["forward_reorder_launches"])
            if bf16:
                s["profile"] = profile_decode(run, dev)
            runs[pes] = _drop(run, "routes")
        a, b = runs[PES[0]], runs[PES[-1]]
        same = torch.from_numpy(a["tokens"][:, :-1] == b["tokens"][:, :-1]
                                ).to(dev)
        same_routes = (a["routes"] == b["routes"]).all(-1).all(1).T
        mask = _agreeing(same & same_routes)                # (B, steps)
        scale = max(1.0, float(a["dec"].abs().max()))
        diff = (a["dec"] - b["dec"]).abs().amax(-1)
        err = float(diff[mask].max()) if bool(mask.any()) else math.inf
        tol = SERVE_TOL if bf16 else F32_TOL
        cell = {"runs": [runs[p]["summary"] for p in PES],
                "pe1_vs_pe8_err": err, "pe1_vs_pe8_bound": tol * scale,
                "pe1_vs_pe8_err_everywhere": float(diff.max()),
                "compared_steps": int(mask.sum()),
                "greedy_tokens_identical": bool(
                    (a["tokens"] == b["tokens"]).all()),
                "routes_identical": bool(torch.equal(a["routes"],
                                                     b["routes"])),
                "routing_agreement_pe1_pe8": float(
                    (a["routes"] == b["routes"]).all(-1).float().mean()),
                "routing_decisions": int(a["routes"][..., 0].numel())}
        cell["ok"] = (all(r["ok"] for r in cell["runs"])
                      and cell["compared_steps"] > 0
                      and err <= tol * scale
                      and (bf16 or (cell["greedy_tokens_identical"]
                                    and cell["routes_identical"]
                                    and float(diff.max()) <= tol * scale)))
        out["bf16" if bf16 else "f32"] = cell
    return {"ok": out["bf16"]["ok"] and out["f32"]["ok"],
            "arch": MIXTRAL_ARCH, "cut": f"{MIXTRAL_SERVE_LAYERS} of "
            f"{_full_depth(MIXTRAL_ARCH)} layers", "batch": BATCH,
            "prompt_len": PROMPT, "gen": GEN, **out,
            "flash_launches": launches["flash"],
            "reorder_launches": launches["reorder"]}


# ----------------------------------------------------------- dense archs
def plain_flash():
    """While open, the model's attention runs the flash kernel's plain
    version on the card (a reference computation: no launch)."""
    from repro_torch.kernels.attention import ops, ref
    return patched(ops, "flash_attention", lambda _: ref.flash_attention)


def _dense_forward(run, pes: int, dtype, tokens) -> torch.Tensor:
    """``forward_logits`` of ``tokens`` (B, S) on the run's weights, on the
    forward topology of the run's cube: global logits (B, S, V_padded)."""
    from repro_torch.models.lm import Model
    from repro_torch.models.topology import build_topology
    cfg = dataclasses.replace(run["cfg"], tp=pes)
    ftopo = build_topology(cfg, pes)
    if ftopo.cube != run["topo"].cube:
        raise RuntimeError("forward and serve cubes differ")
    out = Model(cfg, ftopo, dtype=dtype).forward_logits(
        run["params"], {"tokens": ftopo.cube.to_cube(tokens, (ftopo.dp,
                                                               None))})
    return ftopo.cube.from_cube(out, (ftopo.dp, None, ftopo.tp))


def _dense_long_forward(run, dev, dtype, keep) -> dict:
    """gemma3's windowed forward over LONG_SEQ tokens at 1 PE: the local
    layers' 512-key window masks keys and the bf16 forward skips tiles.
    Held against the witness, the same forward with the plain version in
    the kernel's place, within F32_TOL (f32) or SERVE_TOL (bf16) x max(1,
    max|ref|); in bf16 the f32 forward of the same tokens is reported."""
    from repro_torch.kernels.attention import flash
    cfg = run["cfg"]
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (1, LONG_SEQ))).to(dev)
    n0 = flash.LAUNCHES
    with keep(f"forward{LONG_SEQ}"):
        got = _dense_forward(run, 1, dtype, toks)
    torch.cuda.synchronize()
    n_kernel = flash.LAUNCHES - n0
    with plain_flash():
        want = _dense_forward(run, 1, dtype, toks)
    torch.cuda.synchronize()
    out = {"seq": LONG_SEQ, "windows": sorted({int(w) for w in cfg.windows()}),
           "launches": n_kernel, "expected_launches": cfg.n_layers,
           "plain_witness_launches": flash.LAUNCHES - n0 - n_kernel,
           "finite": bool(torch.isfinite(got).all()),
           **_held(got, want, F32_TOL if dtype == torch.float32
                   else SERVE_TOL)}
    if dtype == torch.bfloat16:
        with plain_flash():
            f32 = _dense_forward(run, 1, torch.float32, toks)
        out.update(vs_f32_err=float((got - f32).abs().max()),
                   witness_vs_f32_err=float((want - f32).abs().max()))
    out["ok"] = (out["ok"] and out["finite"]
                 and out["launches"] == out["expected_launches"]
                 and out["plain_witness_launches"] == 0)
    return out


def _dense_run(dev, arch: str, pes: int, dtype, kept=None,
               n_layers: int | None = None) -> dict:
    """One full-width serve of a dense arch through the launcher's function
    (``n_layers`` deep, else at full depth), then ``forward_logits`` of the
    served tokens; the flash kernel's launches of each counted exactly (one
    per layer and decode step, one per layer and forward). With ``kept``,
    the inputs of the kernel's last launch on each path. gemma3 at 1 PE
    also runs the long forward."""
    from repro_torch.kernels.attention import flash
    from repro_torch.launch.serve import serve

    def keep(path):
        return (keep_kernel_inputs(kept, f"{arch}/{path}/{pes}pe")
                if kept is not None else contextlib.nullcontext())

    torch.cuda.reset_peak_memory_stats(dev)
    n0 = flash.LAUNCHES
    t0 = time.perf_counter()
    with keep("decode"):
        run = serve(arch, batch=BATCH, prompt_len=PROMPT, gen=GEN, pes=pes,
                    device=dev, seed=0, dtype=dtype, keep_logits=True,
                    n_layers=n_layers)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    n_dec = flash.LAUNCHES - n0
    toks = torch.from_numpy(run["tokens"]).to(dev)
    n1 = flash.LAUNCHES
    with keep("forward"):
        fwd = _dense_forward(run, pes, dtype, toks)[:, :-1]
    torch.cuda.synchronize()
    n_fwd = flash.LAUNCHES - n1
    dec = torch.stack(run["logits"], dim=1)               # (B, S-1, Vp)
    cfg, steps = run["cfg"], len(run["step_ms"])
    vs_fwd = _held(dec, fwd, SERVE_TOL if dtype == torch.bfloat16
                   else F32_TOL)
    s = {"arch": arch, "pes": pes, "cube": run["topo"].cube.describe(),
         "dtype": str(dtype).split(".")[-1],
         "ms_per_step": run["ms_per_step"],
         "p75_ms_per_step": float(np.percentile(run["step_ms"][1:], 75)),
         "steps_timed": steps - 1, "tok_per_s": run["tok_per_s"],
         "serve_s": serve_s,
         "flash_launches_decode": n_dec, "flash_launches_forward": n_fwd,
         "expected_launches_decode": cfg.n_layers * steps,
         "expected_launches_forward": cfg.n_layers,
         "decode_vs_forward_err": vs_fwd["err"],
         "decode_vs_forward_bound": vs_fwd["bound"],
         "decode_greedy_matches_forward": float(
             (dec.argmax(-1) == fwd.argmax(-1)).float().mean()),
         "finite": bool(torch.isfinite(dec).all()
                        and torch.isfinite(fwd).all())}
    if dtype == torch.bfloat16:
        # the size of bf16 rounding alone: the same tokens' f32 forward
        with plain_flash():
            f32 = _dense_forward(run, pes, torch.float32, toks)[:, :-1]
        s.update(decode_vs_f32_err=float((dec - f32).abs().max()),
                 forward_vs_f32_err=float((fwd - f32).abs().max()),
                 f32_max_logit=float(f32.abs().max()))
        del f32
    if arch == LONG_ARCH and pes == 1:
        s["long_forward"] = _dense_long_forward(run, dev, dtype, keep)
    s["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    s["layers"] = cfg.n_layers
    run.update(dec=dec, summary=s)
    return run


def _dense_ok(s: dict, gate_decode: bool) -> bool:
    return (s["finite"]
            and s["flash_launches_decode"] == s["expected_launches_decode"]
            and s["flash_launches_forward"] == s["expected_launches_forward"]
            and (not gate_decode
                 or s["decode_vs_forward_err"] <= s["decode_vs_forward_bound"])
            and s.get("long_forward", {"ok": True})["ok"])


def _dense_pair(runs: dict, pes: tuple) -> dict:
    """1 PE against n PEs of one arch: logits over the steps whose inputs
    agree (the prompt, then while greedy tokens agree), and the tokens.
    ``dec`` holds the logits of the last positions (all but the last
    token's; after a prefill, from the prompt's last on), over the vocab
    as each cube pads it: the columns both have are compared."""
    a, b = runs[pes[0]], runs[pes[-1]]
    same = np.cumprod(a["tokens"][:, :-1] == b["tokens"][:, :-1], axis=1)
    same = same[:, same.shape[1] - a["dec"].shape[1]:]
    same = torch.from_numpy(same.astype(bool)).to(a["dec"].device)
    V = min(a["dec"].shape[-1], b["dec"].shape[-1])
    return {"err": float((a["dec"][..., :V] - b["dec"][..., :V]).abs()[
                same].max()),
            "scale": max(1.0, float(a["dec"].abs().max())),
            "compared_steps": int(same.sum()),
            "tokens_identical": bool((a["tokens"] == b["tokens"]).all()),
            "greedy_agreement": float(
                (a["tokens"][:, PROMPT:] == b["tokens"][:, PROMPT:]).mean())}


def phase_serve_dense(dev, kept: dict) -> dict:
    """phi3-mini (hd 96, G = 1) at 1 and 8 PEs and gemma3 (hd 256, G = 4,
    5:1 local:global windows) at 1 and 4 PEs, full width, bf16: decode
    within SERVE_TOL x max(1, max|ref|) of forward_logits, 1 PE vs n PEs
    the same, exact flash launches per run, a decode profile per cell, and
    gemma3's 1,024-token forward against its plain witness. ``kept``
    receives the kernel's inputs of its last launch per path and run."""
    from repro_torch.kernels.attention import flash
    flash.LAUNCHES = 0          # the dense paths' runs start here
    out, ok, profiled = {}, True, 0
    for arch, pes_list in DENSE_ARCHS.items():
        runs = {}
        for pes in pes_list:
            run = _dense_run(dev, arch, pes, torch.bfloat16, kept,
                             n_layers=DENSE_SERVE_LAYERS[arch])
            n0 = flash.LAUNCHES     # the profiled steps are not the path's
            run["summary"]["profile"] = profile_decode(run, dev)
            profiled += flash.LAUNCHES - n0
            runs[pes] = _drop(run)
        pair = _dense_pair(runs, pes_list)
        sums = [runs[p]["summary"] for p in pes_list]
        arch_ok = (all(_dense_ok(s, True) for s in sums)
                   and pair["err"] <= SERVE_TOL * pair["scale"])
        ok &= arch_ok
        out[arch] = {"ok": arch_ok, "runs": sums, f"pe1_vs_pe{pes_list[-1]}":
                     pair, "flash_launches": sum(
                         s["flash_launches_decode"] + s["flash_launches_forward"]
                         + s.get("long_forward", {}).get("launches", 0)
                         for s in sums)}
    launches = flash.LAUNCHES - profiled
    counted = sum(out[a]["flash_launches"] for a in DENSE_ARCHS)
    return {"ok": ok and launches == counted, "batch": BATCH,
            "prompt_len": PROMPT, "gen": GEN, "archs": out,
            "flash_launches": launches, "profiled_launches": profiled}


def phase_serve_dense_f32(dev) -> dict:
    """The same archs in f32 (TF32 off): 1-PE vs n-PE logits within 1e-4 x
    max(1, max|ref|), identical greedy tokens, exact launches, and gemma3's
    1,024-token forward within 1e-4 x max(1, max|ref|) of its witness."""
    out, ok = {}, True
    for arch, pes_list in DENSE_ARCHS.items():
        runs = {pes: _drop(_dense_run(
            dev, arch, pes, torch.float32,
            n_layers=DENSE_SERVE_LAYERS[arch])) for pes in pes_list}
        pair = _dense_pair(runs, pes_list)
        sums = [runs[p]["summary"] for p in pes_list]
        arch_ok = (all(_dense_ok(s, False) for s in sums)
                   and pair["err"] <= F32_TOL * pair["scale"]
                   and pair["tokens_identical"])
        ok &= arch_ok
        out[arch] = {"ok": arch_ok, "runs": sums,
                     f"pe1_vs_pe{pes_list[-1]}": pair,
                     "bound": F32_TOL * pair["scale"]}
    return {"ok": ok, "archs": out}


# --------------------------------------------------------- serve_internlm2
INTERNLM2_ARCH = "internlm2-20b"
# serving depth: 12 of 48 layers (390 M parameters a layer). 36 fit the
# card (58.5 GB of f32 weights) but took 54 s of the run's 1,200 s limit
# at 1 and 16 PEs, bf16 and f32: the host-bound steps take time by the
# layer
INTERNLM2_SERVE_LAYERS = 12
INTERNLM2_PES = (1, 16)                # its own tp 16: KV 8 < tp


def _witness_decode(run, dev, dtype) -> dict:
    """The run's decode again on its weights with the flash kernel's plain
    version in its place (the witness: no launch), its logits against the
    run's at the steps whose inputs agree, within RWKV_PATH_TOL of the
    type x max(1, max|ref|)."""
    from repro_torch.kernels.attention import flash
    from repro_torch.launch.serve import serve
    n0 = flash.LAUNCHES
    with plain_flash():
        w = serve(run["cfg"].name, n_layers=run["cfg"].n_layers,
                  batch=BATCH, prompt_len=PROMPT, gen=GEN,
                  pes=math.prod(run["topo"].cube.dim_sizes),
                  device=dev, seed=0, dtype=dtype, params=run["params"],
                  keep_logits=True)
    wdec = torch.stack(w["logits"], dim=1)
    same = np.cumprod(run["tokens"][:, :-1] == w["tokens"][:, :-1], axis=1)
    same = torch.from_numpy(same.astype(bool)).to(dev)
    held = _held(run["dec"][same], wdec[same], RWKV_PATH_TOL[dtype])
    return {**held, "compared_steps": int(same.sum()),
            "greedy_agreement": float((run["tokens"][:, PROMPT:]
                                       == w["tokens"][:, PROMPT:]).mean()),
            "witness_launches": flash.LAUNCHES - n0,
            "ok": held["ok"] and flash.LAUNCHES == n0}


def phase_serve_internlm2(dev, kept: dict, dtype=torch.bfloat16) -> dict:
    """internlm2-20b at full width and INTERNLM2_SERVE_LAYERS of its 48
    layers (48 / 8 heads of 128: G = 6) at 1 PE and at 16 PEs, its own tp
    (8 KV heads under tp 16: every PE holds every KV head and 3 query
    heads), through the launcher's function, one topology's weights on the
    card at a time, exactly n_layers x 47 flash launches a decode run and
    n_layers a forward. f32 (TF32 off): decode within F32_TOL x max(1,
    max|ref|) of forward_logits, 1 PE vs 16 PEs the same and identical
    greedy tokens. bf16: decode against its witness, the same decode with
    the plain attention in the kernel's place (``_witness_decode``), within
    RWKV_PATH_TOL; decode vs forward and 1 PE vs 16 PEs are reported beside
    SERVE_TOL, which 36 layers of width 6,144 in bf16 did not meet (bf16
    against f32 of the same tokens read about 0.11 of max); a decode
    profile per bf16 run. ``kept`` (bf16) receives the kernel's inputs of
    its last launch per path and run."""
    from repro_torch.kernels.attention import flash
    flash.LAUNCHES = 0          # the internlm2 paths' runs start here
    bf16 = dtype == torch.bfloat16
    tol = SERVE_TOL if bf16 else F32_TOL
    runs, profiled = {}, 0
    for pes in INTERNLM2_PES:
        run = _dense_run(dev, INTERNLM2_ARCH, pes, dtype,
                         kept if bf16 else None,
                         n_layers=INTERNLM2_SERVE_LAYERS)
        if bf16:
            run["summary"]["witness"] = _witness_decode(run, dev, dtype)
            n0 = flash.LAUNCHES
            run["summary"]["profile"] = profile_decode(run, dev)
            profiled += flash.LAUNCHES - n0
        runs[pes] = _drop(run)
        gc.collect()
    pair = _dense_pair(runs, INTERNLM2_PES)
    sums = [runs[p]["summary"] for p in INTERNLM2_PES]
    launches = flash.LAUNCHES - profiled
    counted = sum(s["flash_launches_decode"]
                  + s["flash_launches_forward"] for s in sums)
    ok = (all(_dense_ok(s, not bf16) for s in sums)
          and (all(s["witness"]["ok"] for s in sums) if bf16 else
               pair["err"] <= tol * pair["scale"]
               and pair["tokens_identical"])
          and launches == counted)
    return {"ok": ok, "arch": INTERNLM2_ARCH, "dtype": str(dtype).split(
        ".")[-1], "cut": f"{INTERNLM2_SERVE_LAYERS} of "
            f"{_full_depth(INTERNLM2_ARCH)} layers",
            "runs": sums, f"pe1_vs_pe{INTERNLM2_PES[-1]}": pair,
            "bound": tol * pair["scale"], "flash_launches": launches,
            "profiled_launches": profiled}


# --------------------------------------------------------------- serve_int8
INT8_CACHE_TOL = 5e-2       # int8-cache decode vs the bf16 cache's, x
#                             max(1, max|ref|): tests/test_serving.py's,
#                             held there with JAX's compute in f32


def _cache_bytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size()
               for d in cache.values() for t in d.values())


def _int8_engine(dev, run8) -> dict:
    """``ServeEngine`` on the int8 plan at 1 PE (the paged int8 cell), on
    the launcher's weights: the launcher's four prompts all at step 0 must
    give the int8 launcher's greedy tokens, with exactly n_layers int8
    decode launches a step and no other flash launch."""
    from repro_torch.kernels.attention import flash
    from repro_torch.serving import Request, ServeEngine
    cfg, topo, plan = run8["cfg"], run8["topo"], run8["plan"]
    ref = run8["tokens"]
    eng = ServeEngine(cfg, topo, plan, run8["params"],
                      page_size=ENGINE_PAGE, device=dev)
    reqs = [Request(rid=b, prompt=ref[b, :PROMPT].tolist(), max_new=GEN)
            for b in range(BATCH)]
    n0, i0 = flash.LAUNCHES, flash.INT8_LAUNCHES
    m = eng.run(reqs, max_steps=ENGINE_MAX_STEPS)
    torch.cuda.synchronize()
    got = np.array([list(r.out_tokens) for r in sorted(
        m["finished"], key=lambda r: r.rid)])
    out = {"steps": m["steps"], "tok_per_s": m["tokens_per_s"],
           "ms_per_step": eng.metrics.quantile("serve.step_seconds",
                                               0.5) * 1e3,
           "pool_dtype": str(eng.pcache["p0"]["k"].dtype).split(".")[-1],
           "int8_launches": flash.INT8_LAUNCHES - i0,
           "flash_launches": flash.LAUNCHES - n0,
           "expected_int8_launches": cfg.n_layers * m["steps"],
           "tokens_equal_launcher": bool(got.shape == ref[:, PROMPT:].shape
                                         and np.array_equal(
                                             got, ref[:, PROMPT:]))}
    out["ok"] = (out["tokens_equal_launcher"] and out["flash_launches"] == 0
                 and out["int8_launches"] == out["expected_int8_launches"]
                 and out["pool_dtype"] == "int8")
    del eng
    return out


def _int8_pair(dev, pes: int, dtype, params=None, keep=None) -> dict:
    """qwen3 through the launcher's loop from the int8 cache, then from the
    compute-dtype cache on the same weights: the two runs, their launches
    (int8 form, bf16 / f32 form) and the int8 run's logits against the
    other's at the steps whose inputs agree (INT8_CACHE_TOL)."""
    from repro_torch.kernels.attention import flash
    from repro_torch.launch.serve import serve
    n0, i0 = flash.LAUNCHES, flash.INT8_LAUNCHES
    with keep if keep is not None else contextlib.nullcontext():
        q = serve(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN, pes=pes,
                  device=dev, seed=0, dtype=dtype, keep_logits=True,
                  cache_dtype="int8", params=params, n_layers=INT8_LAYERS)
    q_launch = (flash.INT8_LAUNCHES - i0, flash.LAUNCHES - n0)
    n1 = flash.LAUNCHES
    b = serve(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN, pes=pes,
              device=dev, seed=0, dtype=dtype, keep_logits=True,
              params=q["params"], n_layers=INT8_LAYERS)
    b_launch = flash.LAUNCHES - n1
    d8, dc = (torch.stack(r["logits"], dim=1) for r in (q, b))
    same = np.cumprod(q["tokens"][:, :-1] == b["tokens"][:, :-1], axis=1)
    same = torch.from_numpy(same.astype(bool)).to(dev)
    held = _held(d8[same], dc[same], INT8_CACHE_TOL)
    L, steps = q["cfg"].n_layers, len(q["step_ms"])
    s = {"dtype": str(dtype).split(".")[-1],
         "int8_vs_cache_dtype_err": held["err"], "bound": held["bound"],
         "compared_steps": int(same.sum()),
         "greedy_agreement": float((q["tokens"][:, PROMPT:]
                                    == b["tokens"][:, PROMPT:]).mean()),
         "int8_ms_per_step": q["ms_per_step"],
         "cache_dtype_ms_per_step": b["ms_per_step"],
         "int8_tok_per_s": q["tok_per_s"],
         "cache_dtype_tok_per_s": b["tok_per_s"],
         "int8_cache_bytes": _cache_bytes(q["cache"]),
         "cache_dtype_bytes": _cache_bytes(b["cache"]),
         "int8_launches": q_launch[0],
         "int8_run_flash_launches": q_launch[1],
         "cache_dtype_launches": b_launch, "expected_launches": L * steps,
         "finite": bool(torch.isfinite(d8).all()),
         "launches_ok": (q_launch == (L * steps, 0)
                         and b_launch == L * steps)}
    s["held"] = held["ok"]
    if dtype == torch.bfloat16 and pes == 1:
        s["plain_witness"] = _int8_witness(q, b, d8, dc, dev)
    return q, s


def _int8_witness(q, b, d8, dc, dev) -> dict:
    """The int8 run again with the plain int8 form in the kernel's place
    (no launch): its logits against the int8 run's within RWKV_PATH_TOL
    of the type x max(1, max|ref|), and its own gap to the compute-dtype
    cache's run (``b``) over max(1, max|logits|), beside the kernel run's:
    where the two gaps agree the kernel adds nothing to the quantization's
    drift. Both at the steps whose inputs agree."""
    from repro_torch.kernels.attention import flash
    from repro_torch.launch.serve import serve
    n0, i0 = flash.LAUNCHES, flash.INT8_LAUNCHES
    with plain_flash():
        w = serve(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                  pes=math.prod(q["topo"].cube.dim_sizes), device=dev,
                  seed=0, dtype=torch.bfloat16, n_layers=q["cfg"].n_layers,
                  keep_logits=True, cache_dtype="int8", params=q["params"])
    dw = torch.stack(w["logits"], dim=1)

    def agree(x, y):
        same = np.cumprod(x["tokens"][:, :-1] == y["tokens"][:, :-1], axis=1)
        return torch.from_numpy(same.astype(bool)).to(dev)

    def rel(got, want):
        return float((got.float() - want.float()).abs().max()) / max(
            1.0, float(want.float().abs().max()))

    qw, wb, qb = agree(q, w), agree(w, b), agree(q, b)
    held = _held(d8[qw], dw[qw], RWKV_PATH_TOL[torch.bfloat16])
    return {**held, "compared_steps": int(qw.sum()),
            "plain_int8_vs_cache_dtype": rel(dw[wb], dc[wb]),
            "int8_vs_cache_dtype": rel(d8[qb], dc[qb]),
            "witness_launches": (flash.LAUNCHES - n0
                                 + flash.INT8_LAUNCHES - i0),
            "ok": (held["ok"] and flash.LAUNCHES == n0
                   and flash.INT8_LAUNCHES == i0)}


def phase_serve_int8(dev, kept_int8: dict) -> dict:
    """qwen3-1.7b at full width and depth served from the int8 KV cache
    (``make_serve_plan(cache_dtype="int8")``) through the launcher's loop
    at 1 and 8 PEs, and from the compute-dtype cache on the same weights
    (``_int8_pair``), in bf16 over f32 masters and in f32 (TF32 off).
    Gates: in f32, where only the cache's quantization differs, the int8
    run's logits within INT8_CACHE_TOL x max(1, max|ref|) of the f32
    cache's at the steps whose inputs agree (JAX's own bound for the int8
    cache, held there at smoke size with JAX's params, blocks and lm in
    f32, which ``tests/test_serving.py`` sets on import); in bf16 the same
    difference is reported beside that bound (28 layers of bf16 rounding
    flips add to the quantization's: ``tests/test_torch_int8_cache.py``
    shows JAX's own bf16 gap at 28 layers growing with the width as the
    port's does), and
    the 1-PE bf16 int8 run is gated against its plain witness
    (``_int8_witness``); in both, exactly n_layers int8 decode launches
    a step and no other flash launch (the compute-dtype run: n_layers
    decode launches a step), finite logits; ms/step and cache bytes of
    both caches in bf16; at 1 PE ``ServeEngine`` on the bf16 int8 plan
    (``_int8_engine``). ``kept_int8`` receives the int8 form's inputs of
    each bf16 run's last launch; each is checked and timed at the end with
    its bound and the bf16 decode form on the same shape."""
    from repro_torch.kernels.attention import flash
    flash.LAUNCHES = flash.INT8_LAUNCHES = 0   # the int8 path starts here
    out, ok, int8_launches, bf16_launches = {}, True, 0, 0
    for pes in PES:
        q, s16 = _int8_pair(dev, pes, torch.bfloat16, keep=keep_kernel_inputs(
            kept_int8, f"int8_decode/{pes}pe"))
        params = q["params"]
        _, s32 = _int8_pair(dev, pes, torch.float32, params=params)
        r = out[f"{pes}pe"] = {"cube": q["topo"].cube.describe(),
                               "bf16": s16, "f32": s32}
        r["ok"] = (s32["held"]
                   and (pes != 1 or s16["plain_witness"]["ok"])
                   and all(x["finite"] and x["launches_ok"]
                           for x in (s16, s32)))
        int8_launches += s16["int8_launches"] + s32["int8_launches"]
        bf16_launches += s16["cache_dtype_launches"] + s32[
            "cache_dtype_launches"]
        if pes == 1:
            n2, i2 = flash.LAUNCHES, flash.INT8_LAUNCHES
            r["engine"] = _int8_engine(dev, q)
            int8_launches += flash.INT8_LAUNCHES - i2
            r["ok"] = r["ok"] and r["engine"]["ok"] and flash.LAUNCHES == n2
        ok &= r["ok"]
        del q, params
        gc.collect()
        torch.cuda.empty_cache()
    counted = flash.INT8_LAUNCHES == int8_launches
    rows = [_int8_row(name, *kept_int8[name][:5], kept_int8[name][5])
            for name in sorted(kept_int8)]
    ok &= counted and len(rows) == len(PES) and all(t["ok"] for t in rows)
    return {"ok": bool(ok), "arch": ARCH, "runs": out, "main_path": rows,
            "int8_launches": int8_launches, "bf16_launches": bf16_launches}


# ----------------------------------------------------------- serve_resident
RESIDENT_PES, RESIDENT_TP = 8, 4       # the serve cube: data 2 x tp 4


def _resident_run(dev, resident: bool) -> dict:
    """qwen3-1.7b at full width on the data 2 x tp 4 serve cube (the batch
    of 4 over data), through the launcher's function, under a
    ``CommTrace``: the run, and its data all_gathers a decode step."""
    from repro_torch.core.comm import CommTrace
    from repro_torch.kernels.attention import flash
    from repro_torch.launch.serve import serve
    n0 = flash.LAUNCHES
    with CommTrace() as trc:
        run = serve(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                    pes=RESIDENT_PES, device=dev, seed=0, keep_logits=True,
                    resident=resident, serve_tp=RESIDENT_TP)
    steps = len(run["step_ms"])
    gathers = sum(e.primitive == "all_gather" and e.dims == ("data",)
                  for e in trc.events)
    run.update(data_gathers_per_step=gathers / steps,
               launches=flash.LAUNCHES - n0, dec=torch.stack(run["logits"],
                                                             dim=1))
    return run


def phase_serve_resident(dev) -> dict:
    """Resident serve weights (``Server(resident=True)``: the specs with
    the data axis dropped, so decode gathers no weight over data) against
    the FSDP weights on the same global values, qwen3-1.7b at full width on
    a serve cube of data 2 x tp 4: logits of every step bit-identical,
    tokens identical, zero data all_gathers a step with resident weights
    (counted from the ``CommTrace``; one per weight leaf a layer without),
    exactly n_layers flash launches a step in both, ms/step of both."""
    from repro_torch.kernels.attention import flash
    flash.LAUNCHES = 0          # the resident path's runs start here
    runs, out = {}, {}
    for resident in (False, True):
        run = _resident_run(dev, resident)
        L, steps = run["cfg"].n_layers, len(run["step_ms"])
        out["resident" if resident else "fsdp"] = run["summary"] = {
            "cube": run["topo"].cube.describe(),
            "batch_axes": list(run["plan"].batch_axes),
            "ms_per_step": run["ms_per_step"],
            "p75_ms_per_step": float(np.percentile(run["step_ms"][1:], 75)),
            "tok_per_s": run["tok_per_s"],
            "data_all_gathers_per_step": run["data_gathers_per_step"],
            "flash_launches": run["launches"],
            "expected_launches": L * steps}
        runs[resident] = _drop(run)
        gc.collect()
    a, b = runs[False], runs[True]
    out["bit_identical"] = bool(torch.equal(a["dec"], b["dec"]))
    out["tokens_identical"] = bool(np.array_equal(a["tokens"], b["tokens"]))
    fs, rs = out["fsdp"], out["resident"]
    out["ok"] = (out["bit_identical"] and out["tokens_identical"]
                 and rs["data_all_gathers_per_step"] == 0
                 and fs["data_all_gathers_per_step"] > 0
                 and all(r["flash_launches"] == r["expected_launches"]
                         for r in (fs, rs)))
    out["flash_launches"] = flash.LAUNCHES
    return out


# ------------------------------------------------------------ serve_whisper
WHISPER_ARCH = "whisper-base"
WHISPER_PES = (1, 8)


def _whisper_forward(run, pes: int, dtype) -> torch.Tensor:
    """``forward_logits`` of the served tokens and the run's frames on the
    forward topology of the run's cube: global (B, S, V_padded)."""
    from repro_torch.models.lm import Model
    from repro_torch.models.topology import build_topology
    cfg = dataclasses.replace(run["cfg"], tp=pes)
    ftopo = build_topology(cfg, pes)
    if ftopo.cube != run["topo"].cube:
        raise RuntimeError("forward and serve cubes differ")
    dev = run["params"]["embed"].device
    toks = torch.from_numpy(run["tokens"]).to(dev)
    out = Model(cfg, ftopo, dtype=dtype).forward_logits(run["params"], {
        "tokens": ftopo.cube.to_cube(toks, (ftopo.dp, None)),
        "frames": ftopo.cube.to_cube(run["frames"].to(dev),
                                     (ftopo.dp, None, None))})
    return ftopo.cube.from_cube(out, (ftopo.dp, None, ftopo.tp))


def _whisper_params(dev, pes: int) -> dict:
    """whisper-base's weights at ``pes`` PEs, one model at every PE count:
    drawn from seed 0 on the widest serve cube (its vocab padded to 51,872
    for 8 PEs), the pad columns of lm_head zeroed (their logits 0, below the
    largest of 51,865 real ones, so greedy never picks one) and, on a
    narrower cube, the pad rows and columns cut."""
    from repro_torch import configs
    from repro_torch.models.params import (
        init_params, param_specs, to_global, tree_map, vocab_padded)
    from repro_torch.models.topology import build_serve_topology
    cfg = configs.get(WHISPER_ARCH)
    wide = build_serve_topology(cfg, WHISPER_PES[-1])
    glob = to_global(init_params(cfg, wide, 0, device=dev),
                     param_specs(cfg, wide), wide.cube)
    glob["lm_head"] = glob["lm_head"].clone()
    glob["lm_head"][:, cfg.vocab_size:] = 0
    topo = build_serve_topology(cfg, pes)
    Vp = vocab_padded(cfg, topo)
    glob["embed"] = glob["embed"][:Vp]
    glob["lm_head"] = glob["lm_head"][:, :Vp]
    return tree_map(lambda g, sp: topo.cube.to_cube(g.contiguous(), sp),
                    glob, param_specs(cfg, topo))


def _whisper_run(dev, pes: int, dtype, kept, kept_reorder=None) -> dict:
    """whisper-base at full width and depth through the launcher's
    function: its frames and prompt through ``prefill_shard`` (the encoder,
    then each decoder layer's self and cross caches), then 15 greedy decode
    steps from that cache; ``forward_logits`` of the served tokens and
    frames (weights: ``_whisper_params``, the same model at 1 and 8 PEs).
    Exact launches: the prefill n_enc + 2 L flash forwards (the
    encoder's layers, each decoder layer's self- and cross-attention), 2 L
    decode launches a step (self, cross), n_enc + 2 L a forward; the
    prefill's K/V reshards 2 L reorder launches at 8 PEs (self and cross
    K/V, KV heads sharded over tp). ``kept_reorder`` receives the inputs
    of the prefill's last two reorder launches, the last layer's self and
    cross K/V."""
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.reorder import reorder
    from repro_torch.launch.serve import serve

    def keep(path):
        return (keep_kernel_inputs(kept, f"{WHISPER_ARCH}/{path}/{pes}pe")
                if kept is not None else contextlib.nullcontext())

    torch.cuda.reset_peak_memory_stats(dev)
    n0, r0 = flash.LAUNCHES, reorder.LAUNCHES
    params = _whisper_params(dev, pes)
    swz = []
    with keep("decode"), record_reorder(swz):
        run = serve(WHISPER_ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                    pes=pes, device=dev, seed=0, dtype=dtype,
                    keep_logits=True, params=params)
    torch.cuda.synchronize()
    n_serve, r_serve = flash.LAUNCHES - n0, reorder.LAUNCHES - r0
    if kept_reorder is not None and len(swz) >= 2:
        for part, inputs in zip(("self", "cross"), swz[-2:]):
            kept_reorder[f"{WHISPER_ARCH}/prefill/{pes}pe/{part}"] = inputs
    del swz
    n1 = flash.LAUNCHES
    with keep("forward"):
        fwd = _whisper_forward(run, pes, dtype)
    torch.cuda.synchronize()
    n_fwd = flash.LAUNCHES - n1
    cfg = run["cfg"]
    L, E = cfg.n_layers, cfg.n_enc_layers
    dec = torch.stack(run["logits"], dim=1)         # positions PROMPT-1 ..
    ref = fwd[:, PROMPT - 1:-1]
    held = _held(dec, ref, SERVE_TOL if dtype == torch.bfloat16
                 else F32_TOL)
    steps = len(run["step_ms"])
    s = {"pes": pes, "cube": run["topo"].cube.describe(),
         "dtype": str(dtype).split(".")[-1], "prefill": run["prefill"],
         "prefill_s": run["prefill_s"], "ms_per_step": run["ms_per_step"],
         "steps_timed": steps - 1, "tok_per_s": run["tok_per_s"],
         "flash_launches_serve": n_serve, "flash_launches_forward": n_fwd,
         "expected_launches_serve": E + 2 * L + 2 * L * steps,
         "expected_launches_forward": E + 2 * L,
         "reorder_launches": r_serve,
         "expected_reorder_launches": 2 * L if pes > 1 else 0,
         "decode_vs_forward_err": held["err"],
         "decode_vs_forward_bound": held["bound"],
         "decode_greedy_matches_forward": float(
             (dec.argmax(-1) == ref.argmax(-1)).float().mean()),
         "finite": bool(torch.isfinite(dec).all()
                        and torch.isfinite(fwd).all()),
         "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30}
    s["ok"] = (held["ok"] and s["finite"] and run["prefill"]
               and n_serve == s["expected_launches_serve"]
               and n_fwd == s["expected_launches_forward"]
               and r_serve == s["expected_reorder_launches"])
    if dtype == torch.bfloat16:
        n2 = flash.LAUNCHES
        s["profile"] = profile_decode(run, dev)
        s["profiled_launches"] = flash.LAUNCHES - n2
    run.update(dec=dec, summary=s)
    return run


def phase_serve_whisper(dev, kept: dict, kept_reorder: dict) -> dict:
    """whisper-base (6 encoder + 6 decoder layers, d_model 512, 8 heads of
    64) at full width and depth, at 1 and 8 PEs, bf16 over f32 masters and
    f32 (TF32 off), one topology's weights at a time (``_whisper_run``):
    decode within SERVE_TOL (bf16) / F32_TOL (f32) x max(1, max|ref|) of
    forward_logits, 1 PE vs 8 PEs the same (f32: identical greedy tokens).
    ``kept`` receives the kernel's bf16 inputs of its last launch per path
    and run (the decode path's last is a cross decode), ``kept_reorder``
    the bf16 prefill's last self and cross K/V reshards at 8 PEs."""
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.reorder import reorder
    flash.LAUNCHES = 0          # the whisper paths' runs start here
    reorder.LAUNCHES = 0
    out, ok = {}, True
    launches = reorder_launches = profiled = 0
    for dtype in (torch.bfloat16, torch.float32):
        runs = {}
        for pes in WHISPER_PES:
            bf16 = dtype == torch.bfloat16
            run = _whisper_run(dev, pes, dtype, kept if bf16 else None,
                               kept_reorder if bf16 else None)
            s = run["summary"]
            launches += s["flash_launches_serve"] + s[
                "flash_launches_forward"]
            reorder_launches += s["reorder_launches"]
            profiled += s.get("profiled_launches", 0)
            runs[pes] = _drop(run)
        pair = _dense_pair(runs, WHISPER_PES)
        tol = SERVE_TOL if dtype == torch.bfloat16 else F32_TOL
        name = str(dtype).split(".")[-1]
        d_ok = (all(runs[p]["summary"]["ok"] for p in WHISPER_PES)
                and pair["err"] <= tol * pair["scale"]
                and (dtype == torch.bfloat16 or pair["tokens_identical"]))
        out[name] = {"ok": d_ok, "runs": [runs[p]["summary"]
                                          for p in WHISPER_PES],
                     f"pe1_vs_pe{WHISPER_PES[-1]}": pair,
                     "bound": tol * pair["scale"]}
        ok &= d_ok
    return {"ok": bool(ok and flash.LAUNCHES - profiled == launches
                       and reorder.LAUNCHES == reorder_launches),
            "arch": WHISPER_ARCH, "batch": BATCH, "prompt_len": PROMPT,
            "gen": GEN, **out, "flash_launches": launches,
            "reorder_launches": reorder_launches,
            "profiled_launches": profiled}


# ------------------------------------------------- serve_llava, serve_jamba
LLAVA_ARCH = "llava-next-34b"
# serving depth: 12 of 60 layers (557 M parameters a layer, 30.5 GB of f32
# weights with the embedding and head); a prompt of its 2,880 patches and
# LLAVA_TEXT text tokens goes through one prefill, then GEN - 1 decode steps
LLAVA_SERVE_LAYERS = 12
LLAVA_TEXT = 128
LLAVA_PES = (1, 8)                     # its own tp 8: 7 query heads a PE
JAMBA_ARCH = "jamba-1.5-large"
# one unit of 8 layers (attention at index 4, MoE on the odd ones) at a cut
# width: 64 / 8 heads of 128, 16 experts top-2, d_state 16, expand 2, conv
# 4 and the vocab as published; d_model and the FFN widths cut together,
# since one MoE layer at d_model 8,192 holds 38.6 GB of f32 weights. The
# expert capacity is n_experts / top_k (8.0), so that no choice is dropped
# and decode and forward are one function (the reference's default 1.25
# drops choices at a decode batch of 4: C = 1)
JAMBA_SERVE = {"n_layers": 8, "d_model": 4096, "d_ff": 12288,
               "d_ff_expert": 12288, "capacity_factor": 8.0}
JAMBA_PES = (1, 8)                     # ep 8: 2 experts a PE


def keep_by_form(kept: dict, label: str):
    """While open, every launch of the flash wrapper stores its inputs
    under ``label/prefill`` (more than one query a row) or
    ``label/decode`` (the last launch of each form wins)."""
    from repro_torch.kernels.attention import flash

    def wrap(launch):
        def keeping(q, k, v, q_pos, k_pos, **kw):
            form = "prefill" if q.shape[1] > 1 else "decode"
            kept[f"{label}/{form}"] = (q, k, v, q_pos, k_pos, kw)
            return launch(q, k, v, q_pos, k_pos, **kw)
        return keeping

    return patched(flash, "flash_attention", wrap)


def _served_forward(run, dtype) -> torch.Tensor:
    """``forward_logits`` of the served tokens (and the run's patches) on
    the forward topology of the run's cube: global (B, S, V_padded)."""
    from repro_torch.models.lm import Model
    from repro_torch.models.topology import build_topology
    topo, cfg = run["topo"], run["cfg"]
    cfg = (dataclasses.replace(cfg, ep=topo.size(topo.ep),
                               etp=topo.size(topo.etp)) if cfg.n_experts
           else dataclasses.replace(cfg, tp=topo.tp_size))
    ftopo = build_topology(cfg, topo.cube.ndev)
    if ftopo.cube != topo.cube:
        raise RuntimeError("forward and serve cubes differ")
    dev = run["params"]["embed"].device
    batch = {"tokens": ftopo.cube.to_cube(
        torch.from_numpy(run["tokens"]).to(dev), (ftopo.dp, None))}
    if run["patches"] is not None:
        batch["patches"] = ftopo.cube.to_cube(run["patches"].to(dev),
                                              (ftopo.dp, None, None))
    out = Model(cfg, ftopo, dtype=dtype).forward_logits(run["params"], batch)
    return ftopo.cube.from_cube(out, (ftopo.dp, None, ftopo.tp))


def _new_serve(dev, arch: str, pes: int, dtype, kept, kept_reorder,
               **serve_kw) -> dict:
    """One serve of llava or jamba through the launcher's function (llava:
    its patches and text through ``prefill_shard``, then greedy decode
    steps; jamba: the teacher-forced prompt, then greedy decode steps),
    ``forward_logits`` of the served tokens, and in bf16 the witness: the
    same serve on the same weights with the flash kernel's plain version
    in its place (no flash launch; its reorders launch as the run's).
    Exact launches: the flash kernel once per
    attention layer and prefill, decode step and forward; the reorder, at
    more than one PE, once per attention layer and prefill where the KV
    heads are sharded (the K/V reshard) and twice per MoE layer and
    prefill, decode step and forward (dispatch, combine). bf16 decode is
    gated against its witness within RWKV_PATH_TOL, f32 decode against the
    forward within F32_TOL, x max(1, max|ref|); decode vs forward is
    reported beside SERVE_TOL in bf16."""
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.reorder import reorder
    from repro_torch.launch.serve import serve
    from repro_torch.models.config import ATTN, MOE
    bf16 = dtype == torch.bfloat16
    label = f"{arch}/{pes}pe"
    torch.cuda.reset_peak_memory_stats(dev)
    keep = contextlib.ExitStack()
    if kept is not None:
        keep.enter_context(keep_by_form(kept, label))
    if kept_reorder is not None and pes > 1:
        keep.enter_context(keep_reorder_inputs(kept_reorder,
                                               f"{label}/serve"))
    n0, r0 = flash.LAUNCHES, reorder.LAUNCHES
    t0 = time.perf_counter()
    with keep:
        run = serve(arch, batch=BATCH, gen=GEN, pes=pes, device=dev, seed=0,
                    dtype=dtype, keep_logits=True, **serve_kw)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    n_serve, r_serve = flash.LAUNCHES - n0, reorder.LAUNCHES - r0
    n1, r1 = flash.LAUNCHES, reorder.LAUNCHES
    fwd = _served_forward(run, dtype)
    torch.cuda.synchronize()
    n_fwd, r_fwd = flash.LAUNCHES - n1, reorder.LAUNCHES - r1
    cfg, topo = run["cfg"], run["topo"]
    n_attn = sum(m == ATTN for m in cfg.mixers())
    n_moe = sum(f == MOE for f in cfg.ffns())
    steps = len(run["step_ms"])
    prompt = run["tokens"].shape[1] - GEN
    # two all_to_alls a MoE layer past one PE; a prefill's K/V reshard
    a2a = 2 * n_moe if pes > 1 else 0
    reshard = n_attn if run["prefill"] and _reshards(cfg, topo) else 0
    dec = torch.stack(run["logits"], dim=1)
    ref = fwd[:, -dec.shape[1] - 1:-1]
    held = _held(dec, ref, SERVE_TOL if bf16 else F32_TOL)
    s = {"arch": arch, "pes": pes, "cube": topo.cube.describe(),
         "dtype": str(dtype).split(".")[-1], "layers": cfg.n_layers,
         "d_model": cfg.d_model, "prompt": prompt,
         "prefill": run["prefill"], "prefill_s": run["prefill_s"],
         "prefill_tok_per_s": (BATCH * prompt / run["prefill_s"]
                               if run["prefill"] else None),
         "ms_per_step": run["ms_per_step"],
         "p75_ms_per_step": float(np.percentile(run["step_ms"][1:], 75)),
         "steps_timed": steps - 1, "tok_per_s": run["tok_per_s"],
         "serve_s": serve_s,
         "flash_launches_serve": n_serve, "flash_launches_forward": n_fwd,
         "expected_launches_serve": n_attn * (steps + run["prefill"]),
         "expected_launches_forward": n_attn,
         "reorder_launches_serve": r_serve, "reorder_launches_forward": r_fwd,
         "expected_reorder_serve": a2a * (steps + run["prefill"]) + reshard,
         "expected_reorder_forward": a2a,
         "decode_vs_forward_err": held["err"],
         "decode_vs_forward_bound": held["bound"],
         "decode_greedy_matches_forward": float(
             (dec.argmax(-1) == ref.argmax(-1)).float().mean()),
         "finite": bool(torch.isfinite(dec).all()
                        and torch.isfinite(fwd).all())}
    del fwd, ref
    ok = (s["finite"] and n_serve == s["expected_launches_serve"]
          and n_fwd == s["expected_launches_forward"]
          and r_serve == s["expected_reorder_serve"]
          and r_fwd == s["expected_reorder_forward"]
          and (run["prefill"] == (cfg.frontend == "patch")))
    if bf16:
        n2, r2 = flash.LAUNCHES, reorder.LAUNCHES
        with plain_flash():
            w = serve(arch, batch=BATCH, gen=GEN, pes=pes, device=dev,
                      seed=0, dtype=dtype, keep_logits=True,
                      params=run["params"], **serve_kw)
        torch.cuda.synchronize()
        wdec = torch.stack(w["logits"], dim=1)
        first = run["tokens"].shape[1] - 1 - dec.shape[1]
        same = np.cumprod(run["tokens"][:, first:-1]
                          == w["tokens"][:, first:-1], axis=1)
        same = torch.from_numpy(same.astype(bool)).to(dev)
        wheld = _held(dec[same], wdec[same], RWKV_PATH_TOL[dtype])
        s["witness"] = {**wheld, "compared_steps": int(same.sum()),
                        "greedy_agreement": float(
                            (run["tokens"][:, prompt:]
                             == w["tokens"][:, prompt:]).mean()),
                        "witness_launches": flash.LAUNCHES - n2,
                        "witness_reorder_launches": reorder.LAUNCHES - r2}
        ok &= (wheld["ok"] and flash.LAUNCHES == n2
               and reorder.LAUNCHES - r2 == r_serve)
        del w, wdec
        n3, r3 = flash.LAUNCHES, reorder.LAUNCHES
        s["profile"] = profile_decode(run, dev)
        s["profiled_launches"] = flash.LAUNCHES - n3
        s["profiled_reorder_launches"] = reorder.LAUNCHES - r3
    else:
        ok &= held["ok"]
    s["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    s["ok"] = bool(ok)
    run.update(dec=dec, summary=s)
    return run


def _new_serve_phase(dev, arch: str, pes_list: tuple, dtypes: tuple, kept,
                     kept_reorder, **serve_kw) -> dict:
    """``_new_serve`` at each PE count and type, one topology's weights on
    the card at a time; 1 PE vs n PEs over the steps whose inputs agree,
    within SERVE_TOL (bf16, reported) / F32_TOL (f32, gated, with identical
    greedy tokens). Every launch counted from 0 here (the bf16 witness's
    reorders among them); the profiled decode steps are not the path's."""
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.reorder import reorder
    flash.LAUNCHES = reorder.LAUNCHES = 0
    layers = serve_kw.get("n_layers") or serve_kw["changes"]["n_layers"]
    out, ok, launches, reorders, profiled, profiled_r = {}, True, 0, 0, 0, 0
    for dtype in dtypes:
        bf16 = dtype == torch.bfloat16
        runs = {}
        for pes in pes_list:
            run = _new_serve(dev, arch, pes, dtype, kept if bf16 else None,
                             kept_reorder if bf16 else None, **serve_kw)
            s = run["summary"]
            launches += s["flash_launches_serve"] + s[
                "flash_launches_forward"]
            reorders += (s["reorder_launches_serve"]
                         + s["reorder_launches_forward"]
                         + s.get("witness", {}).get(
                             "witness_reorder_launches", 0))
            profiled += s.get("profiled_launches", 0)
            profiled_r += s.get("profiled_reorder_launches", 0)
            runs[pes] = _drop(run)
            gc.collect()
        pair = _dense_pair(runs, pes_list)
        tol = SERVE_TOL if bf16 else F32_TOL
        d_ok = (all(runs[p]["summary"]["ok"] for p in pes_list)
                and (bf16 or (pair["err"] <= tol * pair["scale"]
                              and pair["tokens_identical"])))
        out[str(dtype).split(".")[-1]] = {
            "ok": d_ok, "runs": [runs[p]["summary"] for p in pes_list],
            f"pe1_vs_pe{pes_list[-1]}": pair, "bound": tol * pair["scale"]}
        ok &= d_ok
    return {"ok": bool(ok and flash.LAUNCHES - profiled == launches
                       and reorder.LAUNCHES - profiled_r == reorders),
            "arch": arch, "batch": BATCH, "gen": GEN, "config": serve_kw,
            "cut": f"{layers} of {_full_depth(arch)} layers",
            **out, "flash_launches": launches, "reorder_launches": reorders,
            "profiled_launches": profiled,
            "profiled_reorder_launches": profiled_r}


def phase_serve_llava(dev, kept: dict, kept_reorder: dict) -> dict:
    """llava-next-34b at full width (d_model 7,168, 56 / 8 heads of 128:
    G = 7) and LLAVA_SERVE_LAYERS of its 60 layers, at 1 PE and 8 PEs (tp
    8: 7 query heads and one KV head a PE), bf16 over f32 masters: 4
    prompts of its 2,880 patches (drawn from the seed) and LLAVA_TEXT text
    tokens through one ``prefill_shard``, then GEN - 1 greedy decode steps
    (``_new_serve``). ``kept`` receives the kernel's inputs of its last
    prefill and decode launch per run, ``kept_reorder`` the 8-PE run's
    last reorder (a K/V reshard)."""
    return _new_serve_phase(dev, LLAVA_ARCH, LLAVA_PES, (torch.bfloat16,),
                            kept, kept_reorder, prompt_len=LLAVA_TEXT,
                            n_layers=LLAVA_SERVE_LAYERS)


def phase_serve_jamba(dev, kept: dict, kept_reorder: dict) -> dict:
    """jamba-1.5-large at JAMBA_SERVE's cut (one unit of 8 layers: 7
    Mamba, 1 attention with 64 / 8 heads of 128: G = 8; 4 MoE layers of 16
    experts top-2) at 1 PE and 8 PEs (ep 8), bf16 and f32 (TF32 off),
    through the launcher's usual loop (the prompt teacher-forced through
    decode steps, then greedy), ``_new_serve``. ``kept`` receives the
    kernel's inputs of its last decode launch per bf16 run, ``kept_reorder``
    the 8-PE bf16 run's last reorder (an MoE all_to_all)."""
    return _new_serve_phase(dev, JAMBA_ARCH, JAMBA_PES,
                            (torch.bfloat16, torch.float32), kept,
                            kept_reorder, prompt_len=PROMPT,
                            changes=JAMBA_SERVE)


# ---------------------------------------------------------- serve_prefill
PREFILL_LONG, PREFILL_GEN = 2048, 16   # qwen3's long prompt, decode steps
MOE_SORT_STEPS = 4                     # decode steps of the sort check


def _counted(fn):
    """``fn()`` with the flash and reorder counts set to 0 just before it
    and read just after: (its result, flash launches, reorder launches)."""
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.reorder import reorder
    flash.LAUNCHES = reorder.LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    return out, flash.LAUNCHES, reorder.LAUNCHES


def _prefill(server, params, tokens):
    """``prefill_shard`` of global tokens (B, S) on the server's cube:
    (global last logits (B, V_padded), the cache, wall seconds between
    synchronizations)."""
    topo, ba = server.topo, server.plan.batch_axes or None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = server.prefill_shard(
        params, {"tokens": topo.cube.to_cube(tokens, (ba, None))})
    torch.cuda.synchronize()
    return (topo.cube.from_cube(logits, (ba, topo.tp)), cache,
            time.perf_counter() - t0)


def _decode_from(server, params, cache, pos0: int, steps: int, *,
                 first=None, feed=None):
    """``steps`` decode steps from ``cache`` at positions pos0, pos0 + 1,
    ...: feeding ``feed[:, i]`` (teacher-forced) or greedy from ``first``.
    Returns (global logits (B, steps, V_padded), the tokens fed (B,
    steps))."""
    topo, ba = server.topo, server.plan.batch_axes or None
    cube = topo.cube
    tok, outs, fed = first, [], []
    for i in range(steps):
        if feed is not None:
            tok = feed[:, i]
        pos = torch.full_like(tok, pos0 + i)
        lg, cache = server.decode_shard(params, cache,
                                        cube.to_cube(tok, (ba,)),
                                        cube.to_cube(pos, (ba,)))
        lg = cube.from_cube(lg, (ba, topo.tp))
        outs.append(lg)
        fed.append(tok)
        tok = lg.argmax(-1)
    return torch.stack(outs, 1), torch.stack(fed, 1)


def _reshards(cfg, topo) -> int:
    """Reorder launches of one prefill: one all_to_all of K and V stacked
    per attention layer where the KV heads are sharded over tp (more than
    one PE); none where they are replicated."""
    from repro_torch.models.params import kv_is_sharded
    sharded = topo.tp_size > 1 and kv_is_sharded(cfg, topo)
    return cfg.n_layers if sharded else 0


def _prefill_vs_loop(dev, pes: int, dtype, params=None,
                     n_layers: int | None = None) -> dict:
    """qwen3's serve cell (batch 4, prompt 32, gen 16): the launcher's
    teacher-forced loop, then prefill of its prompt and 15 decode steps
    from the prefilled cache fed the loop's tokens, against the loop's
    logits at positions 31..46 (SERVE_TOL in bf16, F32_TOL in f32) and
    its greedy tokens. Returns the summary and the weights."""
    from repro_torch.launch.serve import serve
    from repro_torch.models.serving import Server
    run = serve(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN, pes=pes,
                device=dev, seed=0, dtype=dtype, params=params,
                keep_logits=True, n_layers=n_layers)
    cfg, topo = run["cfg"], run["topo"]
    server = Server(cfg, topo, run["plan"], dtype=dtype)
    toks = torch.from_numpy(run["tokens"]).to(dev)
    loop = torch.stack(run["logits"], 1)[:, PROMPT - 1:]     # (B, GEN, V)
    (last, cache, wall), n_flash, n_reorder = _counted(
        lambda: _prefill(server, run["params"], toks[:, :PROMPT]))
    (dec, _), n_flash_dec, _ = _counted(lambda: _decode_from(
        server, run["params"], cache, PROMPT, GEN - 1,
        feed=toks[:, PROMPT:PROMPT + GEN - 1]))
    got = torch.cat((last[:, None], dec), 1)
    held = _held(got, loop, SERVE_TOL if dtype == torch.bfloat16
                 else F32_TOL)
    greedy = float((got.argmax(-1) == toks[:, PROMPT:]).float().mean())
    s = {"pes": pes, "dtype": str(dtype).split(".")[-1],
         "prompt_len": PROMPT, "prefill_s": wall,
         "prefill_vs_loop_err": held["err"], "bound": held["bound"],
         "last_logits_err": float((last - loop[:, 0]).abs().max()),
         "greedy_agreement": greedy,
         "flash_launches": n_flash, "reorder_launches": n_reorder,
         "flash_launches_decode": n_flash_dec,
         "expected_flash_launches": cfg.n_layers,
         "expected_reorder_launches": _reshards(cfg, topo),
         "expected_flash_launches_decode": cfg.n_layers * (GEN - 1),
         "finite": bool(torch.isfinite(got).all())}
    s["ok"] = (held["ok"] and s["finite"]
               and n_flash == s["expected_flash_launches"]
               and n_reorder == s["expected_reorder_launches"]
               and n_flash_dec == s["expected_flash_launches_decode"]
               and (dtype == torch.bfloat16 or greedy == 1.0))
    return s, run["params"]


def _prefill_long(dev, arch: str, pes: int, S: int, kept: dict,
                  kept_reorder: dict, params=None) -> dict:
    """A long prompt (batch 4, S tokens): prefill, a timed second prefill
    (both counted), PREFILL_GEN greedy decode steps from the first one's
    cache, and
    forward_logits of the prompt and the generated tokens; prefill's last
    logits and every decode step against the forward's (SERVE_TOL, bf16).
    The flash and reorder inputs of the prefill's last launches are kept
    for main_path."""
    from repro_torch import configs
    from repro_torch.models.params import init_params
    from repro_torch.models.serving import Server, make_serve_plan
    from repro_torch.models.topology import build_serve_topology
    cfg = configs.get(arch)
    topo = build_serve_topology(cfg, pes)
    plan = make_serve_plan(cfg, topo, S_ctx=S + PREFILL_GEN,
                           global_batch=BATCH)
    server = Server(cfg, topo, plan, dtype=torch.bfloat16)
    if params is None:
        params = init_params(cfg, topo, 0, device=dev)
    prompt = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (BATCH, S))).to(dev)
    with keep_kernel_inputs(kept, f"{arch}/prefill{S}/{pes}pe"), \
            keep_reorder_inputs(kept_reorder, f"prefill{S}/{pes}pe"):
        (last, cache, wall0), n_flash, n_reorder = _counted(
            lambda: _prefill(server, params, prompt))
    (_, _, wall), n_flash2, n_reorder2 = _counted(           # warm
        lambda: _prefill(server, params, prompt))
    n_flash, n_reorder = n_flash + n_flash2, n_reorder + n_reorder2
    (dec, fed), n_flash_dec, _ = _counted(lambda: _decode_from(
        server, params, cache, S, PREFILL_GEN, first=last.argmax(-1)))
    del cache
    fwd = _dense_forward({"cfg": cfg, "topo": topo, "params": params}, pes,
                         torch.bfloat16, torch.cat((prompt, fed), 1))
    last_held = _held(last, fwd[:, S - 1], SERVE_TOL)
    dec_held = _held(dec, fwd[:, S:], SERVE_TOL)
    s = {"arch": arch, "pes": pes, "batch": BATCH, "prompt_len": S,
         "windows": sorted({int(w) for w in cfg.windows()}),
         "S_cache": plan.S_cache,
         "prefill_s_first": wall0, "prefill_s": wall,
         "prefill_tok_per_s": BATCH * S / wall,
         "last_vs_forward_err": last_held["err"],
         "decode_vs_forward_err": dec_held["err"],
         "bound": max(last_held["bound"], dec_held["bound"]),
         "decode_greedy_matches_forward": float(
             (dec.argmax(-1) == fwd[:, S:].argmax(-1)).float().mean()),
         "flash_launches": n_flash, "reorder_launches": n_reorder,
         "flash_launches_decode": n_flash_dec,
         "expected_flash_launches": 2 * cfg.n_layers,        # 2 prefills
         "expected_reorder_launches": 2 * _reshards(cfg, topo),
         "expected_flash_launches_decode": cfg.n_layers * PREFILL_GEN,
         "finite": bool(torch.isfinite(dec).all()
                        and torch.isfinite(last).all()),
         "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30}
    s["ok"] = (last_held["ok"] and dec_held["ok"] and s["finite"]
               and n_flash == s["expected_flash_launches"]
               and n_reorder == s["expected_reorder_launches"]
               and n_flash_dec == s["expected_flash_launches_decode"])
    return s


def _moe_sort_vs_scatter(run, dev) -> dict:
    """On the weights a full-width MoE serve holds: forward_logits of its
    tokens and MOE_SORT_STEPS teacher-forced decode steps under
    moe_dispatch "sort" against "scatter" (expected bit-identical), the
    forward's routing decisions, and the reorder launches of each (two
    all_to_alls per layer and forward or decode step)."""
    from repro_torch.models.lm import Model
    from repro_torch.models.serving import Server, init_cache
    from repro_torch.models.topology import build_topology
    topo, params = run["topo"], run["params"]
    toks = torch.from_numpy(run["tokens"]).to(dev)
    out = {}
    for dispatch in ("scatter", "sort"):
        cfg = dataclasses.replace(run["cfg"], moe_dispatch=dispatch,
                                  ep=topo.size(topo.ep),
                                  etp=topo.size(topo.etp))
        ftopo = build_topology(cfg, topo.cube.ndev)
        if ftopo.cube != topo.cube:
            raise RuntimeError("forward and serve cubes differ")
        calls = []
        with record_routes(calls):
            fwd, nf, nr = _counted(lambda: Model(
                cfg, ftopo, dtype=torch.bfloat16).forward_logits(
                    params, {"tokens": ftopo.cube.to_cube(
                        toks, (ftopo.dp, None))}))
        server = Server(cfg, topo, run["plan"], dtype=torch.bfloat16)
        cache = init_cache(cfg, topo, run["plan"], device=dev)
        (dec, _), nf_dec, nr_dec = _counted(lambda: _decode_from(
            server, params, cache, 0, MOE_SORT_STEPS,
            feed=toks[:, :MOE_SORT_STEPS]))
        out[dispatch] = {"fwd": fwd, "dec": dec,
                         "routes": torch.stack(calls), "reorder": nr,
                         "reorder_decode": nr_dec, "flash": nf + nf_dec}
        del cache, server
    a, b = out["scatter"], out["sort"]
    n_layers = run["cfg"].n_layers
    s = {"forward_identical": bool(torch.equal(a["fwd"], b["fwd"])),
         "decode_identical": bool(torch.equal(a["dec"], b["dec"])),
         "forward_max_diff": float((a["fwd"] - b["fwd"]).abs().max()),
         "decode_max_diff": float((a["dec"] - b["dec"]).abs().max()),
         "routes_identical": bool(torch.equal(a["routes"], b["routes"])),
         "routing_decisions": int(a["routes"][..., 0].numel()),
         "reorder_launches": {d: [out[d]["reorder"],
                                  out[d]["reorder_decode"]]
                              for d in out},
         "expected_reorder_launches": [2 * n_layers,
                                       2 * n_layers * MOE_SORT_STEPS],
         "flash_launches": a["flash"] + b["flash"],
         "reorder_launches_total": sum(out[d]["reorder"]
                                       + out[d]["reorder_decode"]
                                       for d in out)}
    s["ok"] = (s["routes_identical"] and all(
        v == s["expected_reorder_launches"]
        for v in s["reorder_launches"].values())
        and bool(torch.isfinite(b["fwd"]).all()))
    return s


def phase_serve_prefill(dev, kept: dict, kept_reorder: dict,
                        moe_sort: dict) -> dict:
    """Prefill of attention layers into the decode cache: qwen3-1.7b at 1
    and 8 PEs against the teacher-forced loop (bf16 and f32) and at 2,048
    tokens against forward_logits; gemma3-1b at 1 and 4 PEs at 1,024
    tokens; and the MoE sort check ``serve_moe`` ran on its 8-PE weights
    (``moe_sort``)."""
    loop, long_cells = [], []
    for pes in PES:
        torch.cuda.reset_peak_memory_stats(dev)
        s, params = _prefill_vs_loop(dev, pes, torch.bfloat16)
        loop.append(s)
        s32, _ = _prefill_vs_loop(dev, pes, torch.float32, params)
        loop.append(s32)
        long_cells.append(_prefill_long(dev, ARCH, pes, PREFILL_LONG, kept,
                                        kept_reorder, params))
        del params
        torch.cuda.empty_cache()
    for pes in DENSE_ARCHS[LONG_ARCH]:
        torch.cuda.reset_peak_memory_stats(dev)
        long_cells.append(_prefill_long(dev, LONG_ARCH, pes, LONG_SEQ, kept,
                                        kept_reorder))
        torch.cuda.empty_cache()
    cells = loop + long_cells
    launches = {k: sum(c[k] + (c["flash_launches_decode"]
                               if k == "flash_launches" else 0)
                       for c in cells)
                for k in ("flash_launches", "reorder_launches")}
    return {"ok": all(c["ok"] for c in cells) and moe_sort.get("ok", False),
            "loop_cells": loop, "long_cells": long_cells,
            "moe_sort_vs_scatter": moe_sort,
            "flash_launches": launches["flash_launches"]
            + moe_sort.get("flash_launches", 0),
            "reorder_launches": launches["reorder_launches"]
            + moe_sort.get("reorder_launches_total", 0)}


# -------------------------------------------------------------------- tune
# the tuner's cubes: (name, dims, pods, selections or None for the sweep's
# own: the innermost dim and the whole cube)
TUNE_CUBES = [("ring8", {"d": 8}, 1, None),
              ("2x2x2", {"a": 2, "b": 2, "c": 2}, 1,
               [("b",), ("a", "b"), ("b", "c")]),
              ("pod2x4x2", {"pod": 2, "dp": 4, "tp": 2}, 2, None)]
TUNE_SIZES = (64 << 10, 1 << 20, 16 << 20, 64 << 20)   # per-PE bytes
L2_BYTES = 50e6


def _card_bytes(s, cube) -> float:
    """The least bytes a sample's call moves through the card's memory: a
    PE<->PE flow reads every PE's payload once and writes every PE's
    result once (all_reduce and all_to_all the payload's size,
    reduce_scatter 1 / g of it, all_gather g times it); a rooted flow's
    ICI + DCN bytes are the host value's. (The flows' ICI + DCN bytes are
    no such bound: a hierarchical flow counts a byte once for each link
    it crosses, 1.375 x the payload for reduce_scatter over pod2x4x2.)"""
    from repro_torch.tuning.microbench import PE_PRIMITIVES
    if s.primitive not in PE_PRIMITIVES:
        return s.ici_bytes + s.dcn_bytes
    g = cube.comm(cube.dims_from_bitmap(s.bitmap)).group_size
    out = {"all_reduce": 1.0, "all_to_all": 1.0, "reduce_scatter": 1 / g,
           "all_gather": float(g)}[s.primitive]
    return cube.ndev * s.nbytes * (1.0 + out)


def _auto_checks(cube, prof, dev) -> list:
    """Under the installed profile, ``auto`` on each PE primitive at two
    sizes dispatches the flow the planner names, bit-identical to that
    flow on an integer payload."""
    from repro_torch.core import planner
    from repro_torch.core.comm import CommTrace
    out = []
    sel = cube.dim_names
    comm = cube.comm(sel)
    gen = torch.Generator(device=dev).manual_seed(3)
    for nbytes in (64 << 10, 16 << 20):
        n = nbytes // 4 // comm.group_size * comm.group_size
        x = torch.randint(-4, 5, cube.dim_sizes + (n,), generator=gen,
                          device=dev).float()
        calls = {
            "all_reduce": lambda a: comm.all_reduce(x, algorithm=a),
            "all_gather": lambda a: comm.all_gather(x, axis=0, algorithm=a),
            "reduce_scatter": lambda a: comm.reduce_scatter(
                x, axis=0, algorithm=a),
            "all_to_all": lambda a: comm.all_to_all(
                x, split_axis=0, concat_axis=0, algorithm=a)}
        for prim, call in calls.items():
            with planner.install_profile(prof):
                est = planner.plan(cube, prim, sel, 4 * n)
                if est.algorithm == "direct":
                    named = comm._resolve_flow(prim, "pidcomm", 4 * n)[0]
                else:
                    named = est.algorithm
                with CommTrace() as tr:
                    got = call(None)
            want = call(named)
            out.append({"primitive": prim, "bytes": 4 * n,
                        "pick": est.algorithm, "flow": tr.events[0].flow,
                        "named": named, "seconds": est.seconds,
                        "ok": (tr.events[0].flow == named
                               and est.est_source == "measured"
                               and torch.equal(got, want))})
    return out


def _picks(cube, prof, samples) -> list:
    """Per primitive, selection and size: the planner's pick under the
    profile, the measured fastest candidate, and the ratio of their
    measured times (reported, not gated)."""
    from repro_torch.core import planner
    cells = {}
    for s in samples:
        cells.setdefault((s.primitive, s.bitmap, s.nbytes), []).append(s)
    out = []
    for (prim, bitmap, nbytes), cell in sorted(cells.items()):
        dims = cube.dims_from_bitmap(bitmap)
        pick = planner.plan(cube, prim, dims, nbytes, profile=prof)
        fastest = min(cell, key=lambda s: s.seconds)
        mine = [s for s in cell if s.algorithm == pick.algorithm]
        out.append({"primitive": prim, "bitmap": bitmap, "bytes": nbytes,
                    "pick": pick.algorithm, "fastest": fastest.algorithm,
                    "pick_over_fastest": (mine[0].seconds / fastest.seconds
                                          if mine else None)})
    return out


def _grad_sync_drift(dev, tuner) -> dict:
    """qwen3-1.7b's grad-sync program at tp 8 (one all_reduce of each
    parameter replicated over tp, recorded as ``sync_replicated_grads``
    records it, on random gradients), tuned on its own cube, planned under
    the profile, executed, and its planned seconds against the measured
    (the DriftMonitor ratio)."""
    from repro_torch import configs
    from repro_torch.core import planner
    from repro_torch.models.params import leaves, param_defs
    from repro_torch.models.topology import build_topology
    from repro_torch.runtime.trainer import replication_dims
    from repro_torch.telemetry.drift import DriftMonitor
    from repro_torch.tuning import microbench
    cfg = dataclasses.replace(configs.get(ARCH), tp=8)
    topo = build_topology(cfg, 8)
    cube = topo.cube
    prof = tuner.tune(cube, sizes=TUNE_SIZES, primitives=("all_reduce",))
    gen = torch.Generator(device=dev).manual_seed(4)
    grads = []
    for _, d in leaves(param_defs(cfg, topo)):
        dims = replication_dims(d.spec, cube)
        if dims:
            grads.append((cube.comm(dims), torch.randn(
                cube.dim_sizes + cube.local_shape(d.shape, d.spec),
                generator=gen, device=dev)))
    prog = cube.program(name="grad-sync")
    with prog:
        prog.output(*(c.all_reduce(g) for c, g in grads))
    with planner.install_profile(prof):
        lowered = prog.lower()
    measured = microbench.measure_program(lowered, (), device=dev)
    mon = DriftMonitor()
    mon.observe_plan(lowered.plan, measured)
    return {"leaves": len(grads),
            "bytes": sum(g.numel() * 4 for _, g in grads) // cube.ndev,
            "ops": len(lowered.ops), "est_source": lowered.plan.est_source,
            "planned_s": lowered.plan.seconds,
            "serial_s": lowered.plan.serial_seconds, "measured_s": measured,
            "drift_medians": {"/".join(k): v
                              for k, v in mon.medians().items()},
            "ok": lowered.plan.seconds is not None and bool(mon.medians())}


def phase_tune(dev) -> dict:
    """The tuner on the card: ``Tuner.tune`` of three cubes over TUNE_SIZES,
    the fitted models, the planner's picks against the measured fastest,
    and the gates of the module docstring."""
    import shutil
    from repro_torch.core.hypercube import Hypercube
    from repro_torch.kernels.reorder import reorder
    from repro_torch.tuning import CommProfile, ProfileMismatchError, Tuner
    cache = ROOT / "build" / "tuning"
    shutil.rmtree(cache, ignore_errors=True)
    tuner = Tuner(cache, device=dev)
    cubes, out, ok = {}, {}, True
    reps, warmup = 5, 2
    for name, dims, pods, sels in TUNE_CUBES:
        cube = cubes[name] = Hypercube.build(dims, pods=pods)
        a2a = []

        def progress(prim, sel, nbytes, cell, a2a=a2a):
            if prim == "all_to_all":
                a2a.append((sel, nbytes, reorder.LAUNCHES, [
                    s.stage for s in cell]))

        reorder.LAUNCHES = 0
        t0 = time.perf_counter()
        prof = tuner.tune(cube, sizes=TUNE_SIZES, dims=sels, reps=reps,
                          warmup=warmup, progress=progress)
        tune_s = time.perf_counter() - t0
        # reorder launches of each all_to_all cell: one a call of its cm
        # (and pr) flows, warmup + reps calls a flow
        launches, prev = [], 0
        for sel, nbytes, count, stages in a2a:
            want = (warmup + reps) * sum(st in ("cm", "pr") for st in stages)
            launches.append({"dims": "x".join(sel), "bytes": nbytes,
                             "launches": count - prev, "expected": want})
            prev = count
        big = [(s, _card_bytes(s, cube) / s.seconds) for s in prof.samples
               if _card_bytes(s, cube) > 4 * L2_BYTES]
        fastest = max(big, key=lambda t: t[1]) if big else (None, 0.0)
        checks = {
            "reorder_launches_exact": all(c["launches"] == c["expected"]
                                          for c in launches),
            "no_rate_over_hbm": all(r <= HBM_BYTES_PER_S for _, r in big),
            "auto": _auto_checks(cube, prof, dev)}
        reloaded = tuner.load(cube)
        checks["reload_equal"] = reloaded.to_json() == prof.to_json()
        other = cubes.get("ring8") if name != "ring8" else \
            Hypercube.build({"d": 4})
        try:
            CommProfile.load(tuner.profile_path(cube), cube=other,
                             device=dev)
            checks["refused_elsewhere"] = False
        except ProfileMismatchError:
            checks["refused_elsewhere"] = True
        cube_ok = (checks["reorder_launches_exact"]
                   and checks["no_rate_over_hbm"]
                   and all(c["ok"] for c in checks["auto"])
                   and checks["reload_equal"] and checks["refused_elsewhere"])
        ok &= cube_ok
        out[name] = {
            "ok": cube_ok, "cube": cube.describe(), "tune_s": tune_s,
            "samples": len(prof.samples),
            "models": {k: {"alpha_us": m.alpha * 1e6,
                           "GB_per_s": (1e-9 / m.beta if m.beta > 0
                                        else None),
                           "r2": m.r2, "n": m.n}
                       for k, m in sorted(prof.models.items())},
            "overlap": {k: m.factor for k, m in prof.overlap.items()},
            "picks": (picks := _picks(cube, prof, prof.samples)),
            "picks_summary": {
                "cells": len(picks),
                "pick_is_fastest": sum(p["pick"] == p["fastest"]
                                       for p in picks),
                "max_ratio": max(p["pick_over_fastest"] or 1.0
                                 for p in picks)},
            "a2a_reorder_launches": launches,
            "fastest_big_cell": None if fastest[0] is None else {
                "primitive": fastest[0].primitive,
                "algorithm": fastest[0].algorithm,
                "bytes": fastest[0].nbytes, "rate_B_per_s": fastest[1]},
            **{k: v for k, v in checks.items() if k != "auto"},
            "auto": checks["auto"]}
    # select through its fallback: a cube never tuned has no fit
    ring4 = Hypercube.build({"d": 4})
    before = os.path.exists(tuner.profile_path(ring4))
    pick = tuner.select("all_reduce", 1 << 20, ring4.comm("d"))
    grown = len(CommProfile.load(tuner.profile_path(ring4)).samples)
    out["select_fallback"] = {"pick": pick, "profile_existed": before,
                              "samples_after": grown,
                              "ok": not before and grown > 0}
    out["grad_sync"] = _grad_sync_drift(dev, tuner)
    ok &= out["select_fallback"]["ok"] and out["grad_sync"]["ok"]
    return {"ok": ok, "sizes": list(TUNE_SIZES), "cubes": out,
            "reorder_launches": sum(
                c["launches"] for name, *_ in TUNE_CUBES
                for c in out[name]["a2a_reorder_launches"])}


# -------------------------------------------------------------------- RWKV
def plain_rwkv6():
    """While open, the model's RWKV6 recurrence runs the kernel's plain
    version on the card (a reference computation: no launch)."""
    from repro_torch.kernels.rwkv6 import ops, ref
    return patched(ops, "rwkv6_chunked", lambda _: ref.rwkv6_chunked)


def _rwkv_tokens_ok(ref_logits, ref_tokens, got_tokens, bound) -> dict:
    """Greedy tokens of prefill + decode against the teacher-forced loop.
    Identical, or the first that differs is a tie within ``bound`` in the
    loop's logits at that step (after it the inputs differ, so nothing
    later is compared). ref_logits: (B, gen, V); tokens: (B, gen)."""
    diff = ref_tokens != got_tokens
    if not bool(diff.any()):
        return {"identical": True, "ok": True}
    step = int(diff.any(0).nonzero()[0])
    rows = diff[:, step]
    lg = ref_logits[:, step][rows]
    picked = lg.gather(1, got_tokens[:, step][rows][:, None])[:, 0]
    gap = float((lg.max(-1).values - picked).max())
    return {"identical": False, "first_divergence": step,
            "tie_gap": gap, "ok": gap <= bound}


def _held(got, want, tol: float) -> dict:
    """|got - want| against ``tol`` x max(1, max|want|)."""
    want = want.float()
    bound = tol * max(1.0, float(want.abs().max()))
    err = float((got.float() - want).abs().max())
    return {"err": err, "bound": bound, "ok": err <= bound}


def _global_cache(run, cache) -> dict:
    """A copy of the p0 cache leaves as global tensors: state (layers, B,
    H, K, V) f32, shift and cm_shift (layers, B, D)."""
    cube = run["topo"].cube
    return {k: cube.from_cube(v, (None, None, "tp") if k == "state" else ())
            .clone() for k, v in cache["p0"].items()}


def _rwkv_prefill(run, dev, dtype, watch) -> dict:
    """``prefill_shard`` of the run's prompt on the run's server geometry:
    the last prompt position's global logits, the cache (cube layout), the
    kernel's launches and the wall time. ``watch``: a context open around
    the prefill."""
    from repro_torch.kernels.rwkv6 import rwkv6
    from repro_torch.models.serving import Server
    topo, plan = run["topo"], run["plan"]
    cube, ba = topo.cube, plan.batch_axes or None
    server = Server(run["cfg"], topo, plan, dtype=dtype)
    toks = torch.from_numpy(run["tokens"][:, :PROMPT]).to(dev)
    n0 = rwkv6.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with watch:
        logits, cache = server.prefill_shard(
            run["params"], {"tokens": cube.to_cube(toks, (topo.dp, None))})
    torch.cuda.synchronize()
    return {"last": cube.from_cube(logits, (ba, topo.tp)), "cache": cache,
            "launches": rwkv6.LAUNCHES - n0,
            "prefill_s": time.perf_counter() - t0, "server": server}


def _rwkv_prefill_decode(run, dev, dtype, watch) -> dict:
    """Prefill of the run's prompt, then decode of the generated tokens from
    its cache: ``_rwkv_prefill``'s fields with the cache prefill made as
    global tensors (decode then writes into the original) and the greedy
    tokens."""
    pd = _rwkv_prefill(run, dev, dtype, watch)
    server, cache = pd.pop("server"), pd["cache"]
    pd["cache"] = _global_cache(run, cache)
    topo, plan = run["topo"], run["plan"]
    cube, ba = topo.cube, plan.batch_axes or None
    out = [pd["last"].argmax(-1)]
    for t in range(PROMPT, PROMPT + GEN - 1):
        pos = torch.full((BATCH,), t, dtype=torch.int64, device=dev)
        lg, cache = server.decode_shard(
            run["params"], cache, cube.to_cube(out[-1], (ba,)),
            cube.to_cube(pos, (ba,)))
        out.append(cube.from_cube(lg, (ba, topo.tp)).argmax(-1))
    pd["tokens"] = torch.stack(out, 1)
    return pd


def _launch_checks(calls: list, dtype) -> dict:
    """Each recorded launch (inputs, outputs) against the plain version on
    the same inputs, o and final state within RWKV6_TOL x max(1,
    max|plain|); in f32 also against the one-token recurrence step by
    step (``ssm.rwkv6_reference``) within 1e-4 x max(1, max|ref|)."""
    from repro_torch.kernels.rwkv6 import ref
    from repro_torch.models import ssm
    worst_plain = worst_steps = 0.0
    for x, got in calls:
        worst_plain = max(worst_plain, _rwkv6_compare(got,
                                                      ref.rwkv6_chunked(*x)))
        if dtype == torch.float32:
            r, k, v, logw, u, state = x
            if u.dim() == 3:            # one u per PE: rows of its batch
                u = u.repeat_interleave(r.shape[0] // u.shape[0], dim=0)
            worst_steps = max(worst_steps, _rwkv6_compare(
                got, ssm.rwkv6_reference(r, k, v, logw, u, state)))
    out = {"launches": len(calls), "vs_plain_err": worst_plain,
           "ok": bool(calls) and worst_plain <= RWKV6_TOL[dtype]}
    if dtype == torch.float32:
        out["vs_steps_err"] = worst_steps
        out["ok"] &= worst_steps <= F32_TOL
    return out


def _rwkv_run(dev, pes, dtype) -> dict:
    """One full-width RWKV6 serve at ``pes`` PEs through the launcher's
    function, then ``forward_logits`` on the served tokens and prefill +
    decode of its prompt, every kernel launch of the forward and the
    prefill checked against the plain version on its inputs. Then the
    witness: the same forward and prefill with the kernel's plain version
    in place of the kernel (only the recurrence differs), which the
    kernel's paths are held to within RWKV_PATH_TOL. In bf16 also the f32
    forward of the same tokens on the plain version, for the size of bf16
    rounding alone (reported)."""
    from repro_torch.kernels.rwkv6 import rwkv6
    from repro_torch.launch.serve import serve
    from repro_torch.models.lm import Model
    from repro_torch.models.topology import build_topology
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run = serve(RWKV_ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN, pes=pes,
                device=dev, seed=0, dtype=dtype, keep_logits=True,
                n_layers=RWKV_SERVE_LAYERS)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    cfg = dataclasses.replace(run["cfg"], tp=pes)
    ftopo = build_topology(cfg, pes)
    if ftopo.cube != run["topo"].cube:
        raise RuntimeError("forward and serve cubes differ")
    toks = run["tokens"]
    batch = {"tokens": ftopo.cube.to_cube(torch.from_numpy(toks).to(dev),
                                          (ftopo.dp, None))}

    def forward(dt):
        out = Model(cfg, ftopo, dtype=dt).forward_logits(run["params"], batch)
        return ftopo.cube.from_cube(out, (ftopo.dp, None, ftopo.tp))[:, :-1]

    calls = {"forward": [], "prefill": []}

    def watch(path):
        return watch_rwkv6(lambda x, y: calls[path].append((x, y)))

    n0 = rwkv6.LAUNCHES
    t0 = time.perf_counter()
    with watch("forward"):
        fwd = forward(dtype)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    n_fwd = rwkv6.LAUNCHES - n0
    pd = _rwkv_prefill_decode(run, dev, dtype, watch("prefill"))
    n0 = rwkv6.LAUNCHES
    with plain_rwkv6():
        fwd_plain = forward(dtype)
        pre_plain = _rwkv_prefill(run, dev, dtype, contextlib.nullcontext())
        if dtype == torch.bfloat16:
            fwd32 = forward(torch.float32)
    torch.cuda.synchronize()
    n_plain = rwkv6.LAUNCHES - n0
    plain_cache = _global_cache(run, pre_plain["cache"])
    del pre_plain["cache"], pre_plain["server"]
    run["plain_cache"] = plain_cache
    dec = torch.stack(run["logits"], dim=1)               # (B, S-1, Vp)
    ref_tok = torch.from_numpy(toks[:, PROMPT:]).to(dev)
    tol = RWKV_PATH_TOL[dtype]
    stated = SERVE_TOL if dtype == torch.bfloat16 else F32_TOL
    witness = {"forward_logits": _held(fwd, fwd_plain, tol),
               "prefill_last_logits": _held(pd["last"], pre_plain["last"],
                                            tol)}
    witness.update({f"prefill_{k}": _held(pd["cache"][k], plain_cache[k],
                                          tol) for k in plain_cache})
    vs_dec = _held(fwd, dec, stated)
    last_scale = max(1.0, float(dec[:, PROMPT - 1].abs().max()))
    s = {
        "pes": pes, "cube": run["topo"].cube.describe(),
        "dtype": str(dtype).split(".")[-1],
        "ms_per_step": run["ms_per_step"],
        "p75_ms_per_step": float(np.percentile(run["step_ms"][1:], 75)),
        "steps_timed": len(run["step_ms"]) - 1,
        "tok_per_s": run["tok_per_s"], "serve_s": serve_s,
        "forward_s": forward_s, "prefill_s": pd["prefill_s"],
        "rwkv6_launches_decode_loop": run["rwkv6_launches"],
        "rwkv6_launches_forward": n_fwd,
        "rwkv6_launches_prefill": pd["launches"],
        "rwkv6_launches_plain_witness": n_plain,
        "expected_launches_per_path": run["cfg"].n_layers,
        "launch_checks": {p: _launch_checks(c, dtype)
                          for p, c in calls.items()},
        "kernel_vs_plain_path": witness,
        "decode_vs_forward_err": vs_dec["err"],
        "decode_vs_forward_stated_bound": vs_dec["bound"],
        "decode_greedy_matches_forward": float(
            (dec.argmax(-1) == fwd.argmax(-1)).float().mean()),
        "prefill_last_logits_err": float(
            (pd["last"] - dec[:, PROMPT - 1]).abs().max()),
        "prefill_last_logits_scale": last_scale,
        "prefill_last_logits_stated_bound": stated * last_scale,
        "plain_prefill_last_logits_err": float(
            (pre_plain["last"] - dec[:, PROMPT - 1]).abs().max()),
        "finite": bool(torch.isfinite(dec).all() and torch.isfinite(fwd).all()
                       and torch.isfinite(pd["last"]).all()),
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30,
    }
    run["last_inputs"] = {p: c[-1][0] for p, c in calls.items() if c}
    del calls
    if dtype == torch.bfloat16:
        s.update(decode_vs_f32_err=float((dec - fwd32).abs().max()),
                 forward_vs_f32_err=float((fwd - fwd32).abs().max()),
                 f32_max_logit=float(fwd32.abs().max()))
        del fwd32
    s["prefill_decode_tokens"] = _rwkv_tokens_ok(
        dec[:, PROMPT - 1:], ref_tok, pd["tokens"],
        tol * max(1.0, float(dec.abs().max())))
    run.update(dec=dec, pd=pd, summary=s)
    return run


def _rwkv_path_ok(s: dict) -> bool:
    """The launches (32 per forward and per prefill, none in the decode
    loop or the witness), every launch against the plain version, the
    kernel's paths against the witness, finite logits."""
    n = s["expected_launches_per_path"]
    return (s["finite"] and s["rwkv6_launches_decode_loop"] == 0
            and s["rwkv6_launches_plain_witness"] == 0
            and s["rwkv6_launches_forward"] == n
            and s["rwkv6_launches_prefill"] == n
            and all(c["ok"] for c in s["launch_checks"].values())
            and all(w["ok"] for w in s["kernel_vs_plain_path"].values()))


def _cast_ms(run, dev) -> dict:
    """Device time of one decode step's weight gather (``gather_params``:
    the f32 -> bf16 cast of every unit's leaves) and of its part on the
    leaves replicated over tp, which the cast writes once per PE: device
    kernels summed under ``torch.profiler``, after one warm pass."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import blocks
    from repro_torch.models.lm import Model
    cfg, topo = run["cfg"], run["topo"]
    m = Model(cfg, topo)
    specs = m.unit_specs["p0"]
    rep = {k for k, sp in specs.items() if not any(
        a in topo.tp for e in sp if e for a in ((e,) if isinstance(e, str)
                                                else e))}

    def gather(keys):
        out_bytes = 0
        for u in range(m.n_units):
            w = m.unit_params(run["params"], u, 0)
            got = blocks.gather_params({k: w[k] for k in keys}, specs, topo,
                                       torch.bfloat16)
            out_bytes += sum(t.numel() * t.element_size()
                             for t in got.values())
        return out_bytes

    res = {"replicated_leaves": sorted(rep)}
    for name, keys in (("all", set(specs)), ("replicated", rep)):
        gather(keys)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            nbytes = gather(keys)
            torch.cuda.synchronize()
        res[f"{name}_device_ms"] = sum(
            ev.time_range.elapsed_us() for ev in prof.events()
            if ev.device_type == DeviceType.CUDA) / 1e3
        res[f"{name}_bytes_written"] = nbytes
    return res


def phase_serve_rwkv(dev, kept: dict) -> dict:
    """The RWKV6 main path in bf16 at 1 and 8 PEs; ``kept`` receives the
    inputs of the RWKV6 kernel's last launch on each path. Gates: the
    launches; each launch against the plain version within 5e-2; the
    forward's logits, prefill's last-position logits and prefill's cache
    against the same paths on the plain version within RWKV_PATH_TOL
    [bf16] x max(1, max|ref|); prefill + decode's greedy tokens the loop's,
    or a tie within that bound. Decode vs forward and prefill vs the loop
    are reported beside 5e-2 x max(1, max|ref|)."""
    from repro_torch.kernels.rwkv6 import rwkv6
    rwkv6.LAUNCHES = 0          # the main path's run starts here
    runs = {}
    for pes in PES:
        run = _rwkv_run(dev, pes, torch.bfloat16)
        for path, x in run.pop("last_inputs").items():
            kept[f"{path}/{pes}pe"] = x
        run["summary"]["profile"] = profile_decode(run, dev)
        run["summary"]["weight_cast"] = _cast_ms(run, dev)
        runs[pes] = _drop(run)
    launches = rwkv6.LAUNCHES
    a, b = runs[PES[0]], runs[PES[-1]]
    same = np.cumprod(a["tokens"][:, :-1] == b["tokens"][:, :-1], axis=1)
    same = torch.from_numpy(same.astype(bool)).to(dev)
    sums = [runs[p]["summary"] for p in PES]
    expected = 2 * len(PES) * sums[0]["expected_launches_per_path"]
    ok = launches == expected and all(
        _rwkv_path_ok(s) and s["prefill_decode_tokens"]["ok"] for s in sums)
    return {"ok": ok, "arch": RWKV_ARCH, "batch": BATCH,
            "prompt_len": PROMPT, "gen": GEN, "runs": sums,
            "pe1_vs_pe8_err": float((a["dec"] - b["dec"]).abs()[same].max()),
            "pe1_vs_pe8_scale": max(1.0, float(a["dec"].abs().max())),
            "compared_steps": int(same.sum()),
            "greedy_agreement_pe1_pe8": float(
                (a["tokens"][:, PROMPT:] == b["tokens"][:, PROMPT:]).mean()),
            "rwkv6_launches": launches, "expected_rwkv6_launches": expected}


def _rwkv_loop_cache(run, dev, dtype) -> dict:
    """The teacher-forced loop's cache after the prompt: the launcher's
    first PROMPT decode steps again, on a fresh cache."""
    from repro_torch.models.serving import Server, init_cache
    cfg, topo, plan = run["cfg"], run["topo"], run["plan"]
    cube, ba = topo.cube, plan.batch_axes or None
    server = Server(cfg, topo, plan, dtype=dtype)
    cache = init_cache(cfg, topo, plan, dtype=dtype, device=dev)
    toks = torch.from_numpy(run["tokens"]).to(dev)
    for t in range(PROMPT):
        pos = torch.full((BATCH,), t, dtype=torch.int64, device=dev)
        server.decode_shard(run["params"], cache,
                            cube.to_cube(toks[:, t], (ba,)),
                            cube.to_cube(pos, (ba,)))
    return cache


def phase_serve_rwkv_f32(dev) -> dict:
    """The same in f32 (TF32 off). Gates: 1-PE vs 8-PE logits within 1e-4
    x max(1, max|ref|) and identical greedy tokens; the launches; each
    launch against the plain version (5e-4) and against the one-token
    recurrence step by step (1e-4); the kernel's paths against the same
    paths on the plain version within 1e-4 x max(1, max|ref|); prefill's
    last-position logits and its cache (final state, shifts) against the
    teacher-forced loop's logits at that position and the cache the loop
    reaches after the prompt, within RWKV_LOOP_F32_TOL x max(1, max|ref|)
    (1e-4 is reported beside it, and the plain prefill's distance from
    the loop as the witness); prefill + decode's greedy tokens identical
    to the loop's."""
    runs = {}
    for pes in PES:
        run = _rwkv_run(dev, pes, torch.float32)
        s = run["summary"]
        loop = _global_cache(run, _rwkv_loop_cache(run, dev, torch.float32))
        s["layers"] = int(loop["state"].shape[0])
        s["prefill_vs_loop_cache"] = {k: {
            **_held(run["pd"]["cache"][k], want, RWKV_LOOP_F32_TOL),
            "stated_bound": F32_TOL * max(1.0, float(want.abs().max())),
            "plain_prefill_err": float((run["plain_cache"][k] - want)
                                       .abs().max())}
            for k, want in loop.items()}
        s["identical_tokens"] = bool(torch.equal(
            run["pd"]["tokens"].cpu(),
            torch.from_numpy(run["tokens"][:, PROMPT:])))
        del loop
        runs[pes] = _drop(run)
    a, b = runs[PES[0]], runs[PES[-1]]
    scale = max(1.0, float(a["dec"].abs().max()))
    err = float((a["dec"] - b["dec"]).abs().max())
    same_tokens = bool((a["tokens"] == b["tokens"]).all())
    sums = [runs[p]["summary"] for p in PES]
    ok = (err <= F32_TOL * scale and same_tokens
          and all(_rwkv_path_ok(s) and s["identical_tokens"]
                  and s["prefill_last_logits_err"]
                  <= RWKV_LOOP_F32_TOL * s["prefill_last_logits_scale"]
                  and all(v["ok"] for v in s["prefill_vs_loop_cache"]
                          .values())
                  for s in sums))
    return {"ok": ok, "pe1_vs_pe8_err": err, "bound": F32_TOL * scale,
            "greedy_tokens_identical": same_tokens, "runs": sums}


# ------------------------------------------------------------------- train
# full-width qwen3-1.7b training: the launcher's 8-PE layout (tp 8, data 1)
# and data 2 x tp 4, beside 1 PE; bf16 over f32 masters with int8 moments,
# then f32 (TF32 off) with fp32 moments
TRAIN_LAYOUTS = {"1pe": (1, 1), "8pe": (8, 8), "8pe_dp2": (8, 4)}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_TIMED = 4, 1024, 3
TRAIN_F32_BATCH, TRAIN_F32_SEQ = 2, 256
TRAIN_LOSS_STEPS = 5
# TrainConfig's and the launchers' default lr, after a 1-step warmup (the
# first step's lr is 0). At 1e-3 the repeated-batch loss rose again at the
# fifth step, and Adam's normalized update took the rounding of nearly
# cancelled embedding gradients to 1.2-1.4x the params' 1e-4 bound (PERF.md)
TRAIN_LR, TRAIN_WARMUP = 3e-4, 1
PEAK_BF16_FLOPS = 989e12


def keep_train_inputs(kept: dict, kept_bwd: dict, label: str):
    """While open, every launch of the flash forward wrapper stores its
    inputs in ``kept`` and every launch of the backward wrapper in
    ``kept_bwd``, under ``train_forward/<label>`` / ``train_backward/<label>``
    (the last launch wins)."""
    from repro_torch.kernels.attention import flash, flash_bwd

    def wrap_fwd(launch):
        def keeping(q, k, v, q_pos, k_pos, **kw):
            kept[f"train_forward/{label}"] = tuple(
                t.detach() for t in (q, k, v, q_pos, k_pos)) + (kw,)
            return launch(q, k, v, q_pos, k_pos, **kw)
        return keeping

    def wrap_bwd(launch):
        def keeping(*args, **kw):
            kept_bwd[f"train_backward/{label}"] = (
                tuple(t.detach() for t in args), kw)
            return launch(*args, **kw)
        return keeping

    stack = contextlib.ExitStack()
    stack.enter_context(patched(flash, "flash_attention", wrap_fwd))
    stack.enter_context(patched(flash_bwd, "flash_attention_backward",
                                wrap_bwd))
    return stack


def plain_attention_training():
    """While open, the model's training attention runs the plain forward
    and backward on the card in the kernels' place (the witness: no
    launch)."""
    from repro_torch.kernels.attention import ops, ref
    stack = contextlib.ExitStack()
    stack.enter_context(patched(ops, "_forward",
                                lambda _: lambda q: ref.flash_attention))
    stack.enter_context(patched(
        ops, "_backward", lambda _: lambda q: ref.flash_attention_backward))
    return stack


# the witness's controls: the training backward kernel's result spoiled in
# two ways, each of which the witness must catch
WITNESS_CONTROLS = ("zero", "dq_x0.9")


def spoiled_backward(kind: str):
    """While open, the training attention's backward returns the kernel's
    gradients spoiled: ``"zero"`` drops all three (trap 1: a kernel that
    carries no gradient), ``"dq_x0.9"`` scales dq by 0.9."""
    from repro_torch.kernels.attention import ops

    def wrap(pick):
        def spoiled_pick(q):
            backward = pick(q)

            def spoiled(*args, **kw):
                dq, dk, dv = backward(*args, **kw)
                if kind == "zero":
                    return tuple(torch.zeros_like(t) for t in (dq, dk, dv))
                return dq * 0.9, dk, dv
            return spoiled
        return spoiled_pick
    return patched(ops, "_backward", wrap)


def _train_setup(dev, layout: str, tc, n_layers: int | None = None):
    """Config, topology, compact masters (random, seed 0: the same global
    model on every layout) and optimizer state of one layout; ``n_layers``
    cuts the depth."""
    from repro_torch import configs
    from repro_torch.models.params import init_params, param_specs, trainable
    from repro_torch.models.topology import build_topology
    from repro_torch.runtime.trainer import init_opt_state
    pes, tp = TRAIN_LAYOUTS[layout]
    cfg = dataclasses.replace(configs.get(ARCH), tp=tp,
                              n_layers=n_layers or TRAIN_LAYERS)
    topo = build_topology(cfg, pes)
    masters = trainable(init_params(cfg, topo, 0, device=dev),
                        param_specs(cfg, topo), topo.cube)
    return cfg, topo, masters, init_opt_state(masters, cfg, topo, tc)


def _global_grads(step, grads, topo) -> dict:
    """Synced per-PE gradients as global tensors (index 0 of each leaf's
    replicated dims)."""
    from repro_torch.models.params import compact, to_global, tree_map
    cg = tree_map(lambda g, s: compact(g, s, topo.cube), grads, step.specs)
    return to_global(cg, step.specs, topo.cube)


def _tree_held(got: dict, want: dict, tol: float,
               floor: bool = True) -> dict:
    """Per leaf |got - want| against tol x max(1, max|want|), or, with
    ``floor=False``, tol x max|want|: whether every leaf holds, the leaves
    that do not, the worst leaf's ratio to its bound, and each leaf's
    error beside its max|want| (weight gradients lie far below 1, where
    the floor makes the bound an absolute tol)."""
    from repro_torch.models.params import flat_leaves, leaves
    worst, name, failing, per_leaf = 0.0, "", [], {}
    for (path, w), g in zip(leaves(want), flat_leaves(got)):
        key = "/".join(path)
        w = w.to(g.device).float()
        peak = float(w.abs().max())
        err = float((g.float() - w).abs().max())
        bound = tol * (max(1.0, peak) if floor else peak)
        if err > bound:
            failing.append(key)
        ratio = err / bound if bound > 0 else (0.0 if err == 0
                                               else math.inf)
        per_leaf[key] = {"err": err, "max_abs": peak}
        if ratio >= worst:
            worst, name = ratio, key
    return {"ok": not failing, "floor_at_1": floor, "failing": failing,
            "worst_leaf": name, "worst_err_over_bound": worst,
            "leaves": per_leaf}


def _train_bf16(dev, layout: str, kept: dict, kept_bwd: dict) -> dict:
    """One layout's bf16 run: a warm-up step and TRAIN_TIMED timed steps on
    TokenStream through ``Trainer.run``, the launches of each step, the
    grad-sync program's lowerings, peak memory, and a profile of one
    step."""
    from repro_torch.core import program
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.kernels.attention import flash, flash_bwd
    from repro_torch.runtime.trainer import (
        Trainer, TrainConfig, place_batch)
    tc = TrainConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=100)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, topo, masters, opt = _train_setup(dev, layout, tc)
    stream = TokenStream(cfg, DataConfig(seq_len=TRAIN_SEQ,
                                         global_batch=TRAIN_BATCH,
                                         vocab_size=cfg.vocab_size))
    trainer = Trainer(cfg, topo, tc)
    steps, hist = [], []
    program.clear_lower_cache()
    for s in range(1 + TRAIN_TIMED):
        batch = place_batch(stream.global_batch_at(s), cfg, topo, dev)
        f0, b0 = flash.LAUNCHES, flash_bwd.LAUNCHES
        low0 = dict(program.LOWER_STATS)
        with keep_train_inputs(kept, kept_bwd, layout):
            masters, opt, h = trainer.run(masters, opt, [batch],
                                          log_every=0)
        hist += h
        steps.append({
            "forward_launches": flash.LAUNCHES - f0,
            "backward_launches": flash_bwd.LAUNCHES - b0,
            "lowered": program.LOWER_STATS["lowered"] - low0["lowered"],
            "cache_hits": (program.LOWER_STATS["cache_hits"]
                           - low0["cache_hits"])})
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    step_ms = [t * 1e3 for t in trainer.step_seconds]
    ms = float(np.median(step_ms[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n = cfg.param_count()
    L = cfg.n_layers
    buckets = steps[0]["lowered"]
    # the bucket programs with a replicated leaf (none on 1 PE)
    from repro_torch.runtime.overlap import bucket_leaf_indices
    from repro_torch.runtime.trainer import replication_dims
    from repro_torch.models.params import flat_leaves, param_specs
    sflat = flat_leaves(param_specs(cfg, topo))
    want_buckets = sum(
        any(replication_dims(sflat[i], topo.cube) for i in idxs)
        for idxs in bucket_leaf_indices(param_specs(cfg, topo)))
    step_fn = trainer.step_fn
    state = {"m": masters, "o": opt}
    prof_batch = place_batch(stream.global_batch_at(0), cfg, topo, dev)

    def step(_):
        state["m"], state["o"], _m = step_fn(state["m"], state["o"],
                                             prof_batch)

    prof = profile_steps(step, steps=1)
    del masters, opt, state, trainer, step_fn
    torch.cuda.empty_cache()
    launches = sum(st["forward_launches"] for st in steps)
    bwd = sum(st["backward_launches"] for st in steps)
    ok = (all(st["forward_launches"] == 2 * L
              and st["backward_launches"] == L for st in steps)
          and buckets == want_buckets
          and (topo.cube.ndev == 1 or buckets >= 1)
          and all(st["lowered"] == 0 and st["cache_hits"] == buckets
                  for st in steps[1:])
          and all(np.isfinite(h["loss"]) for h in hist))
    return {"ok": ok, "layout": layout, "cube": topo.cube.describe(),
            "params": n, "tokens_per_step": tokens,
            "ms_per_step": ms, "step_ms": step_ms,
            "tok_per_s": tokens / (ms / 1e3),
            "mfu": 6 * n * tokens / (ms / 1e3) / PEAK_BF16_FLOPS,
            "peak_mem_gb": peak, "losses": [h["loss"] for h in hist],
            "per_step": steps, "grad_sync_programs": buckets,
            "expected": {"forward_launches": 2 * L, "backward_launches": L},
            "forward_launches": launches, "backward_launches": bwd,
            "profile": prof}


def _train_loss_falls(dev) -> dict:
    """One batch repeated for TRAIN_LOSS_STEPS steps at 1 PE (bf16), the
    lr warming up over the run: every loss after the first update is below
    the first, the last the lowest; the first is near ln(vocab) for random
    weights (above it by the logits' variance over 2: 0.02 x sqrt(2,048),
    squared, halved, about 0.4)."""
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.runtime.trainer import Trainer, TrainConfig, place_batch
    tc = TrainConfig(lr=TRAIN_LR, warmup=TRAIN_LOSS_STEPS, total_steps=100)
    cfg, topo, masters, opt = _train_setup(dev, "1pe", tc)
    batch = place_batch(TokenStream(cfg, DataConfig(
        seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        vocab_size=cfg.vocab_size)).global_batch_at(0), cfg, topo, dev)
    _, _, hist = Trainer(cfg, topo, tc).run(
        masters, opt, [batch] * TRAIN_LOSS_STEPS, log_every=0)
    del masters, opt
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    return {"ok": (all(np.isfinite(losses))
                   and all(x < losses[0] for x in losses[2:])
                   and losses[-1] == min(losses)
                   and abs(losses[0] - math.log(cfg.vocab_size)) < 1.0),
            "losses": losses, "ln_vocab": math.log(cfg.vocab_size)}


def _train_f32(dev, layout: str, ref: dict | None) -> dict:
    """f32 (TF32 off), fp32 moments, global batch TRAIN_F32_BATCH x
    TRAIN_F32_SEQ: the first step's loss and synced gradients, the params
    after 2 steps; at 8 PEs the barrier sync against the overlapped one
    (the backward's bucket hooks, and the staged post-backward dispatch)
    on the same backward, bit for bit on the synced leaves. At 1 PE the
    witness: the same first step with the plain forward and backward in
    the kernels' place, each leaf within F32_TOL of its own max|g|; and
    its controls: the step with the backward kernel's result spoiled
    (WITNESS_CONTROLS) must fail that bound."""
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.kernels.attention import flash, flash_bwd
    from repro_torch.models.params import flat_leaves, to_global, tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime.overlap import sync_replicated_grads_overlapped
    from repro_torch.runtime.trainer import (
        TrainConfig, make_train_step, place_batch, replication_dims)
    tc = TrainConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=100,
                     adamw=adamw.AdamWConfig(use_8bit=False))
    cfg, topo, masters, opt = _train_setup(dev, layout, tc)
    step = make_train_step(cfg, topo, tc, dtype=torch.float32)
    stream = TokenStream(cfg, DataConfig(seq_len=TRAIN_F32_SEQ,
                                         global_batch=TRAIN_F32_BATCH,
                                         vocab_size=cfg.vocab_size))
    b0 = place_batch(stream.global_batch_at(0), cfg, topo, dev)
    b1 = place_batch(stream.global_batch_at(1), cfg, topo, dev)
    out: dict = {"layout": layout, "cube": topo.cube.describe()}
    f0, k0 = flash.LAUNCHES, flash_bwd.LAUNCHES
    loss, _, raw = step.fwd_bwd(masters, b0)
    out["launches"] = [flash.LAUNCHES - f0, flash_bwd.LAUNCHES - k0]
    synced = step.sync(raw, {})
    out["loss"] = float(loss.reshape(-1)[0])
    grads = _global_grads(step, synced, topo)
    expected = [2 * cfg.n_layers, cfg.n_layers]
    # the 1-PE reference, kept on the host (the step scales its gradients
    # in place, and the device holds one layout's model at a time)
    held = None if ref is not None else {
        "loss": out["loss"],
        "grads": tree_map(lambda t: t.to("cpu", copy=True), grads)}
    if layout == "1pe":
        f1, k1 = flash.LAUNCHES, flash_bwd.LAUNCHES
        with plain_attention_training():
            _, _, wraw = step.fwd_bwd(masters, b0)
        out["witness_launches"] = [flash.LAUNCHES - f1,
                                   flash_bwd.LAUNCHES - k1]
        witness = _global_grads(step, step.sync(wraw, {}), topo)
        del wraw
        # held per leaf to its own max|g| (no floor at 1), and shown able
        # to catch a spoiled backward
        out["witness"] = _tree_held(grads, witness, F32_TOL, floor=False)
        controls = out["witness_controls"] = {}
        for kind in WITNESS_CONTROLS:
            with spoiled_backward(kind):
                _, _, craw = step.fwd_bwd(masters, b0)
            spoiled = _global_grads(step, step.sync(craw, {}), topo)
            del craw
            held_c = _tree_held(spoiled, witness, F32_TOL, floor=False)
            floored = _tree_held(spoiled, witness, F32_TOL)
            controls[kind] = {"caught": not held_c["ok"],
                              "failing": held_c["failing"],
                              "caught_with_floor_at_1": not floored["ok"],
                              "failing_with_floor_at_1": floored["failing"]}
            del spoiled
        out["ok"] = (out["witness"]["ok"]
                     and all(c["caught"] for c in controls.values())
                     and out["witness_launches"] == [0, 0]
                     and out["launches"] == expected)
        del witness
    else:
        # the same backward's partials through the staged bucket dispatch,
        # then a second backward through the hooks
        staged = sync_replicated_grads_overlapped(raw, step.specs,
                                                  topo.cube)
        _, _, hooked = step.fwd_bwd(masters, b0, overlap=True)
        repl = [bool(replication_dims(s, topo.cube))
                for s in flat_leaves(step.specs)]
        same_staged = all(torch.equal(a, b) for a, b in zip(
            flat_leaves(synced), flat_leaves(staged)))
        same_hooked = all(torch.equal(a, b) for a, b, r in zip(
            flat_leaves(synced), flat_leaves(hooked), repl) if r)
        bo = out["barrier_vs_overlap"] = {
            "staged_bit_identical": same_staged,
            "hooked_bit_identical_on_synced_leaves": same_hooked,
            "synced_leaves": sum(repl),
            "hooked_max_abs_diff_all_leaves": max(
                float((a - b).abs().max()) for a, b in zip(
                    flat_leaves(synced), flat_leaves(hooked)))}
        del staged, hooked
        out["loss_vs_1pe_rel"] = abs(out["loss"] - ref["loss"]) / abs(
            ref["loss"])
        out["grads_vs_1pe"] = _tree_held(grads, ref["grads"], F32_TOL,
                                         floor=False)
        out["ok"] = (out["loss_vs_1pe_rel"] <= 1e-5
                     and out["grads_vs_1pe"]["ok"]
                     and bo["staged_bit_identical"]
                     and bo["hooked_bit_identical_on_synced_leaves"]
                     and out["launches"] == expected)
    del raw, grads
    masters, opt, _ = step.opt(masters, opt, synced)   # step 1
    del synced
    masters, opt, _ = step(masters, opt, b1)           # step 2
    params = to_global(masters, step.specs, topo.cube)
    del masters, opt
    if ref is not None:
        out["params_after_2_vs_1pe"] = _tree_held(params, ref["params"],
                                                  F32_TOL)
        out["ok"] = out["ok"] and out["params_after_2_vs_1pe"]["ok"]
    if held is not None:
        held["params"] = tree_map(lambda t: t.to("cpu", copy=True),
                                  params)
    del params
    torch.cuda.empty_cache()
    return out, held


def phase_train(dev, kept: dict, kept_bwd: dict) -> dict:
    """Full-width qwen3-1.7b training through the launcher's functions
    (``Trainer``, ``make_train_step``): the flash forward (with the row
    statistics) and the backward kernel on the path, counted from 0 just
    before the bf16 runs. See ``_train_bf16``, ``_train_loss_falls`` and
    ``_train_f32``."""
    from repro_torch.kernels.attention import flash, flash_bwd
    flash.LAUNCHES = flash_bwd.LAUNCHES = 0     # the main path starts here
    bf16 = {name: _train_bf16(dev, name, kept, kept_bwd)
            for name in TRAIN_LAYOUTS}
    # the runs' steps (each step's count is gated; the profiled steps and
    # the reference runs below are left out)
    launches = (sum(r["forward_launches"] for r in bf16.values()),
                sum(r["backward_launches"] for r in bf16.values()))
    falls = _train_loss_falls(dev)
    f32, ref = {}, None
    for name in TRAIN_LAYOUTS:
        f32[name], held = _train_f32(dev, name, ref)
        if ref is None:
            ref = held
        del held
    del ref
    torch.cuda.empty_cache()
    return {"ok": (all(r["ok"] for r in bf16.values()) and falls["ok"]
                   and all(r["ok"] for r in f32.values())),
            "arch": ARCH, "batch": [TRAIN_BATCH, TRAIN_SEQ],
            "bf16": bf16, "loss_falls": falls, "f32": f32,
            "flash_launches": launches[0], "flash_bwd_launches": launches[1]}


# ---------------------------------------------------------- train_moe_rwkv
# The ported archs other than qwen3 trained at full width through the same
# functions. qwen2-moe-a2.7b and rwkv6-7b have their depth cut so that f32
# masters and gradients, int8 moments and the backward's transients fit in
# 80 GB. qwen3's 13.5 GB of peak per billion parameters planned 6 MoE
# layers (4.05 B) and 16 RWKV6 ones (4.03 B); at 6 MoE layers the first
# step ran out of memory on an H100 (59.7 GB allocated and 16.6 GB held free
# by the allocator when a 4.1 GB stacked expert gradient was asked for: the
# backward stacks each unit's gradients of a stacked leaf), so the cut is
# MoE 4 of 24 layers (2.90 B parameters at 1 PE, 3.04 B at ep 8 with the 64
# padded experts) and RWKV6 12 of 32 (3.15 B, whose channel-mix leaves
# stack the same way). phi3-mini-3.8b (hd 96) and gemma3-1b (hd 256, local
# windows of 512) train at full depth; mixtral-8x7b at 2 of 32 layers (1.45
# B a layer: 3.17 B with the embeddings, qwen2-moe's size). The 8-PE
# layouts are ``launch/train.py --pes 8``'s: model parallelism min(model
# parallel, 8), the rest data (MoE: ep 8, etp 1, the one that runs the
# reorder; RWKV6 and phi3: tp 8; gemma3: data 2 x tp 4, its 4 query heads
# bounding tp).
MIXTRAL_ARCH = "mixtral-8x7b"
# internlm2-20b at 8 of 48 layers: 4.26 B parameters, a step's peak 43.3
# GB at 1 PE and 50.0 GB at tp 8 (10.2 / 11.7 bytes a parameter); at 12
# the tp-8 cell ran out of the card's 80 GB, and at 10 (peak 62.2 GB) it
# did once too, with 17 GB of the allocator's cache free but fragmented;
# whisper-base at full depth (6 encoder + 6 decoder layers)
TRAIN_MR_ARCHS = {"moe": (MOE_ARCH, 2), "rwkv": (RWKV_ARCH, 6),
                  "phi3": ("phi3-mini-3.8b", 8), "gemma3": ("gemma3-1b", 12),
                  "mixtral": (MIXTRAL_ARCH, 2),
                  "internlm2": ("internlm2-20b", 4),
                  "whisper": ("whisper-base", 6),
                  "llava": (LLAVA_ARCH, 6), "jamba": (JAMBA_ARCH, 8)}
# the cells that train in phases of their own (train_llava, train_jamba)
TRAIN_OWN_PHASE = ("llava", "jamba")
# llava-next-34b at 6 of 60 layers (4.27 B parameters with its embedding
# and head, as many as internlm2's 8-layer cell, whose tp-8 step peaked at
# 52 GB); jamba-1.5-large one unit (8 layers) at d_model 2,048 and FFN
# widths 6,144 (3.05 B parameters, 12.2 GB of f32 masters), its heads,
# experts, state and vocab as published
TRAIN_MR_CHANGES = {"jamba": {"d_model": 2048, "d_ff": 6144,
                              "d_ff_expert": 6144}}
# (batch, sequence) where TRAIN_BATCH x TRAIN_SEQ does not fit the arch:
# llava's 2,880 patches come first, so its sequence holds them and 1,216
# text tokens (bf16) / 192 (the f32 witness)
TRAIN_MR_SHAPE = {"llava": (2, 4096)}
TRAIN_MR_F32_SHAPE = {"llava": (1, 3072)}
TRAIN_MR_PES = {"1pe": 1, "8pe": 8}
# the f32 witness cells, at full width and a smaller cut: one step's
# gradients only (no optimizer state), so the run's gradients and the
# witness's stay on the card together (the run's wait on the host); gemma3
# at 6 layers so that its sixth, global, layer runs beside five local ones
TRAIN_MR_F32 = {("rwkv", "1pe"): 4, ("rwkv", "8pe"): 4, ("moe", "8pe"): 2,
                ("phi3", "1pe"): 4, ("phi3", "8pe"): 4, ("gemma3", "1pe"): 6,
                ("gemma3", "8pe"): 6, ("mixtral", "8pe"): 2,
                ("internlm2", "1pe"): 2, ("internlm2", "8pe"): 2,
                ("whisper", "1pe"): 6, ("whisper", "8pe"): 6,
                ("llava", "1pe"): 2, ("llava", "8pe"): 2,
                ("jamba", "1pe"): 8, ("jamba", "8pe"): 8}
# The repeated-batch check's lr where TRAIN_LR overshoots: phi3 (32 layers
# of d_model 3,072) at 3e-4 fell for three steps, then rose past its first
# loss, with the plain attention in the kernels' place as well
# (tools/loss_falls_lr.py); at 1e-4 both fall at every step. internlm2 (10
# layers of d_model 6,144) at 1e-4 took its loss from 12.66 to 0.30 in its
# first update (lr 2e-5 in the warm-up) and to 5.5e-5 in the next, then to
# 1.7e-4: memorized, it sits at the floor of its loss. At 1e-5 its three
# updates' lrs (2e-6, 4e-6, 6e-6) sum to 0.6 of that first one
TRAIN_MR_LOSS_LR = {"phi3": 1e-4, "internlm2": 1e-5, "llava": 1e-5,
                    "jamba": 1e-4}
RWKV6_BWD_SOURCE = "src/repro_torch/kernels/rwkv6/csrc/rwkv6_bwd.cu"
RWKV6_BWD_REPLACES = "src/repro/models/ssm.py:21"


def _mr_attention(name: str) -> bool:
    """Whether the cell's arch has attention layers (all but RWKV6)."""
    return name != "rwkv"


def _mr_cfg(name: str, pes: int, layers: int | None = None):
    """The cell's arch at full width (TRAIN_MR_CHANGES' cut where it has
    one), ``layers`` deep (else TRAIN_MR_ARCHS' depth), laid out as
    ``launch/train.py --pes`` does: min(model parallel, pes) PEs
    model-parallel (ep for MoE, tp otherwise), the rest data-parallel."""
    from repro_torch import configs
    arch, depth = TRAIN_MR_ARCHS[name]
    cfg = dataclasses.replace(configs.get(arch), n_layers=layers or depth,
                              **TRAIN_MR_CHANGES.get(name, {}))
    mp = min(cfg.model_parallel, pes)
    if cfg.n_experts:
        return dataclasses.replace(cfg, ep=mp, etp=1)
    return dataclasses.replace(cfg, tp=mp)


def _full_depth(arch: str) -> int:
    from repro_torch import configs
    return configs.get(arch).n_layers


def _mr_setup(dev, cfg, pes: int, tc=None):
    """Topology, compact masters (random, seed 0) and, with ``tc``, the
    optimizer state."""
    from repro_torch.models.params import init_params, param_specs, trainable
    from repro_torch.models.topology import build_topology
    from repro_torch.runtime.trainer import init_opt_state
    topo = build_topology(cfg, pes)
    masters = trainable(init_params(cfg, topo, 0, device=dev),
                        param_specs(cfg, topo), topo.cube)
    opt = None if tc is None else init_opt_state(masters, cfg, topo, tc)
    return topo, masters, opt


def _mr_kernels():
    from repro_torch.kernels.attention import flash, flash_bwd
    from repro_torch.kernels.reorder import reorder
    from repro_torch.kernels.rwkv6 import rwkv6, rwkv6_bwd
    return {"flash": flash, "flash_bwd": flash_bwd, "reorder": reorder,
            "rwkv6": rwkv6, "rwkv6_bwd": rwkv6_bwd}


def _mr_expected(cfg, pes: int) -> dict:
    """Launches a train step: the remat runs each layer's forward twice
    (the forward, then its recompute in the backward) and the backward
    once. Attention (every arch but RWKV6): 2 L flash forwards (with row
    statistics) and L backwards; MoE at ep > 1: two all_to_alls a layer
    (dispatch, combine),
    each a reorder in the forward, again in the recompute and once in the
    backward with the inverse perm: 6 L; RWKV6: 2 L forwards (saving the
    sub-chunk states) and L backwards. An encoder-decoder's attention
    layers are its encoder's and each decoder layer's self- and
    cross-attention."""
    from repro_torch.models.config import ATTN, MOE, RWKV
    L = sum(m == ATTN for m in cfg.mixers())
    R = sum(m == RWKV for m in cfg.mixers())
    M = sum(f == MOE for f in cfg.ffns())
    A = 2 * L + cfg.n_enc_layers if cfg.is_encoder_decoder else L
    return {"flash": 2 * A, "flash_bwd": A,
            "reorder": 6 * M if cfg.ep > 1 else 0,
            "rwkv6": 2 * R, "rwkv6_bwd": R}


def keep_rwkv6_train_inputs(kept_fwd: dict, kept_bwd: dict, label: str):
    """While open, every launch of the RWKV6 forward wrapper that saves
    the sub-chunk states stores its inputs in ``kept_fwd`` under
    ``train_forward/<label>``, and every launch of the backward wrapper in
    ``kept_bwd`` under ``train_backward/<label>`` (the last launch
    wins)."""
    from repro_torch.kernels.rwkv6 import rwkv6, rwkv6_bwd

    def detached(args):
        return tuple(None if t is None else t.detach() for t in args)

    def wrap_fwd(launch):
        def keeping(*args, states=False):
            if states:
                kept_fwd[f"train_forward/{label}"] = detached(args)
            return launch(*args, states=states)
        return keeping

    def wrap_bwd(launch):
        def keeping(*args):
            kept_bwd[f"train_backward/{label}"] = detached(args)
            return launch(*args)
        return keeping

    stack = contextlib.ExitStack()
    stack.enter_context(patched(rwkv6, "rwkv6_chunked", wrap_fwd))
    stack.enter_context(patched(rwkv6_bwd, "rwkv6_chunked_backward",
                                wrap_bwd))
    return stack


def _mr_bf16(dev, name: str, layout: str, kept: dict) -> dict:
    """One cell's bf16 run: a warm-up step and TRAIN_TIMED timed steps of
    TRAIN_BATCH x TRAIN_SEQ tokens from TokenStream through
    ``Trainer.run``, each step's launches of every kernel against
    ``_mr_expected``, peak memory, and a profile of one step. mfu counts
    active parameters (MoE: the top-4 of 60 routed experts and the 4
    shared ones; ``active_param_count``). Each kernel's inputs of its last
    launch go to ``kept`` (dicts ``flash``, ``flash_bwd``, ``reorder``,
    ``rwkv6``, ``rwkv6_bwd``) for ``main_path``."""
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.runtime.trainer import Trainer, TrainConfig, place_batch
    arch, layers = TRAIN_MR_ARCHS[name]
    pes = TRAIN_MR_PES[layout]
    label = f"{name}/{layout}"
    cfg = _mr_cfg(name, pes)
    batch_size, seq = TRAIN_MR_SHAPE.get(name, (TRAIN_BATCH, TRAIN_SEQ))
    tc = TrainConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=100)
    torch.cuda.reset_peak_memory_stats(dev)
    topo, masters, opt = _mr_setup(dev, cfg, pes, tc)
    stream = TokenStream(cfg, DataConfig(seq_len=seq,
                                         global_batch=batch_size,
                                         vocab_size=cfg.vocab_size))
    trainer = Trainer(cfg, topo, tc)
    kernels = _mr_kernels()
    want = _mr_expected(cfg, pes)
    steps, hist = [], []
    for s in range(1 + TRAIN_TIMED):
        batch = place_batch(stream.global_batch_at(s), cfg, topo, dev)
        n0 = {k: m.LAUNCHES for k, m in kernels.items()}
        keep = contextlib.ExitStack()
        if _mr_attention(name):
            keep.enter_context(keep_train_inputs(
                kept["flash"], kept["flash_bwd"], label))
        if cfg.n_experts:
            keep.enter_context(keep_reorder_inputs(kept["reorder"],
                                                   f"train/{label}"))
        if not _mr_attention(name):
            keep.enter_context(keep_rwkv6_train_inputs(
                kept["rwkv6"], kept["rwkv6_bwd"], label))
        with keep:
            masters, opt, h = trainer.run(masters, opt, [batch],
                                          log_every=0)
        hist += h
        steps.append({k: m.LAUNCHES - n0[k] for k, m in kernels.items()})
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    step_ms = [t * 1e3 for t in trainer.step_seconds]
    ms = float(np.median(step_ms[1:]))
    tokens = batch_size * seq
    n_active = cfg.active_param_count()
    step_fn = trainer.step_fn
    state = {"m": masters, "o": opt}
    prof_batch = place_batch(stream.global_batch_at(0), cfg, topo, dev)

    def step(_):
        state["m"], state["o"], _m = step_fn(state["m"], state["o"],
                                             prof_batch)

    prof = profile_steps(step, steps=1)
    del masters, opt, state, trainer, step_fn, prof_batch, batch
    torch.cuda.empty_cache()
    ok = (all(st == want for st in steps)
          and all(np.isfinite(h["loss"]) for h in hist))
    return {"ok": ok, "arch": arch, "layout": layout,
            "cube": topo.cube.describe(), "layers": layers,
            "d_model": cfg.d_model, "batch": [batch_size, seq],
            "full_depth": layers == _full_depth(arch),
            "params": cfg.param_count(), "active_params": n_active,
            "tokens_per_step": tokens, "ms_per_step": ms,
            "step_ms": step_ms, "tok_per_s": tokens / (ms / 1e3),
            "mfu": 6 * n_active * tokens / (ms / 1e3) / PEAK_BF16_FLOPS,
            "mfu_counts": "active parameters" if cfg.n_experts
            else "all parameters",
            "peak_mem_gb": peak, "losses": [h["loss"] for h in hist],
            "per_step": steps, "expected_per_step": want,
            "launches": {k: sum(st[k] for st in steps) for k in want},
            "profile": prof}


def _mr_loss_falls(dev, name: str) -> dict:
    """One batch repeated TRAIN_LOSS_STEPS steps at 1 PE (bf16), the lr
    (TRAIN_MR_LOSS_LR, else TRAIN_LR) warming up over the run (the first
    step's lr is 0): every loss after the first update below the first,
    the last the lowest."""
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.runtime.trainer import Trainer, TrainConfig, place_batch
    arch, _ = TRAIN_MR_ARCHS[name]
    cfg = _mr_cfg(name, 1)
    batch_size, seq = TRAIN_MR_SHAPE.get(name, (TRAIN_BATCH, TRAIN_SEQ))
    lr = TRAIN_MR_LOSS_LR.get(name, TRAIN_LR)
    tc = TrainConfig(lr=lr, warmup=TRAIN_LOSS_STEPS, total_steps=100)
    topo, masters, opt = _mr_setup(dev, cfg, 1, tc)
    batch = place_batch(TokenStream(cfg, DataConfig(
        seq_len=seq, global_batch=batch_size,
        vocab_size=cfg.vocab_size)).global_batch_at(0), cfg, topo, dev)
    _, _, hist = Trainer(cfg, topo, tc).run(
        masters, opt, [batch] * TRAIN_LOSS_STEPS, log_every=0)
    del masters, opt, batch
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    return {"ok": (all(np.isfinite(losses))
                   and all(x < losses[0] for x in losses[2:])
                   and losses[-1] == min(losses)),
            "arch": arch, "lr": lr, "losses": losses,
            "ln_vocab": math.log(cfg.vocab_size)}


def plain_moe_rwkv_training():
    """While open, the training path runs every kernel's plain version on
    the card in its place (the witness: no launch): the reorder as
    autograd of ``index_select``, attention as ``plain_attention_training``
    and the RWKV6 recurrence as autograd of ``ref.rwkv6_chunked``."""
    from repro_torch.kernels.reorder import ops as reorder_ops
    from repro_torch.kernels.reorder import ref as reorder_ref
    from repro_torch.kernels.rwkv6 import ops as rwkv6_ops
    from repro_torch.kernels.rwkv6 import ref as rwkv6_ref
    stack = contextlib.ExitStack()
    stack.enter_context(plain_attention_training())
    stack.enter_context(patched(
        reorder_ops, "tile_swizzle",
        lambda _: lambda x, perm, inv=None: reorder_ref.tile_swizzle(x,
                                                                     perm)))
    stack.enter_context(patched(
        rwkv6_ops, "rwkv6_chunked",
        lambda _: lambda r, k, v, logw, u, state=None:
        rwkv6_ref.rwkv6_chunked(r, k, v, logw, u, state)))
    return stack


def spoiled_moe_rwkv(kind: str, perms: list):
    """While open, one kernel's backward is spoiled:
    ``rwkv6_dlogw_zero`` returns the RWKV6 backward kernel's gradients
    with dlogw zeroed; ``reorder_perm_for_inverse`` runs the reorder's
    backward with ``perm`` in place of its inverse (each (perm, inverse)
    pair goes to ``perms``); ``reorder_identity_backward`` leaves the
    gradient's blocks where they are."""
    from repro_torch.kernels.reorder import ops as reorder_ops
    from repro_torch.kernels.rwkv6 import ops as rwkv6_ops
    if kind == "rwkv6_dlogw_zero":
        def wrap(pick):
            def spoiled_pick(r):
                backward = pick(r)

                def spoiled(*args):
                    g = list(backward(*args))
                    g[3] = torch.zeros_like(g[3])
                    return tuple(g)
                return spoiled
            return spoiled_pick
        return patched(rwkv6_ops, "_backward", wrap)

    def swizzle(x, perm, inv=None):
        perms.append((perm, inv))
        if kind == "reorder_perm_for_inverse":
            return reorder_ops.TileSwizzle.apply(x, perm, perm)
        ident = torch.arange(perm.numel(), dtype=torch.int32,
                             device=perm.device)
        return reorder_ops.TileSwizzle.apply(x, perm, ident)
    return patched(reorder_ops, "tile_swizzle", lambda _: swizzle)


def _mr_grads_held(got: dict, want: dict, spread: dict | None) -> dict:
    """Per leaf |got - want| against max(F32_TOL x max|want|, 2 x spread)
    (no floor at 1: weight gradients lie far below 1), ``spread`` being
    max|want - second witness| per leaf where two witness runs differ
    (as a backward that sums with atomics would), else F32_TOL x
    max|want|; also each leaf against F32_TOL x
    max(1, max|want|) (``with_floor_at_1``)."""
    from repro_torch.models.params import flat_leaves, leaves
    failing, failing_floor, per_leaf = [], [], {}
    worst, name = 0.0, ""
    for (path, w), g in zip(leaves(want), flat_leaves(got)):
        key = "/".join(path)
        w, g = w.float(), g.to(w.device).float()
        peak = float(w.abs().max())
        err = float((g - w).abs().max())
        sp = 0.0 if spread is None else spread[key]
        bound = max(F32_TOL * peak, 2 * sp)
        if err > bound:
            failing.append(key)
        if err > F32_TOL * max(1.0, peak):
            failing_floor.append(key)
        ratio = err / bound if bound > 0 else (0.0 if err == 0
                                               else math.inf)
        per_leaf[key] = {"err": err, "max_abs": peak, "spread": sp}
        if ratio >= worst:
            worst, name = ratio, key
    return {"ok": not failing, "failing": failing,
            "failing_with_floor_at_1": failing_floor,
            "worst_leaf": name, "worst_err_over_bound": worst,
            "leaves": per_leaf}


def _mr_spoiled(kind: str, perms: list):
    """The control ``kind``: the flash backward's (``spoiled_backward``) or
    the RWKV6 backward's or the reorder's (``spoiled_moe_rwkv``)."""
    if kind in WITNESS_CONTROLS:
        return spoiled_backward(kind)
    return spoiled_moe_rwkv(kind, perms)


def _mr_f32(dev, name: str, layout: str) -> dict:
    """f32 (TF32 off), TRAIN_F32_BATCH x TRAIN_F32_SEQ tokens, full width
    at TRAIN_MR_F32's depth, one forward and backward with the grad-sync:
    the synced gradients against the witness (``plain_moe_rwkv_training``)
    per leaf (``_mr_grads_held``; for MoE the witness runs twice and its
    spread widens the bound), and the controls of this arch, each of which
    must fail it: the flash backward's gradients zeroed and its dq scaled
    by 0.9 (every arch with attention); the RWKV6 backward with dlogw
    zeroed; the reorder's backward with the identity; with ``perm`` in
    place of its inverse, unless every perm it ran is its own inverse
    (then it is the same computation). The run's gradients wait on the
    host while the witness runs, so that mixtral's fit."""
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models.params import tree_map
    from repro_torch.runtime.trainer import (
        TrainConfig, make_train_step, place_batch)
    arch, _ = TRAIN_MR_ARCHS[name]
    pes = TRAIN_MR_PES[layout]
    cfg = _mr_cfg(name, pes, TRAIN_MR_F32[(name, layout)])
    batch_size, seq = TRAIN_MR_F32_SHAPE.get(name, (TRAIN_F32_BATCH,
                                                    TRAIN_F32_SEQ))
    topo, masters, _ = _mr_setup(dev, cfg, pes)
    step = make_train_step(cfg, topo, TrainConfig(), dtype=torch.float32)
    b0 = place_batch(TokenStream(cfg, DataConfig(
        seq_len=seq, global_batch=batch_size,
        vocab_size=cfg.vocab_size)).global_batch_at(0), cfg, topo, dev)
    kernels = _mr_kernels()

    def grads():
        n0 = {k: m.LAUNCHES for k, m in kernels.items()}
        loss, _, raw = step.fwd_bwd(masters, b0)
        g = _global_grads(step, step.sync(raw, {}), topo)
        del raw
        return g, float(loss.reshape(-1)[0]), {
            k: m.LAUNCHES - n0[k] for k, m in kernels.items()}

    got, loss, launched = grads()
    got = tree_map(lambda t: t.cpu(), got)
    torch.cuda.empty_cache()
    with plain_moe_rwkv_training():
        witness, w_loss, w_launched = grads()
    spread = None
    out = {"arch": arch, "layout": layout, "cube": topo.cube.describe(),
           "layers": cfg.n_layers, "loss": loss, "witness_loss": w_loss,
           "launches": launched, "witness_launches": w_launched}
    if cfg.n_experts:
        with plain_moe_rwkv_training():
            again, _, _ = grads()
        from repro_torch.models.params import flat_leaves, leaves
        spread = {"/".join(p): float((a.float() - w.float()).abs().max())
                  for (p, w), a in zip(leaves(witness), flat_leaves(again))}
        del again
        out["witness_spread"] = {k: v for k, v in spread.items() if v > 0}
    out["witness"] = _mr_grads_held(got, witness, spread)
    del got
    kinds = ((("rwkv6_dlogw_zero",) if cfg.family == "ssm" else ())
             + (("reorder_perm_for_inverse", "reorder_identity_backward")
                if cfg.n_experts and cfg.ep > 1 else ())
             + (WITNESS_CONTROLS if _mr_attention(name) else ()))
    controls = out["controls"] = {}
    for kind in kinds:
        perms: list = []
        with _mr_spoiled(kind, perms):
            spoiled, _, _ = grads()
        held = _mr_grads_held(spoiled, witness, spread)
        del spoiled
        own_inverse = bool(perms) and all(
            inv is not None and torch.equal(p, inv) for p, inv in perms)
        controls[kind] = {
            "caught": not held["ok"], "failing": held["failing"],
            "caught_with_floor_at_1": bool(held["failing_with_floor_at_1"]),
            **({"reorder_calls": len(perms),
                "every_perm_its_own_inverse": own_inverse}
               if kind.startswith("reorder") else {})}
    del witness, masters, b0, step
    torch.cuda.empty_cache()
    want = _mr_expected(cfg, pes)
    out["ok"] = (out["witness"]["ok"] and launched == want
                 and all(v == 0 for v in w_launched.values())
                 and abs(loss - w_loss) <= 1e-5 * abs(w_loss)
                 and all(c["caught"] or (k == "reorder_perm_for_inverse"
                                         and c["every_perm_its_own_inverse"])
                         for k, c in controls.items()))
    return out


def phase_train_moe_rwkv(dev, kept: dict) -> dict:
    """qwen2-moe-a2.7b, rwkv6-7b, phi3-mini-3.8b, gemma3-1b and
    mixtral-8x7b training at full width (TRAIN_MR_ARCHS' depth) through
    ``Trainer`` / ``make_train_step``: every kernel of their paths (flash
    forward and backward, the reorder forward and backward, the RWKV6
    forward with saved states and its backward) counted from 0 just before
    the bf16 runs. See ``_mr_bf16``, ``_mr_loss_falls`` and ``_mr_f32``."""
    return _train_cells(dev, kept, [n for n in TRAIN_MR_ARCHS
                                    if n not in TRAIN_OWN_PHASE])


def _train_cells(dev, kept: dict, names: list) -> dict:
    """The bf16 cells, the repeated-batch checks and the f32 witness cells
    of the archs ``names`` (``_mr_bf16``, ``_mr_loss_falls``,
    ``_mr_f32``), every kernel of their paths counted from 0 just before
    the bf16 runs."""
    kernels = _mr_kernels()
    for m in kernels.values():
        m.LAUNCHES = 0                   # the main path starts here
    bf16 = {f"{n}/{lay}": _mr_bf16(dev, n, lay, kept)
            for n in names for lay in TRAIN_MR_PES}
    launches = {k: sum(r["launches"][k] for r in bf16.values())
                for k in kernels}
    by_arch = {TRAIN_MR_ARCHS[n][0]: {k: sum(
        r["launches"][k] for c, r in bf16.items() if c.startswith(n + "/"))
        for k in kernels} for n in names}
    falls = {n: _mr_loss_falls(dev, n) for n in names}
    f32 = {f"{n}/{lay}": _mr_f32(dev, n, lay) for n, lay in TRAIN_MR_F32
           if n in names}
    return {"ok": (all(r["ok"] for r in bf16.values())
                   and all(r["ok"] for r in falls.values())
                   and all(r["ok"] for r in f32.values())),
            "cut": {TRAIN_MR_ARCHS[n][0]: f"{TRAIN_MR_ARCHS[n][1]} of "
                    f"{_full_depth(TRAIN_MR_ARCHS[n][0])} layers"
                    + (f", {TRAIN_MR_CHANGES[n]}" if n in TRAIN_MR_CHANGES
                       else "") for n in names},
            "batch": [TRAIN_BATCH, TRAIN_SEQ], "bf16": bf16,
            "loss_falls": falls, "f32": f32, "launches": launches,
            "launches_by_arch": by_arch}


def phase_train_llava(dev, kept: dict) -> dict:
    """llava-next-34b training at full width and TRAIN_MR_ARCHS' depth
    through ``Trainer`` at 1 PE and tp 8: batches of TRAIN_MR_SHAPE (each
    row its 2,880 patches, then text; the patch positions carry no loss),
    exact launches of the flash forward (2 L a step) and backward (L), a
    falling loss on a repeated batch, and the f32 witness cells (see
    ``_train_cells``)."""
    return _train_cells(dev, kept, ["llava"])


def phase_train_jamba(dev, kept: dict) -> dict:
    """jamba-1.5-large training at TRAIN_MR_CHANGES' cut (one unit of 8
    layers) through ``Trainer`` at 1 PE and ep 8: exact launches of the
    flash forward and backward (its one attention layer) and of the
    reorder (6 a MoE layer and step at ep 8), a falling loss on a repeated
    batch, and the f32 witness cells with the flash and reorder controls
    (see ``_train_cells``)."""
    return _train_cells(dev, kept, ["jamba"])


# -------------------------------------------------------------- checkpoint
# qwen3-1.7b at full width and depth through repro_torch.checkpoint: train
# at 1 PE and at tp 8 (TRAIN_LAYOUTS), save after step 2 with steps 3-4
# behind the write, restore and resume; serve from the tp-8 checkpoint at 8
# and 1 PEs; an HF safetensors round trip. The directory lies in the
# checkout's build/ (ignored by git), keep_last=1, removed at the end.
CKPT_LAYOUTS = ("1pe", "8pe")
# the phase runs qwen3 at 4 of its 28 layers: its gates compare runs on
# the same weights (bit for bit), and a save's, a restore's and the
# engine's seconds go by the bytes; at 28 layers it took 184 s of the
# run's 1,200 s limit, at 14 (6.2 GB a checkpoint) 118 s
CKPT_LAYERS = 4
CKPT_SAVE_AT, CKPT_STEPS = 2, 4         # saves after steps 1 and 2
CKPT_DIR = ROOT / "build" / "checkpoint_phase"
# HF stores a norm as 1 + w: the round trip (w + 1) - 1 rounds once in f32,
# by at most half an ulp of 1 + w (2^-24 for |w| < 1); other leaves are
# bit for bit, as JAX's test_hf_roundtrip_qwen3 holds them
CKPT_NORMS = ("ln", "fln", "q_norm", "k_norm", "final_norm")
CKPT_NORM_TOL = 2.0 ** -24


def _ckpt_counted(fn):
    """``fn()`` with the flash forward, backward and reorder counts set to
    0 just before it and read just after: (result, launches)."""
    from repro_torch.kernels.attention import flash, flash_bwd
    from repro_torch.kernels.reorder import reorder
    flash.LAUNCHES = flash_bwd.LAUNCHES = reorder.LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {"flash": flash.LAUNCHES, "flash_bwd": flash_bwd.LAUNCHES,
                 "reorder": reorder.LAUNCHES}


def _add(total: dict, part: dict) -> None:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def _clone_tree(tree):
    from repro_torch.checkpoint import layout
    flat = list(layout.flatten(tree))
    return layout.tree_from_paths([p for p, _ in flat],
                                  [t.clone() for _, t in flat])


def _tree_cmp(got, want) -> dict:
    """Leaf by leaf: bit-identical, the largest |got - want|, and the leaves
    that differ."""
    from repro_torch.checkpoint import layout
    differ, worst = [], 0.0
    for (path, g), (_, w) in zip(layout.flatten(got), layout.flatten(want)):
        if g.shape != w.shape or not torch.equal(g, w):
            differ.append("/".join(path))
            if g.shape == w.shape:
                worst = max(worst, float((g.double() - w.double())
                                         .abs().max()))
            else:
                worst = math.inf
    return {"equal": not differ, "max_abs_diff": worst,
            "differing": differ[:8], "n_differing": len(differ)}


def _ckpt_disk(root: Path, n_bytes: int) -> dict:
    """Free bytes where the checkpoints go and the host's RAM, printed
    before the first save; whether two checkpoints fit."""
    root.mkdir(parents=True, exist_ok=True)
    usage = shutil.disk_usage(root)
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":")
            mem[k] = int(v.split()[0]) * 1024
    out = {"dir": str(root.relative_to(ROOT)), "free_bytes": usage.free,
           "host_ram_bytes": mem["MemTotal"],
           "host_ram_available_bytes": mem["MemAvailable"],
           "checkpoint_bytes_est": n_bytes,
           "two_checkpoints_fit": usage.free >= 2 * n_bytes}
    print(f"checkpoint: {json.dumps(out)}", flush=True)
    return out


def _ckpt_cell(dev, layout_: str, root: Path) -> tuple[dict, dict]:
    """One layout: steps 1-2 saving after each (async, topology-bound,
    keep_last=1; the first save lowers the gather programs, the second is
    served from the lower cache and is the one measured, past the host's
    first-write costs), steps 3-4 behind the second write (the
    uninterrupted run); two control runs of steps 3-4 from one in-memory
    clone of the step-2 state, each bit for bit the uninterrupted run (the
    step is deterministic); restore of step 2 against that clone, bit for
    bit; steps 3-4 resumed from the restored state, bit for bit the
    uninterrupted run. Returns the summary and the step-2 masters as
    global tensors."""
    from repro_torch import telemetry
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import program
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models.params import param_specs, to_global
    from repro_torch.runtime.trainer import (
        Trainer, TrainConfig, opt_specs, place_batch, resume_state)
    tc = TrainConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=100)
    cfg, topo, masters, opt = _train_setup(dev, layout_, tc,
                                           n_layers=CKPT_LAYERS)
    L = cfg.n_layers
    stream = TokenStream(cfg, DataConfig(seq_len=TRAIN_SEQ,
                                         global_batch=TRAIN_BATCH,
                                         vocab_size=cfg.vocab_size))
    batches = [place_batch(stream.global_batch_at(s), cfg, topo, dev)
               for s in range(CKPT_STEPS)]
    early, late = batches[:CKPT_SAVE_AT], batches[CKPT_SAVE_AT:]
    mgr = CheckpointManager(str(root), topo=topo, keep_last=1, device=dev,
                            specs={"params": param_specs(cfg, topo),
                                   "opt": opt_specs(cfg, topo, tc)})
    saves = []
    save = mgr.save

    def counted_save(*a, **kw):
        low = dict(program.LOWER_STATS)
        t0 = time.perf_counter()
        save(*a, **kw)
        saves.append({"block_s": time.perf_counter() - t0,
                      "lowered": program.LOWER_STATS["lowered"]
                      - low["lowered"],
                      "cache_hits": program.LOWER_STATS["cache_hits"]
                      - low["cache_hits"]})

    mgr.save = counted_save
    program.clear_lower_cache()
    launches: dict = {}
    out = {"layout": layout_, "cube": topo.cube.describe(), "layers": L}

    def run(m, o, bs, start, every=0, ckpt=None, tr=None):
        tr = tr or Trainer(cfg, topo, tc, checkpointer=ckpt)
        (m, o, h), n = _ckpt_counted(lambda: tr.run(
            m, o, bs, start_step=start, checkpoint_every=every,
            log_every=0))
        _add(launches, n)
        ok = n["flash"] == 2 * L * len(bs) and n["flash_bwd"] == L * len(bs)
        return m, o, [x["loss"] for x in h], tr.step_seconds[-len(bs):], ok

    # 1. train saving after steps 1 and 2, steps 3-4 behind the second
    # write (one trainer: its loop goes on after a save as the launcher's)
    with telemetry.Tracer() as trc, telemetry.scoped_metrics() as reg:
        trainer = Trainer(cfg, topo, tc, checkpointer=mgr)
        masters, opt, losses, _, ok1 = run(masters, opt, early, 0, 1,
                                           tr=trainer)
        snap = _clone_tree({"params": masters, "opt": opt})
        masters, opt, ref_losses, behind_s, ok2 = run(
            masters, opt, late, CKPT_SAVE_AT, tr=trainer)
        mgr.wait()
    ev = trc.finished()
    durable = [sp.ts for sp in ev if sp.name == "checkpoint-durable"]
    gathers = [sp for sp in ev if sp.name.startswith("checkpoint:gather:")]
    steps = [sp for sp in ev if sp.name == "train-step"]
    g2 = gathers[2:]                    # the measured save's two sections
    out["save"] = {
        "save_block_s": [sv["block_s"] for sv in saves],
        "gather_s": [sum(g.dur for g in gathers[i:i + 2]) / 1e6
                     for i in (0, 2)],
        "durable_after_s": (durable[-1] - g2[0].ts) / 1e6,
        "write_after_save_s": (durable[-1] - g2[-1].ts - g2[-1].dur) / 1e6,
        "behind_write_step_ms": [t * 1e3 for t in behind_s],
        "step_span_ms": [sp.dur / 1e3 for sp in steps],
        "behind_write_steps_end_before_durable": len(durable) == 2 and all(
            sp.ts + sp.dur < durable[-1] for sp in steps[CKPT_SAVE_AT:]),
        "saved_bytes": reg.value("ckpt.saved_bytes"),
        "save_seconds": reg.quantile("ckpt.save_seconds", 1.0),
        "lowered": [sv["lowered"] for sv in saves],
        "cache_hits": [sv["cache_hits"] for sv in saves],
        "steps_on_disk": mgr.all_steps(), "losses": losses + ref_losses}
    ref = {"params": masters, "opt": opt}

    # 2. the control: steps 3-4 twice from one clone of the step-2 state
    controls = []
    for _ in range(2):
        c = _clone_tree(snap)
        m, o, closs, cs, okc = run(c["params"], c["opt"], late, CKPT_SAVE_AT)
        controls.append({"losses": closs, "step_ms": [t * 1e3 for t in cs],
                         "vs_uninterrupted": _tree_cmp(
                             {"params": m, "opt": o}, ref), "ok": okc})
        del c, m, o
    deterministic = all(c["vs_uninterrupted"]["equal"]
                        and c["losses"] == ref_losses for c in controls)
    out["control"] = {"deterministic": deterministic, "runs": controls}
    if not deterministic:
        # which gradients differ between two backwards of one state
        step = Trainer(cfg, topo, tc).step_fn
        c = _clone_tree(snap)
        l1, _, g1 = step.fwd_bwd(c["params"], late[0], overlap=step.overlap)
        l2, _, g2 = step.fwd_bwd(c["params"], late[0], overlap=step.overlap)
        out["control"]["repeat_backward"] = {
            "loss_equal": bool(torch.equal(l1, l2)),
            "grads": _tree_cmp(g1, g2)}
        del c, g1, g2

    # 3. restore step 2 onto the same topology, bit for bit
    torch.cuda.synchronize()
    with telemetry.scoped_metrics() as reg:
        t0 = time.perf_counter()
        st = mgr.restore(CKPT_SAVE_AT)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    rm, ro = resume_state(st, cfg, topo, tc)
    del st
    out["restore"] = {"restore_s": restore_s,
                      "restored_bytes": reg.value("ckpt.restored_bytes"),
                      "vs_saved": _tree_cmp({"params": rm, "opt": ro},
                                            snap)}
    glob = to_global(snap["params"], param_specs(cfg, topo), topo.cube)
    del snap
    # 4. resume steps 3-4
    rm, ro, res_losses, res_s, ok3 = run(rm, ro, late, CKPT_SAVE_AT)
    vs = _tree_cmp({"params": rm, "opt": ro}, ref)
    loss_diff = max(abs(a - b) for a, b in zip(res_losses, ref_losses))
    out["resume"] = {
        "losses": res_losses, "uninterrupted_losses": ref_losses,
        "max_loss_diff": loss_diff, "vs_uninterrupted": vs,
        "step_ms": [t * 1e3 for t in res_s]}
    out["launches"] = launches
    gates = {
        "deterministic": deterministic,
        "resume_bit_for_bit": bool(vs["equal"]
                                   and res_losses == ref_losses),
        "launches": bool(ok1 and ok2 and ok3
                         and all(c["ok"] for c in controls)),
        "steps_behind_write":
            out["save"]["behind_write_steps_end_before_durable"],
        "lowered_once": (out["save"]["lowered"] == [2, 0]
                         and out["save"]["cache_hits"] == [0, 2]),
        "keep_last": out["save"]["steps_on_disk"] == [CKPT_SAVE_AT],
        "restore_bit_for_bit": out["restore"]["vs_saved"]["equal"],
        "finite": bool(np.all(np.isfinite(out["save"]["losses"]
                                          + res_losses)))}
    out["failed_gates"] = [k for k, v in gates.items() if not v]
    out["ok"] = not out["failed_gates"]
    del masters, opt, ref, rm, ro, batches, early, late
    gc.collect()
    torch.cuda.empty_cache()
    return out, glob


def _ckpt_serve(dev, root: Path, glob: dict, pes: int) -> dict:
    """Restore the tp-8 checkpoint's params onto the serve cube at ``pes``
    PEs: every leaf against ``to_cube`` of the saved global arrays, bit for
    bit; the ``ckpt-restore-params`` program in the trace; restore's and
    direct init's peak memory; the engine's lockstep tokens from the
    restored weights and from the globals placed directly; at 8 PEs one
    prefill of the prompts against the loop's logits (``_prefill_vs_loop``).
    """
    from repro_torch import configs, telemetry
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.comm import CommTrace
    from repro_torch.models.params import (
        flat_leaves, init_params, param_specs, tree_map)
    from repro_torch.models.serving import make_serve_plan
    from repro_torch.models.topology import build_serve_topology
    from repro_torch.serving import Request, ServeEngine
    cfg = dataclasses.replace(configs.get(ARCH), n_layers=CKPT_LAYERS)
    topo = build_serve_topology(cfg, pes)
    specs = param_specs(cfg, topo)
    mgr = CheckpointManager(str(root), device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with CommTrace() as ct, telemetry.scoped_metrics() as reg:
        t0 = time.perf_counter()
        restored = mgr.restore_params(mgr.latest_step(), serve_topo=topo,
                                      specs=specs)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    peak_restore = torch.cuda.max_memory_allocated(dev) - base
    held = tree_map(lambda g, s: topo.cube.to_cube(g, s), glob, specs)
    same = _tree_cmp(restored, held)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    init_params(cfg, topo, 0, device=dev)
    torch.cuda.synchronize()
    peak_init = torch.cuda.max_memory_allocated(dev) - base
    gc.collect()
    torch.cuda.empty_cache()

    plan = make_serve_plan(cfg, topo, S_ctx=PROMPT + GEN, global_batch=BATCH)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                               (BATCH, PROMPT))
    lock = [Request(rid=b, prompt=prompts[b].tolist(), max_new=GEN)
            for b in range(BATCH)]
    engines, launches = {}, {}
    for name, params in (("restored", restored), ("direct", held)):
        m, n = _ckpt_counted(lambda: _engine_run(
            lambda **kw: ServeEngine(cfg, topo, plan, params,
                                     page_size=ENGINE_PAGE, device=dev,
                                     **kw), lock, dev=dev))
        _add(launches, n)
        engines[name] = {"tokens": m["tokens"], "steps": m["steps"],
                         "flash_launches": n["flash"],
                         "launches_ok": n["flash"]
                         == cfg.n_layers * m["steps"],
                         "complete": _engine_summary(
                             m, cfg.n_layers, cfg.vocab_size, lock)
                         ["complete"]}
    out = {"pes": pes, "cube": topo.cube.describe(),
           "restore_s": restore_s,
           "restored_bytes": reg.value("ckpt.restored_bytes"),
           "programs": sorted({str(e.program_id) for e in ct.events}),
           "leaves": len(flat_leaves(restored)),
           "vs_saved_global_placed": same,
           "peak_mem_gb_restore": peak_restore / 2**30,
           "peak_mem_gb_direct_init": peak_init / 2**30,
           "engine": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                      for k, v in engines.items()},
           "engine_tokens_equal": engines["restored"]["tokens"]
           == engines["direct"]["tokens"]}
    ok = (same["equal"] and "ckpt-restore-params" in out["programs"]
          and out["engine_tokens_equal"]
          and all(e["launches_ok"] and e["complete"]
                  for e in engines.values()))
    del held
    if pes == PES[-1]:
        s, _ = _prefill_vs_loop(dev, pes, torch.bfloat16, params=restored,
                                n_layers=CKPT_LAYERS)
        out["prefill"] = s
        _add(launches, {"flash": s["flash_launches"]
                        + s["flash_launches_decode"],
                        "reorder": s["reorder_launches"]})
        ok = ok and s["ok"]
    out["launches"] = launches
    out["ok"] = bool(ok)
    del restored
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ckpt_hf(dev, root: Path, glob: dict) -> dict:
    """The trained masters through ``export_state_dict`` into an F32
    ``model.safetensors``, read back, and imported onto the 8-PE serve cube
    through ``import_checkpoint`` (the ``hf-import`` program): bit for bit
    but the norms, within CKPT_NORM_TOL. The file is removed."""
    from repro_torch import configs
    from repro_torch.checkpoint import hf_import
    from repro_torch.core.comm import CommTrace
    from repro_torch.models.params import leaves, param_specs
    from repro_torch.models.topology import build_serve_topology
    cfg = dataclasses.replace(configs.get(ARCH), n_layers=CKPT_LAYERS)
    topo = build_serve_topology(cfg, PES[-1])
    specs = param_specs(cfg, topo)
    path = root / "model.safetensors"
    t0 = time.perf_counter()
    sd = hf_import.export_state_dict(glob, cfg)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hf_import.write_safetensors(str(path), sd)
    write_s = time.perf_counter() - t0
    del sd
    file_bytes = path.stat().st_size
    t0 = time.perf_counter()
    back = hf_import.read_state_dict(str(path))
    read_s = time.perf_counter() - t0
    keys = len(back)
    del back
    with CommTrace() as ct:
        t0 = time.perf_counter()
        imported = hf_import.import_checkpoint(str(path), cfg, topo,
                                               specs=specs, device=dev)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
    path.unlink()
    worst_norm, differ = 0.0, []
    for (p, got), (_, g), (_, s) in zip(leaves(imported), leaves(glob),
                                        leaves(specs)):
        want = topo.cube.to_cube(g, s)
        if p[-1] in CKPT_NORMS:
            worst_norm = max(worst_norm, float((got - want).abs().max()))
        elif not torch.equal(got, want):
            differ.append("/".join(p))
    del imported
    torch.cuda.empty_cache()
    out = {"keys": keys, "file_bytes": file_bytes, "export_s": export_s,
           "write_s": write_s, "read_s": read_s,
           "import_checkpoint_s": import_s,
           "programs": sorted({str(e.program_id) for e in ct.events}),
           "non_norm_leaves_differing": differ,
           "norm_max_abs_err": worst_norm, "norm_bound": CKPT_NORM_TOL}
    out["ok"] = (not differ and worst_norm <= CKPT_NORM_TOL
                 and out["programs"] == ["hf-import"])
    return out


def phase_checkpoint(dev) -> dict:
    """Elastic checkpointing of full-width qwen3-1.7b (``_ckpt_cell`` at 1
    PE and tp 8, ``_ckpt_serve`` from the tp-8 checkpoint at 8 and 1 PEs,
    ``_ckpt_hf``); the kernels' launches are counted from 0 just before
    each run and read just after. The checkpoint directory is removed."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get(ARCH), n_layers=CKPT_LAYERS)
    n = cfg.param_count()
    disk = _ckpt_disk(CKPT_DIR, 6 * n)      # f32 masters, two int8 moments
    if not disk["two_checkpoints_fit"]:
        return {"ok": False, "disk": disk,
                "error": "two checkpoints do not fit where they go"}
    out: dict = {"arch": ARCH, "params": n, "batch": [TRAIN_BATCH, TRAIN_SEQ],
                 "cut": f"{CKPT_LAYERS} of {_full_depth(ARCH)} layers",
                 "disk": disk, "cells": {}, "serve": {}}
    launches: dict = {}
    glob = None
    try:
        for name in CKPT_LAYOUTS:
            cell, glob = _ckpt_cell(dev, name, CKPT_DIR / name)
            out["cells"][name] = cell
            _add(launches, cell["launches"])
            if name != CKPT_LAYOUTS[-1]:
                shutil.rmtree(CKPT_DIR / name)
                glob = None
        for pes in PES[::-1]:
            s = out["serve"][f"{pes}pe"] = _ckpt_serve(
                dev, CKPT_DIR / CKPT_LAYOUTS[-1], glob, pes)
            _add(launches, s["launches"])
        out["hf"] = _ckpt_hf(dev, CKPT_DIR, glob)
    finally:
        glob = None
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["ok"] = (all(c["ok"] for c in out["cells"].values())
                 and all(s["ok"] for s in out["serve"].values())
                 and out["hf"]["ok"])
    out["flash_launches"] = launches.get("flash", 0)
    out["flash_bwd_launches"] = launches.get("flash_bwd", 0)
    out["reorder_launches"] = launches.get("reorder", 0)
    return out


def _rwkv6_bound(r, k, v, logw, u, state, states: bool = False) -> dict:
    """Least time the card could take: each input byte read once (r, k, v,
    u in their dtype, logw and an incoming state in f32), each output byte
    written once (o, the f32 final state, and with ``states`` the f32
    state at each 64-step chunk's start, which that call returns),
    over HBM rate; per chunk of the reference's rule and per (batch, head)
    2 * (2 C K V + C^2 K + C^2 V) FLOPs, over the peak for the inputs'
    type. The larger of the two."""
    from repro_torch.kernels.rwkv6 import ref
    B, S, H, K = r.shape
    V = v.shape[-1]
    es = r.element_size()
    state_bytes = 4 * B * H * K * V
    read = (es * (r.numel() + k.numel() + v.numel() + u.numel())
            + 4 * logw.numel() + (0 if state is None else state_bytes))
    write = es * B * S * H * V + state_bytes
    if states:
        write += state_bytes * -(-S // ref.SAVE)
    C = ref.chunk_len(S)
    flops = B * H * (S // C) * 2 * (2 * C * K * V + C * C * K + C * C * V)
    t_bytes = (read + write) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[r.dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": read + write, "flops": flops}


def _rwkv6_main_path(kept: dict) -> list:
    """The RWKV6 kernel on the inputs of its last launch on each path of
    the serve_rwkv phase (forward and prefill at 1 and 8 PEs: layer 32):
    held against the plain version, then timed."""
    from repro_torch.kernels.rwkv6 import ref, rwkv6
    out = []
    for name in sorted(kept):
        x = kept[name]
        got = rwkv6.rwkv6_chunked(*x)
        want = ref.rwkv6_chunked(*x)
        torch.cuda.synchronize()
        err = _rwkv6_compare(got, want)
        abs_err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
        out.append({
            "name": name, "dtype": str(x[0].dtype).split(".")[-1],
            "r": list(x[0].shape), "u": list(x[4].shape),
            "state_in": x[5] is not None, "max_abs_err": abs_err,
            "err": err, "ok": err <= RWKV6_TOL[x[0].dtype],
            "ms": time_ms(lambda: rwkv6.rwkv6_chunked(*x)),
            "plain_ms": time_ms(lambda: ref.rwkv6_chunked(*x)),
            "library_ms": None, **_rwkv6_bound(*x)})
    return out


def _rwkv6_states_main_path(kept: dict) -> list:
    """The RWKV6 forward kernel asked for the states saved every 64 steps, on
    the inputs of its last such launch in each bf16 cell of
    ``train_moe_rwkv`` (1 PE and tp 8, one u per PE): o and the final
    state held against the plain version within RWKV6_TOL, the states
    against ``ref.chunk_states`` within RWKV6_STATES_TOL, each x max(1,
    max|plain|); then timed with the plain pair and the bound, which
    counts the states it writes."""
    from repro_torch.kernels.rwkv6 import ref, rwkv6
    out = []
    for name in sorted(kept):
        x = kept[name]
        o, s, st = rwkv6.rwkv6_chunked(*x, states=True)

        def plain():
            o, s = ref.rwkv6_chunked(*x)
            return o, s, ref.chunk_states(x[1], x[2], x[3], x[5])
        want = plain()
        torch.cuda.synchronize()
        err = _rwkv6_compare((o, s), want[:2])
        states_err = _rwkv6_compare((st,), want[2:])
        abs_err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip((o, s, st), want))
        del o, s, st, want
        out.append({
            "name": name, "dtype": str(x[0].dtype).split(".")[-1],
            "r": list(x[0].shape), "u": list(x[4].shape),
            "state_in": x[5] is not None, "states": True,
            "max_abs_err": abs_err, "err": err, "states_err": states_err,
            "ok": (err <= RWKV6_TOL[x[0].dtype]
                   and states_err <= RWKV6_STATES_TOL),
            "ms": time_ms(lambda: rwkv6.rwkv6_chunked(*x, states=True),
                          reps=4),
            "ms_without_states": time_ms(lambda: rwkv6.rwkv6_chunked(*x),
                                         reps=4),
            "plain_ms": time_ms(plain, reps=2, iters=5),
            "library_ms": None, **_rwkv6_bound(*x, states=True)})
    return out


def _reorder_main_path(kept: dict, name: str, redraw: bool = False) -> dict:
    """The reorder kernel on the inputs kept under ``name``: the 8-PE MoE
    decode path's last launch (the combine all_to_all of layer 24 at step
    47), or DLRM's AA(xyz) under pidcomm (the apps phase). ``redraw``
    keeps the launch's permutation and shape but fills x with a random
    draw: DLRM's lookup is the same on every PE, so its blocks repeat and
    a block sent to the wrong PE could still compare equal."""
    from repro_torch.kernels.reorder import ref, reorder
    x, perm = kept[name]
    if redraw:
        gen = torch.Generator(device=x.device).manual_seed(0)
        x = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)
    got = reorder.tile_swizzle(x, perm)
    g = reorder.LAST_PLAN
    want = ref.tile_swizzle(x, perm)
    torch.cuda.synchronize()
    G = perm.numel()
    nbytes = 2 * x.numel() * x.element_size() + perm.numel() * 4
    block_bytes = x.numel() * x.element_size() // G
    ms = time_ms(lambda: reorder.tile_swizzle(x, perm))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {"name": name,
            "dtype": str(x.dtype).split(".")[-1],
            "x": list(x.shape), "blocks": G, "block_bytes": block_bytes,
            "width": g.width, "grid": g.grid,
            "exact": bool(torch.equal(_bits(got), _bits(want))),
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": ms,
            "plain_ms": time_ms(lambda: ref.tile_swizzle(x, perm)),
            "library_ms": time_ms(
                lambda: torch.index_select(x.view(G, -1), 0, perm)),
            "bound_ms": bound, "bound_by": "bytes", "share_of_bound":
            bound / ms, "bytes": nbytes, "fits_l2": nbytes <= L2_BYTES}


def _rwkv6_bwd_main_path(name: str, args: tuple) -> dict:
    """The RWKV6 backward kernel on a training step's last launch, against
    the plain version on the same inputs (the forward kernel's saved
    states): each output within RWKV6_TOL of its own max|plain| (no floor
    at 1: a training step's gradients lie far below 1), on the step's own
    ``do`` and again on a unit-scale ``do`` drawn from randn. Then timed
    with the plain version, the bound and each pass's device ms; no single
    PyTorch call computes it (``library_ms`` None)."""
    from repro_torch.kernels.rwkv6 import ref, rwkv6_bwd
    r, k, v, logw, u, state, do, dstate, states = args
    gen = torch.Generator(device=r.device)
    gen.manual_seed(3)
    unit = torch.randn(do.shape, generator=gen, device=r.device).to(do.dtype)
    held, abs_err = {}, 0.0
    for label, d in (("step_do", do), ("unit_do", unit)):
        a = (r, k, v, logw, u, state, d, dstate, states)
        got = rwkv6_bwd.rwkv6_chunked_backward(*a)
        want = ref.rwkv6_chunked_backward(*a)
        torch.cuda.synchronize()
        pairs = [(g, w) for g, w in zip(got, want) if w is not None]
        errs, peaks = _rel_to_peak([g for g, _ in pairs],
                                   [w for _, w in pairs])
        names = [n for n, w in zip(RWKV6_BWD_NAMES, want) if w is not None]
        held[label] = {"err": dict(zip(names, errs)),
                       "max_abs_plain": dict(zip(names, peaks))}
        abs_err = max([abs_err] + [float((g.float() - w.float()).abs().max())
                                   for g, w in pairs])
        del got, want, pairs
    del unit
    rel = max(e for h in held.values() for e in h["err"].values())
    return {"name": name, "dtype": str(r.dtype).split(".")[-1],
            "r": list(r.shape), "u": list(u.shape),
            "states": list(states.shape), "max_abs_err": abs_err,
            "err": rel, "held": held, "ok": rel <= RWKV6_TOL[r.dtype],
            "ms": time_ms(lambda: rwkv6_bwd.rwkv6_chunked_backward(*args)),
            "pass_ms": _rwkv6_bwd_pass_ms(args),
            "plain_ms": time_ms(lambda: ref.rwkv6_chunked_backward(*args),
                                reps=2, iters=5),
            "library_ms": None, **_rwkv6_bwd_bound(*args)}


PLAIN_BIG = 5e8     # (batch x query x head x key) scores of a plain call
# the plain version's timing: a yardstick, not a gate; fewer calls than the
# kernel's 20 x 10 keep main_path's time down
PLAIN_REPS = {"reps": 5, "iters": 4}
PLAIN_REPS_BIG = {"reps": 2, "iters": 5}


# ------------------------------------------------------------------- lowp
# qwen3-1.7b at full width and the train cell's depth on 1 PE under the
# low-precision modes: train steps per mode, and the serving forward and
# prefill of a LOWP_PROMPT-token prompt at mode 2
LOWP_STEPS, LOWP_PROMPT = 4, 512


def _lowp_train(dev, mode: int, cfg, topo, masters, opt, stream) -> dict:
    """LOWP_STEPS train steps at ``mode``: finite losses, and per step 2L
    forward launches (the forward and the remat's recompute), every one
    in the mode, and L backward launches."""
    from repro_torch.kernels.attention import flash, flash_bwd
    from repro_torch.models import layers
    from repro_torch.runtime.trainer import Trainer, TrainConfig, place_batch
    tc = TrainConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=100)
    trainer = Trainer(cfg, topo, tc)
    L = cfg.n_layers
    steps, hist = [], []
    layers.LOWP = mode
    try:
        for s in range(LOWP_STEPS):
            batch = place_batch(stream.global_batch_at(s), cfg, topo, dev)
            f0, b0 = flash.LAUNCHES, flash_bwd.LAUNCHES
            m0 = flash.LOWP_LAUNCHES[mode]
            masters, opt, h = trainer.run(masters, opt, [batch],
                                          log_every=0)
            hist += h
            steps.append({"forward": flash.LAUNCHES - f0,
                          "in_mode": flash.LOWP_LAUNCHES[mode] - m0,
                          "backward": flash_bwd.LAUNCHES - b0})
    finally:
        layers.LOWP = 0
    ok = (all(st["forward"] == st["in_mode"] == 2 * L
              and st["backward"] == L for st in steps)
          and all(np.isfinite(h["loss"]) for h in hist))
    return {"ok": ok, "mode": mode, "losses": [h["loss"] for h in hist],
            "per_step": steps,
            "ms_per_step": float(np.median([t * 1e3 for t in
                                            trainer.step_seconds[1:]])),
            "launches": sum(st["in_mode"] for st in steps),
            "masters": masters, "opt": opt}


def _lowp_serve(dev, cfg) -> dict:
    """At mode 2 on 1 PE: ``forward_logits`` of a LOWP_PROMPT-token prompt
    and ``prefill_shard`` of it (last logits, the cache's K and V), each on
    the kernel and on its plain version in the same mode (``plain_flash``,
    the witness), within SERVE_TOL of max(1, max|witness|); each launches
    the kernel once a layer, in the mode."""
    from repro_torch.kernels.attention import flash
    from repro_torch.models import layers
    from repro_torch.models.lm import Model
    from repro_torch.models.params import init_params
    from repro_torch.models.serving import Server, make_serve_plan
    from repro_torch.models.topology import build_serve_topology
    topo = build_serve_topology(cfg, 1)
    cube = topo.cube
    params = init_params(cfg, topo, 1, device=dev)
    plan = make_serve_plan(cfg, topo, S_ctx=LOWP_PROMPT + GEN,
                           global_batch=BATCH)
    server = Server(cfg, topo, plan)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    tokens = cube.to_cube(torch.randint(0, cfg.vocab_size,
                                        (BATCH, LOWP_PROMPT), generator=gen,
                                        device=dev), (None, None))

    def run():
        f0, m0 = flash.LAUNCHES, flash.LOWP_LAUNCHES[2]
        with torch.no_grad():
            fwd = Model(cfg, topo).forward_logits(params, {"tokens": tokens})
            last, cache = server.prefill_shard(params, {"tokens": tokens})
        torch.cuda.synchronize(dev)
        return (fwd, last, cache["p0"]["k"], cache["p0"]["v"],
                flash.LAUNCHES - f0, flash.LOWP_LAUNCHES[2] - m0)

    layers.LOWP = 2
    try:
        got = run()
        with plain_flash():
            want = run()
    finally:
        layers.LOWP = 0
    errs = {name: float((g.float() - w.float()).abs().max())
            / max(1.0, float(w.float().abs().max()))
            for name, g, w in zip(("forward", "prefill_last", "cache_k",
                                   "cache_v"), got[:4], want[:4])}
    L = cfg.n_layers
    ok = (max(errs.values()) <= SERVE_TOL and got[4] == got[5] == 2 * L
          and want[4] == 0
          and all(bool(torch.isfinite(t).all()) for t in got[:2]))
    return {"ok": ok, "prompt": [BATCH, LOWP_PROMPT], "errs": errs,
            "tol": SERVE_TOL, "launches": got[4], "in_mode": got[5],
            "witness_launches": want[4]}


def phase_lowp(dev) -> dict:
    """qwen3-1.7b at full width and the train cell's 14 layers on 1 PE
    under the low-precision modes (``layers.LOWP``, the reference's
    ``LOWP``): LOWP_STEPS train steps at mode 1 and again at mode 2 (finite
    losses; 2L forward launches a step, all in the mode, and L backward
    launches: the backward keeps its f32 recompute), then the serving
    forward and prefill at mode 2 held to the plain-flash witness in the
    same mode. The mode is back at 0 after the phase, whatever fails."""
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models import layers
    from repro_torch.runtime.trainer import TrainConfig
    torch.cuda.reset_peak_memory_stats(dev)
    tc = TrainConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=100)
    cfg, topo, masters, opt = _train_setup(dev, "1pe", tc)
    stream = TokenStream(cfg, DataConfig(seq_len=TRAIN_SEQ,
                                         global_batch=TRAIN_BATCH,
                                         vocab_size=cfg.vocab_size))
    train = {}
    for mode in (1, 2):
        res = _lowp_train(dev, mode, cfg, topo, masters, opt, stream)
        masters, opt = res.pop("masters"), res.pop("opt")
        train[f"lowp{mode}"] = res
    del masters, opt
    torch.cuda.empty_cache()
    serve = _lowp_serve(dev, cfg)
    torch.cuda.empty_cache()
    return {"ok": (all(r["ok"] for r in train.values()) and serve["ok"]
                   and layers.LOWP == 0),
            "layers": cfg.n_layers, "train": train, "serve": serve,
            "launches": {1: train["lowp1"]["launches"],
                         2: train["lowp2"]["launches"] + serve["launches"]},
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30}


# ----------------------------------------------------------------- dryrun
# the production cells the dryrun phase traces: (shape, multi_pod)
DRYRUN_CELLS = (("train_4k", False), ("prefill_32k", False),
                ("decode_32k", False), ("train_4k", True))


def _dryrun_row(rec: dict) -> dict:
    mem = rec["memory"]
    return {"cube": rec["cube"],
            "argument_gb": mem["argument_size_in_bytes"] / 1e9,
            "temp_gb": mem["temp_size_in_bytes"] / 1e9,
            "tflops": rec["cost"]["flops"] / 1e12,
            "bytes_accessed_gb": rec["cost"]["bytes accessed"] / 1e9,
            "comm_gb": sum(d["result_bytes"]
                           for d in rec["collectives"].values()) / 1e9,
            "trace_s": rec["lower_s"],
            "drift": rec["planner_drift"]["drift"]}


def _held_bytes(tree) -> int:
    from repro_torch.launch.dryrun import _tensors
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _dryrun_vs_card(dev) -> dict:
    """The dry run of the train cell's topology and batch (qwen3 at 14
    layers, 1 PE, TRAIN_BATCH x TRAIN_SEQ) and of the 1-PE qwen3 serve
    cell (BATCH rows, PROMPT + GEN positions): their per-PE argument
    bytes equal the bytes those cells hold on the card (masters, moments
    and step, batch; weights, cache, tokens and positions), exactly. The
    meta peak (arguments and temporaries) is printed beside the card's
    peak of one step above what was allocated before the cell's tensors
    were made (earlier phases keep launch inputs for main_path), ungated:
    on meta the plain attention's score chunks are counted, which the
    kernels never allocate; on the card the libraries' workspaces are."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.launch import dryrun
    from repro_torch.models.params import init_params
    from repro_torch.models.serving import (
        Server, init_cache, make_serve_plan)
    from repro_torch.models.topology import build_serve_topology
    from repro_torch.runtime.trainer import (
        TrainConfig, make_train_step, place_batch)
    out = {}
    tc = TrainConfig()
    base = torch.cuda.memory_allocated(dev)
    cfg, topo, masters, opt = _train_setup(dev, "1pe", tc)
    stream = TokenStream(cfg, DataConfig(seq_len=TRAIN_SEQ,
                                         global_batch=TRAIN_BATCH,
                                         vocab_size=cfg.vocab_size))
    batch = place_batch(stream.global_batch_at(0), cfg, topo, dev)
    rec = dryrun._cell(cfg, dict(kind="train", seq=TRAIN_SEQ,
                                 batch=TRAIN_BATCH), 1)
    held = _held_bytes((masters, opt, batch))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    make_train_step(cfg, topo, tc)(masters, opt, batch)
    torch.cuda.synchronize(dev)
    out["train"] = {
        "argument_bytes": rec["memory"]["argument_size_in_bytes"],
        "card_bytes": held,
        "meta_peak_gb": (rec["memory"]["argument_size_in_bytes"]
                         + rec["memory"]["temp_size_in_bytes"]) / 1e9,
        "card_peak_gb": (torch.cuda.max_memory_allocated(dev) - base) / 1e9}
    del masters, opt, batch
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    cfg = configs.get(ARCH)
    topo = build_serve_topology(cfg, 1)
    plan = make_serve_plan(cfg, topo, S_ctx=PROMPT + GEN, global_batch=BATCH)
    params = init_params(cfg, topo, 0, device=dev)
    cache = init_cache(cfg, topo, plan, device=dev)
    tok, pos = (topo.cube.to_cube(torch.zeros((BATCH,), dtype=torch.int64,
                                              device=dev), (None,))
                for _ in range(2))
    rec = dryrun._cell(cfg, dict(kind="decode", seq=PROMPT + GEN,
                                 batch=BATCH), 1)
    held = _held_bytes((params, cache, tok, pos))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        Server(cfg, topo, plan).decode_shard(params, cache, tok, pos)
    torch.cuda.synchronize(dev)
    out["serve"] = {
        "argument_bytes": rec["memory"]["argument_size_in_bytes"],
        "card_bytes": held,
        "meta_peak_gb": (rec["memory"]["argument_size_in_bytes"]
                         + rec["memory"]["temp_size_in_bytes"]) / 1e9,
        "card_peak_gb": (torch.cuda.max_memory_allocated(dev) - base) / 1e9}
    del params, cache
    torch.cuda.empty_cache()
    out["ok"] = all(r["argument_bytes"] == r["card_bytes"]
                    for r in (out["train"], out["serve"]))
    return out


def phase_dryrun(dev) -> dict:
    """The dry run (``launch.dryrun``, on the meta device: no card needed,
    no byte allocated) of qwen3-1.7b's train_4k, prefill_32k and
    decode_32k cells on the 256-PE cube and train_4k on 512 PEs (per-PE
    argument and temp bytes, flops, collective bytes, trace seconds; no
    drift between the planned and the executed collectives), and the
    train and 1-PE serve cells' argument bytes against the card's."""
    from repro_torch.launch import dryrun
    cells = {}
    for shape, mp in DRYRUN_CELLS:
        rec = dryrun.run_cell(ARCH, shape, multi_pod=mp)
        cells[f"{shape}/{rec['mesh']}"] = _dryrun_row(rec)
    card = _dryrun_vs_card(dev)
    return {"ok": card["ok"] and not any(c["drift"] for c in cells.values()),
            "cells": cells, "vs_card": card}


def phase_main_path(kept: dict, kept_reorder: dict, kept_rwkv6: dict,
                    kept_bwd: dict, kept_rwkv6_train: dict,
                    kept_rwkv6_bwd: dict) -> dict:
    """Each kernel on the inputs of its last launch in each form and run of
    the serve, serve_moe, serve_rwkv, serve_dense, fused_forward, train
    and train_moe_rwkv phases (and the reorder's first launch of a DLRM
    pidcomm call, and the last self and cross K/V reshards of whisper's
    8-PE prefill): held against the plain version, then timed; every
    training layout's rows must be there. For the fused forward's ring
    hop, a partial launch, SDPA is timed on the same mask computing the
    output only (``library_output_only``)."""
    from repro_torch.kernels.attention import flash, ref
    timings = []
    worst_ok = bool(kept)
    for name in sorted(kept):
        q, k, v, q_pos, k_pos, kw = kept[name]
        got = flash.flash_attention(q, k, v, q_pos, k_pos, **kw)
        want = ref.flash_attention(q, k, v, q_pos, k_pos, **kw)
        torch.cuda.synchronize()
        kw = {"partial": False, "stats": False, **kw}
        # a training launch returns (out, m, l): compared as the partials
        partial = kw["partial"] or kw["stats"]
        gots = got if partial else (got,)
        wants = want if partial else (want,)
        abs_err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(gots, wants))
        rel_err = _compare(got, want, partial)
        ms = time_ms(lambda: flash.flash_attention(q, k, v, q_pos, k_pos,
                                                   **kw))
        # the plain version's scores of llava's 3,008-token prefill take
        # 8 GB and tens of ms a call: fewer calls where they pass PLAIN_BIG
        big = q.shape[0] * q.shape[1] * q.shape[2] * k.shape[1] > PLAIN_BIG
        plain_ms = time_ms(lambda: ref.flash_attention(q, k, v, q_pos, k_pos,
                                                       **kw),
                           **(PLAIN_REPS_BIG if big else PLAIN_REPS))
        lib_ms, lib_form = _library_ms(
            time_ms, lambda f: _sdpa(q, k, v, f), q_pos, k_pos,
            kw["causal"], kw["window"])
        b = _bound(q, k, q_pos, k_pos, kw["causal"], kw["window"],
                   kw["partial"], kw["stats"])
        ok = rel_err <= KERNEL_TOL[q.dtype]
        worst_ok &= ok
        timings.append({"name": name, "dtype": str(q.dtype).split(".")[-1],
                        "q": list(q.shape), "kv": list(k.shape), **kw,
                        "max_abs_err": abs_err, "err": rel_err, "ok": ok,
                        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "library_form": lib_form,
                        "library_output_only": kw["partial"], **b})
    reorder = _reorder_main_path(kept_reorder, f"decode/{PES[-1]}pe")
    dlrm = _reorder_main_path(kept_reorder, "dlrm_aa_xyz", redraw=True)
    reshard = _reorder_main_path(kept_reorder,
                                 f"prefill{PREFILL_LONG}/{PES[-1]}pe")
    train_swz = _reorder_main_path(kept_reorder, "train/moe/8pe")
    mixtral_swz = [_reorder_main_path(kept_reorder, name) for name in (
        f"mixtral/decode/{PES[-1]}pe", "train/mixtral/8pe")]
    whisper_swz = [_reorder_main_path(
        kept_reorder, f"{WHISPER_ARCH}/prefill/{WHISPER_PES[-1]}pe/{part}")
        for part in ("self", "cross")]
    # llava's 8-PE prefill K/V reshard, jamba's 8-PE MoE decode all_to_all
    # and its ep-8 train step's last reorder
    new_swz = [_reorder_main_path(kept_reorder, name) for name in (
        f"{LLAVA_ARCH}/{LLAVA_PES[-1]}pe/serve",
        f"{JAMBA_ARCH}/{JAMBA_PES[-1]}pe/serve", "train/jamba/8pe")]
    rwkv = _rwkv6_main_path(kept_rwkv6)
    bwd = [_flash_bwd_main_path(name, *kept_bwd[name])
           for name in sorted(kept_bwd)]
    rwkv_bwd = [_rwkv6_bwd_main_path(name, kept_rwkv6_bwd[name])
                for name in sorted(kept_rwkv6_bwd)]
    rwkv_states = _rwkv6_states_main_path(kept_rwkv6_train)
    # every training layout's rows: flash at qwen3's and at each attention
    # arch's of train_moe_rwkv, RWKV6 at rwkv6's
    flash_lays = list(TRAIN_LAYOUTS) + [
        f"{n}/{lay}" for n in TRAIN_MR_ARCHS if _mr_attention(n)
        for lay in TRAIN_MR_PES]
    rwkv_lays = [f"rwkv/{lay}" for lay in TRAIN_MR_PES]
    missing = [f"train_{p}/{lay}" for p, d, lays in (
        ("forward", kept, flash_lays), ("backward", kept_bwd, flash_lays),
        ("forward", kept_rwkv6_train, rwkv_lays),
        ("backward", kept_rwkv6_bwd, rwkv_lays))
        for lay in lays if f"train_{p}/{lay}" not in d]
    return {"ok": (worst_ok and reorder["exact"] and dlrm["exact"]
                   and reshard["exact"] and train_swz["exact"]
                   and all(r["exact"] for r in mixtral_swz)
                   and all(r["exact"] for r in whisper_swz)
                   and all(r["exact"] for r in new_swz)
                   and all(f"{a}/{p}pe/{form}" in kept
                           for a, ps, forms in (
                               (LLAVA_ARCH, LLAVA_PES, ("prefill", "decode")),
                               (JAMBA_ARCH, JAMBA_PES, ("decode",)))
                           for p in ps for form in forms)
                   and len(rwkv) == 4 and all(t["ok"] for t in rwkv)
                   and f"ring_hop/{FUSED_PES}pe" in kept
                   and not missing
                   and len(bwd) == len(flash_lays)
                   and all(t["ok"] for t in bwd)
                   and len(rwkv_bwd) == len(TRAIN_MR_PES)
                   and all(t["ok"] for t in rwkv_bwd)
                   and len(rwkv_states) == len(TRAIN_MR_PES)
                   and all(t["ok"] for t in rwkv_states)),
            "missing_training_rows": missing,
            "main_path": timings, "reorder": reorder, "reorder_dlrm": dlrm,
            "reorder_prefill": reshard, "reorder_train": train_swz,
            "reorder_mixtral": mixtral_swz, "reorder_whisper": whisper_swz,
            "reorder_llava_jamba": new_swz,
            "rwkv6": rwkv, "rwkv6_train_forward": rwkv_states,
            "flash_backward": bwd, "rwkv6_backward": rwkv_bwd}


def _event_ms(fn, iters: int = 10) -> float:
    """Device time of one ``fn()`` call between CUDA events, without a
    graph (for a call that autograd drives)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 10, attempts: int = 3) -> float:
    """Device time of one ``fn()`` call: the durations of the kernels it
    launches under ``torch.profiler``, summed, without the host's gaps
    between them (for a call that autograd drives, which ``time_ms`` cannot
    capture in a graph). A profile that traced no device event is taken
    again, up to ``attempts`` times: late in a run that has profiled many
    times, one such profile came back empty on the H100."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    raise RuntimeError("the profiler traced no device events")


def _sdpa_backward(q, k, v, do, form: dict):
    """Autograd of one SDPA call on the same mask: the library's backward
    (timed only; the port never calls it)."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **form)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def _rel_to_peak(got, want) -> tuple[list, list]:
    """Per output, |kernel - plain| over max|plain|, with no floor (a
    training step's gradients lie far below 1), and max|plain|."""
    errs, peaks = [], []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        peak = float(w.abs().max())
        err = float((g - w).abs().max())
        errs.append(err / peak if peak > 0 else (0.0 if err == 0
                                                 else math.inf))
        peaks.append(peak)
    return errs, peaks


def _flash_bwd_main_path(name: str, args: tuple, kw: dict) -> dict:
    """The backward kernel on a training step's last launch, against the
    plain version: each of dq, dk and dv within FLASH_BWD_TOL of its own
    max|plain| (no floor at 1), on the step's own ``do`` and again on a
    unit-scale ``do`` drawn from randn. Then timed with the plain version,
    the bound (10 * hd FLOPs per visible (query head, key) pair: the
    scores and dP recomputed, dq, dk, dv; each input and output byte once)
    and autograd of SDPA: between CUDA events (``library_ms``, the host's
    gaps included) and as the sum of its kernels' device time
    (``library_device_ms``)."""
    from repro_torch.kernels.attention import flash_bwd, ref
    q, k, v, o, m, l, do, q_pos, k_pos = args
    gen = torch.Generator(device=q.device)
    gen.manual_seed(3)
    unit = torch.randn(do.shape, generator=gen, device=q.device).to(do.dtype)
    held, abs_err = {}, 0.0
    for label, d in (("step_do", do), ("unit_do", unit)):
        a = (q, k, v, o, m, l, d, q_pos, k_pos)
        got = flash_bwd.flash_attention_backward(*a, **kw)
        want = ref.flash_attention_backward(*a, **kw)
        torch.cuda.synchronize()
        errs, peaks = _rel_to_peak(got, want)
        held[label] = {"err": dict(zip(("dq", "dk", "dv"), errs)),
                       "max_abs_plain": dict(zip(("dq", "dk", "dv"), peaks))}
        abs_err = max([abs_err] + [float((g.float() - w.float()).abs().max())
                                   for g, w in zip(got, want)])
        del got, want
    del unit
    rel = max(e for h in held.values() for e in h["err"].values())
    B, Sq, H, hd = q.shape
    es = q.element_size()
    nbytes = (es * (2 * q.numel() + o.numel() + do.numel()
                    + 4 * k.numel())
              + 4 * (m.numel() + l.numel() + q_pos.numel() + k_pos.numel()))
    visible = int(ref.mask(q_pos, k_pos, kw["causal"], kw["window"]).sum())
    flops = 10 * hd * H * visible
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    lib_ms, lib_form = _library_ms(
        _event_ms, lambda f: _sdpa_backward(q, k, v, do, f), q_pos, k_pos,
        kw["causal"], kw["window"])
    lib_dev_ms, lib_dev_form = _library_ms(
        _device_ms, lambda f: _sdpa_backward(q, k, v, do, f), q_pos, k_pos,
        kw["causal"], kw["window"])
    return {"name": name, "dtype": str(q.dtype).split(".")[-1],
            "q": list(q.shape), "kv": list(k.shape), **kw,
            "max_abs_err": abs_err, "err": rel, "held": held,
            "ok": rel <= FLASH_BWD_TOL[q.dtype],
            "ms": time_ms(lambda: flash_bwd.flash_attention_backward(
                *args, **kw)),
            "plain_ms": time_ms(lambda: ref.flash_attention_backward(
                *args, **kw), reps=2, iters=5),
            "library_ms": lib_ms, "library_form": lib_form,
            "library_device_ms": lib_dev_ms,
            "library_device_form": lib_dev_form,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


# -------------------------------------------------------------------- main
def _group_rows(kern: dict) -> dict:
    """The main path's flash rows of llava (G = 7: 56 / 8 heads) and
    jamba (G = 8: 64 / 8), forward (prefill, training forward), decode
    and backward, with their times, bound and library yardstick."""
    keys = ("q", "kv", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err")
    out = {}
    for g, arch, name in ((7, LLAVA_ARCH, "llava"), (8, JAMBA_ARCH, "jamba")):
        rows = [t for t in kern["main_path"] + kern["flash_backward"]
                if t["name"].startswith((f"{arch}/",
                                         f"train_forward/{name}/",
                                         f"train_backward/{name}/"))]
        out[f"G{g}"] = {t["name"]: {k: t[k] for k in keys} for t in rows}
    return out


def _rwkv6_entry(timings: list, by_path: dict, kernel: dict) -> dict:
    """The RWKV6 kernel's entry of the kernels line: its numbers at the
    1-PE forward; its launches on each path; each kept path input under
    ``shapes``; the timed rows off the main path of the kernel phase."""
    head = next(t for t in timings if t["name"] == "forward/1pe")
    return {
        "name": "rwkv6_chunked", "route": "cuda", "source": RWKV6_SOURCE,
        "replaces": RWKV6_TPU_KERNEL, "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(t["max_abs_err"] for t in timings),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "at": head["name"],
        "shapes": {t["name"]: {k: t[k] for k in (
            "r", "u", "state_in", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "states", "ms_without_states") if k in t}
            for t in timings},
        "off_main_path": kernel["timed"]}


def _flash_bwd_entry(rows: list, by_path: dict) -> dict:
    """The backward kernel's entry of the kernels line: its numbers at the
    1-PE training step; its launches on each path; every kept training
    launch under ``shapes``. The JAX package has no Pallas backward:
    ``replaces`` names the jnp function whose autodiff its train step
    takes."""
    head = next(t for t in rows if t["name"] == "train_backward/1pe")
    return {
        "name": "flash_attention_backward", "route": "cuda",
        "source": FLASH_BWD_SOURCE, "replaces": FLASH_BWD_REPLACES,
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(t["max_abs_err"] for t in rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "at": head["name"],
        "shapes": {t["name"]: {k: t[k] for k in (
            "q", "kv", "ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms", "bound_by", "max_abs_err")} for t in rows}}


def _rwkv6_bwd_entry(rows: list, launches: int, kernel: dict) -> dict:
    """The RWKV6 backward kernel's entry of the kernels line: its numbers
    at the 1-PE training step; every kept training launch under
    ``shapes``; the kernel phase's timed training shape. The JAX package
    has no Pallas backward: ``replaces`` names the jnp function whose
    autodiff its train step takes."""
    head = next(t for t in rows if t["name"] == "train_backward/rwkv/1pe")
    return {
        "name": "rwkv6_backward", "route": "cuda",
        "source": RWKV6_BWD_SOURCE, "replaces": RWKV6_BWD_REPLACES,
        "launches": launches,
        "launches_by_path": {f"{RWKV_ARCH}/train": launches},
        "max_abs_err": max(t["max_abs_err"] for t in rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "at": head["name"],
        "shapes": {t["name"]: {k: t[k] for k in (
            "r", "u", "states", "ms", "pass_ms", "plain_ms", "bound_ms",
            "bound_by", "saved_states_bytes", "saved_states_read_ms",
            "design_bytes", "design_ms", "max_abs_err")} for t in rows},
        "off_main_path": kernel["timed"]}


def _why(res, path: str = "") -> list:
    """Where a failed phase's result says it failed: its ``error``, each
    nested ``"ok": false`` and each ``failed_gates`` list, by path."""
    out = []
    if isinstance(res, dict):
        for k, v in res.items():
            p = f"{path}/{k}" if path else str(k)
            if k == "error":
                out.append(f"{p}: {v}")
            elif k == "ok" and v is False and path:
                out.append(p)
            elif k == "failed_gates" and v:
                out.append(f"{p}: {v}")
            else:
                out += _why(v, p)
    elif isinstance(res, list):
        for i, v in enumerate(res):
            out += _why(v, f"{path}[{i}]")
    return out


def _lowp_entry(mode: int, kernel: dict, lowp: dict) -> dict:
    """The kernels line's entry of the flash kernel's bf16 forms in
    low-precision mode ``mode``: launches from the lowp phase's train steps
    (and at mode 2 its forward and prefill), the error over the kernel
    phase's mode-``mode`` checks and its row-statistics means beside their
    controls, the times of the LOWP_ROWS row in the mode that fares worst
    against SDPA."""
    rows = [r for r in kernel["lowp_rows"] if r["mode"] == mode]
    head = max(rows, key=lambda r: r["ms"] / r["library_ms"])
    return {
        "name": f"flash_attention_lowp{mode}", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
        "entry": f"flash.flash_attention(..., lowp={mode}) (bf16 forms)",
        "launches": lowp["launches"][mode],
        "launches_by_path": {f"{ARCH}/lowp/train": lowp["train"][
            f"lowp{mode}"]["launches"],
            **({f"{ARCH}/lowp/serve": lowp["serve"]["launches"]}
               if mode == 2 else {})},
        "max_abs_err": max(c[f"lowp{mode}_err"]
                           for c in kernel["lowp"]["checks"]),
        "row_stats": {form: {k: st[k] for k in ("dev", "control_dev")}
                      for form, st in kernel["lowp"]["row_stats"].items()
                      if form.startswith(f"lowp{mode}/")},
        **({"p_rounding": {k: kernel["lowp"]["p_rounding"][k] for k in (
            "dev", "control_dev")}} if mode == 2 else {}),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "at": head["name"],
        "shapes": {r["name"]: {k: r[k] for k in (
            "q", "kv", "stats", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "err")} for r in kernel["lowp_rows"]},
    }


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import _build  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repository's src/repro_torch is missing "
              f"({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    results, failed, kept, kept_reorder, kept_rwkv6 = {}, [], {}, {}, {}
    kept_bwd, moe_sort, kept_rwkv6_bwd, kept_rwkv6_train = {}, {}, {}, {}
    kept_int8 = {}
    kept_train = {"flash": kept, "flash_bwd": kept_bwd,
                  "reorder": kept_reorder, "rwkv6": kept_rwkv6_train,
                  "rwkv6_bwd": kept_rwkv6_bwd}
    for name, fn in (("build", lambda: phase_build()),
                     ("no_spills", lambda: {
                         "ok": not results["build"]["spilling"],
                         "spilling": results["build"]["spilling"]}),
                     ("kernel", lambda: phase_kernel(dev)),
                     ("comm", lambda: phase_comm(dev)),
                     ("serve", lambda: phase_serve(dev, kept)),
                     ("serve_f32", lambda: phase_serve_f32(dev)),
                     ("serve_moe", lambda: phase_serve_moe(
                         dev, kept, kept_reorder, moe_sort)),
                     ("serve_moe_f32", lambda: phase_serve_moe_f32(dev)),
                     ("serve_rwkv", lambda: phase_serve_rwkv(dev,
                                                             kept_rwkv6)),
                     ("serve_rwkv_f32", lambda: phase_serve_rwkv_f32(dev)),
                     ("serve_mixtral", lambda: phase_serve_mixtral(
                         dev, kept, kept_reorder)),
                     ("serve_dense", lambda: phase_serve_dense(dev, kept)),
                     ("serve_dense_f32", lambda: phase_serve_dense_f32(dev)),
                     ("serve_internlm2", lambda: phase_serve_internlm2(
                         dev, kept)),
                     ("serve_internlm2_f32", lambda: phase_serve_internlm2(
                         dev, None, torch.float32)),
                     ("serve_whisper", lambda: phase_serve_whisper(
                         dev, kept, kept_reorder)),
                     ("serve_llava", lambda: phase_serve_llava(
                         dev, kept, kept_reorder)),
                     ("serve_jamba", lambda: phase_serve_jamba(
                         dev, kept, kept_reorder)),
                     ("serve_int8", lambda: phase_serve_int8(dev,
                                                             kept_int8)),
                     ("serve_resident", lambda: phase_serve_resident(dev)),
                     ("serve_prefill", lambda: phase_serve_prefill(
                         dev, kept, kept_reorder, moe_sort)),
                     ("serve_engine", lambda: phase_serve_engine(dev, kept)),
                     ("apps", lambda: phase_apps(dev, kept_reorder)),
                     ("tune", lambda: phase_tune(dev)),
                     ("fused_forward", lambda: phase_fused_forward(dev,
                                                                   kept)),
                     ("train", lambda: phase_train(dev, kept, kept_bwd)),
                     ("train_moe_rwkv", lambda: phase_train_moe_rwkv(
                         dev, kept_train)),
                     ("train_llava", lambda: phase_train_llava(
                         dev, kept_train)),
                     ("train_jamba", lambda: phase_train_jamba(
                         dev, kept_train)),
                     ("checkpoint", lambda: phase_checkpoint(dev)),
                     ("lowp", lambda: phase_lowp(dev)),
                     ("dryrun", lambda: phase_dryrun(dev)),
                     ("main_path", lambda: phase_main_path(
                         kept, kept_reorder, kept_rwkv6, kept_bwd,
                         kept_rwkv6_train, kept_rwkv6_bwd))):
        needs = {"main_path": ("serve", "serve_moe", "serve_rwkv",
                               "serve_mixtral", "serve_dense",
                               "serve_whisper", "serve_llava",
                               "serve_jamba", "serve_prefill", "apps",
                               "fused_forward", "train", "train_moe_rwkv",
                               "train_llava", "train_jamba", "checkpoint"),
                 "serve_prefill": ("build", "serve_moe"),
                 "checkpoint": ("build", "train")}.get(name, ("build",))
        missing = [n for n in needs if n in failed]
        if name != "build" and missing:
            failed.append(name)
            emit(name, ok=False, error=f"skipped: {missing} failed")
            continue
        t0 = time.perf_counter()
        try:
            res = fn()
            res.setdefault("ok", True)
        except Exception as e:  # noqa: BLE001 -- report every phase
            res = {"ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc(limit=8)}
        res["phase_s"] = round(time.perf_counter() - t0, 3)
        results[name] = res
        emit(name, **res)
        if not res["ok"]:
            failed.append(name)

    print(card_line(), flush=True)
    if failed:
        for name in failed:
            print(f"chip_smoke: {name}: {_why(results.get(name, {}))[:20]}",
                  file=sys.stderr)
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    kern, serve_res = results["main_path"], results["serve"]
    moe_res, rwkv_res = results["serve_moe"], results["serve_rwkv"]
    dense_res = results["serve_dense"]["archs"]
    engine_res = results["serve_engine"]
    fused_res, apps_res = results["fused_forward"], results["apps"]
    train_res, prefill_res = results["train"], results["serve_prefill"]
    tune_res, ckpt_res = results["tune"], results["checkpoint"]
    mr = {a: launches for p in ("train_moe_rwkv", "train_llava",
                                "train_jamba")
          for a, launches in results[p]["launches_by_arch"].items()}
    llava_res, jamba_res = results["serve_llava"], results["serve_jamba"]
    mixtral_res = results["serve_mixtral"]
    internlm2_res, whisper_res = (results["serve_internlm2"],
                                  results["serve_whisper"])
    int8_res, resident_res = results["serve_int8"], results["serve_resident"]
    mr_attn = [TRAIN_MR_ARCHS[n][0] for n in TRAIN_MR_ARCHS
               if _mr_attention(n)]
    # the int8 decode form's headline: its main-path row farthest above
    # its bound
    int8_head = max(int8_res["main_path"],
                    key=lambda t: t["ms"] / t["bound_ms"])
    # the flash headline: the main-path row that fares worst against SDPA
    head = max(kern["main_path"], key=lambda t: t["ms"] / t["library_ms"])
    swz = kern["reorder"]
    reorder_rows = (swz, kern["reorder_dlrm"], kern["reorder_prefill"],
                    kern["reorder_train"], *kern["reorder_mixtral"],
                    *kern["reorder_whisper"], *kern["reorder_llava_jamba"])
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": (serve_res["flash_launches"] + moe_res["flash_launches"]
                     + results["serve_dense"]["flash_launches"]
                     + engine_res["flash_launches"]
                     + fused_res["flash_launches"]
                     + train_res["flash_launches"]
                     + prefill_res["flash_launches"]
                     + ckpt_res["flash_launches"]
                     + mixtral_res["flash_launches"]
                     + internlm2_res["flash_launches"]
                     + whisper_res["flash_launches"]
                     + int8_res["bf16_launches"]
                     + resident_res["flash_launches"]
                     + llava_res["flash_launches"]
                     + jamba_res["flash_launches"]
                     + sum(mr[a]["flash"] for a in mr_attn)),
        "launches_by_path": {ARCH: serve_res["flash_launches"],
                             MOE_ARCH: moe_res["flash_launches"],
                             **{a: dense_res[a]["flash_launches"]
                                for a in DENSE_ARCHS},
                             f"{ARCH}/serve_engine":
                                 engine_res["flash_launches"],
                             f"{ARCH}/fused_forward":
                                 fused_res["flash_launches"],
                             f"{ARCH}/train": train_res["flash_launches"],
                             "serve_prefill": prefill_res["flash_launches"],
                             f"{ARCH}/checkpoint":
                                 ckpt_res["flash_launches"],
                             MIXTRAL_ARCH: mixtral_res["flash_launches"],
                             INTERNLM2_ARCH: internlm2_res["flash_launches"],
                             WHISPER_ARCH: whisper_res["flash_launches"],
                             f"{ARCH}/serve_int8/bf16_cache":
                                 int8_res["bf16_launches"],
                             f"{ARCH}/serve_resident":
                                 resident_res["flash_launches"],
                             LLAVA_ARCH: llava_res["flash_launches"],
                             JAMBA_ARCH: jamba_res["flash_launches"],
                             **{f"{a}/train": mr[a]["flash"]
                                for a in mr_attn}},
        "max_abs_err": max(t["max_abs_err"] for t in kern["main_path"]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "at": head["name"],
        "shapes": {t["name"]: {k: t[k] for k in (
            "q", "kv", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err")} for t in kern["main_path"]},
        "off_main_path": {t["name"]: {k: t[k] for k in (
            "q", "kv", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "err")} for t in results["kernel"]["flash_long_rows"]},
        "group_rows": _group_rows(kern),
    }, {
        "name": "tile_swizzle", "route": "cuda", "source": REORDER_SOURCE,
        "replaces": REORDER_TPU_KERNEL,
        "launches": (moe_res["reorder_launches"]
                     + apps_res["dlrm_reorder_launches"]
                     + prefill_res["reorder_launches"]
                     + tune_res["reorder_launches"]
                     + ckpt_res["reorder_launches"]
                     + mixtral_res["reorder_launches"]
                     + whisper_res["reorder_launches"]
                     + jamba_res["reorder_launches"]
                     + llava_res["reorder_launches"]
                     + mr[MOE_ARCH]["reorder"] + mr[MIXTRAL_ARCH]["reorder"]
                     + mr[JAMBA_ARCH]["reorder"]),
        "launches_by_path": {MOE_ARCH: moe_res["reorder_launches"],
                             "dlrm/pidcomm":
                                 apps_res["dlrm_reorder_launches"],
                             "serve_prefill": prefill_res["reorder_launches"],
                             "tune": tune_res["reorder_launches"],
                             f"{ARCH}/checkpoint":
                                 ckpt_res["reorder_launches"],
                             MIXTRAL_ARCH: mixtral_res["reorder_launches"],
                             WHISPER_ARCH: whisper_res["reorder_launches"],
                             LLAVA_ARCH: llava_res["reorder_launches"],
                             JAMBA_ARCH: jamba_res["reorder_launches"],
                             f"{JAMBA_ARCH}/train": mr[JAMBA_ARCH]["reorder"],
                             f"{MOE_ARCH}/train": mr[MOE_ARCH]["reorder"],
                             f"{MIXTRAL_ARCH}/train":
                                 mr[MIXTRAL_ARCH]["reorder"]},
        "max_abs_err": max(r["max_abs_err"] for r in reorder_rows),
        "ms": swz["ms"],
        "plain_ms": swz["plain_ms"], "bound_ms": swz["bound_ms"],
        "bound_by": swz["bound_by"], "library_ms": swz["library_ms"],
        "at": swz["name"], "x": swz["x"], "blocks": swz["blocks"],
        "shapes": {r["name"]: {k: r[k] for k in (
            "x", "blocks", "grid", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "share_of_bound", "fits_l2",
            "max_abs_err")} for r in reorder_rows},
        "sweep": {str(r["block_bytes"]): {k: r[k] for k in (
            "x", "grid", "ms", "library_ms", "bound_ms",
            "share_of_bound", "fits_l2")}
            for r in results["kernel"]["reorder_sweep"]["rows"]},
        "launch_floor_ms": results["kernel"]["reorder_sweep"][
            "launch_floor"]["ms"],
    }, {
        "name": "flash_attention_int8_decode", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
        "entry": "repro_flash_decode_int8 (flash.flash_attention with "
                 "k_scale / v_scale)",
        "launches": int8_res["int8_launches"],
        "launches_by_path": {f"{ARCH}/serve_int8": int8_res["int8_launches"]},
        "max_abs_err": max(t["max_abs_err"] for t in int8_res["main_path"]),
        "ms": int8_head["ms"], "plain_ms": int8_head["plain_ms"],
        "bound_ms": int8_head["bound_ms"], "bound_by": int8_head["bound_by"],
        "library_ms": None, "at": int8_head["name"],
        "bf16_cache_ms": int8_head["bf16_cache_ms"],
        "shapes": {t["name"]: {k: t[k] for k in (
            "q", "kv", "ms", "plain_ms", "bf16_cache_ms", "bound_ms",
            "bound_by", "max_abs_err")} for t in int8_res["main_path"]},
        "off_main_path": {t["name"]: {k: t[k] for k in (
            "q", "kv", "ms", "plain_ms", "bf16_cache_ms", "bound_ms",
            "bound_by", "err")} for t in results["kernel"]["int8_rows"]},
    }, *(_lowp_entry(mode, results["kernel"], results["lowp"])
         for mode in (1, 2)),
        _rwkv6_entry(kern["rwkv6"] + kern["rwkv6_train_forward"], {
        RWKV_ARCH: rwkv_res["rwkv6_launches"],
        f"{RWKV_ARCH}/train": mr[RWKV_ARCH]["rwkv6"]},
        results["kernel"]["rwkv6"]),
        _flash_bwd_entry(kern["flash_backward"], {
            f"{ARCH}/train": train_res["flash_bwd_launches"],
            f"{ARCH}/checkpoint": ckpt_res["flash_bwd_launches"],
            **{f"{a}/train": mr[a]["flash_bwd"] for a in mr_attn}}),
        _rwkv6_bwd_entry(kern["rwkv6_backward"], mr[RWKV_ARCH]["rwkv6_bwd"],
                         results["kernel"]["rwkv6_backward"])],
        "total_s": round(time.perf_counter() - t_all, 3)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
