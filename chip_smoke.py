#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one NVIDIA H100

Phases, each fatal on failure (nothing is caught):

  1. device   — the card's name and power limit (nvidia-smi); TF32 off.
  2. build    — nvcc builds every kernel of ``src/repro_torch/kernels/csrc``;
                ptxas' registers and spills of the tensor-core routes
                (kernel A's, kernels C and D's at one D and their pair
                route at q/k 192, v 128, and the float32 192/128
                instantiations), with their shared memory; none may spill
                at D = 128, in A's latent and pair routes (192/128 and
                160/160), in C and D's pair route (both instantiations) or
                in the float32 192/128 and 160 kernels.
  3. kernels  — each kernel's wrapper against its plain PyTorch version on
                the card, at llama-7b serving and training shapes plus edge
                cases, every case of A, C and D in both dtypes (bf16 runs
                the tensor-core routes, float32 the CUDA-core ones);
                tolerances: forward float32 1e-5 (paged 2e-5), bf16 2e-2;
                backward (kernels C and D) float32 2e-4, bf16 5e-2; lse
                1e-4; the pruned sweep equal to the dense one within 1e-6
                (bf16 forward: 2^-9 of max |o|, under one bf16 step).
                bf16 outputs of A are also held element by element to 3e-2
                of their own size (``rel_err``; A's route feeds p to the
                second product as two bf16 terms to meet it); bf16 outputs
                of C and D row by row to 2e-2 of each row's norm
                (``row_rel_err``), since their route rounds p and ds.
                Kernel B (split-KV) also at its split edges (lengths
                L_s - 1, L_s, L_s + 1, 2 L_s), a 32768-token request, a
                window across a split boundary and Tq 4 rows that are dead
                in some splits, each launch counted once; and bitwise: a
                request alone, in a batch of 4 and under a permuted block
                table gives the same o, and so do two launches.  The Qwen
                family's head pairs (32, 8), (40, 8) and (40, 40) × 128 in
                both dtypes: A at the serving chunk, B at the serving step
                and at verify Tq 5 (group 5: 25 rows, two 16-row groups).
                deepseek-v2-lite-16b's absorbed-MLA shapes in both dtypes:
                A's latent route (bf16 on the tensor cores, float32 on the
                CUDA cores) at q (1, 256, 16, 576), q_offset 768, k
                (1, 1024, 1, 576), v its 512-column view, scale 1/√192; B
                over a latent pool (N, 16, 1, 576) with that view at Tq 1
                and 5 (80 rows: five 16-row groups), phase 4's lengths; B
                bitwise batch-invariant at Tq 1.  Materialised MLA (phase
                13) in both dtypes: A's pair route (bf16 on the tensor
                cores, float32 on the CUDA cores) at q/k 192, v 128 (the
                last 128 columns of a 256-column tensor), 16 heads, scale
                1/√192: phase 13's prefill (B 2, T 4096, causal; launch ==
                launch bitwise), a chunk at q_offset 768 (Tq 256, Tk 1024),
                a ragged T of 1000; pairs outside its table raise.  Kernels
                C and D at that pair in both dtypes (bf16 on the tensor
                cores, the pair library; float32 on the CUDA cores), v the
                strided view: phase 14's training shape (B 1, T 8192, 16
                heads, causal; launch == launch bitwise), a ragged T, a
                document mask, a q-offset chunk, each held to phase 3's
                bars, which must reject the plain backward without the
                last 64-key tile; other (Dk, Dv) pairs and the latent pair
                raise.  Kernels A, C and D at head dim 160 (zamba2's shared
                block, scale 1/√160) in both dtypes (bf16: the pair
                libraries at <160, 160>; float32: flash_fwd.cu /
                flash_bwd.cu at 160): A at B 1, T 4096, 32 heads, causal
                (launch == launch bitwise), a q-offset chunk, a ragged T;
                C and D at T 8192, 32 heads (launch == launch bitwise), a
                ragged T, a document mask, a q-offset chunk, at phase 3's
                bars, which must reject the control without the last key
                tile; head dims 144, 176 and 256 raise.
  3c. plans   — kernels A, C and D under every distinct mask the plan
                steps give them: every active Work item of balanced, ring
                and zigzag (causal) at P 4, Tl 8192 (zigzag: two chunks of
                4096), of a windowed ring and a windowed zigzag (window
                3000: whole rows empty at large q offsets, rank offsets
                folded into static masks) and two steps of a document
                plan with segment ids; 32 heads × 128, bf16.  The backward
                gets the executor's inputs (o = 0, delta passed in).  Held
                head slice by head slice to phase 3's limits; empty rows
                must be (0, NEG_INF) and merge to the other partial; a
                statically empty chunk launches nothing.  Then A, C and D's
                pair routes (q/k 192, v 128, 16 heads, v a strided view)
                under every distinct step of the balanced and zigzag plans
                at P 4, Tl 8192, the backward with o zeros of v's width,
                held to their plain versions at phase 3's bars (the
                backward's must reject the control without the last key
                tile).
  3d. comm    — the ``cuda-ipc`` transport on 4 ranks sharing the card
                against ``gloo-staged`` on the same seeded inputs: shifts,
                all_to_all, all_gather, broadcast_, max and reduce_scatter
                (FSDP's; past the slot too) bitwise, sums
                bitwise equal on every rank and within float32 rounding of
                the float64 sum, messages past the mailbox's slot whole; a
                planted fault (reads of the next peer's mailbox) must break
                every transfer; each transport timed at phase 18's 64 MiB
                all_to_all and shift and phase 16's decode all-reduce.
  4. serve    — llama-7b at full width and depth (32 layers, d_model 4096,
                32 heads × 128, bf16, seeded random weights made on the
                card) through the paged engine: 4 prompts of 1000, 700, 513
                and 64 tokens, 32 greedy tokens each.  Both kernels must
                have launched during the run; the last decode logits of the
                longest request are held against a plain whole-context
                forward of the same model that calls the plain attention,
                and the limit must reject two deliberately wrong forwards
                (one position off; the oldest cache block hidden).  Prefill and decode seconds come from the engine's own
                CUDA-event spans.
  9. spec     — speculative serving (runs right after phase 4, on its
                llama-7b weights and prompts; request 1 sampled at
                temperature 0.8, the rest greedy) with smollm-360m at full
                size as the draft (32 layers, 15 heads over 5 kv heads of
                64, vocab 49152, bf16, seed-7 weights): warm_prefill, then
                five runs of the phase 4 engine (its pool grown by the
                lookahead's blocks): vanilla; depth 0 (streams and every
                row of logits bitwise vanilla's); depth 4 with an oracle
                draft proposing the vanilla continuation (a wrong token at
                draft index 2 for request 2), which must commit 5 tokens on
                most full-depth steps; depth 4 n-gram; depth 4 with the
                draft model (kernel A catches it up, kernel B rolls it).
                The streams of the last three equal vanilla's, diverging
                only where vanilla's top-two gap (Gumbel-perturbed when
                sampled) is below the logit limit; every committed verify
                row is within phase 4's 5e-2 of max |logit| of vanilla's
                row at that position, and the limit must reject two
                planted verify faults (rope positions one off; attention
                before the rows' own writes).  Both allocators conserve
                after every run.  A seeded storm (``FaultInjector.seeded(0,
                n_steps=20, rate=0.5)``, audited) runs twice over the n-gram
                engine: equal fault logs, every request terminal, streams
                of untouched requests equal the zero-fault run's and the
                rest its prefixes.  Prints decode tokens/s, tokens a step,
                acceptance and launches of A and B a step (target and
                draft apart).
  6. train    — llama-7b's width (d_model 4096, 32 heads × 128, d_ff 11008,
                vocab 32000, bf16) at depth 8, one sequence of 8192 tokens:
                4 steps of ``make_train_step`` under ``remat_aware`` on
                ``SyntheticTokens`` (seed 0, lr 1e-4).  Kernels A, C and D
                must each launch 8 times per step, every loss be finite and
                no step be skipped; then 1 step under ``hf``, which must
                launch A 16 times, and 1 under ``none``, both giving step
                1's loss again; peak memory per policy.  A torch.profiler
                window over one more step shows where the time goes, and
                that step's attention inputs are kept for 6a and 5.
  6a. main    — kernels A, C and D on those inputs (T 8192), against their
                plain versions head slice by head slice, to the phase-3
                limits; the element-wise limit must reject a plain forward,
                and the per-row limit a plain backward, that never visits
                the last 64-key tile.  SDPA's forward and backward on the
                same inputs are printed under the same gates, as
                calibrations.
  6b. grads   — at 2 layers and T 1024, full width: per leaf, max |Δg|
                between the kernels and the plain attention is at most 5%
                of the leaf's max |g|, and the same limit rejects a plain
                backward whose causal mask is shifted by one position.
  7. ranks    — the multi-rank path: a gloo world of 4 processes sharing
                the card (transport "cuda-ipc": every transfer device to
                device through CUDA IPC mailboxes), llama-7b's width (d_model
                4096, 32 × 128 heads, d_ff 11008, vocab 32000, bf16) at
                depth 2 on one global sequence of 32768 tokens (8192 a
                rank), remat_aware: 2 balanced steps, 1 ring, 1 zigzag.
                Per rank and step: A, C and D launch counts equal to the
                rank's Work items with a route that reaches an output
                (the coverage rule, checked to compute every causal chunk
                pair once) × layers, finite losses equal on every rank,
                no skipped step; peak memory.  Held to a P = 1 run of the
                same weights and batches in this process: the per-token
                losses of the first batch (the limit must reject a
                control whose plans drop the helper routes); the
                gradients of every layer's wq, wk, wv under each schedule,
                step 1's gradient norm and step 2's loss (the limits must
                reject two planted backward faults: the accumulators'
                home shift dropped, the helpers' dq dropped).  An
                ``auto`` step: one train step under ``schedule="auto"``
                from the world's own init and first batch; every rank
                resolves ``choose_schedule``'s pick for the cell (ulysses
                at the H100 constants: its forward A once a layer over the
                whole 32,768-token sequence at 8 heads a rank, its
                backward the ring plan's C and D), its loss and gradient
                norm bitwise a named-ulysses step's from the same start,
                its loss within the P = 1 bar; rank 0's first
                whole-sequence A call held to its plain version on its
                first and last 2,048 query rows.  Any rank's failure, or
                the world still running after 600 s, is fatal.
  8. long     — long-context serving across sequence ranks: a gloo world
                of 4 processes sharing the card (``cuda-ipc``),
                llama-7b's width (d_model 4096, 32 × 128 heads, d_ff 11008,
                vocab 32000, bf16, seed-0 weights) at depth 4, one prompt
                of 65536 tokens (16384 a rank): ``FixedSlotEngine`` with a
                balanced prefill across the ranks (kernel A in the plan
                executors), the cache sharded along the sequence, 32
                greedy tokens by flash-decoding across the shards.  Kernel
                A's launches per rank equal the plan's coverage count ×
                layers, kernel B never launches, every rank emits the same
                tokens.  Decode logits are held step by step, teacher-
                forced on the ranks' tokens, to the same dense path at
                P = 1 and to the paged ``Engine`` at P = 1 (kernels A and
                B) in this process, to phase 4's form of limit, which must
                reject two planted faults (rank 1's shard left out of the
                decode reduction; positions one off).  Then a head-parallel
                pool of llama-7b's 32 kv heads over the 4 ranks: kernel B
                on each rank's 8 heads, all-gathered, equals one B over
                every head bit for bit at the serving step's shape.
                Prefill seconds and decode ms per rank, host seconds in
                shifts and reductions (``Comm``'s timers), peak memory.
                Any rank's failure, or the world still running after 900
                s, is fatal.
  10. qwen    — qwen3-8b (GQA group 4, qk-norm), qwen2.5-14b (group 5,
                q/k/v bias) and qwen1.5-32b (40 heads, q/k/v bias) at full
                size, one at a time (bf16, seed-10 weights made on the
                card, biases moved off zero and qk-norm weights off one):
                the depth is cut only if the weights, the pool and one
                float32 leaf do not fit the free memory (printed).  Phase
                4's engine and prompts, 32 greedy tokens each; the last
                logits of the longest request within phase 4's limit of a
                plain forward, which must reject the model with its
                feature left out (bias dropped, qk-norm skipped) and phase
                4's two controls; qwen3-8b also serves with n-gram drafts
                at depth 4 (B at Tq 5 × group 4), its streams vanilla's but
                at near-ties.  Prefill and decode tokens/s, launches of A
                and B, peak memory per model.
  11. mesh    — the paged engine across a gloo world of 4 processes sharing
                the card (``cuda-ipc``), each rank running the same
                engine in lockstep over a sharded pool: (a) qwen3-8b's
                width at depth 8 (8 kv heads: head-parallel), (b)
                smollm-360m at full size (5 kv heads: block-sharded), with
                request 3 sharing request 0's first 37 tokens (a prefix
                hit whose partial block forks on write) and, in (b), one
                corrupted block at step 10.  Every rank's streams, fault
                log and terminal states equal the one-process ``Engine``'s
                on the same weights; the ranks' logits agree bit for bit;
                rank 0's are held to the one-process run's at phase 4's
                limit, which must reject a run whose all-gathers take
                zeros for rank 1's part; in (b) the corrupted block
                quarantines its owner only.  Decode-step ms per rank, host
                seconds in all-gathers and broadcasts (``Comm`` timers).
                Any rank's failure, or the world still running after 900 s,
                is fatal.
  12. deepseek — deepseek-v2-lite-16b (arXiv:2405.04434) at full size: 27
                layers, d_model 2048, MLA 16 heads (kv_lora 512, rope 64,
                nope 128, v 128), the first layer dense (d_ff 10944), 26
                MoE layers of 64 routed + 2 shared experts, top-6, d_expert
                1408, capacity 1.25, vocab 102400, bf16, seed-12 weights
                made on the card (15.50 B parameters); nothing cut.  Phase
                4's engine and prompts, 32 greedy tokens each: chunks
                through A's latent route, decode through B over the latent
                pool (95.6 MB).  The longest request's last decode logits
                within phase 4's limit of the same engine on the plain
                versions (``impl="ref"``, same chunking; the first decode
                step if the streams part at a near-tie), which must reject
                the context without its last token and a window hiding the
                oldest block (both through the plain engine); the (token,
                layer) top-6 sets that differ between the two runs are
                counted.  Then n-gram speculation at depth 4 (B at Tq 5),
                held to the vanilla run as phase 9 holds its runs, and a
                profiler trace.  Prefill and decode tokens/s, launches,
                peak memory, the phase's seconds.  Phase 12's model and
                weights go on to phase 13.
  13. fixed   — deepseek-v2-lite-16b at full size (phase 12's model and
                seed-12 weights) through ``FixedSlotEngine``: 2 prompts of
                4,096 tokens in one whole-prompt prefill (MLA materialised:
                A's pair route once a layer, 27 launches, and nothing
                else; the MoE dispatch over all 8,192 rows; the latent rows
                kept as the dense cache), 32 greedy tokens by the absorbed
                dense-cache decode (plain float32 attention over the latent
                rows, every expert a row).  Every step's logits within
                phase 12's limit (5% of max |logit|) of the same engine on
                the plain versions, teacher-forced on this run's tokens and
                replaying its expert choices; the limit must reject decode
                positions one off and a prefill that caches k_pe without
                its rope.  Prefill seconds, decode ms a step, peak memory,
                a profiler trace of the prefill and of 6 decode steps
                (device breakdown, idle share).
  14. train-moe — deepseek-v2-lite-16b trained at full width, cut to 8 of
                27 layers (the dense layer 0 and 7 MoE layers, 4.38 B
                parameters), one 8,192-token ``SyntheticTokens`` sequence a
                step, bf16, seed-14 weights, MoE capacity 960: step 1's
                loss (within 2^-8 of itself) and every gradient leaf (5% of
                its max |g|) against the same weights and batch through
                the plain attention replaying the kernel run's expert
                choices by call order (the remat recompute's included;
                the recomputed top-6 sets that differ from the forward's
                are counted), a planted fault (v from the wrong columns of
                the ``wkv_b`` up-projection) rejected; A, C and D on the
                training path's own inputs as in 6a; then 4 steps each
                under ``remat_aware`` and ``hf`` (A 8 / 16 launches a
                step, C and D 8), finite ce and aux, tokens/s, peak memory
                and a profiled step's device breakdown and top kernels.
  5. times    — each kernel at the shapes of its path (C and D on the
                inputs kept in phase 6): its time (CUDA events, median
                after warm-up), its plain version's at the same shape, a
                library call's where one exists (for C and D, SDPA's
                backward of the pair, marked ``library_covers``), and the
                least time the card could take.  Kernel A also at the
                training shape (its layer-1 inputs, T 8192, causal), beside
                its bound, its plain version and SDPA's causal forward
                (``train_*`` keys), and at the serving chunk of each
                Qwen head pair (``qwen_*`` keys).  Kernel B with a cold L2
                (launches rotate over 4 distinct pool pairs) at the serving
                step, a 32768-token decode (``long_*``), GQA Tq 4
                (``gqa_*``) and the Qwen head pairs at Tq 1 and 5
                (``qwen_*``), and the MLA latent pool at Tq 1 and 5
                (``mla_*``): its device time (40 calls replayed as one
                CUDA graph; torch.profiler's reading printed beside it, as
                the profiler has dropped kernels late in a run), the
                wrapper's (CUDA events) and the host time of one call (1000
                calls).  A's latent route at phase 12's chunk (its own row,
                ``flash_fwd_latent``, bf16): its time and its device time
                (20 calls replayed as one CUDA graph) beside its plain
                version, SDPA with an explicit mask (which it must beat)
                and its bound.  A's pair route at phase 13's prefill (its
                own row, ``flash_fwd_pair``, bf16): its device time (CUDA-
                graph replay) and event time beside its plain version,
                SDPA's causal forward on the same tensors (the backend its
                dispatcher takes, named) and its bound.  C and D at 192/128
                on phase 14's own backward inputs (their own rows,
                ``flash_bwd_dq_pair`` / ``flash_bwd_dkv_pair``): device and
                event time, plain versions, SDPA's autograd backward of the
                pair (its backend named), bounds.  A, C and D at head dim
                160 (their own rows, ``flash_fwd_160``, ``flash_bwd_dq_160``,
                ``flash_bwd_dkv_160``) at zamba2's training shape, q, k, v
                (1, 8192, 32, 160) bf16, causal: device time (CUDA-graph
                replay) and event time, plain versions head slice by head
                slice, SDPA's causal forward and autograd backward (backend
                named), bounds (640, 960 and 1,280 FLOPs a pair).

  15. moe-ranks — (after phase 5: torch.profiler, which phase 5 reads, has
                seen no device kernel in a process that ran phases 15 and
                16 first) deepseek-v2-lite-16b trained across 4 ``cuda-ipc``
                ranks sharing the card, its 64 routed experts 16 a rank
                (the dispatch's two all_to_alls, the aux loss's sums over
                the ranks): full width cut to 3 of 27 layers (the dense
                layer 0 and 2 MoE layers), one 16,384-token sequence a step
                (4,096 a rank: the head's float32 logits of 32,768 tokens
                do not fit 4 ranks on one card), capacity 480, bf16, seed
                15, remat_aware: 3 balanced steps and 1 zigzag step.  One
                process (P = 1) first runs the same weights and tokens
                keeping the pairs each rank keeps of its own rows; the
                ranks replay its expert choices.  Step 1's loss and aux
                within 2^-8 of P = 1's, every gradient leaf (experts
                gathered) within 5% of its max |g|, step 1's gnorm and
                step 2's loss within 2^-8; the ranks agree; no step
                skipped; A / C / D launches a step equal the plan's Work
                items × layers.  Rejected controls: the return all_to_all
                rotated by one rank, the aux without its cross-rank mean,
                expert gradients also summed over the sequence ranks.
  16. moe-serve — deepseek-v2-lite-16b at full size (nothing cut) across
                4 ``cuda-ipc`` ranks through ``FixedSlotEngine``: one
                16,384-token prompt, a balanced whole-prompt prefill (A's
                pair route under the plan's steps, the MoE dispatched over
                the ranks), 32 greedy tokens over the sharded latent cache
                (each step's expert outputs summed over the ranks).  Every
                step's logits within 5% of max |logit| of one process on
                the same weights and prompt (phase 13's path) replaying
                the ranks' expert choices and kept pairs, teacher-forced on
                their tokens; rejected controls: the decode without its sum
                over the ranks' experts, the return all_to_all rotated.
                Then the latent ring: the prompt prefilled again under
                zigzag with ``latent_ring=True`` (each rank ships its 576
                latent columns a position on the ring, not 16 × (192 +
                128) of K/V, and expands what arrives; A's pair route under
                the zigzag plan's steps), replaying the balanced run's
                expert choices and kept pairs at each row's zigzag
                position: its last logits within 5% of max |logit| of the
                one process, its latent cache un-permuted within the same
                bar of the balanced run's; rejected control: each
                expansion with the next layer's ``wkv_b``.  Each layer's
                attention inputs then go through the zigzag K/V ring and
                the latent ring alone: host seconds, seconds in shifts and
                elements a position shipped of each.
  17. moe-paged — deepseek-v2-lite-16b at full width, cut to 9 of 27
                layers (the dense layer 0 and 8 MoE layers: at full depth
                the phase took 152 s on an H100 80GB HBM3 at 700 W; seed
                17), across 4 ``cuda-ipc``
                ranks through phase 4's paged ``Engine``, its latent pool
                block-sharded (48 of the 192
                blocks a rank): phase 11's requests (request 3 shares
                request 0's first 37 tokens, a fork across ranks' blocks;
                a corrupted block at step 10), 32 greedy tokens each.
                Chunks through A's latent route over the gathered pool,
                each chunk's MoE rows split over the ranks (64 of 256 a
                rank, capacity 8 an expert); decode through B over the
                gathered pool, the experts summed over the ranks.  Every
                rank's streams, fault log and states equal, logits
                checksums bitwise equal; the corrupted block quarantines
                its owner only; the pools conserve; on rank 0 one chunk's
                A call and one decode's B call held to their plain
                versions at phase 12's limits.  Every step's logits within
                5% of max |logit| of one process's paged Engine replaying
                the ranks' expert choices and kept pairs, teacher-forced
                on their tokens; rejected controls: every rank
                dispatching the whole chunk (capacity 30 an expert), the
                decode without the experts' sum, the pool gather rotated
                by one rank.  Decode ms a step, the decode's host seconds
                in pool gathers and in the MoE sums.
  18. seq2d   — the 2D sequence × head plans on 4 ``cuda-ipc`` ranks
                (run right after phase 8): (a) phase 7's model and batch
                (llama-7b width, depth 2, T 32768, bf16, remat_aware) on
                ``make_seq2d_mesh(2, 2)`` under balanced and on (1, 4)
                under ring (scatter mode), held to phase 7's P = 1 run
                (per-token losses, wq/wk/wv gradients, step 1's gradient
                norm) at phase 7's limits; rejected controls: the head
                scatter concatenating its peers rotated by one, the
                backward's dk/dv all-to-all rotated by one; each rank's
                A/C/D launches in one train step equal to the inner plan's
                ``rank_calls``; step seconds, host seconds in head
                all_to_alls and seq shifts, peak memory; on (2, 2) an
                ``auto`` step from the named step's start: every rank
                resolves ``choose_inner_schedule``'s pick (balanced), its
                loss, norm and launches bitwise the named step's.  (b)
                replicate mode: the attention alone on (2, 2), q 32
                heads × 128, k/v one kv head, T 32768, bf16, causal,
                against one kernel call
                on the whole inputs at phase 3's bf16 bars (o row by row,
                as the backward: it merges bf16 partials); rejected
                control: the home step without its all-reduce over
                ``head``.  (c) ``FixedSlotEngine`` (phase 8's model, one
                16,384-token prompt, 8 greedy tokens) on (2, 2) against the
                same world's ``make_local_mesh(seq=4)``, teacher-forced:
                logits within phase 8's limit at every step, tokens equal
                at every step.
  19. moe2d   — deepseek-v2-lite-16b on a 2D (seq = 2) × (head = 2) mesh
                of 4 ``cuda-ipc`` ranks (after phase 17): the routed
                experts 32 a rank over seq, each head rank gathering its
                seq shard's 4,096 MoE rows over head (capacity 480), the
                aux statistics over seq, MLA through A / C / D's pair
                routes under the head scatter.  (a) 2 of 27 layers (the
                dense layer 0 and one MoE layer: a third adds 277 M expert
                parameters a rank with their moments), 8,192 tokens a
                step, 2 balanced steps, seed 19, held to one process that
                the ranks replay (its expert choices; its kept pairs are
                the seq shards'): step 1's loss and aux within 2^-8, every
                gradient leaf and the aux loss's router gradients alone
                within 5% of their max |g|, step 1's gnorm and step 2's
                loss within 2^-8; rejected faults: expert gradients summed
                over head not at all and twice, the aux statistics reduced
                over head too, the head scatter rotated; A / C / D launches
                a step equal the inner plan's ``rank_calls`` × layers.
                (b) 9 of 27 layers through ``FixedSlotEngine``: one
                8,192-token prompt, a balanced 2D prefill, the latent cache
                over the (seq, head) pair, 8 greedy tokens; tokens equal on
                every rank, every step's logits within 5% of max |logit|
                of one process replaying the ranks' expert choices and
                kept pairs, teacher-forced; rejected controls: the decode
                MoE without its sum over seq, each head rank dispatching
                only its own 2,048 rows.  (c) the latent ring on (2, 2)
                raises (ROADMAP fault 3.7), printed.
  20. engine2d — the paged Engine on a 2D (seq = 2) × (head = 2) mesh of
                4 ``cuda-ipc`` ranks (after phase 19), every pool sharded
                over seq alone (the two head ranks of a seq shard hold the
                same part), seed 20, phase 4's engine, phase 11's requests
                (a prefix fork), 32 greedy tokens.  (a) qwen3-8b's width at
                depth 8 of 36 (phase 11 (a)'s cut), its K/V pool
                head-parallel (4 of 8 kv heads a seq rank): streams equal
                a one-process engine's on the same weights.  (b)
                deepseek-v2-lite-16b at full width, 9 of 27 layers (phase
                17's cut), its latent pool block-sharded (96 of 192 blocks
                a seq rank), a chunk's MoE rows split over seq (128 of 256
                a seq rank), a corrupted block at step 10: every step's
                logits within 5% of max |logit| of one process replaying
                the seq shards' expert choices and kept pairs,
                teacher-forced; the block's owner alone quarantined;
                controls: the fault applied on one head replica only
                (rejected by the replica check), each head rank
                dispatching only its own 64 rows (rejected by its dispatch
                size).  Both: streams, states, fault log and logits
                checksums equal on every rank, each seq shard's two
                replicas' pools bitwise equal (digests), A and B on rank
                0's chunk and decode inputs held to their plain versions;
                decode ms a step and host seconds in pool gathers and MoE
                sums a rank.
  21. ssm     — the SSM and hybrid families, bf16 (a and b run after phase
                14, c after phase 20).  (a) mamba2-2.7b at full size (64
                layers, d_model 2560, 80 SSM heads of 64, d_state 128,
                seed 0): 3 training steps of 8,192 tokens under remat_aware
                (the mixers checkpointed at their boundary), one more step
                traced on the device alone for the idle share; tokens/s
                over steps 2-3, peak memory.  Then the recurrent decode
                from the empty cache (seed 21): a 64-token prompt token by
                token and 32 greedy tokens, every prompt position's logits
                within 5% of max |logit| of the training forward's on a
                float32 copy of the weights (the bf16 model's drift read
                and printed), ms a greedy bf16 step.  (b) zamba2-2.7b at
                full size (54 layers, a shared block of 32 heads × 160
                every 6 layers): the same, kernels A, C and D at head dim
                160 launched 9 times a step each; its gradients at full
                width, 6 layers, T 4,096 within 5% of max |g| of the plain
                attention path, a backward shifted by one position
                rejected.  (c) zamba2 at 12 of 54 layers on 4 cuda-ipc
                ranks, 16,384 tokens (4,096 a rank), balanced, the state
                relayed and the conv halo shifted between the ranks: step
                1's loss within 2^-8 and every gradient leaf within 5% of
                one process's on the same weights and tokens, the logits
                at every shard's first 64 positions within 5% of max
                |logit| of its; both planted relay faults (every rank from
                a zero state; the halo zeroed) rejected; host seconds in
                shifts and all-reduces.
  22. ssm2d   — zamba2-2.7b at full width, 12 of 54 layers, on a 2D (seq =
                2) × (head = 2) mesh of 4 cuda-ipc ranks (after phase 21
                (c)), 16,384 tokens (4,096 a rank), balanced: the relay
                and the halo over all 4 ranks in sequence order, the
                shared block through the 2D plan (A, C, D at 160).  Held to
                one process as 21 (c) is (loss 2^-8, every summed leaf 5%,
                shard edges 5%); rejected faults: the SSM leaves summed
                over head once more, a zero relayed state.  Then a
                56-token prompt's prefill and the recurrent decode (the
                prompt token by token, 8 greedy tokens, the shared K/V
                sharded over 4 ranks), teacher-forced: prefill logits,
                every step's logits and every shared call's attention
                output within 5% of the one process's; rejected: the
                prefill's head scatter rotated by one, rank 1's shard
                left out of the decode's reductions.
  23. vlm     — internvl2-2b at full size (256 image positions before
                the text), bf16, seed 23: (a) 3 remat_aware steps of 8,192
                positions, A / C / D once a layer a step; (b) gradients at
                4 layers, T 4,096 within 5% of the plain attention path's
                (controls: a shifted backward, the image labels
                unmasked); (c) FixedSlotEngine, 4 requests of 256 image
                rows + 1,000 / 700 / 513 / 64 tokens, 32 greedy tokens,
                every step within 5% of max |logit| of the plain forward
                (control: the decode at S0 − 256, S0 from the text
                alone); (d) one zigzag step on 4 cuda-ipc ranks at 4 of
                24 layers held to one process (loss 2^-8, leaves 5%;
                control: the image labels unmasked).
  24. whisper — whisper-tiny at full size (4 + 4 layers, 1,536 frames),
                bf16, seed 24: (0) A, C and D at the cross shape q (2,
                4096, 6, 64) against k / v (2, 1536, 6, 64), full mask,
                and A at Tq = 1 against 1,536 keys, both dtypes, at phase
                3's bars, then their bf16 device times (CUDA-graph
                replay), plain and SDPA times and bounds (the ``whisper_*``
                keys of the A, C and D rows); (a) 2 remat_aware steps, B
                2, decoder T 4,096, A 16 and C / D 12 launches a step; (b)
                gradients within 5% of the plain path's (controls: a
                shifted backward, a causal cross-attention); (c) 4
                cuda-ipc ranks held to (b) (loss 2^-8, leaves 5%; control:
                the encoder's gradients summed twice); (d)
                FixedSlotEngine, 4 requests of 1,536 frames and 64-token
                prompts, 32 greedy tokens, within 5% of the plain forward
                (control: a causal cross-attention).
  25. v3      — deepseek-v3-671b with multi-token prediction (MTP), bf16,
                seed 25, at full width (d_model 7168, MLA of 128 heads,
                q_lora 1536, kv_lora 512, rope 64, nope 128, v 128;
                d_expert 2048, d_dense_ff 18,432, top-8, 1 shared expert,
                vocab 129,280), 2 of 61 layers (1 dense + 1 MoE) beside
                the MTP block; training keeps 16 of 256 routed experts at
                capacity factor E / k (no pair drops).  (a) step 1 at T
                2,048 within 5% of max |g| of the plain attention path
                replaying the experts, every leaf and the MTP block's
                (control: MTP labels of t + 1), then 3 AdamW steps of
                4,096 tokens: loss, ce, aux, mtp_ce, A / C / D 3 a step.
                (b) 4 cuda-ipc ranks on (seq, head) = (4, 1), 8,192
                tokens, balanced, experts 4 a rank, and (c) the same on
                (2, 2), experts 8 a seq rank: held to one process on the
                same weights, tokens and expert choices (loss, aux, mtp_ce
                2^-8; every summed leaf 5%; the MTP logits at every
                shard's last 64 positions 5% of max |logit|); a step
                asked for as zigzag runs balanced; controls: each rank
                rolling its own shard (b), the shift over seq alone (c).
                (d) all 256 experts, the MTP block loaded and unused: the
                paged Engine (A latent, B over the latent pool, 128 heads
                on one latent head) and FixedSlotEngine (A pair) serve
                1,000 / 700 / 513 / 64-token prompts, 32 greedy tokens,
                every decode step within 5% of max |logit| of the plain
                engines replaying the experts, teacher-forced (control:
                each decode one position early); tokens/s, ms a step,
                idle share.  (e) A, C and D's pair route at (1, 4096, 128
                heads) and A's latent route and B at 128 heads, held to
                their plain versions at phase 3's bars, then timed by
                CUDA-graph replay beside bound and SDPA (the ``v3_*`` keys
                of the rows).
  26. tuning  — the autotuner's sweeps on the card (``tune/sweep.py``):
                (a) kernels A, C and D in bf16 at 32 heads × D 64, 128,
                160 and 192/128, T 2,048 and 8,192, four mask kinds,
                forward and backward, the causal D 128 row at T 8,192
                within 0.9-2.0x phase 5's device times (A; C + D); (b)
                every schedule's forward on 4 cuda-ipc ranks at T 8,192
                and 12,288 (32 × 128), rank 0's output at the first T
                within 2e-2 of the plain attention, then ``calibrate``;
                (c) the paged block sizes 8-64 of smollm-360m and
                deepseek-v2-lite-16b at full size on the reference's
                microtrace (greedy): every request's whole budget, the
                table written to ``build/`` and every winner back out of
                its lookups; (d) ``launch/dryrun`` on the meta device for
                llama-7b and deepseek-v3-671b ``train_4k`` on the
                production mesh: FLOPs, bytes, collective bytes and peak
                nonzero, within 60 s (its runs, and (e)'s counts, go to
                worker processes beside phases 14 and 21 (a, b)); (e) the
                meta peak of one rank of
                phase 7's cell within 0.8-1.25x that rank's
                ``max_memory_allocated``, and phase 6's counted FLOPs over
                its step time as a share of peak (not gated); and the
                meta peak of phase 27 (a)'s rank 0 within 0.8-1.25x its
                ``max_memory_allocated``.
  27. fsdp    — FSDP (ZeRO-3) training (runs after phase 7): 4
                ``cuda-ipc`` ranks on a (data 2, model 2) mesh, each
                holding its shard of every parameter the reference's
                ``param_spec`` shards over data and AdamW moments shaped
                like it, each weight gathered when its layer runs
                (``parallel/fsdp.py``), remat_aware, bf16, seed 27.  (a)
                llama-7b's full width at depth 4 of 32, 2 × 16,384 tokens
                a step (8,192 a rank), 3 steps; (b) deepseek-v2-lite-16b's
                dense layer 0 and one MoE layer, 4,096 tokens a step,
                step 1's gradients and 2 steps replaying the one process's
                expert choices with the pairs each rank keeps of its rows.
                Each against one process on the same global batch and
                weights: (a) phase 7's loss limit on every step's loss and
                its norm limit on step 1's; (b) phase 15's one-bf16-step
                bar on step 1's loss, aux and norm and step 2's loss; both
                every gradient leaf, gathered whole, within 5% of its max
                |g|, which a planted fault (the backward keeps its own
                block of each gradient, not summed over data) must exceed;
                the ranks agree; A, C and D launched as the plan says.
                Prints each rank's parameter and moment bytes (about half
                of one replica's in (a)), its ``max_memory_allocated``
                over the steps and its host seconds in the FSDP gathers
                and reduce-scatters.
Every phase prints its seconds, and every multi-rank phase its ranks'
host seconds in collectives.
Prints the ``{"kernels": [...]}`` line second to last and
``{"ok": true, "device": {...}}`` last.  Exits non-zero with no result when
there is no CUDA device or the port is not beside this file.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import mask as mk  # noqa: E402
from repro_torch.core.config import (  # noqa: E402
    ParallelConfig, ShapeSpec, TrainConfig, get_config)
from repro_torch.core import schedule as sp  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.kernels import build, registry  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FWD_ROUTES, LATENT_ROUTES, PAIR_ROUTES, FlashAttnFn, _BwdPlan,
    _device_bounds, _launch_dkv, _launch_dq, flash_bwd, flash_fwd)
from repro_torch.kernels.paged import paged_attn, paged_attn_ref  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    NEG_INF, chunk_attn_bwd_ref, chunk_attn_ref, merge_ref, row_rel_err)
from repro_torch.launch.mesh import (  # noqa: E402
    make_local_mesh, make_seq2d_mesh)
from repro_torch.launch.world import spawn  # noqa: E402
from repro_torch.models import layers as LY  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.transformer import DecoderLM, trainable  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.comm import MAILBOX_CAP  # noqa: E402
from repro_torch.parallel.sharding import make_parallel_config  # noqa: E402
from repro_torch.serve.cache import (  # noqa: E402
    PagedKVCache, sharded_paged_decode_attn)
from repro_torch.serve import prng  # noqa: E402
from repro_torch.serve.engine import Engine, FixedSlotEngine  # noqa: E402
from repro_torch.serve.faults import FaultEvent, FaultInjector  # noqa: E402
from repro_torch.serve.scheduler import TERMINAL_STATES  # noqa: E402
from repro_torch.serve.speculative import (  # noqa: E402
    DraftSource, ModelDraft, SpecConfig)
from repro_torch.train.step import (make_train_step,  # noqa: E402
                                    norm_groups)

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
# bf16 outputs of kernel A are also held element by element to their own
# size (see rel_err): two bf16 roundings of one float32 value differ by at
# most 2^-7 of it, and a sweep that skips a 64-key tile moves small outputs
# (late rows, last keys) by far more than that.
REL_TOL, REL_FLOOR = 3e-2, 1e-3
# bf16 outputs of C and D are held row by row instead (row_rel_err; a row
# is one query's dq or one key's dk / dv in one head): the tensor-core
# route rounds p and ds to bf16 before the second products (C takes ds as
# two bf16 terms), as every tensor-core backward does, which moves single
# small elements by far more than one bf16 step of their size but a row by
# ~2^-8 of its norm (a CPU emulation at T 512: 4.6e-3), while a sweep
# without the last 64-key tile moves rows by 0.1 to 1.
ROW_TOL = 2e-2
BWD_DESIGN = ("bf16: wgmma m64n64k16 on the tensor cores (sm_90a), float32 "
              "accumulators, swizzled bf16 tiles double-buffered by 16-byte "
              "cp.async, ds into dq as two bf16 terms; float32: IEEE FMAs "
              "on the CUDA cores")
FWD_DESIGN = ("bf16: one block per 128 q rows (two warpgroups of 64); k/v "
              "tiles of 128 keys by TMA into a 3-stage swizzled ring with "
              "mbarriers; s = q·kᵀ as wgmma m64n128k16, o += p·v as wgmma "
              "with p in registers as two bf16 terms (hi, lo); float32: "
              "IEEE FMAs on the CUDA cores")
# bf16 pruned vs dense sweep of kernel A: both do the same arithmetic on
# every live tile; the limit, 2^-9 of max |o|, is under half of one bf16
# step at the largest output (a step there is at least 2^-8 of it)
PRUNE_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -9}
PAGED_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_TOL = 1e-4
LOGIT_REL_TOL = 5e-2          # bf16, 32 layers: |Δ| ≤ 5% of max |logit|
GRAD_REL_TOL = 5e-2           # bf16 grads: |Δg| ≤ 5% of the leaf's max |g|
TRAIN_LAYERS, TRAIN_T, TRAIN_STEPS = 8, 8192, 4
DEV = torch.device("cuda", 0)


def say(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` on the device (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def graph_ms(fn, n=20, reps=5):
    """Device milliseconds a call of ``fn``: n calls captured in one CUDA
    graph, its replays timed with CUDA events (median of reps), so no host
    work sits between the launches."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
        torch.cuda.synchronize()
        with torch.cuda.graph(g, stream=s):
            for _ in range(n):
                fn()
    torch.cuda.current_stream().wait_stream(s)
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def rel_err(a, r):
    """max |a - r| / (|r| + REL_FLOOR · max |r|) over the elements: the
    error in units of each element's own size.  The floor keeps float32
    summation noise on outputs that cancel to ~0 from dominating."""
    a, r = a.float(), r.float()
    floor = REL_FLOOR * r.abs().max().clamp_min(1e-30)
    return float(((a - r).abs() / (r.abs() + floor)).max())


# ----------------------------------------------------------------- phase 3

def _flash_case(gen, name, B, Tq, Tk, Hq, Hkv, D, dtype, mask, segs=False):
    q = randn(gen, (B, Tq, Hq, D), dtype)
    k = randn(gen, (B, Tk, Hkv, D), dtype)
    v = randn(gen, (B, Tk, Hkv, D), dtype)
    kw = {}
    if segs:
        s = torch.sort(torch.randint(0, 4, (B, Tk), generator=gen,
                                     device=DEV), dim=1)[0].to(torch.int32)
        kw = dict(q_segments=s[:, :Tq].contiguous(), kv_segments=s)
    n0 = build.LAUNCHES["flash_fwd"]
    o, lse = flash_fwd(q, k, v, mask=mask, **kw)
    torch.cuda.synchronize()
    check(build.LAUNCHES["flash_fwd"] == n0 + 1, f"flash_fwd {name}: "
          "launches")
    o_r, lse_r = chunk_attn_ref(q, k, v, mask=mask, **kw)
    check(bool((lse[lse_r <= NEG_INF / 2] == NEG_INF).all()),
          f"flash_fwd {name}: an empty row's lse is not NEG_INF")
    err = float((o.float() - o_r.float()).abs().max())
    tol = TOL[dtype]
    check(torch.allclose(o.float(), o_r.float(), atol=tol, rtol=tol),
          f"flash_fwd {name}: o err {err} over {tol}")
    valid = (lse_r > NEG_INF / 2) | (lse > NEG_INF / 2)
    check(bool(valid.any()), f"flash_fwd {name}: every row is empty")
    lerr = float((lse - lse_r).abs()[valid].max())
    check(lerr <= LSE_TOL * (1 + float(lse_r[valid].abs().max())),
          f"flash_fwd {name}: lse err {lerr}")
    check(bool(torch.isfinite(o.float()).all()),
          f"flash_fwd {name}: non-finite")
    rel = ""
    if dtype == torch.bfloat16:
        r = rel_err(o, o_r)
        check(r <= REL_TOL, f"flash_fwd {name}: relative err {r} over "
              f"{REL_TOL}")
        rel = f"  rel {r:.2e} (limit {REL_TOL})"
    say(f"  A {name:<28} {str(dtype)[6:]:<9} max|Δo| {err:.3e}  "
        f"max|Δlse| {lerr:.3e}  tol {tol}{rel}")


def _paged_inputs(gen, B, Tq, Hq, Hkv, D, bs, lengths, dtype):
    lengths = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    nb = int(-(-int(lengths.max()) // bs)) + 2
    N = B * nb + 8
    q = randn(gen, (B, Tq, Hq, D), dtype)
    kp = randn(gen, (N, bs, Hkv, D), dtype)
    vp = randn(gen, (N, bs, Hkv, D), dtype)
    # fragmented, out-of-order tables; entries past each length are null
    perm = torch.randperm(N - 1, generator=gen, device=DEV)[:B * nb] + 1
    table = perm.reshape(B, nb).to(torch.int32)
    for b in range(B):
        table[b, -(-int(lengths[b]) // bs):] = 0
    return q, kp, vp, table.contiguous(), lengths


def _paged_case(gen, name, B, Tq, Hq, Hkv, D, bs, lengths, window, dtype):
    q, kp, vp, bt, lens = _paged_inputs(gen, B, Tq, Hq, Hkv, D, bs, lengths,
                                        dtype)
    mask = mk.sliding_window(window) if window else mk.causal()
    n0 = build.LAUNCHES["paged_decode"]
    o = paged_attn(q, kp, vp, bt, lens, mask=mask)
    torch.cuda.synchronize()
    check(build.LAUNCHES["paged_decode"] == n0 + 1,
          f"paged_decode {name}: launches")
    o_r = paged_attn_ref(q, kp, vp, bt, lens, mask=mask)
    err = float((o.float() - o_r.float()).abs().max())
    tol = PAGED_TOL[dtype]
    check(torch.allclose(o.float(), o_r.float(), atol=tol, rtol=tol),
          f"paged_decode {name}: err {err} over {tol}")
    say(f"  B {name:<28} {str(dtype)[6:]:<9} max|Δo| {err:.3e}  tol {tol}")


# (query heads, kv heads) of qwen3-8b, qwen2.5-14b and qwen1.5-32b (× 128)
QWEN_HEADS = ((32, 8), (40, 8), (40, 40))


def kernel_checks():
    gen = torch.Generator(device=DEV).manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    # kernel A at llama-7b prefill shapes (Hq = Hkv = 32, D = 128) + edges,
    # every case on both routes: float32 (CUDA cores), bf16 (wgmma)
    for dt in (f32, bf):
        _flash_case(gen, "causal Tq256 Tk1024 q_off768", 1, 256, 1024, 32,
                    32, 128, dt, mk.causal(rel_offset=768))
        _flash_case(gen, "sliding_window 300", 1, 256, 1024, 32, 32, 128, dt,
                    mk.sliding_window(300, rel_offset=768))
        _flash_case(gen, "gqa Hkv8", 1, 256, 1024, 32, 8, 128, dt,
                    mk.causal(rel_offset=768))
        _flash_case(gen, "ragged Tq100 Tk1000", 1, 100, 1000, 32, 32, 128, dt,
                    mk.causal(rel_offset=900))
        _flash_case(gen, "d64", 2, 256, 512, 8, 4, 64, dt,
                    mk.causal(rel_offset=256))
        _flash_case(gen, "prefix_lm d32", 1, 192, 192, 4, 2, 32, dt,
                    mk.prefix_lm(70))
        _flash_case(gen, "document boundaries", 1, 256, 256, 4, 4, 64, dt,
                    mk.document(boundaries=(0, 37, 150, 151)))
        _flash_case(gen, "document segments", 2, 128, 256, 4, 2, 32, dt,
                    mk.document(), segs=True)
        _flash_case(gen, "full kv_offset", 1, 64, 200, 4, 4, 32, dt,
                    mk.MaskSpec(q_offset=10, kv_offset=3))
        _flash_case(gen, "empty rows q_offset -64", 1, 128, 128, 2, 2, 128,
                    dt, mk.causal(rel_offset=-64))
        # the smollm-360m draft's catch-up chunk (phase 9): 32 rows, 15
        # query heads over 5 kv heads of 64, the gathered table behind
        _flash_case(gen, "draft chunk h15/5 d64", 1, 32, 1056, 15, 5, 64,
                    dt, mk.causal(rel_offset=1000))
        # the Qwen family's serving chunk (phase 10): qwen3-8b's GQA group
        # 4, qwen2.5-14b's group 5, qwen1.5-32b's 40 heads of group 1
        for hq, hkv in QWEN_HEADS:
            _flash_case(gen, f"qwen chunk h{hq}/{hkv}", 1, 256, 1024, hq,
                        hkv, 128, dt, mk.causal(rel_offset=768))
        # pruned == dense sweep
        q, k, v = (randn(gen, (1, 256, 4, 64), dt) for _ in range(3))
        m = mk.sliding_window(70)
        o1, l1 = flash_fwd(q, k, v, mask=m)
        o2, l2 = flash_fwd(q, k, v, mask=m, prune=False)
        d = float((o1.float() - o2.float()).abs().max())
        lim = PRUNE_TOL[dt] * (1.0 if dt == f32 else float(o1.float().abs()
                                                            .max()))
        check(d <= lim, f"flash_fwd pruned vs dense {str(dt)[6:]}: {d} over "
              f"{lim}")
        say(f"  A {'pruned == dense':<28} {str(dt)[6:]:<9} max|Δo| {d:.3e}  "
            f"tol {lim:.3e}")
        # statically fully masked chunk: zeros and NEG_INF without a launch
        n0 = build.LAUNCHES["flash_fwd"]
        o, lse = flash_fwd(q, k, v, mask=mk.causal(rel_offset=-1000))
        check(build.LAUNCHES["flash_fwd"] == n0 and float(o.abs().max()) == 0
              and bool((lse == NEG_INF).all()), "empty chunk launched")
    # kernel B: B = 4, bs = 16, fragmented tables, mixed lengths incl. 1
    lens = [1, 700, 513, 1032]
    _paged_case(gen, "Tq1", 4, 1, 32, 32, 128, 16, lens, 0, bf)
    _paged_case(gen, "Tq4", 4, 4, 32, 32, 128, 16, lens, 0, bf)
    _paged_case(gen, "window 256", 4, 1, 32, 32, 128, 16, lens, 256, bf)
    _paged_case(gen, "gqa Hkv8 Tq4", 4, 4, 32, 8, 128, 16, lens, 0, bf)
    _paged_case(gen, "gqa d64 window", 4, 3, 8, 2, 64, 8, [2, 5, 40, 77],
                20, f32)
    _paged_case(gen, "d32 bs64", 4, 1, 4, 4, 32, 64, lens, 0, f32)
    # speculative decoding (phase 9): the verify pass at Tq = depth + 1 = 5
    # on llama-7b's heads, and the smollm-360m draft (g = 3, D 64) at Tq 1
    # and Tq 5 (g·Tq = 15 rows a block)
    _paged_case(gen, "verify Tq5", 4, 5, 32, 32, 128, 16, lens, 0, bf)
    _paged_case(gen, "draft g3 d64 Tq1", 4, 1, 15, 5, 64, 16, lens, 0, bf)
    _paged_case(gen, "draft g3 d64 Tq5", 4, 5, 15, 5, 64, 16, lens, 0, bf)
    # the Qwen family (phase 10) at the serving step and at verify Tq 5:
    # group 5 at Tq 5 is 25 rows, two of the kernel's 16-row groups
    for dt in (f32, bf):
        for hq, hkv in QWEN_HEADS:
            for tq in (1, 1 + P9_DEPTH):
                _paged_case(gen, f"qwen h{hq}/{hkv} Tq{tq}", 4, tq, hq, hkv,
                            128, 16, lens, 0, dt)
    # the split-KV design: L_s = 256 tokens at bf16 D 128 (bs 16), 512 at
    # float32 D 32 (bs 64); lengths at the split edges L_s - 1, L_s,
    # L_s + 1, 2 L_s
    edges = [255, 256, 257, 512]
    _paged_case(gen, "split edges", 4, 1, 32, 32, 128, 16, edges, 0, bf)
    _paged_case(gen, "split edges gqa Tq4", 4, 4, 32, 8, 128, 16, edges, 0,
                bf)
    _paged_case(gen, "split edges f32 d32 bs64", 4, 1, 4, 4, 32, 64,
                [511, 512, 513, 1024], 0, f32)
    _paged_case(gen, "32768 tokens", 1, 1, 32, 32, 128, 16, [32768], 0, bf)
    _paged_case(gen, "window across splits", 4, 1, 32, 32, 128, 16,
                [300, 600, 700, 1000], 100, bf)
    # window 2 at Tq 4: the first rows attend only the split before 256,
    # the last only the one after, so each split is dead for some rows
    _paged_case(gen, "rows dead in some splits", 2, 4, 32, 8, 128, 16,
                [258, 770], 2, bf)
    _paged_case(gen, "rows dead in some splits", 2, 4, 8, 2, 64, 16,
                [514, 1026], 2, f32)
    paged_bitwise(gen)


def paged_bitwise(gen):
    """Kernel B's batch invariance: one request (1000 tokens, GQA, Tq 2,
    four splits) alone, in a batch of 4, and under a permuted block table
    gives bitwise the same o, and so do two launches."""
    B, Tq, Hq, Hkv, D, bs = 4, 2, 32, 8, 128, 16
    q, kp, vp, bt, lens = _paged_inputs(gen, B, Tq, Hq, Hkv, D, bs,
                                        [80, 1000, 529, 1100],
                                        torch.bfloat16)
    m = mk.sliding_window(900)
    full = paged_attn(q, kp, vp, bt, lens, mask=m)
    again = paged_attn(q, kp, vp, bt, lens, mask=m)
    alone = paged_attn(q[1:2].contiguous(), kp, vp,
                       bt[1:2, :-(-1000 // bs)].contiguous(), lens[1:2],
                       mask=m)
    N = kp.shape[0]
    perm = torch.cat([torch.zeros(1, dtype=torch.long, device=DEV),
                      torch.randperm(N - 1, generator=gen, device=DEV) + 1])
    kp2, vp2 = torch.empty_like(kp), torch.empty_like(vp)
    kp2[perm], vp2[perm] = kp, vp
    moved = paged_attn(q, kp2, vp2, perm[bt.long()].to(torch.int32), lens,
                       mask=m)
    check(torch.equal(full, again), "paged_decode: two launches differ")
    check(torch.equal(alone[0], full[1]),
          "paged_decode: a request alone differs from it in a batch")
    check(torch.equal(moved, full),
          "paged_decode: a permuted block table changes o")
    say(f"  B {'bitwise batch invariance':<28} bfloat16  alone == in a "
        "batch of 4 == permuted table; launch == launch")


# deepseek-v2-lite-16b's absorbed MLA (phase 12): q/k 576 (latent 512 ⊕
# rope 64), v the latent rows' first 512 columns, one kv head under 16
# query heads, scale 1/√(nope 128 + rope 64)
LAT_DK, LAT_DV, LAT_H = 576, 512, 16
LAT_SCALE = 192 ** -0.5
LAT_LENS = [1016, 716, 529, 80]     # phase 4's lengths mid-way through decode


def _latent_chunk(gen, dtype, Tq=256, Tk=1024, H=LAT_H):
    """A latent prefill chunk: q (1, Tq, H, 576) (H 16: deepseek-v2-lite's
    heads), the gathered latent rows k (1, Tk, 1, 576) and v =
    k[..., :512] (a view)."""
    q = randn(gen, (1, Tq, H, LAT_DK), dtype)
    k = randn(gen, (1, Tk, 1, LAT_DK), dtype)
    return q, k, k[..., :LAT_DV]


def _latent_pool(gen, B, Tq, lengths, dtype, H=LAT_H):
    """q (B, Tq, H, 576), a latent pool (N, 16, 1, 576) and its 512-column
    value view, a fragmented table and the lengths."""
    q, kp, _, bt, lens = _paged_inputs(gen, B, Tq, H, 1, LAT_DK, 16,
                                       lengths, dtype)
    return q, kp, kp[..., :LAT_DV], bt, lens


def latent_checks(H=LAT_H, seed=12):
    """Kernels A and B at the latent shapes with H query heads (16:
    deepseek-v2-lite's; 128: deepseek-v3's), each in both dtypes against
    its plain version at phase 3's limits: A's latent route on the serving
    chunk (Tq 256 at q_offset 768 over 1024 keys), B at the serving step
    (Tq 1) and at verify (Tq 5: 5·H rows), and B's bitwise batch
    invariance at Tq 1."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    m = mk.causal(rel_offset=768)
    tag = f"latent 576/512 h{H}/1"
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = _latent_chunk(gen, dt, H=H)
        n0 = dict(build.LAUNCHES)
        o, lse = flash_fwd(q, k, v, mask=m, scale=LAT_SCALE)
        torch.cuda.synchronize()
        check(build.LAUNCHES["flash_fwd_latent"]
              == n0["flash_fwd_latent"] + 1
              and build.LAUNCHES["flash_fwd"] == n0["flash_fwd"],
              "flash_fwd latent: launches")
        o_r, lse_r = chunk_attn_ref(q, k, v, mask=m, scale=LAT_SCALE)
        err = float((o.float() - o_r.float()).abs().max())
        lerr = float((lse - lse_r).abs().max())
        tol = TOL[dt]
        check(torch.allclose(o.float(), o_r.float(), atol=tol, rtol=tol),
              f"flash_fwd latent {dt}: o err {err} over {tol}")
        check(lerr <= LSE_TOL * (1 + float(lse_r.abs().max())),
              f"flash_fwd latent {dt}: lse err {lerr}")
        rel = ""
        if dt == torch.bfloat16:
            r = rel_err(o, o_r)
            check(r <= REL_TOL, f"flash_fwd latent: relative err {r}")
            rel = f"  rel {r:.2e} (limit {REL_TOL})"
        say(f"  A {tag + ' Tq256':<28} {str(dt)[6:]:<9} "
            f"max|Δo| {err:.3e}  max|Δlse| {lerr:.3e}  tol {tol}{rel}  "
            f"({LATENT_ROUTES[dt][0]})")
        for tq in (1, 1 + P9_DEPTH):
            q, kp, vp, bt, lens = _latent_pool(gen, 4, tq, LAT_LENS, dt, H)
            n0 = build.LAUNCHES["paged_decode"]
            o = paged_attn(q, kp, vp, bt, lens, scale=LAT_SCALE)
            torch.cuda.synchronize()
            check(build.LAUNCHES["paged_decode"] == n0 + 1,
                  "paged_decode latent: launches")
            o_r = paged_attn_ref(q, kp, vp, bt, lens, scale=LAT_SCALE)
            err = float((o.float() - o_r.float()).abs().max())
            tol = PAGED_TOL[dt]
            check(torch.allclose(o.float(), o_r.float(), atol=tol,
                                 rtol=tol),
                  f"paged_decode latent Tq{tq} {dt}: err {err} over {tol}")
            say(f"  B {f'{tag} Tq{tq}':<28} "
                f"{str(dt)[6:]:<9} max|Δo| {err:.3e}  tol {tol}")
    # bitwise batch invariance at the serving step
    q, kp, vp, bt, lens = _latent_pool(gen, 4, 1, [80, 1000, 529, 1100],
                                       torch.bfloat16, H)

    def run(q, kp, bt, lens):
        return paged_attn(q, kp, kp[..., :LAT_DV], bt, lens, scale=LAT_SCALE)
    full = run(q, kp, bt, lens)
    alone = run(q[1:2].contiguous(), kp, bt[1:2, :-(-1000 // 16)]
                .contiguous(), lens[1:2])
    N = kp.shape[0]
    perm = torch.cat([torch.zeros(1, dtype=torch.long, device=DEV),
                      torch.randperm(N - 1, generator=gen, device=DEV) + 1])
    kp2 = torch.empty_like(kp)
    kp2[perm] = kp
    moved = run(q, kp2, perm[bt.long()].to(torch.int32), lens)
    check(torch.equal(full, run(q, kp, bt, lens)),
          "paged_decode latent: two launches differ")
    check(torch.equal(alone[0], full[1]),
          "paged_decode latent: a request alone differs from it in a batch")
    check(torch.equal(moved, full),
          "paged_decode latent: a permuted block table changes o")
    say(f"  B {f'latent h{H} bitwise invariance':<28} bfloat16  alone == in a "
        "batch of 4 == permuted table; launch == launch")


# deepseek-v2-lite-16b's materialised MLA (phase 13's whole-prompt
# prefill): per head q/k 192 (nope 128 ⊕ rope 64) and v 128, 16 heads with
# a kv head each, scale 1/√192; v is the last 128 columns of the (..., 256)
# up-projection it shares with k_nope, as the model hands it over
PAIR_DK, PAIR_DV, PAIR_H = 192, 128, 16
P13_B, P13_T = 2, 4096          # phase 13's prompts


# (heads, q/k head dim, v head dim, softmax scale) of the pair route's
# cases: materialised MLA's, and zamba2's shared attention block (32 heads
# of 160, one kv head a query head)
PAIR_SHAPE = (PAIR_H, PAIR_DK, PAIR_DV, LAT_SCALE)
D160 = 160
D160_DIMS = (32, D160, D160, D160 ** -0.5)


def _pair_inputs(gen, B, Tq, Tk, dtype, dims=PAIR_SHAPE):
    """q, k, v of a pair case: v the last Dv columns of a (.., 2·Dv)
    tensor (as materialised MLA hands it over) when Dv != Dk, else a
    tensor of its own."""
    H, dk, dv, _ = dims
    q = randn(gen, (B, Tq, H, dk), dtype)
    k = randn(gen, (B, Tk, H, dk), dtype)
    if dv == dk:
        return q, k, randn(gen, (B, Tk, H, dv), dtype)
    v = randn(gen, (B, Tk, H, 2 * dv), dtype)[..., dv:]
    return q, k, v


def _fwd_count(dk, dv):
    """The launch counter of kernel A's call at q/k ``dk``, v ``dv``."""
    return "flash_fwd_pair" if dk != dv else f"flash_fwd_{dk}"


def _pair_case(gen, name, B, Tq, Tk, dtype, mask, dims=PAIR_SHAPE):
    """Kernel A's pair route (or its <160, 160> instantiation, ``dims``)
    against its plain version at phase 3's limits (o, element-wise for
    bf16, lse), the plain version run head slice by head slice; one
    launch, counted as ``flash_fwd_pair`` (or ``flash_fwd_160``).  Returns
    the inputs and the output."""
    H, dk, dv, scale = dims
    q, k, v = _pair_inputs(gen, B, Tq, Tk, dtype, dims)
    n0 = dict(build.LAUNCHES)
    o, lse = flash_fwd(q, k, v, mask=mask, scale=scale)
    torch.cuda.synchronize()
    check(all(build.LAUNCHES[n] == n0[n] + (n == _fwd_count(dk, dv))
              for n in n0), f"flash_fwd pair {name}: launches")
    refs = [chunk_attn_ref(q[:, :, sq], k[:, :, skv], v[:, :, skv],
                           mask=mask, scale=scale)
            for sq, skv in _head_slices(q, k)]
    o_r = torch.cat([r[0] for r in refs], dim=2)
    lse_r = torch.cat([r[1] for r in refs], dim=2)
    del refs
    check(o.shape == o_r.shape == (B, Tq, H, dv),
          f"flash_fwd pair {name}: o {tuple(o.shape)}")
    check(bool(torch.isfinite(o.float()).all()),
          f"flash_fwd pair {name}: non-finite")
    err = float((o.float() - o_r.float()).abs().max())
    lerr = float((lse - lse_r).abs().max())
    tol = TOL[dtype]
    check(torch.allclose(o.float(), o_r.float(), atol=tol, rtol=tol),
          f"flash_fwd pair {name}: o err {err} over {tol}")
    check(lerr <= LSE_TOL * (1 + float(lse_r.abs().max())),
          f"flash_fwd pair {name}: lse err {lerr}")
    rel = ""
    if dtype == torch.bfloat16:
        r = rel_err(o, o_r)
        check(r <= REL_TOL, f"flash_fwd pair {name}: relative err {r} over "
              f"{REL_TOL}")
        rel = f"  rel {r:.2e} (limit {REL_TOL})"
    lib = (PAIR_ROUTES if dk != dv or dtype == torch.bfloat16
           else FWD_ROUTES)[dtype][0]
    say(f"  A {f'pair {dk}/{dv} ' + name:<28} {str(dtype)[6:]:<9} max|Δo| "
        f"{err:.3e}  max|Δlse| {lerr:.3e}  tol {tol}{rel}  ({lib})")
    return (q, k, v), o, lse


def pair_checks():
    """Kernel A's pair route (q/k 192, v 128), each dtype against its plain
    version at phase 3's limits: phase 13's whole-prompt prefill (B 2,
    T 4096, 16 heads, causal), a chunk at q offset 768 (Tq 256, Tk 1024),
    a ragged T of 1000; launch == launch bitwise; pairs outside the table
    raise before a launch."""
    gen = torch.Generator(device=DEV).manual_seed(22)
    for dt in (torch.float32, torch.bfloat16):
        m = mk.causal()
        args, o, lse = _pair_case(gen, f"B{P13_B} T{P13_T} causal", P13_B,
                                  P13_T, P13_T, dt, m)
        o2, lse2 = flash_fwd(*args, mask=m, scale=LAT_SCALE)
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              f"flash_fwd pair {dt}: two launches differ")
        del args, o, lse, o2, lse2
        _pair_case(gen, "Tq256 Tk1024 q_off768", 1, 256, 1024, dt,
                   mk.causal(rel_offset=768))
        _pair_case(gen, "ragged T1000", 1, 1000, 1000, dt, mk.causal())
        say(f"  A {'pair 192/128 bitwise':<28} {str(dt)[6:]:<9} launch == "
            f"launch at B{P13_B} T{P13_T}")
    _free()
    n0 = dict(build.LAUNCHES)
    for dk, dv in ((192, 64), (160, 128), (256, 128)):
        q = torch.zeros((1, 64, 4, dk), device=DEV, dtype=torch.bfloat16)
        v = torch.zeros((1, 64, 4, dv), device=DEV, dtype=torch.bfloat16)
        try:
            flash_fwd(q, q, v, mask=mk.causal())
        except ValueError:
            continue
        raise AssertionError(f"flash_fwd took the pair {dk}/{dv}")
    check(dict(build.LAUNCHES) == n0, "a refused pair launched")
    say(f"  A {'pairs outside the table':<28} bfloat16  192/64, 160/128, "
        "256/128 raise before a launch")


def _bwd_case(gen, name, B, Tq, Tk, Hq, Hkv, D, dtype, mask, segs=False,
              pass_delta=False):
    """Kernels C and D against the plain backward on the same saved (o,
    lse), and the pruned sweep against the dense one."""
    q = randn(gen, (B, Tq, Hq, D), dtype)
    k = randn(gen, (B, Tk, Hkv, D), dtype)
    v = randn(gen, (B, Tk, Hkv, D), dtype)
    do = randn(gen, (B, Tq, Hq, D), dtype)
    kw = {}
    if segs:
        s = torch.sort(torch.randint(0, 4, (B, Tk), generator=gen,
                                     device=DEV), dim=1)[0].to(torch.int32)
        kw = dict(q_segments=s[:, :Tq].contiguous(), kv_segments=s)
    o, lse = chunk_attn_ref(q, k, v, mask=mask, **kw)
    if pass_delta:
        kw["delta"] = (o.float() * do.float()).sum(-1)
    n0 = (build.LAUNCHES["flash_bwd_dq"], build.LAUNCHES["flash_bwd_dkv"])
    got = flash_bwd(q, k, v, o, lse, do, mask=mask, **kw)
    torch.cuda.synchronize()
    check((build.LAUNCHES["flash_bwd_dq"], build.LAUNCHES["flash_bwd_dkv"])
          == (n0[0] + 1, n0[1] + 1), f"flash_bwd {name}: launches")
    ref = chunk_attn_bwd_ref(q, k, v, o, lse, do, mask=mask, **kw)
    dense = flash_bwd(q, k, v, o, lse, do, mask=mask, prune=False, **kw)
    tol = BWD_TOL[dtype]
    errs, rels = [], []
    for nm, a, r, d in zip(("dq", "dk", "dv"), got, ref, dense):
        check(a.shape == r.shape and a.dtype == r.dtype,
              f"flash_bwd {name}: {nm} {tuple(a.shape)} {a.dtype}")
        check(bool(torch.isfinite(a.float()).all()),
              f"flash_bwd {name}: {nm} non-finite")
        err = float((a.float() - r.float()).abs().max())
        check(torch.allclose(a.float(), r.float(), atol=tol, rtol=tol),
              f"flash_bwd {name}: {nm} err {err} over {tol}")
        pd = float((a.float() - d.float()).abs().max())
        check(pd <= 1e-6, f"flash_bwd {name}: {nm} pruned vs dense {pd}")
        errs.append(err)
        if dtype == torch.bfloat16:
            rels.append(row_rel_err(a, r))
            check(rels[-1] <= ROW_TOL, f"flash_bwd {name}: {nm} per-row "
                  f"relative err {rels[-1]} over {ROW_TOL}")
    rel = (f"; row {'/'.join(f'{x:.2e}' for x in rels)} (limit {ROW_TOL})"
           if rels else "")
    say(f"  C/D {name:<26} {str(dtype)[6:]:<9} max|Δdq| {errs[0]:.3e}  "
        f"max|Δdk| {errs[1]:.3e}  max|Δdv| {errs[2]:.3e}  tol {tol}; "
        f"pruned == dense{rel}")


def bwd_checks():
    """Kernels C and D over the edge cases kernel A is held to, plus the
    training shape."""
    gen = torch.Generator(device=DEV).manual_seed(4)
    bf, f32 = torch.bfloat16, torch.float32
    # every edge case on both routes: float32 (CUDA cores), bf16 (wgmma)
    for dt in (f32, bf):
        _bwd_case(gen, "causal d128", 1, 256, 256, 4, 4, 128, dt,
                  mk.causal())
        _bwd_case(gen, "sliding_window 70 d64", 1, 256, 256, 4, 1, 64, dt,
                  mk.sliding_window(70))
        _bwd_case(gen, "prefix_lm 70 d32", 1, 192, 192, 4, 2, 32, dt,
                  mk.prefix_lm(70))
        _bwd_case(gen, "document boundaries", 1, 256, 256, 4, 4, 64, dt,
                  mk.document(boundaries=(0, 37, 150, 151)))
        _bwd_case(gen, "document segments gqa", 2, 128, 256, 4, 2, 32, dt,
                  mk.document(), segs=True)
        _bwd_case(gen, "gqa Hkv2 Tq!=Tk offset", 2, 100, 300, 8, 2, 64, dt,
                  mk.causal(rel_offset=200))
        _bwd_case(gen, "empty rows q_offset -64", 1, 128, 128, 2, 2, 32, dt,
                  mk.causal(rel_offset=-64))
        _bwd_case(gen, "full kv_offset, delta in", 1, 64, 200, 4, 4, 32, dt,
                  mk.MaskSpec(q_offset=10, kv_offset=3), pass_delta=True)
    _bwd_case(gen, "window gqa bf16", 1, 512, 512, 32, 8, 128, bf,
              mk.sliding_window(300))
    _bwd_case(gen, "train B1 T2048 H32 causal", 1, 2048, 2048, 32, 32, 128,
              bf, mk.causal())
    _bwd_case(gen, "train B1 T2048 H32 causal", 1, 2048, 2048, 32, 32, 128,
              f32, mk.causal())
    # statically fully masked chunk: zeros without a launch
    q = randn(gen, (1, 128, 2, 32), f32)
    m = mk.causal(rel_offset=-1000)
    o, lse = chunk_attn_ref(q, q, q, mask=m)
    n0 = build.LAUNCHES["flash_bwd_dq"] + build.LAUNCHES["flash_bwd_dkv"]
    g = flash_bwd(q, q, q, o, lse, q, mask=m)
    check(build.LAUNCHES["flash_bwd_dq"] + build.LAUNCHES["flash_bwd_dkv"]
          == n0 and all(float(x.abs().max()) == 0 for x in g),
          "empty chunk launched the backward")
    # the autograd glue: FlashAttnFn's gradients are flash_bwd's
    q, k, v = (randn(gen, (1, 128, 4, 64), f32).requires_grad_()
               for _ in range(3))
    do = randn(gen, (1, 128, 4, 64), f32)
    m = mk.causal()
    o, _ = FlashAttnFn.apply(
        q, k, v, lambda *a: flash_fwd(*a, mask=m),
        lambda *a: flash_bwd(*a, mask=m))
    got = torch.autograd.grad(o, (q, k, v), do)
    o_r, lse_r = chunk_attn_ref(q.detach(), k.detach(), v.detach(), mask=m)
    ref = chunk_attn_bwd_ref(q.detach(), k.detach(), v.detach(), o_r, lse_r,
                             do, mask=m)
    d = max(float((a - r).abs().max()) for a, r in zip(got, ref))
    check(d <= 2e-4, f"FlashAttnFn grads vs plain: {d}")
    say(f"  C/D {'FlashAttnFn autograd':<26} float32   max|Δ| {d:.3e}  "
        f"tol 0.0002")


def _bwd_bar(a, r, dtype):
    """Phase 3's bar on one backward output: element-wise BWD_TOL, and for
    bf16 also ROW_TOL row by row.  Returns (passes, max |Δ|, per-row
    relative error or None)."""
    tol = BWD_TOL[dtype]
    ok = torch.allclose(a.float(), r.float(), atol=tol, rtol=tol)
    err = float((a.float() - r.float()).abs().max())
    row = row_rel_err(a, r) if dtype == torch.bfloat16 else None
    return ok and (row is None or row <= ROW_TOL), err, row


def _pair_bwd_ref(args, kw, cut=None):
    """The plain backward of a pair case head slice by head slice (each
    (h, T, T) float32 tensor at most 2.1 GB); ``cut`` drops every key from
    that index on (dk and dv of those keys read 0): the control."""
    q, k, v, o, lse, do = args
    out = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]
    for sq, skv in _head_slices(q, k):
        (qs, ks, vs, os_, ls, ds), kws = _bwd_slice(args, kw, sq, skv)
        if cut is not None:
            ks, vs = ks[:, :cut], vs[:, :cut]
            if "kv_segments" in kws:
                kws["kv_segments"] = kws["kv_segments"][:, :cut]
        g = chunk_attn_bwd_ref(qs, ks, vs, os_, ls, ds, **kws)
        out[0][:, :, sq] = g[0]
        for i in (1, 2):
            out[i][:, :, skv] = 0
            out[i][:, :g[i].shape[1], skv] = g[i]
    return out


def _pair_bwd_case(gen, name, B, Tq, Tk, dtype, mask, v_kind="kv",
                   segs=False, repeat=False, dims=PAIR_SHAPE):
    """Kernels C and D at q/k 192, v 128 (materialised MLA, 16 heads,
    scale 1/√192), or at ``dims`` (zamba2's 32 heads of 160), against the
    plain backward on the same saved (o, lse) (kernel A's pair route) at
    phase 3's bar, which must reject the plain backward without the last
    64-key tile; the pruned sweep equals the dense one; with ``repeat``, a
    second launch gives the same bits.  v is the last Dv columns of a
    (.., 2·Dv) tensor (``kv``, as the model hands it over) or a tensor of
    its own (``own``)."""
    H, dk, dv, scale = dims
    q = randn(gen, (B, Tq, H, dk), dtype)
    k = randn(gen, (B, Tk, H, dk), dtype)
    if v_kind == "kv":
        v = randn(gen, (B, Tk, H, 2 * dv), dtype)[..., dv:]
    else:
        v = randn(gen, (B, Tk, H, dv), dtype)
    do = randn(gen, (B, Tq, H, dv), dtype)
    kw = dict(mask=mask, scale=scale)
    counts = (("flash_bwd_dq", "flash_bwd_dkv") if dk != dv else
              (f"flash_bwd_dq_{dk}", f"flash_bwd_dkv_{dk}"))
    if segs:
        s = torch.sort(torch.randint(0, 4, (B, Tk), generator=gen,
                                     device=DEV), dim=1)[0].to(torch.int32)
        kw.update(q_segments=s[:, :Tq].contiguous(), kv_segments=s)
    o, lse = flash_fwd(q, k, v, **kw)
    n0 = dict(build.LAUNCHES)
    got = flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    check(all(build.LAUNCHES[n] == n0[n] + (n in counts) for n in n0),
          f"flash_bwd pair {name}: launches")
    same = ""
    if repeat:     # a fixed sweep order and no atomics: the same bits
        again = flash_bwd(q, k, v, o, lse, do, **kw)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash_bwd pair {name}: two launches differ")
        same = "; launch == launch bitwise"
        del again
    dense = flash_bwd(q, k, v, o, lse, do, prune=False, **kw)
    args = (q, k, v, o, lse, do)
    ref = _pair_bwd_ref(args, kw)
    errs, rows = [], []
    for nm, a, r, d in zip(("dq", "dk", "dv"), got, ref, dense):
        check(a.shape == r.shape and a.dtype == r.dtype and
              a.is_contiguous(), f"flash_bwd pair {name}: {nm} "
              f"{tuple(a.shape)} {a.dtype}")
        check(bool(torch.isfinite(a.float()).all()),
              f"flash_bwd pair {name}: {nm} non-finite")
        ok, err, row = _bwd_bar(a, r, dtype)
        check(ok, f"flash_bwd pair {name}: {nm} err {err} row {row}")
        pd = float((a.float() - d.float()).abs().max())
        check(pd <= 1e-6, f"flash_bwd pair {name}: {nm} pruned vs dense {pd}")
        errs.append(err)
        rows.append(row)
    del dense
    bad = _pair_bwd_ref(args, kw, cut=Tk - 64)
    ctl = [_bwd_bar(b, r, dtype) for b, r in zip(bad, ref)]
    check(not any(c[0] for c in ctl), f"flash_bwd pair {name}: the bar "
          f"does not reject the plain backward without the last key tile "
          f"({ctl})")
    show = (lambda c: f"{c[2]:.2e}" if c[2] is not None else f"{c[1]:.2e}")
    rel = (f"; row {'/'.join(f'{x:.2e}' for x in rows)} (limit {ROW_TOL})"
           if dtype == torch.bfloat16 else "")
    say(f"  C/D {f'{dk}/{dv} ' + name:<30} {str(dtype)[6:]:<9} max|Δdq| "
        f"{errs[0]:.3e}  max|Δdk| {errs[1]:.3e}  max|Δdv| {errs[2]:.3e}  "
        f"tol {BWD_TOL[dtype]}; pruned == dense{same}{rel}; control without "
        f"the last key tile {'/'.join(show(c) for c in ctl)} (rejected)")
    return errs


PAIR_BWD_CASES = (
    # (name, B, Tq, Tk, mask, v, segments): phase 14's training shape (its
    # two launches also compared bit for bit), a ragged T, a document mask
    # with segment ids, a chunk at q offset 768
    ("train B1 T8192 causal v-view", 1, 8192, 8192, mk.causal(), "kv", False),
    ("ragged T1000 causal", 1, 1000, 1000, mk.causal(), "own", False),
    ("document segments v-view", 2, 512, 512, mk.document(), "kv", True),
    ("Tq256 Tk1024 q_off768 v-view", 1, 256, 1024, mk.causal(rel_offset=768),
     "kv", False),
)


def pair_bwd_checks():
    """Kernels C and D at materialised MLA's q/k 192, v 128 in both dtypes
    (bf16 on the tensor cores, the pair library; float32 on the CUDA cores)
    over ``PAIR_BWD_CASES``, each held to its plain version at phase 3's
    bar, which must reject the control, the training shape's two launches
    bitwise equal; other (Dk, Dv) pairs and the latent pair raise before a
    launch."""
    gen = torch.Generator(device=DEV).manual_seed(23)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        for name, B, Tq, Tk, m, vk, segs in PAIR_BWD_CASES:
            e = _pair_bwd_case(gen, name, B, Tq, Tk, dt, m, vk, segs,
                               repeat=name.startswith("train"))
            errs[(name, dt)] = e
            _free()
    n0 = dict(build.LAUNCHES)
    for dt in (torch.float32, torch.bfloat16):
        for dk, dv in ((192, 64), (160, 128), (128, 192), (576, 512)):
            q = torch.zeros((1, 64, 4, dk), device=DEV, dtype=dt)
            v = torch.zeros((1, 64, 4, dv), device=DEV, dtype=dt)
            lse = torch.zeros((1, 64, 4), device=DEV)
            try:
                flash_bwd(q, q, v, v, lse, v, mask=mk.causal())
            except ValueError:
                continue
            raise AssertionError(f"flash_bwd took the pair {dk}/{dv}")
    check(dict(build.LAUNCHES) == n0, "a refused backward pair launched")
    say(f"  C/D {'pairs outside the table':<30} both      192/64, 160/128, "
        "128/192, 576/512 raise before a launch")
    return errs


D160_BWD_CASES = (
    # (name, B, Tq, Tk, heads, mask, segments): zamba2's training shape (its
    # two launches also compared bit for bit), a ragged T, a document mask
    # with segment ids, a chunk at q offset 768
    ("train B1 T8192 H32 causal", 1, 8192, 8192, 32, mk.causal(), False),
    ("ragged T1000 causal", 1, 1000, 1000, 4, mk.causal(), False),
    ("document segments", 2, 512, 512, 4, mk.document(), True),
    ("Tq256 Tk1024 q_off768", 1, 256, 1024, 4, mk.causal(rel_offset=768),
     False),
)


def d160_checks():
    """Kernels A, C and D at head dim 160 (zamba2-2.7b's shared attention
    block, scale 1/√160) in both dtypes: bf16 through the pair libraries'
    <160, 160> instantiations (three 64-column slabs, the last half zeros),
    float32 through ``flash_fwd.cu`` / ``flash_bwd.cu`` at 160.  A at B1
    T8192 H32 causal, zamba2's training shape (launch == launch bitwise),
    a q-offset chunk and a ragged T; C and D over ``D160_BWD_CASES`` at phase 3's bars, which must
    reject the control without the last key tile; one head dims the
    kernels do not take (144, 176, 256) raise before a launch.  Returns
    the backward's errors by (case, dtype)."""
    gen = torch.Generator(device=DEV).manual_seed(30)
    H, _, _, scale = D160_DIMS
    small = (4,) + D160_DIMS[1:]
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        m = mk.causal()
        args, o, lse = _pair_case(gen, D160_BWD_CASES[0][0], 1, P21_T,
                                  P21_T, dt, m, dims=D160_DIMS)
        o2, lse2 = flash_fwd(*args, mask=m, scale=scale)
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              f"flash_fwd 160 {dt}: two launches differ")
        del args, o, lse, o2, lse2
        _pair_case(gen, "Tq256 Tk1024 q_off768", 1, 256, 1024, dt,
                   mk.causal(rel_offset=768), dims=small)
        _pair_case(gen, "ragged T1000", 1, 1000, 1000, dt, mk.causal(),
                   dims=small)
        say(f"  A {'160/160 bitwise':<28} {str(dt)[6:]:<9} launch == launch "
            f"at B1 T{P21_T} H32")
        for name, B, Tq, Tk, h, m, segs in D160_BWD_CASES:
            errs[(name, dt)] = _pair_bwd_case(
                gen, name, B, Tq, Tk, dt, m, "own", segs,
                repeat=name.startswith("train"), dims=(h,) + D160_DIMS[1:])
            _free()
    n0 = dict(build.LAUNCHES)
    for dt in (torch.float32, torch.bfloat16):
        for d in (144, 176, 256):
            q = torch.zeros((1, 64, 4, d), device=DEV, dtype=dt)
            lse = torch.zeros((1, 64, 4), device=DEV)
            for call in (lambda: flash_fwd(q, q, q, mask=mk.causal()),
                         lambda: flash_bwd(q, q, q, q, lse, q,
                                           mask=mk.causal())):
                try:
                    call()
                except ValueError:
                    continue
                raise AssertionError(f"a flash kernel took head dim {d}")
    check(dict(build.LAUNCHES) == n0, "a refused head dim launched")
    say(f"  A/C/D {'head dims outside the table':<26} both      144, 176, "
        "256 raise before a launch")
    return errs


# ---------------------------------------------------------------- phase 3d

P3D_RANKS = 4
P3D_TIMEOUT = 300
P3D_REPS = 20
# the sizes timed: phase 18's head all_to_all (64 MiB a rank: llama-7b's
# q of 8,192 tokens, 32 heads × 128, bf16) and phase 16's decode
# all-reduce (the flash-decoding numerator and denominator of one token,
# 16 heads over the 512-column latent, float32)
P3D_A2A = (1, 8192, 32, 128)
P3D_REDUCE = ((1, 16, 1, 512), (1, 16, 1))


def _p3d_inputs(rank):
    """This rank's seeded tensors: small ones of several dtypes and shapes,
    and ones past the mailbox cap."""
    from repro_torch.parallel.comm import MAILBOX_CAP
    gen = torch.Generator(device=DEV).manual_seed(300 + rank)

    def r(shape, dtype):
        return torch.randn(shape, generator=gen, device=DEV).to(dtype)
    big = MAILBOX_CAP // 2 + 4096           # bf16 elements: past one slot
    return dict(small=[r((4, 1000, 7), torch.bfloat16), r((5,), torch.float32),
                       r((8, 33), torch.float32)],
                big=r((big,), torch.bfloat16),
                a2a=r((P3D_RANKS * 3, 513, 2), torch.bfloat16),
                a2a_big=r((P3D_RANKS, MAILBOX_CAP // 2 // P3D_RANKS * 3
                           + 100), torch.bfloat16),
                red=[r((1000, 37), torch.float32), r((64, 129), torch.bfloat16),
                     r((3,), torch.float32)],
                red_big=r((MAILBOX_CAP // 4 + 1000,), torch.float32))


def _p3d_run(comm, x):
    """Every collective of ``comm`` on this rank's inputs ``x``: results on
    the host."""
    out = {}
    for h in (1, -1, 2):
        out[f"shift{h}"] = [t.cpu() for t in comm.shift(x["small"], h).wait()]
    out["shift_big"] = comm.shift([x["big"], x["small"][0]], 1).wait()[0].cpu()
    out["a2a"] = comm.all_to_all(x["a2a"], 0, 1).cpu()
    out["a2a_big"] = comm.all_to_all(x["a2a_big"], 0, 1).cpu()
    out["gather"] = comm.all_gather(x["small"][2], 1).cpu()
    out["gather_big"] = comm.all_gather(x["big"], 0).cpu()
    out["bcast"] = [t.cpu() for t in comm.broadcast_(
        [t.clone() for t in x["small"]], 2)]
    out["sum"] = [t.cpu() for t in comm.all_reduce_(
        [t.clone() for t in x["red"]])]
    out["max"] = [t.cpu() for t in comm.all_reduce_(
        [t.clone() for t in x["red"]], op="max")]
    out["sum_big"] = comm.all_reduce_([x["red_big"].clone()])[0].cpu()
    out["rscatter"] = comm.reduce_scatter(x["a2a"], 0).cpu()
    out["rscatter_big"] = comm.reduce_scatter(x["a2a_big"], 1).cpu()
    torch.cuda.synchronize()
    return out


def _p3d_time(comm, fn, reps=P3D_REPS):
    fn()
    torch.cuda.synchronize()
    comm.group and torch.distributed.barrier(group=comm.group)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


@contextlib.contextmanager
def _wrong_peer():
    """Planted transport fault: every read of a peer's mailbox reads the
    next peer's."""
    from repro_torch.parallel import comm as cm
    base = cm.Comm._peer_slot

    def wrong(self, box, i, s):
        return base(self, box, (i + 1) % self.size, s)
    cm.Comm._peer_slot = wrong
    try:
        yield
    finally:
        cm.Comm._peer_slot = base


def _p3d_rank(rank):
    """One rank of phase 3d's world: every collective under cuda-ipc and
    gloo-staged on the same inputs, the inputs all-gathered (for the
    float64 sums), cuda-ipc again under the planted fault, and times."""
    ipc = make_local_mesh(seq=P3D_RANKS, device=DEV).comms["model"]
    stg = make_local_mesh(seq=P3D_RANKS, device=DEV,
                          transport="gloo-staged").comms["model"]
    x = _p3d_inputs(rank)
    out = {"rank": rank, "transports": (ipc.transport, stg.transport)}
    out["ipc"] = _p3d_run(ipc, x)
    out["staged"] = _p3d_run(stg, x)
    out["inputs"] = dict(red=[stg.all_gather(t[None], 0).cpu()
                              for t in x["red"]],
                         red_big=stg.all_gather(x["red_big"][None], 0).cpu())
    with _wrong_peer():
        out["fault"] = _p3d_run(ipc, x)
    a2a = torch.randn(P3D_A2A, generator=torch.Generator(device=DEV)
                      .manual_seed(rank), device=DEV).to(torch.bfloat16)
    red = [torch.rand(s, device=DEV) for s in P3D_REDUCE]
    out["ms"] = {}
    for name, c in (("cuda-ipc", ipc), ("gloo-staged", stg)):
        out["ms"][name] = dict(
            a2a=_p3d_time(c, lambda: c.all_to_all(a2a, 2, 1)),
            reduce=_p3d_time(c, lambda: c.all_reduce_(red)),
            shift=_p3d_time(c, lambda: c.shift([a2a], 1).wait()))
    return out


def _bitwise(a, b):
    if isinstance(a, list):
        return len(a) == len(b) and all(_bitwise(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(-1).view(torch.uint8) if a.dtype != torch.bool else a,
        b.view(-1).view(torch.uint8) if b.dtype != torch.bool else b)


def _p3d_sum_err(got, parts):
    """max |got − Σ parts (float64)| over the float32 rounding bound
    P · 2^-24 · Σ|parts| (+ one rounding of got's own dtype)."""
    exact = parts.double().sum(0)
    ulp = 2.0 ** -8 if got.dtype == torch.bfloat16 else 2.0 ** -24
    bound = (parts.shape[0] * 2.0 ** -24 * parts.double().abs().sum(0)
             + ulp * exact.abs() + 1e-30)
    return float(((got.double() - exact).abs() / bound).max())


def transport_checks():
    """Phase 3d: the cuda-ipc transport on 4 ranks sharing the card against
    gloo-staged, on the same seeded inputs: shifts (hops 1, -1, 2),
    all_to_all, all_gather, broadcast_ and reduce_scatter bitwise;
    all_reduce_ (sum and max) bitwise equal across the ranks and each sum
    within its float32 rounding bound of the float64 sum of the ranks'
    inputs; messages past
    the mailbox cap (a shift, an all_to_all, an all_gather and an
    all-reduce) arrive whole.  A planted fault (every read of a peer's
    mailbox reads the next peer's) must break the bitwise checks.  Times
    each transport at phase 18's 64 MiB all_to_all and shift and phase
    16's decode all-reduce."""
    t0 = time.perf_counter()
    res = spawn(_p3d_rank, P3D_RANKS, (), device=DEV, timeout=P3D_TIMEOUT)
    check(all(r["transports"] == ("cuda-ipc", "gloo-staged") for r in res),
          f"transports {[r['transports'] for r in res]}")
    scatters = ("rscatter", "rscatter_big")
    copies = [k for k in res[0]["ipc"] if k not in ("sum", "max",
                                                     "sum_big") + scatters]
    for r in res:
        for k in copies:
            check(_bitwise(r["ipc"][k], r["staged"][k]),
                  f"rank {r['rank']}: cuda-ipc's {k} is not gloo-staged's")
        for k in ("sum", "max", "sum_big"):
            check(_bitwise(r["ipc"][k], res[0]["ipc"][k]),
                  f"rank {r['rank']}: cuda-ipc's {k} differs from rank 0's")
        check(_bitwise(r["ipc"]["max"], r["staged"]["max"]),
              f"rank {r['rank']}: cuda-ipc's max is not gloo-staged's")
        # both sum the ranks' blocks in rank order in float32: the same
        # bits (a rotated read order would round the same set alike, so
        # the wrong-peer fault is not asked to break these)
        for k in scatters:
            check(_bitwise(r["ipc"][k], r["staged"][k]),
                  f"rank {r['rank']}: cuda-ipc's {k} is not gloo-staged's")
    ins = res[0]["inputs"]
    errs = [_p3d_sum_err(g, p) for g, p in zip(res[0]["ipc"]["sum"],
                                               ins["red"])]
    errs.append(_p3d_sum_err(res[0]["ipc"]["sum_big"], ins["red_big"]))
    staged = [_p3d_sum_err(g, p) for g, p in zip(res[0]["staged"]["sum"],
                                                 ins["red"])]
    check(max(errs) <= 1.0, f"cuda-ipc sums off their float64 sums by "
          f"{max(errs):.3f} of the rounding bound")
    diff = sum(not _bitwise(r["ipc"][k], r["staged"][k]) for r in res
               for k in ("sum", "sum_big"))
    caught = [k for k in copies
              if any(not _bitwise(r["fault"][k], r["staged"][k])
                     for r in res)]
    check(set(caught) == set(copies),
          f"the wrong-peer fault passes {sorted(set(copies) - set(caught))}")
    say(f"  cuda-ipc: {len(copies)} transfers bitwise gloo-staged's on 4 "
        f"ranks (shifts, all_to_all, all_gather, broadcast_, max; past the "
        f"{MAILBOX_CAP >> 20} MiB slot too); sums equal on every rank, "
        f"within {max(errs):.3f} of their float32 rounding bound "
        f"(gloo-staged {max(staged):.3f}); {diff} of 8 sum results differ "
        f"from gloo-staged's bitwise; reduce_scatter (bf16, and past the "
        f"slot) bitwise gloo-staged's; the wrong-peer fault breaks "
        f"{len(caught)} of {len(copies)}")
    for name in ("cuda-ipc", "gloo-staged"):
        ms = {k: max(r["ms"][name][k] for r in res)
              for k in res[0]["ms"][name]}
        say(f"  {name}: all_to_all of {_mib(P3D_A2A)} MiB {ms['a2a']:.3f} "
            f"ms, shift of it {ms['shift']:.3f} ms, decode all-reduce "
            f"{ms['reduce']:.3f} ms (slowest rank, mean of {P3D_REPS})")
    say(f"  phase 3d took {time.perf_counter() - t0:.1f} s")
    return res


def _mib(shape, nbytes=2):
    return int(np.prod(shape)) * nbytes / 2 ** 20


# ----------------------------------------------------------------- phase 4

P4_LENS, P4_NEW = (1000, 700, 513, 64), 32
P4_ENGINE = dict(max_batch=4, block_size=16, prefill_chunk_tokens=256,
                 n_blocks=192)


@contextlib.contextmanager
def _meter(model, eng, router=None):
    """While the block runs: the logits of every decode and verify row of
    ``eng``'s target ``model`` under (rid, context position of the token the
    row predicts), kept on the device without a copy (a later row at a
    position replaces an earlier one, so a committed position ends up with
    the row that committed it); and the kernel launches inside the target's
    decode / verify calls and inside the engine's ``draft.propose``, apart,
    and the host seconds in ``draft.propose`` (it ends in a host read).
    With a ``router`` (phase 12's :class:`_Router`) each target call tells
    it which rows it runs: a chunk's valid rows, or each decode / verify
    row's logits key."""
    rec = {"logits": {}, "target": dict.fromkeys(build.LAUNCHES, 0),
           "draft": dict.fromkeys(build.LAUNCHES, 0), "draft_s": 0.0}
    live = []
    rows = eng._rows

    def noting(lv, T):
        live[:] = lv
        return rows(lv, T)

    def counted(key, fn, keep):
        def run(*a):
            n0 = dict(build.LAUNCHES)
            t0 = time.perf_counter()
            if keep and router is not None:
                T = a[2].shape[1]
                router.begin([(r.slot * T + t, (r.rid, r.cached + 1 + t))
                              for r in live for t in range(T)])
            out = fn(*a)
            if keep and router is not None:
                router.end()
            if key == "draft":       # proposals end in a host read
                rec["draft_s"] += time.perf_counter() - t0
            for k, n in n0.items():
                rec[key][k] += build.LAUNCHES[k] - n
            if keep:
                for r in live:
                    for t in range(out.shape[1]):
                        rec["logits"][(r.rid, r.cached + 1 + t)] = \
                            out[r.slot, t]
            return out
        return run

    def chunk(fn):
        def run(*a):
            router.begin_chunk(int(a[4]))      # its n_valid rows
            fn(*a)
            router.end()
        return run

    draft = eng.draft
    eng._rows = noting
    saved = {k: model.__dict__.get(k)
             for k in ("decode", "verify", "prefill_chunk")}
    model.decode = counted("target", model.decode, True)
    model.verify = counted("target", model.verify, True)
    if router is not None:
        model.prefill_chunk = chunk(model.prefill_chunk)
    if draft is not None:
        draft.propose = counted("draft", draft.propose, False)
    try:
        yield rec
    finally:
        del eng._rows
        if draft is not None:
            del draft.propose
        for k, fn in saved.items():
            if fn is None:
                model.__dict__.pop(k, None)
            else:
                setattr(model, k, fn)


def serve():
    cfg = get_config("llama-7b")
    model = DecoderLM(cfg, device=DEV)
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    say(f"  init {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.attn.n_heads}x{cfg.attn.head_dim} {cfg.dtype} "
        f"({cfg.param_count() / 1e9:.2f} B params) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    lens, n_new = P4_LENS, P4_NEW
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    kw = P4_ENGINE

    # warm-up (cuBLAS handles, allocator) on a short request
    warm = Engine(model, params, **kw)
    warm.submit(prompts[3], max_new_tokens=2)
    warm.run()
    del warm

    eng = Engine(model, params, **kw)
    torch.cuda.synchronize()
    build.reset_launches()
    with _meter(model, eng) as rec:
        t_sub = time.perf_counter()
        rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        ttft = {}
        while not eng.sched.idle:
            ev = eng.step()
            now = time.perf_counter()
            for rid in ev:
                ttft.setdefault(rid, now - t_sub)
        total = time.perf_counter() - t_sub
    launches = dict(build.LAUNCHES)
    out = {rid: np.asarray(eng.requests[rid].emitted) for rid in rids}
    st = eng.stats()
    spent = {"prefill": st["prefill_seconds"], "decode": st["decode_seconds"]}
    for name in ("flash_fwd", "paged_decode"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the serving path")
    for rid in rids:
        check(len(out[rid]) == n_new, f"request {rid} emitted {len(out[rid])}")
        check(bool(((out[rid] >= 0) & (out[rid] < cfg.vocab)).all()),
              f"request {rid}: token outside the vocabulary")
    say(f"  served {len(rids)} requests: prefill {st['prefill_tokens']} "
        f"tokens in {st['prefill_chunks']} chunks, decode "
        f"{st['decode_tokens']} tokens in {st['decode_steps']} steps, "
        f"{st['steps']} engine steps, {total:.3f} s")
    say(f"  launches on the main path: {launches}")
    say(f"  prefill {st['prefill_tokens'] / spent['prefill']:.1f} tok/s "
        f"({spent['prefill']:.3f} s), decode "
        f"{st['decode_tokens'] / spent['decode']:.1f} tok/s "
        f"({spent['decode']:.3f} s, "
        f"{1e3 * spent['decode'] / st['decode_steps']:.2f} ms/step)")
    say("  time to first token (ms, submit -> first token): "
        + ", ".join(f"{n}-token prompt {1e3 * ttft[r]:.1f}"
                    for n, r in zip(lens, rids)))

    # the longest request's last decode logits against a plain forward
    rid = rids[0]
    ctx = torch.from_numpy(np.concatenate([prompts[0], out[rid][:-1]])[None])
    ctx = ctx.to(DEV)
    ref = model.forward(params, ctx, last_only=True)[0, -1].float()
    got = rec["logits"][(rid, lens[0] + n_new - 1)].float()
    d = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    check(bool(torch.isfinite(got).all()), "non-finite serving logits")
    check(d <= LOGIT_REL_TOL * scale,
          f"serving logits vs plain forward: max|Δ| {d} > "
          f"{LOGIT_REL_TOL} × {scale}")
    say(f"  last logits of the {lens[0]}-token request vs plain forward: "
        f"max|Δ| {d:.4f} (max|logit| {scale:.3f}, tol {LOGIT_REL_TOL} × "
        f"max = {LOGIT_REL_TOL * scale:.4f}), argmax {int(got.argmax())} "
        f"vs {int(ref.argmax())}")
    logit_controls(model, params, ctx, ref, LOGIT_REL_TOL * scale)
    steps = max(st["decode_steps"], 1)
    say("== phase 4b: where the device time goes")
    trace(model, params, prompts)
    return dict(launches=launches, cfg=cfg, model=model, params=params,
                prompts=prompts,
                per_decode_step=launches["paged_decode"] / steps,
                per_chunk=launches["flash_fwd"] / max(st["prefill_chunks"], 1),
                prefill_tok_s=st["prefill_tokens"] / spent["prefill"],
                decode_tok_s=st["decode_tokens"] / spent["decode"],
                ttft_ms=[1e3 * ttft[r] for r in rids])


def _kernels(prof):
    """Device time by kernel name in a torch.profiler trace, {name:
    (launches, µs)}, summed once a trace from its raw device events (the
    profiler's own tables build an event for every host operator too:
    seconds for a traced step of 37,659 launches)."""
    if not hasattr(prof, "_by_kernel"):
        from torch.autograd import DeviceType
        res = prof.profiler.kineto_results
        out = {}
        for ev in res.events() if res is not None else ():
            if ev.device_type() == DeviceType.CUDA:
                n, us = out.get(ev.name(), (0, 0.0))
                out[ev.name()] = (n + 1,
                                  us + (ev.end_ns() - ev.start_ns()) / 1e3)
        prof._by_kernel = out
    return prof._by_kernel


def _device_breakdown(prof, wall):
    """Device time by kernel family from a torch.profiler trace, and the
    share of the wall clock the device was busy."""
    fam = {}
    for name, (count, us) in _kernels(prof).items():
        key = ("kernel A flash_fwd" if "flash_fwd" in name else
               "kernel B paged_decode" if "paged_decode" in name else
               "kernel C flash_bwd_dq" if "flash_bwd_dq" in name else
               "kernel D flash_bwd_dkv" if "flash_bwd_dkv" in name else
               "matmul (cuBLAS)" if any(t in name.lower() for t in
                                        ("gemm", "gemv", "xmma", "cutlass",
                                         "splitk", "nvjet"))
               else "other (elementwise, copies, index_put)")
        n, t = fam.get(key, (0, 0.0))
        fam[key] = (n + count, t + us / 1e3)
    busy = sum(t for _, t in fam.values())
    return fam, busy, 1e3 * wall


def trace(model, params, prompts):
    """torch.profiler over the first 4 engine steps (prefill-heavy) and 6
    decode-only steps of the same 4 requests; returns each trace's idle
    share by label (nan: not measured)."""
    from torch.profiler import ProfilerActivity, profile
    eng = Engine(model, params, **P4_ENGINE)
    rids = [eng.submit(p, max_new_tokens=16) for p in prompts]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    idle = {}
    for label, cond in (("prefill steps 1-4", lambda i: i < 4),
                        ("6 decode-only steps", lambda i: i < 6)):
        if label.startswith("6"):
            while any(eng.requests[r].state != "decode" for r in rids):
                eng.step()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            i = 0
            while cond(i):
                eng.step()
                i += 1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        idle[label] = show_breakdown(label, prof, wall)
    return idle


def show_breakdown(label, prof, wall):
    """Prints the device time by kernel family; returns the idle share, or
    nan where the trace holds no device kernel (not measured)."""
    fam, busy, wall_ms = _device_breakdown(prof, wall)
    if not fam:
        say(f"  trace {label}: wall {wall_ms:.1f} ms (under the profiler); "
            "the profiler recorded no device kernel, idle share not measured")
        return float("nan")
    say(f"  trace {label}: wall {wall_ms:.1f} ms (under the profiler), "
        f"device busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}")
    for key, (n, t) in sorted(fam.items(), key=lambda kv: -kv[1][1]):
        say(f"    {key:<40} {t:9.2f} ms  {n:6d} launches  "
            f"{t / wall_ms:.3f} of wall")
    return 1 - busy / wall_ms


def logit_controls(model, params, ctx, ref, limit):
    """Plain forwards with a deliberately wrong attention, held to the same
    limit, which must reject both: a path that is off by one position (the
    context without its last token), and one that hides the oldest cache
    block (16 keys) from the newest rows through a sliding window."""
    T = ctx.shape[1]
    short = model.forward(params, ctx[:, :-1], last_only=True)[0, -1].float()
    d_pos = float((short - ref).abs().max())
    check(d_pos > limit, f"logit limit {limit} does not reject an "
          f"off-by-one position (max|Δ| {d_pos})")
    cfg = model.cfg
    cut = DecoderLM(cfg.replace(attn=dataclasses.replace(
        cfg.attn, window=T - 16)), device=DEV)
    blk = cut.forward(params, ctx, last_only=True)[0, -1].float()
    d_blk = float((blk - ref).abs().max())
    check(d_blk > limit, f"logit limit {limit} does not reject a hidden "
          f"oldest block (max|Δ| {d_blk})")
    say(f"  controls, both rejected by the limit {limit:.4f}: off-by-one "
        f"position max|Δ| {d_pos:.4f}; oldest block hidden (window "
        f"{T - 16}) max|Δ| {d_blk:.4f}")


# ----------------------------------------------------------------- phase 6

BWD_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _free():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _capturing(seen):
    """The ``cuda`` backend, which also keeps the arguments of its first
    forward and first backward call in ``seen`` once ``seen["armed"]`` is
    set: the inputs the training path gives kernels A, C and D."""
    cuda = registry.get("cuda")

    def fwd(*a, **kw):
        if seen.get("armed"):
            seen.setdefault("fwd", (a, kw))
        return cuda.fwd(*a, **kw)

    def bwd(*a, **kw):
        if seen.get("armed"):
            seen.setdefault("bwd", (a, kw))
        return cuda.bwd(*a, **kw)
    return dataclasses.replace(cuda, fwd=fwd, bwd=bwd)


def _moved(call, dev):
    """A captured ``(args, kwargs)`` with its tensors on ``dev``."""
    a, kw = call
    to = (lambda x: x.to(dev) if torch.is_tensor(x) else x)
    return tuple(map(to, a)), {k: to(x) for k, x in kw.items()}


def _train_policy(cfg, policy, batches, tc, seen=None, seed=0,
                  kernels=BWD_KERNELS, profile=False):
    """``len(batches)`` steps from the seed-``seed`` init under ``policy``:
    metrics, step seconds (CUDA events), launches of ``kernels`` and peak
    device memory, and the device's idle share in one more step run under
    torch.profiler when ``seen`` or ``profile`` is given (else None); with
    ``seen`` that step leaves the inputs of its first attention forward
    (layer 1) and first attention backward (the last layer) in ``seen``,
    on the host."""
    model = TF.build_model(cfg, device=DEV, par=ParallelConfig(remat=policy),
                           impl=None if seen is None else _capturing(seen))
    params = trainable(model.init(seed=seed))
    opt = adamw.init(params)
    step = make_train_step(model, tc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    out = []
    for b in batches:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        m = step(params, opt, b)
        e.record()
        e.synchronize()
        out.append((m, s.elapsed_time(e) / 1e3))
    launches = {k: build.LAUNCHES[k] for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    idle = None
    if seen is not None or profile:
        from torch.profiler import ProfilerActivity, profile as prof_
        if seen is not None:
            seen["armed"] = True
        with prof_(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, opt, batches[0])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        idle = show_breakdown(f"one {policy} training step", prof, wall)
        if profile:
            _show_top(prof)
        if seen is not None:
            for k in ("fwd", "bwd"):
                seen[k] = _moved(seen[k], "cpu")
    del model, params, opt, step
    _free()
    return out, launches, peak, idle


def train():
    """Phase 6: llama-7b's width at depth 8, T 8192, B 1, bf16."""
    cfg = get_config("llama-7b").replace(n_layers=TRAIN_LAYERS)
    L, T, n = TRAIN_LAYERS, TRAIN_T, TRAIN_STEPS
    tc = TrainConfig(lr=1e-4, warmup_steps=min(20, n // 5 + 1),
                     total_steps=n)
    ds = SyntheticTokens(cfg, ShapeSpec("chip", T, 1, "train"), device=DEV,
                         seed=0)
    batches = [ds.batch(i) for i in range(n)]
    say(f"  {cfg.name} width, {L} of 32 layers ({cfg.param_count() / 1e9:.2f}"
        f" B params), B 1 T {T}, bf16 params, fp32 moments, lr {tc.lr}")
    seen = {}
    runs, launches, peak, _ = _train_policy(cfg, "remat_aware", batches, tc,
                                         seen=seen)
    for i, (m, sec) in enumerate(runs):
        check(m["skipped_nonfinite"] == 0, f"step {i + 1} was skipped")
        check(np.isfinite(m["loss"]), f"step {i + 1}: loss {m['loss']}")
        say(f"  remat_aware step {i + 1}: loss {m['loss']:.4f} gnorm "
            f"{m['gnorm']:.3f} lr {m['lr']:.2e} step {sec:.3f} s")
    tok_s = (n - 1) * T / sum(sec for _, sec in runs[1:])
    for k in BWD_KERNELS:
        check(launches[k] == L * n, f"remat_aware: {k} launched "
              f"{launches[k]} times in {n} steps, want {L} per step")
    say(f"  remat_aware: {tok_s:.1f} tokens/s over steps 2-{n}; launches "
        f"per step " + ", ".join(f"{k} {launches[k] / n:g}"
                                 for k in BWD_KERNELS)
        + f"; peak memory {peak / 2**30:.2f} GiB")
    peaks = {"remat_aware": peak}
    for policy, n_fwd in (("hf", 2 * L), ("none", L)):
        one, got, peaks[policy], _ = _train_policy(cfg, policy, batches[:1],
                                                   tc)
        (m1, sec1), = one
        want = {"flash_fwd": n_fwd, "flash_bwd_dq": L, "flash_bwd_dkv": L}
        check(got == want, f"{policy} launches {got}, want {want}")
        d = abs(m1["loss"] - runs[0][0]["loss"])
        check(d <= 1e-2 * abs(runs[0][0]["loss"]),
              f"{policy} step 1 loss {m1['loss']} vs remat_aware "
              f"{runs[0][0]['loss']}")
        say(f"  {policy} step 1: loss {m1['loss']:.4f} (|Δ| vs remat_aware "
            f"{d:.2e}), step {sec1:.3f} s; launches " + ", ".join(
                f"{k} {got[k]}" for k in BWD_KERNELS)
            + f"; peak memory {peaks[policy] / 2**30:.2f} GiB")
    return dict(launches=launches, losses=[m["loss"] for m, _ in runs],
                tok_s=tok_s, peaks=peaks, seen=seen)


HEAD_SLICE = 8      # heads per plain-version call at T 8192 (2.1 GB each
                    # (h, T, T) float32 tensor)


def _head_slices(q, k):
    """(q-head slice, kv-head slice) pairs covering every head."""
    g = q.shape[2] // k.shape[2]
    check(HEAD_SLICE % g == 0, f"head slice {HEAD_SLICE} splits a group")
    return [(slice(h, h + HEAD_SLICE), slice(h // g, (h + HEAD_SLICE) // g))
            for h in range(0, q.shape[2], HEAD_SLICE)]


def _bwd_slice(args, kw, sq, skv):
    """The backward's inputs restricted to one head slice."""
    q, k, v, o, lse, do = args
    kw = dict(kw)
    if kw.get("delta") is not None:
        kw["delta"] = kw["delta"][:, :, sq]
    return (q[:, :, sq], k[:, :, skv], v[:, :, skv], o[:, :, sq],
            lse[:, :, sq], do[:, :, sq]), kw


def _sdpa_bwd(q, k, v, do, scale):
    """SDPA's causal forward and autograd backward of (q, k, v) for the
    cotangent do, in the (B, T, H, D) layout: the library yardstick of
    kernels C and D, never called by the port.  Returns (o, (dq, dk, dv))."""
    qt, kt, vt = (x.transpose(1, 2).detach().contiguous().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale,
        enable_gqa=qt.shape[1] != kt.shape[1])
    g = torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2))
    return (out.detach().transpose(1, 2),
            tuple(x.transpose(1, 2) for x in g))


def _library(fn):
    """``fn()``, SDPA's call beside a kernel as a calibration, or None when
    no SDPA backend takes the shape (the port never calls it)."""
    try:
        return fn()
    except RuntimeError as e:
        say(f"  sdpa: {str(e)[:160]}")
        return None


def _fmt(x):
    return "n/a" if x is None else f"{x:.2e}"


def main_path_checks(seen, shape=(1, TRAIN_T, 32, 128), last=TRAIN_LAYERS):
    """Kernels A, C and D on the inputs the training path gave them (phase
    6: B 1, T 8192, 32 heads × 128; phase 14: 16 heads of q/k 192, v 128;
    bf16, causal; the backward's are the last layer's), each held against
    its plain version head slice by head slice, and the same limits held to
    a plain backward that never visits the last 64-key tile, which they
    must reject."""
    (q, k, v), kw = _moved(seen["fwd"], DEV)
    check(kw["mask"] == mk.causal() and q.dtype == torch.bfloat16
          and q.shape == shape,
          f"training attention {kw['mask']} {q.dtype} {tuple(q.shape)}")
    o, lse = flash_fwd(q, k, v, **kw)
    e_o = r_o = e_lse = lse_max = 0.0
    r_bad = r_lib = None
    for sq, skv in _head_slices(q, k):
        qh, kh, vh = q[:, :, sq], k[:, :, skv], v[:, :, skv]
        o_r, lse_r = chunk_attn_ref(qh, kh, vh, **kw)
        e_o = max(e_o, float((o[:, :, sq].float() - o_r.float()).abs()
                             .max()))
        r_o = max(r_o, rel_err(o[:, :, sq], o_r))
        e_lse = max(e_lse, float((lse[:, :, sq] - lse_r).abs().max()))
        lse_max = max(lse_max, float(lse_r.abs().max()))
        if r_bad is None:   # the control and the calibration, first slice
            cut = kh.shape[1] - 64
            r_bad = rel_err(chunk_attn_ref(qh, kh[:, :cut], vh[:, :cut],
                                           **kw)[0], o_r)
            o_lib = _library(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    *(x.transpose(1, 2) for x in (qh, kh, vh)),
                    is_causal=True, scale=kw.get("scale"),
                    enable_gqa=qh.shape[2] != kh.shape[2]))
            r_lib = (None if o_lib is None else
                     rel_err(o_lib.transpose(1, 2), o_r))
            del o_lib
    say(f"  A  layer-1 forward: max|Δo| {e_o:.3e} rel {r_o:.2e} (limit "
        f"{REL_TOL}), max|Δlse| {e_lse:.3e}; control without the last kv "
        f"tile: rel {r_bad:.2e}; SDPA's forward (calibration, first head "
        f"slice): rel {_fmt(r_lib)}")
    check(r_o <= REL_TOL and e_o <= TOL[torch.bfloat16],
          f"flash_fwd on the training path: o err {e_o}, rel {r_o}")
    check(e_lse <= LSE_TOL * (1 + lse_max),
          f"flash_fwd on the training path: lse err {e_lse}")
    check(r_bad > REL_TOL, f"the limit {REL_TOL} does not reject a forward "
          f"without the last kv tile (rel {r_bad})")
    del q, k, v, o, lse, o_r, lse_r, qh, kh, vh
    args, kw = _moved(seen["bwd"], DEV)
    got = flash_bwd(*args, **kw)
    e_abs, e_row, e_bad, e_lib = [0.0] * 3, [0.0] * 3, None, None
    tol = BWD_TOL[torch.bfloat16]
    for sq, skv in _head_slices(args[0], args[1]):
        a_s, kw_s = _bwd_slice(args, kw, sq, skv)
        ref = chunk_attn_bwd_ref(*a_s, **kw_s)
        mine = (got[0][:, :, sq], got[1][:, :, skv], got[2][:, :, skv])
        for i, (a, r) in enumerate(zip(mine, ref)):
            check(torch.allclose(a.float(), r.float(), atol=tol, rtol=tol),
                  f"flash_bwd on the training path: output {i} over {tol}")
            e_abs[i] = max(e_abs[i], float((a.float() - r.float()).abs()
                                           .max()))
            e_row[i] = max(e_row[i], row_rel_err(a, r))
        if e_bad is None:             # the control, on the first slice
            q, k, v, o, lse, do = a_s
            cut = k.shape[1] - 64
            bq, bk, bv = chunk_attn_bwd_ref(q, k[:, :cut], v[:, :cut], o,
                                            lse, do, **kw_s)
            bad = (bq, torch.cat([bk, torch.zeros_like(k[:, cut:])], 1),
                   torch.cat([bv, torch.zeros_like(v[:, cut:])], 1))
            e_bad = [row_rel_err(b, r) for b, r in zip(bad, ref)]
            del bad, bq, bk, bv
            # SDPA's backward uses its own forward's output in delta =
            # rowsum(o ⊙ do), so it is held to the plain backward from that
            # output
            lib = _library(lambda: _sdpa_bwd(q, k, v, do, kw_s.get("scale")))
            e_lib = [None] * 3
            if lib is not None:
                ref_lib = chunk_attn_bwd_ref(q, k, v, lib[0], lse, do,
                                             **kw_s)
                e_lib = [row_rel_err(b, r) for b, r in zip(lib[1], ref_lib)]
                del ref_lib
            del lib
        del ref
    say(f"  C/D layer-{last} backward: max|Δdq| {e_abs[0]:.3e} max|Δdk| "
        f"{e_abs[1]:.3e} max|Δdv| {e_abs[2]:.3e} (tol {tol}); per-row dq/dk/"
        "dv " + "/".join(f"{x:.2e}" for x in e_row) + f" (limit {ROW_TOL}); "
        "control without the last kv tile: per-row "
        + "/".join(f"{x:.2e}" for x in e_bad) + "; SDPA's backward "
        "(calibration, first head slice): per-row "
        + "/".join(_fmt(x) for x in e_lib))
    check(max(e_row) <= ROW_TOL, f"flash_bwd on the training path: per-row "
          f"errors {e_row} over {ROW_TOL}")
    check(min(e_bad) > ROW_TOL, f"the limit {ROW_TOL} does not reject a "
          f"backward without the last kv tile (per-row {e_bad})")
    del got, args
    _free()
    return {"flash_bwd_dq": e_abs[0], "flash_bwd_dkv": max(e_abs[1:])}


def _shifted_backend():
    """A deliberately wrong attention backward: the plain one with the
    causal mask shifted by one position (each query also sees the next
    key).  The forward is the plain one."""
    ref = registry.get("ref")

    def bwd(q, k, v, o, lse, do, *, mask, **kw):
        return chunk_attn_bwd_ref(q, k, v, o, lse, do,
                                  mask=mask.replace(q_offset=mask.q_offset
                                                    + 1), **kw)
    return dataclasses.replace(ref, name="shifted", bwd=bwd)


def grad_check():
    """Phase 6b: per-leaf gradients of the kernels against the plain path
    at full width, 2 layers, T 1024; the limit must reject a shifted
    backward."""
    cfg = get_config("llama-7b").replace(n_layers=2)
    batch = SyntheticTokens(cfg, ShapeSpec("g", 1024, 1, "train"),
                            device=DEV).batch(0)
    base = DecoderLM(cfg, device=DEV).init(seed=0)

    def grads(impl):
        model = DecoderLM(cfg, device=DEV, impl=impl)
        params = trainable(base)
        loss, _ = model.loss(params, batch)
        return float(loss.detach()), torch.autograd.grad(loss,
                                                         leaves(params))

    def worst(gs, ref):
        """Largest per-leaf max |Δg| / max |g_ref|."""
        return max(float((a.float() - r.float()).abs().max())
                   / float(r.float().abs().max()) for a, r in zip(gs, ref))

    l_ref, g_ref = grads("ref")
    l_cuda, g_cuda = grads("cuda")
    ok = worst(g_cuda, g_ref)
    check(ok <= GRAD_REL_TOL, f"kernel grads vs plain: worst leaf {ok:.4f} "
          f"of its max |g|, over {GRAD_REL_TOL}")
    _, g_bad = grads(_shifted_backend())
    bad = worst(g_bad, g_ref)
    check(bad > GRAD_REL_TOL, f"the grad limit {GRAD_REL_TOL} does not "
          f"reject a backward shifted by one position (worst leaf {bad:.4f})")
    say(f"  loss kernels {l_cuda:.5f} vs plain {l_ref:.5f}; worst leaf "
        f"max|Δg| / max|g|: kernels {ok:.4f} (limit {GRAD_REL_TOL}), "
        f"shifted-mask control {bad:.4f} (rejected)")
    del base, g_ref, g_cuda, g_bad
    _free()


# ---------------------------------------------------------------- phase 3c

PLAN_P, PLAN_TL, PLAN_WINDOW = 4, 8192, 3000
PLAN_SETS = (("balanced", mk.causal()), ("ring", mk.causal()),
             ("zigzag", mk.causal()),
             ("ring", mk.sliding_window(PLAN_WINDOW)),
             ("zigzag", mk.sliding_window(PLAN_WINDOW)),
             ("balanced", mk.document()))
PLAN_DOC_STEPS = ((0, 1), (1, 3))   # (step, rank) run of the document plan


def _plan_step_cases():
    """The distinct kernel calls of every Work item of ``PLAN_SETS`` at
    P 4, Tl 8192, as each rank's forward and backward make them
    (``schedule.rank_calls``): ``{(mask, chunk tokens, q chunk, kv chunk):
    [labels]}`` (the chunks only where segment ids make them matter:
    document masks)."""
    cases = {}
    for sched, m in PLAN_SETS:
        plan = sp.build_plan(sched, m, PLAN_P, PLAN_TL)
        tag = sched + ("-window" if m.window else "") \
            + ("-document" if m.document else "")
        for backward in (False, True):
            for si, p, qg, kg, km in sp.rank_calls(plan, backward):
                if m.document and (si, p) not in PLAN_DOC_STEPS:
                    continue
                key = (km, plan.chunk_len) + ((qg, kg) if m.document
                                              else (None, None))
                label = f"{tag} t{si} p{p}"
                if label not in cases.setdefault(key, []):
                    cases[key].append(label)
    return cases


def plan_step_checks():
    """Phase 3c: kernels A, C and D under every plan step's mask at
    llama-7b width (32 heads × 128, bf16), against their plain versions
    head slice by head slice at phase 3's limits; the backward gets the
    executor's inputs (o = 0, delta = rowsum(o ⊙ do) passed in)."""
    gen = torch.Generator(device=DEV).manual_seed(16)
    bf = torch.bfloat16
    T = PLAN_P * PLAN_TL
    seg_g = torch.sort(torch.randint(0, 7, (1, T), generator=gen,
                                     device=DEV), dim=1)[0].to(torch.int32)
    cases = _plan_step_cases()
    n_empty_rows = n_empty_chunks = 0
    for (m, c, qg, kg), labels in cases.items():
        q, k, v, do = (randn(gen, (1, c, 32, 128), bf) for _ in range(4))
        kw = {}
        if m.document:
            kw = dict(q_segments=seg_g[:, qg * c:(qg + 1) * c].contiguous(),
                      kv_segments=seg_g[:, kg * c:(kg + 1) * c]
                      .contiguous())
        block = FWD_ROUTES[bf][2]
        empty = _device_bounds(m, c, c, True, str(DEV), block)[1]
        n0 = dict(build.LAUNCHES)
        o, lse = flash_fwd(q, k, v, mask=m, **kw)
        delta = (o.float() * do.float()).sum(-1)
        zero = torch.zeros_like(q)
        got = flash_bwd(q, k, v, zero, lse, do, mask=m, delta=delta, **kw)
        torch.cuda.synchronize()
        want = 0 if empty else 1
        for name in BWD_KERNELS:
            check(build.LAUNCHES[name] - n0[name] == want,
                  f"plan step {labels[0]}: {name} launched "
                  f"{build.LAUNCHES[name] - n0[name]} times, want {want}")
        e = dict(o=0.0, lse=0.0, rel=0.0, dq=0.0, dk=0.0, dv=0.0)
        rows = [0.0] * 3
        dead = 0
        for sq, skv in _head_slices(q, k):
            qh, kh, vh = q[:, :, sq], k[:, :, skv], v[:, :, skv]
            o_r, lse_r = chunk_attn_ref(qh, kh, vh, mask=m, **kw)
            oh, lh = o[:, :, sq], lse[:, :, sq]
            check(torch.allclose(oh.float(), o_r.float(), atol=TOL[bf],
                                 rtol=TOL[bf]),
                  f"plan step {labels[0]}: o over {TOL[bf]}")
            e["o"] = max(e["o"], float((oh.float() - o_r.float()).abs()
                                       .max()))
            e["rel"] = max(e["rel"], rel_err(oh, o_r))
            gone = lse_r <= NEG_INF / 2
            dead += int(gone.sum())
            check(bool((lh[gone] == NEG_INF).all() and (oh[gone] == 0).all()),
                  f"plan step {labels[0]}: an empty row is not (0, NEG_INF)")
            if (~gone).any():
                e["lse"] = max(e["lse"], float((lh - lse_r).abs()[~gone]
                                               .max()))
            ref = chunk_attn_bwd_ref(qh, kh, vh, zero[:, :, sq], lh,
                                     do[:, :, sq], mask=m,
                                     delta=delta[:, :, sq], **kw)
            mine = (got[0][:, :, sq], got[1][:, :, skv], got[2][:, :, skv])
            for i, (nm, a, r) in enumerate(zip(("dq", "dk", "dv"), mine,
                                               ref)):
                check(torch.allclose(a.float(), r.float(), atol=BWD_TOL[bf],
                                     rtol=BWD_TOL[bf]),
                      f"plan step {labels[0]}: {nm} over {BWD_TOL[bf]}")
                e[nm] = max(e[nm], float((a.float() - r.float()).abs()
                                         .max()))
                rows[i] = max(rows[i], row_rel_err(a, r))
            del o_r, lse_r, ref
        check(e["rel"] <= REL_TOL, f"plan step {labels[0]}: o relative "
              f"err {e['rel']} over {REL_TOL}")
        check(max(rows) <= ROW_TOL, f"plan step {labels[0]}: per-row "
              f"errors {rows} over {ROW_TOL}")
        if dead:
            # merged with another partial, the empty rows stay finite and
            # take the other partial's value exactly
            o2 = randn(gen, o.shape, torch.float32)
            mo, ml = merge_ref(o.float(), lse, o2, torch.zeros_like(lse))
            gone = lse <= NEG_INF / 2
            check(bool(torch.isfinite(mo).all() and torch.isfinite(ml).all()
                       and (mo[gone] == o2[gone]).all()),
                  f"plan step {labels[0]}: merge of empty rows")
            n_empty_rows += 1
        n_empty_chunks += bool(empty)
        say(f"  {labels[0]:<24} {m.kind:<14} q_off {m.q_offset:>5} kv_off "
            f"{m.kv_offset:>5} c {c}: max|Δo| {e['o']:.2e} rel "
            f"{e['rel']:.2e} max|Δlse| {e['lse']:.2e}; dq/dk/dv "
            f"{e['dq']:.2e}/{e['dk']:.2e}/{e['dv']:.2e} per-row "
            + "/".join(f"{x:.2e}" for x in rows)
            + (f"; {dead} empty rows" if dead else "")
            + ("; statically empty, no launch" if empty else "")
            + f" ({len(labels)} rank-steps)")
        del q, k, v, do, o, lse, got, zero, delta
        _free()
    check(n_empty_rows > 0, "no plan step had empty rows")
    say(f"  {len(cases)} distinct plan-step kernel calls held to their "
        f"plain versions; {n_empty_rows} with empty rows, "
        f"{n_empty_chunks} statically empty")


PAIR_PLAN_SETS = (("balanced", mk.causal()), ("zigzag", mk.causal()))


def _pair_plan_cases():
    """The distinct kernel calls of ``PAIR_PLAN_SETS``'s plans at P 4, Tl
    8192, and at the P and Tl with which phase 15's training and phase
    16's prefill run these plans at q/k 192, v 128 (4,096 tokens a rank):
    ``{(mask, chunk tokens): [labels]}``."""
    cases = {}
    runs = sorted({(PLAN_P, PLAN_TL), (P15_RANKS, P15_T // P15_RANKS),
                   (P16_RANKS, P16_T // P16_RANKS)}, reverse=True)
    for P, Tl in runs:
        for sched, m in PAIR_PLAN_SETS:
            plan = sp.build_plan(sched, m, P, Tl)
            for backward in (False, True):
                for si, p, _, _, km in sp.rank_calls(plan, backward):
                    label = f"{sched} P{P} Tl{Tl} t{si} p{p}"
                    key = (km, plan.chunk_len)
                    if label not in cases.setdefault(key, []):
                        cases[key].append(label)
    return cases


def pair_plan_step_checks():
    """Phase 3c at materialised MLA's q/k 192, v 128 (16 heads, bf16,
    scale 1/√192, v the last 128 columns of a 256-wide tensor): kernels
    A, C and D's pair routes under every distinct plan-step mask of the
    balanced and zigzag plans at P 4, Tl 8192 and phases 15 and 16's Tl
    (``_pair_plan_cases``), with the executor's
    backward inputs (o zeros of v's width, delta = rowsum(o ⊙ do) passed
    in), held to their plain versions head slice by head slice at phase
    3's bars (the backward's must reject the plain backward without the
    last key tile); empty rows come out (0, NEG_INF)."""
    gen = torch.Generator(device=DEV).manual_seed(17)
    bf = torch.bfloat16
    cases = _pair_plan_cases()
    for (m, c), labels in cases.items():
        q = randn(gen, (1, c, PAIR_H, PAIR_DK), bf)
        k = randn(gen, (1, c, PAIR_H, PAIR_DK), bf)
        v = randn(gen, (1, c, PAIR_H, 2 * PAIR_DV), bf)[..., PAIR_DV:]
        do = randn(gen, (1, c, PAIR_H, PAIR_DV), bf)
        kw = dict(mask=m, scale=LAT_SCALE)
        empty = _device_bounds(m, c, c, True, str(DEV),
                               PAIR_ROUTES[bf][2])[1]
        n0 = dict(build.LAUNCHES)
        o, lse = flash_fwd(q, k, v, **kw)
        delta = (o.float() * do.float()).sum(-1)
        zero = torch.zeros_like(do)
        got = flash_bwd(q, k, v, zero, lse, do, delta=delta, **kw)
        torch.cuda.synchronize()
        want = 0 if empty else 1
        for name in P14_KERNELS:
            check(build.LAUNCHES[name] - n0[name] == want,
                  f"pair plan step {labels[0]}: {name} launched "
                  f"{build.LAUNCHES[name] - n0[name]} times, want {want}")
        e = dict(o=0.0, lse=0.0, rel=0.0)
        dead = 0
        for sq, skv in _head_slices(q, k):
            o_r, lse_r = chunk_attn_ref(q[:, :, sq], k[:, :, skv],
                                        v[:, :, skv], **kw)
            oh, lh = o[:, :, sq], lse[:, :, sq]
            check(torch.allclose(oh.float(), o_r.float(), atol=TOL[bf],
                                 rtol=TOL[bf]),
                  f"pair plan step {labels[0]}: o over {TOL[bf]}")
            e["o"] = max(e["o"], float((oh.float() - o_r.float()).abs()
                                       .max()))
            e["rel"] = max(e["rel"], rel_err(oh, o_r))
            gone = lse_r <= NEG_INF / 2
            dead += int(gone.sum())
            check(bool((lh[gone] == NEG_INF).all() and (oh[gone] == 0).all()),
                  f"pair plan step {labels[0]}: an empty row is not "
                  f"(0, NEG_INF)")
            if (~gone).any():
                e["lse"] = max(e["lse"], float((lh - lse_r).abs()[~gone]
                                               .max()))
            del o_r, lse_r
        check(e["rel"] <= REL_TOL, f"pair plan step {labels[0]}: o relative "
              f"err {e['rel']} over {REL_TOL}")
        args = (q, k, v, zero, lse, do)
        bkw = dict(kw, delta=delta)
        ref = _pair_bwd_ref(args, bkw)
        bars = [_bwd_bar(a, r, bf) for a, r in zip(got, ref)]
        check(all(b[0] for b in bars), f"pair plan step {labels[0]}: "
              f"dq/dk/dv {bars}")
        ctl = ""
        if not empty:
            bad = _pair_bwd_ref(args, bkw, cut=c - 64)
            cb = [_bwd_bar(b, r, bf) for b, r in zip(bad, ref)]
            check(not all(x[0] for x in cb), f"pair plan step {labels[0]}: "
                  f"the bar does not reject the control without the last "
                  f"key tile ({cb})")
            ctl = "; control without the last key tile " + "/".join(
                f"{x[2]:.2e}" for x in cb) + " (rejected)"
            del bad
        say(f"  pair {labels[0]:<27} {m.kind:<10} q_off {m.q_offset:>5} "
            f"kv_off {m.kv_offset:>5} c {c}: max|Δo| {e['o']:.2e} rel "
            f"{e['rel']:.2e} max|Δlse| {e['lse']:.2e}; dq/dk/dv "
            + "/".join(f"{b[1]:.2e}" for b in bars) + " per-row "
            + "/".join(f"{b[2]:.2e}" for b in bars)
            + (f"; {dead} empty rows" if dead else "")
            + ("; statically empty, no launch" if empty else "") + ctl
            + f" ({len(labels)} rank-steps)")
        del q, k, v, do, o, lse, got, zero, delta, ref
        _free()
    tls = {f"P{P15_RANKS} Tl{P15_T // P15_RANKS} ",
           f"P{P16_RANKS} Tl{P16_T // P16_RANKS} "}
    main = sum(any(t in x for t in tls for x in labels)
               for labels in cases.values())
    say(f"  {len(cases)} distinct pair plan-step kernel calls held to their "
        f"plain versions, {main} of them calls of phases 15 and 16")


# ----------------------------------------------------------------- phase 7

P7_RANKS, P7_LAYERS, P7_T = 4, 2, 32768
# two balanced steps (the gates read steps 1 and 2), one ring, one zigzag:
# a third balanced step went to keep the whole run near 1,000 s once
# phases 15 and 16 joined it
P7_RUNS = (("balanced", 2), ("ring", 1), ("zigzag", 1))
P7_TIMEOUT = 600
P7_TRANSPORT = "cuda-ipc"          # four ranks, one card
# P = 4 against P = 1 on the same weights and first batch (bf16, width,
# depth 2): the mean |Δ| of the per-token losses and |Δ| of the loss.
# Calibrated on the first chip run: sound 5.03e-3 and 4.77e-5; the
# control without the helper routes 5.36e-2 and 5.18e-4.  Each limit sits
# about 3× above the sound run and 3× below the control.
P7_CE_TOL, P7_LOSS_TOL = 1.5e-2, 1.5e-4
# The backward against P = 1 on the same weights and batches: the worst
# relative error ‖g₄ − g₁‖ / ‖g₁‖ over the gradients of every layer's wq,
# wk and wv (each schedule), the relative |Δ| of step 1's gradient norm,
# and |Δ| of step 2's loss (after one AdamW update).  Two planted backward
# faults on the balanced schedule are the controls: the traveling
# accumulators' home shift dropped ("home"), and the helpers' dq
# accumulator emptied on its way home ("dqb").  Calibrated on the chip
# (H100, 700 W): sound ≤ 7.61e-3 / 2.91e-5 / 9.54e-6; home 0.821 /
# 3.39e-2 / 4.57e-2; dqb 0.223 / 5.79e-5 / 1.95e-4.  The gradient and
# step-2 limits sit about 4× above the sound run and 5-7× below the dqb
# control; the norm limit 34× from both the sound run and the home
# control.  The dqb control moves the norm only twice as far as the sound
# run does (the helpers' dq is a small part of it), so the norm limit
# need reject only the home control.
P7_GRAD_TOL, P7_GNORM_TOL, P7_LOSS2_TOL = 3e-2, 1e-3, 4e-5
P7_GRAD_RUNS = (("balanced", None), ("ring", None), ("zigzag", None),
                ("balanced", "home"), ("balanced", "dqb"))


def _p7_tc():
    return TrainConfig(lr=1e-4, warmup_steps=1,
                       total_steps=sum(n for _, n in P7_RUNS))


def _helperless(build_plan):
    """A deliberately wrong planner (phase 7's control): the plans with
    every shipped route dropped, so the balanced schedule's helper results
    never reach home."""
    def build(sched, m, P, Tl):
        plan = build_plan(sched, m, P, Tl)
        steps = []
        for s in plan.steps:
            work = [dataclasses.replace(w, routes=tuple(
                r for r in w.routes if not r.ship)) for w in s.work]
            steps.append(dataclasses.replace(
                s, work=tuple(w for w in work if w.routes)))
        return dataclasses.replace(plan, steps=tuple(steps))
    return build


@contextlib.contextmanager
def _backward_fault(fault):
    """A deliberately wrong backward while the block runs (phase 7's
    controls): ``execute_bwd``'s multi-hop shift that sends the traveling
    accumulators home (its only shift with negative hops) dropped
    (``"home"``), or made with the helpers' dq accumulator emptied
    (``"dqb"``); None leaves the backward as it is."""
    shift_now = sp._shift_now

    def faulty(comm, data, hops):
        if hops >= 0:
            return shift_now(comm, data, hops)
        if fault == "home":
            return data
        out = shift_now(comm, data, hops)
        out["dqb"] = torch.zeros_like(out["dqb"])
        return out
    if fault:
        sp._shift_now = faulty
    try:
        yield
    finally:
        sp._shift_now = shift_now


def _token_ce(model, params, batch):
    """Per-token cross-entropy (B, Tl) float32 of ``model`` on its shard,
    through the model's own layers (logits 4096 tokens at a time)."""
    from repro_torch.models import layers as L
    a = model.cfg.attn
    with torch.no_grad():
        h = model._embed(params, batch)
        cos, sin = L.rope_tables(model.positions(h.shape[1]), a.head_dim,
                                 a.rope_theta)
        h, _ = model._backbone(params, h, cos, sin)
        labels = batch["labels"].to(model.device).long()
        out = []
        for i in range(0, h.shape[1], 4096):
            lf = model._head(params, h[:, i:i + 4096]).float()
            ll = lf.gather(-1, labels[:, i:i + 4096, None])[..., 0]
            out.append(torch.logsumexp(lf, -1) - ll)
        return torch.cat(out, dim=1)


def _attn_grads(model, params, batch):
    """Gradients of the global loss w.r.t. every layer's wq, wk and wv,
    summed over the ranks as the train step sums them."""
    loss, _ = model.loss(params, batch)
    gs = list(torch.autograd.grad(loss, [
        lp["attn"][k] for lp in params["layers"] for k in ("wq", "wk", "wv")]))
    if model.token_group is not None:
        model.token_group.all_reduce_(gs)
    return gs


def _grad_err(gs, ref):
    return max(float((g.float() - r.float()).norm() / r.float().norm())
               for g, r in zip(gs, ref))


def _plan_launches(sched, P=P7_RANKS, T=P7_T):
    """Per rank, the kernel calls one pass of ``sched``'s causal plan at
    P ranks and T tokens must launch, derived apart from the executor's
    ``work_active``: the rank's Work items with a route that reaches an
    output (``schedule.route_reaches``, the coverage rule).  Fails unless
    those items compute every causal (q chunk, kv chunk) pair of
    ``global_allow`` exactly once over the ranks."""
    plan = sp.build_plan(sched, mk.causal(), P, T // P)
    n = P * plan.n_chunks
    got = np.zeros((n, n), np.int64)
    want = [0] * P
    d = 0
    for step in plan.steps:
        d += step.shift
        for w in step.work:
            for p in range(P):
                if any(sp.route_reaches(r, P, p) for r in w.routes):
                    qg, kg, _ = sp.work_operands(plan, w, p, d)
                    got[qg, kg] += 1
                    want[p] += 1
    check(bool((got == sp.global_allow(mk.causal(), n)).all()),
          f"{sched}: the ranks' routes do not compute every causal chunk "
          f"pair once")
    return want


@contextlib.contextmanager
def _resolved():
    """While the block runs, every name ``resolve_schedule`` gives an
    ``auto`` spec goes into the list it yields."""
    from repro_torch.core import dist_attention as da
    base, names = da.resolve_schedule, []

    def noted(spec, *a, **kw):
        name = base(spec, *a, **kw)
        if spec.schedule == "auto":
            names.append(name)
        return name
    da.resolve_schedule = noted
    try:
        yield names
    finally:
        da.resolve_schedule = base


@contextlib.contextmanager
def _local_calls(save_to=None):
    """While the block runs, the q shape of every whole-sequence kernel-A
    call the ulysses baseline makes (``dist_attention.chunk_attn``) goes
    into the list it yields; ``save_to``: the first call's q, k, v saved
    there (on the host)."""
    from repro_torch.core import dist_attention as da
    base, shapes = da.chunk_attn, []

    def noted(q, k, v, **kw):
        if save_to is not None and not shapes:
            torch.save(dict(q=q.cpu(), k=k.cpu(), v=v.cpu(),
                            mask=kw["mask"]), save_to)
        shapes.append(tuple(q.shape))
        return base(q, k, v, **kw)
    da.chunk_attn = noted
    try:
        yield shapes
    finally:
        da.chunk_attn = base


def _p7_auto_name():
    """``choose_schedule``'s pick for phase 7's cell (causal, P 4, Tl
    8192, llama-7b's 32 / 32 heads of 128, bf16, with the backward)."""
    a = get_config("llama-7b").attn
    return sp.choose_schedule(mk.causal(), P7_RANKS, Tl=P7_T // P7_RANKS,
                              B=1, Hq=a.n_heads, Hkv=a.n_kv_heads,
                              Dqk=a.head_dim, bpe=2, include_bwd=True)


def _p7_auto(cfg, mesh, shape, params, batch, saved, save_to=None):
    """Phase 7's ``auto`` step: one train step under ``schedule="auto"``
    from the world's own init and first batch, then one under the name
    ``choose_schedule`` gives the cell, each from the same start (undone):
    losses, norms, the names ``auto`` resolved, launches, the whole-sequence
    A calls' shapes (rank 0's first saved at ``save_to``)."""
    runs = {}
    for sched in ("auto", _p7_auto_name()):
        model = DecoderLM(cfg, DEV, mesh=mesh, par=make_parallel_config(
            mesh, shape, schedule=sched))
        opt = adamw.init(params)
        step = make_train_step(model, _p7_tc())
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        with _resolved() as names, _local_calls(
                save_to if sched == "auto" else None) as shapes:
            m = step(params, opt, batch)
        torch.cuda.synchronize()
        runs[sched] = dict(loss=m["loss"], gnorm=m["gnorm"],
                           skipped=m["skipped_nonfinite"],
                           sec=time.perf_counter() - t0, names=names,
                           shapes=shapes,
                           launches={k: build.LAUNCHES[k]
                                     for k in BWD_KERNELS})
        with torch.no_grad():
            for t, v in zip(leaves(params), saved):
                t.copy_(v)
        del opt, step, model
    return runs


def _p7_auto_gates(res, ce1, auto_path, want):
    """The ``auto`` step's gates: every rank resolved ``choose_schedule``'s
    name (ulysses expected) in its forward and backward; its loss and
    gradient norm bitwise the named step's, its loss within phase 7's bar
    of P = 1's; A once a layer over the whole sequence at 8 heads a rank,
    C and D the ring plan's (the baseline's backward); rank 0's first
    whole-sequence A call held to its plain version on its first and last
    2,048 query rows.  Returns the auto step's launches (all ranks)."""
    name = _p7_auto_name()
    check(name == "ulysses", f"choose_schedule picks {name} for phase 7's "
          "cell, not ulysses")
    launches = {k: 0 for k in BWD_KERNELS}
    cfg = get_config("llama-7b")
    hl = cfg.attn.n_heads // P7_RANKS
    for r in res:
        au, named = r["auto"]["auto"], r["auto"][name]
        check(au["names"] and set(au["names"]) == {name}, f"rank "
              f"{r['rank']}: auto resolved {au['names']}, want {name}")
        check(au["loss"] == named["loss"] and au["gnorm"] == named["gnorm"],
              f"rank {r['rank']}: auto step loss / gnorm {au['loss']} / "
              f"{au['gnorm']} vs {name} {named['loss']} / {named['gnorm']}")
        check(au["skipped"] == 0 and abs(au["loss"] - float(ce1.mean()))
              <= P7_LOSS_TOL, f"rank {r['rank']}: auto step loss "
              f"{au['loss']} vs P = 1 {float(ce1.mean())}")
        w_bwd = P7_LAYERS * want["ring"][r["rank"]]
        check(au["launches"] == {"flash_fwd": P7_LAYERS, "flash_bwd_dq":
                                 w_bwd, "flash_bwd_dkv": w_bwd}
              and au["shapes"] == [(1, P7_T, hl, cfg.attn.head_dim)]
              * P7_LAYERS, f"rank {r['rank']}: auto launches "
              f"{au['launches']}, A shapes {au['shapes']}")
        for k in BWD_KERNELS:
            launches[k] += au["launches"][k]
    x = torch.load(auto_path, weights_only=False)
    q, k, v = (x[n].to(DEV) for n in ("q", "k", "v"))
    o, lse = flash_fwd(q, k, v, mask=x["mask"])
    e_o = r_o = e_l = l_max = 0.0
    n = min(2048, P7_T // 2)
    for a in (0, P7_T - n):
        o_r, lse_r = chunk_attn_ref(q[:, a:a + n], k[:, :a + n],
                                    v[:, :a + n], mask=mk.causal(a))
        e_o = max(e_o, float((o[:, a:a + n].float() - o_r.float()).abs()
                             .max()))
        r_o = max(r_o, rel_err(o[:, a:a + n], o_r))
        e_l = max(e_l, float((lse[:, a:a + n] - lse_r).abs().max()))
        l_max = max(l_max, float(lse_r.abs().max()))
    del q, k, v, o, lse, o_r, lse_r, x
    _free()
    au0, nm0 = res[0]["auto"]["auto"], res[0]["auto"][name]
    say(f"  auto step: every rank resolved {name} (choose_schedule's pick "
        f"for the cell at the H100 constants; ulysses expected); loss "
        f"{au0['loss']:.6f} gnorm {au0['gnorm']:.4f}, bitwise the named "
        f"{name} step's ({nm0['loss']:.6f} / {nm0['gnorm']:.4f}); |Δloss| "
        f"vs P = 1 {abs(au0['loss'] - float(ce1.mean())):.3e} (limit "
        f"{P7_LOSS_TOL}); steps " + ", ".join(
            f"{r['auto']['auto']['sec']:.2f}" for r in res) + " s a rank")
    say(f"  auto step launches a rank: A {P7_LAYERS} over q "
        f"{au0['shapes'][0]} (the ulysses forward, one a layer), C/D "
        + ", ".join(f"{r['auto']['auto']['launches']['flash_bwd_dq']}"
                    for r in res)
        + " (the ring plan's backward); rank 0's first A call against its "
        f"plain version on query rows [0, {n}) and [{P7_T - n}, {P7_T}): "
        f"max|Δo| {e_o:.3e} rel {r_o:.2e} (limits {TOL[torch.bfloat16]}, "
        f"{REL_TOL}), max|Δlse| {e_l:.3e}")
    check(e_o <= TOL[torch.bfloat16] and r_o <= REL_TOL
          and e_l <= LSE_TOL * (1 + l_max), f"A at the ulysses shape: o "
          f"{e_o}, rel {r_o}, lse {e_l}")
    return launches


def _p7_rank(rank, ref_path, auto_path):
    """One rank of phase 7's world (its process and world are started by
    ``spawn``): the per-token losses of the first batch under balanced
    and under the control, the attention projections' gradients of that
    batch under each schedule and under the backward controls (held on
    rank 0 to the P = 1 gradients saved at ``ref_path``), a train step
    under each backward control (undone), the ``auto`` step and its named
    schedule's (undone; :func:`_p7_auto`, rank 0's first whole-sequence A
    call saved at ``auto_path``), then the train steps of ``P7_RUNS``."""
    mesh = make_local_mesh(seq=P7_RANKS, device=DEV)
    p = mesh.coord("model")
    cfg = get_config("llama-7b").replace(n_layers=P7_LAYERS)
    shape = ShapeSpec("chip7", P7_T, 1, "train")
    models = {s: DecoderLM(cfg, DEV, mesh=mesh, par=make_parallel_config(
        mesh, shape, schedule=s)) for s, _ in P7_RUNS}
    data = {s: SyntheticTokens(cfg, shape, device=DEV, seed=0, mesh=mesh,
                               par=m.par) for s, m in models.items()}
    params = trainable(models["balanced"].init(seed=0))
    out = {"transport": mesh.transport, "rank": p}
    b0 = data["balanced"].batch(0)
    out["ce"] = _token_ce(models["balanced"], params, b0).cpu()
    real = sp.build_plan
    sp.build_plan = _helperless(real)
    try:
        out["ce_control"] = _token_ce(models["balanced"], params, b0).cpu()
    finally:
        sp.build_plan = real
    ref = torch.load(ref_path, map_location=DEV) if p == 0 else None
    out["grad_err"] = {}
    for sched, fault in P7_GRAD_RUNS:
        with _backward_fault(fault):
            gs = _attn_grads(models[sched], params, data[sched].batch(0))
        if ref is not None:
            out["grad_err"][f"{sched}/{fault or 'sound'}"] = _grad_err(gs,
                                                                       ref)
        del gs
    del ref
    # the controls through a whole train step from the same start: step
    # 1's gradient norm and the loss of batch 1 after the update
    bal, tc = models["balanced"], _p7_tc()
    saved = [t.detach().clone() for t in leaves(params)]
    out["control_steps"] = {}
    for fault in ("home", "dqb"):
        opt = adamw.init(params)
        with _backward_fault(fault):
            m = make_train_step(bal, tc)(params, opt, b0)
        with torch.no_grad():
            l2 = float(bal.loss(params, data["balanced"].batch(1))[0])
            for t, v in zip(leaves(params), saved):
                t.copy_(v)
        out["control_steps"][fault] = (m["gnorm"], l2)
        del opt
    # the same step under gloo-staged (printed beside the gated reading:
    # the transports sum the gradients in different orders)
    stg = make_local_mesh(seq=P7_RANKS, device=DEV, transport="gloo-staged")
    st_bal = DecoderLM(cfg, DEV, mesh=stg, par=bal.par)
    opt = adamw.init(params)
    m = make_train_step(st_bal, tc)(params, opt, b0)
    with torch.no_grad():
        l2 = float(st_bal.loss(params, data["balanced"].batch(1))[0])
        for t, v in zip(leaves(params), saved):
            t.copy_(v)
    out["staged_step"] = (m["gnorm"], l2)
    del opt, st_bal
    _free()
    out["auto"] = _p7_auto(cfg, mesh, shape, params, b0, saved,
                           auto_path if p == 0 else None)
    del saved
    _free()
    comms = list({id(c): c for m in models.values()
                  for c in (m.seq_group, m.token_group)}.values())
    opt = adamw.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, i = [], 0
    for sched, n in P7_RUNS:
        step = make_train_step(models[sched], tc)
        for _ in range(n):
            batch = data[sched].batch(i)
            torch.cuda.synchronize()
            build.reset_launches()
            w0 = sum(c.shift_wait_s for c in comms)
            r0 = sum(c.reduce_s for c in comms)
            t0 = time.perf_counter()
            m = step(params, opt, batch)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            steps.append(dict(
                schedule=sched, loss=m["loss"], gnorm=m["gnorm"], sec=sec,
                shift_wait=sum(c.shift_wait_s for c in comms) - w0,
                reduce_sec=sum(c.reduce_s for c in comms) - r0,
                skipped=m["skipped_nonfinite"],
                launches={k: build.LAUNCHES[k] for k in BWD_KERNELS}))
            i += 1
    out["steps"] = steps
    out["peak"] = torch.cuda.max_memory_allocated()
    out["comm_s"] = _process_comm_seconds()
    return out


def _p7_one(cfg, shape, ref_path):
    """P = 1 on this process: the first batch's per-token losses, its
    attention projections' gradients (saved at ``ref_path``), and two
    train steps from the same weights (step 1's loss and gradient norm,
    step 2's loss)."""
    one = DecoderLM(cfg, DEV)
    params = trainable(one.init(seed=0))
    ds = SyntheticTokens(cfg, shape, device=DEV, seed=0)
    b0 = ds.batch(0)
    ce1 = _token_ce(one, params, b0).cpu()
    torch.save([g.cpu() for g in _attn_grads(one, params, b0)], ref_path)
    step = make_train_step(one, _p7_tc())
    opt = adamw.init(params)
    s1 = step(params, opt, b0)
    s2 = step(params, opt, ds.batch(1))
    del one, params, opt, step
    _free()
    return ce1, s1, s2


def multi_rank():
    """Phase 7: a gloo world of 4 ranks sharing the one card, training
    llama-7b's width at depth 2 on one sequence of 32768 tokens (8192 a
    rank) under remat_aware: 2 balanced steps, 1 ring, 1 zigzag.  Before
    the world starts, the same weights and batches run on one process
    (P = 1), for the per-token losses, gradients and first two steps the
    ranks are held to."""
    cfg = get_config("llama-7b").replace(n_layers=P7_LAYERS)
    shape = ShapeSpec("chip7", P7_T, 1, "train")
    want = {s: _plan_launches(s) for s, _ in P7_RUNS}
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "grads1.pt")
        auto_path = os.path.join(tmp, "auto_a.pt")
        ce1, s1, s2 = _p7_one(cfg, shape, ref_path)
        say(f"  P = 1: loss {float(ce1.mean()):.6f} over {P7_T} tokens "
            f"({cfg.name} width, {P7_LAYERS} layers, bf16); step 1 loss "
            f"{s1['loss']:.6f} gnorm {s1['gnorm']:.4f}, step 2 loss "
            f"{s2['loss']:.6f}")
        t0 = time.perf_counter()
        res = spawn(_p7_rank, P7_RANKS, (ref_path, auto_path), device=DEV,
                    timeout=P7_TIMEOUT, threads=2)
        wall = time.perf_counter() - t0
        # phase 18 holds its 2D runs to the same P = 1 run
        p1 = dict(ce=ce1, gnorm=s1["gnorm"], grads=torch.load(ref_path))
        res.sort(key=lambda r: r["rank"])
        auto_launches = _p7_auto_gates(res, ce1, auto_path, want)
    res.sort(key=lambda r: r["rank"])
    _say_comm(7, res)
    check(all(r["transport"] == P7_TRANSPORT for r in res),
          f"transport {[r['transport'] for r in res]}")
    ce4 = torch.cat([r["ce"] for r in res], dim=1)
    ctl = torch.cat([r["ce_control"] for r in res], dim=1)
    check(bool(torch.isfinite(ce4).all()), "P = 4 losses not finite")
    d_tok = float((ce4 - ce1).abs().mean())
    d_ctl = float((ctl - ce1).abs().mean())
    d_loss = abs(float(ce4.mean()) - float(ce1.mean()))
    d_loss_ctl = abs(float(ctl.mean()) - float(ce1.mean()))
    st4 = res[0]["steps"]
    step1 = abs(st4[0]["loss"] - float(ce1.mean()))
    d_gnorm = abs(st4[0]["gnorm"] - s1["gnorm"]) / s1["gnorm"]
    d_loss2 = abs(st4[1]["loss"] - s2["loss"])
    gerr = res[0]["grad_err"]
    ctl_steps = {f: (abs(gn - s1["gnorm"]) / s1["gnorm"],
                     abs(l2 - s2["loss"]))
                 for f, (gn, l2) in res[0]["control_steps"].items()}
    gn_st, l2_st = res[0]["staged_step"]
    staged = (abs(gn_st - s1["gnorm"]) / s1["gnorm"], abs(l2_st - s2["loss"]))
    say(f"  P = 4 (balanced) vs P = 1: |Δloss| {d_loss:.3e} (limit "
        f"{P7_LOSS_TOL}), mean |Δce| a token {d_tok:.3e} (limit "
        f"{P7_CE_TOL}), max {float((ce4 - ce1).abs().max()):.3e}; control "
        f"(helper routes dropped): |Δloss| {d_loss_ctl:.3e}, mean |Δce| a "
        f"token {d_ctl:.3e}")
    say("  backward vs P = 1, worst ‖Δg‖/‖g‖ of wq/wk/wv (limit "
        f"{P7_GRAD_TOL}): " + ", ".join(f"{k} {v:.3e}"
                                        for k, v in gerr.items()))
    say(f"  step 1 gnorm {st4[0]['gnorm']:.4f} vs {s1['gnorm']:.4f}: "
        f"relative |Δ| {d_gnorm:.3e} (limit {P7_GNORM_TOL}); step 2 loss "
        f"{st4[1]['loss']:.6f} vs {s2['loss']:.6f}: |Δ| {d_loss2:.3e} "
        f"(limit {P7_LOSS2_TOL}); controls: " + ", ".join(
            f"{f} {gn:.3e} / {l2:.3e}" for f, (gn, l2) in ctl_steps.items()))
    say(f"  the same readings with step 1's gradients summed by "
        f"gloo-staged instead of {P7_TRANSPORT} (printed, not gated): gnorm "
        f"relative |Δ| {staged[0]:.3e}, step 2 loss |Δ| {staged[1]:.3e}")
    check(d_tok <= P7_CE_TOL and d_loss <= P7_LOSS_TOL
          and step1 <= P7_LOSS_TOL,
          f"P = 4 vs P = 1: per-token {d_tok}, loss {d_loss}, first step's "
          f"loss {step1}")
    check(d_ctl > P7_CE_TOL and d_loss_ctl > P7_LOSS_TOL,
          f"the limits do not reject the control without helper routes "
          f"(per-token {d_ctl}, loss {d_loss_ctl})")
    for sched, fault in P7_GRAD_RUNS:
        e = gerr[f"{sched}/{fault or 'sound'}"]
        if fault:
            check(e > P7_GRAD_TOL, f"the gradient limit does not reject "
                  f"the {fault} control ({e})")
        else:
            check(e <= P7_GRAD_TOL, f"{sched} gradients vs P = 1: {e}")
    check(d_gnorm <= P7_GNORM_TOL and d_loss2 <= P7_LOSS2_TOL,
          f"P = 4 vs P = 1: step 1 gnorm {d_gnorm}, step 2 loss {d_loss2}")
    for fault, (_, e_l2) in ctl_steps.items():
        check(e_l2 > P7_LOSS2_TOL, f"the step-2 loss limit does not reject "
              f"the {fault} control ({e_l2})")
    check(ctl_steps["home"][0] > P7_GNORM_TOL, f"the gradient-norm limit "
          f"does not reject the home control ({ctl_steps['home'][0]})")
    launches = {k: 0 for k in BWD_KERNELS}
    for r in res:
        for i, st in enumerate(r["steps"]):
            check(st["skipped"] == 0, f"rank {r['rank']} step {i + 1} "
                  "skipped")
            check(np.isfinite(st["loss"]), f"rank {r['rank']} step {i + 1}"
                  f" loss {st['loss']}")
            w = P7_LAYERS * want[st["schedule"]][r["rank"]]
            check(all(st["launches"][k] == w for k in BWD_KERNELS),
                  f"rank {r['rank']} step {i + 1} ({st['schedule']}): "
                  f"launches {st['launches']}, want {w} each")
            for k in BWD_KERNELS:
                launches[k] += st["launches"][k]
        say(f"  rank {r['rank']}: peak {r['peak'] / 2**30:.2f} GiB; "
            "launches A/C/D a step " + ", ".join(
                f"{st['schedule']} {st['launches']['flash_fwd']}/"
                f"{st['launches']['flash_bwd_dq']}/"
                f"{st['launches']['flash_bwd_dkv']}"
                for st in r["steps"]))
    for i, st in enumerate(st4):
        losses = {r["steps"][i]["loss"] for r in res}
        check(len(losses) == 1, f"step {i + 1}: ranks disagree {losses}")
        say(f"  step {i + 1} {st['schedule']:<8} loss {st['loss']:.5f} "
            f"gnorm {st['gnorm']:.3f} "
            f"{max(r['steps'][i]['sec'] for r in res):.2f} s; host blocked "
            "on shifts / in gradient and loss all-reduces, per rank: "
            + ", ".join(f"{r['steps'][i]['shift_wait']:.2f}/"
                        f"{r['steps'][i]['reduce_sec']:.2f}" for r in res)
            + " s")
    for k in BWD_KERNELS:
        launches[k] += auto_launches[k]
    say(f"  world of {P7_RANKS} ranks: {wall:.1f} s, spawn included")
    return dict(launches=launches, d_tok=d_tok, d_ctl=d_ctl, d_loss=d_loss,
                d_loss_ctl=d_loss_ctl, grad_err=gerr, d_gnorm=d_gnorm,
                d_loss2=d_loss2, staged=staged, p1=p1,
                peaks=[r["peak"] for r in res])


# ---------------------------------------------------------------- phase 27

P27_RANKS, P27_MESH = 4, (2, 2)           # (data, model)
# (a): llama-7b's full width at depth 4 of 32, one sequence of 16,384
# tokens a data rank (8,192 a rank), 3 steps
P27_LAYERS, P27_T, P27_B, P27_STEPS = 4, 16384, 2, 3
# (b): deepseek-v2-lite-16b, the dense layer 0 and one MoE layer, 4,096
# tokens a step (1,024 a rank), step 1's gradients and 2 train steps
P27_MOE_LAYERS, P27_MOE_T, P27_MOE_B, P27_MOE_STEPS = 2, 2048, 2, 2
P27_SEED = 27
P27_TIMEOUT = 600
# a rank's parameter bytes over one replica's at data 2: its shards (the
# replicated norm weights add 3.6e-5 of them at llama-7b's width)
P27_HALF = (0.49, 0.51)


def _p27_tc(steps):
    return TrainConfig(lr=1e-4, warmup_steps=1, total_steps=steps)


def _p27_cfg(moe=False):
    if moe:
        return get_config(P15_ARCH).replace(n_layers=P27_MOE_LAYERS)
    return get_config("llama-7b").replace(n_layers=P27_LAYERS)


def _p27_shape(moe=False):
    return (ShapeSpec("chip27b", P27_MOE_T, P27_MOE_B, "train") if moe
            else ShapeSpec("chip27", P27_T, P27_B, "train"))


@contextlib.contextmanager
def _own_block_fault(model):
    """Phase 27's planted fault: the FSDP backward keeps its own block of
    each whole weight's gradient, the other data rank's contribution not
    summed in (the reduce-scatter of the FSDP group replaced by a
    slice)."""
    g = model.fsdp.group

    def own(x, dim):
        n = x.shape[dim] // g.size
        return x.narrow(dim, g.rank * n, n).contiguous()
    g.reduce_scatter = own
    try:
        yield
    finally:
        del g.reduce_scatter


def _p27_one(moe, path):
    """Phase 27's one process on the same global batch and weights (seed
    27, the ranks' shards sliced from the same draws): step 1's loss, aux
    and gradients (saved at ``path``, flatten order, on the host), then
    the train steps.  (b) keeps the pairs each rank keeps of its own rows
    (``_Keep(split=4)``) and saves its expert choices for the ranks to
    replay (``path + ".calls"``)."""
    cfg, shape = _p27_cfg(moe), _p27_shape(moe)
    steps = P27_MOE_STEPS if moe else P27_STEPS
    one = DecoderLM(cfg, DEV)
    params = trainable(one.init(seed=P27_SEED))
    ds = SyntheticTokens(cfg, shape, device=DEV, seed=0)
    b0 = ds.batch(0)
    n_rows = shape.seq_len * shape.global_batch // P27_RANKS
    rk = _Router() if moe else contextlib.nullcontext()
    from repro_torch.models.moe import capacity
    kp = (_Keep(split=P27_RANKS, cap=capacity(cfg, n_rows)) if moe
          else contextlib.nullcontext())
    t0 = time.perf_counter()
    with rk, kp:
        loss, met = one.loss(params, b0)
        gs = torch.autograd.grad(loss, leaves(params))
        first = [float(x.detach()) for x in (loss, met["ce"], met["aux"])]
        torch.save([g.cpu() for g in gs], path)
        del gs, loss, met
        step = make_train_step(one, _p27_tc(steps))
        opt = adamw.init(params)
        runs = [step(params, opt, ds.batch(i)) for i in range(steps)]
    if moe:
        torch.save([c.cpu() for c in rk.seen], path + ".calls")
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    names = _leaf_names(params)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    del one, params, opt, step
    _free()
    return dict(first=first, steps=runs, bytes=nbytes, names=names,
                sec=sec)


def _p27_grads(model, params, batch, ref, calls=None):
    """Step 1's loss, ce, aux and this rank's gradients summed as the train
    step sums them (``train/step.sum_grads``: the shards' arrive summed
    over data by the reduce-scatter), gathered whole over the FSDP group
    and held to the one process's ``ref`` (this rank's rows of the routed
    experts): (first, worst leaf max|Δg| / max|g₁| over the world, its
    index).  Every rank calls it (collectives)."""
    from repro_torch.core.tree import flatten
    from repro_torch.train.step import sum_grads
    ps, rebuild = flatten(params)
    with (_Router(calls=calls) if calls is not None
          else contextlib.nullcontext()):
        loss, met = model.loss(params, batch)
        raw = torch.autograd.grad(loss, ps)
    first = [float(x.detach()) for x in (loss, met["ce"], met["aux"])]
    del loss, met
    grads, experts = sum_grads(model, params, raw)
    del raw
    whole = leaves(model.fsdp.full(rebuild(grads)))
    del grads
    num = torch.zeros(len(whole), device=DEV)
    den = torch.zeros(len(whole), device=DEV)
    n = 1 << 24
    for i, (g, r) in enumerate(zip(whole, ref)):
        if experts[i]:
            r = TF.expert_rows(model.cfg, r, model.expert_group)
        a, b = g.reshape(-1), r.reshape(-1)
        for j in range(0, a.numel(), n):
            x = b[j:j + n].to(DEV).float()
            num[i] = torch.maximum(num[i],
                                   (a[j:j + n].float() - x).abs().max())
            den[i] = torch.maximum(den[i], x.abs().max())
    del whole
    model.mesh.world.all_reduce_([num, den], op="max")
    err = (num / den.clamp(min=1e-30)).cpu()
    i = int(err.argmax())
    return first, float(err[i]), i


def _p27_case(rank, mesh, moe, path):
    """One rank's part of (a) or (b): step 1's gradients sound and under
    the planted fault against the one process's, this rank's bytes, then
    the train steps (launches, losses, norms, seconds, host seconds in
    the FSDP gathers and reduce-scatters, the peak over the steps)."""
    cfg, shape = _p27_cfg(moe), _p27_shape(moe)
    steps = P27_MOE_STEPS if moe else P27_STEPS
    par = make_parallel_config(mesh, shape)
    model = DecoderLM(cfg, DEV, mesh=mesh, par=par, fsdp=True)
    params = trainable(model.init(seed=P27_SEED))
    data = SyntheticTokens(cfg, shape, device=DEV, seed=0, mesh=mesh,
                           par=par)
    ref = torch.load(path, mmap=True)
    calls = None
    if moe:
        n = shape.seq_len * shape.global_batch // P27_RANKS
        calls = [c[rank * n:(rank + 1) * n].to(DEV)
                 for c in torch.load(path + ".calls")]
    n_moe = cfg.n_layers - cfg.moe.n_dense_layers if moe else 0
    b0 = data.batch(0)
    out = {"rank": rank, "transport": mesh.transport,
           "coords": (mesh.coord("data"), mesh.coord("model")),
           "batch_axes": par.batch_axes, "fsdp": model.fsdp.group.size}
    out["first"], out["grad_err"], out["grad_leaf"] = _p27_grads(
        model, params, b0, ref, calls and calls[:2 * n_moe])
    with _own_block_fault(model):
        f, e, i = _p27_grads(model, params, b0, ref,
                             calls and calls[:2 * n_moe])
    out["fault"] = dict(first=f, grad_err=e, grad_leaf=i)
    del ref
    _free()
    opt = adamw.init(params)
    out["bytes"] = (sum(t.numel() * t.element_size() for t in leaves(params)),
                    sum(t.numel() * t.element_size()
                        for t in leaves(opt.m) + leaves(opt.v)),
                    sum(t.numel() for t in leaves(params)))
    kernels = P14_KERNELS if moe else BWD_KERNELS
    step = make_train_step(model, _p27_tc(steps))
    g = model.fsdp.group
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = (g.gather_s, g.scatter_s, g.reduce_s)
    run = []
    for i in range(steps):
        batch = data.batch(i)
        replay = (_Router(calls=calls[(2 + 2 * i) * n_moe:
                                      (4 + 2 * i) * n_moe])
                  if moe else contextlib.nullcontext())
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        with replay:
            m = step(params, opt, batch)
        torch.cuda.synchronize()
        run.append(dict(loss=m["loss"], ce=m["ce"], aux=m["aux"],
                        gnorm=m["gnorm"], skipped=m["skipped_nonfinite"],
                        sec=time.perf_counter() - t0,
                        launches={k: build.LAUNCHES[k] for k in kernels}))
    out["steps"] = run
    out["peak"] = torch.cuda.max_memory_allocated()
    out["fsdp_s"] = dict(gather=g.gather_s - c0[0],
                         scatter=g.scatter_s - c0[1],
                         fetch=g.reduce_s - c0[2])
    del model, params, opt, step
    _free()
    return out


def _p27_rank(rank, tmp):
    """One rank of phase 27's world: (a), then (b) (:func:`_p27_case`)."""
    mesh = make_local_mesh(seq=P27_MESH[1], data=P27_MESH[0], device=DEV)
    out = {"a": _p27_case(rank, mesh, False, os.path.join(tmp, "a.pt")),
           "b": _p27_case(rank, mesh, True, os.path.join(tmp, "b.pt"))}
    out["rank"] = rank
    out["comm_s"] = _process_comm_seconds()
    return out


def _p27_gates(name, res, one, moe):
    """Phase 27 (a) or (b)'s gates against the one process: (a) phase 7's
    loss limit on every step's loss, its norm limit on step 1's gradient
    norm; (b) phase 15's bar (one bf16 step) on step 1's loss and aux,
    step 1's norm and step 2's loss; both: every gradient leaf, gathered,
    within 5% of its max |g|, a limit the planted fault must exceed; the
    ranks agree; each step launched A, C and D as the plan says."""
    cfg, shape = _p27_cfg(moe), _p27_shape(moe)
    rs = [r[name] for r in res]
    r0 = rs[0]
    names = one["names"]
    check(all(r["transport"] == P8_TRANSPORT for r in rs),
          f"transport {[r['transport'] for r in rs]}")
    check(all(r["batch_axes"] == ("data",) and r["fsdp"] == P27_MESH[0]
              for r in rs), f"({name}) batch axes / FSDP group "
          f"{[(r['batch_axes'], r['fsdp']) for r in rs]}")

    def rel(a, b):
        return abs(a - b) / abs(b)
    st, s1 = r0["steps"], one["steps"]
    if moe:
        d = dict(loss=rel(r0["first"][0], one["first"][0]),
                 aux=rel(r0["first"][2], one["first"][2]),
                 gnorm=rel(st[0]["gnorm"], s1[0]["gnorm"]),
                 loss2=rel(st[1]["loss"], s1[1]["loss"]))
        lim = dict.fromkeys(d, P15_TOL)
    else:
        d = {f"loss{i + 1}": abs(st[i]["loss"] - s1[i]["loss"])
             for i in range(len(st))}
        d["first"] = abs(r0["first"][0] - one["first"][0])
        lim = dict.fromkeys(d, P7_LOSS_TOL)
        d["gnorm"] = rel(st[0]["gnorm"], s1[0]["gnorm"])
        lim["gnorm"] = P7_GNORM_TOL
    err, fault = r0["grad_err"], r0["fault"]["grad_err"]
    say(f"  ({name}) FSDP on (data 2, model 2) vs one process: " + ", ".join(
        f"{k} {v:.3e} (limit {lim[k]:.3e})" for k, v in d.items())
        + f"; worst gradient leaf max|Δg|/max|g| {err:.4f} "
        f"({names[r0['grad_leaf']]}; limit {GRAD_REL_TOL}); planted fault "
        f"(own block, no sum over data): {fault:.4f} "
        f"({names[r0['fault']['grad_leaf']]}), its step-1 loss "
        f"{r0['fault']['first'][0]:.6f} vs {r0['first'][0]:.6f}")
    for k, v in d.items():
        check(v <= lim[k], f"phase 27 ({name}): {k} {v} vs one process")
    check(err <= GRAD_REL_TOL, f"phase 27 ({name}) gradients: "
          f"{names[r0['grad_leaf']]} {err}")
    check(fault > GRAD_REL_TOL, f"phase 27 ({name}): the gradient limit "
          f"does not reject the unsummed FSDP backward ({fault})")
    for i, s in enumerate(st):
        vals = {(r["steps"][i]["loss"], r["steps"][i]["gnorm"]) for r in rs}
        check(len(vals) == 1, f"({name}) step {i + 1}: ranks disagree "
              f"{vals}")
    P = P27_MESH[1]
    want = _plan_launches("balanced", P, shape.seq_len)
    kernels = P14_KERNELS if moe else BWD_KERNELS
    launches = {k: 0 for k in kernels}
    for r in rs:
        seq = r["coords"][1]
        for i, s in enumerate(r["steps"]):
            check(s["skipped"] == 0 and np.isfinite(s["loss"]),
                  f"({name}) rank {r['rank']} step {i + 1}: {s}")
            w = cfg.n_layers * want[seq]
            check(all(s["launches"][k] == w for k in kernels),
                  f"({name}) rank {r['rank']} step {i + 1}: launches "
                  f"{s['launches']}, want {w} each")
            for k in kernels:
                launches[k] += s["launches"][k]
        p, mo, numel = r["bytes"]
        say(f"  ({name}) rank {r['rank']} {r['coords']}: parameters "
            f"{p / 2**30:.3f} GiB ({p / one['bytes']:.5f} of one replica's "
            f"{one['bytes'] / 2**30:.3f}), moments {mo / 2**30:.3f} GiB; "
            f"peak {r['peak'] / 2**30:.2f} GiB over the steps; host seconds "
            f"in FSDP gathers / reduce-scatters / fetches "
            f"{r['fsdp_s']['gather']:.3f}/{r['fsdp_s']['scatter']:.3f}/"
            f"{r['fsdp_s']['fetch']:.3f}; launches A/C/D a step " + ", ".join(
                "/".join(str(s["launches"][k]) for k in kernels)
                for s in r["steps"]))
        check(mo == 8 * numel, f"rank {r['rank']}: moments {mo} bytes "
              f"for {numel} parameters (float32 m and v)")
        if not moe:
            check(P27_HALF[0] <= p / one["bytes"] <= P27_HALF[1],
                  f"rank {r['rank']} holds {p / one['bytes']:.4f} of one "
                  f"replica's parameter bytes")
    for i, s in enumerate(st):
        say(f"  ({name}) step {i + 1} loss {s['loss']:.6f} (one process "
            f"{s1[i]['loss']:.6f}) gnorm {s['gnorm']:.4f} "
            f"({s1[i]['gnorm']:.4f}) "
            f"{max(r['steps'][i]['sec'] for r in rs):.3f} s")
    return dict(launches=launches, d=d, grad_err=err, fault=fault,
                peaks=[r["peak"] for r in rs],
                bytes=[r["bytes"] for r in rs], one_bytes=one["bytes"])


def fsdp_ranks():
    """Phase 27: FSDP (ZeRO-3) training over (data 2, model 2), 4 ranks
    sharing the card over cuda-ipc: (a) llama-7b's width at depth 4,
    2 × 16,384 tokens a step, 3 steps; (b) deepseek-v2-lite-16b's dense
    layer 0 and one MoE layer, 4,096 tokens a step, replaying the one
    process's expert choices.  Each against one process on the same
    global batch and weights; a planted fault (no sum over data in the
    backward) rejected."""
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        one = {}
        for name, moe in (("a", False), ("b", True)):
            one[name] = _p27_one(moe, os.path.join(tmp, f"{name}.pt"))
            o = one[name]
            say(f"  one process ({name}: {_p27_cfg(moe).name}, "
                f"{_p27_cfg(moe).n_layers} layers, "
                f"{_p27_shape(moe).global_batch} x "
                f"{_p27_shape(moe).seq_len} tokens, {o['sec']:.1f} s): "
                f"step 1 loss {o['first'][0]:.6f} aux {o['first'][2]:.3e}; "
                "train steps " + ", ".join(
                    f"{s['loss']:.6f}/{s['gnorm']:.4f}" for s in o["steps"])
                + f"; parameters {o['bytes'] / 2**30:.3f} GiB")
        t0 = time.perf_counter()
        res = spawn(_p27_rank, P27_RANKS, (tmp,), device=DEV,
                    timeout=P27_TIMEOUT, threads=2)
        wall = time.perf_counter() - t0
    res.sort(key=lambda r: r["rank"])
    _say_comm(27, [dict(r, transport=r["a"]["transport"]) for r in res])
    a = _p27_gates("a", res, one["a"], False)
    b = _p27_gates("b", res, one["b"], True)
    sec = time.perf_counter() - t_all
    say(f"  world of {P27_RANKS} ranks: {wall:.1f} s, spawn included; "
        f"phase 27 {sec:.1f} s")
    return dict(launches=a["launches"], pair=b["launches"], a=a, b=b,
                peaks=a["peaks"], seconds=sec)


# ----------------------------------------------------------------- phase 8

P8_RANKS, P8_LAYERS, P8_T, P8_GEN = 4, 4, 65536, 32
P8_SCHED = "balanced"
P8_CTL_GEN = 8          # decode steps of each planted-fault run
P8_WARM_T = 4096        # the warm-up prompt
P8_TIMEOUT = 900
P8_TRANSPORT = "cuda-ipc"          # four ranks, one card
# Teacher-forced decode logits against the P = 1 dense path and the paged
# Engine: at every step max |Δ| ≤ P8_LOGIT_TOL × max |logit| of the
# reference step, phase 4's limit.  The planted faults (one rank's shard
# left out of the decode reduction; decode positions one off) must exceed
# it.  On the chip (H100, 700 W) the worst step read 1.40e-2 against the
# dense path and 1.41e-2 against the paged Engine; the controls 0.417
# (shard) and 0.155 (positions): the limit sits 3.6× above the sound run
# and 3.1× below the nearer control.
P8_LOGIT_TOL = 5e-2
P8_POOL_B, P8_POOL_BS, P8_POOL_NB = 4, 16, 64     # the serving step's shape
P8_POOL_LENS = (1000, 700, 513, 64)


def _p8_model(mesh):
    cfg = get_config("llama-7b").replace(n_layers=P8_LAYERS)
    par = make_parallel_config(mesh, ShapeSpec("chip8", P8_T, 1, "decode"),
                               schedule=P8_SCHED)
    return DecoderLM(cfg, DEV, par=par, mesh=mesh)


def _p8_prompt(vocab):
    return np.random.default_rng(8).integers(0, vocab, (1, P8_T)).astype(
        np.int32)


def _timed(times, key, fn):
    """``fn`` timed on the host between two device syncs (into
    ``times[key]``)."""
    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        times.setdefault(key, []).append(time.perf_counter() - t0)
        return out
    return run


@contextlib.contextmanager
def _decode_fault(model, fault, by=1):
    """A deliberately wrong decode while the block runs (phase 8's
    controls): ``"shard"`` — rank 1's shard left out of the decode
    reduction (its max, numerator and denominator replaced by the
    reduction's identity before each all-reduce of the cache's group);
    ``"pos"`` — every decode step at its position plus ``by`` (a paged
    engine's idle rows, at position 0, left alone)."""
    grp = model.decode_group
    if fault == "shard":
        reduce_ = grp.all_reduce_

        def faulty(tensors, op="sum"):
            if grp.rank == 1:
                for t in tensors:
                    t.fill_(NEG_INF if op == "max" else 0.0)
            return reduce_(tensors, op)
        grp.all_reduce_ = faulty
    else:
        decode = model.decode
        model.decode = lambda p, cache, token, pos: decode(
            p, cache, token, torch.where(pos > 0, pos + by, pos))
    try:
        yield
    finally:
        if fault == "shard":
            del grp.all_reduce_
        else:
            del model.decode


def _p8_pool(mesh):
    """llama-7b's 32 kv heads × 128 in a bf16 pool sharded head-parallel
    over the ranks, at the serving step's shape: kernel B on this rank's
    heads, all-gathered, against one B over every head (rank 0)."""
    cfg = get_config("llama-7b").replace(n_layers=1)
    a, B, bs, nb = cfg.attn, P8_POOL_B, P8_POOL_BS, P8_POOL_NB
    cache = PagedKVCache.create(cfg, block_size=bs, n_blocks=B * nb + 1,
                                max_reqs=B, device=DEV, mesh=mesh)
    check(cache.sharding == "heads", f"pool sharding {cache.sharding}")
    gen = torch.Generator(device=DEV).manual_seed(0)
    full = {k: randn(gen, (1, B * nb + 1, bs, a.n_kv_heads, a.head_dim),
                     torch.bfloat16) for k in ("k_pool", "v_pool")}
    r, h = cache.group.rank, cache.pools["k_pool"].shape[3]
    for k, pool in cache.pools.items():
        pool.copy_(full[k][:, :, :, r * h:(r + 1) * h])
    q = randn(gen, (B, 1, a.n_heads, a.head_dim), torch.bfloat16)
    bt = (1 + torch.arange(B * nb, device=DEV, dtype=torch.int32)).view(B,
                                                                         nb)
    lens = torch.tensor(P8_POOL_LENS, dtype=torch.int32, device=DEV)
    o = sharded_paged_decode_attn(q, cache, 0, bt, lens)
    if r:
        return None
    one = paged_attn(q, full["k_pool"][0], full["v_pool"][0], bt, lens,
                     mask=mk.causal())
    return dict(equal=bool(torch.equal(o, one)),
                max_abs=float((o.float() - one.float()).abs().max()),
                local_shape=tuple(cache.pools["k_pool"].shape))


def _p8_rank(rank):
    """One rank of phase 8's world: a warm-up, then the main run (one
    65536-token prompt, balanced prefill across the ranks, 32 greedy
    tokens through ``FixedSlotEngine``), the two planted-fault runs
    teacher-forced on its tokens, and the head-parallel pool."""
    mesh = make_local_mesh(seq=P8_RANKS, device=DEV)
    model = _p8_model(mesh)
    params = model.init(seed=0)
    prompt = _p8_prompt(model.cfg.vocab)
    out = {"rank": mesh.coord("model"), "transport": mesh.transport,
           "seq_axes": model.par.seq_axes,
           "shards": model.decode_group.size}
    eng = FixedSlotEngine(model, params)
    eng.generate({"tokens": prompt[:, :P8_WARM_T]}, 2)
    comms = list({id(c): c for c in (model.seq_group,
                                     model.decode_group)}.values())
    times = {}
    model.prefill = _timed(times, "prefill", model.prefill)
    model.decode = _timed(times, "decode", model.decode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    w0 = sum(c.shift_wait_s for c in comms)
    r0 = sum(c.reduce_s for c in comms)
    build.reset_launches()
    with _recorded(model) as logs:
        toks, _ = eng.generate({"tokens": prompt}, P8_GEN)
    launches = dict(build.LAUNCHES)
    out.update(
        tokens=toks.cpu(), logits=torch.stack(logs),
        launches=launches, prefill_s=times["prefill"][0],
        decode_ms=[1e3 * t for t in times["decode"]],
        shift_wait=sum(c.shift_wait_s for c in comms) - w0,
        reduce_s=sum(c.reduce_s for c in comms) - r0,
        peak=torch.cuda.max_memory_allocated(),
        peak_reserved=torch.cuda.max_memory_reserved())
    del model.prefill, model.decode
    out["controls"] = {}
    for fault in ("shard", "pos"):
        with _decode_fault(model, fault), _recorded(
                model, toks[:, :P8_CTL_GEN]) as logs:
            eng.generate({"tokens": prompt}, P8_CTL_GEN)
        out["controls"][fault] = torch.stack(logs)
    del eng, params
    _free()
    out["pool"] = _p8_pool(mesh)
    out["comm_s"] = _process_comm_seconds()
    return out


@contextlib.contextmanager
def _recorded(model, forced=None):
    """While the block runs, every ``prefill`` and ``decode`` of ``model``
    appends its last position's float32 logits (on the host) to the list
    it yields.  With ``forced`` (B, n) the decode that follows the k-th
    logits is fed ``forced[:, k - 1]`` instead of the engine's token
    (teacher forcing); a decode before any logits (the paged ``Engine``'s
    first, fed the prompt's last token) is left alone."""
    logs = []
    saved = {k: model.__dict__.get(k) for k in ("prefill", "decode")}
    prefill, decode = model.prefill, model.decode

    def pre(p, tokens, **kw):
        logits, cache = prefill(p, tokens, **kw)
        logs.append(logits[:, -1].float().cpu())
        return logits, cache

    def dec(p, cache, token, pos):
        if forced is not None and logs:
            k = len(logs)
            token = forced[:, k - 1:k].to(token.device, token.dtype)
        logits = decode(p, cache, token, pos)
        logs.append(logits[:, -1].float().cpu())
        return logits

    model.prefill, model.decode = pre, dec
    try:
        yield logs
    finally:
        for k, fn in saved.items():
            if fn is None:
                del model.__dict__[k]
            else:
                setattr(model, k, fn)


def _step_err(got, ref):
    """Worst over the steps of max |Δ| / max |ref| of the step's logits."""
    return max(float((g - r).abs().max() / r.abs().max())
               for g, r in zip(got, ref))


def long_serve():
    """Phase 8: a gloo world of 4 ranks sharing the one card serves one
    65536-token prompt through ``FixedSlotEngine`` (balanced prefill
    across the ranks, the cache sharded along the sequence, 32 greedy
    tokens by flash-decoding across the shards), then the same prompt at
    P = 1 in this process through the dense path and through the paged
    ``Engine``, teacher-forced on the ranks' tokens."""
    cfg = get_config("llama-7b").replace(n_layers=P8_LAYERS)
    want = _plan_launches(P8_SCHED, P8_RANKS, P8_T)
    t0 = time.perf_counter()
    res = spawn(_p8_rank, P8_RANKS, (), device=DEV, timeout=P8_TIMEOUT,
                threads=2)
    wall = time.perf_counter() - t0
    res.sort(key=lambda r: r["rank"])
    _say_comm(8, res)
    check(all(r["transport"] == P8_TRANSPORT for r in res),
          f"transport {[r['transport'] for r in res]}")
    check(all(r["seq_axes"] == ("model",) and r["shards"] == P8_RANKS
              for r in res), "the cache is not sharded over the 4 ranks")
    toks = res[0]["tokens"]
    check(tuple(toks.shape) == (1, P8_GEN), f"tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "token outside the vocabulary")
    for r in res:
        check(torch.equal(r["tokens"], toks),
              f"rank {r['rank']} emitted other tokens")
        check(bool(torch.isfinite(r["logits"]).all()),
              f"rank {r['rank']}: non-finite logits")
        w = P8_LAYERS * want[r["rank"]]
        check(r["launches"]["flash_fwd"] == w,
              f"rank {r['rank']}: kernel A launched "
              f"{r['launches']['flash_fwd']} times in prefill, want {w}")
        check(r["launches"]["paged_decode"] == 0,
              f"rank {r['rank']}: kernel B launched on the dense path")
        dm = r["decode_ms"]
        say(f"  rank {r['rank']}: prefill {r['prefill_s']:.3f} s "
            f"({P8_T // P8_RANKS} tokens, kernel A {r['launches']['flash_fwd']}"
            f" launches = {want[r['rank']]} items x {P8_LAYERS} layers), "
            f"decode {np.median(dm):.2f} ms a step (median of {len(dm)}; "
            f"{min(dm):.2f}-{max(dm):.2f}), host blocked on shifts "
            f"{r['shift_wait']:.3f} s, in all-reduces and broadcasts "
            f"{r['reduce_s']:.3f} s, peak {r['peak'] / 2**30:.2f} GiB "
            f"allocated ({r['peak_reserved'] / 2**30:.2f} reserved)")
    say(f"  world of {P8_RANKS} ranks: {wall:.1f} s, spawn included; "
        f"tokens equal on every rank: {toks[0, :8].tolist()} ...")
    logits4 = res[0]["logits"]

    # (a) the same dense path at P = 1 in this process
    one = DecoderLM(cfg, DEV)
    params = one.init(seed=0)
    prompt = _p8_prompt(cfg.vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {}
    one.prefill = _timed(times, "prefill", one.prefill)
    one.decode = _timed(times, "decode", one.decode)
    with _recorded(one, toks) as logs:
        FixedSlotEngine(one, params).generate({"tokens": prompt}, P8_GEN)
    dense1 = torch.stack(logs)
    peak1 = torch.cuda.max_memory_allocated()
    del one.prefill, one.decode
    _free()
    # (b) the paged Engine at P = 1 (kernels A and B)
    bs = 16
    eng = Engine(one, params, max_batch=1, block_size=bs,
                 prefill_chunk_tokens=4096,
                 n_blocks=-(-(P8_T + P8_GEN + 1) // bs) + 2,
                 prefix_cache=False)
    with _recorded(one, toks) as logs:
        eng.submit(prompt[0], max_new_tokens=P8_GEN + 1)
        eng.run()
    paged1 = torch.stack(logs)
    peak1 = max(peak1, torch.cuda.max_memory_allocated())
    st = eng.stats()
    say(f"  P = 1 in this process: dense prefill {times['prefill'][0]:.3f} "
        f"s, decode {np.median(times['decode']) * 1e3:.2f} ms a step; "
        f"paged Engine prefill {st['prefill_seconds']:.3f} s in "
        f"{st['prefill_chunks']} chunks, decode "
        f"{1e3 * st['decode_seconds'] / st['decode_steps']:.2f} ms a step "
        f"(CUDA-event spans)")
    del eng, one, params
    _free()
    check(dense1.shape == logits4.shape == paged1.shape,
          f"steps {dense1.shape} {logits4.shape} {paged1.shape}")
    e_dense, e_paged = _step_err(logits4, dense1), _step_err(logits4,
                                                            paged1)
    e_ctl = {f: _step_err(c[1:], dense1[1:P8_CTL_GEN + 1])
             for f, c in res[0]["controls"].items()}
    say(f"  teacher-forced decode logits, worst step max|Δ| / max|logit| "
        f"over {P8_GEN + 1} steps (limit {P8_LOGIT_TOL}): P = 4 vs P = 1 "
        f"dense {e_dense:.3e}, vs the paged Engine {e_paged:.3e}; "
        f"controls vs P = 1 dense: " + ", ".join(
            f"{f} {e:.3e}" for f, e in e_ctl.items()))
    check(e_dense <= P8_LOGIT_TOL and e_paged <= P8_LOGIT_TOL,
          f"P = 4 decode logits: vs dense {e_dense}, vs paged {e_paged}")
    for f, e in e_ctl.items():
        check(e > P8_LOGIT_TOL, f"the logit limit does not reject the "
              f"{f} control ({e})")
    pool = res[0]["pool"]
    say(f"  head-parallel pool: {P8_RANKS} ranks of local shape "
        f"{pool['local_shape']}; gathered kernel B vs one B over every "
        f"head: bitwise equal {pool['equal']} (max |Δ| "
        f"{pool['max_abs']:.3e})")
    check(pool["equal"], "the head-parallel pool differs from one B")
    total = sum(r["peak"] for r in res) + peak1
    say(f"  peak memory: ranks {sum(r['peak'] for r in res) / 2**30:.2f} "
        f"GiB allocated together, P = 1 runs {peak1 / 2**30:.2f} GiB, "
        f"{total / 2**30:.2f} GiB in all")
    return dict(launches={"flash_fwd": sum(r["launches"]["flash_fwd"]
                                           for r in res)},
                e_dense=e_dense, e_paged=e_paged, e_ctl=e_ctl)


# ----------------------------------------------------------------- phase 9

P9_DEPTH = 4
P9_DRAFT, P9_DRAFT_SEED = "smollm-360m", 7
P9_HOT = (1, 0.8)       # (request, temperature): the one sampled request
P9_MISS = (2, 2)        # the oracle's wrong proposal: (request, draft index)
P9_STORM = dict(seed=0, n_steps=20, rate=0.5)
P9_CTL_NEW = 6          # tokens a request in each planted-fault run
P9_CORRUPT_STEP = 8     # every request decodes by then (prefill: steps 0-3)


class OracleDraft(DraftSource):
    """Proposes the vanilla run's own continuation of each request
    (``streams[rid]``), except a wrong token at index ``P9_MISS[1]`` for
    request ``P9_MISS[0]``; keeps each step's (rid, accepted, proposed)."""

    def __init__(self, streams, vocab):
        self.streams, self.vocab, self.seen = streams, vocab, []

    def propose(self, req, k):
        e = len(req.emitted)
        out = [int(t) for t in self.streams[req.rid][e:e + k]]
        i = P9_MISS[1]
        if req.rid == P9_MISS[0] and len(out) > i:
            out[i] = (out[i] + 1) % self.vocab
        return out

    def observe(self, req, n_acc, proposed):
        self.seen.append((req.rid, n_acc, proposed))


def _conserved(cache, what):
    a = cache.allocator
    a.check_conservation()
    check(a.n_free + cache.n_cache_blocks == a.n_usable,
          f"{what}: {a.n_usable - a.n_free - cache.n_cache_blocks} blocks "
          "still held after the run")


def _p9_run(model, params, prompts, temps, kw, n_new=P4_NEW, draft=None,
            router=None, forced=None, **ekw):
    """One engine over the phase's requests (request i: seed i), with the
    meter on (and ``router``, phase 12's), teacher-forced on ``forced``
    (:func:`_forcing`); both allocators must conserve afterwards."""
    eng = Engine(model, params, draft=draft, **kw, **ekw)
    with _meter(model, eng, router) as rec, _forcing(eng, forced):
        rids = [eng.submit(p, max_new_tokens=n_new, temperature=t, seed=i)
                for i, (p, t) in enumerate(zip(prompts, temps))]
        check(rids == list(range(len(prompts))), f"rids {rids}")
        out = eng.run()
        torch.cuda.synchronize()
    _conserved(eng.cache, "target pool")
    if isinstance(draft, ModelDraft):
        _conserved(draft.cache, "draft pool")
        check(not draft._slots, "draft state left after the run")
    return dict(eng=eng, out=[out[r] for r in rids], rec=rec,
                st=eng.stats())


def _gap(row, temp, seed, position):
    """Top-two gap of what a request's sampler ranks at ``position``: the
    logits, plus T · its Gumbel draw when sampled (categorical takes the
    argmax of logits / T + g)."""
    lf = row.float().cpu().numpy()
    if temp > 0:
        key = prng.fold_in(prng.prng_key(seed), position)
        lf = lf + np.float32(temp) * prng.gumbel(key, lf.shape)
    top = np.sort(lf)[-2:]
    return float(top[1] - top[0])


def _p9_compare(ref, run, prompts, temps, gate=True):
    """``run``'s streams and committed rows against the vanilla ``ref``:
    per request, the rows up to the first divergence (their context is the
    same) within LOGIT_REL_TOL of max |logit| of ref's row; a divergence
    passes (and is listed) only where ref's top-two gap is below that limit.
    Returns (worst relative logit error, divergences)."""
    worst, divs = 0.0, []
    for i, (p, T) in enumerate(zip(prompts, temps)):
        a, b = ref["out"][i], run["out"][i]
        n = min(len(a), len(b))
        j = next((j for j in range(n) if a[j] != b[j]), n)
        for jj in range(min(j + 1, len(b))):
            r = ref["rec"]["logits"][(i, len(p) + jj)].float()
            g = run["rec"]["logits"][(i, len(p) + jj)].float()
            worst = max(worst, float((g - r).abs().max() / r.abs().max()))
        if j < n:
            r = ref["rec"]["logits"][(i, len(p) + j)]
            gap = _gap(r, T, i, len(p) + j)
            lim = LOGIT_REL_TOL * float(r.float().abs().max())
            divs.append((i, j, gap, lim))
            check(not gate or gap < lim,
                  f"request {i} diverges at token {j} ({a[j]} vs {b[j]}) "
                  f"where the vanilla top-two gap {gap:.4f} is not below "
                  f"the limit {lim:.4f}")
        elif gate:
            check(len(b) == len(a), f"request {i}: {len(b)} tokens, vanilla "
                  f"{len(a)}")
    check(not gate or worst <= LOGIT_REL_TOL,
          f"verify rows vs vanilla decode: {worst} of max |logit| over "
          f"{LOGIT_REL_TOL}")
    return worst, divs


@contextlib.contextmanager
def _verify_fault(model, fault):
    """A deliberately wrong verify while the block runs: ``"rope"`` — the
    rows rotated at their positions plus one (their K/V still written where
    they belong); ``"order"`` — kernel B attends before the step's own rows
    are written (the writes land after it, layer by layer)."""
    if fault == "rope":
        verify, rope = model.verify, LY.rope_tables

        def shifted(*a):
            LY.rope_tables = lambda pos, *r: rope(pos + 1, *r)
            try:
                return verify(*a)
            finally:
                LY.rope_tables = rope
        model.verify = shifted
        try:
            yield
        finally:
            del model.verify
        return
    scatter, attend, pending = TF._scatter, TF.paged_decode_attn, []
    verify = model.verify

    def attend_first(*a, **kw):
        o = attend(*a, **kw)
        for w in pending:
            scatter(*w)
        pending.clear()
        return o

    def faulty(*a):
        TF._scatter = lambda *w: pending.append(w)
        TF.paged_decode_attn = attend_first
        try:
            return verify(*a)
        finally:
            TF._scatter, TF.paged_decode_attn = scatter, attend
    model.verify = faulty
    try:
        yield
    finally:
        del model.verify


def _p9_report(name, r):
    st, rec = r["st"], r["rec"]
    n = max(st["decode_steps"], 1)
    a_t, b_t = (rec["target"][k] / n for k in ("flash_fwd", "paged_decode"))
    a_d, b_d = (rec["draft"][k] / n for k in ("flash_fwd", "paged_decode"))
    tok_s = st["decode_tokens"] / st["decode_seconds"]
    say(f"  {name:<24} {st['decode_tokens']} tokens in {st['decode_steps']} "
        f"steps ({st['steps']} engine steps): decode {tok_s:.1f} tok/s "
        f"({st['decode_seconds']:.3f} s, {rec['draft_s']:.3f} s of it in "
        f"the draft), {st['decode_tokens'] / n:.3f} "
        f"tokens a step, acceptance {st['spec_acceptance']:.3f} "
        f"({st['spec_accepted']}/{st['spec_proposed']}, rollbacks "
        f"{st['spec_rollbacks']}); launches a step: target A {a_t:.1f} B "
        f"{b_t:.1f}, draft A {a_d:.1f} B {b_d:.1f}")
    return dict(decode_tok_s=tok_s, draft_s=rec["draft_s"],
                decode_s=st["decode_seconds"],
                tokens_per_step=st["decode_tokens"] / n,
                acceptance=st["spec_acceptance"], steps=st["decode_steps"],
                target_A=a_t, target_B=b_t, draft_A=a_d, draft_B=b_d)


def _p9_trace(model, params, prompts, temps, kw, label, n, **ekw):
    """torch.profiler over ``n`` speculative steps once every request
    decodes (after its first verify step, so the draft has caught up)."""
    from torch.profiler import ProfilerActivity, profile
    eng = Engine(model, params, **kw, **ekw)
    rids = [eng.submit(p, max_new_tokens=P4_NEW, temperature=t, seed=i)
            for i, (p, t) in enumerate(zip(prompts, temps))]
    while any(eng.requests[r].state != "decode" for r in rids):
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    show_breakdown(label, prof, wall)


def speculative(model, params, prompts):
    """Phase 9: speculative serving of phase 4's llama-7b (weights and
    prompts) with smollm-360m at full size as the draft: vanilla, depth 0,
    an oracle draft, n-gram and the draft model, each held to the vanilla
    run; two planted verify faults; a seeded fault storm, twice."""
    cfg = model.cfg
    d_cfg = get_config(P9_DRAFT)
    d_model = DecoderLM(d_cfg, device=DEV)
    d_params = d_model.init(seed=P9_DRAFT_SEED)
    say(f"  draft {d_cfg.name}: {d_cfg.n_layers} layers d_model "
        f"{d_cfg.d_model} heads {d_cfg.attn.n_heads}/{d_cfg.attn.n_kv_heads}"
        f"x{d_cfg.attn.head_dim} vocab {d_cfg.vocab} "
        f"({d_cfg.param_count() / 1e9:.3f} B params, seed "
        f"{P9_DRAFT_SEED}); target {cfg.name} "
        f"vocab {cfg.vocab}: draft ids past it are clamped and rejected")
    kw = dict(P4_ENGINE)
    kw["n_blocks"] += len(prompts) * -(-P9_DEPTH // kw["block_size"])
    temps = [0.0] * len(prompts)
    temps[P9_HOT[0]] = P9_HOT[1]
    depth = SpecConfig(depth=P9_DEPTH, mode="model", draft_arch=d_cfg.name)

    def draft():
        return ModelDraft(d_model, d_params, block_size=kw["block_size"],
                          n_blocks=kw["n_blocks"], max_batch=kw["max_batch"])

    t0 = time.perf_counter()
    n_shapes = Engine(model, params, **kw).warm_prefill(
        max(map(len, prompts)) + P4_NEW + P9_DEPTH)
    _p9_run(model, params, prompts[-1:], temps[-1:], kw, n_new=4,
            spec=depth, draft=draft())
    torch.cuda.synchronize()
    say(f"  warm-up: warm_prefill ran {n_shapes} chunk shapes, then one "
        f"short model-draft run, in {time.perf_counter() - t0:.1f} s")

    build.reset_launches()
    runs = {"vanilla": _p9_run(model, params, prompts, temps, kw)}
    runs["depth 0"] = _p9_run(model, params, prompts, temps, kw,
                              spec=SpecConfig(depth=0, mode="none"))
    oracle = OracleDraft([list(o) for o in runs["vanilla"]["out"]],
                         cfg.vocab)
    runs["oracle"] = _p9_run(model, params, prompts, temps, kw,
                             spec=SpecConfig(depth=P9_DEPTH, mode="none"),
                             draft=oracle)
    runs["n-gram"] = _p9_run(model, params, prompts, temps, kw,
                             spec=SpecConfig(depth=P9_DEPTH, mode="ngram"))
    runs["model draft"] = _p9_run(model, params, prompts, temps, kw,
                                  spec=depth, draft=draft())
    launches = dict(build.LAUNCHES)
    van = runs["vanilla"]

    # depth 0: the same T = 1 shapes, so the same streams and bits
    d0 = runs["depth 0"]
    for i in range(len(prompts)):
        check(np.array_equal(d0["out"][i], van["out"][i]),
              f"depth 0 request {i}: stream differs from vanilla")
    check(d0["rec"]["logits"].keys() == van["rec"]["logits"].keys(),
          "depth 0 computed other positions than vanilla")
    check(all(torch.equal(x, van["rec"]["logits"][k])
              for k, x in d0["rec"]["logits"].items()),
          "depth 0 logits are not vanilla's bit for bit")
    say(f"  depth 0: streams and all {len(van['rec']['logits'])} rows of "
        "logits equal vanilla's bit for bit")

    # the oracle: full commits on most steps, a rollback every step of the
    # request with the planted miss
    full = [s for s in oracle.seen if s[2] == P9_DEPTH]
    n_full = sum(a == P9_DEPTH for _, a, _ in full)
    miss = [a for rid, a, _ in full if rid == P9_MISS[0]]
    check(2 * n_full > len(full), f"oracle: {n_full} of {len(full)} "
          f"full-depth steps committed {P9_DEPTH + 1} tokens")
    check(miss and all(a == P9_MISS[1] for a in miss),
          f"oracle: the planted miss was not rejected where planted {miss}")
    say(f"  oracle: {n_full} of {len(full)} full-depth request steps "
        f"committed {P9_DEPTH + 1} tokens; request {P9_MISS[0]} rolled back "
        f"at draft {P9_MISS[1]} on each of its {len(miss)} steps")

    say("== phase 9b: where the device time goes in verify steps")
    _p9_trace(model, params, prompts, temps, kw, "3 oracle verify steps", 3,
              spec=SpecConfig(depth=P9_DEPTH, mode="none"), draft=oracle)
    _p9_trace(model, params, prompts, temps, kw, "2 model-draft steps", 2,
              spec=depth, draft=draft())

    out = {"shapes": n_shapes}
    for name in ("oracle", "n-gram", "model draft"):
        worst, divs = _p9_compare(van, runs[name], prompts, temps)
        say(f"  {name}: committed rows vs vanilla decode max|Δ| {worst:.3e} "
            f"of max |logit| (limit {LOGIT_REL_TOL}); divergences "
            + (", ".join(f"request {i} at token {j} (gap {g:.4f} < "
                         f"{lim:.4f})" for i, j, g, lim in divs) or "none"))
        out[name] = worst
    for name, r in runs.items():
        out[name + " report"] = _p9_report(name, r)

    # the limit must reject two planted faults of the verify pass
    for fault in ("rope", "order"):
        with _verify_fault(model, fault):
            bad = _p9_run(model, params, prompts, temps, kw,
                          n_new=P9_CTL_NEW,
                          spec=SpecConfig(depth=P9_DEPTH, mode="none"),
                          draft=oracle)
        err, _ = _p9_compare(van, bad, prompts, temps, gate=False)
        check(err > LOGIT_REL_TOL, f"the logit limit does not reject the "
              f"planted {fault} fault ({err} of max |logit|)")
        out[fault] = err
    say(f"  controls, both rejected by the limit {LOGIT_REL_TOL}: rope "
        f"positions one off {out['rope']:.4f}, attend before write "
        f"{out['order']:.4f} of max |logit|")

    # a seeded storm over the n-gram engine, twice
    calm = runs["n-gram"]
    storms = [_p9_run(model, params, prompts, temps, kw, audit=True,
                      spec=SpecConfig(depth=P9_DEPTH, mode="ngram"),
                      faults=FaultInjector.seeded(**P9_STORM))
              for _ in range(2)]
    a, b = (x["eng"] for x in storms)
    check(a.injector.log == b.injector.log and a.injector.log,
          "the storm's fault logs differ between the two runs")
    touched = set()
    for _, kind, detail in a.injector.log:
        if kind in ("nan_logits", "corrupt_block") and "rid=" in detail:
            touched.add(int(detail.split("rid=")[1].split()[0]))
    divs = []
    for x in storms:
        for i, o in enumerate(x["out"]):
            req = x["eng"].requests[i]
            check(req.state in TERMINAL_STATES, f"storm: request {i} ended "
                  f"{req.state}")
            c = calm["out"][i]
            if i not in touched and not req.n_preemptions:
                check(np.array_equal(o, c), f"storm: untouched request {i} "
                      "differs from its zero-fault stream")
                continue
            # a request a fault named, or preempted and prefilled again
            # (other chunks, other bf16 roundings): a prefix of its
            # zero-fault stream, or diverging where that run's top-two gap
            # is below the limit
            j = next((j for j in range(len(o)) if o[j] != c[j]), len(o))
            if j < len(o):
                r = calm["rec"]["logits"][(i, len(prompts[i]) + j)]
                gap = _gap(r, temps[i], i, len(prompts[i]) + j)
                lim = LOGIT_REL_TOL * float(r.float().abs().max())
                check(gap < lim, f"storm: request {i} diverges from its "
                      f"zero-fault stream at token {j} (gap {gap} >= {lim})")
                divs.append((i, j, gap))
    st = a.stats()
    say(f"  storm {P9_STORM} twice, audited every step: logs equal "
        f"({len(a.injector.log)} faults: {a.injector.log}); states "
        f"{[a.status(i) for i in range(len(prompts))]}; quarantined "
        f"{st['quarantined']} (named by a fault: {sorted(touched)}), "
        f"retried {st['retried']}, backoff steps {st['backoff_steps']}, "
        f"storm preemptions {st['storm_preempts']}, audits "
        f"{st['audit_passes']}, preempted requests "
        f"{[i for i in range(len(prompts)) if a.requests[i].n_preemptions]};"
        " streams of untouched requests equal the zero-fault run's, the "
        "rest are its prefixes; near-tie divergences " + str(divs))
    out["storm"] = dict(log=a.injector.log, quarantined=st["quarantined"],
                        touched=sorted(touched))

    # one corrupted block (the seeded storm draws none): its owner's verify
    # rows past n_write write NaN K/V into the null block, which the plain
    # paged versions gather (0 · NaN) for every request with a null table
    # entry (ROADMAP §3); kernel B reads only the pages below each length,
    # so the card quarantines what it quarantines — counted, not gated
    bad = _p9_run(model, params, prompts, temps, kw, audit=True,
                  spec=SpecConfig(depth=P9_DEPTH, mode="ngram"),
                  faults=FaultInjector([FaultEvent(step=P9_CORRUPT_STEP,
                                                   kind="corrupt_block")]))
    e = bad["eng"]
    (_, _, detail), = e.injector.log
    victim = int(detail.split("rid=")[1].split()[0])
    check(e.status(victim) == ("failed", "nan_logits"),
          f"corrupt_block: its owner {victim} ended {e.status(victim)}")
    for i, o in enumerate(bad["out"]):
        check(np.array_equal(o, calm["out"][i][:len(o)]), f"corrupt_block: "
              f"request {i} is not a prefix of its zero-fault stream")
    q = e.stats()["quarantined"]
    say(f"  corrupt_block at step {P9_CORRUPT_STEP} ({detail}): quarantined "
        f"{q} of {len(prompts)} ({q - 1} beyond the owner); states "
        f"{[e.status(i) for i in range(len(prompts))]}")
    out["corrupt_quarantined"] = q
    out["launches"] = launches
    del runs, storms, a, b, bad, e, d_model, d_params
    return out


# ---------------------------------------------------------------- phase 10

P10_ARCHS = ("qwen3-8b", "qwen2.5-14b", "qwen1.5-32b")
P10_SEED = 10
P10_WARM = 64           # the warm-up request's prompt
P10_MARGIN = 4 << 30    # device bytes kept free beyond the weights and pool


def _perturb(params, seed):
    """Move the q/k/v biases off zero (N(0, 0.1²)) and the qk-norm weights
    off one (U[0.5, 1.5)), in place, from a seeded generator on the card:
    the init's zeros and ones would serve the same logits with the feature
    left out.  Larger values make the random bf16 model degenerate: biases
    of N(0, 0.5²) add one vector to every position's residual in every
    layer, until the logits barely depend on the token (phase 4's
    off-by-one control is no longer rejected); qk-norm weights of U[0.5, 3)
    sharpen attention until bf16 rounding moves the logits by 20%."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    for lp in params["layers"]:
        for name, t in lp["attn"].items():
            if name in ("bq", "bk", "bv"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen,
                                          device=DEV))
            elif name in ("q_norm", "k_norm"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen,
                                         device=DEV))


def _without_feature(cfg):
    """The config with its Qwen feature left out (phase 10's control)."""
    a = cfg.attn
    feat = "qk_norm" if a.qk_norm else "qkv_bias"
    return feat, cfg.replace(attn=dataclasses.replace(a, **{feat: False}))


def _fit_depth(cfg, n_blocks, block_size):
    """The config at the largest depth (at most its own) whose bf16
    weights, one float32 temporary of its largest leaf, its pool of
    ``n_blocks`` and P10_MARGIN fit in the card's free memory."""
    a = cfg.attn
    free, _ = torch.cuda.mem_get_info()
    per_layer = 2 * (cfg.d_model * (a.n_heads + 2 * a.n_kv_heads)
                     * a.head_dim + a.n_heads * a.head_dim * cfg.d_model
                     + 3 * cfg.d_model * cfg.d_ff) \
        + 2 * 2 * n_blocks * block_size * a.n_kv_heads * a.head_dim
    fixed = 2 * cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2) \
        + 4 * cfg.vocab * cfg.d_model + P10_MARGIN
    depth = min(cfg.n_layers, int((free - fixed) // per_layer))
    check(depth > 0, f"{cfg.name}: not one layer fits in {free} free bytes")
    need = fixed - P10_MARGIN + cfg.n_layers * per_layer
    say(f"  {cfg.name}: {free / 2**30:.2f} GiB free on the card; weights "
        f"and pool {need / 2**30:.2f} GiB at full depth {cfg.n_layers} "
        f"(float32 temporary of the "
        f"embedding included): "
        + ("fits" if depth == cfg.n_layers else f"depth cut to {depth}"))
    return cfg.replace(n_layers=depth)


def _qwen_one(arch, prompts_for):
    """One Qwen model at full width: phase 4's engine and prompts, its
    logits against a plain forward, the feature and phase 4's controls;
    qwen3-8b also serves speculatively (n-gram, depth 4)."""
    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = _fit_depth(get_config(arch), P4_ENGINE["n_blocks"] + 4
                     * -(-P9_DEPTH // P4_ENGINE["block_size"]),
                     P4_ENGINE["block_size"])
    model = DecoderLM(cfg, device=DEV)
    t0 = time.perf_counter()
    params = model.init(seed=P10_SEED)
    _perturb(params, P10_SEED)
    torch.cuda.synchronize()
    a = cfg.attn
    say(f"  {cfg.name} ({cfg.citation}): {cfg.n_layers} layers d_model "
        f"{cfg.d_model} heads {a.n_heads}/{a.n_kv_heads}x{a.head_dim} "
        f"(group {a.n_heads // a.n_kv_heads}) d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab} qkv_bias {a.qkv_bias} qk_norm {a.qk_norm} "
        f"rope_theta {a.rope_theta:g}, bf16, "
        f"{cfg.param_count() / 1e9:.2f} B params, seed {P10_SEED} with "
        f"perturbed biases / norms, made on the card in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    prompts = prompts_for(cfg.vocab)
    warm = Engine(model, params, **P4_ENGINE)
    warm.submit(prompts[3][:P10_WARM], max_new_tokens=2)
    warm.run()
    del warm
    temps = [0.0] * len(prompts)
    build.reset_launches()
    van = _p9_run(model, params, prompts, temps, P4_ENGINE, n_new=P4_NEW)
    launches = dict(build.LAUNCHES)
    st = van["st"]
    for name in ("flash_fwd", "paged_decode"):
        check(launches[name] > 0, f"{cfg.name}: kernel {name} was not "
              "launched")
    for i, o in enumerate(van["out"]):
        check(len(o) == P4_NEW and bool(((o >= 0) & (o < cfg.vocab)).all()),
              f"{cfg.name} request {i}: {o}")
    pf, dc = st["prefill_seconds"], st["decode_seconds"]
    res = dict(name=cfg.name, layers=cfg.n_layers, launches=launches,
               prefill_tok_s=st["prefill_tokens"] / pf,
               decode_tok_s=st["decode_tokens"] / dc,
               decode_ms=1e3 * dc / st["decode_steps"])
    say(f"  served {len(prompts)} requests ({P4_NEW} greedy tokens each): "
        f"prefill {res['prefill_tok_s']:.1f} tok/s ({pf:.3f} s), decode "
        f"{res['decode_tok_s']:.1f} tok/s ({res['decode_ms']:.2f} ms a "
        f"step); launches A {launches['flash_fwd']}, B "
        f"{launches['paged_decode']}")
    # the longest request's last decode logits against a plain forward
    ctx = torch.from_numpy(np.concatenate([prompts[0], van["out"][0][:-1]])
                           [None]).to(DEV)
    ref = model.forward(params, ctx, last_only=True)[0, -1].float()
    got = van["rec"]["logits"][(0, ctx.shape[1])].float()
    scale = float(ref.abs().max())
    d = float((got - ref).abs().max())
    lim = LOGIT_REL_TOL * scale
    check(bool(torch.isfinite(got).all()) and d <= lim,
          f"{cfg.name}: served logits vs plain forward max|Δ| {d} > {lim}")
    feat, bare_cfg = _without_feature(cfg)
    bare = DecoderLM(bare_cfg, device=DEV).forward(
        params, ctx, last_only=True)[0, -1].float()
    d_feat = float((bare - ref).abs().max())
    check(d_feat > lim, f"{cfg.name}: the logit limit {lim} does not "
          f"reject the model without {feat} (max|Δ| {d_feat})")
    say(f"  last logits of the {len(prompts[0])}-token request vs plain "
        f"forward: max|Δ| {d:.4f} (max|logit| {scale:.3f}, limit "
        f"{lim:.4f}); without {feat}: max|Δ| {d_feat:.4f}, rejected")
    logit_controls(model, params, ctx, ref, lim)
    res.update(err=d / scale, feat=feat, feat_err=d_feat / scale)
    if a.qk_norm:
        kw = dict(P4_ENGINE)
        kw["n_blocks"] += len(prompts) * -(-P9_DEPTH // kw["block_size"])
        van2 = _p9_run(model, params, prompts, temps, kw, n_new=P4_NEW)
        n0 = dict(build.LAUNCHES)
        ng = _p9_run(model, params, prompts, temps, kw, n_new=P4_NEW,
                     spec=SpecConfig(depth=P9_DEPTH, mode="ngram"))
        worst, divs = _p9_compare(van2, ng, prompts, temps)
        sst = ng["st"]
        spec_b = build.LAUNCHES["paged_decode"] - n0["paged_decode"]
        res.update(spec_err=worst, spec_divs=len(divs),
                   spec_tok_s=sst["decode_tokens"] / sst["decode_seconds"],
                   spec_acceptance=sst["spec_acceptance"], spec_B=spec_b)
        say(f"  n-gram depth {P9_DEPTH} (B at Tq {1 + P9_DEPTH} x group "
            f"{a.n_heads // a.n_kv_heads}): streams equal vanilla's but at "
            f"near-ties ({len(divs)} divergences), committed rows max|Δ| "
            f"{worst:.3e} of max |logit|, decode {res['spec_tok_s']:.1f} "
            f"tok/s, acceptance {sst['spec_acceptance']:.3f}, "
            f"{sst['decode_tokens'] / sst['decode_steps']:.3f} tokens a "
            f"step, B launches {spec_b}")
        for name in launches:
            launches[name] = build.LAUNCHES[name]
        del van2, ng
    res["peak"] = torch.cuda.max_memory_allocated()
    say(f"  peak {res['peak'] / 2**30:.2f} GiB allocated "
        f"({torch.cuda.max_memory_reserved() / 2**30:.2f} reserved)")
    del van
    _free()
    trace(model, params, prompts)
    del model, params
    _free()
    return res


def qwen():
    """Phase 10: qwen3-8b, qwen2.5-14b and qwen1.5-32b at full size, one at
    a time, through phase 4's engine and prompts."""
    def prompts_for(vocab):
        rng = np.random.default_rng(0)
        return [rng.integers(0, vocab, n).astype(np.int32) for n in P4_LENS]
    rows = []
    for arch in P10_ARCHS:
        t0 = time.perf_counter()
        rows.append(_qwen_one(arch, prompts_for))
        say(f"  {arch}: {time.perf_counter() - t0:.1f} s")
    launches = {}
    for r in rows:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return dict(rows=rows, launches=launches)


# ---------------------------------------------------------------- phase 11

P11_RANKS = 4
P11_TIMEOUT = 900
P11_SEED = 11
# (name, arch, depth or None for the config's own, pool sharding, step of
# a corrupt_block fault or None)
P11_CASES = (("a", "qwen3-8b", 8, "heads", None),
             ("b", "smollm-360m", None, "blocks", 10))
P11_SHARE = 37          # request 3 shares request 0's first 37 tokens
P11_STAGGER = 2         # steps before request 3 arrives
P11_CTL_NEW = 6


def _p11_model(arch, depth, mesh):
    cfg = get_config(arch)
    if depth:
        cfg = cfg.replace(n_layers=depth)
    par = None if mesh is None else make_parallel_config(
        mesh, ShapeSpec("chip11", 1024, P4_ENGINE["max_batch"], "prefill"))
    model = DecoderLM(cfg, DEV, par=par, mesh=mesh)
    params = model.init(seed=P11_SEED)
    _perturb(params, P11_SEED)
    return model, params


def _p11_prompts(vocab):
    """Phase 4's lengths; request 3 (64 tokens) shares request 0's first
    two blocks and five tokens of its third (a partial prefix hit, forked
    on write)."""
    rng = np.random.default_rng(11)
    p = [rng.integers(0, vocab, n).astype(np.int32) for n in P4_LENS]
    p[3] = np.concatenate([p[0][:P11_SHARE], p[3][P11_SHARE:]])
    return p


@contextlib.contextmanager
def _forcing(eng, forced):
    """Teacher forcing of a paged Engine while the block runs: each decode
    step samples ``forced[(rid, context position)]`` for a running request
    that has one, and its own draw otherwise (``forced`` None: no change)."""
    from repro_torch.serve import engine as em
    base = em._sample

    def sample(logits, temps, seeds, positions):
        out = base(logits, temps, seeds, positions)
        for slot, req in eng.sched.running.items():
            t = forced.get((req.rid, int(positions[slot])))
            if t is not None:
                out[slot] = t
        return out
    if forced is not None:
        em._sample = sample
    try:
        yield
    finally:
        em._sample = base


def _p11_run(model, params, corrupt, n_new=None, router=None, forced=None):
    """Phase 11's run: requests 0-2, P11_STAGGER steps, request 3, to the
    end, the meter on (with phase 12's ``router``; teacher-forced on
    ``forced``, :func:`_forcing`); returns streams, rows, stats and the
    fault log."""
    n_new = n_new or P4_NEW
    inj = FaultInjector([] if corrupt is None else [
        FaultEvent(step=corrupt, kind="corrupt_block")])
    eng = Engine(model, params, faults=inj, audit=True, **P4_ENGINE)
    prompts = _p11_prompts(model.cfg.vocab)
    times = []
    with _meter(model, eng, router) as rec, _forcing(eng, forced):
        rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts[:3]]
        for _ in range(P11_STAGGER):
            eng.step()
        rids.append(eng.submit(prompts[3], max_new_tokens=n_new))
        while not eng.sched.idle:
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), eng.counters["prefill_chunks"]
            ev = eng.step()
            torch.cuda.synchronize()
            if ev and eng.counters["prefill_chunks"] == c0:  # decode only
                times.append(time.perf_counter() - t0)
        eng.release_faults()
    _conserved(eng.cache, "the paged pool")
    st = eng.stats()
    return dict(eng=eng, out=[np.asarray(eng.requests[r].emitted)
                              for r in rids], rec=rec, st=st,
                log=list(inj.log), prompts=prompts, step_s=times,
                states=[eng.status(r) for r in rids])


def _shard_fault(group):
    """The planted fault of phase 11: every all-gather over the pool's
    group takes zeros for group rank 1's part (its kv heads' outputs, or
    its blocks)."""
    gather = group.all_gather

    def faulty(x, dim):
        return gather(torch.zeros_like(x) if group.rank == 1 else x, dim)
    group.all_gather = faulty
    return lambda: delattr(group, "all_gather")


def _host_rows(rec):
    return {k: v.float().cpu() for k, v in rec["logits"].items()}


def _sums(rows):
    """Each row's float64 sum of its finite logits and its count of NaN
    (a quarantined row's): what the ranks must agree on bit for bit."""
    return {k: (float(v.double().nan_to_num(nan=0.0).sum()),
                int(v.isnan().sum())) for k, v in rows.items()}


def _same_rows(a, b):
    """Two {key: row} dicts hold the same keys and bits (NaN equal NaN)."""
    return a.keys() == b.keys() and all(
        torch.equal(v.nan_to_num(nan=0.0), b[k].nan_to_num(nan=0.0))
        and torch.equal(v.isnan(), b[k].isnan()) for k, v in a.items())


def _p11_rank(rank):
    """One rank of phase 11's world: each case's run, then a short run under
    the planted fault."""
    mesh = make_local_mesh(seq=P11_RANKS, device=DEV)
    out = {"rank": mesh.coord("model"), "transport": mesh.transport}
    for name, arch, depth, _, corrupt in P11_CASES:
        model, params = _p11_model(arch, depth, mesh)
        grp = mesh.comms["model"]
        _p11_run(model, params, None, n_new=2)           # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r0 = grp.reduce_s + grp.gather_s
        build.reset_launches()
        t0 = time.perf_counter()
        r = _p11_run(model, params, corrupt)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        gather_s = grp.reduce_s + grp.gather_s - r0
        peak = torch.cuda.max_memory_allocated()
        undo = _shard_fault(grp)
        bad = _p11_run(model, params, None, n_new=P11_CTL_NEW)
        undo()
        rows = _host_rows(r["rec"])
        out[name] = dict(
            sharding=r["eng"].cache.sharding,
            local=tuple(r["eng"].cache.pools["k_pool"].shape),
            out=r["out"], log=r["log"], states=r["states"],
            forks=r["st"]["forks"], quarantined=r["st"]["quarantined"],
            sums=_sums(rows),
            rows=rows if out["rank"] == 0 else None,
            bad=dict(out=bad["out"], rows=_host_rows(bad["rec"]))
            if out["rank"] == 0 else None,
            launches=launches, wall=wall, step_ms=[1e3 * t for t in
                                                   r["step_s"]],
            gather_s=gather_s, peak=peak)
        del model, params, r, bad
        _free()
    out["comm_s"] = _process_comm_seconds()
    return out


def mesh_engine():
    """Phase 11: a gloo world of 4 ranks sharing the card runs the paged
    Engine over sharded pools (qwen3-8b's width at depth 8, head-parallel;
    smollm-360m, block-sharded, with a fork and a corrupted block), held to
    the one-process Engine on the same weights in this process."""
    t0 = time.perf_counter()
    res = spawn(_p11_rank, P11_RANKS, (), device=DEV, timeout=P11_TIMEOUT,
                threads=2)
    wall = time.perf_counter() - t0
    res.sort(key=lambda r: r["rank"])
    _say_comm(11, res)
    check(all(r["transport"] == P8_TRANSPORT for r in res),
          f"transport {[r['transport'] for r in res]}")
    launches = {}
    out = {}
    for name, arch, depth, sharding, corrupt in P11_CASES:
        ranks = [r[name] for r in res]
        model, params = _p11_model(arch, depth, None)
        _p11_run(model, params, None, n_new=2)           # warm-up
        one = _p11_run(model, params, corrupt)
        cfg = model.cfg
        del model, params
        _free()
        zero = ranks[0]
        for r in ranks:
            check(r["sharding"] == sharding, f"case {name}: pool sharding "
                  f"{r['sharding']}")
            check(r["sums"] == zero["sums"], f"case {name}: the ranks "
                  "computed other logits")
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
            for i, (a, b) in enumerate(zip(r["out"], one["out"])):
                check(np.array_equal(a, b), f"case {name} request {i}: the "
                      f"ranks' stream differs from one process's")
            check(r["log"] == one["log"] and r["states"] == one["states"],
                  f"case {name}: fault log or states differ: {r['log']} "
                  f"{r['states']} vs {one['log']} {one['states']}")
        for k in ("flash_fwd", "paged_decode"):
            check(zero["launches"][k] > 0, f"case {name}: kernel {k} was "
                  "not launched on the ranks")
        check(zero["forks"] >= 1, f"case {name}: no copy-on-write fork")
        ref = dict(out=one["out"], rec={"logits": _host_rows(one["rec"])})
        run = dict(out=zero["out"], rec={"logits": zero["rows"]})
        temps = [0.0] * len(one["out"])
        err, _ = _p9_compare(ref, run, one["prompts"], temps)
        same = _same_rows(ref["rec"]["logits"], zero["rows"])
        e_bad, _ = _p9_compare(ref, dict(out=zero["bad"]["out"], rec={
            "logits": zero["bad"]["rows"]}), one["prompts"], temps,
            gate=False)
        check(e_bad > LOGIT_REL_TOL, f"case {name}: the logit limit does "
              f"not reject rank 1's part left out of the gathers ({e_bad})")
        if corrupt is not None:
            failed = [i for i, s in enumerate(zero["states"])
                      if s == ("failed", "nan_logits")]
            (_, _, detail), = zero["log"]
            victim = int(detail.split("rid=")[1].split()[0])
            check(failed == [victim], f"case {name}: quarantined {failed}, "
                  f"the corrupted block's owner is {victim}")
        step_ms = [float(np.median(r["step_ms"])) for r in ranks]
        say(f"  case {name}: {cfg.name} {cfg.n_layers} layers, pool "
            f"{sharding}-sharded (local pool {zero['local']}), {P11_RANKS} "
            f"ranks: streams equal the one-process Engine's on every rank; "
            f"logits max|Δ| {err:.3e} of max |logit| (limit {LOGIT_REL_TOL})"
            f", bitwise equal {same}; rank 1's part left out: {e_bad:.3e}, "
            f"rejected; forks {zero['forks']}, fault log {zero['log']}, "
            f"states {zero['states']}")
        say(f"    decode-step ms a rank (median) "
            + ", ".join(f"{m:.2f}" for m in step_ms)
            + f"; one process {float(np.median(one['step_s'])) * 1e3:.2f}; "
            f"host s in all-gathers and broadcasts a rank "
            + ", ".join(f"{r['gather_s']:.3f}" for r in ranks)
            + f"; run {zero['wall']:.1f} s; launches on rank 0 "
            f"{zero['launches']}; peak a rank "
            f"{max(r['peak'] for r in ranks) / 2**30:.2f} GiB")
        out[name] = dict(err=err, bitwise=same, e_bad=e_bad,
                         step_ms=step_ms, gather_s=[r["gather_s"]
                                                    for r in ranks])
    say(f"  world of {P11_RANKS} ranks: {wall:.1f} s, spawn included")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------- phase 12

P12_ARCH, P12_SEED = "deepseek-v2-lite-16b", 12


class _Router:
    """The MoE routing of one engine run, through ``models/moe.top_k``
    while installed (``with router:``): every MoE call's top-k experts in
    call order (``seen``), which of a call's rows are real (a chunk's
    ``n_valid``; the live decode / verify rows), and each decode / verify
    row's experts in every MoE layer (L, k) under its logits key (rid,
    position of the token it predicts; ``by_key``, as :func:`_meter` keys
    the logits).  It may force another run's choices instead of its own
    (its own probabilities at them): ``calls`` by call order, where the
    shapes agree; ``keys`` for decode / verify rows, by logits key."""

    def __init__(self, calls=None, keys=None):
        self.calls, self.keys = calls, keys
        self.seen, self.valid, self.by_key = [], [], {}
        self._rows, self._n, self._start = None, None, 0
        self._ridx = self._forced = None

    def begin(self, rows):
        """A decode / verify call over ``rows``: [(flat row, key)]."""
        self._rows, self._n, self._start = rows, None, len(self.seen)
        self._ridx = self._forced = None
        if self.keys is not None:
            hit = [(r, self.keys[k]) for r, k in rows if k in self.keys]
            if hit:
                self._ridx = torch.tensor([r for r, _ in hit], device=DEV)
                self._forced = torch.stack([f for _, f in hit])  # (n, L, k)

    def begin_chunk(self, n_valid):
        self._rows, self._n, self._start = None, n_valid, len(self.seen)

    def end(self):
        if self._rows is not None and len(self.seen) > self._start:
            st = torch.stack(self.seen[self._start:])           # (L, R, k)
            for r, key in self._rows:
                self.by_key[key] = st[:, r]
        self._rows = self._n = None

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._base = moe, moe.top_k
        moe.top_k = self._top_k
        return self

    def __exit__(self, *exc):
        self._moe.top_k = self._base

    def _top_k(self, probs, k):
        vals, idx = self._base(probs, k)
        i, forced = len(self.seen), False
        if self.calls is not None:
            if i < len(self.calls) and self.calls[i].shape == idx.shape:
                idx, forced = self.calls[i], True
        elif self._forced is not None:
            idx = idx.clone()
            idx[self._ridx] = self._forced[:, i - self._start]
            forced = True
        if forced:
            vals = probs.gather(-1, idx)
        self.seen.append(idx)
        self.valid.append(self._n if self._rows is None
                          else [r for r, _ in self._rows])
        return vals, idx


def _route_diff(a, b, upto):
    """(rows compared, rows whose top-k set differs) between two routers'
    runs: the valid rows of their chunk calls (the same prefill chunks in
    the same order), and the decode / verify rows of the logits keys both
    have, up to ``upto[rid]`` (the position past which request rid's
    streams part)."""
    n = d = 0

    def differ(x, y):
        return int((x.sort(dim=-1)[0] != y.sort(dim=-1)[0]).any(dim=-1)
                   .sum())
    chunks = [[x for x, v in zip(r.seen, r.valid) if isinstance(v, int)]
              for r in (a, b)]
    nv = [v for v in a.valid if isinstance(v, int)]
    for x, y, v in zip(*chunks, nv):
        n += v
        d += differ(x[:v], y[:v])
    for key, x in a.by_key.items():
        y = b.by_key.get(key)
        if y is not None and key[1] <= upto[key[0]]:
            n += x.shape[0]
            d += differ(x, y)
    return n, d


def _p12_plain(cfg, params, prompts, temps, kw, router=None):
    """Phase 12's workload through the same engine on the plain versions
    (``impl="ref"``: chunk and paged attention in plain PyTorch)."""
    model = DecoderLM(cfg, device=DEV, impl="ref")
    return _p9_run(model, params, prompts, temps, kw, router=router)


def _first_split(a, b):
    """The first token where two streams differ, or None."""
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def deepseek():
    """Phase 12: deepseek-v2-lite-16b (MLA + MoE) at full size through phase
    4's engine and prompts: kernel A's latent route for the chunks, kernel
    B over the latent pool; the served logits held to the same engine on
    the plain versions, which must reject two controls; n-gram speculation
    at depth 4 (B at Tq 5)."""
    _free()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    cfg = get_config(P12_ARCH)
    a, m = cfg.attn, cfg.moe
    model = DecoderLM(cfg, device=DEV)
    t0 = time.perf_counter()
    params = model.init(seed=P12_SEED)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in leaves(params))
    # param_count leaves out the norms: ln_f, two a layer, kv_ln
    check(n_par - cfg.param_count() == (2 * cfg.n_layers + 1) * cfg.d_model
          + cfg.n_layers * a.kv_lora_rank,
          f"{cfg.name}: {n_par} parameters against param_count "
          f"{cfg.param_count()} and the norms")
    say(f"  {cfg.name} ({cfg.citation}): {cfg.n_layers} layers d_model "
        f"{cfg.d_model}, MLA {a.n_heads} heads kv_lora {a.kv_lora_rank} "
        f"rope {a.qk_rope_head_dim} nope {a.qk_nope_head_dim} v "
        f"{a.v_head_dim}, {m.n_dense_layers} dense layer (d_ff "
        f"{m.d_dense_ff}) then MoE {m.n_routed} routed + {m.n_shared} shared"
        f" top-{m.top_k} d_expert {m.d_expert} capacity "
        f"{m.capacity_factor}, vocab {cfg.vocab}, bf16, "
        f"{cfg.param_count() / 1e9:.2f} B params ({n_par} with norms), "
        f"seed {P12_SEED}, made on the card in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB); nothing cut")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in P4_LENS]
    temps = [0.0] * len(prompts)
    warm = Engine(model, params, **P4_ENGINE)
    warm.submit(prompts[3][:P10_WARM], max_new_tokens=2)
    warm.run()
    check(warm.cache.layout == "mla", "the engine's pool is not latent")
    pool_mb = sum(t.numel() * t.element_size()
                  for t in warm.cache.pools.values()) / 1e6
    del warm
    build.reset_launches()
    rk = _Router()
    with rk:
        van = _p9_run(model, params, prompts, temps, P4_ENGINE, router=rk)
    launches = dict(build.LAUNCHES)
    st = van["st"]
    check(launches["flash_fwd_latent"] > 0 and launches["paged_decode"] > 0,
          f"{cfg.name}: kernels A (latent route) and B must launch: "
          f"{launches}")
    check(launches["flash_fwd"] == 0, "a one-D route of A ran on MLA")
    check(st["n_preemptions"] == 0, "the phase's pool preempted")
    for i, o in enumerate(van["out"]):
        check(len(o) == P4_NEW and bool(((o >= 0) & (o < cfg.vocab)).all()),
              f"{cfg.name} request {i}: {o}")
    pf, dc = st["prefill_seconds"], st["decode_seconds"]
    res = dict(launches=launches, prefill_tok_s=st["prefill_tokens"] / pf,
               decode_tok_s=st["decode_tokens"] / dc,
               decode_ms=1e3 * dc / st["decode_steps"], pool_mb=pool_mb)
    say(f"  served {len(prompts)} requests ({P4_NEW} greedy tokens each, "
        f"latent pool {pool_mb:.1f} MB): prefill {res['prefill_tok_s']:.1f} "
        f"tok/s ({pf:.3f} s), decode {res['decode_tok_s']:.1f} tok/s "
        f"({res['decode_ms']:.2f} ms a step); launches A (latent) "
        f"{launches['flash_fwd_latent']}, B {launches['paged_decode']}")

    # the same engine on the plain versions, with its own routing: a
    # router near-tie that rounding tips one way moves a token to another
    # expert (and, in a prefill chunk, other tokens' capacity slots), so
    # the logits are a discontinuous function of the attention outputs;
    # this run is reported (differing top-6 sets of real rows, streams,
    # logits at the first decode step) and the gate takes the next one
    n0 = len(prompts[0])
    rp = _Router()
    with rp:
        free = _p12_plain(cfg, params, prompts, temps, P4_ENGINE, router=rp)
    upto = {i: len(p) + (P4_NEW - 1 if j is None else j)
            for i, p, j in ((i, p, _first_split(x, y)) for i, (p, x, y)
                            in enumerate(zip(prompts, van["out"],
                                             free["out"])))}
    rows, differ = _route_diff(rk, rp, upto)
    del rp
    streams = sum(np.array_equal(x, y) for x, y in zip(van["out"],
                                                       free["out"]))
    fw = free["rec"]["logits"][(0, n0)].float()
    free_err = float((van["rec"]["logits"][(0, n0)].float() - fw).abs()
                     .max()) / float(fw.abs().max())
    say(f"  plain engine, its own routing: top-{m.top_k} sets differing "
        f"from the kernel run's in {differ} of {rows} (token, layer) rows "
        f"(prompt rows, and decode rows until the streams part); streams "
        f"equal in "
        f"{streams} of {len(prompts)} (request 0 first parts at token "
        f"{_first_split(van['out'][0], free['out'][0])}); first decode "
        f"step's logits max|Δ| {free_err:.4f} of max |logit|")
    del free
    # the gate: the plain engine replaying the kernel run's expert choices
    with _Router(calls=rk.seen) as rr:
        ref = _p12_plain(cfg, params, prompts, temps, P4_ENGINE, router=rr)
    del rr
    j = _first_split(van["out"][0], ref["out"][0])
    pos = n0 + P4_NEW - 1 if j is None else n0
    if j is not None:
        say(f"  request 0's streams part at token {j} (near-tie: kernel "
            f"{van['out'][0][j]} vs plain {ref['out'][0][j]}); the gate "
            f"compares the first decode step (position {pos})")
    got = van["rec"]["logits"][(0, pos)].float()
    want = ref["rec"]["logits"][(0, pos)].float()
    scale = float(want.abs().max())
    lim = LOGIT_REL_TOL * scale
    d = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and d <= lim,
          f"{cfg.name}: served logits vs the plain engine max|Δ| {d} > "
          f"{lim}")
    # control 1: the context without its last token (the plain engine's
    # row one position earlier, or a run with that prompt)
    if (0, pos - 1) in ref["rec"]["logits"]:
        short = ref["rec"]["logits"][(0, pos - 1)].float()
    else:
        cut = _p12_plain(cfg, params, [prompts[0][:-1]] + prompts[1:],
                         temps, P4_ENGINE)
        short = cut["rec"]["logits"][(0, pos - 1)].float()
    d_pos = float((short - want).abs().max())
    # control 2: a window that hides the oldest block at that step
    win = _p12_plain(cfg.replace(attn=dataclasses.replace(
        a, window=pos - P4_ENGINE["block_size"])), params, prompts, temps,
        P4_ENGINE)
    d_blk = float((win["rec"]["logits"][(0, pos)].float() - want)
                  .abs().max())
    check(d_pos > lim and d_blk > lim, f"{cfg.name}: the logit limit {lim} "
          f"does not reject both controls ({d_pos}, {d_blk})")
    replayed = sum(np.array_equal(x, y) for x, y in zip(van["out"],
                                                         ref["out"]))
    say(f"  last logits of the {n0}-token request (position {pos}) vs the "
        f"plain engine replaying the kernel run's experts: max|Δ| {d:.4f} "
        f"(max|logit| {scale:.3f}, limit {lim:.4f}), argmax "
        f"{int(got.argmax())} vs {int(want.argmax())}; streams equal in "
        f"{replayed} of {len(prompts)}; controls rejected: context without "
        f"its last token max|Δ| {d_pos:.4f}, oldest block hidden max|Δ| "
        f"{d_blk:.4f}")
    res.update(err=d / scale, ctl_pos=d_pos / scale, ctl_blk=d_blk / scale,
               gate_pos=pos, route_rows=rows, route_differ=differ,
               streams_free=streams, free_err=free_err,
               streams_replayed=replayed)
    del ref, win

    # n-gram speculation at depth 4: verify through B at Tq 5; each row
    # the vanilla run decoded takes the vanilla row's experts (keyed by
    # request and position), so the verify rows are held to the decode
    # rows without the routing discontinuity (GEMMs of B·5 rows round
    # otherwise than of B)
    kw = dict(P4_ENGINE)
    kw["n_blocks"] += len(prompts) * -(-P9_DEPTH // kw["block_size"])
    n0l = dict(build.LAUNCHES)
    with _Router(keys=rk.by_key) as rn:
        ng = _p9_run(model, params, prompts, temps, kw, router=rn,
                     spec=SpecConfig(depth=P9_DEPTH, mode="ngram"))
    del rk, rn
    worst, divs = _p9_compare(van, ng, prompts, temps)
    sst = ng["st"]
    spec_b = build.LAUNCHES["paged_decode"] - n0l["paged_decode"]
    res.update(spec_err=worst, spec_divs=len(divs),
               spec_tok_s=sst["decode_tokens"] / sst["decode_seconds"],
               spec_acceptance=sst["spec_acceptance"], spec_B=spec_b)
    say(f"  n-gram depth {P9_DEPTH} (B at Tq {1 + P9_DEPTH} x 16 heads): "
        f"streams equal vanilla's but at near-ties ({len(divs)} "
        f"divergences), committed rows max|Δ| {worst:.3e} of max |logit|, "
        f"decode {res['spec_tok_s']:.1f} tok/s, acceptance "
        f"{sst['spec_acceptance']:.3f}, "
        f"{sst['decode_tokens'] / sst['decode_steps']:.3f} tokens a step, "
        f"B launches {spec_b}")
    for name in launches:
        launches[name] = build.LAUNCHES[name]
    res["peak"] = torch.cuda.max_memory_allocated()
    say(f"  peak {res['peak'] / 2**30:.2f} GiB allocated "
        f"({torch.cuda.max_memory_reserved() / 2**30:.2f} reserved)")
    del van, ng
    _free()
    trace(model, params, prompts)
    res["seconds"] = time.perf_counter() - t_all
    say(f"  phase 12 took {res['seconds']:.1f} s")
    res.update(model=model, params=params)    # phase 13 serves them again
    return res


# ---------------------------------------------------------------- phase 13

P13_NEW = 32            # greedy tokens a prompt
P13_CTL_GEN = 8         # decode steps of each planted-fault run
P13_WARM_T = 256        # the warm-up prompts


@contextlib.contextmanager
def _kpe_fault():
    """A deliberately wrong prefill cache while the block runs (phase 13's
    second control): each latent row keeps its k_pe without the rope (the
    roped columns rotated back), its c_kv as it is."""
    base = LY.mla_qkv

    def faulty(p, x, cfg, cos, sin, return_latent=False):
        out = base(p, x, cfg, cos, sin, return_latent)
        if not return_latent:
            return out
        *qkv, lat = out
        c = cfg.attn.kv_lora_rank
        pe = LY.apply_rope(lat[..., None, c:], cos, -sin)[..., 0, :]
        return (*qkv, torch.cat([lat[..., :c], pe], dim=-1))
    LY.mla_qkv = faulty
    try:
        yield
    finally:
        LY.mla_qkv = base


def _show_top(prof, n=6):
    """The ``n`` device kernels of a trace with the most self device
    time."""
    top = sorted(_kernels(prof).items(), key=lambda kv: -kv[1][1])
    for name, (count, us) in top[:n]:
        say(f"      {us / 1e3:9.2f} ms {count:6d} launches  {name[:90]}")


def _p13_trace(model, params, prompts):
    """torch.profiler over one whole-prompt prefill of the phase's prompts,
    then over 6 dense decode steps after 2 unprofiled ones: the device
    breakdown and idle share of each, and the kernels with the most device
    time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    label = f"fixed-slot prefill ({P13_B} x {P13_T} tokens)"
    idle = show_breakdown(label, prof, wall)
    _show_top(prof)
    fam, busy, wall_ms = _device_breakdown(prof, wall)
    out["prefill"] = dict(wall_ms=wall_ms, busy_ms=busy, idle=idle,
                          attn_ms=fam.get("kernel A flash_fwd", (0, 0.0))[1])
    S0 = prompts.shape[1]
    cache = model.pad_cache(cache, S0 + 8)
    tok = logits[:, -1].float().argmax(dim=-1)[:, None].to(torch.int32)

    def step(i):
        pos = torch.full((P13_B,), S0 + i, dtype=torch.int32, device=DEV)
        lg = model.decode(params, cache, tok, pos)
        return lg[:, -1].float().argmax(dim=-1)[:, None].to(torch.int32)
    for i in range(2):
        tok = step(i)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(2, 8):
            tok = step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    idle = show_breakdown("6 fixed-slot decode steps", prof, wall)
    _show_top(prof)
    fam, busy, wall_ms = _device_breakdown(prof, wall)
    out["decode"] = dict(wall_ms=wall_ms, busy_ms=busy, idle=idle)
    return out


def fixed_slot(model, params):
    """Phase 13: deepseek-v2-lite-16b at full size (phase 12's model and
    seed-12 weights) through ``FixedSlotEngine``: one whole-prompt prefill
    of 2 prompts of 4,096 tokens with MLA materialised (kernel A's pair
    route, q/k 192, v 128, once a layer), the latent rows as the dense
    cache, 32 greedy tokens by the absorbed dense-cache decode.  Every
    step's logits are held to the same engine on the plain versions
    (``impl="ref"``), teacher-forced on this run's tokens and replaying its
    expert choices; the limit must reject two planted faults."""
    t_all = time.perf_counter()
    cfg = model.cfg
    prompts = np.random.default_rng(13).integers(
        0, cfg.vocab, (P13_B, P13_T)).astype(np.int32)
    batch = {"tokens": prompts}
    FixedSlotEngine(model, params).generate(
        {"tokens": prompts[:, :P13_WARM_T]}, 2)
    _free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {}
    model.prefill = _timed(times, "prefill", model.prefill)
    model.decode = _timed(times, "decode", model.decode)
    build.reset_launches()
    rk = _Router()
    with rk, _recorded(model) as logs:
        toks, _ = FixedSlotEngine(model, params).generate(batch, P13_NEW)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    del model.prefill, model.decode
    kern = torch.stack(logs)
    check(launches["flash_fwd_pair"] == cfg.n_layers and all(
        n == 0 for k, n in launches.items() if k != "flash_fwd_pair"),
        f"{cfg.name} fixed-slot: kernel A's pair route must launch once a "
        f"layer and nothing else: {launches}")
    toks = toks.cpu()
    check(tuple(toks.shape) == (P13_B, P13_NEW) and bool(
        ((toks >= 0) & (toks < cfg.vocab)).all()), f"tokens {toks}")
    check(bool(torch.isfinite(kern).all()), "non-finite fixed-slot logits")
    pf, dc = times["prefill"][0], times["decode"]
    res = dict(launches=launches, prefill_s=pf,
               decode_ms=1e3 * float(np.median(dc)),
               decode_ms_mean=1e3 * float(np.mean(dc)),
               prefill_tok_s=P13_B * P13_T / pf,
               decode_tok_s=P13_B * len(dc) / sum(dc), peak=peak)
    say(f"  served {P13_B} prompts of {P13_T} tokens, {P13_NEW} greedy "
        f"tokens each: prefill {pf:.3f} s ({res['prefill_tok_s']:.1f} "
        f"tok/s), decode {res['decode_ms']:.2f} ms a step (median; mean "
        f"{res['decode_ms_mean']:.2f}, {res['decode_tok_s']:.1f} tok/s), "
        f"peak {peak / 2**30:.2f} GiB allocated; launches {launches}")

    # the same engine on the plain versions, teacher-forced on this run's
    # tokens and replaying its expert choices (phase 12: a near-tie the
    # rounding tips moves a token to another expert)
    ref_model = DecoderLM(cfg, device=DEV, impl="ref")

    def plain(n_new, fault=None):
        ctx = (_decode_fault(ref_model, "pos") if fault == "pos" else
               _kpe_fault() if fault == "kpe" else contextlib.nullcontext())
        with _Router(calls=rk.seen), ctx, _recorded(ref_model,
                                                     toks) as lg:
            FixedSlotEngine(ref_model, params).generate(batch, n_new)
        _free()
        return torch.stack(lg)
    ref = plain(P13_NEW)
    check(ref.shape == kern.shape, f"steps {ref.shape} {kern.shape}")
    err = _step_err(kern, ref)
    ctl = {f: _step_err(plain(P13_CTL_GEN, f)[1:], ref[1:P13_CTL_GEN + 1])
           for f in ("pos", "kpe")}
    say(f"  teacher-forced logits, worst step max|Δ| / max|logit| over "
        f"{P13_NEW + 1} steps (limit {LOGIT_REL_TOL}): kernels vs the plain "
        f"engine replaying the experts {err:.3e}; controls: decode "
        f"positions one off {ctl['pos']:.3e}, latent cached without its k_pe "
        f"rope {ctl['kpe']:.3e}")
    check(err <= LOGIT_REL_TOL, f"{cfg.name} fixed-slot logits vs the plain "
          f"engine: {err} over {LOGIT_REL_TOL}")
    for f, e in ctl.items():
        check(e > LOGIT_REL_TOL, f"the logit limit does not reject the {f} "
              f"control ({e})")
    res.update(err=err, ctl_pos=ctl["pos"], ctl_kpe=ctl["kpe"])
    del ref_model, rk
    _free()
    res["trace"] = _p13_trace(model, params, prompts)
    _free()
    res["seconds"] = time.perf_counter() - t_all
    say(f"  phase 13 took {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------- phase 14

P14_ARCH, P14_SEED = "deepseek-v2-lite-16b", 14
P14_LAYERS, P14_T, P14_STEPS = 8, 8192, 4
P14_CAP = 960           # slots an expert takes: 8192 · 6 · 1.25 / 64
P14_KERNELS = ("flash_fwd_pair", "flash_bwd_dq", "flash_bwd_dkv")
# step 1's loss, kernels against the plain attention: the logits are bf16,
# so each token's cross-entropy is known to one bf16 step of the logits'
# size (2^-8 of it); the mean over 8,192 tokens is held to that step of its
# own size
P14_LOSS_TOL = 2.0 ** -8


@contextlib.contextmanager
def _v_columns_fault():
    """A planted fault: materialised MLA's v taken from the wrong columns
    of the ``wkv_b`` up-projection (each head's first 128, k_nope's,
    instead of its last 128)."""
    base = LY.mla_qkv

    def faulty(p, x, cfg, cos, sin, return_latent=False):
        out = base(p, x, cfg, cos, sin, return_latent)
        q, k, v = out[:3]
        return (q, k, k[..., :v.shape[-1]]) + tuple(out[3:])
    LY.mla_qkv = faulty
    try:
        yield
    finally:
        LY.mla_qkv = base


def _leaf_names(tree, prefix=""):
    """Names of a parameter tree's leaves, in ``core.tree.flatten``'s
    order (sorted dict keys, list order)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, x in enumerate(tree)
                for n in _leaf_names(x, f"{prefix}[{i}]")]
    return [prefix]


def _worst_leaf(gs, ref, names):
    """(largest per-leaf max |Δg| / max |g_ref|, that leaf's name)."""
    errs = [float((a.float() - r.float()).abs().max())
            / max(float(r.float().abs().max()), 1e-30)
            for a, r in zip(gs, ref)]
    i = int(np.argmax(errs))
    return errs[i], names[i]


def train_moe():
    """Phase 14: deepseek-v2-lite-16b (MLA + MoE) trained at full width,
    depth cut to 8 of 27 layers (the dense layer 0 and 7 MoE layers), one
    8,192-token sequence a step, bf16, seed-14 weights: step 1's loss and
    every gradient leaf against the plain attention replaying the kernel
    run's experts (a planted fault rejected), kernels A (pair route), C
    and D on the training path's own inputs, then 4 steps each under
    remat_aware and hf."""
    from repro_torch.models.moe import capacity
    t_all = time.perf_counter()
    cfg = get_config(P14_ARCH).replace(n_layers=P14_LAYERS)
    m, L, T, n = cfg.moe, P14_LAYERS, P14_T, P14_STEPS
    n_moe = L - m.n_dense_layers
    cap = capacity(cfg, T)
    tc = TrainConfig(lr=1e-4, warmup_steps=min(20, n // 5 + 1),
                     total_steps=n)
    batches = [SyntheticTokens(cfg, ShapeSpec("chip", T, 1, "train"),
                               device=DEV, seed=0).batch(i)
               for i in range(n)]
    at = cfg.attn
    say(f"  {cfg.name} at full width (d_model {cfg.d_model}, MLA "
        f"{at.n_heads} heads of q/k "
        f"{at.qk_nope_head_dim + at.qk_rope_head_dim} and v {at.v_head_dim}, "
        f"latent {at.kv_lora_rank}, {m.n_routed} routed + {m.n_shared} shared "
        f"experts, top-{m.top_k}, vocab {cfg.vocab}), {L} of 27 layers "
        f"({m.n_dense_layers} dense + {n_moe} MoE; "
        f"{cfg.param_count() / 1e9:.2f} B params), B 1 T {T}, bf16 params, "
        f"fp32 moments, seed {P14_SEED}; MoE capacity {cap} a layer for "
        f"{T * m.top_k} (token, expert) pairs over {m.n_routed} experts")
    check(cap == P14_CAP, f"capacity {cap}, want {P14_CAP}")

    # step 1: the kernels against the plain attention from the same weights
    # and batch, the plain run replaying the kernel run's experts by call
    # order (remat_aware routes each MoE layer twice: the forward, then the
    # recompute in the backward)
    base = DecoderLM(cfg, device=DEV).init(seed=P14_SEED)
    names = _leaf_names(base)

    def step1(impl, router, fault=False):
        model = DecoderLM(cfg, device=DEV, impl=impl)
        params = trainable(base)
        with router, (_v_columns_fault() if fault
                      else contextlib.nullcontext()):
            loss, met = model.loss(params, batches[0])
            g = torch.autograd.grad(loss, leaves(params))
        torch.cuda.synchronize()
        return [float(x.detach()) for x in (loss, met["ce"], met["aux"])], g

    seen = {"armed": True}
    build.reset_launches()
    rk = _Router()
    (l_k, ce_k, aux_k), g_k = step1(_capturing(seen), rk)
    got = dict(build.LAUNCHES)
    want = {k: L if k in P14_KERNELS else 0 for k in got}
    check(got == want, f"step 1 launches {got}, want {want}")
    check(len(rk.seen) == 2 * n_moe, f"{len(rk.seen)} MoE routings in a "
          f"remat_aware step, want {2 * n_moe}")
    fwd, rec = rk.seen[:n_moe], rk.seen[n_moe:][::-1]
    redo = sum(int((a.sort(-1)[0] != b.sort(-1)[0]).any(-1).sum())
               for a, b in zip(fwd, rec))
    say(f"  step 1 (remat_aware, kernels): loss {l_k:.6f} ce {ce_k:.6f} aux "
        f"{aux_k:.6e}; launches {got}; {len(rk.seen)} MoE routings; "
        f"recomputed top-{m.top_k} sets that differ from their forward's: "
        f"{redo} of {n_moe * T}")
    rr = _Router(calls=rk.seen)
    (l_r, ce_r, aux_r), g_r = step1("ref", rr)
    check(len(rr.seen) == len(rk.seen) and all(
        torch.equal(a, b) for a, b in zip(rr.seen, rk.seen)),
        "the plain run did not replay every expert choice")
    err, leaf = _worst_leaf(g_k, g_r, names)
    del g_k
    (l_f, _, _), g_f = step1("ref", _Router(calls=rk.seen), fault=True)
    bad, bad_leaf = _worst_leaf(g_f, g_r, names)
    del g_f
    d_loss = abs(l_k - l_r)
    say(f"  step 1 plain attention replaying the experts: loss {l_r:.6f} ce "
        f"{ce_r:.6f} aux {aux_r:.6e}; |Δloss| {d_loss:.3e} (limit "
        f"{P14_LOSS_TOL:.3e} of |loss|), |Δce| {abs(ce_k - ce_r):.3e}, "
        f"|Δaux| {abs(aux_k - aux_r):.3e}")
    say(f"  worst gradient leaf max|Δg| / max|g| over {len(names)} leaves: "
        f"kernels {err:.4f} ({leaf}; limit {GRAD_REL_TOL}); control, v from "
        f"the wrong wkv_b columns: {bad:.4f} ({bad_leaf}), loss {l_f:.6f}")
    check(d_loss <= P14_LOSS_TOL * abs(l_r), f"step 1 loss {l_k} vs plain "
          f"{l_r}")
    check(err <= GRAD_REL_TOL, f"kernel grads vs plain: {leaf} {err}")
    check(bad > GRAD_REL_TOL, f"the grad limit does not reject v taken from "
          f"the wrong columns ({bad_leaf} {bad})")
    del base, g_r, rk, rr
    _free()
    say("  kernels A (pair route), C and D on the training path's inputs:")
    errs = main_path_checks(seen, shape=(1, T, PAIR_H, PAIR_DK), last=L)
    res = dict(seen=seen, errs=errs, redo=redo, step1_err=err,
               step1_ctl=bad, d_loss=d_loss, launches={}, peaks={}, tok_s={},
               idle={})
    first = None
    for policy, n_fwd in (("remat_aware", L), ("hf", 2 * L)):
        runs, got, peak, idle = _train_policy(cfg, policy, batches, tc,
                                              seed=P14_SEED,
                                              kernels=P14_KERNELS,
                                              profile=True)
        want = {"flash_fwd_pair": n_fwd * n, "flash_bwd_dq": L * n,
                "flash_bwd_dkv": L * n}
        check(got == want, f"{policy} launches {got}, want {want}")
        for i, (mt, sec) in enumerate(runs):
            check(mt["skipped_nonfinite"] == 0, f"{policy} step {i + 1} was "
                  "skipped")
            check(all(np.isfinite(mt[k]) for k in ("loss", "ce", "aux")),
                  f"{policy} step {i + 1}: {mt}")
            say(f"  {policy} step {i + 1}: loss {mt['loss']:.4f} ce "
                f"{mt['ce']:.4f} aux {mt['aux']:.6e} gnorm {mt['gnorm']:.3f} "
                f"step {sec:.3f} s")
        l1 = runs[0][0]["loss"]
        first = l1 if first is None else first
        check(abs(l1 - first) <= 1e-2 * abs(first), f"{policy} step 1 loss "
              f"{l1} vs remat_aware {first}")
        tok_s = (n - 1) * T / sum(sec for _, sec in runs[1:])
        say(f"  {policy}: {tok_s:.1f} tokens/s over steps 2-{n}; launches "
            f"per step " + ", ".join(f"{k} {got[k] / n:g}"
                                     for k in P14_KERNELS)
            + f"; peak memory {peak / 2**30:.2f} GiB; idle share {idle:.3f}")
        for k in P14_KERNELS:
            res["launches"][k] = res["launches"].get(k, 0) + got[k]
        res["peaks"][policy], res["tok_s"][policy] = peak, tok_s
        res["idle"][policy] = idle
    res["seconds"] = time.perf_counter() - t_all
    say(f"  phase 14 took {res['seconds']:.1f} s")
    return res


# ------------------------------------------------------- phases 15 and 16

class _Keep:
    """The kept (token, choice) pairs of every MoE dispatch, through
    ``models/moe.dispatch_slots`` while installed (``with keep:``): each
    call's keep mask (n·k,) in call order (``seen``).  It may force them
    instead, the slots then each kept pair's rank among its expert's kept
    pairs: ``split`` — the call's rows cut into ``split`` equal blocks,
    each dispatched on its own at ``cap`` slots an expert (the pairs P
    ranks keep of their own rows); ``calls`` — recorded masks by call
    order."""

    def __init__(self, split=None, cap=None, calls=None):
        self.split, self.cap, self.calls = split, cap, calls
        self.seen = []

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._base = moe, moe.dispatch_slots
        moe.dispatch_slots = self._slots
        return self

    def __exit__(self, *exc):
        self._moe.dispatch_slots = self._base

    def _slots(self, flat_e, E, cap):
        i = len(self.seen)
        if self.split:
            n = flat_e.shape[0] // self.split
            keep = torch.cat([self._base(flat_e[j * n:(j + 1) * n], E,
                                         self.cap)[1]
                              for j in range(self.split)])
        elif self.calls is not None and i < len(self.calls):
            keep = self.calls[i].to(flat_e.device)
            check(keep.shape == flat_e.shape, f"kept pairs of call {i}: "
                  f"{tuple(keep.shape)} for {tuple(flat_e.shape)}")
        else:
            slot, keep = self._base(flat_e, E, cap)
            self.seen.append(keep)
            return slot, keep
        hot = torch.nn.functional.one_hot(flat_e, E) * keep[:, None]
        pos = ((hot.cumsum(dim=0) - 1) * hot).sum(dim=-1)
        check(int(pos.max()) < cap, f"call {i}: {int(pos.max()) + 1} kept "
              f"pairs for an expert of {cap} slots")
        self.seen.append(keep)
        return torch.where(keep, pos, torch.full_like(pos, cap)), keep


@contextlib.contextmanager
def _moe_fault(fault):
    """A deliberately wrong MoE while the block runs (phases 15 and 16's
    controls): ``"rotate"`` — the return ``all_to_all`` of every dispatch
    rotated by one rank (each rank gets its next rank's results);
    ``"aux"`` — the mean probabilities of the aux loss left without their
    cross-rank mean; ``"psum"`` — ``moe_decode_apply``'s sum over the
    ranks' experts left out; ``"grads"`` — the routed experts' gradients
    also summed over the sequence axis (whose ranks hold other
    experts)."""
    from repro_torch.models import moe
    from repro_torch.train import step as st
    saved = []

    def patch(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    if fault == "rotate":
        a2a, n = moe.all_to_all, [0]

        def rotated(comm, x, split, concat):
            y = a2a(comm, x, split, concat)
            n[0] += 1
            return torch.roll(y, 1, dims=0) if n[0] % 2 == 0 else y
        patch(moe, "all_to_all", rotated)
    elif fault == "aux":
        red = moe.all_reduce
        patch(moe, "all_reduce",
              lambda comm, x, op="sum": x if op == "mean" else red(comm, x,
                                                                   op))
    elif fault == "psum":
        dec = TF.moe_decode_apply

        def no_psum(p, x, cfg, *, group=None):
            idle = None if group is None else types.SimpleNamespace(
                size=group.size, rank=group.rank,
                all_reduce_=lambda ts, op="sum": ts)
            return dec(p, x, cfg, group=idle)
        patch(TF, "moe_decode_apply", no_psum)
    elif fault == "grads":
        sg = st.sum_grads

        def twice(model, params, grads):
            grads, sharded = sg(model, params, grads)
            model.expert_group.all_reduce_([g for g, s in zip(grads, sharded)
                                            if s])
            return grads, sharded
        patch(st, "sum_grads", twice)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def _comm_seconds(comms):
    """Host seconds the Comms spent blocked: shifts, all_to_alls, and
    all-reduces / broadcasts / all-gathers."""
    return dict(shift=sum(c.shift_wait_s for c in comms),
                a2a=sum(c.a2a_s for c in comms),
                reduce=sum(c.reduce_s + c.gather_s for c in comms))


def _process_comm_seconds():
    """Host seconds every Comm of this process spent blocked, summed
    (:func:`_comm_seconds`); the gloo-staged Comms of phases 7 and 15's
    printed readings left out."""
    import gc
    from repro_torch.parallel.comm import Comm
    return _comm_seconds([o for o in gc.get_objects()
                          if type(o) is Comm
                          and o.transport != "gloo-staged"])


def _say_comm(phase, res):
    """Print a world's host seconds in collectives, rank by rank."""
    say(f"  phase {phase} host seconds in collectives over the world's run "
        f"({res[0]['transport']}), per rank shifts / all_to_alls / "
        "all-reduces, broadcasts and gathers: " + ", ".join(
            "/".join(f"{r['comm_s'][k]:.3f}" for k in ("shift", "a2a",
                                                       "reduce"))
            for r in res))


P15_ARCH, P15_SEED, P15_RANKS = "deepseek-v2-lite-16b", 15, 4
# the dense layer 0 and 2 MoE layers: with a third MoE layer each rank
# reserved 17.67 GiB (15.61 allocated), 70.7 GiB of the card for the four,
# leaving under 8 GiB free beside their contexts
P15_LAYERS = 3
P15_T = 16384           # one sequence a step: 4,096 tokens a rank
P15_CAP = 480           # slots an expert takes from a rank: 4096 · 6 · 1.25 / 64
P15_RUNS = (("balanced", 3), ("zigzag", 1))
P15_TIMEOUT = 900
# P = 4 against P = 1 on the same weights, tokens, expert choices and kept
# pairs: the logits are bf16, so the bar on the losses and the gradient
# norm is one bf16 step of their size (phase 14's); gradients phase 14's
# 5% of each leaf's max |g|
P15_TOL = 2.0 ** -8


def _p15_cfg():
    return get_config(P15_ARCH).replace(n_layers=P15_LAYERS)


def _p15_tc():
    return TrainConfig(lr=1e-4, warmup_steps=1,
                       total_steps=sum(n for _, n in P15_RUNS))


def _p15_one(cfg, shape, tmp, split=P15_RANKS, cap=P15_CAP, seed=P15_SEED,
             tc=None, aux_router=False):
    """P = 1 on this process under remat_aware, its MoE dispatches keeping
    the pairs the ranks keep of their own rows (``_Keep(split=split)``:
    ``split`` expert shards, each dispatching one block of the rows at
    ``cap`` slots an expert): step 1's loss, ce, aux and gradients (saved
    on the host: the replicated leaves at ``tmp/grads1.pt``, shard r's
    rows of the routed experts' at ``tmp/grads1_r{r}.pt``), then two train
    steps from the same weights (step 1's gradient norm, step 2's loss).
    Its expert choices, call by call, are saved at ``tmp/calls.pt`` for
    the ranks to replay.  ``aux_router``: between the two, another forward
    whose aux loss alone is differentiated for the MoE routers
    (:func:`_aux_router`, saved at ``tmp/aux_router.pt``)."""
    one = DecoderLM(cfg, DEV)
    params = trainable(one.init(seed=seed))
    ds = SyntheticTokens(cfg, shape, device=DEV, seed=0)
    b0 = ds.batch(0)
    torch.cuda.reset_peak_memory_stats()
    rk, kp = _Router(), _Keep(split=split, cap=cap)
    with rk, kp:
        loss, met = one.loss(params, b0)
        gs = torch.autograd.grad(loss, leaves(params))
        first = [float(x.detach()) for x in (loss, met["ce"], met["aux"])]
        sharded = TF.expert_mask(params)
        torch.save([None if s else g.cpu() for g, s in zip(gs, sharded)],
                   os.path.join(tmp, "grads1.pt"))
        e = cfg.moe.n_routed // split
        for r in range(split):
            torch.save([g[r * e:(r + 1) * e].cpu() if s else None
                        for g, s in zip(gs, sharded)],
                       os.path.join(tmp, f"grads1_r{r}.pt"))
        del gs, loss, met
        if aux_router:
            torch.save([g.cpu() for g in _aux_router(one, params, b0)],
                       os.path.join(tmp, "aux_router.pt"))
        step = make_train_step(one, tc or _p15_tc())
        opt = adamw.init(params)
        s1 = step(params, opt, b0)
        s2 = step(params, opt, ds.batch(1))
    peak = torch.cuda.max_memory_allocated()
    torch.save({"calls": [c.cpu() for c in rk.seen],
                "keep": [k.cpu() for k in kp.seen]},
               os.path.join(tmp, "calls.pt"))
    names = _leaf_names(params)
    del one, params, opt, step
    _free()
    return first, s1, s2, peak, names


def _aux_router(model, params, batch, calls=None):
    """The gradient of the aux loss alone for every MoE layer's router (its
    own term of the router's gradient, which reducing the aux statistics
    over the wrong ranks scales), summed over the ranks holding distinct
    tokens; ``calls`` replays expert choices."""
    with (_Router(calls=calls) if calls is not None
          else contextlib.nullcontext()):
        _, met = model.loss(params, batch)
        ga = list(torch.autograd.grad(met["aux"], [
            lp["moe"]["router"] for lp in params["moe_layers"]]))
    tg = getattr(model, "token_group", None)
    if tg is not None and tg.size > 1:
        tg.all_reduce_(ga)
    return ga


def _p15_grads(model, params, batch, calls):
    """Step 1's loss, ce and aux on this rank and its own gradients (not
    yet summed over the ranks), replaying ``calls``'s expert choices (this
    rank's rows of P = 1's); and the pairs each dispatch kept."""
    rk = _Router(calls=calls)
    with rk, _Keep() as kp:
        loss, met = model.loss(params, batch)
        gs = torch.autograd.grad(loss, leaves(params))
    return ([float(x.detach()) for x in (loss, met["ce"], met["aux"])],
            list(gs), kp.seen)


def _p15_summed(model, params, raw):
    """``train.step.sum_grads`` of a copy of this rank's gradients."""
    from repro_torch.train import step as st
    return st.sum_grads(model, params, [g.clone() for g in raw])


def _p15_grad_err(model, grads, sharded, ref, names):
    """(worst leaf max|Δg| / max|g₁|, its name) of the ranks' summed
    gradients against P = 1's ``ref`` (this rank's part of it, on the
    host: the replicated leaves on rank 0, its rows of the experts on
    every rank; None elsewhere).  Each rank measures its part on the card,
    a block of at most 2^24 elements at a time (an embedding's gradient is
    3.7 GB in float32), and the numerators and denominators are
    max-reduced over the ranks (a collective: every rank calls it)."""
    num = torch.zeros(len(grads), device=DEV)
    den = torch.zeros(len(grads), device=DEV)
    n = 1 << 24
    for i, g in enumerate(grads):
        if ref[i] is not None:
            a, b = g.reshape(-1), ref[i].reshape(-1)
            for j in range(0, a.numel(), n):
                r = b[j:j + n].to(DEV).float()
                num[i] = torch.maximum(num[i],
                                       (a[j:j + n].float() - r).abs().max())
                den[i] = torch.maximum(den[i], r.abs().max())
                del r
    model.expert_group.all_reduce_([num, den], op="max")
    err = (num / den.clamp(min=1e-30)).cpu()
    i = int(err.argmax())
    return float(err[i]), names[i]


def _p15_rank(rank, tmp):
    """One rank of phase 15's world: step 1's loss, aux and gradients
    replaying P = 1's expert choices (held to P = 1's), the same under each
    planted fault (the gradient fault on the same gradients, with its
    norm), then the train steps of ``P15_RUNS`` (the first two replaying
    P = 1's choices)."""
    mesh = make_local_mesh(seq=P15_RANKS, device=DEV)
    p = mesh.coord("model")
    cfg = _p15_cfg()
    shape = ShapeSpec("chip15", P15_T, 1, "train")
    models = {s: DecoderLM(cfg, DEV, mesh=mesh, par=make_parallel_config(
        mesh, shape, schedule=s)) for s, _ in P15_RUNS}
    data = {s: SyntheticTokens(cfg, shape, device=DEV, seed=0, mesh=mesh,
                               par=m.par) for s, m in models.items()}
    bal = models["balanced"]
    params = trainable(bal.init(seed=P15_SEED))
    n = P15_T // P15_RANKS
    rec = torch.load(os.path.join(tmp, "calls.pt"))
    calls = [c[p * n:(p + 1) * n].to(DEV) for c in rec["calls"]]
    n_moe = cfg.n_layers - cfg.moe.n_dense_layers
    out = {"rank": p, "transport": mesh.transport,
           "expert_rows": tuple(params["moe_layers"][0]["moe"]["wg"].shape)}
    rep = torch.load(os.path.join(tmp, "grads1.pt"))
    ref = [x if p == 0 else None for x in rep]
    for i, x in enumerate(torch.load(os.path.join(tmp, f"grads1_r{p}.pt"))):
        if x is not None:
            ref[i] = x
    del rep
    names = _leaf_names(params)
    b0 = data["balanced"].batch(0)
    first, raw, kept = _p15_grads(bal, params, b0, calls[:2 * n_moe])
    out["first"] = first
    # the pairs this rank kept are the ones P = 1 kept of its rows
    out["kept_same"] = all(
        torch.equal(k.cpu(), r.view(P15_RANKS, -1)[p])
        for k, r in zip(kept, rec["keep"][:2 * n_moe]))
    grads, sharded = _p15_summed(bal, params, raw)
    out["grad_err"] = _p15_grad_err(bal, grads, sharded, ref, names)
    del grads
    out["faults"] = {}
    # the gradient fault reuses step 1's gradients: only their sum changes
    with _moe_fault("grads"):
        grads, sharded = _p15_summed(bal, params, raw)
    out["faults"]["grads"] = dict(first=first, grad_err=_p15_grad_err(
        bal, grads, sharded, ref, names), gnorm=float(adamw.global_norm(
            grads, norm_groups(bal, params))))
    del grads
    # the gradient norms again with the sums made by gloo-staged (printed
    # beside the gated readings: another summation order)
    stg = make_local_mesh(seq=P15_RANKS, device=DEV, transport="gloo-staged")
    st_bal = DecoderLM(cfg, DEV, mesh=stg, par=bal.par)
    out["staged_gnorm"] = []
    for fault in (None, "grads"):
        with (_moe_fault(fault) if fault else contextlib.nullcontext()):
            grads, sharded = _p15_summed(st_bal, params, raw)
        out["staged_gnorm"].append(float(adamw.global_norm(
            grads, norm_groups(st_bal, params))))
        del grads
    del raw, st_bal
    for fault in ("rotate", "aux"):
        with _moe_fault(fault):
            f, raw, _ = _p15_grads(bal, params, b0, calls[:2 * n_moe])
        grads, sharded = _p15_summed(bal, params, raw)
        out["faults"][fault] = dict(first=f, grad_err=_p15_grad_err(
            bal, grads, sharded, ref, names))
        del grads, raw
        _free()
    del ref
    comms = list({id(c): c for m in models.values()
                  for c in (m.seq_group, m.token_group, m.mesh.world)
                  if c is not None}.values())
    opt = adamw.init(params)
    tc = _p15_tc()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, i = [], 0
    for sched, k in P15_RUNS:
        step = make_train_step(models[sched], tc)
        for _ in range(k):
            batch = data[sched].batch(i)
            replay = (_Router(calls=calls[(2 + 2 * i) * n_moe:
                                          (4 + 2 * i) * n_moe])
                      if i < 2 else contextlib.nullcontext())
            torch.cuda.synchronize()
            build.reset_launches()
            c0 = _comm_seconds(comms)
            t0 = time.perf_counter()
            with replay:
                m = step(params, opt, batch)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            c1 = _comm_seconds(comms)
            steps.append(dict(
                schedule=sched, loss=m["loss"], ce=m["ce"], aux=m["aux"],
                gnorm=m["gnorm"], sec=sec, skipped=m["skipped_nonfinite"],
                comm={k2: c1[k2] - c0[k2] for k2 in c1},
                launches={k2: build.LAUNCHES[k2] for k2 in P14_KERNELS}))
            i += 1
    out["steps"] = steps
    out["peak"] = torch.cuda.max_memory_allocated()
    out["peak_reserved"] = torch.cuda.max_memory_reserved()
    out["comm_s"] = _process_comm_seconds()
    return out


def train_moe_ranks():
    """Phase 15: a gloo world of 4 ranks sharing the one card trains
    deepseek-v2-lite-16b at full width, depth cut to 3 of 27 layers (the
    dense layer 0 and 2 MoE layers), its 64 routed experts 16 a rank,
    one sequence of 16,384 tokens a step (4,096 a rank), bf16, seed-15
    weights, under remat_aware: 3 balanced steps and 1 zigzag step.
    Before the world starts, one process (P = 1) runs the same weights
    and tokens through the same kernels, keeping the pairs the ranks keep
    of their rows; the ranks replay its expert choices, so both compute
    one function up to float order.  Three planted faults must be
    rejected."""
    t_all = time.perf_counter()
    cfg = _p15_cfg()
    m = cfg.moe
    shape = ShapeSpec("chip15", P15_T, 1, "train")
    n_moe = cfg.n_layers - m.n_dense_layers
    from repro_torch.models.moe import capacity
    check(capacity(cfg, P15_T // P15_RANKS) == P15_CAP,
          f"capacity {capacity(cfg, P15_T // P15_RANKS)}, want {P15_CAP}")
    want = {s: _plan_launches(s, P15_RANKS, P15_T) for s, _ in P15_RUNS}
    say(f"  {cfg.name} at full width, {cfg.n_layers} of 27 layers "
        f"({m.n_dense_layers} dense + {n_moe} MoE, "
        f"{cfg.param_count() / 1e9:.2f} B params; {m.n_routed} routed "
        f"experts, {m.n_routed // P15_RANKS} a rank), one sequence of "
        f"{P15_T} tokens a step ({P15_T // P15_RANKS} a rank), bf16, seed "
        f"{P15_SEED}; capacity {P15_CAP} an expert from each rank's "
        f"{P15_T // P15_RANKS * m.top_k} pairs")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        first, s1, s2, peak1, names = _p15_one(cfg, shape, tmp)
        say(f"  P = 1 ({time.perf_counter() - t0:.1f} s, peak "
            f"{peak1 / 2**30:.2f} GiB): step 1 loss {first[0]:.6f} ce "
            f"{first[1]:.6f} aux {first[2]:.6e}; train step 1 loss "
            f"{s1['loss']:.6f} gnorm {s1['gnorm']:.4f}, step 2 loss "
            f"{s2['loss']:.6f}")
        _free()
        t0 = time.perf_counter()
        res = spawn(_p15_rank, P15_RANKS, (tmp,), device=DEV,
                    timeout=P15_TIMEOUT, threads=2)
        wall = time.perf_counter() - t0
    res.sort(key=lambda r: r["rank"])
    _say_comm(15, res)
    r0 = res[0]
    check(all(r["transport"] == P8_TRANSPORT for r in res),
          f"transport {[r['transport'] for r in res]}")
    check(all(r["expert_rows"][0] == m.n_routed // P15_RANKS for r in res),
          f"expert leaves {[r['expert_rows'] for r in res]}")
    check(all(r["kept_same"] for r in res), "a rank kept other pairs than "
          "P = 1 kept of its rows")

    def rel(a, b):
        return abs(a - b) / abs(b)
    d_loss, d_aux = rel(r0["first"][0], first[0]), rel(r0["first"][2],
                                                        first[2])
    err, leaf = r0["grad_err"]
    st = r0["steps"]
    d_gn, d_l2 = rel(st[0]["gnorm"], s1["gnorm"]), rel(st[1]["loss"],
                                                       s2["loss"])
    say(f"  P = 4 vs P = 1, step 1: loss {r0['first'][0]:.6f} relative |Δ| "
        f"{d_loss:.3e}, aux {r0['first'][2]:.6e} relative |Δ| {d_aux:.3e} "
        f"(limit {P15_TOL:.3e}); worst gradient leaf max|Δg| / max|g| "
        f"{err:.4f} ({leaf}; limit {GRAD_REL_TOL}); gnorm "
        f"{st[0]['gnorm']:.4f} vs {s1['gnorm']:.4f} relative |Δ| "
        f"{d_gn:.3e}; step 2 loss {st[1]['loss']:.6f} vs {s2['loss']:.6f} "
        f"relative |Δ| {d_l2:.3e} (limits {P15_TOL:.3e})")
    check(d_loss <= P15_TOL and d_aux <= P15_TOL, f"step 1 loss {d_loss} / "
          f"aux {d_aux} vs P = 1")
    check(err <= GRAD_REL_TOL, f"gradients vs P = 1: {leaf} {err}")
    check(d_gn <= P15_TOL and d_l2 <= P15_TOL, f"step 1 gnorm {d_gn}, step "
          f"2 loss {d_l2} vs P = 1")
    fl = {f: r0["faults"][f] for f in ("rotate", "aux", "grads")}
    agree = {f: len({tuple(r["faults"][f]["first"]) for r in res}) == 1
             for f in fl}
    ctl = {f: dict(loss=rel(x["first"][0], first[0]),
                   aux=max(rel(r["faults"][f]["first"][2], first[2])
                           for r in res),
                   grad=x["grad_err"][0]) for f, x in fl.items()}
    d_gn_ctl = rel(fl["grads"]["gnorm"], s1["gnorm"])
    st_gn = [rel(g, s1["gnorm"]) for g in r0["staged_gnorm"]]
    say("  controls (step 1, relative |Δloss| / worst rank's |Δaux| / worst "
        "leaf |Δg|; ranks agree): " + "; ".join(
            f"{f} {c['loss']:.3e} / {c['aux']:.3e} / {c['grad']:.4f}; "
            f"{agree[f]}" for f, c in ctl.items())
        + f"; gradient fault's gnorm relative |Δ| {d_gn_ctl:.3e}")
    say(f"  step 1's gnorm from the sums of gloo-staged instead of "
        f"{P8_TRANSPORT} (printed, not gated): relative |Δ| {st_gn[0]:.3e}, "
        f"the gradient fault's {st_gn[1]:.3e} (limit {P15_TOL:.3e})")
    check(ctl["rotate"]["grad"] > GRAD_REL_TOL, "the gradient limit does "
          f"not reject the rotated return all_to_all ({ctl['rotate']})")
    check(ctl["aux"]["aux"] > P15_TOL or not agree["aux"], "neither the aux "
          f"limit nor the ranks' agreement rejects the aux without its "
          f"cross-rank mean ({ctl['aux']})")
    check(ctl["grads"]["grad"] > GRAD_REL_TOL, f"the gradient limit does "
          f"not reject expert gradients summed over the sequence axis "
          f"({ctl['grads']})")
    check(d_gn_ctl > P15_TOL, f"the gnorm limit does not reject expert "
          f"gradients summed over the sequence axis ({d_gn_ctl})")
    launches = {k: 0 for k in P14_KERNELS}
    for r in res:
        for i, s in enumerate(r["steps"]):
            check(s["skipped"] == 0, f"rank {r['rank']} step {i + 1} "
                  "skipped")
            check(all(np.isfinite(s[k]) for k in ("loss", "ce", "aux")),
                  f"rank {r['rank']} step {i + 1}: {s}")
            w = cfg.n_layers * want[s["schedule"]][r["rank"]]
            check(all(s["launches"][k] == w for k in P14_KERNELS),
                  f"rank {r['rank']} step {i + 1} ({s['schedule']}): "
                  f"launches {s['launches']}, want {w} each")
            for k in P14_KERNELS:
                launches[k] += s["launches"][k]
        say(f"  rank {r['rank']}: peak {r['peak'] / 2**30:.2f} GiB "
            f"allocated, {r['peak_reserved'] / 2**30:.2f} reserved; "
            "launches A/C/D a step " + ", ".join(
                f"{s['schedule']} " + "/".join(
                    str(s["launches"][k]) for k in P14_KERNELS)
                for s in r["steps"]))
    for i, s in enumerate(st):
        vals = {(r["steps"][i]["loss"], r["steps"][i]["gnorm"]) for r in res}
        check(len(vals) == 1, f"step {i + 1}: ranks disagree {vals}")
        say(f"  step {i + 1} {s['schedule']:<8} loss {s['loss']:.5f} ce "
            f"{s['ce']:.5f} aux {s['aux']:.6e} gnorm {s['gnorm']:.4f} "
            f"{max(r['steps'][i]['sec'] for r in res):.3f} s; host blocked "
            "in shifts / all_to_alls / all-reduces, per rank: " + ", ".join(
                "/".join(f"{r['steps'][i]['comm'][k]:.3f}"
                         for k in ("shift", "a2a", "reduce")) for r in res)
            + " s")
    say(f"  world of {P15_RANKS} ranks: {wall:.1f} s, spawn included")
    out = dict(launches=launches, d_loss=d_loss, d_aux=d_aux, grad_err=err,
               d_gnorm=d_gn, d_loss2=d_l2, controls=ctl, d_gnorm_ctl=d_gn_ctl,
               staged_gnorm=st_gn,
               peaks=[r["peak"] for r in res], peak1=peak1,
               step_s=[max(r["steps"][i]["sec"] for r in res)
                       for i in range(len(st))],
               seconds=time.perf_counter() - t_all)
    say(f"  phase 15 took {out['seconds']:.1f} s")
    return out


P16_SEED, P16_RANKS = 16, 4
P16_T, P16_NEW = 16384, 32      # one prompt, 4,096 tokens a rank
P16_CTL_GEN = 4                 # decode steps of the decode fault's run
P16_WARM_T = 256
P16_TIMEOUT = 900


@contextlib.contextmanager
def _capacity(fn):
    """``models/moe.capacity`` is ``fn(cfg, n, base)`` while the block runs:
    room for the pairs a replay forces (its kept pairs came from other
    dispatches, so an expert may hold more than its own capacity; the
    buffer's extra slots stay empty and change nothing)."""
    from repro_torch.models import moe
    base = moe.capacity
    moe.capacity = lambda cfg, n: fn(cfg, n, base)
    try:
        yield
    finally:
        moe.capacity = base


@contextlib.contextmanager
def _expand_fault(params):
    """The latent ring's planted fault: every expansion up-projects with the
    next layer's ``wkv_b`` instead of its own."""
    ws = [lp["attn"]["wkv_b"] for lp in TF.layer_params(params)]
    base = LY.mla_expand

    def wrong(latent, w_up, cfg):
        i = next(j for j, w in enumerate(ws) if w is w_up)
        return base(latent, ws[(i + 1) % len(ws)], cfg)
    LY.mla_expand = wrong
    try:
        yield
    finally:
        LY.mla_expand = base


def _ring_compare(grp, calls, cfg):
    """Each layer's inputs of the latent-ring prefill (``calls``: q, k, v,
    payload, w_up) through the zigzag K/V ring (``dist_attn_fwd``) and the
    latent ring, one after the other: host seconds a ring (device synced)
    and blocked in shifts, the elements a position each shift carries
    (summed over its tensors), and the outputs' largest difference
    relative to the K/V ring's."""
    from repro_torch.core.dist_attention import (DistAttnSpec,
                                                 dist_attn_fwd,
                                                 dist_attn_fwd_latent)
    spec = DistAttnSpec(axis="model", axis_size=grp.size, schedule="zigzag",
                        scale=LY.mla_scale(cfg))
    expand = lambda x, w: LY.mla_expand(x, w, cfg)
    out = {k: dict(s=0.0, shift=0.0, elems=[]) for k in ("kv", "latent")}
    shift, err = grp.shift, 0.0
    for q, k, v, payload, w_up in calls:
        o = {}
        for name in ("kv", "latent"):
            rec = out[name]

            def noted(ts, hops, rec=rec):
                rec["elems"].append(sum(t.numel() // (t.shape[0]
                                                      * t.shape[1])
                                        for t in ts))
                return shift(ts, hops)
            grp.shift = noted
            torch.cuda.synchronize()
            t0, w0 = time.perf_counter(), grp.shift_wait_s
            o[name] = (dist_attn_fwd(q, k, v, spec=spec, group=grp)[0]
                       if name == "kv" else dist_attn_fwd_latent(
                           q, k, v, payload, w_up, expand, spec=spec,
                           group=grp)[0])
            torch.cuda.synchronize()
            rec["s"] += time.perf_counter() - t0
            rec["shift"] += grp.shift_wait_s - w0
            del grp.shift
        err = max(err, float((o["latent"].float() - o["kv"].float()).abs()
                             .max() / o["kv"].float().abs().max()))
    for rec in out.values():
        rec["elems"] = sorted(set(rec.pop("elems")))
    out["err"] = err
    return out


def _p16_ring(mesh, model, params, prompt, kept, rk, kp):
    """Phase 16's latent ring on this rank: the prompt prefilled again
    under zigzag with ``latent_ring=True``, replaying the balanced run's
    expert choices and kept pairs (``rk`` / ``kp``: this rank's; every
    rank's are all-gathered and each row takes its own, at its zigzag
    position; a zigzag rank's rows come from two balanced ranks, so an
    expert gets the most slots any zigzag rank's kept pairs need); its
    last logits, launches, host seconds and its latent
    cache held to the balanced run's (``kept``: this rank's ``{"ckv"}``
    shard), un-permuted; the same prefill under the planted expand fault;
    then each layer's attention inputs through both rings
    (:func:`_ring_compare`)."""
    from repro_torch.core.dist_attention import shard_positions
    cfg, grp = model.cfg, model.seq_group
    P, n_moe = grp.size, cfg.n_layers - cfg.moe.n_dense_layers
    every = lambda x: grp.all_gather(x.contiguous(), dim=1)
    calls = every(torch.stack(rk.seen[:n_moe]))           # (n_moe, T, k)
    keep = every(torch.stack(kp.seen[:n_moe]).view(n_moe, -1, cfg.moe.top_k)
                 .to(torch.uint8))
    zig = [torch.as_tensor(shard_positions(P16_T, P, r, True), device=DEV)
           for r in range(P)]
    pos = zig[grp.rank]
    # each MoE layer's slots an expert: the most pairs any zigzag rank's
    # rows keep for one expert (the same on every rank)
    E = cfg.moe.n_routed
    caps = [max(int(torch.bincount(c[z][k[z].bool()], minlength=E).max())
                for z in zig) for c, k in zip(calls, keep)]
    zz = DecoderLM(cfg, DEV, par=dataclasses.replace(model.par,
                                                     schedule="zigzag"),
                   mesh=mesh, latent_ring=True)
    seen = []
    base = TF.dist_attn_fwd_latent

    def noted(*a, **kw):
        seen.append(a[:5])
        return base(*a, **kw)

    def replay(fault=False):
        cap = iter(caps)
        with _Router(calls=[c[pos] for c in calls]), _Keep(calls=[
                c[pos].reshape(-1).bool() for c in keep]), _capacity(
                lambda c, n, b: max(b(c, n), next(cap))), (
                _expand_fault(params) if fault
                else contextlib.nullcontext()):
            return zz.prefill(params, prompt)
    torch.cuda.synchronize()
    build.reset_launches()
    t0, w0, a0 = time.perf_counter(), grp.shift_wait_s, grp.a2a_s
    TF.dist_attn_fwd_latent = noted
    try:
        logits, cache = replay()
        torch.cuda.synchronize()
    finally:
        TF.dist_attn_fwd_latent = base
    out = dict(launches=dict(build.LAUNCHES), s=time.perf_counter() - t0,
               shift=grp.shift_wait_s - w0, a2a=grp.a2a_s - a0,
               logits=logits[:, -1].float().cpu(), ring_calls=len(seen),
               caps=(min(caps), max(caps)))
    whole = grp.all_gather(kept.contiguous(), dim=2)[:, :, pos].float()
    out["cache_err"] = float((cache["ckv"].float() - whole).abs().max()
                             / whole.abs().max())
    del whole, cache, logits
    out["ctl"] = replay(fault=True)[0][:, -1].float().cpu()
    out["rings"] = _ring_compare(grp, seen, cfg)
    del seen, zz
    return out


def _p16_rank(rank, tmp):
    """One rank of phase 16's world: deepseek-v2-lite-16b at full size, its
    routed experts 16 a rank; a warm-up, then one 16,384-token prompt
    through ``FixedSlotEngine`` (balanced whole-prompt prefill across the
    ranks, the latent cache sharded along the sequence, 32 greedy tokens),
    recording every MoE call's expert choices and kept pairs; then the
    planted-fault runs teacher-forced on its tokens, and the latent ring
    (:func:`_p16_ring`)."""
    mesh = make_local_mesh(seq=P16_RANKS, device=DEV)
    cfg = get_config(P12_ARCH)
    par = make_parallel_config(mesh, ShapeSpec("chip16", P16_T, 1,
                                               "decode"), schedule="balanced")
    model = DecoderLM(cfg, DEV, par=par, mesh=mesh)
    params = model.init(seed=P16_SEED)
    prompt = np.random.default_rng(16).integers(
        0, cfg.vocab, (1, P16_T)).astype(np.int32)
    out = {"rank": mesh.coord("model"), "transport": mesh.transport,
           "n_params": sum(t.numel() for t in leaves(params)),
           "shards": model.decode_group.size}
    eng = FixedSlotEngine(model, params)
    eng.generate({"tokens": prompt[:, :P16_WARM_T]}, 2)
    comms = list({id(c): c for c in (model.seq_group, model.decode_group,
                                     model.token_group)}.values())
    times, kept = {}, {}
    prefill = model.prefill

    def keeping(p, tokens):
        logits, cache = prefill(p, tokens)
        kept["ckv"] = cache["ckv"]
        return logits, cache
    model.prefill = _timed(times, "prefill", keeping)
    model.decode = _timed(times, "decode", model.decode)
    _free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = _comm_seconds(comms)
    build.reset_launches()
    rk = _Router()
    with rk, _Keep() as kp, _recorded(model) as logs:
        toks, _ = eng.generate({"tokens": prompt}, P16_NEW)
    launches = dict(build.LAUNCHES)
    c1 = _comm_seconds(comms)
    out.update(tokens=toks.cpu(), logits=torch.stack(logs),
               launches=launches, prefill_s=times["prefill"][0],
               decode_ms=[1e3 * t for t in times["decode"]],
               comm={k: c1[k] - c0[k] for k in c1},
               peak=torch.cuda.max_memory_allocated())
    del model.prefill, model.decode
    torch.save({"calls": [c.cpu() for c in rk.seen],
                "keep": [k.cpu() for k in kp.seen]},
               os.path.join(tmp, f"rank{out['rank']}.pt"))
    out["controls"] = {}
    # the dispatch fault shows in the prefill's logits, one step is enough
    for fault, n in (("psum", P16_CTL_GEN), ("rotate", 1)):
        with _moe_fault(fault), _recorded(model, toks[:, :n]) as logs:
            eng.generate({"tokens": prompt}, n)
        out["controls"][fault] = torch.stack(logs)
    del eng
    _free()
    out["ring"] = _p16_ring(mesh, model, params, prompt, kept.pop("ckv"),
                            rk, kp)
    out["comm_s"] = _process_comm_seconds()
    return out


def serve_moe_ranks():
    """Phase 16: a gloo world of 4 ranks sharing the one card serves
    deepseek-v2-lite-16b at full size (nothing cut; its routed experts 16
    a rank) through ``FixedSlotEngine``: one prompt of 16,384 tokens, a
    balanced whole-prompt prefill across the ranks (kernel A's pair route
    under the plan's steps, the MoE dispatched over the ranks), 32 greedy
    tokens over the sharded latent cache (each step's MoE summed over the
    ranks' experts).  Then one process runs the same weights and prompt
    through phase 13's path, replaying the ranks' expert choices and kept
    pairs, teacher-forced on their tokens: every step's logits within 5%
    of max |logit|, which must reject two planted faults."""
    t_all = time.perf_counter()
    cfg = get_config(P12_ARCH)
    m = cfg.moe
    n_moe = cfg.n_layers - m.n_dense_layers
    want = _plan_launches("balanced", P16_RANKS, P16_T)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = spawn(_p16_rank, P16_RANKS, (tmp,), device=DEV,
                    timeout=P16_TIMEOUT, threads=2)
        wall = time.perf_counter() - t0
        res.sort(key=lambda r: r["rank"])
        _say_comm(16, res)
        recs = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(P16_RANKS)]
    r0 = res[0]
    check(all(r["transport"] == P8_TRANSPORT for r in res),
          f"transport {[r['transport'] for r in res]}")
    toks = r0["tokens"]
    check(tuple(toks.shape) == (1, P16_NEW) and bool(
        ((toks >= 0) & (toks < cfg.vocab)).all()), f"tokens {toks}")
    check(all(torch.equal(r["tokens"], toks) for r in res),
          "the ranks' tokens differ")
    for r in res:
        w = cfg.n_layers * want[r["rank"]]
        check(r["launches"]["flash_fwd_pair"] == w and all(
            n == 0 for k, n in r["launches"].items()
            if k != "flash_fwd_pair"), f"rank {r['rank']}: launches "
            f"{r['launches']}, want flash_fwd_pair {w} and nothing else")
        check(bool(torch.isfinite(r["logits"]).all()), "non-finite logits")
        dc = r["decode_ms"]
        say(f"  rank {r['rank']}: {r['n_params'] / 1e9:.2f} B parameters, "
            f"peak {r['peak'] / 2**30:.2f} GiB; prefill {r['prefill_s']:.3f} "
            f"s, decode {float(np.median(dc)):.2f} ms a step (median); host "
            "blocked in shifts / all_to_alls / all-reduces "
            + "/".join(f"{r['comm'][k]:.3f}" for k in ("shift", "a2a",
                                                       "reduce"))
            + f" s; launches {r['launches']}")
    # the prefill's dispatches (one a MoE layer, each rank its rows), then
    # 32 decode steps' (every rank routes the same row: rank 0's)
    calls = [torch.cat([rec["calls"][i] for rec in recs]) for i in
             range(n_moe)] + recs[0]["calls"][n_moe:]
    keep = [torch.cat([rec["keep"][i] for rec in recs])
            for i in range(n_moe)]
    check(all(len(rec["keep"]) == n_moe for rec in recs),
          "a decode step dispatched")
    del recs
    _free()
    t0 = time.perf_counter()
    one = DecoderLM(cfg, DEV)
    params = one.init(seed=P16_SEED)
    prompt = np.random.default_rng(16).integers(
        0, cfg.vocab, (1, P16_T)).astype(np.int32)
    from repro_torch.models.moe import capacity
    cap1 = capacity(cfg, P16_T)
    rr = _Router(calls=[c.to(DEV) for c in calls])
    with rr, _Keep(calls=keep), _recorded(one, toks) as lg:
        FixedSlotEngine(one, params).generate({"tokens": prompt}, P16_NEW)
    ref = torch.stack(lg)
    check(len(rr.seen) == len(calls) and all(
        torch.equal(a.cpu(), b) for a, b in zip(rr.seen, calls)),
        "the one process did not replay every expert choice")
    del one, params
    _free()
    check(ref.shape == r0["logits"].shape, f"steps {ref.shape} "
          f"{r0['logits'].shape}")
    err = max(_step_err(r["logits"], ref) for r in res)
    ctl = {"psum": _step_err(r0["controls"]["psum"][1:],
                             ref[1:P16_CTL_GEN + 1]),
           "rotate": _step_err(r0["controls"]["rotate"], ref[:2])}
    say(f"  one process replaying the ranks' experts and kept pairs "
        f"({time.perf_counter() - t0:.1f} s; capacity {cap1} an expert for "
        f"the whole prompt, the ranks' {capacity(cfg, P16_T // P16_RANKS)} "
        f"each): teacher-forced logits, worst step max|Δ| / max|logit| over "
        f"{P16_NEW + 1} steps (limit {LOGIT_REL_TOL}): {err:.3e}; controls: "
        f"decode without the experts' sum over the ranks {ctl['psum']:.3e}, "
        f"return all_to_all rotated {ctl['rotate']:.3e}")
    check(err <= LOGIT_REL_TOL, f"P = 4 fixed-slot logits vs one process: "
          f"{err} over {LOGIT_REL_TOL}")
    for f, e in ctl.items():
        check(e > LOGIT_REL_TOL, f"the logit limit does not reject the {f} "
              f"control ({e})")
    ring = _p16_ring_gates(cfg, res, ref[:1])
    launches = {k: sum(r["launches"][k] for r in res) for k in r0["launches"]}
    out = dict(launches=launches, err=err, controls=ctl,
               prefill_s=max(r["prefill_s"] for r in res),
               decode_ms=[float(np.median(r["decode_ms"])) for r in res],
               peaks=[r["peak"] for r in res], world_s=wall, ring=ring,
               seconds=time.perf_counter() - t_all)
    say(f"  world of {P16_RANKS} ranks: {wall:.1f} s, spawn included; phase "
        f"16 took {out['seconds']:.1f} s")
    return out


def _p16_ring_gates(cfg, res, ref):
    """Phase 16's latent-ring gates over the ranks' :func:`_p16_ring`
    results: A's pair route launched the zigzag plan's coverage count ×
    layers on every rank and nothing else; the last logits within 5% of max
    |logit| of the one process (``ref``: its prefill logits, replaying the
    same expert choices and kept pairs); the latent cache un-permuted
    within the same bar of the balanced run's; the expand fault rejected;
    the K/V ring shipping 16 × (192 + 128) elements a position, the latent
    ring kv_lora + rope, their outputs within bf16's 2e-2 of each other."""
    a = cfg.attn
    want = _plan_launches("zigzag", P16_RANKS, P16_T)
    lat = a.kv_lora_rank + a.qk_rope_head_dim
    kv = a.n_heads * (a.qk_nope_head_dim + a.qk_rope_head_dim
                      + a.v_head_dim)
    for r in res:
        g = r["ring"]
        w = cfg.n_layers * want[r["rank"]]
        check(g["launches"]["flash_fwd_pair"] == w and all(
            n == 0 for k, n in g["launches"].items()
            if k != "flash_fwd_pair"), f"rank {r['rank']}: latent ring "
            f"launches {g['launches']}, want flash_fwd_pair {w} only")
        check(g["ring_calls"] == cfg.n_layers, f"rank {r['rank']}: "
              f"{g['ring_calls']} latent-ring attention calls")
        rg = g["rings"]
        check(rg["latent"]["elems"] == [lat] and rg["kv"]["elems"] == [kv],
              f"rank {r['rank']}: elements a position shipped: latent "
              f"{rg['latent']['elems']}, K/V {rg['kv']['elems']}")
        check(rg["err"] <= TOL[torch.bfloat16], f"rank {r['rank']}: the "
              f"rings' outputs differ by {rg['err']} of max |o|")
    from repro_torch.models.moe import capacity
    own = capacity(cfg, P16_T // P16_RANKS)
    err = max(_step_err([r["ring"]["logits"]], ref) for r in res)
    cache = max(r["ring"]["cache_err"] for r in res)
    ctl = max(_step_err([r["ring"]["ctl"]], ref) for r in res)
    for r in res:
        g, rg = r["ring"], r["ring"]["rings"]
        say(f"  rank {r['rank']}: latent-ring zigzag prefill "
            f"{g['s']:.3f} s (host blocked in shifts {g['shift']:.3f} s, "
            f"all_to_alls {g['a2a']:.3f} s; the replayed pairs take "
            f"{g['caps'][0]}-{g['caps'][1]} slots an expert, the ranks' "
            f"own dispatch {own}); attention alone over the "
            f"{cfg.n_layers} layers' inputs: K/V ring {rg['kv']['s']:.3f} s "
            f"({rg['kv']['shift']:.3f} s in shifts, {kv} elements = "
            f"{2 * kv} bytes a position), latent ring "
            f"{rg['latent']['s']:.3f} s ({rg['latent']['shift']:.3f} s in "
            f"shifts, {lat} elements = {2 * lat} bytes a position); "
            f"outputs max|Δ| {rg['err']:.3e} of max |o|; launches "
            f"{g['launches']}")
    say(f"  latent ring (zigzag, replaying the balanced run's experts and "
        f"kept pairs): last logits max|Δ| / max|logit| {err:.3e} against "
        f"the one process (limit {LOGIT_REL_TOL}); latent cache "
        f"un-permuted against the balanced run's {cache:.3e} of max |ckv|; "
        f"control (each expansion with the next layer's wkv_b) {ctl:.3e}")
    check(err <= LOGIT_REL_TOL, f"latent-ring logits vs one process: {err}")
    check(cache <= LOGIT_REL_TOL, f"latent-ring cache vs balanced: {cache}")
    check(ctl > LOGIT_REL_TOL, f"the logit limit does not reject the "
          f"expand control ({ctl})")
    return dict(err=err, cache_err=cache, ctl=ctl,
                launches=sum(r["ring"]["launches"]["flash_fwd_pair"]
                             for r in res),
                s=[r["ring"]["s"] for r in res],
                shift=[r["ring"]["shift"] for r in res],
                rings={k: dict(s=[r["ring"]["rings"][k]["s"] for r in res],
                               shift=[r["ring"]["rings"][k]["shift"]
                                      for r in res])
                       for k in ("kv", "latent")})


# ---------------------------------------------------------------- phase 17

P17_SEED, P17_RANKS = 17, 4
# the dense layer 0 and 8 MoE layers of 27: at full depth the phase took
# 152.2 s on an H100 80GB HBM3 at 700 W (a decode step 1.42 s a rank, four
# ranks' expert reads serialised on the one card), beyond its share of
# the run's time
P17_LAYERS = 9
P17_CORRUPT = 10        # phase 11 (b)'s corrupted block's step
P17_CTL_NEW = 2         # tokens a request in each planted-fault run
P17_TIMEOUT = 900


@contextlib.contextmanager
def _gather_fault():
    """Phase 17's pool control: every latent-pool gather rotated by one
    rank (each rank's blocks land where the next rank's belong)."""
    from repro_torch.serve import cache as cm
    base = cm.gather_pool

    def rotated(pool, shard):
        g = base(pool, shard)
        return g if shard is None else torch.roll(g, shard.n_local, dims=0)
    cm.gather_pool = TF.gather_pool = rotated
    try:
        yield
    finally:
        cm.gather_pool = TF.gather_pool = base


@contextlib.contextmanager
def _chunk_moe_fault():
    """Phase 17's dispatch control: every rank dispatches all of a chunk's
    replicated rows (each expert's capacity from the chunk's C rows, not
    from the rank's C/S)."""
    from repro_torch.models.moe import moe_apply
    base = DecoderLM._split_moe
    DecoderLM._split_moe = lambda self, p, h: moe_apply(
        p, h, self.cfg, group=self.expert_group)[0]
    try:
        yield
    finally:
        DecoderLM._split_moe = base


def _v_of(k, v):
    """What :func:`_captured` keeps of v: its width when it is k's leading
    columns (a latent pool's view), else a clone."""
    return v.shape[-1] if v.data_ptr() == k.data_ptr() else v.clone()


def _v_back(k, v):
    return k[..., :v] if isinstance(v, int) else v


@contextlib.contextmanager
def _captured():
    """Kernel A's first chunk call past the first chunk (q_offset > 0) and
    kernel B's first decode call (Tq 1, over the gathered pool) while the
    block runs, inputs cloned: {"A": (q, k, v, kwargs), "B": (q, k, v,
    table, lengths, kwargs)}, v as :func:`_v_of` keeps it."""
    from repro_torch.serve import cache as cm
    got = {}
    a_base, b_base = TF.chunk_attn, cm.paged_decode_attn

    def a(q, k, v, **kw):
        if "A" not in got and kw.get("q_offset", 0) > 0:
            got["A"] = (q.clone(), k.clone(), _v_of(k, v), dict(kw))
        return a_base(q, k, v, **kw)

    def b(q, k, v, bt, lens, **kw):
        if "B" not in got and q.shape[1] == 1:
            got["B"] = (q.clone(), k.clone(), _v_of(k, v), bt.clone(),
                        lens.clone(), dict(kw))
        return b_base(q, k, v, bt, lens, **kw)
    TF.chunk_attn, cm.paged_decode_attn = a, b
    try:
        yield got
    finally:
        TF.chunk_attn, cm.paged_decode_attn = a_base, b_base


def _held(got, phase=17):
    """The captured A and B calls (:func:`_captured`) through the kernels
    and their plain versions (``impl="ref"``), at phase 12's limits: A's
    o element-wise 2e-2 and relative 3e-2, its lse 1e-4; B's o 2e-2."""
    from repro_torch.serve import cache as cm
    q, k, c, kw = got["A"]
    o, lse = TF.chunk_attn(q, k, _v_back(k, c), **kw)
    o_r, lse_r = TF.chunk_attn(q, k, _v_back(k, c), **{**kw, "impl": "ref"})
    tol = TOL[q.dtype]
    a_err = float((o.float() - o_r.float()).abs().max())
    a_rel = rel_err(o, o_r) if q.dtype == torch.bfloat16 else 0.0
    valid = lse_r > NEG_INF / 2
    l_err = float((lse - lse_r).abs()[valid].max())
    check(torch.allclose(o.float(), o_r.float(), atol=tol, rtol=tol)
          and a_rel <= REL_TOL
          and l_err <= LSE_TOL * (1 + float(lse_r[valid].abs().max())),
          f"phase {phase} chunk: A against its plain version o {a_err}, "
          f"rel {a_rel}, lse {l_err}")
    q, k, c, bt, lens, kw = got["B"]
    o = cm.paged_decode_attn(q, k, _v_back(k, c), bt, lens, **kw)
    o_r = cm.paged_decode_attn(q, k, _v_back(k, c), bt, lens,
                               **{**kw, "impl": "ref"})
    b_err = float((o.float() - o_r.float()).abs().max())
    tol = PAGED_TOL[q.dtype]
    check(torch.allclose(o.float(), o_r.float(), atol=tol, rtol=tol),
          f"phase {phase} decode: B against its plain version {b_err}")
    return dict(A=(a_err, a_rel, l_err, tuple(got["A"][0].shape),
                   got["A"][3]["q_offset"]), B=(b_err, tuple(k.shape)))


def _p17_cfg():
    return get_config(P12_ARCH).replace(n_layers=P17_LAYERS)


def _p17_rank(rank, tmp):
    """One rank of phase 17's world: deepseek-v2-lite-16b at full width,
    P17_LAYERS deep, its routed experts 16 a rank, through phase 4's paged
    engine over a latent pool block-sharded on the 4 ranks; a warm-up,
    then phase 11's run (a
    fork, a corrupted block) recording every MoE call's expert choices and
    kept pairs, the pool gathers' and the MoE sums' host seconds in each
    decode, and on rank 0 one chunk's A call and one decode's B call held
    to their plain versions; then the three planted-fault runs."""
    mesh = make_local_mesh(seq=P17_RANKS, device=DEV)
    cfg = _p17_cfg()
    par = make_parallel_config(mesh, ShapeSpec(
        "chip17", 1024, P4_ENGINE["max_batch"], "prefill"))
    model = DecoderLM(cfg, DEV, par=par, mesh=mesh)
    params = model.init(seed=P17_SEED)
    grp = model.seq_group
    out = {"rank": mesh.coord("model"), "transport": mesh.transport,
           "n_params": sum(t.numel() for t in leaves(params))}
    warm = Engine(model, params, **P4_ENGINE)
    warm.submit(_p11_prompts(cfg.vocab)[3], max_new_tokens=2)
    warm.run()
    del warm
    dec = dict(s=[], gather=0.0, reduce=0.0)
    decode = model.decode

    def timed(*a):
        torch.cuda.synchronize()
        t0, g0, r0 = time.perf_counter(), grp.gather_s, grp.reduce_s
        logits = decode(*a)
        torch.cuda.synchronize()
        dec["s"].append(time.perf_counter() - t0)
        dec["gather"] += grp.gather_s - g0
        dec["reduce"] += grp.reduce_s - r0
        return logits
    model.decode = timed
    _free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = _comm_seconds([grp])
    build.reset_launches()
    rk = _Router()
    t0 = time.perf_counter()
    with rk, _Keep() as kp, (_captured() if out["rank"] == 0
                             else contextlib.nullcontext({})) as got:
        r = _p11_run(model, params, P17_CORRUPT, router=rk)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    c1 = _comm_seconds([grp])
    del model.decode
    rows = _host_rows(r["rec"])
    out.update(
        sharding=r["eng"].cache.sharding,
        local=tuple(r["eng"].cache.pools["ckv_pool"].shape),
        out=r["out"], log=r["log"], states=r["states"],
        forks=r["st"]["forks"], quarantined=r["st"]["quarantined"],
        sums=_sums(rows), rows=rows if out["rank"] == 0 else None,
        launches=launches, wall=wall, step_ms=[1e3 * t for t in r["step_s"]],
        decode=dec, comm={k: c1[k] - c0[k] for k in c1},
        peak=torch.cuda.max_memory_allocated(),
        held=_held(got) if out["rank"] == 0 else None)
    torch.save({"calls": [c.cpu() for c in rk.seen], "valid": rk.valid,
                "keep": [k.cpu() for k in kp.seen]},
               os.path.join(tmp, f"rank{out['rank']}.pt"))
    del r, rk, kp, got
    _free()
    out["controls"] = {}
    for name, fault in (("chunk", _chunk_moe_fault), ("psum", lambda:
                        _moe_fault("psum")), ("gather", _gather_fault)):
        with fault():
            bad = _p11_run(model, params, None, n_new=P17_CTL_NEW)
        out["controls"][name] = (dict(out=bad["out"],
                                      rows=_host_rows(bad["rec"]))
                                 if out["rank"] == 0 else None)
        del bad
    out["comm_s"] = _process_comm_seconds()
    return out


def serve_moe_paged():
    """Phase 17: a gloo world of 4 ranks sharing the one card serves
    deepseek-v2-lite-16b at full width, P17_LAYERS of its 27 layers deep
    (its routed experts 16 a rank) through phase 4's paged Engine over a
    latent pool block-sharded on the
    ranks: chunks through A's latent route over the gathered pool, each
    chunk's MoE rows split over the ranks, decode through B over the
    gathered pool with the experts summed over the ranks; phase 11's
    requests (a fork, a corrupted block).  Then one process runs the paged
    Engine on the same weights, replaying the ranks' expert choices and
    kept pairs, teacher-forced on their tokens: every step's logits within
    5% of max |logit|, which must reject three planted faults."""
    from repro_torch.models.moe import capacity
    t_all = time.perf_counter()
    cfg = _p17_cfg()
    P = P17_RANKS
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = spawn(_p17_rank, P, (tmp,), device=DEV, timeout=P17_TIMEOUT,
                    threads=2)
        world = time.perf_counter() - t0
        res.sort(key=lambda r: r["rank"])
        _say_comm(17, res)
        recs = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(P)]
    zero = res[0]
    check(all(r["transport"] == P8_TRANSPORT for r in res),
          f"transport {[r['transport'] for r in res]}")
    nb = P4_ENGINE["n_blocks"] // P
    for r in res:
        check(r["sharding"] == "blocks" and r["local"][1] == nb,
              f"rank {r['rank']}: pool {r['sharding']} {r['local']}")
        check(r["sums"] == zero["sums"], "the ranks computed other logits")
        check(all(np.array_equal(a, b) for a, b in zip(r["out"],
                                                       zero["out"]))
              and r["log"] == zero["log"] and r["states"] == zero["states"],
              f"rank {r['rank']}: streams, fault log or states differ")
        L = r["launches"]
        check(L["flash_fwd_latent"] > 0 and L["paged_decode"] > 0
              and L["flash_fwd"] == 0 and L["flash_fwd_pair"] == 0,
              f"rank {r['rank']}: launches {L}")
    check(zero["forks"] >= 1, "phase 17: no copy-on-write fork")
    failed = [i for i, s in enumerate(zero["states"])
              if s == ("failed", "nan_logits")]
    (_, _, detail), = zero["log"]
    victim = int(detail.split("rid=")[1].split()[0])
    check(failed == [victim], f"phase 17: quarantined {failed}, the "
          f"corrupted block's owner is {victim}")
    # one process replays the ranks: their chunk calls' rows concatenated
    # in rank order, each decode call's from rank 0 (every rank routes the
    # same rows); the kept pairs of every dispatch likewise
    calls = [torch.cat([rec["calls"][i] for rec in recs])
             if isinstance(v, int) else recs[0]["calls"][i]
             for i, v in enumerate(recs[0]["valid"])]
    keep = [torch.cat([rec["keep"][j] for rec in recs])
            for j in range(len(recs[0]["keep"]))]
    del recs
    prompts = _p11_prompts(cfg.vocab)
    forced = {(i, len(p) + j): int(t) for i, p in enumerate(prompts)
              for j, t in enumerate(zero["out"][i])}
    t0 = time.perf_counter()
    one = DecoderLM(cfg, DEV)
    params = one.init(seed=P17_SEED)
    rr = _Router(calls=[c.to(DEV) for c in calls])
    with rr, _Keep(calls=keep), _capacity(lambda c, n, b: max(
            b(c, n), P * b(c, n // P))):
        ref = _p11_run(one, params, P17_CORRUPT, router=rr, forced=forced)
    del ref["eng"]
    check(len(rr.seen) == len(calls) and all(
        torch.equal(a.cpu(), b) for a, b in zip(rr.seen, calls)),
        "the one process did not replay every expert choice")
    del one, params, rr
    _free()
    one_s = time.perf_counter() - t0
    check(all(np.array_equal(a, b) for a, b in zip(ref["out"], zero["out"]))
          and ref["log"] == zero["log"] and ref["states"] == zero["states"],
          "the teacher-forced one process took another course")
    ref = dict(out=ref["out"], rec={"logits": _host_rows(ref["rec"])},
               step_s=ref["step_s"])
    temps = [0.0] * len(prompts)
    err, _ = _p9_compare(ref, dict(out=zero["out"], rec={
        "logits": zero["rows"]}), prompts, temps)
    ctl = {k: _p9_compare(ref, dict(out=v["out"], rec={"logits": v["rows"]}),
                          prompts, temps, gate=False)[0]
           for k, v in zero["controls"].items()}
    h = zero["held"]
    say(f"  {cfg.name} at full width, {cfg.n_layers} of 27 layers, {P} "
        f"ranks ({zero['n_params'] / 1e9:.2f} B parameters a rank), latent pool block-sharded (local "
        f"{zero['local']}): streams, fault log and states equal on every "
        f"rank, logits checksums equal; forks {zero['forks']}, fault log "
        f"{zero['log']}, states {zero['states']}")
    say(f"  rank 0's chunk call of A (latent route, q "
        f"{tuple(h['A'][3])}, q_offset {h['A'][4]}) against its plain "
        f"version: max|Δo| {h['A'][0]:.3e}, rel {h['A'][1]:.3e}, max|Δlse| "
        f"{h['A'][2]:.3e}; a decode call of B over the gathered pool "
        f"{h['B'][1]}: max|Δo| {h['B'][0]:.3e}")
    say(f"  one process replaying the ranks' experts and kept pairs, "
        f"teacher-forced ({one_s:.1f} s; capacity a chunk "
        f"{capacity(cfg, P4_ENGINE['prefill_chunk_tokens'])} an expert, "
        f"a rank's {capacity(cfg, P4_ENGINE['prefill_chunk_tokens'] // P)}"
        f" of its {P4_ENGINE['prefill_chunk_tokens'] // P} rows): every "
        f"row max|Δ| / max|logit| {err:.3e} (limit {LOGIT_REL_TOL}); "
        f"controls: every rank dispatching the whole chunk "
        f"{ctl['chunk']:.3e}, decode without the experts' sum "
        f"{ctl['psum']:.3e}, pool gather rotated by a rank "
        f"{ctl['gather']:.3e}")
    check(err <= LOGIT_REL_TOL, f"phase 17 logits vs one process: {err}")
    for k, e in ctl.items():
        check(e > LOGIT_REL_TOL, f"the logit limit does not reject the {k} "
              f"control ({e})")
    for r in res:
        d = r["decode"]
        tot = sum(d["s"])
        say(f"  rank {r['rank']}: decode-step ms (median) "
            f"{float(np.median(r['step_ms'])):.2f}; decode calls "
            f"{len(d['s'])}, {tot:.3f} s: pool gathers {d['gather']:.3f} s "
            f"({d['gather'] / tot:.3f}), MoE sums {d['reduce']:.3f} s "
            f"({d['reduce'] / tot:.3f}); the run {r['wall']:.1f} s, host "
            f"blocked in all_to_alls / all-reduces and gathers "
            f"{r['comm']['a2a']:.3f} / {r['comm']['reduce']:.3f} s; peak "
            f"{r['peak'] / 2**30:.2f} GiB; launches {r['launches']}")
    launches = {k: sum(r["launches"][k] for r in res)
                for k in zero["launches"]}
    out = dict(launches=launches, err=err, controls=ctl, held=h,
               step_ms=[float(np.median(r["step_ms"])) for r in res],
               one_step_ms=1e3 * float(np.median(ref["step_s"])),
               gather_share=[r["decode"]["gather"] / sum(r["decode"]["s"])
                             for r in res],
               sum_share=[r["decode"]["reduce"] / sum(r["decode"]["s"])
                          for r in res],
               world_s=world, seconds=time.perf_counter() - t_all)
    say(f"  one process: decode-step ms (median) {out['one_step_ms']:.2f}; "
        f"world of {P} ranks {world:.1f} s, spawn included; phase 17 took "
        f"{out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 18

P18_RANKS = 4
# (r, u) of make_seq2d_mesh and the inner schedule of each training run:
# both scatter mode (llama-7b's 32 kv heads divide u)
P18_TRAIN = (((2, 2), "balanced"), ((1, 4), "ring"))
P18_TIMEOUT = 600
P18_TRANSPORT = "cuda-ipc"         # four ranks, one card
P18_SEED = 18
P18_REP_HEADS = (32, 1)            # replicate mode: 1 kv head, 1 % 2 != 0
P18_SERVE_T, P18_GEN = 16384, 8    # (c): one prompt, greedy tokens
P18_WARM_T = 1024


def _rotated(x, dim, n):
    """``x``'s n equal parts along ``dim`` concatenated rotated by one."""
    parts = x.chunk(n, dim=dim)
    return torch.cat(parts[1:] + parts[:1], dim=dim)


@contextlib.contextmanager
def _p18_fault(fault, head=None):
    """A deliberately wrong 2D plan while the block runs (phase 18's
    controls): ``"scatter"`` — the head scatter concatenates its peers'
    parts rotated by one; ``"dkv"`` — the backward's inverse all-to-all
    of dk and dv concatenates its peers' parts rotated by one;
    ``"home"`` — replicate mode's home step without the all-reduce over
    the ``head`` Comm."""
    a2a_heads, a2a_seq, bwd = sp._a2a_heads, sp._a2a_seq, sp.execute_bwd
    if fault == "scatter":
        sp._a2a_heads = lambda x, h: _rotated(a2a_heads(x, h), 1, h.size)
    elif fault == "dkv":
        n = [None]                  # inverse all-to-alls since the inner bwd

        def inner(*a, **kw):
            out = bwd(*a, **kw)
            n[0] = 0
            return out

        def seq(x, h):
            y = a2a_seq(x, h)
            if n[0] is not None:
                n[0] += 1           # dq, then dk and dv
                if n[0] > 1:
                    y = _rotated(y, 2, h.size)
                if n[0] == 3:
                    n[0] = None
            return y
        sp.execute_bwd, sp._a2a_seq = inner, seq
    else:
        head.all_reduce_ = lambda tensors, op="sum": tensors
    try:
        yield
    finally:
        sp._a2a_heads, sp._a2a_seq, sp.execute_bwd = a2a_heads, a2a_seq, bwd
        if fault == "home":
            del head.all_reduce_


@contextlib.contextmanager
def _step_grads(params, out):
    """While the block runs, the train step's gradients of every layer's
    wq, wk and wv, summed over the ranks, go into the list ``out`` (what
    ``_attn_grads`` computes, taken from the step instead of another
    forward and backward)."""
    from repro_torch.train import step as st
    want = [lp["attn"][k] for lp in params["layers"]
            for k in ("wq", "wk", "wv")]
    pos = {id(t): i for i, t in enumerate(leaves(params))}
    summed = st.sum_over

    def capture(grads, groups):
        grads = summed(grads, groups)
        out[:] = [grads[pos[id(t)]] for t in want]
        return grads
    st.sum_over = capture
    try:
        yield
    finally:
        st.sum_over = summed


def _p18_calls(plan, s, backward=False):
    """Kernel calls rank ``s`` of ``plan`` launches in one pass
    (``schedule.rank_calls``)."""
    return sum(1 for c in sp.rank_calls(plan, backward) if c[1] == s)


def _p18_auto_name():
    """``choose_inner_schedule``'s pick for phase 7's cell on (2, 2)."""
    a = get_config("llama-7b").attn
    return sp.choose_inner_schedule(
        mk.causal(), 2, 2, Tl_dev=P7_T // P18_RANKS, B=1, Hq=a.n_heads,
        Hkv=a.n_kv_heads, Dqk=a.head_dim, bpe=2, include_bwd=True)


def _p18_auto(cfg, mesh, shape, params, batch, saved):
    """(a)'s ``auto`` step on (2, 2): one train step under
    ``schedule="auto"`` from the named step's start (undone): the inner
    schedules it resolved, its loss, norm and launches."""
    model = DecoderLM(cfg, DEV, par=make_parallel_config(
        mesh, shape, schedule="auto"), mesh=mesh)
    opt = adamw.init(params)
    step = make_train_step(model, _p7_tc())
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    with _resolved() as names:
        m = step(params, opt, batch)
    torch.cuda.synchronize()
    out = dict(names=names, loss=m["loss"], gnorm=m["gnorm"],
               sec=time.perf_counter() - t0,
               launches={k: build.LAUNCHES[k] for k in BWD_KERNELS})
    with torch.no_grad():
        for t, v in zip(leaves(params), saved):
            t.copy_(v)
    del opt, step, model
    return out


def _p18_train(rank, meshes, ref):
    """(a): phase 7's model and batch on each 2D mesh of ``P18_TRAIN``:
    per-token losses, the planted controls on (2, 2), then one counted and
    timed train step from the same start, whose attention projections'
    gradients are held on rank 0 to ``ref`` (phase 7's P = 1
    gradients)."""
    cfg = get_config("llama-7b").replace(n_layers=P7_LAYERS)
    shape = ShapeSpec("chip7", P7_T, 1, "train")
    params, runs = None, {}
    for (r, u), sched in P18_TRAIN:
        mesh = meshes[(r, u)]
        par = make_parallel_config(mesh, shape, schedule=sched)
        model = DecoderLM(cfg, DEV, par=par, mesh=mesh)
        if params is None:
            params = trainable(model.init(seed=0))
        b0 = SyntheticTokens(cfg, shape, device=DEV, seed=0, mesh=mesh,
                             par=par).batch(0)
        run = dict(seq=mesh.coord("seq"), seq_rank=model.seq_rank,
                   axes=par.seq_axes, ce=_token_ce(model, params, b0).cpu())
        if (r, u) == (2, 2):
            with _p18_fault("scatter"):
                run["ce_scatter"] = _token_ce(model, params, b0).cpu()
            with _p18_fault("dkv"):
                gs = _attn_grads(model, params, b0)
            run["grad_err_dkv"] = None if ref is None else _grad_err(gs,
                                                                      ref)
            del gs
        saved = [t.detach().clone() for t in leaves(params)]
        opt = adamw.init(params)
        step = make_train_step(model, _p7_tc())
        seq_c, head_c = mesh.comm("seq"), mesh.comm("head")
        _free()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        a0, w0 = head_c.a2a_s, seq_c.shift_wait_s
        g0, r0 = head_c.gather_s, model.token_group.reduce_s
        gs = []
        t0 = time.perf_counter()
        with _step_grads(params, gs):
            m = step(params, opt, b0)
        torch.cuda.synchronize()
        run["grad_err"] = None if ref is None else _grad_err(gs, ref)
        del gs
        run.update(sec=time.perf_counter() - t0, loss=m["loss"],
                   gnorm=m["gnorm"], skipped=m["skipped_nonfinite"],
                   launches={k: build.LAUNCHES[k] for k in BWD_KERNELS},
                   a2a=head_c.a2a_s - a0, gather=head_c.gather_s - g0,
                   shift=seq_c.shift_wait_s - w0,
                   reduce=model.token_group.reduce_s - r0,
                   peak=torch.cuda.max_memory_allocated())
        with torch.no_grad():
            for t, v in zip(leaves(params), saved):
                t.copy_(v)
        del opt, step, model
        if (r, u) == (2, 2):
            _free()
            run["auto"] = _p18_auto(cfg, mesh, shape, params, b0, saved)
        del saved
        runs[f"{sched}@r{r}u{u}"] = run
    del params
    _free()
    return runs


def _p18_replicate(rank, mesh):
    """(b): the attention alone on (2, 2) under balanced, q at 32 heads ×
    128 and k/v at one kv head (replicate mode), T 32768, bf16, causal:
    this rank's slice of o, lse, dq, dk, dv against one kernel call on the
    whole inputs, and of dk, dv under the home control."""
    from repro_torch.core import dist_attention as da
    Hq, Hkv = P18_REP_HEADS
    D, T, bf = 128, P7_T, torch.bfloat16
    gen = torch.Generator(device=DEV).manual_seed(P18_SEED)
    q, do = (randn(gen, (1, T, Hq, D), bf) for _ in range(2))
    k, v = (randn(gen, (1, T, Hkv, D), bf) for _ in range(2))
    p = mesh.comm(("seq", "head")).rank
    sl = slice(p * T // P18_RANKS, (p + 1) * T // P18_RANKS)
    ql, kl, vl, dol = (x[:, sl].contiguous() for x in (q, k, v, do))
    spec = da.DistAttnSpec(axis="seq", axis_size=P18_RANKS,
                           schedule="balanced", mask=mk.causal(),
                           mesh2d=da.Mesh2DSpec(r=2, u=2))
    p2 = da._plan2d(spec, "balanced", ql, kl)
    pair = (mesh.comm("seq"), mesh.comm("head"))
    build.reset_launches()
    o, lse = da.dist_attn_fwd(ql, kl, vl, spec=spec, group=pair)
    grads = da.dist_attn_bwd(ql, kl, vl, o, lse, dol, spec=spec, group=pair)
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in BWD_KERNELS}
    with _p18_fault("home", pair[1]):
        ctl = da.dist_attn_bwd(ql, kl, vl, o, lse, dol, spec=spec,
                               group=pair)
    o1, lse1 = flash_fwd(q, k, v, mask=mk.causal())
    g1 = flash_bwd(q, k, v, o1, lse1, do, mask=mk.causal())
    torch.cuda.synchronize()
    res = dict(kv_mode=p2.kv_mode, launches=launches,
               want=(_p18_calls(p2.inner, mesh.coord("seq")),
                     _p18_calls(p2.inner, mesh.coord("seq"), True)),
               o_err=float((o.float() - o1[:, sl].float()).abs().max()),
               o_ok=torch.allclose(o.float(), o1[:, sl].float(),
                                   atol=TOL[bf], rtol=TOL[bf]),
               o_row=row_rel_err(o, o1[:, sl]), o_rel=rel_err(o, o1[:, sl]),
               lse_err=float((lse - lse1[:, sl]).abs().max()),
               lse_max=float(lse1.abs().max()), bwd={}, ctl={})
    for nm, a, b, c in zip(("dq", "dk", "dv"), grads, g1, (None,) + ctl[1:]):
        res["bwd"][nm] = _bwd_bar(a, b[:, sl], bf)
        if c is not None:
            res["ctl"][nm] = _bwd_bar(c, b[:, sl], bf)
    del q, k, v, do, o1, lse1, g1, grads, ctl, o, lse
    _free()
    return res


def _p18_serve(rank, mesh2):
    """(c): phase 8's model (llama-7b width, depth 4) serves one 16384-token
    prompt, 8 greedy tokens, through ``FixedSlotEngine`` on
    ``make_local_mesh(seq=4)`` and then on the (2, 2) mesh, teacher-forced
    on the first run's tokens; the 2D prefill's launches and the ranks'
    seconds."""
    cfg = get_config("llama-7b").replace(n_layers=P8_LAYERS)
    shape = ShapeSpec("chip18", P18_SERVE_T, 1, "decode")
    prompt = np.random.default_rng(P18_SEED).integers(
        0, cfg.vocab, (1, P18_SERVE_T)).astype(np.int32)
    mesh1 = make_local_mesh(seq=P18_RANKS, device=DEV)
    one = DecoderLM(cfg, DEV, par=make_parallel_config(
        mesh1, shape, schedule="balanced"), mesh=mesh1)
    params = one.init(seed=0)
    eng = FixedSlotEngine(one, params)
    eng.generate({"tokens": prompt[:, :P18_WARM_T]}, 2)
    with _recorded(one) as logs:
        toks1, _ = eng.generate({"tokens": prompt}, P18_GEN)
    out = dict(tokens1=toks1.cpu(), logits1=torch.stack(logs))
    par2 = make_parallel_config(mesh2, shape, schedule="balanced")
    two = DecoderLM(cfg, DEV, par=par2, mesh=mesh2)
    eng = FixedSlotEngine(two, params)
    eng.generate({"tokens": prompt[:, :P18_WARM_T]}, 2)
    seq_c, head_c = mesh2.comm("seq"), mesh2.comm("head")
    times = {}
    two.prefill = _timed(times, "prefill", two.prefill)
    two.decode = _timed(times, "decode", two.decode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    a0, w0, r0 = head_c.a2a_s, seq_c.shift_wait_s, two.decode_group.reduce_s
    with _recorded(two, toks1) as logs:
        toks2, _ = eng.generate({"tokens": prompt}, P18_GEN)
    p2 = sp.build_plan2d("balanced", mk.causal(), 2, 2,
                         P18_SERVE_T // P18_RANKS, Hq=cfg.attn.n_heads,
                         Hkv=cfg.attn.n_kv_heads)
    out.update(tokens2=toks2.cpu(), logits2=torch.stack(logs),
               launches=build.LAUNCHES["flash_fwd"],
               want=P8_LAYERS * _p18_calls(p2.inner, mesh2.coord("seq")),
               shards=two.decode_group.size, prefill_s=times["prefill"][0],
               decode_ms=[1e3 * t for t in times["decode"]],
               a2a=head_c.a2a_s - a0, shift=seq_c.shift_wait_s - w0,
               reduce=two.decode_group.reduce_s - r0,
               peak=torch.cuda.max_memory_allocated())
    del two.prefill, two.decode, eng, one, two, params
    _free()
    return out


def _p18_rank(rank, ref_path):
    """One rank of phase 18's world: (a) training, (b) replicate mode, (c)
    serving."""
    meshes = {ru: make_seq2d_mesh(*ru, device=DEV) for ru, _ in P18_TRAIN}
    ref = torch.load(ref_path, map_location=DEV) if rank == 0 else None
    out = {"rank": rank, "transport": meshes[(2, 2)].transport}
    out["train"] = _p18_train(rank, meshes, ref)
    del ref
    out["replicate"] = _p18_replicate(rank, meshes[(2, 2)])
    out["serve"] = _p18_serve(rank, meshes[(2, 2)])
    out["comm_s"] = _process_comm_seconds()
    return out


def _p18_train_gates(res, p1):
    """Phase 18 (a)'s gates: phase 7's limits against its P = 1 run, the
    controls rejected, the launches equal to the inner plans'."""
    ce1, gnorm1 = p1["ce"], p1["gnorm"]
    launches = {k: 0 for k in BWD_KERNELS}
    a = get_config("llama-7b").attn
    for (r, u), sched in P18_TRAIN:
        key = f"{sched}@r{r}u{u}"
        runs = [x["train"][key] for x in res]
        p2 = sp.build_plan2d(sched, mk.causal(), r, u, P7_T // P18_RANKS,
                             Hq=a.n_heads, Hkv=a.n_kv_heads)
        check(p2.kv_mode == "scatter", f"{key}: kv mode {p2.kv_mode}")
        ce = torch.cat([x["ce"] for x in sorted(runs, key=lambda x:
                                                x["seq_rank"])], dim=1)
        check(bool(torch.isfinite(ce).all()), f"{key}: losses not finite")
        d_tok = float((ce - ce1).abs().mean())
        d_loss = abs(float(ce.mean()) - float(ce1.mean()))
        st = runs[0]
        step1 = abs(st["loss"] - float(ce1.mean()))
        d_gnorm = abs(st["gnorm"] - gnorm1) / gnorm1
        say(f"  {key} vs P = 1: |Δloss| {d_loss:.3e} (limit {P7_LOSS_TOL}), "
            f"mean |Δce| a token {d_tok:.3e} (limit {P7_CE_TOL}); worst "
            f"‖Δg‖/‖g‖ of wq/wk/wv {st['grad_err']:.3e} (limit "
            f"{P7_GRAD_TOL}); step 1 loss {st['loss']:.6f} |Δ| {step1:.3e}, "
            f"gnorm {st['gnorm']:.4f} vs {gnorm1:.4f} relative |Δ| "
            f"{d_gnorm:.3e} (limit {P7_GNORM_TOL})")
        check(d_tok <= P7_CE_TOL and d_loss <= P7_LOSS_TOL
              and step1 <= P7_LOSS_TOL, f"{key} vs P = 1: per-token "
              f"{d_tok}, loss {d_loss}, step 1's loss {step1}")
        check(st["grad_err"] <= P7_GRAD_TOL, f"{key} gradients vs P = 1: "
              f"{st['grad_err']}")
        check(d_gnorm <= P7_GNORM_TOL, f"{key} step 1 gnorm {d_gnorm}")
        if "ce_scatter" in st:
            ctl = torch.cat([x["ce_scatter"] for x in sorted(
                runs, key=lambda x: x["seq_rank"])], dim=1)
            c_tok = float((ctl - ce1).abs().mean())
            c_loss = abs(float(ctl.mean()) - float(ce1.mean()))
            say(f"  controls on {key}: head scatter rotated by one: "
                f"|Δloss| {c_loss:.3e}, mean |Δce| a token {c_tok:.3e}; dk/dv "
                f"home all-to-all rotated by one: ‖Δg‖/‖g‖ "
                f"{st['grad_err_dkv']:.3e}")
            check(c_tok > P7_CE_TOL or c_loss > P7_LOSS_TOL, "the limits do "
                  f"not reject the rotated head scatter ({c_tok}, {c_loss})")
            check(st["grad_err_dkv"] > P7_GRAD_TOL, "the gradient limit "
                  f"does not reject the rotated dk/dv all-to-all "
                  f"({st['grad_err_dkv']})")
        losses = {x["loss"] for x in runs}
        check(len(losses) == 1, f"{key}: ranks disagree {losses}")
        if "auto" in st:
            name = _p18_auto_name()
            check(name == sched == "balanced", f"choose_inner_schedule "
                  f"picks {name} on {key}, not balanced")
            for x, rk in zip(runs, range(P18_RANKS)):
                au = x["auto"]
                check(au["names"] and set(au["names"]) == {name}
                      and au["loss"] == x["loss"]
                      and au["gnorm"] == x["gnorm"]
                      and au["launches"] == x["launches"],
                      f"{key} rank {rk}: the auto step resolved "
                      f"{set(au['names'])}, loss / gnorm {au['loss']} / "
                      f"{au['gnorm']}, launches {au['launches']} against the "
                      f"named step's {x['loss']} / {x['gnorm']}, "
                      f"{x['launches']}")
                for k in BWD_KERNELS:
                    launches[k] += au["launches"][k]
            say(f"  auto step on {key}: every rank resolved the inner "
                f"schedule {name} (choose_inner_schedule's pick; balanced "
                f"expected); loss {st['auto']['loss']:.6f} gnorm "
                f"{st['auto']['gnorm']:.4f}, bitwise the named step's; "
                f"steps " + ", ".join(f"{x['auto']['sec']:.2f}"
                                      for x in runs) + " s a rank")
        for x, rk in zip(runs, range(P18_RANKS)):
            check(x["axes"] == ("seq", "head") and x["seq_rank"] == rk,
                  f"{key}: rank {rk} shard {x['seq_rank']} over {x['axes']}")
            check(x["skipped"] == 0 and np.isfinite(x["loss"]),
                  f"{key} rank {rk}: step skipped or loss {x['loss']}")
            want = (P7_LAYERS * _p18_calls(p2.inner, x["seq"]),
                    P7_LAYERS * _p18_calls(p2.inner, x["seq"], True))
            got = x["launches"]
            check(want[0] > 0 and want[1] > 0 and got["flash_fwd"] == want[0]
                  and got["flash_bwd_dq"] == got["flash_bwd_dkv"] == want[1],
                  f"{key} rank {rk}: launches {got}, want A {want[0]}, C/D "
                  f"{want[1]}")
            for k in BWD_KERNELS:
                launches[k] += got[k]
            say(f"  {key} rank {rk}: step {x['sec']:.2f} s, host in head "
                f"all_to_alls {x['a2a']:.3f} s, blocked on seq shifts "
                f"{x['shift']:.3f} s, in all-reduces {x['reduce']:.3f} s; "
                f"peak {x['peak'] / 2**30:.2f} GiB; launches A/C/D "
                f"{got['flash_fwd']}/{got['flash_bwd_dq']}/"
                f"{got['flash_bwd_dkv']} (predicted {want[0]}/{want[1]}/"
                f"{want[1]})")
    return launches


def _p18_replicate_gates(res):
    bf = torch.bfloat16
    for x in res:
        rep = x["replicate"]
        check(rep["kv_mode"] == "replicate", f"kv mode {rep['kv_mode']}")
        # o merges the plan steps' bf16 partials, so it is held as the
        # backward is (element-wise and row by row), not element by
        # element to its own size (rel_err: reported)
        ok_l = rep["lse_err"] <= LSE_TOL * (1 + rep["lse_max"])
        check(rep["o_ok"] and rep["o_row"] <= ROW_TOL and ok_l,
              f"replicate rank {x['rank']}: o err {rep['o_err']} (row "
              f"{rep['o_row']}), lse err {rep['lse_err']}")
        for nm, (ok, err, row) in rep["bwd"].items():
            check(ok, f"replicate rank {x['rank']}: {nm} err {err}, row "
                  f"{row}")
        check(any(not ok for ok, _, _ in rep["ctl"].values()),
              f"replicate rank {x['rank']}: the bars do not reject the home "
              f"step without the all-reduce ({rep['ctl']})")
        got, (wf, wb) = rep["launches"], rep["want"]
        check(got["flash_fwd"] == wf and got["flash_bwd_dq"] == wb
              and got["flash_bwd_dkv"] == wb and wf > 0 and wb > 0,
              f"replicate rank {x['rank']}: launches {got}, want {wf}/{wb}")
        say(f"  replicate (q 32 heads, k/v 1 head, T {P7_T}) rank "
            f"{x['rank']}: max|Δo| {rep['o_err']:.3e} (row "
            f"{rep['o_row']:.3e}, element {rep['o_rel']:.3e}), max|Δlse| "
            f"{rep['lse_err']:.3e}; "
            + ", ".join(f"{nm} max|Δ| {e:.3e} row {r:.3e}"
                        for nm, (_, e, r) in rep["bwd"].items())
            + " (limits " + f"{BWD_TOL[bf]}, row {ROW_TOL}); control without "
            "the all-reduce: " + ", ".join(
                f"{nm} max|Δ| {e:.3e} row {r:.3e}"
                for nm, (_, e, r) in rep["ctl"].items())
            + f"; launches A/C/D {got['flash_fwd']}/{got['flash_bwd_dq']}/"
            f"{got['flash_bwd_dkv']} (predicted {wf}/{wb}/{wb})")


def _p18_serve_gates(res):
    sv = [x["serve"] for x in res]
    t1, l1 = sv[0]["tokens1"], sv[0]["logits1"]
    for x, s in zip(res, sv):
        check(s["shards"] == P18_RANKS, f"rank {x['rank']}: cache over "
              f"{s['shards']} shards")
        check(torch.equal(s["tokens1"], t1) and torch.equal(s["tokens2"],
                                                            sv[0]["tokens2"]),
              f"rank {x['rank']} emitted other tokens")
        check(s["launches"] == s["want"] > 0, f"rank {x['rank']}: kernel A "
              f"launched {s['launches']} times in the 2D run, want "
              f"{s['want']}")
    l2, t2 = sv[0]["logits2"], sv[0]["tokens2"]
    check(l1.shape == l2.shape, f"steps {l1.shape} {l2.shape}")
    err = _step_err(l2, l1)
    # reported, not gated: each step's top-two gap of the (seq) run and
    # the step's max |Δ| between the runs
    top2 = l1.float().topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).amin(dim=-1)
    moved = [float((a - b).abs().max()) for a, b in zip(l2, l1)]
    same = [i for i in range(t1.shape[1]) if torch.equal(t1[:, i], t2[:, i])]
    say(f"  serving (2, 2) vs (seq=4), teacher-forced: worst step max|Δ| / "
        f"max|logit| {err:.3e} (limit {P8_LOGIT_TOL}) over {l1.shape[0]} "
        f"steps; tokens equal at {len(same)} of {t1.shape[1]} steps "
        f"{t1[0].tolist()}; top-two gap / max|Δ| a step "
        + ", ".join(f"{float(g) / max(m, 1e-30):.2f}"
                    for g, m in zip(gaps[:t1.shape[1]], moved)))
    check(err <= P8_LOGIT_TOL, f"2D serving logits {err}")
    check(len(same) == t1.shape[1],
          f"2D tokens {t2[0].tolist()} vs {t1[0].tolist()}")
    for x, s in zip(res, sv):
        dm = s["decode_ms"]
        say(f"  serving (2, 2) rank {x['rank']}: prefill {s['prefill_s']:.3f}"
            f" s ({P18_SERVE_T // P18_RANKS} tokens, A {s['launches']} "
            f"launches, predicted {s['want']}), decode {np.median(dm):.2f} ms "
            f"a step (median of {len(dm)}), host in head all_to_alls "
            f"{s['a2a']:.3f} s, blocked on seq shifts {s['shift']:.3f} s, "
            f"in all-reduces {s['reduce']:.3f} s, peak "
            f"{s['peak'] / 2**30:.2f} GiB")
    return sum(s["launches"] for s in sv)


def seq2d(p1):
    """Phase 18: the 2D sequence × head plans on a gloo world of 4 ranks
    sharing the one card: (a) phase 7's training on (2, 2) and (1, 4),
    held to phase 7's P = 1 run ``p1``; (b) replicate mode; (c)
    ``FixedSlotEngine`` on (2, 2) against the same world's (seq = 4)."""
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "grads1.pt")
        torch.save(p1["grads"], ref_path)
        t0 = time.perf_counter()
        res = spawn(_p18_rank, P18_RANKS, (ref_path,), device=DEV,
                    timeout=P18_TIMEOUT, threads=2)
        wall = time.perf_counter() - t0
    res.sort(key=lambda r: r["rank"])
    _say_comm(18, res)
    check(all(r["transport"] == P18_TRANSPORT for r in res),
          f"transport {[r['transport'] for r in res]}")
    launches = _p18_train_gates(res, p1)
    _p18_replicate_gates(res)
    launches["flash_fwd"] += _p18_serve_gates(res)
    say(f"  world of {P18_RANKS} ranks: {wall:.1f} s, spawn included")
    return dict(launches=launches)


# ---------------------------------------------------------------- phase 19

P19_SEED, P19_RANKS, P19_RU = 19, 4, (2, 2)
# (a): the dense layer 0 and one MoE layer: a third layer adds 277 M
# expert parameters a rank with their moments, and phase 15's headroom is
# thin
P19_LAYERS, P19_T, P19_STEPS = 2, 8192, 2
# slots an expert takes from a seq shard: its 4,096 rows (gathered over
# head) · 6 · 1.25 / 64, as phase 15's ranks
P19_CAP = 480
# (b): phase 17's cut, 9 of 27 layers; one prompt, greedy tokens
P19_SERVE_LAYERS, P19_SERVE_T, P19_NEW = 9, 8192, 8
P19_CTL_GEN = 4                 # decode steps of the decode fault's run
P19_WARM_T = 256
P19_TIMEOUT = 900
P19_TRANSPORT = "cuda-ipc"         # four ranks, one card


def _p19_tc():
    return TrainConfig(lr=1e-4, warmup_steps=1, total_steps=P19_STEPS)


@contextlib.contextmanager
def _p19_fault(model, fault):
    """Phase 19's planted faults on a 2D-mesh model while the block runs:
    ``"aux"`` — the aux loss's statistics reduced over ``head`` as well
    (the world); ``"scatter"`` — the head scatter rotated by one
    (``_p18_fault``); ``"rows"`` — each head rank dispatching only its
    own T/(r·u) rows (no gather over ``head``)."""
    if fault == "scatter":
        with _p18_fault("scatter"):
            yield
        return
    key, val = {"aux": ("moe_token_group", model.token_group),
                "rows": ("moe_rows", None)}[fault]
    saved = getattr(model, key)
    setattr(model, key, val)
    try:
        yield
    finally:
        setattr(model, key, saved)


def _p19_head_sums(model, params, raw, times):
    """``sum_grads`` of a copy of ``raw`` with the expert shards summed over
    ``head`` ``times`` times (the right sum is once)."""
    grads = [g.clone() for g in raw]
    sharded = TF.expert_mask(params)
    model.token_group.all_reduce_([g for g, s in zip(grads, sharded)
                                   if not s])
    for _ in range(times):
        model.expert_grad_group.all_reduce_(
            [g for g, s in zip(grads, sharded) if s])
    return grads, sharded


def _p19_train(rank, mesh, tmp):
    """(a) on this rank: step 1's loss, aux and gradients replaying P = 1's
    expert choices (held to P = 1's), the planted faults, then
    ``P19_STEPS`` counted and timed train steps (replaying P = 1's
    choices)."""
    cfg = get_config(P12_ARCH).replace(n_layers=P19_LAYERS)
    shape = ShapeSpec("chip19", P19_T, 1, "train")
    par = make_parallel_config(mesh, shape, schedule="balanced")
    model = DecoderLM(cfg, DEV, mesh=mesh, par=par)
    data = SyntheticTokens(cfg, shape, device=DEV, seed=0, mesh=mesh,
                           par=par)
    params = trainable(model.init(seed=P19_SEED))
    s, r = mesh.coord("seq"), P19_RU[0]
    n = P19_T // r                   # a seq shard's MoE rows
    rec = torch.load(os.path.join(tmp, "calls.pt"))
    calls = [c[s * n:(s + 1) * n].to(DEV) for c in rec["calls"]]
    n_moe = cfg.n_layers - cfg.moe.n_dense_layers
    out = {"seq": s, "seq_rank": model.seq_rank,
           "groups": (model.expert_group.size, model.moe_rows.size,
                      model.expert_grad_group.size,
                      model.moe_token_group.size),
           "expert_rows": tuple(params["moe_layers"][0]["moe"]["wg"].shape)}
    rep = torch.load(os.path.join(tmp, "grads1.pt"))
    ref = [x if rank == 0 else None for x in rep]
    for i, x in enumerate(torch.load(os.path.join(tmp, f"grads1_r{s}.pt"))):
        if x is not None:
            ref[i] = x
    del rep
    names = _leaf_names(params)
    b0 = data.batch(0)
    first, raw, kept = _p15_grads(model, params, b0, calls[:2 * n_moe])
    out["first"] = first
    out["kept_same"] = all(torch.equal(k.cpu(), x.view(r, -1)[s])
                           for k, x in zip(kept, rec["keep"][:2 * n_moe]))
    grads, sharded = _p15_summed(model, params, raw)
    out["grad_err"] = _p15_grad_err(model, grads, sharded, ref, names)
    out["gnorm1"] = float(adamw.global_norm(
        grads, norm_groups(model, params)))
    del grads
    ref_aux = [g.to(DEV) for g in torch.load(os.path.join(tmp,
                                                          "aux_router.pt"))]

    def aux_err(ga):
        return max(float((g - r).abs().max() / r.abs().max())
                   for g, r in zip(ga, ref_aux))
    aux_calls = calls[2 * n_moe:4 * n_moe]
    out["aux_err"] = aux_err(_aux_router(model, params, b0, aux_calls))
    out["faults"] = {}
    for name, times in (("head_none", 0), ("head_twice", 2)):
        grads, sharded = _p19_head_sums(model, params, raw, times)
        out["faults"][name] = dict(first=first, grad_err=_p15_grad_err(
            model, grads, sharded, ref, names))
        del grads
    del raw
    for fault in ("aux", "scatter"):
        with _p19_fault(model, fault):
            f, raw, _ = _p15_grads(model, params, b0, calls[:2 * n_moe])
            ae = aux_err(_aux_router(model, params, b0, aux_calls))
        grads, sharded = _p15_summed(model, params, raw)
        out["faults"][fault] = dict(first=f, grad_err=_p15_grad_err(
            model, grads, sharded, ref, names), aux_err=ae)
        del grads, raw
        _free()
    del ref, ref_aux
    comms = list({id(c): c for c in (
        mesh.comm("seq"), mesh.comm("head"), model.token_group,
        model.moe_token_group, model.expert_grad_group)}.values())
    opt = adamw.init(params)
    step = make_train_step(model, _p19_tc())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(P19_STEPS):
        batch = data.batch(i)
        replay = _Router(calls=calls[(4 + 2 * i) * n_moe:
                                     (6 + 2 * i) * n_moe])
        torch.cuda.synchronize()
        build.reset_launches()
        c0 = _comm_seconds(comms)
        t0 = time.perf_counter()
        with replay:
            m = step(params, opt, batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        c1 = _comm_seconds(comms)
        steps.append(dict(
            loss=m["loss"], ce=m["ce"], aux=m["aux"], gnorm=m["gnorm"],
            sec=sec, skipped=m["skipped_nonfinite"],
            comm={k: c1[k] - c0[k] for k in c1},
            launches={k: build.LAUNCHES[k] for k in P14_KERNELS}))
    out["steps"] = steps
    out["peak"] = torch.cuda.max_memory_allocated()
    del params, opt, step, model
    _free()
    return out


def _p19_serve(rank, mesh, tmp):
    """(b) on this rank: deepseek at full width, 9 of 27 layers, through
    ``FixedSlotEngine`` on the (2, 2) mesh — a warm-up, then one 8,192-token
    prompt (balanced 2D prefill under the head scatter, the latent cache
    over the (seq, head) pair, 8 greedy tokens), recording every MoE
    call's expert choices and kept pairs; the planted controls
    teacher-forced on its tokens; (c) the latent ring's refusal."""
    cfg = get_config(P12_ARCH).replace(n_layers=P19_SERVE_LAYERS)
    shape = ShapeSpec("chip19s", P19_SERVE_T, 1, "decode")
    par = make_parallel_config(mesh, shape, schedule="balanced")
    model = DecoderLM(cfg, DEV, par=par, mesh=mesh)
    params = model.init(seed=P19_SEED)
    prompt = np.random.default_rng(P19_SEED).integers(
        0, cfg.vocab, (1, P19_SERVE_T)).astype(np.int32)
    eng = FixedSlotEngine(model, params)
    eng.generate({"tokens": prompt[:, :P19_WARM_T]}, 2)
    comms = list({id(c): c for c in (
        mesh.comm("seq"), mesh.comm("head"), model.decode_group,
        model.seq_group)}.values())
    times = {}
    model.prefill = _timed(times, "prefill", model.prefill)
    model.decode = _timed(times, "decode", model.decode)
    _free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = _comm_seconds(comms)
    build.reset_launches()
    rk = _Router()
    with rk, _Keep() as kp, _recorded(model) as logs:
        toks, _ = eng.generate({"tokens": prompt}, P19_NEW)
    launches = dict(build.LAUNCHES)
    c1 = _comm_seconds(comms)
    out = dict(tokens=toks.cpu(), logits=torch.stack(logs),
               launches=launches, prefill_s=times["prefill"][0],
               decode_ms=[1e3 * t for t in times["decode"]],
               comm={k: c1[k] - c0[k] for k in c1},
               shards=model.decode_group.size,
               rows=[int(k.shape[0]) // cfg.moe.top_k for k in kp.seen],
               peak=torch.cuda.max_memory_allocated())
    del model.prefill, model.decode
    if mesh.coord("head") == 0:
        torch.save({"calls": [c.cpu() for c in rk.seen],
                    "keep": [k.cpu() for k in kp.seen]},
                   os.path.join(tmp, f"serve{mesh.coord('seq')}.pt"))
    out["controls"] = {}
    with _moe_fault("psum"), _recorded(model, toks[:, :P19_CTL_GEN]) as lg:
        eng.generate({"tokens": prompt}, P19_CTL_GEN)
    out["controls"]["psum"] = torch.stack(lg)
    with _p19_fault(model, "rows"), _Keep() as kp2, \
            _recorded(model, toks[:, :1]) as lg:
        eng.generate({"tokens": prompt}, 1)
    out["controls"]["rows"] = torch.stack(lg)
    out["rows_ctl"] = [int(k.shape[0]) // cfg.moe.top_k for k in kp2.seen]
    del eng
    zz = make_parallel_config(mesh, shape, schedule="zigzag")
    try:
        DecoderLM(cfg, DEV, par=zz, mesh=mesh, latent_ring=True)
        out["ring"] = "no error"
    except ValueError as e:
        out["ring"] = f"ValueError: {e}"
    del model, params
    _free()
    return out


def _p19_rank(rank, tmp):
    mesh = make_seq2d_mesh(*P19_RU, device=DEV)
    out = {"rank": rank, "transport": mesh.transport}
    out["train"] = _p19_train(rank, mesh, tmp)
    out["serve"] = _p19_serve(rank, mesh, tmp)
    out["comm_s"] = _process_comm_seconds()
    return out


def _p19_train_gates(cfg, res, first, s1, s2):
    """(a)'s gates against P = 1 (phase 15's bars), the planted faults
    rejected, the pair routes' launches equal to the inner plan's."""
    t0 = res[0]["train"]

    def rel(a, b):
        return abs(a - b) / abs(b)
    for x in res:
        tr = x["train"]
        check(tr["groups"] == (2, 2, 2, 2), f"rank {x['rank']}: experts / "
              f"rows / expert gradients / aux over {tr['groups']} ranks")
        check(tr["expert_rows"][0] == cfg.moe.n_routed // P19_RU[0],
              f"rank {x['rank']}: expert leaves {tr['expert_rows']}")
        check(tr["kept_same"], f"rank {x['rank']} kept other pairs than "
              "P = 1 kept of its seq shard's rows")
    d_loss, d_aux = rel(t0["first"][0], first[0]), rel(t0["first"][2],
                                                        first[2])
    err, leaf = t0["grad_err"]
    st = t0["steps"]
    d_gn, d_l2 = rel(st[0]["gnorm"], s1["gnorm"]), rel(st[1]["loss"],
                                                       s2["loss"])
    aux_e = max(x["train"]["aux_err"] for x in res)
    say(f"  (a) (2, 2) vs P = 1, step 1: loss {t0['first'][0]:.6f} relative "
        f"|Δ| {d_loss:.3e}, aux {t0['first'][2]:.6e} relative |Δ| "
        f"{d_aux:.3e} (limit {P15_TOL:.3e}); worst gradient leaf max|Δg| / "
        f"max|g| {err:.4f} ({leaf}; limit {GRAD_REL_TOL}), of the aux "
        f"loss's router gradients alone {aux_e:.4f}; gnorm "
        f"{st[0]['gnorm']:.4f} vs {s1['gnorm']:.4f} relative |Δ| "
        f"{d_gn:.3e}; step 2 loss {st[1]['loss']:.6f} vs {s2['loss']:.6f} "
        f"relative |Δ| {d_l2:.3e} (limits {P15_TOL:.3e})")
    check(d_loss <= P15_TOL and d_aux <= P15_TOL, f"(a) step 1 loss "
          f"{d_loss} / aux {d_aux} vs P = 1")
    check(err <= GRAD_REL_TOL, f"(a) gradients vs P = 1: {leaf} {err}")
    check(aux_e <= GRAD_REL_TOL, f"(a) the aux loss's router gradients vs "
          f"P = 1: {aux_e}")
    check(d_gn <= P15_TOL and d_l2 <= P15_TOL, f"(a) step 1 gnorm {d_gn}, "
          f"step 2 loss {d_l2} vs P = 1")
    ctl = {f: dict(loss=rel(v["first"][0], first[0]), grad=v["grad_err"][0],
                   leaf=v["grad_err"][1],
                   aux=max(x["train"]["faults"][f].get("aux_err", 0.0)
                           for x in res))
           for f, v in t0["faults"].items()}
    say("  (a) controls (step 1 relative |Δloss| / worst leaf |Δg| / the "
        "aux loss's router gradients): " + "; ".join(
            f"{f} {c['loss']:.3e} / {c['grad']:.4f} ({c['leaf']}) / "
            f"{c['aux']:.4f}" for f, c in ctl.items()))
    for f, c in ctl.items():
        check(c["loss"] > P15_TOL or c["grad"] > GRAD_REL_TOL
              or c["aux"] > GRAD_REL_TOL, f"(a) the bars do not reject the "
              f"{f} fault ({c})")
    a = cfg.attn
    p2 = sp.build_plan2d("balanced", mk.causal(), *P19_RU,
                         P19_T // P19_RANKS, Hq=a.n_heads, Hkv=a.n_heads)
    launches = {k: 0 for k in P14_KERNELS}
    for x in res:
        tr = x["train"]
        want = (cfg.n_layers * _p18_calls(p2.inner, tr["seq"]),
                cfg.n_layers * _p18_calls(p2.inner, tr["seq"], True))
        for i, s in enumerate(tr["steps"]):
            got = s["launches"]
            check(s["skipped"] == 0 and np.isfinite(s["loss"]),
                  f"(a) rank {x['rank']} step {i + 1}: {s}")
            check(want[0] > 0 and got["flash_fwd_pair"] == want[0]
                  and got["flash_bwd_dq"] == got["flash_bwd_dkv"] == want[1],
                  f"(a) rank {x['rank']} step {i + 1}: launches {got}, want "
                  f"A {want[0]}, C/D {want[1]}")
            for k in P14_KERNELS:
                launches[k] += got[k]
        say(f"  (a) rank {x['rank']}: peak {tr['peak'] / 2**30:.2f} GiB; "
            f"steps " + ", ".join(f"{s['sec']:.3f}" for s in tr["steps"])
            + " s; host in shifts / all_to_alls / all-reduces and gathers "
            + ", ".join("/".join(f"{s['comm'][k]:.3f}" for k in
                                 ("shift", "a2a", "reduce"))
                        for s in tr["steps"])
            + f" s; launches A/C/D a step {want[0]}/{want[1]}/{want[1]} "
            f"(rank_calls of the inner plan × {cfg.n_layers} layers)")
    for i in range(P19_STEPS):
        vals = {(x["train"]["steps"][i]["loss"],
                 x["train"]["steps"][i]["gnorm"]) for x in res}
        check(len(vals) == 1, f"(a) step {i + 1}: ranks disagree {vals}")
    return launches, dict(d_loss=d_loss, d_aux=d_aux, grad_err=err,
                          aux_err=aux_e,
                          d_gnorm=d_gn, d_loss2=d_l2, controls=ctl,
                          step_s=[max(x["train"]["steps"][i]["sec"]
                                      for x in res)
                                  for i in range(P19_STEPS)])


def _p19_serve_gates(cfg, res, tmp):
    """(b)'s gates: equal tokens on every rank, the 2D prefill's launches,
    every MoE dispatch over a seq shard's rows; then one process replays
    the ranks' expert choices and kept pairs teacher-forced on their
    tokens: every step's logits within 5% of max |logit|, the controls
    rejected; (c) the latent ring's refusal printed."""
    sv = [x["serve"] for x in res]
    toks = sv[0]["tokens"]
    n_moe = cfg.n_layers - cfg.moe.n_dense_layers
    a = cfg.attn
    p2 = sp.build_plan2d("balanced", mk.causal(), *P19_RU,
                         P19_SERVE_T // P19_RANKS, Hq=a.n_heads,
                         Hkv=a.n_heads)
    check(tuple(toks.shape) == (1, P19_NEW) and bool(
        ((toks >= 0) & (toks < cfg.vocab)).all()), f"(b) tokens {toks}")
    rows = P19_SERVE_T // P19_RU[0]
    for x, s in zip(res, sv):
        tr = x["train"]
        check(torch.equal(s["tokens"], toks), f"(b) rank {x['rank']}'s "
              "tokens differ")
        check(s["shards"] == P19_RANKS, f"(b) cache over {s['shards']}")
        w = cfg.n_layers * _p18_calls(p2.inner, tr["seq"])
        check(s["launches"]["flash_fwd_pair"] == w and all(
            v == 0 for k, v in s["launches"].items()
            if k != "flash_fwd_pair"), f"(b) rank {x['rank']}: launches "
            f"{s['launches']}, want flash_fwd_pair {w} and nothing else")
        check(s["rows"][:n_moe] == [rows] * n_moe, f"(b) rank {x['rank']}: "
              f"the prefill dispatched {s['rows'][:n_moe]} rows a layer")
        check(bool(torch.isfinite(s["logits"]).all()), "(b) non-finite")
    recs = [torch.load(os.path.join(tmp, f"serve{i}.pt"))
            for i in range(P19_RU[0])]
    calls = [torch.cat([rec["calls"][i] for rec in recs]) for i in
             range(n_moe)] + recs[0]["calls"][n_moe:]
    keep = [torch.cat([rec["keep"][i] for rec in recs])
            for i in range(n_moe)]
    check(all(len(rec["keep"]) == n_moe for rec in recs),
          "(b) a decode step dispatched")
    del recs
    t0 = time.perf_counter()
    one = DecoderLM(cfg, DEV)
    params = one.init(seed=P19_SEED)
    prompt = np.random.default_rng(P19_SEED).integers(
        0, cfg.vocab, (1, P19_SERVE_T)).astype(np.int32)
    rr = _Router(calls=[c.to(DEV) for c in calls])
    with rr, _Keep(calls=keep), _recorded(one, toks) as lg:
        FixedSlotEngine(one, params).generate({"tokens": prompt}, P19_NEW)
    ref = torch.stack(lg)
    check(len(rr.seen) == len(calls) and all(
        torch.equal(x.cpu(), y) for x, y in zip(rr.seen, calls)),
        "(b) the one process did not replay every expert choice")
    del one, params
    _free()
    err = max(_step_err(s["logits"], ref) for s in sv)
    ctl = {"psum": _step_err(sv[0]["controls"]["psum"][1:],
                             ref[1:P19_CTL_GEN + 1]),
           "rows": _step_err(sv[0]["controls"]["rows"], ref[:1])}
    own = P19_SERVE_T // P19_RANKS
    rows_ctl = sv[0]["rows_ctl"][:n_moe]
    say(f"  (b) one process replaying the ranks' experts and kept pairs "
        f"({time.perf_counter() - t0:.1f} s): teacher-forced logits, worst "
        f"step max|Δ| / max|logit| over {P19_NEW + 1} steps (limit "
        f"{LOGIT_REL_TOL}): {err:.3e}; controls: decode without the "
        f"experts' sum over seq {ctl['psum']:.3e}; each head rank "
        f"dispatching only its own {own} rows: prefill logits "
        f"{ctl['rows']:.3e}, dispatches of {sorted(set(rows_ctl))} rows "
        f"(a seq shard holds {rows})")
    check(err <= LOGIT_REL_TOL, f"(b) (2, 2) fixed-slot logits vs one "
          f"process: {err}")
    check(ctl["psum"] > LOGIT_REL_TOL, f"(b) the logit limit does not "
          f"reject the decode without its seq sum ({ctl['psum']})")
    check(ctl["rows"] > LOGIT_REL_TOL or rows_ctl != [rows] * n_moe,
          f"(b) neither the logits nor the dispatch's rows reject the "
          f"head ranks' own-rows dispatch ({ctl['rows']}, {rows_ctl})")
    for x, s in zip(res, sv):
        dc = s["decode_ms"]
        say(f"  (b) rank {x['rank']}: peak {s['peak'] / 2**30:.2f} GiB; "
            f"prefill {s['prefill_s']:.3f} s, decode "
            f"{float(np.median(dc)):.2f} ms a step (median); host in "
            "shifts / all_to_alls / all-reduces and gathers "
            + "/".join(f"{s['comm'][k]:.3f}" for k in ("shift", "a2a",
                                                       "reduce"))
            + f" s; launches {s['launches']}")
    msgs = {s["ring"] for s in sv}
    say(f"  (c) the latent ring on (2, 2): {msgs.pop()}")
    check(not msgs and all(s["ring"].startswith("ValueError: the latent "
                                                "ring on a 2D mesh")
                           and "fault 3.7" in s["ring"] for s in sv),
          f"(c) the latent ring on (2, 2): {[s['ring'] for s in sv]}")
    return sum(s["launches"]["flash_fwd_pair"] for s in sv), dict(
        err=err, controls=ctl,
        prefill_s=max(s["prefill_s"] for s in sv),
        decode_ms=[float(np.median(s["decode_ms"])) for s in sv])


def moe2d():
    """Phase 19: deepseek-v2-lite-16b (MLA + MoE) on a 2D (seq = 2) ×
    (head = 2) mesh of 4 ranks sharing the one card — the routed experts
    32 a rank over ``seq`` (the same on the two head ranks), each head
    rank gathering its seq shard's 4,096 MoE rows over ``head``, the aux
    statistics over ``seq``, MLA materialised through A / C / D's pair
    routes under the head scatter.  (a) trains 2 of 27 layers at full
    width, 8,192 tokens a step, 2 balanced steps, against one process that
    the ranks replay (its expert choices; its kept pairs are the ranks'),
    with four planted faults; (b) serves 9 of 27 layers through
    ``FixedSlotEngine`` (one 8,192-token prompt, 8 greedy tokens) against
    one process replaying the ranks' choices and kept pairs, with two
    controls; (c) prints the latent ring's refusal (fault 3.7)."""
    t_all = time.perf_counter()
    cfg = get_config(P12_ARCH).replace(n_layers=P19_LAYERS)
    scfg = get_config(P12_ARCH).replace(n_layers=P19_SERVE_LAYERS)
    shape = ShapeSpec("chip19", P19_T, 1, "train")
    from repro_torch.models.moe import capacity
    check(capacity(cfg, P19_T // P19_RU[0]) == P19_CAP,
          f"capacity {capacity(cfg, P19_T // P19_RU[0])}, want {P19_CAP}")
    say(f"  (a) {cfg.name} at full width, {cfg.n_layers} of 27 layers, "
        f"{P19_T} tokens a step on (seq, head) = {P19_RU}: "
        f"{cfg.moe.n_routed // P19_RU[0]} routed experts a rank, "
        f"{P19_T // P19_RU[0]} MoE rows a seq shard, capacity {P19_CAP}; "
        f"(b) {P19_SERVE_LAYERS} of 27 layers, a {P19_SERVE_T}-token "
        f"prompt, {P19_NEW} greedy tokens")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        first, s1, s2, peak1, _ = _p15_one(cfg, shape, tmp, split=P19_RU[0],
                                           cap=P19_CAP, seed=P19_SEED,
                                           tc=_p19_tc(), aux_router=True)
        say(f"  (a) P = 1 ({time.perf_counter() - t0:.1f} s, peak "
            f"{peak1 / 2**30:.2f} GiB): step 1 loss {first[0]:.6f} aux "
            f"{first[2]:.6e}; train step 1 gnorm {s1['gnorm']:.4f}, step 2 "
            f"loss {s2['loss']:.6f}")
        _free()
        t0 = time.perf_counter()
        res = spawn(_p19_rank, P19_RANKS, (tmp,), device=DEV,
                    timeout=P19_TIMEOUT, threads=2)
        wall = time.perf_counter() - t0
        res.sort(key=lambda r: r["rank"])
        _say_comm(19, res)
        check(all(r["transport"] == P19_TRANSPORT for r in res),
              f"transport {[r['transport'] for r in res]}")
        say(f"  world of {P19_RANKS} ranks: {wall:.1f} s, spawn included")
        launches, tr = _p19_train_gates(cfg, res, first, s1, s2)
        a_serve, sv = _p19_serve_gates(scfg, res, tmp)
    launches["flash_fwd_pair"] += a_serve
    out = dict(launches=launches, train=tr, serve=sv, world_s=wall,
               seconds=time.perf_counter() - t_all)
    say(f"  phase 19 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 20

P20_SEED, P20_RANKS, P20_RU = 20, 4, (2, 2)
# (name, arch, depth, pool sharding over seq, step of a corrupt_block fault
# or None): (a) qwen3-8b's width at phase 11 (a)'s cut, its 8 kv heads 4 a
# seq rank; (b) deepseek at phase 17's cut, its latent pool 96 of 192
# blocks a seq rank, the corrupted block at phase 17's step
P20_CASES = (("a", "qwen3-8b", 8, "heads", None),
             ("b", P12_ARCH, P17_LAYERS, "blocks", P17_CORRUPT))
# tokens a request in the one-replica fault's run: its decode must still
# run at the corrupted block's step
P20_CTL_NEW = 16
P20_TIMEOUT = 900


def _p20_model(arch, depth, mesh):
    """A phase 20 model at full width, ``depth`` layers, seed 20 (the Qwen
    features off their init values, :func:`_perturb`)."""
    cfg = get_config(arch).replace(n_layers=depth)
    par = None if mesh is None else make_parallel_config(
        mesh, ShapeSpec("chip20", 1024, P4_ENGINE["max_batch"], "prefill"))
    model = DecoderLM(cfg, DEV, par=par, mesh=mesh)
    params = model.init(seed=P20_SEED)
    if cfg.moe is None:
        _perturb(params, P20_SEED)
    return model, params


def _digest(cache):
    """A sha256 of each local block's bytes in every layer of each pool
    (what two head replicas compare), with the local index of the null
    block where this rank holds it: padded chunk rows and idle decode rows
    all write there, to the same slots, and on the card a scatter with
    repeated indices keeps any one of the rows."""
    import hashlib
    out = {}
    for k, p in sorted(cache.pools.items()):
        x = p.detach().contiguous().view(torch.uint8).cpu().numpy()
        out[k] = [hashlib.sha256(x[:, n].tobytes()).hexdigest()
                  for n in range(x.shape[1])]
    held = cache.sharding != "blocks" or cache.group.rank == 0
    return dict(blocks=out, null=0 if held else None)


@contextlib.contextmanager
def _one_replica_fault(mesh):
    """Phase 20's replica control: ``corrupt_block`` poisons the owner's
    block on head replica 0 only."""
    base = PagedKVCache.corrupt_block

    def corrupt(self, b):
        if mesh.coord("head") == 0:
            base(self, b)
    PagedKVCache.corrupt_block = corrupt
    try:
        yield
    finally:
        PagedKVCache.corrupt_block = base


@contextlib.contextmanager
def _own_rows_fault():
    """Phase 20's dispatch control: each head rank dispatches only its own
    C/(r·u) of a chunk's rows (split over the (seq, head) pair, not over
    the seq axis), all-gathered back over the pair."""
    from repro_torch.models.moe import moe_apply
    base = DecoderLM._split_moe

    def own(self, p, h):
        g, n = self.seq_group, h.shape[1] // self.seq_group.size
        y = moe_apply(p, h[:, g.rank * n:(g.rank + 1) * n], self.cfg,
                      group=self.expert_group)[0]
        return g.all_gather(y.contiguous(), dim=1)
    DecoderLM._split_moe = own
    try:
        yield
    finally:
        DecoderLM._split_moe = base


def _p20_case(rank, mesh, case, tmp):
    """One case of phase 20 on this rank: a warm-up, then phase 11's run
    (a fork; (b): a corrupted block), recording each decode's seconds and
    its host seconds in pool gathers and MoE sums, the pools' digests, on
    rank 0 one chunk's A call and one decode's B call held to their plain
    versions, and for (b) every MoE dispatch's choices and kept pairs
    (saved by head rank 0 of each seq shard) and its rows; then (b)'s two
    controls."""
    _, arch, depth, _, corrupt = case
    model, params = _p20_model(arch, depth, mesh)
    cfg = model.cfg
    moe = cfg.moe is not None
    grp = mesh.comm("seq")
    warm = Engine(model, params, **P4_ENGINE)
    warm.submit(_p11_prompts(cfg.vocab)[3], max_new_tokens=2)
    warm.run()
    del warm
    dec = dict(s=[], gather=0.0, reduce=0.0)
    decode = model.decode

    def timed(*a):
        torch.cuda.synchronize()
        t0, g0, r0 = time.perf_counter(), grp.gather_s, grp.reduce_s
        logits = decode(*a)
        torch.cuda.synchronize()
        dec["s"].append(time.perf_counter() - t0)
        dec["gather"] += grp.gather_s - g0
        dec["reduce"] += grp.reduce_s - r0
        return logits
    model.decode = timed
    _free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    rk, kp = (_Router(), _Keep()) if moe else (None, None)
    t0 = time.perf_counter()
    with (rk or contextlib.nullcontext()), (kp or contextlib.nullcontext()), \
            (_captured() if rank == 0 else contextlib.nullcontext({})) as got:
        r = _p11_run(model, params, corrupt, router=rk)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    del model.decode
    rows = _host_rows(r["rec"])
    cache = r["eng"].cache
    out = dict(
        sharding=cache.sharding, group=cache.group.size,
        local=tuple(next(iter(cache.pools.values())).shape),
        out=r["out"], log=r["log"], states=r["states"],
        forks=r["st"]["forks"], quarantined=r["st"]["quarantined"],
        sums=_sums(rows), rows=rows if rank == 0 else None,
        launches=launches, wall=wall,
        step_ms=[1e3 * t for t in r["step_s"]], decode=dec,
        peak=torch.cuda.max_memory_allocated(), digest=_digest(cache),
        held=_held(got, 20) if rank == 0 else None,
        n_params=sum(t.numel() for t in leaves(params)),
        prompts=r["prompts"] if rank == 0 else None)
    if moe:
        out["dispatch"] = [int(k.shape[0]) // cfg.moe.top_k
                           for k in kp.seen]
        if mesh.coord("head") == 0:
            torch.save({"calls": [c.cpu() for c in rk.seen],
                        "valid": rk.valid,
                        "keep": [k.cpu() for k in kp.seen]},
                       os.path.join(tmp, f"p20_seq{mesh.coord('seq')}.pt"))
    del r, rk, kp, got, cache
    _free()
    out["controls"] = {}
    if moe:
        with _one_replica_fault(mesh):
            bad = _p11_run(model, params, corrupt, n_new=P20_CTL_NEW)
        out["controls"]["replica"] = dict(
            digest=_digest(bad["eng"].cache), log=bad["log"],
            out=bad["out"])
        del bad
        with _own_rows_fault(), _Keep() as kp2:
            bad = _p11_run(model, params, None, n_new=P17_CTL_NEW)
        out["controls"]["rows"] = dict(
            dispatch=[int(k.shape[0]) // cfg.moe.top_k for k in kp2.seen],
            out=bad["out"],
            rows=_host_rows(bad["rec"]) if rank == 0 else None)
        del bad, kp2
    del model, params
    _free()
    return out


def _p20_rank(rank, tmp):
    mesh = make_seq2d_mesh(*P20_RU, device=DEV)
    out = {"rank": rank, "transport": mesh.transport,
           "coords": (mesh.coord("seq"), mesh.coord("head"))}
    for case in P20_CASES:
        out[case[0]] = _p20_case(rank, mesh, case, tmp)
    out["comm_s"] = _process_comm_seconds()
    return out


def _replicas_equal(res, name, key=None):
    """Whether each seq shard's two head replicas hold bitwise-equal pools
    past the null block (:func:`_digest`; ``key``: a control's run), the
    (seq shard, pool, local block)s that differ, and whether the two seq
    shards hold other parts."""
    dig = {x["coords"]: (x[name] if key is None
                         else x[name]["controls"][key])["digest"]
           for x in res}
    diff = []
    for s in range(P20_RU[0]):
        a, b = dig[(s, 0)], dig[(s, 1)]
        for k in a["blocks"]:
            diff += [(s, k, n) for n, (x, y) in enumerate(zip(
                a["blocks"][k], b["blocks"][k])) if x != y and n != a["null"]]
    return not diff, diff, dig[(0, 0)]["blocks"] != dig[(1, 0)]["blocks"]


def _p20_gates(res, case, tmp):
    """One case's gates: sharding, ranks' streams, states, fault log and
    logits checksums equal, replicas' pools bitwise equal, launches; (a)
    against one process's engine on the same weights (streams equal),
    (b) against one process replaying the seq shards' expert choices and
    kept pairs, teacher-forced on their tokens (logits within 5% of max
    |logit|), the corrupted block's owner alone quarantined, the two
    controls rejected.  Returns the case's launches (all ranks)."""
    from repro_torch.models.moe import capacity
    name, arch, depth, sharding, corrupt = case
    ranks = [x[name] for x in res]
    zero = ranks[0]
    cfg = get_config(arch).replace(n_layers=depth)
    r_seq = P20_RU[0]
    a = cfg.attn
    want_local = ((cfg.n_layers, P4_ENGINE["n_blocks"], P4_ENGINE[
        "block_size"], a.n_kv_heads // r_seq, a.head_dim)
        if sharding == "heads" else
        (cfg.n_layers, P4_ENGINE["n_blocks"] // r_seq,
         P4_ENGINE["block_size"], a.kv_lora_rank + a.qk_rope_head_dim))
    keys = (("flash_fwd", "paged_decode") if sharding == "heads"
            else ("flash_fwd_latent", "paged_decode"))
    for x, rr in zip(res, ranks):
        check(rr["sharding"] == sharding and rr["group"] == r_seq
              and rr["local"] == want_local, f"({name}) rank {x['rank']}: "
              f"pool {rr['sharding']} over {rr['group']}, local "
              f"{rr['local']}, want {sharding} over {r_seq}, {want_local}")
        check(rr["sums"] == zero["sums"], f"({name}) rank {x['rank']} "
              "computed other logits")
        check(all(np.array_equal(p, q) for p, q in zip(rr["out"],
                                                       zero["out"]))
              and rr["log"] == zero["log"] and rr["states"] == zero["states"],
              f"({name}) rank {x['rank']}: streams, fault log or states "
              "differ")
        check(all(rr["launches"][k] > 0 for k in keys), f"({name}) rank "
              f"{x['rank']}: launches {rr['launches']}")
    same, diff, apart = _replicas_equal(res, name)
    check(same and apart, f"({name}) replicas' pools equal {same} (blocks "
          f"that differ: {diff[:8]}), seq shards apart {apart}")
    check(zero["forks"] >= 1, f"({name}) no copy-on-write fork")
    h = zero["held"]
    temps = [0.0] * len(zero["out"])
    prompts = zero["prompts"]
    t0 = time.perf_counter()
    one, params = _p20_model(arch, depth, None)
    if corrupt is None:
        ref = _p11_run(one, params, None)
        check(all(np.array_equal(p, q) for p, q in zip(ref["out"],
                                                       zero["out"])),
              f"({name}) the ranks' streams differ from one process's")
    else:
        recs = [torch.load(os.path.join(tmp, f"p20_seq{i}.pt"))
                for i in range(r_seq)]
        calls = [torch.cat([rec["calls"][i] for rec in recs])
                 if isinstance(v, int) else recs[0]["calls"][i]
                 for i, v in enumerate(recs[0]["valid"])]
        keep = [torch.cat([rec["keep"][j] for rec in recs])
                for j in range(len(recs[0]["keep"]))]
        del recs
        forced = {(i, len(p) + j): int(t) for i, p in enumerate(prompts)
                  for j, t in enumerate(zero["out"][i])}
        rr = _Router(calls=[c.to(DEV) for c in calls])
        with rr, _Keep(calls=keep), _capacity(lambda c, n, b: max(
                b(c, n), r_seq * b(c, n // r_seq))):
            ref = _p11_run(one, params, corrupt, router=rr, forced=forced)
        check(len(rr.seen) == len(calls) and all(
            torch.equal(p.cpu(), q) for p, q in zip(rr.seen, calls)),
            f"({name}) the one process did not replay every expert choice")
        check(all(np.array_equal(p, q) for p, q in zip(ref["out"],
                                                       zero["out"]))
              and ref["log"] == zero["log"]
              and ref["states"] == zero["states"],
              f"({name}) the teacher-forced one process took another course")
        del rr
    one_s = time.perf_counter() - t0
    one_ms = 1e3 * float(np.median(ref["step_s"]))
    del ref["eng"], one, params
    _free()
    ref = dict(out=ref["out"], rec={"logits": _host_rows(ref["rec"])})
    err, _ = _p9_compare(ref, dict(out=zero["out"], rec={
        "logits": zero["rows"]}), prompts, temps)
    same_rows = _same_rows(ref["rec"]["logits"], zero["rows"])
    say(f"  ({name}) {cfg.name} at full width, {cfg.n_layers} layers "
        f"({zero['n_params'] / 1e9:.2f} B parameters a rank), on (seq, head)"
        f" = {P20_RU}: pool {sharding}-sharded over seq (local "
        f"{zero['local']}), the head replicas' pools bitwise equal; streams, "
        f"fault log, states and logits checksums equal on every rank; "
        f"forks {zero['forks']}, fault log {zero['log']}, states "
        f"{zero['states']}")
    say(f"  ({name}) one process ({one_s:.1f} s"
        + (", replaying the seq shards' experts and kept pairs, "
           "teacher-forced" if corrupt is not None else "")
        + f"): streams equal; logits max|Δ| / max|logit| {err:.3e} (limit "
        f"{LOGIT_REL_TOL}), bitwise equal {same_rows}")
    say(f"  ({name}) rank 0's chunk call of A (q {h['A'][3]}, q_offset "
        f"{h['A'][4]}) against its plain version: max|Δo| {h['A'][0]:.3e}, "
        f"rel {h['A'][1]:.3e}, max|Δlse| {h['A'][2]:.3e}; a decode call of "
        f"B (pool {h['B'][1]}): max|Δo| {h['B'][0]:.3e}")
    check(err <= LOGIT_REL_TOL, f"({name}) logits vs one process: {err}")
    out = dict(err=err, bitwise=same_rows, one_step_ms=one_ms)
    if corrupt is not None:
        failed = [i for i, st in enumerate(zero["states"])
                  if st == ("failed", "nan_logits")]
        (_, _, detail), = zero["log"]
        victim = int(detail.split("rid=")[1].split()[0])
        check(failed == [victim], f"({name}) quarantined {failed}, the "
              f"corrupted block's owner is {victim}")
        C = P4_ENGINE["prefill_chunk_tokens"]
        n_moe = cfg.n_layers - cfg.moe.n_dense_layers
        for x, rr in zip(res, ranks):
            check(rr["dispatch"] and set(rr["dispatch"]) == {C // r_seq},
                  f"({name}) rank {x['rank']} dispatched "
                  f"{sorted(set(rr['dispatch']))} rows, want {C // r_seq}")
        same_ctl, diff_ctl, _ = _replicas_equal(res, name, "replica")
        logs = {tuple(map(str, x[name]["controls"]["replica"]["log"]))
                for x in res}
        rows_ctl = sorted({n for x in ranks
                           for n in x["controls"]["rows"]["dispatch"]})
        ctl_rows = zero["controls"]["rows"]
        e_rows, _ = _p9_compare(ref, dict(out=ctl_rows["out"], rec={
            "logits": ctl_rows["rows"]}), prompts, temps, gate=False)
        say(f"  ({name}) a chunk's MoE: {C // r_seq} of its {C} rows a seq "
            f"rank (the same on its head ranks; capacity "
            f"{capacity(cfg, C // r_seq)} an expert), {n_moe} MoE layers; "
            f"controls: the corrupted block poisoned on head replica 0 only "
            f"— replicas' pools bitwise equal {same_ctl} ({len(diff_ctl)} "
            f"blocks differ; rejected: {not same_ctl}), fault logs across "
            f"ranks {len(logs)}; each "
            f"head rank dispatching only its own {C // P20_RANKS} rows — "
            f"dispatches of {rows_ctl} rows (a seq rank holds {C // r_seq}),"
            f" logits max|Δ| / max|logit| {e_rows:.3e}")
        check(not same_ctl, f"({name}) the replica check does not reject "
              "the fault applied on one head replica")
        check(rows_ctl != [C // r_seq] or e_rows > LOGIT_REL_TOL,
              f"({name}) neither the dispatch size nor the logits reject "
              f"the own-rows dispatch ({rows_ctl}, {e_rows})")
        out["controls"] = dict(replica=not same_ctl, rows=e_rows,
                               rows_dispatch=rows_ctl)
    for x, rr in zip(res, ranks):
        d = rr["decode"]
        tot = sum(d["s"])
        say(f"  ({name}) rank {x['rank']} {x['coords']}: decode-step ms "
            f"(median) {float(np.median(rr['step_ms'])):.2f}; decode calls "
            f"{len(d['s'])}, {tot:.3f} s: pool gathers {d['gather']:.3f} s "
            f"({d['gather'] / tot:.3f}), MoE sums {d['reduce']:.3f} s "
            f"({d['reduce'] / tot:.3f}); run {rr['wall']:.1f} s; peak "
            f"{rr['peak'] / 2**30:.2f} GiB; launches {rr['launches']}")
    say(f"  ({name}) one process: decode-step ms (median) {one_ms:.2f}")
    out.update(step_ms=[float(np.median(rr["step_ms"])) for rr in ranks],
               gather_s=[rr["decode"]["gather"] for rr in ranks],
               sum_s=[rr["decode"]["reduce"] for rr in ranks])
    launches = {}
    for rr in ranks:
        for k, n in rr["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return launches, out


def engine2d():
    """Phase 20: the paged Engine on a 2D (seq = 2) × (head = 2) mesh of 4
    ranks sharing the one card, every pool sharded over seq alone (the u
    head ranks of a seq shard hold the same part): (a) qwen3-8b's width at
    depth 8 of 36, its K/V pool head-parallel (4 of 8 kv heads a seq
    rank), held to one process's engine on the same weights; (b)
    deepseek-v2-lite-16b at full width, 9 of 27 layers, its latent pool
    block-sharded (96 of 192 blocks a seq rank), each chunk's MoE rows
    split over seq (128 of 256 a seq rank), a corrupted block, held to one
    process replaying the seq shards' expert choices and kept pairs, with
    two controls.  Phase 11's requests (a prefix fork), 32 greedy
    tokens."""
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = spawn(_p20_rank, P20_RANKS, (tmp,), device=DEV,
                    timeout=P20_TIMEOUT, threads=2)
        world = time.perf_counter() - t0
        res.sort(key=lambda r: r["rank"])
        _say_comm(20, res)
        check(all(r["transport"] == P8_TRANSPORT for r in res),
              f"transport {[r['transport'] for r in res]}")
        launches, out = {}, {}
        for case in P20_CASES:
            t0 = time.perf_counter()
            got, out[case[0]] = _p20_gates(res, case, tmp)
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            say(f"  ({case[0]}) gates {time.perf_counter() - t0:.1f} s")
    say(f"  launches on the ranks (all ranks, both cases) "
        f"{ {k: n for k, n in launches.items() if n} }")
    out.update(launches=launches, world_s=world,
               seconds=time.perf_counter() - t_all)
    say(f"  world of {P20_RANKS} ranks: {world:.1f} s, spawn included; "
        f"phase 20 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 21

P21_ARCHS = ("mamba2-2.7b", "zamba2-2.7b")
P21_T, P21_STEPS, P21_SEED = 8192, 3, 21
P21_PROMPT, P21_NEW = 64, 32     # the recurrent decode: prompt, greedy
# bf16 rounds the chunked and the recurrent scans apart, and 64 layers of
# random weights carry it: the bf16 training forward of mamba2-2.7b reads
# 0.18 of max |logit| off its float32 run (tools/ssm_bf16_drift.py), so
# the bf16 decode is held to the forward's own bf16 rounding: its distance
# from the float32 decode within this multiple of the forward's from the
# float32 forward (the tool read 0.92-1.12 at 4 to 64 layers)
DECODE16_RATIO = 1.5
# zamba2's gradients against the plain attention path: full width, one
# group of 6 layers (one shared-block call), 4,096 tokens (the plain
# version's (32, T, T) float32 scores 2 GiB)
P21_GRAD_LAYERS, P21_GRAD_T = 6, 4096
# (c): zamba2 on 4 ranks sharing the card, 12 of 54 layers (the shared
# block twice), one 16,384-token sequence a step (4,096 a rank), balanced
P21C_LAYERS, P21C_T, P21C_RANKS, P21C_TIMEOUT = 12, 16384, 4, 600
# the first P21C_EDGE positions of every rank's shard: where the relayed
# state and the conv halo weigh most (the reference init's A = −1 decays a
# carried state within tens of tokens, so the loss alone barely sees it)
P21C_EDGE = 64
D160_KERNELS = ("flash_fwd_160", "flash_bwd_dq_160", "flash_bwd_dkv_160")


def _p21_decode(cfg):
    """The recurrent decode of seed-21 weights from the empty cache, in
    float32 and in bf16 (the float32 weights cast): the 64-token prompt
    fed token by token, then (bf16) 32 greedy tokens, each step timed with
    CUDA events.  Readings, each the largest over the prompt's positions
    of max |Δlogit| / max |logit| of the second term: the decode against
    the training forward (:func:`_trunk_logits`) in float32 (``e32``, the
    gate: ≤ LOGIT_REL_TOL) and in bf16 (``e16``, read); each path's bf16
    run against its float32 run, the bf16 rounding it carries (the gate:
    the decode's ``n_dec`` within DECODE16_RATIO × the forward's
    ``n_fwd``); the bf16 forward at a quarter of its SSD chunk against
    itself (``order16``, read: what another float32 summation order alone
    moves once rounded to bf16).  Returns the readings and ``ms``, the
    median ms of a greedy bf16 step."""
    from repro_torch.data.pipeline import empty_decode_cache
    prompt = torch.from_numpy(np.random.default_rng(P21_SEED).integers(
        0, cfg.vocab, (1, P21_PROMPT)).astype(np.int32)).to(DEV)
    fwd, dec, ms, r = {}, {}, [], {}
    base = DecoderLM(cfg.replace(dtype="float32"), DEV).init(seed=P21_SEED)
    for dt in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dt)
        model = DecoderLM(c, DEV)
        params = base if dt == "float32" else _cast(base, torch.bfloat16)
        fwd[dt] = _trunk_logits(model, params, prompt)[0]
        cache = empty_decode_cache(c, 1, P21_PROMPT + P21_NEW, DEV)
        rows, tok = [], None
        n = P21_PROMPT + (P21_NEW if dt == "bfloat16" else 0)
        for t in range(n):
            cur = prompt[:, t:t + 1] if t < P21_PROMPT else tok
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            lg = model.decode(params, cache, cur, torch.full(
                (1,), t, dtype=torch.int32, device=DEV))
            b.record()
            b.synchronize()
            if t < P21_PROMPT:
                rows.append(lg[0, 0].float())
            else:
                ms.append(a.elapsed_time(b))
            tok = lg[:, -1:].argmax(-1).to(torch.int32)
        dec[dt] = torch.stack(rows)
        check(all(torch.isfinite(x).all() for x in cache.values()),
              f"{c.name} {dt}: a non-finite decode cache")
        if dt == "bfloat16":
            fine = c.replace(ssm=dataclasses.replace(
                c.ssm, chunk=P21_PROMPT // 4))
            r["order16"] = _row_rel(_trunk_logits(
                DecoderLM(fine, DEV), params, prompt)[0], fwd[dt])
        del model, params, cache
    del base
    _free()
    r["e32"] = _row_rel(dec["float32"], fwd["float32"])
    r["e16"] = _row_rel(dec["bfloat16"], fwd["bfloat16"])
    r["n_fwd"] = _row_rel(fwd["bfloat16"], fwd["float32"])
    r["n_dec"] = _row_rel(dec["bfloat16"], dec["float32"])
    check(r["e32"] <= LOGIT_REL_TOL, f"{cfg.name}: recurrent decode logits "
          f"{r['e32']:.4e} of max |logit| off the training forward's "
          "(float32)")
    check(r["n_dec"] <= DECODE16_RATIO * r["n_fwd"], f"{cfg.name}: the bf16 "
          f"decode {r['n_dec']:.4e} of max |logit| off the float32 decode, "
          f"over {DECODE16_RATIO} × the bf16 training forward's "
          f"{r['n_fwd']:.4e} off the float32 forward")
    r["ms"] = float(np.median(ms))
    return r


def _row_rel(got, ref):
    """The largest over rows of max |got − ref| / max |ref|."""
    return float(((got - ref).abs().amax(-1) / ref.abs().amax(-1)).max())


def _trunk_logits(model, params, tokens):
    """An SSM or hybrid model's training trunk (``prefill``'s SSM arm) with
    the logits of every position of this rank's shard, float32."""
    with torch.no_grad():
        h, cos, sin, _, _ = model._trunk_input(params, tokens)
        return model._head(params, model._ssm_trunk(params, h, cos,
                                                    sin)).float()


def _cast(tree, dtype, name=None):
    """A parameter tree in ``dtype``, the leaves the model keeps in float32
    kept (``init`` draws every leaf in float32 and casts it: this is the
    ``dtype`` init of the same seed, bit for bit)."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(x, dtype, name) for x in tree]
    return tree if name in TF._FLOAT32_LEAVES else tree.to(dtype)


def _p21_grad_check():
    """(b): zamba2 at full width, 6 layers, T 4096: per-leaf gradients
    through kernels A, C and D against the plain attention path; the limit
    must reject a backward shifted by one position (phase 6b's control)."""
    cfg = get_config("zamba2-2.7b").replace(n_layers=P21_GRAD_LAYERS)
    batch = SyntheticTokens(cfg, ShapeSpec("g", P21_GRAD_T, 1, "train"),
                            device=DEV).batch(0)
    _grads_vs_plain(cfg, batch, P21_SEED, f"(b) gradients at full width, "
                    f"{P21_GRAD_LAYERS} layers, T {P21_GRAD_T}:")
    _free()


def ssm_models():
    """Phase 21 (a) and (b): mamba2-2.7b and zamba2-2.7b at full size on
    one card, bf16, seed-0 weights: 3 training steps of 8,192 tokens under
    remat_aware (the SSM layers checkpointed at their boundary, zamba2's
    shared block remat-aware through kernels A, C and D at head dim 160,
    each launched once a call: 9 calls a step), one more step traced for
    the device's idle share; then the recurrent decode of seed-21 weights
    (:func:`_p21_decode`); zamba2's gradients against the plain attention
    path (:func:`_p21_grad_check`)."""
    out = {"launches": dict.fromkeys(D160_KERNELS, 0)}
    for arch in P21_ARCHS:
        t0 = time.perf_counter()
        part = "(a)" if arch == "mamba2-2.7b" else "(b)"
        cfg = get_config(arch)
        tc = TrainConfig(lr=1e-4, warmup_steps=1, total_steps=P21_STEPS)
        ds = SyntheticTokens(cfg, ShapeSpec("chip21", P21_T, 1, "train"),
                             device=DEV, seed=0)
        batches = [ds.batch(i) for i in range(P21_STEPS)]
        say(f"  {part} {cfg.name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.ssm.n_heads(cfg.d_model)} SSM heads of "
            f"{cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}"
            + (f", a shared block of {cfg.attn.n_heads} heads × "
               f"{cfg.attn.head_dim} every {cfg.hybrid_period} layers"
               if cfg.attn else "")
            + f" ({cfg.param_count() / 1e9:.2f} B params), B 1 T {P21_T}, "
            "bf16 params, fp32 moments")
        runs, launches, peak, idle = _train_policy(
            cfg, "remat_aware", batches, tc, kernels=D160_KERNELS,
            profile=True)
        for i, (m, sec) in enumerate(runs):
            check(m["skipped_nonfinite"] == 0 and np.isfinite(m["loss"]),
                  f"{arch} step {i + 1}: loss {m['loss']}")
            say(f"  {part} step {i + 1}: loss {m['loss']:.4f} gnorm "
                f"{m['gnorm']:.3f} step {sec:.3f} s")
        tok_s = (P21_STEPS - 1) * P21_T / sum(s for _, s in runs[1:])
        calls = cfg.n_layers // cfg.hybrid_period if cfg.attn else 0
        for k in D160_KERNELS:
            check(launches[k] == calls * P21_STEPS, f"{arch}: {k} launched "
                  f"{launches[k]} times, want {calls} a step")
            out["launches"][k] += launches[k]
        say(f"  {part} {tok_s:.1f} tokens/s over steps 2-{P21_STEPS}, peak "
            f"memory {peak / 2**30:.2f} GiB, device idle share {idle:.3f}; "
            f"launches over the {P21_STEPS} steps "
            + ", ".join(f"{k} {launches[k]}" for k in D160_KERNELS)
            + f"; training {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        d = _p21_decode(cfg)
        say(f"  {part} recurrent decode, max |Δlogit| / max |logit| over the "
            f"{P21_PROMPT} prompt positions: decode vs training forward "
            f"{d['e32']:.4e} in float32 (limit {LOGIT_REL_TOL}), "
            f"{d['e16']:.4e} in bf16 (read); bf16 vs float32 on the same "
            f"weights: decode {d['n_dec']:.4e}, training forward "
            f"{d['n_fwd']:.4e} (limit: the decode within {DECODE16_RATIO} × "
            f"the forward's), the bf16 forward at SSD chunk "
            f"{P21_PROMPT // 4} vs {P21_PROMPT} {d['order16']:.4e} (read); "
            f"{d['ms']:.2f} ms a greedy bf16 step (median of {P21_NEW}); "
            f"{time.perf_counter() - t1:.1f} s")
        out[arch] = dict(tok_s=tok_s, peak=peak, idle=idle, decode_ms=d["ms"],
                         decode=d)
        if cfg.attn:
            t1 = time.perf_counter()
            _p21_grad_check()
            say(f"  {part} gradient check {time.perf_counter() - t1:.1f} s")
        say(f"  {part} took {time.perf_counter() - t0:.1f} s")
    return out


def _p21c_cfg():
    return get_config("zamba2-2.7b").replace(n_layers=P21C_LAYERS)


def _p21c_edges(T, P):
    """The first P21C_EDGE positions of every rank's shard."""
    return np.concatenate([np.arange(r * (T // P), r * (T // P) + P21C_EDGE)
                           for r in range(P)])


def _p21c_one(tmp):
    """(c)'s P = 1 on this process, the ranks' weights and tokens: step 1's
    loss and gradients, and the logits at every shard's first positions,
    saved on the host at ``tmp/p1.pt``."""
    cfg = _p21c_cfg()
    one = DecoderLM(cfg, DEV)
    params = trainable(one.init(seed=P21_SEED))
    batch = SyntheticTokens(cfg, ShapeSpec("chip21c", P21C_T, 1, "train"),
                            device=DEV, seed=0).batch(0)
    loss, _ = one.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves(params))
    edges = torch.as_tensor(_p21c_edges(P21C_T, P21C_RANKS), device=DEV)
    logits = _trunk_logits(one, params, batch["tokens"])[0, edges]
    torch.save({"loss": float(loss.detach()),
                "grads": [g.cpu() for g in grads], "logits": logits.cpu(),
                "names": _leaf_names(params)}, os.path.join(tmp, "p1.pt"))
    del one, params, grads, logits
    _free()
    return float(loss.detach())


def _p21c_rank(rank, tmp):
    """One rank of (c): step 1's loss, summed gradients and shard-edge
    logits held to P = 1's (the worst leaf, the worst edge), the forward
    and backward timed with their host seconds in shifts and all-reduces;
    then the loss and the edges under each planted relay fault."""
    from repro_torch.models import ssm as SSM
    from repro_torch.train.step import sum_grads
    mesh = make_local_mesh(seq=P21C_RANKS, device=DEV)
    p = mesh.coord("model")
    cfg = _p21c_cfg()
    shape = ShapeSpec("chip21c", P21C_T, 1, "train")
    model = DecoderLM(cfg, DEV, mesh=mesh, par=make_parallel_config(
        mesh, shape, schedule="balanced"))
    params = trainable(model.init(seed=P21_SEED))
    ds = SyntheticTokens(cfg, shape, device=DEV, seed=0, mesh=mesh,
                         par=model.par)
    b0 = ds.batch(0)
    glob = SyntheticTokens(cfg, shape, device=DEV, seed=0).batch(0)["tokens"]
    one = torch.load(os.path.join(tmp, "p1.pt"))
    Tl, E = P21C_T // P21C_RANKS, P21C_EDGE
    ref_edge = one["logits"][p * E:(p + 1) * E].to(DEV).float()

    def readings(grad=True):
        if grad:
            loss, _ = model.loss(params, b0)
            raw = torch.autograd.grad(loss, leaves(params))
            grads, _ = sum_grads(model, params, list(raw))
            err = _worst_leaf(grads, [g.to(DEV) for g in one["grads"]],
                              one["names"])
            del raw, grads
        else:
            with torch.no_grad():
                loss, _ = model.loss(params, b0)
            err = None
        edge = _trunk_logits(model, params, glob)[0, :E]
        d_edge = float((edge - ref_edge).abs().max()
                       / ref_edge.abs().max())
        return dict(loss=float(loss.detach()), grad_err=err, edge=d_edge)
    comms = [model.seq_group, model.token_group]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    c0 = _comm_seconds(comms)
    t0 = time.perf_counter()
    out = {"rank": p, "transport": mesh.transport, "first": readings()}
    torch.cuda.synchronize()
    c1 = _comm_seconds(comms)
    out["step"] = dict(sec=time.perf_counter() - t0,
                       comm={k: c1[k] - c0[k] for k in c1})
    out["peak"] = torch.cuda.max_memory_allocated()
    out["launches"] = {k: build.LAUNCHES[k] for k in D160_KERNELS}

    def zero_state(group, decay, state):
        return torch.zeros_like(state)

    def zero_halo(group, xbc, k):
        return torch.zeros_like(xbc[:, -(k - 1):])
    out["faults"] = {}
    for name, where, fn in (("zero_state", "_device_prefix", zero_state),
                            ("zero_halo", "_halo", zero_halo)):
        right = getattr(SSM, where)
        setattr(SSM, where, fn)
        try:
            out["faults"][name] = readings(grad=False)
        finally:
            setattr(SSM, where, right)
    out["comm_s"] = _process_comm_seconds()
    return out


def ssm_ranks():
    """Phase 21 (c): zamba2-2.7b at full width, 12 of 54 layers (the shared
    block twice), on 4 ``cuda-ipc`` ranks sharing the card, one 16,384-token
    sequence a step (4,096 a rank), balanced, seed-21 weights: the SSD state
    relayed between the ranks, the conv halo shifted, the shared block's
    attention through the balanced plan (kernels A, C and D at 160).  Held
    to one process on the same weights and tokens: step 1's loss within
    2^-8 of its size (phase 15's bar), every gradient leaf within 5% of its
    max |g|, the logits at each shard's first 64 positions within 5% of max
    |logit|; each planted relay fault (every rank starting from a zero
    state; the conv halo zeroed) must be rejected."""
    cfg = _p21c_cfg()
    say(f"  (c) {cfg.name} at full width, {cfg.n_layers} of 54 layers "
        f"({cfg.param_count() / 1e9:.2f} B params, the shared block "
        f"{cfg.n_layers // cfg.hybrid_period} times), one sequence of "
        f"{P21C_T} tokens a step ({P21C_T // P21C_RANKS} a rank), bf16, "
        f"balanced, seed {P21_SEED}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        loss1 = _p21c_one(tmp)
        say(f"  (c) P = 1 ({time.perf_counter() - t0:.1f} s): step 1 loss "
            f"{loss1:.6f}")
        t0 = time.perf_counter()
        res = spawn(_p21c_rank, P21C_RANKS, (tmp,), device=DEV,
                    timeout=P21C_TIMEOUT, threads=2)
        wall = time.perf_counter() - t0
    res.sort(key=lambda r: r["rank"])
    _say_comm(21, res)
    check(all(r["transport"] == P8_TRANSPORT for r in res),
          f"transport {[r['transport'] for r in res]}")

    def rel(a):
        return abs(a - loss1) / abs(loss1)
    launches = {k: sum(r["launches"][k] for r in res) for k in D160_KERNELS}
    for r in res:
        f = r["first"]
        err, leaf = f["grad_err"]
        say(f"  (c) rank {r['rank']}: step 1 loss {f['loss']:.6f} relative "
            f"|Δ| {rel(f['loss']):.3e} (limit {P15_TOL:.3e}); worst "
            f"gradient leaf {err:.4f} ({leaf}; limit {GRAD_REL_TOL}); "
            f"shard-edge logits {f['edge']:.4e} of max |logit| (limit "
            f"{LOGIT_REL_TOL}); step 1 forward, backward and gradient sum "
            f"with the edges' forward {r['step']['sec']:.3f} s, host in "
            f"shifts / all-reduces and gathers "
            f"{r['step']['comm']['shift']:.3f} / "
            f"{r['step']['comm']['reduce']:.3f} s; peak "
            f"{r['peak'] / 2**30:.2f} GiB; launches "
            + ", ".join(f"{k} {r['launches'][k]}" for k in D160_KERNELS))
        check(rel(f["loss"]) <= P15_TOL, f"rank {r['rank']}: loss vs P = 1")
        check(err <= GRAD_REL_TOL, f"rank {r['rank']}: {leaf} {err}")
        check(f["edge"] <= LOGIT_REL_TOL, f"rank {r['rank']}: shard-edge "
              f"logits {f['edge']}")
        check(all(r["launches"][k] > 0 for k in D160_KERNELS),
              f"rank {r['rank']}: D 160 launches {r['launches']}")
    for name in ("zero_state", "zero_halo"):
        worst = max(r["faults"][name]["edge"] for r in res)
        d_loss = max(rel(r["faults"][name]["loss"]) for r in res)
        rejected = worst > LOGIT_REL_TOL or d_loss > P15_TOL
        say(f"  (c) fault {name}: shard-edge logits {worst:.4e} of max "
            f"|logit|, step 1 loss relative |Δ| {d_loss:.3e} "
            f"({'rejected' if rejected else 'NOT rejected'})")
        check(rejected, f"relay fault {name} passes the gates")
    say(f"  (c) world of {P21C_RANKS} ranks: {wall:.1f} s, spawn included")
    return dict(launches=launches, res=res)


# ----------------------------------------------------------------- phase 22

P22_MESH = (2, 2)                # (seq, head): r·u = 4 ranks
# the recurrent decode: the prompt token by token from the empty cache,
# then greedy tokens; 64 slots of the shared K/V, 16 a rank
P22_PROMPT, P22_NEW, P22_SEED = 56, 8, 22
P22_TIMEOUT = 600


def _p22_prompt(vocab):
    return torch.from_numpy(np.random.default_rng(P22_SEED).integers(
        0, vocab, (1, P22_PROMPT)).astype(np.int32)).to(DEV)


@contextlib.contextmanager
def _decode_attn_outputs():
    """While the block runs, every ``dist_decode_attn`` of the models (a
    hybrid's shared-block calls in the decode) appends its output, float32
    on the host, to the list it yields."""
    outs, right = [], TF.dist_decode_attn

    def rec(*a, **kw):
        o = right(*a, **kw)
        outs.append(o.float().cpu())
        return o
    TF.dist_decode_attn = rec
    try:
        yield outs
    finally:
        TF.dist_decode_attn = right


def _p22_decode(model, params, prompt, forced=None):
    """The recurrent decode from the empty cache (the hybrid's shared K/V
    sharded over the model's decode group): the prompt token by token, then
    P22_NEW greedy tokens, or the tokens of ``forced`` (1, P22_NEW).
    Returns every step's logits and every shared call's attention output
    (float32, on the host), the tokens fed after the prompt, and ms a
    step."""
    from repro_torch.data.pipeline import empty_decode_cache
    grp = model.decode_group
    cache = empty_decode_cache(model.cfg, 1, P22_PROMPT + P22_NEW, DEV,
                               shards=1 if grp is None else grp.size)
    rows, fed, tok = [], [], None
    with _decode_attn_outputs() as outs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(P22_PROMPT + P22_NEW):
            if t < P22_PROMPT:
                cur = prompt[:, t:t + 1]
            else:
                i = t - P22_PROMPT
                cur = tok if forced is None else forced[:, i:i + 1].to(DEV)
                fed.append(cur.cpu())
            lg = model.decode(params, cache, cur, torch.full(
                (1,), t, dtype=torch.int32, device=DEV))
            rows.append(lg[0, -1].float().cpu())
            tok = lg[:, -1:].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / (P22_PROMPT + P22_NEW)
    return dict(rows=torch.stack(rows), attn=torch.stack(outs),
                fed=torch.cat(fed, dim=1), ms=ms)


def _p22_one(tmp):
    """Phase 22's one process: (c)'s P = 1 readings (:func:`_p21c_one`),
    then the prefill of the seed-22 prompt and the recurrent decode
    (:func:`_p22_decode`) on the same weights, saved at ``tmp/serve.pt``."""
    loss1 = _p21c_one(tmp)
    cfg = _p21c_cfg()
    model = DecoderLM(cfg, DEV)
    params = model.init(seed=P21_SEED)
    prompt = _p22_prompt(cfg.vocab)
    logits, _ = model.prefill(params, prompt)
    dec = _p22_decode(model, params, prompt)
    torch.save(dict(prefill=logits[0, -1].float().cpu(), **dec),
               os.path.join(tmp, "serve.pt"))
    del model, params
    _free()
    return loss1, dec["ms"]


def _p22_rank(rank, tmp):
    """One rank of phase 22 on the (seq, head) mesh: step 1's loss, summed
    gradients and shard-edge logits held to P = 1's, timed; the gradients
    with the SSM leaves summed over ``head`` once more, and the loss and
    edges with every rank starting from a zero state (the planted faults);
    then the prefill and the recurrent decode teacher-forced on P = 1's
    tokens, the prefill with the 2D plan's head scatter rotated by one,
    and the decode with rank 1's shard left out of its reductions."""
    from repro_torch.models import ssm as SSM
    from repro_torch.train.step import sum_grads
    mesh = make_seq2d_mesh(*P22_MESH, device=DEV)
    cfg = _p21c_cfg()
    shape = ShapeSpec("chip21c", P21C_T, 1, "train")
    model = DecoderLM(cfg, DEV, mesh=mesh, par=make_parallel_config(
        mesh, shape, schedule="balanced"))
    p = model.seq_rank
    params = trainable(model.init(seed=P21_SEED))
    b0 = SyntheticTokens(cfg, shape, device=DEV, seed=0, mesh=mesh,
                         par=model.par).batch(0)
    glob = SyntheticTokens(cfg, shape, device=DEV, seed=0).batch(0)["tokens"]
    one = torch.load(os.path.join(tmp, "p1.pt"))
    names, E = one["names"], P21C_EDGE
    ref = [g.to(DEV) for g in one["grads"]]
    ref_edge = one["logits"][p * E:(p + 1) * E].to(DEV).float()

    def edge():
        e = _trunk_logits(model, params, glob)[0, :E]
        return float((e - ref_edge).abs().max() / ref_edge.abs().max())
    comms = [model.seq_group, model.token_group, mesh.comms["head"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    c0 = _comm_seconds(comms)
    t0 = time.perf_counter()
    loss, _ = model.loss(params, b0)
    grads, _ = sum_grads(model, params, list(torch.autograd.grad(
        loss, leaves(params))))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    c1 = _comm_seconds(comms)
    out = {"rank": p, "transport": mesh.transport,
           "launches": {k: build.LAUNCHES[k] for k in D160_KERNELS},
           "first": dict(loss=float(loss.detach()),
                         grad_err=_worst_leaf(grads, ref, names),
                         edge=edge()),
           "step": dict(sec=sec, comm={k: c1[k] - c0[k] for k in c1}),
           "peak": torch.cuda.max_memory_allocated()}
    mesh.comms["head"].all_reduce_([g for g, n in zip(grads, names)
                                    if "/ssm/" in n])
    out["faults"] = {"head": dict(grad_err=_worst_leaf(grads, ref, names))}
    del grads, ref

    def zero_state(group, decay, state):
        return torch.zeros_like(state)
    right = SSM._device_prefix
    SSM._device_prefix = zero_state
    try:
        with torch.no_grad():
            bad, _ = model.loss(params, b0)
        out["faults"]["zero_state"] = dict(loss=float(bad), edge=edge())
    finally:
        SSM._device_prefix = right
    srv = torch.load(os.path.join(tmp, "serve.pt"))
    smodel = DecoderLM(cfg, DEV, mesh=mesh, par=make_parallel_config(
        mesh, ShapeSpec("chip22", P22_PROMPT + P22_NEW, 1, "decode")))
    prompt = _p22_prompt(cfg.vocab)
    build.reset_launches()
    logits, _ = smodel.prefill(params, prompt)
    out["serve_launches"] = {k: build.LAUNCHES[k] for k in D160_KERNELS}
    dec = _p22_decode(smodel, params, prompt, forced=srv["fed"])
    pre = logits[0, -1].float().cpu()
    out["serve"] = dict(
        prefill=float((pre - srv["prefill"]).abs().max()
                      / srv["prefill"].abs().max()),
        logits=_step_err(dec["rows"], srv["rows"]),
        attn=_step_err(dec["attn"], srv["attn"]), ms=dec["ms"],
        shards=smodel.decode_group.size,
        argmax=int((dec["rows"].argmax(-1) == srv["rows"].argmax(-1))
                   .sum()))
    with _decode_fault(smodel, "shard"):
        bad = _p22_decode(smodel, params, prompt, forced=srv["fed"])
    out["faults"]["shard"] = dict(logits=_step_err(bad["rows"], srv["rows"]),
                                  attn=_step_err(bad["attn"], srv["attn"]))
    with _p18_fault("scatter"):
        bad, _ = smodel.prefill(params, prompt)
    bad = bad[0, -1].float().cpu()
    out["faults"]["scatter"] = float((bad - srv["prefill"]).abs().max()
                                     / srv["prefill"].abs().max())
    out["comm_s"] = _process_comm_seconds()
    return out


def ssm2d():
    """Phase 22: zamba2-2.7b at full width, 12 of 54 layers (the shared
    block twice), on a 2D (seq = 2) × (head = 2) mesh of 4 ``cuda-ipc``
    ranks, one 16,384-token sequence a step (4,096 a rank), balanced,
    seed-21 weights: the SSD state relayed and the conv halo shifted over
    all 4 ranks in sequence order, the shared block's attention through the
    2D plan (kernels A, C and D at head dim 160).  Held to one process on
    the same weights and tokens as phase 21 (c): step 1's loss within 2^-8,
    every summed gradient leaf within 5% of max |g| (each rank's SSM
    gradients its own share, summed once), the logits at every shard's
    first 64 positions within 5% of max |logit|; rejected faults: the SSM
    leaves summed over head once more, every rank starting from a zero
    state.  Then the prefill of a 56-token prompt and the recurrent decode
    (the prompt token by token, then 8 greedy tokens; the shared K/V
    sharded over the 4 ranks), teacher-forced on the one process's tokens:
    the prefill's logits, every step's logits and every shared call's
    attention output within 5% of the one process's; rejected faults: the
    prefill's head scatter rotated by one, rank 1's shard left out of the
    decode's reductions."""
    cfg = _p21c_cfg()
    say(f"  {cfg.name} at full width, {cfg.n_layers} of 54 layers on a "
        f"(seq, head) = {P22_MESH} mesh, one sequence of {P21C_T} tokens "
        f"a step ({P21C_T // 4} a rank), bf16, balanced, seed {P21_SEED}; "
        f"serving: a {P22_PROMPT}-token prompt, {P22_NEW} greedy tokens")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        loss1, ms1 = _p22_one(tmp)
        say(f"  P = 1 ({time.perf_counter() - t0:.1f} s): step 1 loss "
            f"{loss1:.6f}; recurrent decode {ms1:.2f} ms a step")
        t0 = time.perf_counter()
        res = spawn(_p22_rank, 4, (tmp,), device=DEV, timeout=P22_TIMEOUT,
                    threads=2)
        wall = time.perf_counter() - t0
    res.sort(key=lambda r: r["rank"])
    _say_comm(22, res)
    check(all(r["transport"] == P8_TRANSPORT for r in res),
          f"transport {[r['transport'] for r in res]}")

    def rel(a):
        return abs(a - loss1) / abs(loss1)
    for r in res:
        f, s = r["first"], r["serve"]
        err, leaf = f["grad_err"]
        say(f"  rank {r['rank']}: step 1 loss {f['loss']:.6f} relative |Δ| "
            f"{rel(f['loss']):.3e} (limit {P15_TOL:.3e}); worst gradient "
            f"leaf {err:.4f} ({leaf}; limit {GRAD_REL_TOL}); shard-edge "
            f"logits {f['edge']:.4e} (limit {LOGIT_REL_TOL}); step "
            f"{r['step']['sec']:.3f} s, host in shifts / all_to_alls / "
            f"all-reduces {r['step']['comm']['shift']:.3f} / "
            f"{r['step']['comm']['a2a']:.3f} / "
            f"{r['step']['comm']['reduce']:.3f} s; peak "
            f"{r['peak'] / 2**30:.2f} GiB; train launches "
            + ", ".join(f"{k} {r['launches'][k]}" for k in D160_KERNELS))
        say(f"  rank {r['rank']} serving ({s['shards']} cache shards): "
            f"prefill logits {s['prefill']:.4e}, decode logits "
            f"{s['logits']:.4e}, shared-block attention outputs "
            f"{s['attn']:.4e} of max (limit {LOGIT_REL_TOL}); argmax equal "
            f"at {s['argmax']} of {P22_PROMPT + P22_NEW} steps; "
            f"{s['ms']:.2f} ms a step; prefill launches "
            + ", ".join(f"{k} {r['serve_launches'][k]}"
                        for k in D160_KERNELS))
        check(rel(f["loss"]) <= P15_TOL, f"rank {r['rank']}: loss vs P = 1")
        check(err <= GRAD_REL_TOL, f"rank {r['rank']}: {leaf} {err}")
        check(f["edge"] <= LOGIT_REL_TOL, f"rank {r['rank']}: edges")
        check(all(r["launches"][k] > 0 for k in D160_KERNELS),
              f"rank {r['rank']}: D 160 launches {r['launches']}")
        check(r["serve_launches"]["flash_fwd_160"] > 0,
              f"rank {r['rank']}: the prefill did not launch A at 160")
        check(max(s["prefill"], s["logits"], s["attn"]) <= LOGIT_REL_TOL,
              f"rank {r['rank']}: serving vs P = 1 {s}")
        check(s["shards"] == 4, f"rank {r['rank']}: {s['shards']} shards")
    head = max(r["faults"]["head"]["grad_err"][0] for r in res)
    zs = max(max(r["faults"]["zero_state"]["edge"] / LOGIT_REL_TOL,
                 rel(r["faults"]["zero_state"]["loss"]) / P15_TOL)
             for r in res)
    shard = max(max(r["faults"]["shard"]["logits"],
                    r["faults"]["shard"]["attn"]) for r in res)
    scatter = min(r["faults"]["scatter"] for r in res)
    say(f"  faults: SSM leaves summed over head twice, worst leaf "
        f"{head:.4f} (limit {GRAD_REL_TOL}); zero relayed state, the "
        f"larger of edge and loss over their limits {zs:.3f}; rank 1's "
        f"decode shard left out, logits / attention outputs "
        + ", ".join(f"{r['faults']['shard']['logits']:.4e}/"
                    f"{r['faults']['shard']['attn']:.4e}" for r in res)
        + f" (limit {LOGIT_REL_TOL}); the prefill with the head scatter "
        "rotated, logits " + ", ".join(f"{r['faults']['scatter']:.4e}"
                                       for r in res))
    check(head > GRAD_REL_TOL, "the SSM leaves counted twice pass")
    check(zs > 1, "the zero relayed state passes")
    check(shard > LOGIT_REL_TOL, "the decode without rank 1's shard passes")
    check(scatter > LOGIT_REL_TOL, "the prefill's rotated head scatter "
          "passes")
    say(f"  world of 4 ranks: {wall:.1f} s, spawn included")
    launches = {k: sum(r["launches"][k] + r["serve_launches"][k]
                       for r in res) for k in D160_KERNELS}
    return dict(launches=launches, res=res)


# ----------------------------------------------------------------- phase 23

P23_ARCH, P23_SEED = "internvl2-2b", 23
P23_T, P23_STEPS = 8192, 3              # 256 image positions + 7,936 text
# its gradients against the plain attention path: full width, 4 layers,
# 4,096 positions (the plain version's (16, T, T) float32 scores 1 GiB)
P23_GRAD_LAYERS, P23_GRAD_T = 4, 4096
P23_LENS, P23_NEW = (1000, 700, 513, 64), 32     # text tokens a request
# one zigzag step at 4 ranks, 4 of 24 layers
P23_RANKS, P23_ZZ_LAYERS, P23_TIMEOUT = 4, 4, 600


def _unmask_images(model):
    """A planted fault: a VLM's image positions labelled with token 0
    instead of −100 (its loss then counts them)."""
    right = model._labels

    def labels(batch):
        got = right(batch).clone()
        got[:, :batch["image_embeds"].shape[1]] = 0
        return got
    model._labels = labels


def _grads_vs_plain(cfg, batch, seed, label, faults=()):
    """Per-leaf gradients of ``cfg``'s model from the seed-``seed`` init on
    ``batch`` through kernels A, C and D against the plain attention path,
    each leaf within GRAD_REL_TOL of its max |g|; a backward shifted by one
    position (phase 6b's control) and each planted fault of ``faults``
    ((name, fn(model))) must be rejected.  Returns the kernel path's (loss,
    gradients, leaf names)."""
    base = TF.build_model(cfg, DEV).init(seed=seed)
    names = _leaf_names(base)

    def grads(impl=None, fault=None):
        model = TF.build_model(cfg, DEV, impl=impl)
        if fault is not None:
            fault(model)
        params = trainable(base)
        loss, _ = model.loss(params, batch)
        return float(loss.detach()), torch.autograd.grad(loss,
                                                         leaves(params))
    l_ref, g_ref = grads("ref")
    l_cuda, g_cuda = grads()
    ok, leaf = _worst_leaf(g_cuda, g_ref, names)
    check(ok <= GRAD_REL_TOL, f"{label} kernel grads vs plain: {leaf} {ok}")
    controls = []
    for name, impl, fault in ((("backward shifted by one",
                                _shifted_backend(), None),)
                              + tuple((n, None, f) for n, f in faults)):
        _, g_bad = grads(impl, fault)
        bad, bad_leaf = _worst_leaf(g_bad, g_ref, names)
        del g_bad
        check(bad > GRAD_REL_TOL, f"{label}: the gradient limit does not "
              f"reject {name} (worst leaf {bad_leaf} {bad:.4f})")
        controls.append(f"{name} {bad:.4f} ({bad_leaf}; rejected)")
    say(f"  {label} loss kernels {l_cuda:.5f} vs plain {l_ref:.5f}; worst "
        f"leaf max|Δg| / max|g| {ok:.4f} ({leaf}; limit {GRAD_REL_TOL}); "
        "controls: " + ", ".join(controls))
    del base, g_ref
    _free()
    return l_cuda, g_cuda, names


def _p23_one(tmp):
    """(d)'s one process: 4 of 24 layers, step 1's loss and gradients on
    the seed-23 init and batch 0, saved at ``tmp/p1.pt``."""
    cfg = get_config(P23_ARCH).replace(n_layers=P23_ZZ_LAYERS)
    model = DecoderLM(cfg, DEV)
    params = trainable(model.init(seed=P23_SEED))
    batch = SyntheticTokens(cfg, ShapeSpec("chip23", P23_T, 1, "train"),
                            device=DEV, seed=0).batch(0)
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves(params))
    torch.save({"loss": float(loss.detach()),
                "grads": [g.cpu() for g in grads],
                "names": _leaf_names(params)}, os.path.join(tmp, "p1.pt"))
    del model, params, grads
    _free()
    return float(loss.detach())


def _p23_rank(rank, tmp):
    """One rank of (d): one zigzag step's loss and summed gradients held
    to one process's, its columns of the concatenated (image, text)
    sequence, timed; then the same with the image labels unmasked."""
    from repro_torch.train.step import sum_grads
    mesh = make_local_mesh(seq=P23_RANKS, device=DEV)
    cfg = get_config(P23_ARCH).replace(n_layers=P23_ZZ_LAYERS)
    shape = ShapeSpec("chip23", P23_T, 1, "train")
    model = DecoderLM(cfg, DEV, mesh=mesh, par=make_parallel_config(
        mesh, shape, schedule="zigzag"))
    params = trainable(model.init(seed=P23_SEED))
    b0 = SyntheticTokens(cfg, shape, device=DEV, seed=0, mesh=mesh,
                         par=model.par).batch(0)
    one = torch.load(os.path.join(tmp, "p1.pt"))
    ref = [g.to(DEV) for g in one["grads"]]

    def step():
        loss, _ = model.loss(params, b0)
        grads, _ = sum_grads(model, params, list(torch.autograd.grad(
            loss, leaves(params))))
        return dict(loss=float(loss.detach()),
                    grad_err=_worst_leaf(grads, ref, one["names"]))
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    first = step()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {k: build.LAUNCHES[k] for k in BWD_KERNELS}
    n_img = b0["image_embeds"].shape[1]
    pos = model.positions(n_img + b0["tokens"].shape[1]).cpu().numpy()
    _unmask_images(model)
    return {"rank": model.seq_rank, "transport": mesh.transport,
            "first": first, "sec": sec, "launches": launches,
            "n_img": n_img, "chunks": (int(pos[0]), int(pos[-1])),
            "fault": step(), "comm_s": _process_comm_seconds()}


def _p23_serve(cfg):
    """(c): ``FixedSlotEngine`` on 4 requests, each 256 image rows then
    P23_LENS text tokens, P23_NEW greedy tokens, one request at a time;
    every step's logits (the prefill's last, then each decode's) held to
    the plain forward over the image rows, the prompt and the greedy
    tokens; the control: the first request's decode at positions 256 too
    low (S0 taken from the text's length), teacher-forced."""
    model = DecoderLM(cfg, DEV)
    params = model.init(seed=P23_SEED)
    rng = np.random.default_rng(P23_SEED)
    n = cfg.n_image_tokens
    reqs = [(torch.from_numpy(rng.integers(0, cfg.vocab, (1, m)).astype(
                np.int32)).to(DEV),
             torch.from_numpy(rng.standard_normal(
                 (1, n, cfg.d_model)).astype(np.float32)).to(DEV, model.dtype))
            for m in P23_LENS]
    eng = FixedSlotEngine(model, params)
    build.reset_launches()
    errs, secs, ctl = [], [], None
    for i, (toks, img) in enumerate(reqs):
        batch = {"tokens": toks, "image_embeds": img}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _recorded(model) as logs:
            gen, _ = eng.generate(batch, P23_NEW)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if i == 0:
            launches = build.LAUNCHES["flash_fwd"]
        s0 = n + toks.shape[1] - 1
        ref = model.forward(params, torch.cat([toks, gen], dim=1),
                            image_embeds=img)[0, s0:].float().cpu()
        errs.append(_step_err([x[0] for x in logs], ref))
        if i == 0:
            with _decode_fault(model, "pos", by=-n), \
                    _recorded(model, forced=gen) as bad:
                eng.generate(batch, P23_NEW)
            ctl = _step_err([x[0] for x in bad], ref)
    del model, params, eng
    _free()
    return dict(errs=errs, secs=secs, ctl=ctl, launches=launches)


def vlm():
    """Phase 23: internvl2-2b at full size (24 layers, d_model 2048, 16 /
    8 heads × 128, vocab 92,553, 256 image positions), bf16, nothing cut.
    (a) 3 training steps of 8,192 positions (256 image + 7,936 text) under
    remat_aware, seed 23: finite losses, kernels A, C and D once a layer a
    step.  (b) its gradients at 4 layers, T 4,096, against the plain
    attention path (:func:`_grads_vs_plain`; controls: a shifted backward,
    the image labels unmasked).  (c) ``FixedSlotEngine``
    (:func:`_p23_serve`).  (d) one zigzag step at 4 ``cuda-ipc`` ranks, 4
    of 24 layers, the zigzag permutation of the concatenated sequence (the
    image rows in rank 0's first chunk), held to one process: the loss
    within 2^-8 and every summed gradient leaf within 5% of max |g|; the
    control: the image labels unmasked on the ranks."""
    cfg = get_config(P23_ARCH)
    a = cfg.attn
    out = {"launches": dict.fromkeys(BWD_KERNELS, 0)}
    t0 = time.perf_counter()
    say(f"  (a) {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{a.n_heads} / {a.n_kv_heads} heads × {a.head_dim}, vocab "
        f"{cfg.vocab}, {cfg.n_image_tokens} image positions "
        f"({cfg.param_count() / 1e9:.2f} B params), B 1 T {P23_T} "
        f"({P23_T - cfg.n_image_tokens} text tokens), bf16 params, fp32 "
        "moments, remat_aware")
    tc = TrainConfig(lr=1e-4, warmup_steps=1, total_steps=P23_STEPS)
    ds = SyntheticTokens(cfg, ShapeSpec("chip23", P23_T, 1, "train"),
                         device=DEV, seed=0)
    batches = [ds.batch(i) for i in range(P23_STEPS)]
    runs, launches, peak, _ = _train_policy(cfg, "remat_aware", batches, tc,
                                            seed=P23_SEED)
    for i, (m, sec) in enumerate(runs):
        check(m["skipped_nonfinite"] == 0 and np.isfinite(m["loss"]),
              f"{cfg.name} step {i + 1}: loss {m['loss']}")
        say(f"  (a) step {i + 1}: loss {m['loss']:.4f} gnorm "
            f"{m['gnorm']:.3f} step {sec:.3f} s")
    for k in BWD_KERNELS:
        check(launches[k] == cfg.n_layers * P23_STEPS, f"{cfg.name}: {k} "
              f"launched {launches[k]} times, want {cfg.n_layers} a step")
        out["launches"][k] += launches[k]
    tok_s = (P23_STEPS - 1) * P23_T / sum(s for _, s in runs[1:])
    say(f"  (a) {tok_s:.1f} positions/s over steps 2-{P23_STEPS}, peak "
        f"memory {peak / 2**30:.2f} GiB; launches "
        + ", ".join(f"{k} {launches[k]}" for k in BWD_KERNELS)
        + f"; {time.perf_counter() - t0:.1f} s")
    out.update(tok_s=tok_s, peak=peak, step_s=[s for _, s in runs],
               losses=[m["loss"] for m, _ in runs])
    del batches
    _free()
    t0 = time.perf_counter()
    gcfg = cfg.replace(n_layers=P23_GRAD_LAYERS)
    gb = SyntheticTokens(gcfg, ShapeSpec("g", P23_GRAD_T, 1, "train"),
                         device=DEV).batch(0)
    _grads_vs_plain(gcfg, gb, P23_SEED, f"(b) {P23_GRAD_LAYERS} layers, T "
                    f"{P23_GRAD_T}:", faults=(("image labels unmasked",
                                               _unmask_images),))
    del gb
    say(f"  (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sv = _p23_serve(cfg)
    for m, err, sec in zip(P23_LENS, sv["errs"], sv["secs"]):
        say(f"  (c) request of {cfg.n_image_tokens} image rows + {m} "
            f"tokens: {P23_NEW} greedy tokens in {sec:.3f} s; logits "
            f"{err:.4e} of max |logit| off the plain forward (limit "
            f"{LOGIT_REL_TOL})")
        check(err <= LOGIT_REL_TOL, f"(c) logits {err}")
    say(f"  (c) control, decode positions {cfg.n_image_tokens} too low (S0 "
        f"from the text alone): {sv['ctl']:.4e} "
        f"({'rejected' if sv['ctl'] > LOGIT_REL_TOL else 'NOT rejected'}); "
        f"flash_fwd launches on the first request {sv['launches']}; "
        f"{time.perf_counter() - t0:.1f} s")
    check(sv["ctl"] > LOGIT_REL_TOL, "the decode at S0 - 256 passes")
    check(sv["launches"] == cfg.n_layers, f"(c) the prefill launched A "
          f"{sv['launches']} times, want {cfg.n_layers}")
    out["launches"]["flash_fwd"] += sv["launches"]
    out["serve"] = sv
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        loss1 = _p23_one(tmp)
        res = spawn(_p23_rank, P23_RANKS, (tmp,), device=DEV,
                    timeout=P23_TIMEOUT, threads=2)
    res.sort(key=lambda r: r["rank"])
    _say_comm(23, res)
    for r in res:
        f, bad = r["first"], r["fault"]
        d = abs(f["loss"] - loss1) / abs(loss1)
        say(f"  (d) rank {r['rank']}: columns from {r['chunks'][0]} to "
            f"{r['chunks'][1]}, {r['n_img']} image rows; step loss "
            f"{f['loss']:.6f} relative |Δ| {d:.3e} (limit {P15_TOL:.3e}); "
            f"worst leaf {f['grad_err'][0]:.4f} ({f['grad_err'][1]}; limit "
            f"{GRAD_REL_TOL}); step {r['sec']:.3f} s; launches "
            + ", ".join(f"{k} {r['launches'][k]}" for k in BWD_KERNELS)
            + f"; image labels unmasked: loss {bad['loss']:.6f}, worst leaf "
            f"{bad['grad_err'][0]:.4f} ({bad['grad_err'][1]})")
        check(d <= P15_TOL, f"(d) rank {r['rank']}: loss vs P = 1")
        check(f["grad_err"][0] <= GRAD_REL_TOL, f"(d) rank {r['rank']}: "
              f"{f['grad_err']}")
        check(all(r["launches"][k] > 0 for k in BWD_KERNELS),
              f"(d) rank {r['rank']}: launches {r['launches']}")
        check(bad["grad_err"][0] > GRAD_REL_TOL
              or abs(bad["loss"] - loss1) / abs(loss1) > P15_TOL,
              f"(d) rank {r['rank']}: unmasked image labels pass")
        for k in BWD_KERNELS:
            out["launches"][k] += r["launches"][k]
    check([r["n_img"] for r in res] == [cfg.n_image_tokens, 0, 0, 0],
          f"(d) image rows a rank {[r['n_img'] for r in res]}")
    say(f"  (d) P = 1 loss {loss1:.6f}; {time.perf_counter() - t0:.1f} s, "
        "spawn included")
    out["ranks"] = res
    return out


# ----------------------------------------------------------------- phase 24

P24_ARCH, P24_SEED = "whisper-tiny", 24
P24_T, P24_B, P24_STEPS = 4096, 2, 2     # decoder tokens beside 1,536 frames
P24_PROMPT, P24_NEW, P24_REQS = 64, 32, 4
P24_RANKS, P24_TIMEOUT = 4, 600


def _whisper_shapes(cfg):
    """(B, Tq, Tk, H, D) of whisper's cross-attention in training and at
    decode."""
    a, F = cfg.attn, cfg.n_audio_frames
    return ((P24_B, P24_T, F, a.n_heads, a.head_dim),
            (P24_REQS, 1, F, a.n_heads, a.head_dim))


def whisper_kernels(cfg):
    """Kernels A, C and D at whisper's cross shape — q (2, 4096, 6, 64)
    against k / v (2, 1536, 6, 64), the full mask — and A at Tq = 1
    against 1,536 keys (B 4), in both dtypes, held to their plain versions
    at phase 3's bars (``_flash_case`` / ``_bwd_case``); then the bf16
    times: device ms (20 calls replayed as one CUDA graph), the plain
    version's, SDPA's (non-causal forward; its autograd backward for C and
    D, which computes the pair), each bound.  Returns the extra keys of
    the A, C and D rows."""
    gen = torch.Generator(device=DEV).manual_seed(P24_SEED)
    cross, dec = _whisper_shapes(cfg)
    full = mk.full()
    for dt in (torch.float32, torch.bfloat16):
        _flash_case(gen, "whisper cross {1}x{2}".format(*cross), *cross[:4],
                    cross[3], cross[4], dt, full)
        _bwd_case(gen, "whisper cross {1}x{2}".format(*cross), *cross[:4],
                  cross[3], cross[4], dt, full)
        _flash_case(gen, "whisper decode {1}x{2}".format(*dec), *dec[:4],
                    dec[3], dec[4], dt, full)
    extra = {"flash_fwd": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for tag, (B, Tq, Tk, H, D) in (("whisper_cross", cross),
                                   ("whisper_decode", dec)):
        q = randn(gen, (B, Tq, H, D), torch.bfloat16)
        k = randn(gen, (B, Tk, H, D), torch.bfloat16)
        v = randn(gen, (B, Tk, H, D), torch.bfloat16)
        do = randn(gen, (B, Tq, H, D), torch.bfloat16)
        scale = D ** -0.5
        o, lse = flash_fwd(q, k, v, mask=full)
        o_r, _ = chunk_attn_ref(q, k, v, mask=full)
        errs = {"flash_fwd": float((o.float() - o_r.float()).abs().max())}
        dev = {"flash_fwd": graph_ms(lambda: flash_fwd(q, k, v, mask=full))}
        plain = {"flash_fwd": cuda_ms(lambda: chunk_attn_ref(
            q, k, v, mask=full), reps=5, warmup=1)}
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        backend = _sdpa_backend(qt, kt, vt, scale=scale)
        sdpa = (lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, scale=scale))
        lib = {"flash_fwd": _library(lambda: cuda_ms(sdpa, reps=10,
                                                     warmup=2))}
        tq, tk, st = 2 * B * Tq * H * D, 2 * B * Tk * H * D, 4 * B * Tq * H
        pairs = B * H * Tq * Tk
        cost = {"flash_fwd": (4.0 * D * pairs, 2 * tq + 2 * tk + st)}
        if tag == "whisper_cross":
            got = flash_bwd(q, k, v, o, lse, do, mask=full)
            ref = chunk_attn_bwd_ref(q, k, v, o, lse, do, mask=full)
            errs["flash_bwd_dq"] = float((got[0].float() - ref[0].float())
                                         .abs().max())
            errs["flash_bwd_dkv"] = max(float((a.float() - r.float()).abs()
                                              .max())
                                        for a, r in zip(got[1:], ref[1:]))
            del got, ref
            pl = _BwdPlan(q, k, v, o, lse, do, full, None, None, None, True)
            dev["flash_bwd_dq"] = graph_ms(lambda: _launch_dq(pl, scale))
            dev["flash_bwd_dkv"] = graph_ms(lambda: _launch_dkv(pl, scale))
            for nm, only in (("flash_bwd_dq", "dq"), ("flash_bwd_dkv", "dkv")):
                plain[nm] = cuda_ms(lambda: chunk_attn_bwd_ref(
                    q, k, v, o, lse, do, mask=full, only=only), reps=3,
                    warmup=1)
            out_ = _library(sdpa)
            lb = None
            if out_ is not None:
                dot = do.transpose(1, 2).contiguous()
                lb = _library(lambda: cuda_ms(lambda: torch.autograd.grad(
                    out_, (qt, kt, vt), dot, retain_graph=True), reps=10,
                    warmup=2))
            lib["flash_bwd_dq"] = lib["flash_bwd_dkv"] = lb
            # C reads q, o, do, k, v, lse, writes dq and delta; D reads q,
            # do, k, v, lse, delta, writes dk and dv
            cost["flash_bwd_dq"] = (6.0 * D * pairs, 4 * tq + 2 * tk + 2 * st)
            cost["flash_bwd_dkv"] = (8.0 * D * pairs,
                                     2 * tq + 4 * tk + 2 * st)
            del pl, out_
        del qt, kt, vt, q, k, v, o, lse, do, o_r
        _free()
        for nm, (fl, nbytes) in cost.items():
            b_ms, b_by = bound(fl, nbytes, PEAK_BF16_FLOPS)
            ms = dev[nm]
            say(f"  {nm} {tag} B{B} Tq{Tq} Tk{Tk} H{H} D{D} bf16 full: "
                f"device {ms:.4f} ms ({fl / ms / 1e9:.1f} TFLOP/s, "
                f"{b_ms / ms:.4f} of the bound), plain {plain[nm]:.4f} ms, "
                f"sdpa {_fmt(lib[nm])} ms (backend {backend}"
                f"{'' if nm == 'flash_fwd' else ', autograd backward'}), "
                f"bound {b_ms:.4f} ms ({b_by}; {fl / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.2f} MB), max|Δ| vs plain {errs[nm]:.3e}")
            extra[nm].update({f"{tag}_ms": ms, f"{tag}_plain_ms": plain[nm],
                              f"{tag}_bound_ms": b_ms,
                              f"{tag}_bound_by": b_by,
                              f"{tag}_library_ms": lib[nm],
                              f"{tag}_library_backend": backend,
                              f"{tag}_max_abs_err": errs[nm]})
    return extra


def _causal_cross(model):
    """A planted fault: a causal mask on the encoder-decoder's
    cross-attention."""
    model.cross_mask = mk.causal()


def _p24_step(cfg, params, batch, model):
    """``model.loss`` and its gradients summed over the ranks."""
    from repro_torch.train.step import sum_grads
    loss, _ = model.loss(params, batch)
    grads, _ = sum_grads(model, params, list(torch.autograd.grad(
        loss, leaves(params))))
    return float(loss.detach()), grads


def _p24_one(cfg, tmp):
    """(c)'s float32 one process: step 1's loss and gradients from the
    seed-24 init (the bf16 init's float32 weights) on batch 0, kernel A,
    C and D's float32 routes, saved at ``tmp/p1_float32.pt``."""
    c32 = cfg.replace(dtype="float32")
    model = TF.EncDecLM(c32, DEV)
    params = trainable(model.init(seed=P24_SEED))
    batch = SyntheticTokens(c32, ShapeSpec("chip24", P24_T, P24_B, "train"),
                            device=DEV, seed=0).batch(0)
    loss, grads = _p24_step(c32, params, batch, model)
    torch.save({"loss": loss, "grads": [g.cpu() for g in grads],
                "names": _leaf_names(params)},
               os.path.join(tmp, "p1_float32.pt"))
    del model, params, grads
    _free()
    return loss


def _p24_rank(rank, tmp):
    """One rank of (c), in bf16 then in float32: step 1's loss and summed
    gradients against one process's in the same dtype (the whole clip's
    frames on every rank), timed; in float32 also the gradients with the
    encoder's leaves summed over the ranks once more."""
    mesh = make_local_mesh(seq=P24_RANKS, device=DEV)
    shape = ShapeSpec("chip24", P24_T, P24_B, "train")
    out = {"rank": mesh.world.rank, "transport": mesh.transport}
    for dt in ("bfloat16", "float32"):
        cfg = get_config(P24_ARCH).replace(dtype=dt)
        model = TF.EncDecLM(cfg, DEV, mesh=mesh, par=make_parallel_config(
            mesh, shape, schedule="balanced"))
        params = trainable(model.init(seed=P24_SEED))
        b0 = SyntheticTokens(cfg, shape, device=DEV, seed=0, mesh=mesh,
                             par=model.par).batch(0)
        one = torch.load(os.path.join(tmp, f"p1_{dt}.pt"))
        names, ref = one["names"], [g.to(DEV) for g in one["grads"]]
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        loss, grads = _p24_step(cfg, params, b0, model)
        torch.cuda.synchronize()
        r = {"sec": time.perf_counter() - t0, "loss": loss,
             "loss1": one["loss"], "grad_err": _worst_leaf(grads, ref, names),
             "launches": {k: build.LAUNCHES[k] for k in BWD_KERNELS},
             "frames": tuple(b0["frames"].shape),
             "tokens": tuple(b0["tokens"].shape)}
        if dt == "float32":
            model.token_group.all_reduce_(
                [g for g, n in zip(grads, names)
                 if n.startswith("/enc_layers") or n == "/ln_enc"])
            r["fault"] = _worst_leaf(grads, ref, names)
        out[dt] = r
        del model, params, grads, ref
        _free()
    out["comm_s"] = _process_comm_seconds()
    return out


def _p24_serve(cfg):
    """(d): ``FixedSlotEngine`` on P24_REQS requests of 1,536 frames and
    64-token prompts, P24_NEW greedy tokens: every step's logits held to
    the plain forward; the control: a causal mask on the cross-attention,
    teacher-forced."""
    model = TF.EncDecLM(cfg, DEV)
    params = model.init(seed=P24_SEED)
    rng = np.random.default_rng(P24_SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
        P24_REQS, P24_PROMPT)).astype(np.int32)).to(DEV)
    frames = torch.from_numpy(rng.standard_normal(
        (P24_REQS, cfg.n_audio_frames, cfg.d_model)).astype(
            np.float32)).to(DEV, model.dtype)
    batch = {"tokens": toks, "frames": frames}
    eng = FixedSlotEngine(model, params)
    eng.generate(batch, 2)                      # warm-up
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _recorded(model) as logs:
        gen, _ = eng.generate(batch, P24_NEW)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = build.LAUNCHES["flash_fwd"]
    ref = model.forward(params, torch.cat([toks, gen], dim=1),
                        frames=frames)[:, P24_PROMPT - 1:].float().cpu()
    ref = ref.transpose(0, 1)                   # (steps, B, V)
    err = _step_err(logs, ref)
    _causal_cross(model)
    with _recorded(model, forced=gen) as bad:
        eng.generate(batch, P24_NEW)
    del model.cross_mask
    ctl = _step_err(bad, ref)
    del model, params, eng
    _free()
    return dict(err=err, ctl=ctl, sec=sec, launches=launches)


def whisper():
    """Phase 24: whisper-tiny at full size (4 encoder + 4 decoder layers,
    d_model 384, 6 heads × 64, vocab 51,865, 1,536 frames), bf16, nothing
    cut.  (0) :func:`whisper_kernels`.  (a) 2 training steps at P = 1,
    B 2, decoder T 4,096 beside 1,536 frames, remat_aware (the encoder
    layers checkpointed whole, the decoder's self- and cross-attention
    remat-aware), seed 24: finite losses; A 16, C and D 12 launches a
    step.  (b) its gradients against the plain attention path
    (:func:`_grads_vs_plain`; controls: a shifted backward, a causal
    cross-attention).  (c) 4 ``cuda-ipc`` ranks of 1,024 decoder tokens
    each, the encoder whole on every rank, step 1 held to one process's
    in bf16 (against (b)'s kernel gradients) and in float32 (the float32
    routes): the loss within 2^-8 in both; every summed leaf within 5% of
    max |g| in float32, read in bf16 (the per-rank bf16 partial sums
    round apart from one process's: PERF.md §6); the control, in
    float32: the encoder's gradients summed twice.  (d)
    :func:`_p24_serve`."""
    cfg = get_config(P24_ARCH)
    a = cfg.attn
    out = {"launches": dict.fromkeys(BWD_KERNELS, 0)}
    t0 = time.perf_counter()
    out["rows"] = whisper_kernels(cfg)
    say(f"  (0) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    say(f"  (a) {cfg.name}: {cfg.n_enc_layers} encoder + {cfg.n_layers} "
        f"decoder layers, d_model {cfg.d_model}, {a.n_heads} heads × "
        f"{a.head_dim}, vocab {cfg.vocab} ({cfg.param_count() / 1e6:.1f} M "
        f"params), B {P24_B}, {cfg.n_audio_frames} frames, decoder T "
        f"{P24_T}, bf16, remat_aware")
    tc = TrainConfig(lr=1e-4, warmup_steps=1, total_steps=P24_STEPS)
    ds = SyntheticTokens(cfg, ShapeSpec("chip24", P24_T, P24_B, "train"),
                         device=DEV, seed=0)
    batches = [ds.batch(i) for i in range(P24_STEPS)]
    runs, launches, peak, _ = _train_policy(cfg, "remat_aware", batches, tc,
                                            seed=P24_SEED)
    for i, (m, sec) in enumerate(runs):
        check(m["skipped_nonfinite"] == 0 and np.isfinite(m["loss"]),
              f"{cfg.name} step {i + 1}: loss {m['loss']}")
        say(f"  (a) step {i + 1}: loss {m['loss']:.4f} gnorm "
            f"{m['gnorm']:.3f} step {sec:.3f} s")
    want = {"flash_fwd": 2 * (cfg.n_enc_layers + cfg.n_layers),
            "flash_bwd_dq": cfg.n_enc_layers + 2 * cfg.n_layers,
            "flash_bwd_dkv": cfg.n_enc_layers + 2 * cfg.n_layers}
    for k in BWD_KERNELS:
        check(launches[k] == want[k] * P24_STEPS, f"{cfg.name}: {k} "
              f"launched {launches[k]} times, want {want[k]} a step")
        out["launches"][k] += launches[k]
    tok_s = (P24_STEPS - 1) * P24_B * P24_T / sum(s for _, s in runs[1:])
    say(f"  (a) {tok_s:.1f} decoder tokens/s over steps 2-{P24_STEPS}, peak "
        f"memory {peak / 2**30:.2f} GiB; launches "
        + ", ".join(f"{k} {launches[k]}" for k in BWD_KERNELS)
        + f"; {time.perf_counter() - t0:.1f} s")
    out.update(tok_s=tok_s, peak=peak, step_s=[s for _, s in runs],
               losses=[m["loss"] for m, _ in runs])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        loss1, g1, names = _grads_vs_plain(
            cfg, batches[0], P24_SEED, "(b) full size, step 1:",
            faults=(("causal cross-attention", _causal_cross),))
        torch.save({"loss": loss1, "grads": [g.cpu() for g in g1],
                    "names": names}, os.path.join(tmp, "p1_bfloat16.pt"))
        del g1, batches
        _free()
        say(f"  (b) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        _p24_one(cfg, tmp)
        res = spawn(_p24_rank, P24_RANKS, (tmp,), device=DEV,
                    timeout=P24_TIMEOUT, threads=2)
    res.sort(key=lambda r: r["rank"])
    _say_comm(24, res)
    for r in res:
        for dt in ("bfloat16", "float32"):
            x = r[dt]
            d = abs(x["loss"] - x["loss1"]) / abs(x["loss1"])
            say(f"  (c) rank {r['rank']} {dt}: tokens {x['tokens']}, frames "
                f"{x['frames']}; step 1 loss {x['loss']:.6f} relative |Δ| "
                f"{d:.3e} (limit {P15_TOL:.3e}); worst leaf "
                f"{x['grad_err'][0]:.4f} ({x['grad_err'][1]}"
                + (f"; limit {GRAD_REL_TOL}" if dt == "float32" else
                   "; read") + f"); step {x['sec']:.3f} s; launches "
                + ", ".join(f"{k} {x['launches'][k]}" for k in BWD_KERNELS)
                + (f"; encoder summed twice: worst leaf "
                   f"{x['fault'][0]:.4f} ({x['fault'][1]})"
                   if "fault" in x else ""))
            check(d <= P15_TOL, f"(c) rank {r['rank']} {dt}: loss vs P = 1")
            check(x["frames"] == (P24_B, cfg.n_audio_frames, cfg.d_model),
                  f"(c) rank {r['rank']}: frames {x['frames']}")
            check(all(x["launches"][k] > 0 for k in BWD_KERNELS),
                  f"(c) rank {r['rank']}: launches {x['launches']}")
        x = r["float32"]
        check(x["grad_err"][0] <= GRAD_REL_TOL,
              f"(c) rank {r['rank']} float32: {x['grad_err']}")
        check(x["fault"][0] > GRAD_REL_TOL,
              f"(c) rank {r['rank']}: the encoder summed twice passes")
        for k in BWD_KERNELS:
            out["launches"][k] += r["bfloat16"]["launches"][k]
    say(f"  (c) {time.perf_counter() - t0:.1f} s, spawn included")
    t0 = time.perf_counter()
    sv = _p24_serve(cfg)
    say(f"  (d) FixedSlotEngine, {P24_REQS} requests of "
        f"{cfg.n_audio_frames} frames and {P24_PROMPT}-token prompts, "
        f"{P24_NEW} greedy tokens in {sv['sec']:.3f} s; logits "
        f"{sv['err']:.4e} of max |logit| off the plain forward (limit "
        f"{LOGIT_REL_TOL}); control, a causal cross-attention "
        f"{sv['ctl']:.4e} "
        f"({'rejected' if sv['ctl'] > LOGIT_REL_TOL else 'NOT rejected'}); "
        f"flash_fwd launches {sv['launches']}; "
        f"{time.perf_counter() - t0:.1f} s")
    check(sv["err"] <= LOGIT_REL_TOL, f"(d) logits {sv['err']}")
    check(sv["ctl"] > LOGIT_REL_TOL, "(d) the causal cross-attention passes")
    check(sv["launches"] >= cfg.n_layers * P24_NEW, "(d) the decode's "
          f"cross-attention launched A {sv['launches']} times")
    out["launches"]["flash_fwd"] += sv["launches"]
    out["serve"], out["ranks"] = sv, res
    return out


# ---------------------------------------------------------------- phase 25

P25_ARCH, P25_SEED = "deepseek-v3-671b", 25
P25_LAYERS = 2          # the dense layer 0 and one MoE layer, of 61
P25_EXPERTS = 16        # routed experts in training, of 256 (top-8 kept)
P25_T, P25_STEPS = 4096, 3      # (a): one sequence a step
# (a)'s gate: the plain path holds (128, T, T) float32 scores, 2.1 GB at
# T 2,048 (8.6 GB at 4,096)
P25_GRAD_T = 2048
# (b) and (c): 2,048 tokens a rank; at 4,096 a rank each rank's two
# vocab-wide heads hold ~6 GB of float32 logits beside its 9.7 GB of
# parameters and gradients, and four ranks leave no room on the card
P25_RANKS, P25_RANK_T = 4, 8192
P25_MESHES = ((4, 1), (2, 2))   # (seq, head)
P25_EDGE = 64           # the shard-edge gate's positions a shard
P25_TIMEOUT = 600
# each rank's share of the card, and the allocator setting of the world:
# large blocks are not split, so a rank's cache fragments less
P25_RANK_MEM = 0.235
P25_ALLOC = "max_split_size_mb:512"
P25_CTL_NEW = 4         # tokens a request in the control's runs
P25_B_LENS = (1000, 1000, 1000, 1000)   # (e): kernel B's latent step
# kernels A, C and D's pair route at deepseek-v3's 128 heads
V3_DIMS = (128, PAIR_DK, PAIR_DV, LAT_SCALE)


def _p25_cfg(experts=None):
    """deepseek-v3-671b at full width, depth cut to ``P25_LAYERS`` of 61
    (the dense layer 0 and one MoE layer) beside its MTP block, with
    ``experts`` routed experts: 256, the config's, for serving, at its
    capacity factor; fewer for training, at capacity factor E / k, so no
    (token, expert) pair can drop (DeepSeek-V3 trains without dropping
    tokens) and one process and any layout of ranks dispatch alike."""
    cfg = get_config(P25_ARCH)
    m = cfg.moe
    experts = experts or P25_EXPERTS
    moe = dataclasses.replace(m, n_dense_layers=1, n_routed=experts)
    if experts != m.n_routed:
        moe = dataclasses.replace(moe, capacity_factor=experts / m.top_k)
    return cfg.replace(n_layers=P25_LAYERS, moe=moe)


@contextlib.contextmanager
def _p25_fault(model, kind):
    """A planted fault of the MTP block's shift (``DecoderLM._next_rows``:
    its t + 1 rows and labels) while the block runs: ``"t_plus_1"`` — the
    labels left unshifted (the block predicts t + 1, not t + 2);
    ``"local"`` — each rank rolling its own shard, no shift across ranks;
    ``"seq_only"`` — on a 2D mesh the shift over ``seq`` alone instead of
    the (seq, head) pair's sequence order."""
    from repro_torch.parallel.comm import shift as comm_shift
    right, g = model._next_rows, model.seq_group

    def ended(out, labels):
        if labels and (g is None or g.rank == g.size - 1):
            out[:, -1] = -100
        return out

    def t_plus_1(x, labels=False):
        return x.clone() if labels else right(x)

    def local(x, labels=False):
        return ended(torch.cat([x[:, 1:], x[:, :1]], dim=1), labels)

    def seq_only(x, labels=False):
        s = model.mesh.comms[model.par.seq_axis]
        nxt = (s.shift([x[:, :1]], -1).wait()[0] if labels
               else comm_shift(s, x[:, :1], -1))
        return ended(torch.cat([x[:, 1:], nxt], dim=1), labels)
    model._next_rows = {"t_plus_1": t_plus_1, "local": local,
                        "seq_only": seq_only}[kind]
    try:
        yield
    finally:
        del model._next_rows


@contextlib.contextmanager
def _mtp_rows(model, rows):
    """While the block runs, the MTP head's logits (each ``loss``'s second
    cross-entropy) at this rank's positions ``rows``, in float32, appended
    to the list it yields."""
    got, base, n = [], model._ce, [0]

    def ce(logits, labels):
        n[0] += 1
        if n[0] % 2 == 0:
            got.append(logits[:, rows].detach().float())
        return base(logits, labels)
    model._ce = ce
    try:
        yield got
    finally:
        del model._ce


def _metrics(loss, met):
    out = {k: float(v.detach()) for k, v in met.items()}
    out["loss"] = float(loss.detach())
    return out


def _p25_train(cfg):
    """(a) at one rank: step 1's loss and every gradient leaf at T
    ``P25_GRAD_T`` through kernels A, C and D against the plain attention
    replaying the kernel run's experts (the MTP block's leaves read apart),
    MTP labels of t + 1 rejected; then ``P25_STEPS`` AdamW steps of
    ``P25_T`` tokens under remat_aware."""
    m = cfg.moe
    sites = cfg.n_layers + cfg.mtp_depth      # attention calls a pass
    b = SyntheticTokens(cfg, ShapeSpec("chip25", P25_GRAD_T, 1, "train"),
                        device=DEV, seed=0).batch(0)
    base = DecoderLM(cfg, DEV).init(seed=P25_SEED)
    names = _leaf_names(base)
    mtp = [i for i, n in enumerate(names) if n.startswith("/mtp/")]
    say(f"  (a) {sum(t.numel() for t in leaves(base)) / 1e9:.3f} B "
        f"parameters with the MTP block's "
        f"{sum(t.numel() for t in leaves(base['mtp'])) / 1e9:.3f} B")
    check(len(mtp) == len(leaves(base["mtp"])), "the MTP block's leaves")

    def grads(impl, router, fault=None):
        model = DecoderLM(cfg, DEV, impl=impl)
        params = trainable(base)
        with router, (_p25_fault(model, fault) if fault
                      else contextlib.nullcontext()):
            loss, met = model.loss(params, b)
            g = torch.autograd.grad(loss, leaves(params))
        torch.cuda.synchronize()
        return _metrics(loss, met), g

    build.reset_launches()
    rk = _Router()
    mk_, g_k = grads(None, rk)
    got = {k: build.LAUNCHES[k] for k in P14_KERNELS}
    check(all(got[k] == sites for k in P14_KERNELS), f"(a) step 1 "
          f"launches {got}, want {sites} each (2 layers and the MTP block)")
    rr = _Router(calls=rk.seen)
    mr, g_r = grads("ref", rr)
    check(len(rr.seen) == len(rk.seen) and all(
        torch.equal(x, y) for x, y in zip(rr.seen, rk.seen)),
        "(a) the plain run did not replay every expert choice")
    err, leaf = _worst_leaf(g_k, g_r, names)
    err_m, leaf_m = _worst_leaf([g_k[i] for i in mtp], [g_r[i] for i in mtp],
                                [names[i] for i in mtp])
    del g_k
    mf, g_f = grads(None, _Router(calls=rk.seen), "t_plus_1")
    bad, bad_leaf = _worst_leaf(g_f, g_r, names)
    del g_f, g_r, base
    _free()
    d_loss = abs(mk_["loss"] - mr["loss"])
    say(f"  (a) step 1 at T {P25_GRAD_T} (remat_aware, {len(rk.seen)} MoE "
        f"routings): kernels loss {mk_['loss']:.6f} ce {mk_['ce']:.6f} aux "
        f"{mk_['aux']:.6e} mtp_ce {mk_['mtp_ce']:.6f}; plain attention "
        f"replaying the experts loss {mr['loss']:.6f} mtp_ce "
        f"{mr['mtp_ce']:.6f}; |Δloss| {d_loss:.3e} (limit "
        f"{P14_LOSS_TOL:.3e} of |loss|), |Δmtp_ce| "
        f"{abs(mk_['mtp_ce'] - mr['mtp_ce']):.3e}; launches {got}")
    say(f"  (a) worst gradient leaf max|Δg| / max|g| over {len(names)} "
        f"leaves: {err:.4f} ({leaf}; limit {GRAD_REL_TOL}), over the MTP "
        f"block's {len(mtp)}: {err_m:.4f} ({leaf_m}); control, MTP labels "
        f"of t + 1: {bad:.4f} ({bad_leaf}), mtp_ce {mf['mtp_ce']:.6f}")
    check(d_loss <= P14_LOSS_TOL * abs(mr["loss"]), f"(a) step 1 loss "
          f"{mk_['loss']} vs plain {mr['loss']}")
    check(err <= GRAD_REL_TOL, f"(a) kernel grads vs plain: {leaf} {err}")
    check(bad > GRAD_REL_TOL, f"(a) the gradient limit does not reject MTP "
          f"labels of t + 1 ({bad_leaf} {bad})")
    ds = SyntheticTokens(cfg, ShapeSpec("chip25", P25_T, 1, "train"),
                         device=DEV, seed=0)
    batches = [ds.batch(i) for i in range(P25_STEPS)]
    tc = TrainConfig(lr=1e-4, warmup_steps=1, total_steps=P25_STEPS)
    runs, launches, peak, _ = _train_policy(cfg, "remat_aware", batches, tc,
                                            seed=P25_SEED,
                                            kernels=P14_KERNELS)
    for i, (mt, sec) in enumerate(runs):
        check(mt["skipped_nonfinite"] == 0 and all(
            np.isfinite(mt[k]) for k in ("loss", "ce", "aux", "mtp_ce")),
            f"(a) step {i + 1}: {mt}")
        say(f"  (a) step {i + 1}: loss {mt['loss']:.4f} ce {mt['ce']:.4f} "
            f"aux {mt['aux']:.6e} mtp_ce {mt['mtp_ce']:.4f} gnorm "
            f"{mt['gnorm']:.3f} step {sec:.3f} s")
    for k in P14_KERNELS:
        check(launches[k] == sites * P25_STEPS, f"(a) {k} launched "
              f"{launches[k]} times, want {sites} a step")
    tok_s = (P25_STEPS - 1) * P25_T / sum(sec for _, sec in runs[1:])
    say(f"  (a) {tok_s:.1f} tokens/s over steps 2-{P25_STEPS}; launches a "
        "step " + ", ".join(f"{k} {launches[k] // P25_STEPS}"
                            for k in P14_KERNELS)
        + f"; peak memory {peak / 2**30:.2f} GiB")
    return dict(launches=launches, err=err, err_mtp=err_m, ctl=bad,
                d_loss=d_loss, tok_s=tok_s, peak=peak,
                losses=[mt["loss"] for mt, _ in runs],
                step_s=[sec for _, sec in runs])


def _dropless_capacity(cfg, calls, splits):
    """The least capacity factor (a multiple of 1/64) at which no (token,
    expert) pair of the recorded routing ``calls`` drops when each call's
    rows are dispatched in ``split`` equal blocks, for every split of
    ``splits``."""
    m, cf = cfg.moe, 0.0
    for split in splits:
        for c in calls:
            n = c.shape[0] // split
            for j in range(split):
                load = int(torch.bincount(c[j * n:(j + 1) * n].reshape(-1),
                                          minlength=m.n_routed).max())
                cf = max(cf, load * m.n_routed / (n * m.top_k))
    return -(-cf * 64 // 1) / 64


def _p25_one(cfg, tmp):
    """(b) and (c)'s one process: ``P25_RANK_T`` tokens through the kernels
    on the seed-25 weights, its MTP logits at every shard's last
    ``P25_EDGE`` positions (the ranks' shards: 4 of ``P25_RANK_T / 4``, on
    both meshes), saved with its loss, ce, aux, mtp_ce and expert choices
    at ``tmp/one.pt``, its gradients at ``tmp/grads1.pt``; and the least
    capacity factor at which the ranks' dispatches of its routing drop no
    pair (:func:`_dropless_capacity`; their MoE buffers shrink with it)."""
    one = DecoderLM(cfg, DEV)
    params = trainable(one.init(seed=P25_SEED))
    b0 = SyntheticTokens(cfg, ShapeSpec("chip25r", P25_RANK_T, 1, "train"),
                         device=DEV, seed=0).batch(0)
    n = P25_RANK_T // P25_RANKS
    edges = torch.cat([torch.arange((p + 1) * n - P25_EDGE, (p + 1) * n)
                       for p in range(P25_RANKS)]).to(DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rk = _Router()
    with rk, _mtp_rows(one, edges) as lg:
        loss, met = one.loss(params, b0)
        gs = torch.autograd.grad(loss, leaves(params))
    first = _metrics(loss, met)
    peak = torch.cuda.max_memory_allocated()
    del loss, met
    torch.save([g.cpu() for g in gs], os.path.join(tmp, "grads1.pt"))
    del gs
    cf = _dropless_capacity(cfg, rk.seen, [r for r, _ in P25_MESHES])
    torch.save({"calls": [c.cpu() for c in rk.seen], "edges": lg[0].cpu(),
                "first": first, "capacity_factor": cf},
               os.path.join(tmp, "one.pt"))
    names = _leaf_names(params)
    del one, params, rk, lg
    _free()
    return first, peak, names, cf


def _p25_mesh(rank, mesh, cfg, shape, one, ref_all):
    """One mesh of the world: step 1's loss, ce, aux, mtp_ce and summed
    gradients replaying the one process's expert choices, held to its on
    the card (:func:`_p15_grad_err`), the MTP logits at this shard's last
    ``P25_EDGE`` positions against its; on the 1D mesh a step asked for as
    zigzag; the planted shift fault of the mesh, forward only."""
    par = make_parallel_config(mesh, shape, schedule="balanced")
    two_d = par.head_axis is not None and mesh.size(par.head_axis) > 1
    model = DecoderLM(cfg, DEV, mesh=mesh, par=par)
    params = trainable(model.init(seed=P25_SEED))
    data = SyntheticTokens(cfg, shape, device=DEV, seed=0, mesh=mesh,
                           par=par)
    b0 = data.batch(0)
    s, r = mesh.coord(par.seq_axis), mesh.size(par.seq_axis)
    n = P25_RANK_T // r              # the MoE rows seq shard s dispatches
    calls = [c[s * n:(s + 1) * n].to(DEV) for c in one["calls"]]
    shard, n_loc = model.seq_rank, b0["tokens"].shape[1]
    ref_e = one["edges"][:, shard * P25_EDGE:(shard + 1) * P25_EDGE].to(DEV)
    names = _leaf_names(params)
    out = {"seq": s, "shard": shard, "tokens": n_loc,
           "expert_rows": (params["moe_layers"][0]["moe"]["wg"].shape[0],
                           params["mtp"]["layer"]["moe"]["wg"].shape[0])}

    def run(m, batch, fault=None, grad=True):
        rr, kp = _Router(calls=calls), _Keep()
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        with rr, kp, (_p25_fault(m, fault) if fault
                      else contextlib.nullcontext()), \
                _mtp_rows(m, slice(-P25_EDGE, None)) as lg, \
                (contextlib.nullcontext() if grad else torch.no_grad()):
            loss, met = m.loss(params, batch)
            g = torch.autograd.grad(loss, leaves(params)) if grad else None
        torch.cuda.synchronize()
        got = dict(first=_metrics(loss, met),
                   sec=time.perf_counter() - t0,
                   edge=float((lg[0] - ref_e).abs().max()
                              / ref_e.abs().max()),
                   launches={k: build.LAUNCHES[k] for k in P14_KERNELS},
                   dropped=sum(int((~k).sum()) for k in kp.seen),
                   replayed=all(torch.equal(a, c) for a, c in
                                zip(rr.seen, calls))
                   and len(rr.seen) == (len(calls) if grad
                                        else len(calls) // 2))
        return got, g

    torch.cuda.reset_peak_memory_stats()
    res, raw = run(model, b0)
    from repro_torch.train.step import sum_grads
    grads, sharded = sum_grads(model, params, raw)     # in place
    del raw
    _free()
    ref = [TF.expert_rows(cfg, x, model.expert_group) if sh
           else (x if rank == 0 else None)
           for x, sh in zip(ref_all, sharded)]
    res["grad_err"] = _p15_grad_err(model, grads, sharded, ref, names)
    del grads, ref
    res["peak"] = torch.cuda.max_memory_allocated()
    out["balanced"] = res
    _free()
    if not two_d:
        zpar = make_parallel_config(mesh, shape, schedule="zigzag")
        mz = DecoderLM(cfg, DEV, mesh=mesh, par=zpar)
        bz = SyntheticTokens(cfg, shape, device=DEV, seed=0, mesh=mesh,
                             par=zpar).batch(0)
        res, gz = run(mz, bz)
        del gz
        res["contiguous"] = bool(torch.equal(
            mz.positions(n_loc).cpu(),
            torch.arange(shard * n_loc, (shard + 1) * n_loc)))
        res["same_tokens"] = bool(torch.equal(bz["tokens"], b0["tokens"]))
        out["zigzag"] = res
        _free()
    fault = "seq_only" if two_d else "local"
    out["fault"], _ = run(model, b0, fault, grad=False)
    out["fault"]["name"] = fault
    out["comm_s"] = _comm_seconds(list({
        id(c): c for c in (*mesh.comms.values(), mesh.world)}.values()))
    del params, model
    _free()
    return out


def _p25_rank(rank, tmp):
    """One rank of (b) and (c)'s world: :func:`_p25_mesh` on the
    (seq, head) = (4, 1) mesh, then on (2, 2).  Each rank keeps to its
    quarter of the card (``P25_RANK_MEM``), so its allocator returns its
    cached blocks before it takes memory another rank needs."""
    if DEV.type == "cuda":
        torch.cuda.set_per_process_memory_fraction(P25_RANK_MEM)
    shape = ShapeSpec("chip25r", P25_RANK_T, 1, "train")
    one = torch.load(os.path.join(tmp, "one.pt"))
    cfg = _p25_cfg()
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=one["capacity_factor"]))
    ref_all = torch.load(os.path.join(tmp, "grads1.pt"), mmap=True)
    out = {"rank": rank}
    for r, u in P25_MESHES:
        mesh = (make_local_mesh(seq=r, device=DEV) if u == 1
                else make_seq2d_mesh(r, u, device=DEV))
        out[(r, u)] = _p25_mesh(rank, mesh, cfg, shape, one, ref_all)
        out["transport"] = mesh.transport
        del mesh
        _free()
    out["comm_s"] = {k: sum(out[m]["comm_s"][k] for m in P25_MESHES)
                     for k in ("shift", "a2a", "reduce")}
    return out


def _p25_ranks(cfg):
    """(b) 4 cuda-ipc ranks on (seq, head) = (4, 1) and (c) on (2, 2),
    ``P25_RANK_T`` tokens, balanced, held to one process on the same
    weights, tokens and expert choices: the loss, aux and mtp_ce within
    2^-8, every summed gradient leaf within 5% of max |g|, the MTP logits
    at every shard's last 64 positions within 5% of max |logit| (the
    shard-edge gate, which each mesh's planted shift fault must miss); a
    step asked for as zigzag runs balanced on contiguous tokens."""
    m, a = cfg.moe, cfg.attn
    sites = cfg.n_layers + cfg.mtp_depth
    n_loc = P25_RANK_T // P25_RANKS
    say(f"  (b, c) {P25_RANK_T} tokens ({n_loc} a rank; at 4,096 a rank "
        f"the four ranks' two vocab-wide heads and gradients do not fit "
        f"the card), experts {m.n_routed // P25_MESHES[0][0]} a rank on "
        f"(4, 1) and {m.n_routed // P25_MESHES[1][0]} a seq rank on (2, 2), "
        "no optimizer state")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        first, peak1, names, cf = _p25_one(cfg, tmp)
        free, total = (torch.cuda.mem_get_info() if DEV.type == "cuda"
                       else (0, 0))
        say(f"  (b, c) P = 1 ({time.perf_counter() - t0:.1f} s, saves "
            f"included; peak {peak1 / 2**30:.2f} GiB): loss "
            f"{first['loss']:.6f} ce {first['ce']:.6f} aux "
            f"{first['aux']:.6e} mtp_ce {first['mtp_ce']:.6f}; the ranks "
            f"dispatch its routing at capacity factor {cf:g}, the least "
            f"at which none of their pairs drops; the card has "
            f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free")
        t0 = time.perf_counter()
        saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = P25_ALLOC
        try:
            res = spawn(_p25_rank, P25_RANKS, (tmp,), device=DEV,
                        timeout=P25_TIMEOUT, threads=2)
        finally:
            if saved is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
        wall = time.perf_counter() - t0
    res.sort(key=lambda r: r["rank"])
    _say_comm(25, res)
    check(all(r["transport"] == P8_TRANSPORT for r in res),
          f"transport {[r['transport'] for r in res]}")

    def rel(x, y):
        return abs(x - y) / abs(y)
    p2 = sp.build_plan2d("balanced", mk.causal(), *P25_MESHES[1],
                         n_loc, Hq=a.n_heads, Hkv=a.n_heads)
    plan1 = _plan_launches("balanced", P25_RANKS, P25_RANK_T)
    launches = dict.fromkeys(P14_KERNELS, 0)
    out = {}
    for (r, u), tag in zip(P25_MESHES, ("b", "c")):
        xs = [x[(r, u)] for x in res]
        bal = [x["balanced"] for x in xs]
        f0 = bal[0]["first"]
        d = {k: rel(f0[k], first[k]) for k in ("loss", "aux", "mtp_ce")}
        err, leaf = bal[0]["grad_err"]
        edge = max(b["edge"] for b in bal)
        ctl = max(x["fault"]["edge"] for x in xs)
        say(f"  ({tag}) (seq, head) = ({r}, {u}): loss {f0['loss']:.6f} ce "
            f"{f0['ce']:.6f} aux {f0['aux']:.6e} mtp_ce {f0['mtp_ce']:.6f}; "
            "relative |Δ| vs P = 1: " + ", ".join(
                f"{k} {v:.3e}" for k, v in d.items())
            + f" (limit {P15_TOL:.3e}); worst gradient leaf max|Δg| / "
            f"max|g| {err:.4f} ({leaf}; limit {GRAD_REL_TOL}); MTP logits "
            f"at the shards' last {P25_EDGE} positions, worst shard "
            f"{edge:.4e} of max |logit| (limit {LOGIT_REL_TOL}); control "
            f"{xs[0]['fault']['name']}: edges {ctl:.4e}, loss "
            f"{xs[0]['fault']['first']['loss']:.6f}")
        check(all(v <= P15_TOL for v in d.values()), f"({tag}) vs P = 1: "
              f"{d}")
        check(len({b["first"]["loss"] for b in bal}) == 1,
              f"({tag}) the ranks' losses disagree")
        check(all(b["replayed"] for b in bal), f"({tag}) a rank did not "
              "replay every expert choice")
        check(all(x["dropped"] == 0 for x in bal + [x["fault"] for x in xs]
                  + [x["zigzag"] for x in xs if "zigzag" in x]),
              f"({tag}) a rank dropped (token, expert) pairs")
        check(err <= GRAD_REL_TOL, f"({tag}) gradients vs P = 1: {leaf} "
              f"{err}")
        check(edge <= LOGIT_REL_TOL, f"({tag}) shard-edge MTP logits {edge}")
        check(ctl > LOGIT_REL_TOL, f"({tag}) the shard-edge gate does not "
              f"reject {xs[0]['fault']['name']} ({ctl})")
        for x in xs:
            ex = m.n_routed // r
            check(x["expert_rows"] == (ex, ex), f"({tag}) rank expert rows "
                  f"{x['expert_rows']}, want {ex}")
            check(x["tokens"] == n_loc, f"({tag}) tokens {x['tokens']}")
            if u == 1:
                want = (sites * plan1[x["shard"]],) * 2
            else:
                want = (sites * _p18_calls(p2.inner, x["seq"]),
                        sites * _p18_calls(p2.inner, x["seq"], True))
            got = x["balanced"]["launches"]
            check(want[0] > 0 and got["flash_fwd_pair"] == want[0]
                  and got["flash_bwd_dq"] == got["flash_bwd_dkv"] == want[1],
                  f"({tag}) rank {x['shard']}: launches {got}, want A "
                  f"{want[0]}, C/D {want[1]}")
            for k in P14_KERNELS:
                launches[k] += got[k]
            say(f"  ({tag}) shard {x['shard']}: step {x['balanced']['sec']:.3f}"
                f" s, peak {x['balanced']['peak'] / 2**30:.2f} GiB, launches "
                f"A/C/D {want[0]}/{want[1]}/{want[1]}, edge "
                f"{x['balanced']['edge']:.4e}, control edge "
                f"{x['fault']['edge']:.4e}")
        if u == 1:
            zz = [x["zigzag"] for x in xs]
            same = all(z["first"]["loss"] == b["first"]["loss"]
                       for z, b in zip(zz, bal))
            check(all(z["contiguous"] and z["same_tokens"] for z in zz),
                  "(b) zigzag asked: the tokens are not the contiguous "
                  "shards")
            check(all(z["launches"] == b["launches"] for z, b in
                      zip(zz, bal)) and all(z["replayed"] for z in zz),
                  "(b) zigzag asked did not run balanced's kernel calls")
            check(rel(zz[0]["first"]["loss"], first["loss"]) <= P15_TOL,
                  f"(b) zigzag asked: loss {zz[0]['first']['loss']}")
            say(f"  (b) a step asked for as zigzag ran balanced on "
                f"contiguous tokens: loss {zz[0]['first']['loss']:.6f} "
                f"({'bitwise' if same else 'not bitwise'} balanced's), the "
                f"same kernel calls a rank")
            for z in zz:
                for k in P14_KERNELS:
                    launches[k] += z["launches"][k]
        out[tag] = dict(d=d, grad_err=err, edge=edge, ctl=ctl)
    say(f"  (b, c) world of {P25_RANKS} ranks: {wall:.1f} s, spawn included")
    out.update(launches=launches, peak1=peak1, wall=wall)
    return out


def _key_err(got, ref, show=0):
    """Worst over the keys both hold of max |Δ| / max |ref| of a row, and
    the number of rows; with ``show``, the rows over LOGIT_REL_TOL and
    the ``show`` worst (request, position) keys are printed."""
    keys = [k for k in ref if k in got]
    check(keys, "no logits row in common")
    errs = {k: float((got[k].float() - ref[k].float()).abs().max()
                     / ref[k].float().abs().max()) for k in keys}
    if show:
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:show]
        say(f"    rows over {LOGIT_REL_TOL}: "
            f"{sum(e > LOGIT_REL_TOL for e in errs.values())} of "
            f"{len(errs)}; worst (request, position): " + ", ".join(
                f"{k} {e:.4e}" for k, e in worst))
    return max(errs.values()), len(keys)


def _p25_serve():
    """(d) deepseek-v3-671b at full width, 2 of 61 layers, all 256 routed
    experts, its MTP block loaded and unused, bf16, seed 25: the paged
    Engine (kernel A's latent route for the chunks, kernel B over the
    latent pool: 128 query heads on one latent head) and FixedSlotEngine
    (A's pair route for the whole-prompt prefill) serve phase 4's prompts,
    32 greedy tokens; every decode step's logits within 5% of max |logit|
    of the same engine on the plain versions replaying the kernel run's
    expert choices, teacher-forced; the control, each decode one position
    early, rejected."""
    cfg = _p25_cfg(get_config(P25_ARCH).moe.n_routed)
    m, a = cfg.moe, cfg.attn
    model = DecoderLM(cfg, device=DEV)
    t0 = time.perf_counter()
    params = model.init(seed=P25_SEED)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in leaves(params))
    n_mtp = sum(t.numel() for t in leaves(params["mtp"]))
    check("mtp" in params and n_mtp > 0, "the MTP block is not loaded")
    say(f"  (d) {cfg.name}: {cfg.n_layers} layers ({m.n_dense_layers} dense, "
        f"d_ff {m.d_dense_ff}, + {cfg.n_layers - m.n_dense_layers} MoE of "
        f"{m.n_routed} routed + {m.n_shared} shared top-{m.top_k}, d_expert "
        f"{m.d_expert}, capacity {m.capacity_factor}) and the MTP block, "
        f"d_model {cfg.d_model}, MLA {a.n_heads} heads q_lora "
        f"{a.q_lora_rank} kv_lora {a.kv_lora_rank}, vocab {cfg.vocab}, "
        f"{n_par / 1e9:.3f} B parameters ({n_mtp / 1e9:.3f} B in the MTP "
        f"block, loaded and unused), made on the card in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    rng = np.random.default_rng(P25_SEED)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in P4_LENS]
    warm = Engine(model, params, **P4_ENGINE)
    warm.submit(prompts[3][:P10_WARM], max_new_tokens=2)
    warm.run()
    FixedSlotEngine(model, params).generate(
        {"tokens": prompts[3][None, :P10_WARM]}, 2)
    del warm
    _free()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    # the paged Engine
    greedy = [0.0] * len(prompts)

    def paged(m, router, forced=None, n_new=P4_NEW):
        with router:
            return _p9_run(m, params, prompts, greedy, P4_ENGINE, n_new,
                           router=router, forced=forced)
    build.reset_launches()
    rk = _Router()
    van = paged(model, rk)
    lp = dict(build.LAUNCHES)
    check(van["eng"].cache.layout == "mla", "the engine's pool is not "
          "latent")
    check(lp["flash_fwd_latent"] > 0 and lp["paged_decode"] > 0
          and lp["flash_fwd"] == lp["flash_fwd_pair"] == 0,
          f"(d) paged Engine launches {lp}")
    for i, o in enumerate(van["out"]):
        check(len(o) == P4_NEW and bool(((o >= 0) & (o < cfg.vocab)).all()),
              f"(d) request {i}: {o}")
    st = van["st"]
    pf, dc = st["prefill_seconds"], st["decode_seconds"]
    forced = {(i, len(p) + j): int(t) for i, p in enumerate(prompts)
              for j, t in enumerate(van["out"][i])}
    plain = DecoderLM(cfg, device=DEV, impl="ref")
    rr = _Router(calls=rk.seen)
    ref = paged(plain, rr, forced)
    check(len(rr.seen) == len(rk.seen) and all(
        torch.equal(a, b) for a, b in zip(rr.seen, rk.seen)),
        "(d) the plain engine did not replay every expert choice")
    err, n_rows = _key_err(van["rec"]["logits"], ref["rec"]["logits"], 4)
    with _decode_fault(plain, "pos", by=-1):
        ctl = paged(plain, _Router(calls=rk.seen), forced, P25_CTL_NEW)
    bad, _ = _key_err(ctl["rec"]["logits"], ref["rec"]["logits"])
    del ref, ctl, rk
    _free()
    out["paged"] = dict(launches=lp, err=err, ctl=bad,
                        prefill_tok_s=st["prefill_tokens"] / pf,
                        decode_tok_s=st["decode_tokens"] / dc,
                        decode_ms=1e3 * dc / st["decode_steps"])
    say(f"  (d) paged Engine: prefill {out['paged']['prefill_tok_s']:.1f} "
        f"tok/s ({pf:.3f} s), decode {out['paged']['decode_tok_s']:.1f} "
        f"tok/s ({out['paged']['decode_ms']:.2f} ms a step); launches A "
        f"(latent) {lp['flash_fwd_latent']}, B {lp['paged_decode']}; "
        f"{n_rows} decode rows, worst max|Δ| / max|logit| vs the plain "
        f"engine replaying the experts {err:.4e} (limit {LOGIT_REL_TOL}); "
        f"control, decode one position early: {bad:.4e}")
    check(err <= LOGIT_REL_TOL, f"(d) paged Engine logits {err}")
    check(bad > LOGIT_REL_TOL, f"(d) the paged gate does not reject the "
          f"early decode ({bad})")
    # FixedSlotEngine: one prompt at a time (its batch shares one length)
    times, logs, toks, calls = {}, [], [], []
    model.prefill = _timed(times, "prefill", model.prefill)
    model.decode = _timed(times, "decode", model.decode)
    build.reset_launches()
    for p in prompts:
        r = _Router()
        with r, _recorded(model) as lg:
            t, _ = FixedSlotEngine(model, params).generate(
                {"tokens": p[None]}, P4_NEW)
        logs.append(torch.stack(lg))
        toks.append(t.cpu())
        calls.append(r.seen)
    lf = dict(build.LAUNCHES)
    del model.prefill, model.decode
    check(lf["flash_fwd_pair"] == cfg.n_layers * len(prompts),
          f"(d) FixedSlotEngine launches {lf}: kernel A's pair route must "
          f"launch once a layer a prompt")
    errs, first = [], None
    for p, kern, t, c in zip(prompts, logs, toks, calls):
        with _Router(calls=c), _recorded(plain, t) as lg:
            FixedSlotEngine(plain, params).generate({"tokens": p[None]},
                                                    P4_NEW)
        first = torch.stack(lg) if first is None else first
        errs.append(_step_err(kern, torch.stack(lg)))
    with _Router(calls=calls[0]), _decode_fault(plain, "pos", by=-1), \
            _recorded(plain, toks[0]) as lg:
        FixedSlotEngine(plain, params).generate({"tokens": prompts[0][None]},
                                                P25_CTL_NEW)
    bad = _step_err(torch.stack(lg)[1:], first[1:P25_CTL_NEW + 1])
    pf, dc = sum(times["prefill"]), times["decode"]
    out["fixed"] = dict(launches=lf, err=max(errs), ctl=bad,
                        prefill_tok_s=sum(P4_LENS) / pf,
                        decode_ms=1e3 * float(np.median(dc)),
                        decode_tok_s=len(dc) / sum(dc))
    say(f"  (d) FixedSlotEngine: prefill {out['fixed']['prefill_tok_s']:.1f}"
        f" tok/s ({pf:.3f} s for the 4 prompts), decode "
        f"{out['fixed']['decode_ms']:.2f} ms a step (median; B 1), launches "
        f"{ {k: n for k, n in lf.items() if n} }; worst step max|Δ| / "
        f"max|logit| vs the plain engine replaying the experts, per prompt "
        + ", ".join(f"{e:.4e}" for e in errs)
        + f" (limit {LOGIT_REL_TOL}); control, decode one position early: "
        f"{bad:.4e}")
    check(max(errs) <= LOGIT_REL_TOL, f"(d) FixedSlotEngine logits {errs}")
    check(bad > LOGIT_REL_TOL, f"(d) the fixed-slot gate does not reject "
          f"the early decode ({bad})")
    del plain
    _free()
    out["idle"] = trace(model, params, prompts)
    out["peak"] = torch.cuda.max_memory_allocated()
    say(f"  (d) peak {out['peak'] / 2**30:.2f} GiB allocated")
    del model, params
    _free()
    return out


def _p25_kernels():
    """(e) kernels A, C and D's pair route at deepseek-v3's (1, 4096, 128
    heads, q/k 192 / v 128), causal, and A's latent route and B at 128
    heads over one latent head, each held to its plain version at phase
    3's bars first (A, C, D in bf16 at T 4,096 and float32 at 1,024; the
    latent shapes in both dtypes, B bitwise batch-invariant); then the
    bf16 device times by CUDA-graph replay beside the bound, the plain
    version's and SDPA's (its forward for A, its autograd backward for C
    and D). Returns the ``v3_*`` keys of the rows."""
    gen = torch.Generator(device=DEV).manual_seed(P25_SEED)
    H = V3_DIMS[0]
    for dt, T in ((torch.bfloat16, P25_T), (torch.float32, 1024)):
        _pair_case(gen, f"h{H} B1 T{T} causal", 1, T, T, dt, mk.causal(),
                   dims=V3_DIMS)
        _free()
        _pair_bwd_case(gen, f"h{H} B1 T{T} causal v-view", 1, T, T,
                              dt, mk.causal(), "kv",
                              repeat=dt == torch.bfloat16, dims=V3_DIMS)
        _free()
    latent_checks(H=H, seed=P25_SEED)
    _free()
    rows = {}
    fwd = _pair_fwd_timing(gen, 1, P25_T, V3_DIMS)
    rows["flash_fwd_pair"] = fwd
    q, k, v = _pair_inputs(gen, 1, P25_T, P25_T, torch.bfloat16, V3_DIMS)
    do = randn(gen, (1, P25_T, H, PAIR_DV), torch.bfloat16)
    kw = dict(mask=mk.causal(), scale=LAT_SCALE)
    o, lse = flash_fwd(q, k, v, **kw)
    got = flash_bwd(q, k, v, o, lse, do, **kw)
    ref = _pair_bwd_ref((q, k, v, o, lse, do), kw)
    e = {"flash_bwd_dq": float((got[0].float() - ref[0].float()).abs()
                               .max()),
         "flash_bwd_dkv": max(float((x.float() - y.float()).abs().max())
                              for x, y in zip(got[1:], ref[1:]))}
    del got, ref
    _free()
    bwd = _pair_bwd_timing((q, k, v, o, lse, do), kw, e)
    del q, k, v, o, lse, do
    _free()
    rows["flash_bwd_dq_pair"] = bwd["flash_bwd_dq"]
    rows["flash_bwd_dkv_pair"] = bwd["flash_bwd_dkv"]
    rows["flash_fwd_latent"] = _latent_fwd_timing(gen, H)
    rows["paged_decode"] = _paged_timing(gen, 4, 1, H, 1, LAT_DK, 16,
                                         list(P25_B_LENS), latent=True)
    return {name: {f"v3_{k}": x for k, x in r.items()}
            for name, r in rows.items()}


def deepseek_v3():
    """Phase 25: deepseek-v3-671b with multi-token prediction, bf16, seed
    25, at full width (d_model 7168, MLA of 128 heads with q_lora 1536,
    kv_lora 512, rope 64, nope 128, v 128; d_expert 2048, d_dense_ff
    18,432, top-8, 1 shared expert, vocab 129,280), depth cut to 2 of 61
    layers (1 dense + 1 MoE) beside the MTP block; training keeps 16 of
    the 256 routed experts.  (a) :func:`_p25_train`; (b, c)
    :func:`_p25_ranks`; (d) :func:`_p25_serve` at all 256 experts; (e)
    :func:`_p25_kernels`.  Returns the launches on its paths by kernel row
    and the rows' ``v3_*`` keys."""
    t_all = time.perf_counter()
    cfg = _p25_cfg()
    m = cfg.moe
    from repro_torch.models.moe import capacity
    check(capacity(cfg, P25_T) >= P25_T, f"capacity {capacity(cfg, P25_T)} "
          f"at capacity factor {m.capacity_factor}: pairs can drop")
    say(f"  cuts: depth 2 of 61 layers (1 of 3 dense + 1 of 58 MoE) beside "
        f"the MTP block, to fit the card; training {m.n_routed} of 256 "
        f"routed experts ({cfg.param_count() / 1e9:.3f} B parameters "
        f"without the MTP block, bf16 weights and gradients, float32 AdamW "
        f"moments), capacity factor {m.capacity_factor:g} = E / k (no pair "
        f"drops, as DeepSeek-V3 trains); the router is the reference's "
        f"softmax top-k, not DeepSeek-V3's sigmoid with a bias")
    out = {"launches": {}, "rows": {}}

    def add(name, n):
        out["launches"][name] = out["launches"].get(name, 0) + n
    t0 = time.perf_counter()
    tr = _p25_train(cfg)
    _free()
    say(f"  (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rk = _p25_ranks(cfg)
    _free()
    say(f"  (b, c) {time.perf_counter() - t0:.1f} s")
    for src in (tr["launches"], rk["launches"]):
        add("flash_fwd_pair", src["flash_fwd_pair"])
        add("flash_bwd_dq_pair", src["flash_bwd_dq"])
        add("flash_bwd_dkv_pair", src["flash_bwd_dkv"])
    t0 = time.perf_counter()
    sv = _p25_serve()
    say(f"  (d) {time.perf_counter() - t0:.1f} s")
    for name in ("flash_fwd_latent", "paged_decode", "flash_fwd_pair"):
        add(name, sv["paged"]["launches"][name]
            + sv["fixed"]["launches"][name])
    t0 = time.perf_counter()
    out["rows"] = _p25_kernels()
    _free()
    say(f"  (e) {time.perf_counter() - t0:.1f} s")
    for name, n in out["launches"].items():
        out["rows"].setdefault(name, {})["v3_launches"] = n
    out.update(train=tr, ranks=rk, serve=sv,
               seconds=time.perf_counter() - t_all)
    say(f"  phase 25 took {out['seconds']:.1f} s")
    return out


# ----------------------------------------------------------------- phase 5

# ---------------------------------------------------------------- phase 26

P26_KERNEL_SHAPES = None          # kernel_grid's (T, D, Dv) list on the card
P26_PAIR = (192, 128)             # counted under the pair rows
P26_GATE_SHAPE = (8192, 128)      # (T, D) of (a)'s gate, 32 heads, causal
P26_GATE = (0.9, 2.0)             # the sweep's wall / phase 5's device ms
P26_SCHED_SEQS = None             # schedule_grid's seqs on the card
P26_SCHED_TOL = 2e-2              # bf16: rank 0's output vs the plain one
P26_SCHED_TIMEOUT = 600
P26_PAGED_SMOKE = False
P26_TABLE = Path(__file__).resolve().parent / "build" / "tuning_table.json"
P26_DRYRUN = (("deepseek-v3-671b", "train_4k"), ("llama-7b", "train_4k"))
P26_DRYRUN_KW = {}                # run_one's smoke= / mesh_shape= (rehearsal)
P26_DRYRUN_S = 60.0
P26_DRYRUN_JOBS = 6               # one pool; two cores for the main process
P26_PEAK = (0.8, 1.25)            # meta peak / phase 7's rank peak


def _p26_kernels(rows):
    """(a): ``tune/sweep.sweep_kernels`` on the card; its causal row at
    phase 5's training shape held to phase 5's device times (A forward,
    C + D backward).  Returns (data, launches, pair launches, gate
    ratios)."""
    from repro_torch.tune import sweep as tsw
    data = tsw.new_table_data(DEV)
    _, _, grid, _, _ = tsw.kernel_grid(DEV)
    grid = P26_KERNEL_SHAPES or grid
    build.reset_launches()
    tsw.sweep_kernels(data, device=DEV, log=say,
                      shapes=[g for g in grid if g[1:] != P26_PAIR])
    launches = dict(build.LAUNCHES)
    build.reset_launches()
    tsw.sweep_kernels(data, device=DEV, log=say,
                      shapes=[g for g in grid if g[1:] == P26_PAIR])
    pair = dict(build.LAUNCHES)
    T, D = P26_GATE_SHAPE
    got = {r["op"]: r["wall_us"] / 1e3 for r in data["kernel"]
           if r["mask_kind"] == "causal" and r["seq"] == T
           and r["head_dim"] == D and r["dv"] == D}
    by = {r["name"]: r for r in rows}
    want = {"fwd": by["flash_fwd"].get("train_ms"),
            "bwd": by["flash_bwd_dq"]["ms"] + by["flash_bwd_dkv"]["ms"]}
    ratios = {}
    for op in ("fwd", "bwd"):
        if want[op] is None or op not in got:
            continue
        ratios[op] = got[op] / want[op]
        say(f"  (a) gate: sweep {op} causal T {T} D {D} {got[op]:.4f} ms, "
            f"phase 5's device time {want[op]:.4f} ms: ratio "
            f"{ratios[op]:.3f} (limits {P26_GATE})")
        check(P26_GATE[0] <= ratios[op] <= P26_GATE[1],
              f"the kernel sweep's {op} row reads {ratios[op]:.3f}x phase "
              f"5's device time, outside {P26_GATE}")
    return data, launches, pair, ratios


def _p26_meta_counts():
    """(e)'s counts on the meta device (a worker process's job): the peak
    of one rank of phase 7's cell under each of its schedules ((1, 4)
    meta mesh, the ``null`` backend standing in for the kernels' outputs:
    no O(T²) scores), and phase 6's step FLOPs (``null`` plus the
    kernels' analytic FLOPs)."""
    from repro_torch.analysis import roofline as RL
    from repro_torch.analysis.meta_count import counting
    from repro_torch.launch.dryrun import build_step
    from repro_torch.launch.mesh import make_meta_mesh
    torch.set_num_threads(1)
    cfg = get_config("llama-7b").replace(n_layers=P7_LAYERS)
    shape = ShapeSpec("chip7", P7_T, 1, "train")
    peaks = {}
    for sched, _ in P7_RUNS:
        mesh = make_meta_mesh(("data", "model"), (1, P7_RANKS))
        step, live = build_step(cfg, shape, mesh, schedule=sched,
                                impl="null")
        with counting(*live) as c:
            step()
        peaks[sched] = c.peak_bytes
    # phase 27 (a)'s rank 0 on a (2, 2) meta mesh: its FSDP shards,
    # moments and the step's gathers
    step, live = build_step(_p27_cfg(), _p27_shape(),
                            make_meta_mesh(("data", "model"), P27_MESH),
                            impl="null")
    with counting(*live) as c:
        step()
    peak27 = c.peak_bytes
    cfg6 = get_config("llama-7b").replace(n_layers=TRAIN_LAYERS)
    shape6 = ShapeSpec("chip", TRAIN_T, 1, "train")
    step, live = build_step(cfg6, shape6, None, impl="null")
    with counting(*live) as c:
        step()
    an_f, _ = RL.attention_analytic(cfg6, shape6, seq_shards=1,
                                    batch_shards=1)
    return dict(peaks=peaks, flops=c.flops + an_f, attn_flops=an_f,
                peak27=peak27)


def p26_start():
    """Start phase 26's (d) and (e) on the meta device in a pool of
    P26_DRYRUN_JOBS worker processes, which need only CPU, while the main
    process goes on with single-process card phases (14 and 21 (a, b)):
    every run of ``launch/dryrun``'s pairs P26_DRYRUN, the longest first,
    then :func:`_p26_meta_counts`.  A thread waits for the pairs and
    keeps their wall from the pool's start."""
    import threading
    from repro_torch.launch import dryrun
    ex = dryrun.worker_pool(P26_DRYRUN_JOBS)
    t0 = time.perf_counter()
    collect = dryrun.submit_many(ex, P26_DRYRUN, **P26_DRYRUN_KW)
    bg = dict(ex=ex, meta=ex.submit(_p26_meta_counts))

    def wait():
        try:
            bg["recs"] = collect()
        except BaseException as e:      # re-raised by _p26_dryrun
            bg["err"] = e
        bg["dry_s"] = time.perf_counter() - t0
    bg["thread"] = threading.Thread(target=wait, daemon=True)
    bg["thread"].start()
    return bg


def _p26_dryrun(bg):
    """(d): the records of P26_DRYRUN on the single-pod production mesh
    (started by :func:`p26_start`): FLOPs, bytes, collective bytes and
    peak nonzero; the records printed; the pairs' wall within
    P26_DRYRUN_S."""
    bg["thread"].join()
    if "err" in bg:
        raise bg["err"]
    recs, sec = {}, bg["dry_s"]
    for (arch, shape), rec in zip(P26_DRYRUN, bg["recs"]):
        rec.pop("flops_by_op")
        say(f"  (d) {arch} {shape}: " + json.dumps(rec))
        for what, x in (("flops", rec["flops"]),
                        ("bytes", rec["bytes_accessed"]),
                        ("collective bytes",
                         rec["collectives"]["total_bytes"]),
                        ("peak", rec["memory"]["peak_device_bytes"])):
            check(x > 0, f"dry-run {arch} {shape}: {what} {x}")
        recs[(arch, shape)] = rec
    say(f"  (d) both pairs in {sec:.1f} s from their pool's start, "
        f"{P26_DRYRUN_JOBS} worker processes beside phases 14 and 21 "
        f"(limit {P26_DRYRUN_S:.0f} s)")
    check(sec <= P26_DRYRUN_S, f"the dry-run pairs took {sec:.1f} s")
    return recs


def _p26_meta(tr, mr, counts, fp=None):
    """(e): the meta peak of one rank of phase 7's cell (the largest over
    its schedules) against that rank's ``max_memory_allocated``, and of
    phase 27 (a)'s rank 0 (FSDP shards) against its own; phase
    6's counted step FLOPs over its step seconds and the peak rate (not
    gated)."""
    from repro_torch.analysis import roofline as RL
    peaks = counts["peaks"]
    meta = max(peaks.values())
    card = mr["peaks"][0]
    ratio = meta / card
    say(f"  (e) one rank of phase 7's cell on meta: peak "
        + ", ".join(f"{s} {b / 2**30:.3f}" for s, b in peaks.items())
        + f" GiB; phase 7's rank 0 (max_memory_allocated) "
        f"{card / 2**30:.3f} GiB; ratio {ratio:.3f} (limits {P26_PEAK})")
    check(P26_PEAK[0] <= ratio <= P26_PEAK[1],
          f"the meta peak reads {ratio:.3f}x phase 7's rank peak")
    ratio27 = None
    if fp is not None:
        card27 = fp["peaks"][0]
        ratio27 = counts["peak27"] / card27
        say(f"  (e) phase 27 (a)'s rank 0 (FSDP over data 2) on meta: peak "
            f"{counts['peak27'] / 2**30:.3f} GiB; on the card "
            f"(max_memory_allocated over its steps) {card27 / 2**30:.3f} "
            f"GiB; ratio {ratio27:.3f} (limits {P26_PEAK})")
        check(P26_PEAK[0] <= ratio27 <= P26_PEAK[1],
              f"the meta peak reads {ratio27:.3f}x phase 27's rank peak")
    flops, an_f = counts["flops"], counts["attn_flops"]
    step_s = TRAIN_T / tr["tok_s"]
    share = flops / (step_s * RL.PEAK_FLOPS)
    say(f"  (e) phase 6's step counted on meta: {flops / 1e12:.3f} TFLOP "
        f"({(flops - an_f) / 1e12:.3f} outside the attention, "
        f"{an_f / 1e12:.3f} the kernels' analytic), step {step_s:.4f} s: "
        f"{flops / step_s / 1e12:.1f} TFLOP/s, {share:.4f} of the "
        f"{RL.PEAK_FLOPS / 1e12:.1f} TFLOP/s peak (not gated)")
    return dict(meta_peaks=peaks, card_peak=card, ratio=ratio,
                step_flops=flops, peak_share=share, ratio27=ratio27)


def tuning(rows, tr, mr, bg, fp=None):
    """Phase 26: the autotuner's sweeps on the card (``tune/sweep.py``:
    kernels (a), schedules on 4 cuda-ipc ranks (b), paged block sizes
    (c)), the dry-run's records on the meta device (d) and its peak
    against the card (e), whose counts ``bg`` (:func:`p26_start`) ran
    earlier in worker processes."""
    from repro_torch.tune import calibrate as cal
    from repro_torch.tune import sweep as tsw
    from repro_torch.tune.table import TuningTable
    t0 = time.perf_counter()
    data, launches, pair, ratios = _p26_kernels(rows)
    say(f"  (a) {len(data['kernel'])} kernel rows in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}, pair "
        f"{pair}")
    _free()
    t1 = time.perf_counter()
    errs = tsw.sweep_schedules(data, log=say, device=DEV,
                               seqs=P26_SCHED_SEQS,
                               timeout=P26_SCHED_TIMEOUT)
    worst = max(errs.values())
    say(f"  (b) {len(data['schedule'])} schedule rows in "
        f"{time.perf_counter() - t1:.1f} s (transport "
        f"{data['host']['schedule_transport']}); rank 0 vs the plain "
        f"attention at seq {data['schedule'][0]['seq']}: " + ", ".join(
            f"{r}/{s} {e:.2e}" for (r, s), e in sorted(errs.items()))
        + f" (limit {P26_SCHED_TOL})")
    check(worst <= P26_SCHED_TOL, f"a schedule's output is {worst} off the "
          "plain attention")
    data["calibration"] = cal.calibrate(data["schedule"])
    fit = data["calibration"]["fit"]
    say(f"  (b) calibrate: coefficients {data['calibration']['coeffs']}; "
        f"spearman {fit['spearman']} (roofline {fit['spearman_roofline']}),"
        f" best-match {fit['best_match']} (roofline "
        f"{fit['best_match_roofline']})")
    _free()
    t1 = time.perf_counter()
    build.reset_launches()
    paged = tsw.sweep_paged(data, device=DEV, log=say,
                            smoke=P26_PAGED_SMOKE)
    for k, n in build.LAUNCHES.items():
        launches[k] = launches.get(k, 0) + n
    for arch, meas in paged.items():
        streams = [tuple(map(tuple, r["streams"])) for r in meas.values()]
        same = sum(len({s[i] for s in streams}) == 1
                   for i in range(len(streams[0])))
        say(f"  (c) {arch}: " + ", ".join(
            f"bs {b} {r['tokens_per_s']:.1f} tok/s {r['preemptions']} "
            f"preemptions" for b, r in meas.items())
            + f"; {same} of {len(streams[0])} streams equal across sizes")
        for b, r in meas.items():
            check(all(r["full_budgets"]), f"{arch} block size {b}: a "
                  "request ended short of its budget")
    tab = TuningTable(data)
    P26_TABLE.parent.mkdir(parents=True, exist_ok=True)
    tab.save(str(P26_TABLE))
    tsw.check_roundtrip(TuningTable.load(str(P26_TABLE)), log=say)
    say(f"  (c) in {time.perf_counter() - t1:.1f} s; table written to "
        f"{P26_TABLE}")
    _free()
    recs = _p26_dryrun(bg)
    meta = _p26_meta(tr, mr, bg["meta"].result(), fp)
    bg["ex"].shutdown()
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
              "paged_decode"):
        check(launches.get(k, 0) > 0, f"phase 26 launched no {k}")
    return dict(launches=launches, pair=pair, ratios=ratios, errs=errs,
                table=data, dryrun=recs, meta=meta)


def ptxas_kernels(text):
    """{kernel name: (registers, spill bytes)} from nvcc's ``-Xptxas -v``
    output, by the entry function each report follows."""
    out, name, spill = {}, None, 0
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], 0
        elif "spill stores" in line and name:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spill = nums[1] + nums[2]     # spill stores, spill loads
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used")[1].split("registers")[0])
            out[name] = (regs, spill)
    return out


def _template_args(mangled):
    """The integer template arguments of a mangled kernel name."""
    import re
    return [int(x) for x in re.findall(r"Li(\d+)E", mangled)]


def tensor_core_report(report):
    """Registers, spills and shared memory of the tensor-core routes at each
    head dim: kernel A's (``flash_fwd_sm90``) and kernels C and D's
    (``flash_bwd_sm90``), none of which may spill at D = 128; kernel A's
    latent route (``flash_fwd_latent_sm90``, v k's prefix view or a tensor
    of its own) and pair route (``flash_fwd_pair_sm90``, q/k 192, v 128),
    and kernels C and D's pair route (``flash_bwd_pair_sm90``), which may
    not spill at all; and kernels C and D's float32 route (``flash_bwd``)
    at 192 / 128, which may not spill either."""
    import ctypes
    fwd = build.load("flash_fwd_sm90").repro_flash_fwd_sm90_smem
    fwd.argtypes, fwd.restype = [ctypes.c_int], ctypes.c_int
    bwd = build.load("flash_bwd_sm90").repro_flash_bwd_sm90_smem
    bwd.argtypes, bwd.restype = [ctypes.c_int] * 3, ctypes.c_int
    bwd32 = build.load("flash_bwd").repro_flash_bwd_smem
    bwd32.argtypes, bwd32.restype = [ctypes.c_int] * 3, ctypes.c_int
    lat = build.load("flash_fwd_latent_sm90").repro_flash_fwd_latent_sm90_smem
    lat.argtypes, lat.restype = [ctypes.c_int], ctypes.c_int
    views = set()
    for mangled, (regs, spill) in sorted(
            ptxas_kernels(report["flash_fwd_latent_sm90"]).items()):
        if "wgmma_kernel" not in mangled:      # the split's merge kernel
            continue
        own_v = int(mangled.split("ILb")[1][0])
        views.add(own_v)
        say(f"  ptxas A fwd latent wgmma 576/512 "
            f"{'v of its own' if own_v else 'v in k'}: {regs} registers, "
            f"{spill} bytes spilled, {lat(1 - own_v)} bytes dynamic shared "
            "memory")
        check(spill == 0, f"kernel {mangled} spills {spill} bytes")
    check(views == {0, 1}, "ptxas reported fewer than two latent tensor-core "
          "kernels")
    pair = build.load("flash_fwd_pair_sm90").repro_flash_fwd_pair_sm90_smem
    pair.argtypes, pair.restype = [ctypes.c_int] * 2, ctypes.c_int
    got = ptxas_kernels(report["flash_fwd_pair_sm90"])
    dims = sorted(tuple(_template_args(m)[:2]) for m in got)
    check(dims == [(160, 160), (192, 128)],
          f"ptxas reported the pair kernels {dims}")
    for mangled, (regs, spill) in sorted(got.items()):
        dk, dv = _template_args(mangled)[:2]
        say(f"  ptxas A fwd pair wgmma {dk}/{dv}: {regs} registers, {spill} "
            f"bytes spilled, {pair(dk, dv)} bytes dynamic shared memory")
        check(spill == 0, f"kernel {mangled} spills {spill} bytes")
    # C and D's pair route: three warpgroups, `setmaxnreg` hands the
    # consumers 240 registers a thread (ptxas reports the launch's 168)
    bpair = build.load("flash_bwd_pair_sm90").repro_flash_bwd_pair_sm90_smem
    bpair.argtypes, bpair.restype = [ctypes.c_int] * 3, ctypes.c_int
    got = ptxas_kernels(report["flash_bwd_pair_sm90"])
    names = sorted(("C dq" if "dq_pair" in m else "D dkv",)
                   + tuple(_template_args(m)[:2]) for m in got)
    check(names == [("C dq", 160, 160), ("C dq", 192, 128),
                    ("D dkv", 160, 160), ("D dkv", 192, 128)],
          f"ptxas reported the pair backward kernels {names}")
    for mangled, (regs, spill) in sorted(got.items()):
        kernel = 0 if "dq_pair" in mangled else 1
        dk, dv = _template_args(mangled)[:2]
        say(f"  ptxas {('C dq', 'D dkv')[kernel]} pair wgmma {dk}/{dv}: "
            f"{regs} registers at launch, {spill} bytes spilled, "
            f"{bpair(kernel, dk, dv)} bytes dynamic shared memory")
        check(spill == 0, f"kernel {mangled} spills {spill} bytes")
    seen = 0
    for lib in ("flash_fwd_sm90", "flash_bwd_sm90"):
        for mangled, (regs, spill) in sorted(
                ptxas_kernels(report[lib]).items()):
            targs = _template_args(mangled)
            d = targs[0]
            if lib == "flash_fwd_sm90":
                name, smem = "A fwd", fwd(d)
            else:
                kernel = 0 if "dq_wgmma" in mangled else 1
                name = ("C dq", "D dkv")[kernel]
                smem = bwd(kernel, d, d)
            say(f"  ptxas {name} wgmma D={d}: {regs} registers, {spill} "
                f"bytes spilled, {smem} bytes dynamic shared memory")
            check(d != 128 or spill == 0, f"kernel {mangled} spills {spill} "
                  f"bytes at D={d}")
            seen += d == 128
    check(seen == 3, "ptxas reported fewer than three D = 128 tensor-core "
          "kernels")
    f32 = 0
    for mangled, (regs, spill) in sorted(
            ptxas_kernels(report["flash_bwd"]).items()):
        d, dv = _template_args(mangled)[:2]
        if dv == d and d != D160:
            continue
        kernel = 0 if "dq_kernel" in mangled else 1
        say(f"  ptxas {('C dq', 'D dkv')[kernel]} float32 D={d}/{dv}: "
            f"{regs} registers, {spill} bytes spilled, "
            f"{bwd32(kernel, d, dv)} bytes dynamic shared memory")
        check(spill == 0, f"kernel {mangled} spills {spill} bytes")
        f32 += 1
    check(f32 == 4, f"ptxas reported {f32} float32 192/128 and 160 kernels")
    for mangled, (regs, spill) in sorted(
            ptxas_kernels(report["flash_fwd"]).items()):
        if _template_args(mangled)[:1] != [D160]:
            continue
        say(f"  ptxas A fwd float32 D={D160}: {regs} registers, {spill} bytes "
            "spilled")
        check(spill == 0, f"kernel {mangled} spills {spill} bytes")


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _flash_timing(gen, H, Hkv):
    """Kernel A at the serving shape with H query heads over Hkv kv heads of
    128: one 256-token chunk of the 1000-token prompt at start 768 against
    the 1024-key (bucketed) gathered context; its time, its plain
    version's, SDPA's, its bound and its error."""
    B, Tq, Tk, D, off = 1, 256, 1024, 128, 768
    q = randn(gen, (B, Tq, H, D), torch.bfloat16)
    k = randn(gen, (B, Tk, Hkv, D), torch.bfloat16)
    v = randn(gen, (B, Tk, Hkv, D), torch.bfloat16)
    m = mk.causal(rel_offset=off)
    o, _ = flash_fwd(q, k, v, mask=m)
    o_r, _ = chunk_attn_ref(q, k, v, mask=m)
    err = float((o.float() - o_r.float()).abs().max())
    ms = cuda_ms(lambda: flash_fwd(q, k, v, mask=m))
    plain = cuda_ms(lambda: chunk_attn_ref(q, k, v, mask=m))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    allow = (torch.arange(Tk, device=DEV)[None, :]
             <= off + torch.arange(Tq, device=DEV)[:, None])
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=allow, enable_gqa=H != Hkv))
    pairs = sum(min(Tk, off + t + 1) for t in range(Tq))
    flops = 4.0 * B * H * pairs * D
    nbytes = 2 * B * D * (2 * Tq * H + 2 * Tk * Hkv) + 4 * B * H * Tq
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    say(f"  flash_fwd  B{B} Tq{Tq} Tk{Tk} H{H}/{Hkv} D{D} bf16 "
        f"causal@{off}: kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa "
        f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} "
        f"GFLOP, {nbytes / 1e6:.2f} MB), {flops / ms / 1e9:.1f} TFLOP/s "
        f"achieved, max|Δo| {err:.3e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib)


def time_flash(launches):
    """Kernel A at the serving shape (llama-7b's 32 heads), and at the
    Qwen family's head pairs (phase 10: ``qwen_h{Hq}_{Hkv}_*`` keys)."""
    gen = torch.Generator(device=DEV).manual_seed(2)
    row = {"name": "flash_fwd", "route": "cuda", "design": FWD_DESIGN,
           "source": "src/repro_torch/kernels/csrc/flash_fwd_sm90.cu",
           "float32_source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
           "replaces": "src/repro/kernels/flash_attention.py:157",
           "launches": launches["flash_fwd"]}
    row.update(_flash_timing(gen, 32, 32))
    for hq, hkv in QWEN_HEADS:
        row.update({f"qwen_h{hq}_{hkv}_{k}": x
                    for k, x in _flash_timing(gen, hq, hkv).items()})
    return row


LATENT_DESIGN = ("bf16 on the tensor cores: 64-row tiles of (position, head) "
                 "pairs (4 positions x 16 heads) that share one staged latent "
                 "tile; q by TMA once, 64-key latent tiles by TMA into a "
                 "2-stage swizzled ring with mbarriers, v the staged tile's "
                 "first 8 slabs; two warpgroups each compute s = q.k^T "
                 "(wgmma m64n64k16) and own 256 of o's 512 columns, o += p.v "
                 "as wgmma m64n128k16 with p in registers as two bf16 terms; "
                 "float32: IEEE FMAs on the CUDA cores, 16 x 32 tiles")


def _latent_fwd_timing(gen, H):
    """Kernel A's latent route at a serving chunk (Tq 256 at q_offset 768
    over 1024 gathered latent rows, H heads, bf16): its time, its plain
    version's, SDPA's with an explicit mask (q/k 576, v 512,
    ``enable_gqa``), its bound and its error."""
    q, k, v = _latent_chunk(gen, torch.bfloat16, H=H)
    Tq, Tk, off = q.shape[1], k.shape[1], 768
    m = mk.causal(rel_offset=off)
    o, _ = flash_fwd(q, k, v, mask=m, scale=LAT_SCALE)
    o_r, _ = chunk_attn_ref(q, k, v, mask=m, scale=LAT_SCALE)
    err = float((o.float() - o_r.float()).abs().max())
    ms = cuda_ms(lambda: flash_fwd(q, k, v, mask=m, scale=LAT_SCALE))
    dev_ms = graph_ms(lambda: flash_fwd(q, k, v, mask=m, scale=LAT_SCALE))
    plain = cuda_ms(lambda: chunk_attn_ref(q, k, v, mask=m, scale=LAT_SCALE))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    allow = (torch.arange(Tk, device=DEV)[None, :]
             <= off + torch.arange(Tq, device=DEV)[:, None])
    try:
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=allow, scale=LAT_SCALE, enable_gqa=True))
    except RuntimeError as e:     # no SDPA backend takes the shape
        say(f"  sdpa at q/k {LAT_DK}, v {LAT_DV}: {str(e)[:120]}")
        lib = None
    pairs = sum(min(Tk, off + t + 1) for t in range(Tq))
    flops = 2.0 * H * pairs * (LAT_DK + LAT_DV)
    nbytes = 2 * (Tq * H * (LAT_DK + LAT_DV) + Tk * LAT_DK) + 4 * Tq * H
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    say(f"  flash_fwd_latent Tq{Tq} Tk{Tk} H{H}/1 D{LAT_DK}/{LAT_DV} "
        f"bf16 causal@{off} ({LATENT_ROUTES[torch.bfloat16][0]}): kernel "
        f"{ms:.4f} ms, device {dev_ms:.4f} ms ({flops / dev_ms / 1e9:.1f} "
        f"TFLOP/s), plain {plain:.4f} ms, sdpa "
        f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound {b_ms:.4f} ms "
        f"({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB; "
        f"{b_ms / ms:.3f} of the kernel's time, {b_ms / dev_ms:.3f} of its "
        f"device time), max|Δo| {err:.3e}")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "bound_fraction": b_ms / ms, "library_ms": lib}


def time_latent(launches):
    """Kernel A's latent route at phase 12's serving chunk (16 heads):
    :func:`_latent_fwd_timing`; it must beat SDPA's time."""
    gen = torch.Generator(device=DEV).manual_seed(4)
    row = {"name": "flash_fwd_latent", "route": "cuda",
           "design": LATENT_DESIGN,
           "source": "src/repro_torch/kernels/csrc/flash_fwd_latent_sm90.cu",
           "float32_source":
               "src/repro_torch/kernels/csrc/flash_fwd_latent.cu",
           "replaces": "src/repro/kernels/flash_attention.py:157",
           "launches": launches["flash_fwd_latent"]}
    row.update(_latent_fwd_timing(gen, LAT_H))
    ms, lib = row["ms"], row["library_ms"]
    check(lib is None or ms < lib, f"flash_fwd_latent: {ms:.4f} ms is not "
          f"faster than SDPA's {lib:.4f} ms")
    return row


PAIR_DESIGN = ("bf16 on the tensor cores: one block per 128 q rows (two "
               "warpgroups of 64) of one head; q by TMA once, 64-key k and v "
               "tiles by TMA into a 3-stage swizzled ring with mbarriers; s = "
               "q.k^T as wgmma m64n64k16 over 12 k16 steps, o += p.v as "
               "wgmma m64n128k16 with p in registers as two bf16 terms; "
               "float32: IEEE FMAs on the CUDA cores, 16 x 32 tiles")


def _sdpa_backend(q, k, v, **kw):
    """The backend SDPA's dispatcher picks for these (B, H, T, D) inputs, by
    name."""
    from torch.nn.attention import SDPBackend
    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v, **kw)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        return f"unknown ({type(e).__name__})"


def _pair_fwd_timing(gen, B, T, dims=PAIR_SHAPE):
    """Kernel A's pair route at a causal whole-prompt shape (B, T, ``dims``'
    heads of q/k 192 and v 128, bf16): its device time (20 calls replayed
    as one CUDA graph) and event time around a call, its plain version's,
    SDPA's on the same tensors (with the backend its dispatcher takes),
    its bound and its error."""
    H = dims[0]
    q, k, v = _pair_inputs(gen, B, T, T, torch.bfloat16, dims)
    m = mk.causal()
    # the plain version over every head at once, or (more than 16 heads)
    # head slice by head slice, each (h, T, T) float32 at most 2.1 GB
    slices = ([(slice(None), slice(None))] if H <= PAIR_H
              else _head_slices(q, k))

    def ref():
        return [chunk_attn_ref(q[:, :, sq], k[:, :, skv], v[:, :, skv],
                               mask=m, scale=LAT_SCALE)[0]
                for sq, skv in slices]
    o, _ = flash_fwd(q, k, v, mask=m, scale=LAT_SCALE)
    o_r = torch.cat(ref(), dim=2)
    err = float((o.float() - o_r.float()).abs().max())
    del o, o_r
    _free()
    dev_ms = graph_ms(lambda: flash_fwd(q, k, v, mask=m, scale=LAT_SCALE))
    ms = cuda_ms(lambda: flash_fwd(q, k, v, mask=m, scale=LAT_SCALE))
    plain = cuda_ms(ref, reps=5, warmup=1)
    _free()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    backend = _sdpa_backend(qt, kt, vt, is_causal=True, scale=LAT_SCALE)
    try:
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=LAT_SCALE), reps=10, warmup=2)
    except RuntimeError as e:     # no SDPA backend takes the shape
        say(f"  sdpa at q/k {PAIR_DK}, v {PAIR_DV}: {str(e)[:160]}")
        lib, backend = None, f"none: {str(e)[:120]}"
    del qt, kt, vt
    _free()
    pairs = B * H * T * (T + 1) // 2
    flops = 2.0 * pairs * (PAIR_DK + PAIR_DV)
    nbytes = 2 * B * T * H * (2 * PAIR_DK + 2 * PAIR_DV) + 4 * B * T * H
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    say(f"  flash_fwd_pair B{B} T{T} H{H} D{PAIR_DK}/{PAIR_DV} bf16 "
        f"causal ({PAIR_ROUTES[torch.bfloat16][0]}): device {dev_ms:.4f} ms "
        f"({flops / dev_ms / 1e9:.1f} TFLOP/s, {b_ms / dev_ms:.3f} of the "
        f"bound), event {ms:.4f} ms a call, plain {plain:.4f} ms, sdpa "
        f"{'n/a' if lib is None else f'{lib:.4f} ms'} (backend {backend}), "
        f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e12:.4f} TFLOP, "
        f"{nbytes / 1e6:.1f} MB), max|Δo| {err:.3e}")
    del q, k, v
    _free()
    return {"max_abs_err": err, "ms": dev_ms, "event_ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "bound_fraction": b_ms / dev_ms, "library_ms": lib,
            "library_backend": backend}


def time_pair(launches):
    """Kernel A's pair route at phase 13's whole-prompt prefill (B 2, T
    4096, 16 heads): :func:`_pair_fwd_timing`."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    row = {"name": "flash_fwd_pair", "route": "cuda", "design": PAIR_DESIGN,
           "source": "src/repro_torch/kernels/csrc/flash_fwd_pair_sm90.cu",
           "float32_source":
               "src/repro_torch/kernels/csrc/flash_fwd_latent.cu",
           "replaces": "src/repro/kernels/flash_attention.py:157",
           "launches": launches["flash_fwd_pair"]}
    row.update(_pair_fwd_timing(gen, P13_B, P13_T))
    return row


def time_flash_train(seen):
    """Kernel A at the training shape: the layer-1 forward inputs kept in
    phase 6 (B 1, T 8192, 32 heads × 128, bf16, causal), beside its bound,
    its plain version over head slices and SDPA's causal forward."""
    (q, k, v), kw = _moved(seen["fwd"], DEV)
    B, T, H, D = q.shape
    ms = cuda_ms(lambda: flash_fwd(q, k, v, **kw), reps=10, warmup=2)
    slices = _head_slices(q, k)
    plain = cuda_ms(lambda: [chunk_attn_ref(q[:, :, sq], k[:, :, skv],
                                            v[:, :, skv], **kw)
                             for sq, skv in slices], reps=3, warmup=1)
    _free()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=kw.get("scale"),
        enable_gqa=H != k.shape[2]), reps=10, warmup=2)
    pairs = B * H * T * (T + 1) // 2
    flops = 4.0 * D * pairs
    nbytes = 2 * B * T * D * (2 * H + 2 * k.shape[2]) + 4 * B * T * H
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    say(f"  flash_fwd  B{B} T{T} H{H} D{D} bf16 causal (training shape): "
        f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
        f"{b_ms / ms:.4f} of the bound), plain {plain:.4f} ms, sdpa "
        f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {flops / 1e12:.3f} "
        f"TFLOP, {nbytes / 1e6:.1f} MB)")
    del q, k, v, qt, kt, vt
    _free()
    return {"train_ms": ms, "train_plain_ms": plain, "train_bound_ms": b_ms,
            "train_bound_by": b_by, "train_library_ms": lib}


PAGED_DESIGN = ("split-KV (flash-decoding): grid (Hkv, B, S) over splits of "
                "L_s tokens (256 at bf16 D 128) fixed by the request's own "
                "positions; 256-thread blocks stage each split's pages in "
                "32-token tiles through a 4-stage 16-byte cp.async ring (48 "
                "KB in flight a block, three blocks an SM); scores, one max "
                "and sum per tile and p·v on the CUDA cores in float32; a "
                "second kernel merges the splits in a fixed order")
PAGED_LIBRARY = ("none: no single PyTorch call computes attention through a "
                 "block table (SDPA takes contiguous K/V)")
PAGED_POOLS = 4     # pool pairs the L2-cold timings rotate over


def _paged_device_ms(call, n=40):
    """Kernel B's own device time per call: n calls replayed as one CUDA
    graph (:func:`graph_ms`); and, beside it, torch.profiler's device time
    of every kernel named ``paged_decode*`` over n calls (split and merge),
    None where the trace holds no such kernel.  Late in this script's run
    the profiler has dropped kernels (readings past the bytes bound) or
    recorded none, so only the replay is the device time."""
    from torch.profiler import ProfilerActivity, profile
    it = iter(range(1 << 30))
    replay = graph_ms(lambda: call(next(it)), n=n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            call(i)
        torch.cuda.synchronize()
    us = sum(t for name, (_, t) in _kernels(prof).items()
             if "paged_decode" in name)
    return replay, (us / 1e3 / n if us > 0 else None)


def _paged_timing(gen, B, Tq, Hq, Hkv, D, bs, lens, latent=False):
    """Kernel B L2-cold at one shape: every launch reads one of PAGED_POOLS
    distinct pool pairs in turn (together far above the 50 MB L2, as the
    engine's 32 layers are).  Returns its device time, the wrapper's time
    (CUDA events around one call), the host time of one call (a host clock
    around 1000 calls, no sync inside), the plain version's time, the bound
    and the error against the plain version.  ``latent``: the MLA latent
    pool (q/k 576 over one kv head, v its 512-column view, Hq query
    heads), whose bytes are the latent rows read once."""
    if latent:
        q, kp, vp, bt, ln = _latent_pool(gen, B, Tq, lens, torch.bfloat16,
                                         Hq)
        more = [torch.randn_like(kp) for _ in range(PAGED_POOLS - 1)]
        pools = [(kp, vp)] + [(k, k[..., :LAT_DV]) for k in more]
        sc = LAT_SCALE
    else:
        q, kp, vp, bt, ln = _paged_inputs(gen, B, Tq, Hq, Hkv, D, bs, lens,
                                          torch.bfloat16)
        pools = [(kp, vp)] + [(torch.randn_like(kp), torch.randn_like(vp))
                              for _ in range(PAGED_POOLS - 1)]
        sc = None
    m = mk.causal()

    def call(i):
        k, v = pools[i % PAGED_POOLS]
        return paged_attn(q, k, v, bt, ln, mask=m, scale=sc)
    o = call(0)
    o_r = paged_attn_ref(q, kp, vp, bt, ln, mask=m, scale=sc)
    err = float((o.float() - o_r.float()).abs().max())
    dev, prof_ms = _paged_device_ms(call)
    it = iter(range(1 << 30))
    wrap = cuda_ms(lambda: call(next(it)), reps=20, warmup=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1000):
        call(i)
    host = 1e3 * (time.perf_counter() - t0) / 1000
    torch.cuda.synchronize()
    plain = cuda_ms(lambda: paged_attn_ref(q, *pools[next(it) % PAGED_POOLS],
                                           bt, ln, mask=m, scale=sc),
                    reps=5, warmup=1)
    ctx = sum(lens)
    if latent:
        D, Hkv = LAT_DK, 1
        flops = 2.0 * ctx * Hq * Tq * (LAT_DK + LAT_DV)
        nbytes = 2 * (ctx * LAT_DK + B * Tq * Hq * (LAT_DK + LAT_DV)) \
            + 4 * (B + bt.numel())
    else:
        flops = 4.0 * ctx * Hq * Tq * D
        nbytes = 2 * (2 * ctx * Hkv * D + 2 * B * Tq * Hq * D) \
            + 4 * (B + bt.numel())
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    dims = f"D{LAT_DK}/{LAT_DV} latent" if latent else f"D{D}"
    say(f"  paged_decode B{B} Tq{Tq} Hq{Hq} Hkv{Hkv} {dims} bs{bs} bf16 "
        f"lengths {lens if len(lens) < 5 else len(lens)}, L2-cold: device "
        f"{dev:.4f} ms ({nbytes / dev / 1e6:.1f} GB/s, {b_ms / dev:.3f} of "
        f"the bound), profiler "
        f"{'n/a' if prof_ms is None else f'{prof_ms:.4f} ms'}, wrapper "
        f"{wrap:.4f} ms, host {host:.4f} ms a call, "
        f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
        f"{nbytes / 1e6:.2f} MB), max|Δo| {err:.3e}")
    del q, kp, vp, pools, o, o_r
    _free()
    return dict(ms=dev, profiler_ms=prof_ms, wrapper_ms=wrap, host_ms=host,
                plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)


def time_paged(launches):
    """Kernel B, L2-cold, at the serving shape (one decode step of the 4
    requests, lengths mid-way through their 32 new tokens, bs 16), at a
    long-context decode (one 32768-token request), at the GQA shape of
    phase 3 (Tq 4, 32 query heads over 8 kv heads), and at phase 9's
    shapes: the verify pass (Tq 5 on llama-7b's heads) and the draft's
    decode (smollm-360m: 15 query heads over 5 kv heads of 64); and the
    Qwen family's head pairs at the serving step and at verify Tq 5
    (phase 10: ``qwen_h{Hq}_{Hkv}_{serve,verify}_*`` keys), and the MLA
    latent pool of phase 12 at Tq 1 and 5 (``mla_{serve,verify}_*``)."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    lens = [1016, 716, 529, 80]
    serve = _paged_timing(gen, 4, 1, 32, 32, 128, 16, lens)
    long = _paged_timing(gen, 1, 1, 32, 32, 128, 16, [32768])
    gqa = _paged_timing(gen, 4, 4, 32, 8, 128, 16, lens)
    verify = _paged_timing(gen, 4, 1 + P9_DEPTH, 32, 32, 128, 16, lens)
    draft = _paged_timing(gen, 4, 1, 15, 5, 64, 16, lens)
    qwen = {f"qwen_h{hq}_{hkv}_{tag}": _paged_timing(gen, 4, tq, hq, hkv,
                                                      128, 16, lens)
            for hq, hkv in QWEN_HEADS
            for tag, tq in (("serve", 1), ("verify", 1 + P9_DEPTH))}
    mla = {f"mla_{tag}": _paged_timing(gen, 4, tq, LAT_H, 1, LAT_DK, 16,
                                       LAT_LENS, latent=True)
           for tag, tq in (("serve", 1), ("verify", 1 + P9_DEPTH))}
    row = {"name": "paged_decode", "route": "cuda", "design": PAGED_DESIGN,
           "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
           "replaces": "src/repro/kernels/paged.py:182",
           "launches": launches["paged_decode"], "library_ms": None,
           "library_note": PAGED_LIBRARY}
    row.update(serve)
    for name, r in (("long", long), ("gqa", gqa), ("verify", verify),
                    ("draft", draft), *qwen.items(), *mla.items()):
        row.update({f"{name}_{k}": x for k, x in r.items()})
    return row


def time_bwd(launches, seen, errs):
    """Kernels C and D on the training path's own backward inputs (B 1,
    T 8192, 32 heads × 128, bf16, causal).  Each kernel's plain version is
    the plain backward computing just its part (``only=``), run over every
    head slice in turn, so it covers the same work at the same shape.  No
    single library call computes dq or dk/dv alone: the library figure is
    SDPA's autograd backward, which computes the pair, and both rows say
    so."""
    (q, k, v, o, lse, do), kw = _moved(seen["bwd"], DEV)
    B, T, H, D = q.shape
    scale = D ** -0.5 if kw["scale"] is None else kw["scale"]
    pl = _BwdPlan(q, k, v, o, lse, do, kw["mask"], kw.get("delta"),
                  kw.get("q_segments"), kw.get("kv_segments"), True)
    dq_ms = cuda_ms(lambda: _launch_dq(pl, scale), reps=10, warmup=2)
    dkv_ms = cuda_ms(lambda: _launch_dkv(pl, scale), reps=10, warmup=2)
    slices = [_bwd_slice((q, k, v, o, lse, do), kw, sq, skv)
              for sq, skv in _head_slices(q, k)]

    def plain(only):
        return lambda: [chunk_attn_bwd_ref(*a, **k2, only=only)
                        for a, k2 in slices]
    plain_ms = {"flash_bwd_dq": cuda_ms(plain("dq"), reps=3, warmup=1),
                "flash_bwd_dkv": cuda_ms(plain("dkv"), reps=3, warmup=1)}
    _free()
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                           is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    lib = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                              retain_graph=True),
                  reps=10, warmup=2)
    del pl, slices, qt, kt, vt, out, dot, q, k, v, o, lse, do
    _free()
    pairs = B * H * T * (T + 1) // 2
    tensor = 2 * B * T * H * D                   # one bf16 (B,T,H,D)
    stats = 4 * B * T * H                        # one float32 (B,T,H)
    rows = []
    for name, ms, fl, nbytes, src_line in (
            ("flash_bwd_dq", dq_ms, 6.0 * D * pairs, 6 * tensor + 2 * stats,
             280),
            ("flash_bwd_dkv", dkv_ms, 8.0 * D * pairs, 6 * tensor + 2 * stats,
             322)):
        b_ms, b_by = bound(fl, nbytes, PEAK_BF16_FLOPS)
        say(f"  {name} B{B} T{T} H{H} D{D} bf16 causal: kernel {ms:.4f} ms "
            f"({fl / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.4f} of the bound), "
            f"plain {plain_ms[name]:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{fl / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB), max|Δ| vs plain "
            f"{errs[name]:.3e}")
        rows.append({"name": name, "route": "cuda", "design": BWD_DESIGN,
                     "source":
                         "src/repro_torch/kernels/csrc/flash_bwd_sm90.cu",
                     "replaces": f"src/repro/kernels/flash_attention.py:"
                                 f"{src_line}",
                     "launches": launches[name], "max_abs_err": errs[name],
                     "ms": ms, "plain_ms": plain_ms[name], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib,
                     "library_covers": "flash_bwd_dq+flash_bwd_dkv"})
    say(f"  pair C+D at T {T}: kernels {dq_ms + dkv_ms:.4f} ms, plain "
        f"{sum(plain_ms.values()):.4f} ms (each part on its own), SDPA "
        f"autograd backward {lib:.4f} ms")
    return rows


PAIR_BWD_DESIGN = ("bf16 on the tensor cores: three warpgroups a block, a "
                   "TMA producer warp (3-stage ring, mbarriers, row "
                   "statistics by cp.async) and two consumers that split "
                   "each tile pair's wgmma products and hand p (pᵀ) across "
                   "in float32 through shared memory; D in one pass, C with "
                   "ds as hi (shared-shared) and lo (register A) terms; "
                   "setmaxnreg 24 / 240; float32: IEEE FMAs on the CUDA "
                   "cores at <192, 128>")


def _pair_bwd_timing(args, kw, errs):
    """Kernels C and D at q/k 192, v 128 on causal inputs ``args`` = (q, k,
    v, o, lse, do) (bf16, v the strided view): device time (20 calls
    replayed as one CUDA graph) and event time of each, its plain
    version's (the plain backward computing just its part, head slice by
    head slice), SDPA's autograd backward of the pair on the same tensors
    (the backend its dispatcher takes, named) and the bound, printed
    beside ``errs`` (each kernel's max |Δ| against its plain version).
    Returns {kernel: its keys}."""
    q, k, v, o, lse, do = args
    del args
    B, T, H, D = q.shape
    Dv = v.shape[-1]
    scale = kw["scale"]
    pl = _BwdPlan(q, k, v, o, lse, do, kw["mask"], kw.get("delta"),
                  kw.get("q_segments"), kw.get("kv_segments"), True)
    dev_ms = {"flash_bwd_dq": graph_ms(lambda: _launch_dq(pl, scale)),
              "flash_bwd_dkv": graph_ms(lambda: _launch_dkv(pl, scale))}
    ev_ms = {"flash_bwd_dq": cuda_ms(lambda: _launch_dq(pl, scale), reps=10,
                                     warmup=2),
             "flash_bwd_dkv": cuda_ms(lambda: _launch_dkv(pl, scale),
                                      reps=10, warmup=2)}
    slices = [_bwd_slice((q, k, v, o, lse, do), kw, sq, skv)
              for sq, skv in _head_slices(q, k)]

    def plain(only):
        return lambda: [chunk_attn_bwd_ref(*a, **k2, only=only)
                        for a, k2 in slices]
    plain_ms = {"flash_bwd_dq": cuda_ms(plain("dq"), reps=3, warmup=1),
                "flash_bwd_dkv": cuda_ms(plain("dkv"), reps=3, warmup=1)}
    del pl, slices
    _free()
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    backend = _sdpa_backend(qt, kt, vt, is_causal=True, scale=scale)
    out = _library(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale))
    lib = None
    if out is not None:
        dot = do.transpose(1, 2).contiguous()
        lib = _library(lambda: cuda_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), reps=10, warmup=2))
        del dot
    if lib is None:
        backend = f"none ({backend})"
    del qt, kt, vt, out, q, k, v, o, lse, do
    _free()
    pairs = B * H * T * (T + 1) // 2
    tk, tv = 2 * B * T * H * D, 2 * B * T * H * Dv   # one bf16 tensor each
    stats = 4 * B * T * H                            # one float32 (B,T,H)
    out = {}
    for name, fl, nbytes in (
            # C reads q, k, v, o, do, lse; writes dq and delta
            ("flash_bwd_dq", 2.0 * (2 * D + Dv) * pairs,
             3 * tk + 3 * tv + 2 * stats),
            # D reads q, k, v, do, lse, delta; writes dk and dv
            ("flash_bwd_dkv", 2.0 * (2 * D + 2 * Dv) * pairs,
             3 * tk + 3 * tv + 2 * stats)):
        b_ms, b_by = bound(fl, nbytes, PEAK_BF16_FLOPS)
        ms = dev_ms[name]
        say(f"  {name} pair B{B} T{T} H{H} D{D}/{Dv} bf16 causal: device "
            f"{ms:.4f} ms ({fl / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.4f} of "
            f"the bound), event {ev_ms[name]:.4f} ms a call, plain "
            f"{plain_ms[name]:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{fl / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB), max|Δ| vs plain "
            f"{errs[name]:.3e}")
        out[name] = {"max_abs_err": errs[name], "ms": ms,
                     "event_ms": ev_ms[name], "plain_ms": plain_ms[name],
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bound_fraction": b_ms / ms, "library_ms": lib,
                     "library_backend": backend}
    say(f"  pair C+D at T {T}: kernels {sum(dev_ms.values()):.4f} ms "
        f"(device), plain {sum(plain_ms.values()):.4f} ms (each part on its "
        f"own), SDPA autograd backward "
        f"{'n/a' if lib is None else f'{lib:.4f} ms'} (backend {backend})")
    return out


def time_pair_bwd(launches, seen, errs):
    """Kernels C and D at materialised MLA's q/k 192, v 128 on phase 14's
    own backward inputs (B 1, T 8192, 16 heads, bf16, causal, v the strided
    view): :func:`_pair_bwd_timing`."""
    got = _pair_bwd_timing(*_moved(seen["bwd"], DEV), errs)
    rows = []
    for name, src_line in (("flash_bwd_dq", 280), ("flash_bwd_dkv", 322)):
        row = {"name": name + "_pair", "route": "cuda",
               "design": PAIR_BWD_DESIGN,
               "source": "src/repro_torch/kernels/csrc/flash_bwd_pair_sm90.cu",
               "float32_source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
               "replaces": f"src/repro/kernels/flash_attention.py:{src_line}",
               "launches": launches[name]}
        row.update(got[name])
        row["library_covers"] = "flash_bwd_dq+flash_bwd_dkv"
        rows.append(row)
    return rows


D160_DESIGN = ("bf16 on the tensor cores, the pair libraries at <160, 160>: "
               "160 columns as three 64-column TMA slabs, the last half "
               "zeros; A: 128-row q tiles on two warpgroups over 64-key "
               "tiles in a 3-stage ring, o += p·v as wgmma m64n192 with p "
               "as two bf16 terms; C and D: a TMA producer warp and two "
               "consumer warpgroups over a 2-stage ring, the first products "
               "shared-shared, the second m64n192; float32: IEEE FMAs on "
               "the CUDA cores")


def time_d160(launches):
    """Kernels A, C and D at zamba2-2.7b's training shape: q, k, v (1, 8192,
    32, 160) bf16, causal, scale 1/√160: device time of each (20 calls
    replayed as one CUDA graph) and event time a call, its plain version's
    (head slice by head slice), SDPA's causal forward and autograd
    backward on the same tensors (the backend its dispatcher takes,
    named), each bound and the error against the plain version."""
    gen = torch.Generator(device=DEV).manual_seed(31)
    H, D, _, scale = D160_DIMS
    B, T = 1, 8192
    q, k, v = _pair_inputs(gen, B, T, T, torch.bfloat16, D160_DIMS)
    do = randn(gen, (B, T, H, D), torch.bfloat16)
    m = mk.causal()
    o, lse = flash_fwd(q, k, v, mask=m, scale=scale)
    kw = dict(mask=m, scale=scale)
    args = (q, k, v, o, lse, do)
    slices = [_bwd_slice(args, kw, sq, skv) for sq, skv in _head_slices(q, k)]
    o_r = torch.cat([chunk_attn_ref(a[0], a[1], a[2], **kw)[0]
                     for a, _ in slices], dim=2)
    err = {"flash_fwd_160": float((o.float() - o_r.float()).abs().max())}
    del o_r
    got = flash_bwd(*args, **kw)
    ref = _pair_bwd_ref(args, kw)
    err["flash_bwd_dq_160"] = float((got[0].float() - ref[0].float()).abs()
                                    .max())
    err["flash_bwd_dkv_160"] = max(float((a.float() - r.float()).abs().max())
                                   for a, r in zip(got[1:], ref[1:]))
    del got, ref
    _free()
    pl = _BwdPlan(q, k, v, o, lse, do, m, None, None, None, True)
    fwd = (lambda: flash_fwd(q, k, v, mask=m, scale=scale))
    dev_ms = {"flash_fwd_160": graph_ms(fwd),
              "flash_bwd_dq_160": graph_ms(lambda: _launch_dq(pl, scale)),
              "flash_bwd_dkv_160": graph_ms(lambda: _launch_dkv(pl, scale))}
    ev_ms = {"flash_fwd_160": cuda_ms(fwd, reps=10, warmup=2),
             "flash_bwd_dq_160": cuda_ms(lambda: _launch_dq(pl, scale),
                                         reps=10, warmup=2),
             "flash_bwd_dkv_160": cuda_ms(lambda: _launch_dkv(pl, scale),
                                          reps=10, warmup=2)}

    def plain(only=None):
        if only is None:
            return lambda: [chunk_attn_ref(a[0], a[1], a[2], **k2)
                            for a, k2 in slices]
        return lambda: [chunk_attn_bwd_ref(*a, **k2, only=only)
                        for a, k2 in slices]
    plain_ms = {"flash_fwd_160": cuda_ms(plain(), reps=3, warmup=1),
                "flash_bwd_dq_160": cuda_ms(plain("dq"), reps=3, warmup=1),
                "flash_bwd_dkv_160": cuda_ms(plain("dkv"), reps=3, warmup=1)}
    del pl, slices
    _free()
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    backend = _sdpa_backend(qt, kt, vt, is_causal=True, scale=scale)
    sdpa = (lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale))
    lib_fwd = _library(lambda: cuda_ms(sdpa, reps=10, warmup=2))
    out = _library(sdpa)
    lib_bwd = None
    if out is not None:
        dot = do.transpose(1, 2).contiguous()
        lib_bwd = _library(lambda: cuda_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), reps=10, warmup=2))
        del dot
    del qt, kt, vt, out, q, k, v, o, lse, do
    _free()
    pairs = B * H * T * (T + 1) // 2
    t16, stats = 2 * B * T * H * D, 4 * B * T * H
    rows = []
    for name, fl, nbytes, src_line, lib in (
            # A reads q, k, v; writes o and lse
            ("flash_fwd_160", 2.0 * 2 * D * pairs, 4 * t16 + stats, 157,
             lib_fwd),
            # C reads q, k, v, o, do, lse; writes dq and delta
            ("flash_bwd_dq_160", 2.0 * 3 * D * pairs, 6 * t16 + 2 * stats,
             280, lib_bwd),
            # D reads q, k, v, do, lse, delta; writes dk and dv
            ("flash_bwd_dkv_160", 2.0 * 4 * D * pairs, 6 * t16 + 2 * stats,
             322, lib_bwd)):
        b_ms, b_by = bound(fl, nbytes, PEAK_BF16_FLOPS)
        ms = dev_ms[name]
        say(f"  {name} B{B} T{T} H{H} D{D} bf16 causal: device {ms:.4f} ms "
            f"({fl / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.4f} of the bound), "
            f"event {ev_ms[name]:.4f} ms a call, plain {plain_ms[name]:.4f} "
            f"ms, sdpa {'n/a' if lib is None else f'{lib:.4f} ms'} (backend "
            f"{backend}{'' if name == 'flash_fwd_160' else ', autograd backward'}"
            f"), bound {b_ms:.4f} ms ({b_by}; {fl / 1e12:.3f} TFLOP, "
            f"{nbytes / 1e6:.1f} MB), max|Δ| vs plain {err[name]:.3e}")
        rows.append({"name": name, "route": "cuda", "design": D160_DESIGN,
                     "source": "src/repro_torch/kernels/csrc/" + (
                         "flash_fwd_pair_sm90.cu" if name == "flash_fwd_160"
                         else "flash_bwd_pair_sm90.cu"),
                     "float32_source": "src/repro_torch/kernels/csrc/" + (
                         "flash_fwd.cu" if name == "flash_fwd_160"
                         else "flash_bwd.cu"),
                     "replaces": f"src/repro/kernels/flash_attention.py:"
                                 f"{src_line}",
                     "launches": launches.get(name, 0),
                     "max_abs_err": err[name], "ms": ms,
                     "event_ms": ev_ms[name], "plain_ms": plain_ms[name],
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bound_fraction": b_ms / ms, "library_ms": lib,
                     "library_backend": backend,
                     **({} if name == "flash_fwd_160" else
                        {"library_covers":
                         "flash_bwd_dq_160+flash_bwd_dkv_160"})})
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_all = time.perf_counter()

    def took(n, t0):
        say(f"  phase {n} took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    say("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"nvidia-smi: {smi}")
    say(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    took(1, t0)

    say("== phase 2: build")
    t0 = time.perf_counter()
    report = build.build_all()
    say(f"  {list(report)} built from the checkout's sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in report.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")
    tensor_core_report(report)
    took(2, t0)

    say("== phase 3: kernels against their plain versions")
    t0 = time.perf_counter()
    kernel_checks()
    latent_checks()
    pair_checks()
    bwd_checks()
    pair_bwd_checks()
    d160_checks()
    took(3, t0)
    say("== phase 3c: kernels A, C and D under every plan step's mask")
    t0 = time.perf_counter()
    plan_step_checks()
    pair_plan_step_checks()
    took("3c", t0)
    say("== phase 3d: the cuda-ipc transport against gloo-staged, 4 ranks "
        "on the one card")
    transport_checks()

    say("== phase 4: serve llama-7b")
    t0 = time.perf_counter()
    res = serve()
    say(f"  launches per decode step: paged_decode "
        f"{res['per_decode_step']:.1f}; per prefill chunk: flash_fwd "
        f"{res['per_chunk']:.1f}")
    took(4, t0)
    say("== phase 9: speculative serving, llama-7b with a smollm-360m draft")
    t0 = time.perf_counter()
    sp = speculative(res.pop("model"), res.pop("params"), res["prompts"])
    for name, key in (("flash_fwd", "draft_A"), ("paged_decode", "draft_B")):
        check(sp["launches"][name] > 0, f"kernel {name} was not launched "
              "on the speculative serving path")
        check(sp["model draft report"][key] > 0,
              f"the draft model did not launch {name}")
    say(f"  phase 9 took {time.perf_counter() - t0:.1f} s")
    _free()

    say("== phase 6: train at llama-7b width")
    t0 = time.perf_counter()
    tr = train()
    took(6, t0)
    say("== phase 6a: kernels A, C and D on the training path's inputs")
    t0 = time.perf_counter()
    errs = main_path_checks(tr["seen"])
    took("6a", t0)
    say("== phase 6b: gradients against the plain path")
    t0 = time.perf_counter()
    grad_check()
    took("6b", t0)
    say("== phase 7: multi-rank training, 4 ranks on the one card")
    t0 = time.perf_counter()
    mr = multi_rank()
    _free()
    took(7, t0)
    say("== phase 27: FSDP (ZeRO-3) training over (data 2, model 2), 4 "
        "ranks on the one card: llama-7b's width at depth 4 and "
        "deepseek-v2-lite-16b at depth 2")
    t0 = time.perf_counter()
    fp = fsdp_ranks()
    _free()
    took(27, t0)
    say("== phase 8: long-context serving, 4 sequence ranks on the one card")
    t0 = time.perf_counter()
    lg = long_serve()
    _free()
    took(8, t0)
    say("== phase 18: 2D sequence x head plans, 4 ranks on the one card")
    t0 = time.perf_counter()
    s2 = seq2d(mr.pop("p1"))
    say(f"  phase 18 took {time.perf_counter() - t0:.1f} s")
    _free()
    say("== phase 10: the Qwen family at full size through the paged engine")
    t0 = time.perf_counter()
    qw = qwen()
    say(f"  phase 10 took {time.perf_counter() - t0:.1f} s")
    say("== phase 11: the paged engine across 4 ranks on the one card")
    t0 = time.perf_counter()
    me = mesh_engine()
    say(f"  phase 11 took {time.perf_counter() - t0:.1f} s")
    _free()
    say("== phase 12: deepseek-v2-lite-16b (MLA + MoE) at full size through "
        "the paged engine")
    dk = deepseek()
    say("== phase 13: deepseek-v2-lite-16b through the fixed-slot engine "
        "(whole-prompt MLA prefill, dense latent-cache decode)")
    fs = fixed_slot(dk.pop("model"), dk.pop("params"))
    _free()
    # phase 26 (d, e) count on the meta device in worker processes while
    # the single-process card phases 14 and 21 (a, b) run
    p26 = p26_start()
    say(f"== phase 14: train deepseek-v2-lite-16b (MLA + MoE) at full width, "
        f"{P14_LAYERS} of 27 layers")
    tm = train_moe()
    _free()
    say("== phase 21 (a, b): mamba2-2.7b and zamba2-2.7b at full size on "
        "the one card: training, the recurrent decode, kernels A, C and D at "
        "head dim 160")
    t0 = time.perf_counter()
    sm = ssm_models()
    took("21 (a, b)", t0)
    say("== phase 5: times at the shapes of each path")
    t0 = time.perf_counter()
    launches = {k: res["launches"][k] + tr["launches"].get(k, 0)
                + mr["launches"].get(k, 0) + lg["launches"].get(k, 0)
                + sp["launches"].get(k, 0) + qw["launches"].get(k, 0)
                + me["launches"].get(k, 0) + dk["launches"].get(k, 0)
                + fs["launches"].get(k, 0) + s2["launches"].get(k, 0)
                + fp["launches"].get(k, 0)
                for k in res["launches"]}
    # kernel A's pair route also trains (phases 14 and 15) and prefills
    # across ranks (phase 16, all ranks; added once they have run); C and
    # D's one-D rows keep the llama paths' counts, their 192/128 rows
    # phases 14 and 15's
    launches["flash_fwd_pair"] += tm["launches"]["flash_fwd_pair"]
    pair_bwd = {k: tm["launches"][k] for k in ("flash_bwd_dq",
                                                "flash_bwd_dkv")}
    say(f"  launches on the main paths: serve {res['launches']}, "
        f"train {tr['launches']}, multi-rank (all ranks) {mr['launches']}, "
        f"long-context prefill (all ranks) {lg['launches']}, speculative "
        f"serving (runs 1-5) {sp['launches']}, qwen {qw['launches']}, "
        f"mesh engine (all ranks) {me['launches']}, deepseek "
        f"{dk['launches']}, deepseek fixed-slot {fs['launches']}, deepseek "
        f"training (remat_aware and hf, 4 steps each) {tm['launches']}, 2D "
        f"plans (all ranks: a train step on each mesh, the 2D prefill) "
        f"{s2['launches']}, FSDP training (all ranks, phase 27 (a)) "
        f"{fp['launches']}")
    rows = [time_flash(launches), time_latent(launches), time_pair(launches),
            time_paged(launches), *time_bwd(launches, tr["seen"], errs),
            *time_pair_bwd(pair_bwd, tm.pop("seen"), tm["errs"]),
            *time_d160(sm["launches"])]
    rows[0].update(time_flash_train(tr["seen"]))
    _free()
    took(5, t0)
    # phases 15 and 16 after the times: torch.profiler, which the times
    # read, has seen no device kernel in a process that ran them first
    say("== phase 15: train deepseek-v2-lite-16b across 4 ranks on the one "
        f"card (experts sharded over the sequence ranks), {P15_LAYERS} of 27 "
        "layers")
    em = train_moe_ranks()
    _free()
    say("== phase 16: serve deepseek-v2-lite-16b at full size across 4 ranks "
        "through the fixed-slot engine")
    es = serve_moe_ranks()
    _free()
    say(f"== phase 17: serve deepseek-v2-lite-16b at full width, {P17_LAYERS} "
        "of 27 layers, across 4 ranks through the paged engine (latent pool "
        "block-sharded)")
    ep = serve_moe_paged()
    _free()
    say("== phase 19: deepseek-v2-lite-16b (MLA + MoE) on a 2D (seq x head) "
        "mesh of 4 ranks on the one card: training and fixed-slot serving")
    e2 = moe2d()
    _free()
    say("== phase 20: the paged engine on a 2D (seq x head) mesh of 4 ranks "
        "on the one card: qwen3-8b's width (head-parallel pool) and "
        f"deepseek-v2-lite-16b, {P17_LAYERS} of 27 layers (latent pool "
        "block-sharded)")
    g2 = engine2d()
    _free()
    say("== phase 21 (c): zamba2-2.7b at full width, "
        f"{P21C_LAYERS} of 54 layers, across 4 ranks on the one card (the "
        "SSD state relayed between them)")
    t0 = time.perf_counter()
    sr = ssm_ranks()
    _free()
    took("21 (c)", t0)
    say(f"== phase 22: zamba2-2.7b at full width, {P21C_LAYERS} of 54 "
        "layers, on a 2D (seq x head) = (2, 2) mesh of 4 ranks on the one "
        "card: training, the prefill and the recurrent decode")
    t0 = time.perf_counter()
    s2d = ssm2d()
    _free()
    took(22, t0)
    say("== phase 23: internvl2-2b (VLM) at full size: training, gradients "
        "against the plain path, FixedSlotEngine, a zigzag step on 4 ranks")
    t0 = time.perf_counter()
    vl = vlm()
    _free()
    took(23, t0)
    say("== phase 24: whisper-tiny (encoder-decoder) at full size: kernels "
        "A, C and D at its cross shape, training at 1 and 4 ranks, "
        "gradients against the plain path, FixedSlotEngine")
    t0 = time.perf_counter()
    wh = whisper()
    _free()
    took(24, t0)
    say("== phase 25: deepseek-v3-671b with multi-token prediction at full "
        "width, 2 of 61 layers and the MTP block: training at 1 rank, on 4 "
        "ranks and on a (2, 2) mesh, serving at 256 experts, kernels A-D "
        "at 128 heads")
    v3 = deepseek_v3()
    _free()
    say("== phase 26: the autotuner's sweeps on the card (kernels, "
        "schedules on 4 cuda-ipc ranks, paged block sizes), the dry-run on "
        "the meta device, its peak against phase 7's")
    t0 = time.perf_counter()
    tu = tuning(rows, tr, mr, p26, fp)
    _free()
    took(26, t0)

    for row in rows:
        if row["name"] == "flash_fwd_pair":
            row["launches"] += (em["launches"]["flash_fwd_pair"]
                                + es["launches"]["flash_fwd_pair"]
                                + es["ring"]["launches"])
        elif row["name"] in ("flash_fwd_latent", "paged_decode"):
            row["launches"] += ep["launches"][row["name"]]
        elif row["name"] in ("flash_bwd_dq_pair", "flash_bwd_dkv_pair"):
            row["launches"] += (em["launches"][row["name"][:-5]]
                                + e2["launches"][row["name"][:-5]]
                                + fp["pair"][row["name"][:-5]])
        if row["name"] == "flash_fwd_pair":
            row["launches"] += (e2["launches"]["flash_fwd_pair"]
                                + fp["pair"]["flash_fwd_pair"])
        # phase 27's FSDP runs: (a) on the one-D rows (added with phase
        # 5's sums), (b) on the pair rows
        row["p27_launches"] = {
            "flash_fwd_pair": fp["pair"]["flash_fwd_pair"],
            "flash_bwd_dq_pair": fp["pair"]["flash_bwd_dq"],
            "flash_bwd_dkv_pair": fp["pair"]["flash_bwd_dkv"]}.get(
                row["name"], fp["launches"].get(row["name"], 0))
        row["launches"] += g2["launches"].get(row["name"], 0)
        row["launches"] += sr["launches"].get(row["name"], 0)
        row["launches"] += s2d["launches"].get(row["name"], 0)
        # the one-D rows also count phases 23 and 24, and keep whisper's
        # cross and decode shapes' times (``whisper_*`` keys)
        for ph in (vl, wh):
            row["launches"] += ph["launches"].get(row["name"], 0)
        row.update(wh["rows"].get(row["name"], {}))
        if row["name"] in wh["launches"]:
            row["whisper_launches"] = wh["launches"][row["name"]]
        # phase 25's paths (``v3_launches``) and times at its shapes
        row["launches"] += v3["launches"].get(row["name"], 0)
        row.update(v3["rows"].get(row["name"], {}))
        # phase 26's sweeps: the pair rows count the 192/128 shapes'
        name = row["name"]
        if name in ("flash_bwd_dq_pair", "flash_bwd_dkv_pair"):
            p26 = tu["pair"].get(name[:-5], 0)
        else:
            p26 = tu["launches"].get(name, 0) + (
                tu["pair"].get(name, 0) if name == "flash_fwd_pair" else 0)
        row["launches"] += p26
        row["p26_launches"] = p26
    say(f"  deepseek training across 4 ranks (all ranks, 4 steps) "
        f"{em['launches']}, deepseek fixed-slot across 4 ranks (all ranks) "
        f"{es['launches']}, its latent-ring prefill (all ranks) "
        f"flash_fwd_pair {es['ring']['launches']}, deepseek paged across 4 "
        f"ranks (all ranks) {ep['launches']}, deepseek on the 2D mesh "
        f"(all ranks: 2 train steps, the prefill) {e2['launches']}, the "
        f"paged engine on the 2D mesh (all ranks, both cases) "
        f"{ {k: n for k, n in g2['launches'].items() if n} }, zamba2 "
        f"training and across 4 ranks (all ranks) "
        f"{sm['launches']} / {sr['launches']}, zamba2 on the 2D mesh (all "
        f"ranks: a train step, the prefill) {s2d['launches']}, internvl2 "
        f"(3 steps, the engine's first request, a zigzag step on all "
        f"ranks) {vl['launches']}, whisper (2 steps, a step on all ranks, "
        f"the engine's decode) {wh['launches']}, deepseek-v3 (3 training "
        f"steps, the 4-rank and (2, 2) steps on all ranks, both engines' "
        f"kernel runs) {v3['launches']}, FSDP deepseek (all ranks, phase "
        f"27 (b)) {fp['pair']}, the sweeps (phase 26 (a, c); the "
        f"192/128 shapes {tu['pair']}) {tu['launches']}")
    say(f"  total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
