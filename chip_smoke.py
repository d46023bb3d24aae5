"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a non-zero
exit, and nothing falls back:

  1. device   — asserts CUDA; prints the card's name and power limit;
  2. build    — builds every CUDA kernel of the port from ``csrc/`` (all
                nvcc processes started together) into ``build/kernels``;
  3. parity   — each kernel against its plain PyTorch version on the
                card: metric_topk at the CPU tests' shapes, over a
                query-tile sweep (Nq 1, 7, 9, 64, 65, 200; k_top 1 and 256
                at d_out 1000; d_out 33, which the wrapper pads), past its
                256-entry lists on the wide path (k_top 257, 1024, 5000
                and k_top = M) and on a gallery with duplicated rows (ties;
                k_top 9, 256, 257 and M);
                dml_pair forward (loss, d2, proj) and gradients (kernel +
                closed-form backward against autograd through the plain
                version) at the CPU tests' shapes plus ragged ones (d 9,
                33, 4001), and its forward at the training width (B 1000,
                k 1000, d 21504; its proj error printed beside that of
                ``_dispatch.tf32x3_matmul``, the plain 3xTF32 model);
                pairwise_sqdist at square and ragged shapes, k 9 and 1003
                (padded to a multiple of 4), the eval width and M = 8.4M
                (past the grid's y limit); two calls of metric_topk,
                dml_pair and pairwise_sqdist on the same inputs compare
                bit-equal; ivf_scan and pq_adc at the CPU tests' shapes, at
                ragged ones (cap not a multiple of the tile, -1 pads,
                probes with fewer than kk real rows, duplicated rows, kk =
                1, 256, 257, 300 and 1024, the last three on the wide
                path), pq_adc at S 128, 200 and 1000 (its table beside one
                code tile, then in chunks) and both at the serving widths
                (Nq 64 and 1), on 64 queries that probe the same 16
                clusters and on probe ids repeated in a row; ivf_scan's
                work plan made on the card against ``work_plan``, 9,600
                pairs (two plan launches) and k 50,000; flash_attention and ssd_scan
                in f32 and bf16 at the CPU tests' shapes, at ragged T and
                S, GQA 2 and 3, Dh 64, 80 and 256, windows below, at and
                above T, reduced zamba2's p 128 / n 16; ssd_scan also on
                the cases of kernels/ssd_chunk/cases.py (segments forced
                by explicit plans across T's segment edges, odd head
                pairs, one input under two plans, views no TMA map
                describes, B and C per head); flash also at the
                bf16 kernel's tile edges (T = S of 127, 129, 161, 255,
                window 1 and one kv tile, GQA 4 at Dh 256, non-causal
                S < T) and on strided views of a fused qkv projection;
                the asynchronous PS: its server's rule on messages made on
                four worker streams, once with the workers' streams and
                once with the server's held back by a spinning kernel
                (``torch.equal`` to the same rule run on one stream; each
                case fails without one of ``_receive``'s guards), one
                worker message against ``objective_value_and_grad``; and
                the Fig. 4 baselines (``xing2002.pgd_step``, one ITML
                sweep, KISS ``fit`` with PCA) against the same calls on
                the CPU;
  4. training — the Eq. 4 path at dml-imnet1m width (d_in 21504 -> d_out
                1000): 10,000 noisy_subspace rows and 100 classes resident
                on the card, 50k + 50k index pairs (the reference's
                RandomState draws), the example's init rescale, then
                ``train_dml_distributed`` with P = 4 workers on the card,
                1000 pairs per worker per step, sgd(inverse_time(1e-3,
                1e-3)): bsp, then local (tau 4), then ssp (staleness 2);
                checks the dml_pair launch count, finite and falling
                losses, bit-identical bsp copies and one full-width step's
                dL against the plain path; prints ms/step, pairs/s and
                one bsp step's device time by kernel;
  5. eval     — ``knn_accuracy`` of the trained L and of Euclidean on the
                2,000 held-out rows against the 8,000 training rows
                through pairwise_sqdist; checks the launch count and that
                the kernel path's predictions equal the plain path's
                except at a k-th / (k+1)-th distance tie;
 5a. async PS — ``run_async_dml`` (the paper's §4.2 server) at
                dml-imnet1m width on phase 4's data, from phase 4's
                rescaled initial L: P worker threads and the server
                thread, each on a CUDA stream of its own, server_batch 4,
                lr 1e-3, 100 steps a worker, at P = 1, 2 and 4; the P =
                4 call is checked: P x 100 messages from every worker, 1
                <= updates <= messages, a finite L, the last 20 messages'
                mean loss below the first 20's and every thread
                finished; prints ms a message a worker, messages/s,
                updates, messages an update, the deepest inbound queue
                and peak memory; each call runs once under the profiler
                (host time of that call, device busy time as the union
                of kernel and copy intervals over all streams, idle
                share);
 5b. Fig. 3   — on those three calls: wall time and messages/s, and
                the virtual-time speedup of ``benchmarks/fig3_speedup.py``
                (findings, not checks: the P threads share one card);
 5c. Fig. 4   — the reference's Fig. 4 recipe at dml-mnist width (d 780,
                k 600, 1000 pairs a batch): noisy_subspace at noise 3.0,
                60,000 rows, 100k + 100k train and 2,000 + 2,000 eval
                pairs; ours (``train_dml_single`` on dml_pair, 250 steps,
                lr 1e-2, from the rescaled ``init_params``), Xing2002 (50
                PGD steps, lr 5e-2), ITML (4,000 constraints, 2 sweeps),
                KISS (PCA to 390, ridge 1e-4) and Euclidean; checks 250
                dml_pair launches, every M finite and PSD, every AP in
                [0, 1]; prints each AP and training time (ours takes
                its batches from host numpy, the baselines their pairs
                on the card; both these calls under the profiler) and
                whether each of the reference's three Fig. 4 claims
                holds;
  6. serving  — the exact-serving path at dml-imnet1m width (1M x 21504
                -> 1000): a random L from a seeded generator, a 1M-row
                llc_like gallery generated and projected on the card in
                blocks, ExactIndex -> RetrievalEngine -> MicroBatcher
                answering 256 single-query requests; checks the kernel's
                launch count rose and one full batch against the plain
                version; prints QPS, latency, batch size, class purity;
  7. kernels  — times metric_topk, its plain version and one library
                call at the serving shapes;
  8. ANN      — the approximate serving paths on phase 6's L, projected
                gallery and 256 requests: IVFIndex (1024 clusters, nprobe
                16, cap_factor 1.25) on ivf_scan, then IVFPQIndex (the same
                coarse quantizer, 100 x 8-bit codes, exact rerank of 50 on
                the card) on pq_adc, each through RetrievalEngine ->
                MicroBatcher; prints the build time by step, QPS, latency,
                recall@10 against phase 6's exact answers, class purity and
                peak memory; checks the kernel's launch count rose, IVF at
                nprobe = n_clusters against the exact plain version, and
                each kernel against its plain version at the full width,
                pq_adc also at kk 512, and IVFPQ with an exact rerank of
                512 (recall no lower than rerank 50's); then times both
                kernels at Nq = 1 and 64, splits one Nq 64 call of each
                into its launches (CUDA events its launcher records
                between them) and pq_adc's blocks into phases (their
                clock stamps);
 8b. mutation — phase 6's and 8's three indexes, each wrapped as a
                ``MutableIndex`` (ids 0..M-1, auto-compaction off), take
                the same churn in batches of 4,096 rows: 16,384 new rows
                of the requests' classes, 4,096 ids re-upserted with
                fresh rows, 4,096 ids deleted (both id sets hold phase
                6's first two neighbours of the requests), rows made and
                projected on the card; each batch must flush the engine's
                cache once. 8,192 dead base slots, so the base is asked
                for k 8,202 (the wide paths). The 256 requests go through
                RetrievalEngine -> MicroBatcher with tombstones live, then
                after ``compact()`` (IVF / IVFPQ fold into their headroom:
                no rebuild); the exact answers are held to the plain scan
                over the live rows (compare()'s rule) both times, IVF and
                IVFPQ recall@10 to the exact mutable's; the launch counts
                of the base's kernel and of the delta scan (metric_topk)
                must rise; the engine's registry holds the compaction
                event. The exact mutable round-trips a ~4 GB snapshot
                (build/snapshots/, git-ignored, deleted at the phase's
                end), answers bit for bit. Then a cut of 32,768 rows at
                full width, raw rows retained in host memory: exact and
                IVF (128 clusters, nprobe 128) swap to a second seeded L
                and to one of rank 500, each equal to a fresh build; the
                IVF and IVFPQ mutables round-trip their snapshots with
                raw rows; the IVF takes rows past its free capacity and
                spills into a rebuild. Last, each base's kernel at k
                8,202 on 64 queries against its plain version, and the
                base calls' device ms at k 10 and k 8,202. Prints rows/s,
                compaction s, QPS and p50 / p99, swap seconds by step,
                snapshot GB and seconds, and peak memory, each beside the
                card's name and power limit;
 8c. front end — a RequestScheduler with default settings (max_batch 64,
                2 ms wait, watermarks 32 / 4, windows 50 / 500 ms; classes
                interactive 100 ms / 256, batch 1 s / 1024, mining 10 s /
                4096) in front of an engine over each of phases 6 and 8's
                indexes, its ladder run up front (``warmup``). Steady:
                the 256 requests in a 70/20/10 class mix, 8 every 8 ms,
                after a full collection of the garbage collector (one
                over this process's objects pauses it 0.2-0.36 s), the
                collections inside the window timed; every request
                served, the ladder must not move, every batch must run at level
                0's knobs and equal the plain version there, and each
                answer the MicroBatcher's for the same request
                (``_agree``: compare()'s rule where both scanned the same
                segments and, IVFPQ, reranked the same ADC candidates; the
                projection's rounding follows the batch's bucket, so
                requests that probed otherwise are counted, at most
                ``FE_OTHER_MAX``, 5 of 256). Burst: 4,096 requests at once (the 256 rows x
                16 with fresh seeded noise, the same mix) under the tracer
                at rate 1.0; every future resolves once (served,
                RejectedError at submit, DeadlineExceededError), the
                engine sees exactly the served rows, each batch span
                carries its level and knobs, each batch equals the plain
                version at its knobs (pq_adc's plain version in the
                IVFPQ call: bit for bit); IVF and IVFPQ step down at
                least one level, and a request every 10 ms afterwards
                (mining class) brings the ladder back to level 0; the
                exact engine's ladder is ``({},)``. Prints QPS, p50 /
                p99 and served / rejected / expired by class, each
                transition with its trigger, seconds at each level, and
                the ms at Nq 64 of ivf_scan / pq_adc and of the index call
                at each level (graph replay and eager);
 8d. tenants — after phases 6 and 8's indexes are freed: a TenantRouter
                over 262,144 llc_like rows at d_in 21504 made on the card
                (22.5 GB, taken without a copy; 1M rows would be 86 GB),
                tenants t0 exact on phase 6's L (interactive), t1 IVF 256
                clusters nprobe 16 (batch), t2 IVFPQ 256 clusters 100 x
                8-bit rerank 50 (batch), t3 exact at rank 500 (mining),
                seeded factors; a shadow arm on t1 (rate 0.25); a
                scheduler without degradation (``registry=
                router.registry``) and 256 requests a tenant through
                ``router.submit``; every engine call of that traffic (the
                shadow's single-query calls too) against the plain
                version on its inputs (``_check_calls``: metric_topk,
                ivf_scan, pq_adc at 8d's view shapes), each answer
                against ``router.search`` (``_agree``), t0's against the
                plain scan; promote, then t1's answers against the plain
                version and a fresh build of the candidate's view in a
                second router over the same store, bit for bit; 16,384
                rows added and 4,096 removed, each view rebuilt lazily,
                t1 and t2's first calls on the rebuilt views against the
                plain version, the exact tenants against the plain scan
                over the live rows;
                ``memory()`` counts the store once; ``save_tenants`` /
                ``load_tenants`` of a 32,768-row cut (build/snapshots/,
                deleted at the phase's end) bit for bit, and a swapped
                factor raises TenantFingerprintError. Prints view build
                s, QPS and p50 / p99 by tenant, promote s, the shadow's
                overlap@10 and latency ratio, rebuild s, memory and peak
                memory;
 8e. closed loop — 262,144 llc_like rows of phase 6's 1000 classes plus
                N(0, 1.1^2) on every dimension (so classes overlap and
                hard negatives are mined) made on the card (22.5 GB, 8d's
                cut) and 4,096 held-out rows; ``ClosedLoopTrainer``
                (mutable-exact, P = 4 bsp, 1000 pairs a worker a step,
                sgd(inverse_time(1e-3, 1e-3)), 60 steps, a refresh every
                15 with 16,384 anchors mined, train_mined's miner and
                curriculum defaults) from the example's rescaled init,
                over the same tensor as its feature table, its stream's
                and a TenantRouter's store (``copy=False``), the router's
                tenant promoted through its shadow arm at every refresh;
                a kNN hook every 20 steps (held-out rows against the
                first 65,536) on pairwise_sqdist. Checks: dml_pair 4
                launches a step, metric_topk on every sweep, one version
                bump a refresh, every mined pair's label rule, each
                promoted view bit for bit a fresh build in a second
                router, finite losses and the objective on 4,000 pairs of
                the last pool lower under the final L than under L0; the
                last sweep's first two engine calls (Nq 512, k 21) held
                to metric_topk's plain version (compare()), the hook's
                4,096 x 65,536 distances to pairwise_sqdist's; the last
                sweep's pool against the same sweep on metric_topk's
                plain version on the card, and 2,048 anchors mined
                through a RequestScheduler against the direct path: an
                anchor may differ only at a distance tie (the metric_topk
                rule) at a gap the label filter reads (the neighbourhood's
                edge, the two chosen negatives, the semi-hard band's
                edges). Cuts: a mutable-ivf loop over 65,536 rows (256
                clusters, nprobe 16; ivf_scan must launch, its last
                sweep's calls held to compare_ivf) and a frozen exact loop
                over 32,768 (rebuilt at each refresh; held to compare()),
                20 steps each. Then, a finding and not a check,
                ``benchmarks/mining_convergence.py``'s recipe at its own
                widths (N 8000, D 64, rank 16, 128 classes): whether each
                of its pinned claims holds on the card. Prints each
                refresh's seconds by step (swap_metric's host_to_device /
                project / rebuild, promote, mine on the host clock and
                the engine's device time), anchors/s, the mined pairs and
                yields, ms a step and pairs/s beside phase 4's bsp step,
                kNN accuracy, the launches, peak memory and the phase's
                time;
  9. backbone — zamba2-2.7b at full width and depth (54 mamba2 layers,
                d_model 2560, 80 SSM heads of p = n = 64; the shared
                attention + GELU MLP block after every 6th layer, 32 heads
                of 80, window 4096) from the port's seeded init, f32
                weights: ssd_scan on layer 0's real SSD inputs and
                flash_attention on the shared block's real q, k, v at
                B 2, T 8192, bf16 and f32, against the plain versions;
                then one f32 forward (B 1, T 8192) through the kernels
                against the plain path (``plain=True``: the reference's
                chunked Mamba2 and chunked attention), by the final hidden
                state and by ``embed_pool``; then gemma-7b at full width
                (d_model 3072, 16 heads of 256, d_ff 24576), depth cut to 2
                layers, f32, B 1, T 2048: flash_attention at Dh 256 on
                layer 0's q, k, v in bf16 and f32, and the forward through
                the kernels against the plain path by the final hidden
                state and ``embed_pool`` (2 flash_attention launches);
 10. service  — ``launch/serve_embeddings`` with bf16 activations: a
                corpus of 16 x 8192-token sequences embedded in batches of
                4, then 4 request batches of 4 x 8192 tokens ranked under
                a seeded L (2560 -> 64), k = 5; checks that the counts rose
                by 54 ssd_scan and 9 flash_attention launches a forward
                batch and one pairwise_sqdist a ranked batch, finite
                embeddings, and the ranking against the plain distances on
                the same embeddings; prints requests/s, tokens/s, p50 / p99
                ms a batch, peak memory and one batch's device time by
                kind (ssd_scan, flash_attention, GEMMs, other);
 11. kernels  — times ssd_scan and flash_attention at the service's
                shapes (B 4, T 8192, bf16) on real layer inputs, each
                beside its plain version, its bound and (flash) the library
                call, then flash_attention at gemma-7b's shape (B 1, T
                8192, 16 heads of 256, causal, bf16) beside
                scaled_dot_product_attention, and makes the ``kernels``
                line's entries (all seven kernels; flash_attention
                twice; the line itself is printed after phase 15);
 12. decode  — zamba2-2.7b at full width and depth on phase 10's weights:
                ``launch/serve.generate`` (prefill by decode over a
                16-token prompt, then 32 greedy tokens, B 4) at f32
                activations, every step's logits held against ``apply``
                on the same 47 tokens through the kernels (54 ssd_scan
                and 9 flash_attention launches) and plain, max |a - b| /
                max |b| within 1e-4; again with the shared block's window
                cut to 16 (the ring of 16 slots wraps); then the loop at
                the config's bf16 activations, timed (prefill ms,
                ms/token, tokens/s, peak memory), and a 7-step loop under
                the profiler (device busy a step, operations a step).
                Decode launches none of the port's kernels (checked);
 13. gemma    — gemma-7b decode at full width and depth (28 layers, 34 GB
                of f32 weights; the deepest cut that fits if the card
                lacks room, listed), B 4, 16 + 32 tokens, f32, held
                against ``apply`` (28 flash_attention launches) as in 12;
 14. training — smollm-135m at full width and depth through
                ``launch/train.py``'s loop (``train.build``,
                ``train_loop``; AdamW, bf16 activations, f32 weights, B 8,
                T 512, 30 steps): on the full-vocabulary stream (the loss
                logged), then on ``test_system.py``'s stream (ids below
                512), whose mean loss over the last 5 steps must fall
                under 0.85x the first 5; a checkpoint at step 15
                (``build/checkpoints``, deleted after), restored and
                resumed bit-exact against the run that went on; ms/step,
                tokens/s, peak memory, one step under the profiler;
 15. training — zamba2-2.7b at full width cut to one group (6 mamba2
                layers and the shared block), f32, remat, B 2, T 512, 10
                steps on the same stream: the first step's loss within
                1e-5 of the CE of ``apply`` through the kernels on that
                batch, every leaf updated and finite, the loss falling;
                ms/step, peak memory;
 16. rwkv6    — rwkv6-1.6b at full width and depth (24 layers, d_model
                2048, 32 heads of 64, d_ff 7168, vocab 65,536; f32
                weights from the port's seeded init; no kernel of its
                own): (a) layer 0's chunked time mix on its real input
                (B 1, T 2048, f32) against the token-by-token recurrence
                within the reference's bound (rtol 1e-3, atol 1e-4), at
                init and with every w0 at +2 (every log decay at its clamp
                of -5, a chunk's factors up to e^160 above the diagonal);
                (b) at the clamp, T 256, the gradients of x and every leaf
                finite and within 1e-3 of each leaf's largest |b| of the
                recurrence's; (c) decode as in 12 (f32, B 4, 16 + 32
                tokens, every step against ``apply``, which runs whole
                chunks of 32: the tokens padded, causal), then the bf16
                loop timed and profiled; (d) training through
                ``launch/train.py``'s loop as in 15 (f32, remat, B 2, T
                512, 10 steps) at full depth; (e) the embedding service at
                phase 10's traffic (one pairwise_sqdist launch a ranked
                batch and no other kernel);
 17. moe      — granite-moe-1b-a400m at full width and depth (24 layers,
                d_model 1024, GQA 16/8 at Dh 64, 32 experts top 8, expert
                d_ff 512, vocab 49,155, tied) and qwen3-moe-30b-a3b at
                full width (d_model 2048, GQA 32/4 at Dh 128, qk_norm, 128
                experts top 8, expert d_ff 768, vocab 151,936) cut to 16
                of 48 layers (the deepest cut that fits, printed); f32
                weights from the port's seeded init; the expert layer is
                plain torch, attention runs on flash_attention. (a) layer
                0's MoE on its real input (B 1, T 2048, f32): the grouped
                ``apply_moe`` against the every-expert
                ``apply_moe_dense`` at the config's capacity (no pair
                dropped; y within rtol 1e-3 / atol 1e-4 and aux within
                1e-4, the reference's own bound), at capacity factor 0.25
                (pairs dropped, counted) against the dense form with the
                dropped pairs' weights at 0, the gradients of x and every
                leaf against the dense form's (within 1e-3 of each leaf's
                largest |b|), forward and backward run twice
                bit-identical; (b) the full forward through the kernels
                against plain=True (hidden within 1e-4, the router loss
                within 1e-6; one flash_attention launch a layer); (c)
                decode as in 12 (f32, B 4, 16 + 32 tokens; neither apply
                nor decode drops a pair, checked first), then the bf16
                loop timed and profiled; (d) granite-moe training as in
                15 at full depth (the first loss against apply's CE +
                0.01 x its router loss; the router loss a step); (e) the
                granite-moe embedding service: 32 corpus and 32 request
                sequences of 4,096 tokens (granite-3.0's context) in
                batches of 8, one batch's device ms by kind (attention,
                expert GEMMs, dispatch and combine, other GEMMs); (f)
                qwen3-moe's (a)-(c), one timed service batch of 8 x 4,096
                tokens at bf16, and 3 training steps cut to 2 layers.
                Prints the decode, training, rwkv6 and moe numbers as a
                JSON line, then the ``kernels`` line, the backbone
                kernels' entries with their launches in 12-15 (and
                flash_attention's in 17), pairwise_sqdist's with its
                launches in 16e, 17e and 18;
 18. vlm, audio — pixtral-12b at full width and depth (40 layers,
                d_model 5120, GQA 32/8 at Dh 128, d_ff 14336, vocab
                131,072, RoPE at 1e9; 49.1 GB of f32 weights) and
                hubert-xlarge at full width and depth (48 layers, d_model
                1280, 16 heads of 80, non-causal, layernorm, gelu,
                attention biases); seeded f32 weights with every constant
                leaf (biases, norm scales) given N(0, 0.1^2) noise; both
                take frame / patch embeddings through ``frontend_proj``.
                (a) pixtral's forward on patch embeddings (B 1, T 2048,
                f32) through the kernels against plain=True (hidden
                within 1e-4, embed_pool within 1e-5); (b) decode on
                tokens as in 12, then the bf16 loop timed and profiled;
                (d) the service on patch batches of 2 x 4,096 (bf16):
                ``serve_embeddings.serve`` on ``{"embeddings": ...}``
                batches of ``embedding_stream`` (``Model.embed_pool``,
                ranked by pairwise_sqdist), a corpus of 4 batches and 8
                request batches timed, one batch's device ms by kind; (e) flash_attention on a service
                batch's layer-0 q, k, v against attention_ref; (c)
                training cut to 2 layers on ``launch/train.py``'s patch
                batches (the reference launcher's: labels uniform over
                the vocabulary), B 1, T 512, 5 steps, the first loss
                within 1e-6 of apply's CE, the loss falling; then hubert:
                (f) the forward on frames (B 4, T 1500) against plain, and
                bidirectional (frames 750+ moved move the positions
                before 750); (g) ``init_decode_cache`` raises; (i) the
                service on frame batches of 8 x 4,096 (a corpus of 2
                batches, 8 request batches timed) and one forward of
                B 1 x T 32,768, with flash_attention's share; (j) as (e),
                non-causal MHA; (h) training at full depth with remat
                (B 4, T 1500, 5 steps; the first loss within 1e-6, the
                loss falling at lr 3e-4, launch/train.py's default, for
                the reason AUDIO_LR's comment gives); then flash_attention alone at both
                services' shapes against SDPA and its plain version (two
                more ``kernels`` entries);
 19. account  — the dry-run account (``launch/dryrun.py``, counted over
                meta tensors at the card's figures from
                ``launch/mesh.py``): (a) the records of a subset of the
                registry's (arch x shape) pairs holding every family and
                every mode, and of the paper's three DML configs, a line
                each, traced in a pool of ACCOUNT_JOBS processes started
                beside phases 12-18; (b) the account of
                three steps held against the card: smollm-135m training
                (B 8, T 512, phase 14's step), hubert-xlarge training (B
                4, T 1500, f32, remat, 18h's) and phase 4's bsp PS step
                (P 4 x 1000 pairs, d 21504 -> k 1000); each step's time
                must be at least the account's compute_s; its peak
                memory, less what was allocated before its state and
                batch, at least the account's arguments, and the
                account's peak within PEAK_RATIO_BAND of it; printed
                beside: memory_s / the step, the mfu (model FLOPs,
                ``benchmarks/roofline.py``'s 6ND, over the step at its
                dtype's rate) and the step's GEMM kernels by name;
 20. multi-rank — after what earlier phases hold is freed: four ranks
                (``launch/mesh.spawn``, processes sharing the one card, so
                gloo, which stages every collective through the host)
                run (a) the PS of phase 4 with one worker a rank
                (``train_dml_distributed(mesh=)``, 1000 pairs a worker a
                step, bsp, local tau 4, ssp staleness 2, 4 steps each,
                on phase 4's rows, rescaled L0 and one SSP delay table),
                a timed step loop a mode, the bsp copies gathered and
                compared exactly, one ``make_train_chunk`` call (tau 4);
                merged L held within MR_L_RTOL x max |L| of the one-process
                port on the same batches and delays, losses within rtol
                1e-5; (b) phase 6's 1M-row gallery, every rank making and
                projecting all the seeded blocks as phase 6 does (the
                IVF layout takes a rank's clusters' rows from all of
                them), a sharded ``ExactIndex`` keeping the rank's
                quarter of the rows (1 GB) and a sharded ``IVFIndex``
                its clusters (phase 8's 1024 clusters, nprobe 16; the
                k-means on rank 0, broadcast); phase 6's first 64
                requests as one batch at k 10, at k 300 (past the
                256-entry lists) and through the IVF index, timed, then
                through a ``RetrievalEngine`` on rank 0 with the other
                ranks following (``scan.lead`` / ``scan.follow``); the
                answers held to the plain version (``compare()`` /
                ``compare_ivf``'s rules) and counted against the
                one-process indexes on the card. A one-rank mesh over
                NCCL takes one bsp step, bit-identical to the same step
                without a mesh. Every rank's dml_pair, metric_topk and
                ivf_scan launches must rise. Prints ms a step and a batch
                beside the one-process figures, the backend, build
                seconds, memory a rank and peak memory, each beside the
                card's name and power limit and the note that the ranks
                share one card. Alone: ``python -c "import chip_smoke as
                c; card = c.phase_device(); c.phase_build();
                c.phase_multirank(card)"``;
 21. multi-rank moe and loop — four ranks sharing the card over gloo
                again: (a) granite-moe-1b-a400m at full width and depth
                (f32, seeded, the same on every rank) through its
                per-rank program (the experts, heads and
                ffn over model, FSDP over data, the moe nested),
                ``Model.hidden(mesh=)`` on a batch of 4 x 1,024 on (data
                1, model 4), against the one-process model, and on (data
                2, model 2), where FSDP gathers the expert stacks, against
                the one-process model with each moe layer computed as the
                ranks do (``_moe_as_on_2x2``: a batch half apart, the sum
                of the two expert shards' partials) following the
                ranks' routes where they moved a near-tie
                (``_moe_as_on_2x2(follow=)``: each half's top-k ids from
                its model rank 0; the seeded router's near-tied routes
                move under the ranks' other rounding, and one moved
                route reorders its expert's capacity queue): at most
                MOVED_ROUTES_MAX moved, each within ROUTE_TIE_REL of
                the oracle's own k-th probability, and the oracle that
                routes itself within HIDDEN_REL_BOUND on every token no
                moved routing reaches (``_unmoved``); the hidden state
                within HIDDEN_REL_BOUND, its mean pool within
                EMBED_REL_BOUND, moe_aux within MOE_AUX_KERNEL_REL, every
                rank's flash_attention launches one a layer and its
                hidden state's bits equal; 8 decode steps at B 1 on (1, 4)
                against one process's within DECODE_REL_BOUND; (b)
                ``steps.make_train_step(mesh=)`` on (2, 2) cut to
                MRM_TRAIN_LAYERS (the reckoning beside the constants),
                B 2 x T 512, three AdamW steps on one batch: the loss
                falls, the first loss and gradient norm within
                MRM_TRAIN_RTOL of the one-process oracle's, the
                parameters' bits equal across ranks; (c) phase 8e's
                closed loop (mutable-exact, P = 4 bsp, 16,384 anchors) on
                a 65,536-row cut of its store over a worker mesh, 24
                steps, a refresh every 10, against the one-process loop:
                the first pool equal, the later pools' overlap at least
                MRM_POOL_OVERLAP, L within MR_L_RTOL x max |L|, the
                ranks' pools and records equal, the serving stack on rank
                0 alone; (d) ms a forward batch, a token and a step, the
                loop's ms a step and refresh s over ranks beside one
                process's, each rank's peak memory, every figure beside
                the card's name and power limit. A failed check fails
                the phase after every figure is printed. Alone:
                ``python -c "import chip_smoke as c; card =
                c.phase_device(); c.phase_build();
                c.phase_multirank_moe(card)"``;
 22. per-rank program — the dry run's per-rank program (ROADMAP.md Queue
                1 item 8e, first part): (a) rank 0's records (each traced
                on meta in a fake world of 256 or 512 ranks,
                ``launch/mesh.fake_world``, in a pool of RK_JOBS
                processes) of smollm-135m, yi-6b, gemma-7b and
                command-r-35b at train_4k and decode_32k and of the three
                DML configs on 16x16 and pod2x16x16, a line each: FLOPs,
                bytes, arguments (equal to the plan's) and temp, the
                collectives by kind, the roofline with its collective
                term; (b) four ranks sharing the card over gloo (data 2 x
                model 2) run yi-6b at full width cut to RK_LAYERS (one
                layer, so that the script with phase 23 stays near 1,050
                s): the prefill at B 2 x T 4,096 in f32 and bf16 through
                ``Model.apply(mesh=)`` (flash_attention on a rank's 16 q
                and 2 kv heads of 128, a launch a layer a rank), the
                gathered logits held to one process's forward (f32 within
                DECODE_REL_BOUND, phase 13's bound; bf16 within one
                process's own bf16-to-f32 distance); one AdamW step at B 4
                x T 512 (bf16 activations, f32 weights, remat) on the
                rank's own blocks through the step's per-rank map, its
                loss, first moments and gathered parameters held to one
                process's bf16 step (the loss and each moment leaf within
                one process's bf16-to-f32 distance, the parameters within
                2 lr: AdamW's first step moves each by about lr); decode
                at B 2, 4 tokens, f32, within DECODE_REL_BOUND; the
                per-rank Eq. 4 step of dml-imnet63k at its paper width
                (L's 10,000 rows over model, 100 pairs a data rank,
                dml_pair on each rank), dL within 1e-4 x max |dL| of one
                process's; (c) the account of (b)'s step in a fake world
                of the same (2, 2): its collectives by kind (count and
                bytes) equal to what rank 0 issued (the same
                ``CostMode``), its arguments equal to rank 0's blocks and
                its peak within PEAK_RATIO_BAND of rank 0's (its
                max_memory_allocated over the step above what it held
                besides the blocks). Device ms (CUDA events on rank 0)
                beside one process's on each line. Alone: ``python -c
                "import chip_smoke as c; card = c.phase_device();
                c.phase_build(); c.phase_ranks(card)"``;
 23. per-rank families — the per-rank program of the moe, vlm and audio
                families: (a) rank
                0's records of granite-moe-1b, qwen3-moe-30b and
                pixtral-12b at train_4k and decode_32k and of
                hubert-xlarge at train_4k and prefill_32k (at
                ACCOUNT_CHUNKS' attention chunks, for the trace's time)
                on 16x16 and pod2x16x16, traced on meta in a pool of
                RF_JOBS processes started beside phase 22's, a line each,
                each "ok" with the plan's arguments; (b) four ranks
                sharing the card over gloo (data 2 x model 2), each model
                at full width cut to RF_LAYERS: granite-moe-1b's prefill
                at B 2 x T 4,096 in f32 and bf16 (its 32 experts 16 a
                rank, nested in the program) held to one process routing
                each batch half apart (_moe_as_on_2x2; in f32 following
                the ranks' near-ties, as in phase 21), with moe_aux (f32
                within MOE_AUX_KERNEL_REL), one AdamW step at B 4 x T 512
                and decode at B 2, 4 tokens; pixtral-12b's bf16 prefill
                from patch embeddings and its decode on tokens;
                hubert-xlarge's bf16 prefill from frame embeddings
                (non-causal, biases) and one step at B 4 x T 512;
                smollm-135m's bf16 prefill, 9 heads on a model axis of
                2: context parallelism, one flash_attention launch a q
                chunk a layer a rank at its q_offset; phase 22's bounds
                (f32 within DECODE_REL_BOUND, bf16 within RK_BF16_SLACK
                times one process's bf16-to-f32 distance, the bf16
                steps' moments and parameters as 22's, their loss
                within RK_BF16_SLACK times one process's bf16-to-f32
                distance plus RF_LOSS_SE standard errors of its
                per-token distance: a scalar's distance alone can fall
                below the ranks' bf16 noise, as hubert's did at
                5.4e-6), each rank's flash_attention
                launches read; (c) the account of the granite-moe step in
                a fake world of (2, 2): collectives equal to rank 0's,
                arguments equal, peak within PEAK_RATIO_BAND; then
                smollm's last context-parallel slice timed alone for the
                kernels line (kernel, plain version, SDPA with the
                offset's explicit mask). Alone: ``python -c "import
                chip_smoke as c; card = c.phase_device();
                c.phase_build(); c.phase_ranks_families(card)"``;
 24. per-rank recurrent families — the per-rank program of the ssm and
                hybrid families: (a) rank 0's records of rwkv6-1.6b and
                zamba2-2.7b at train_4k and decode_32k on 16x16 and
                pod2x16x16 (full depth), traced on meta in a pool of
                RR_JOBS processes started beside phases 12-18 (with 19
                (a)'s, 22 (a)'s and 23 (a)'s), a line each, each "ok" with
                the plan's arguments; (b) in the spawn of phases 22-24
                (``ranks_spawn``: each rank runs 22's, 23's and 24's
                models in turn, one rank start and one CUDA context for
                the three), both at full width cut to RR_CUT (rwkv6 2 layers;
                zamba2 2 mamba2 layers and one use of the shared block):
                the prefill at B 2 x T 4,096 in f32 and bf16 (rwkv6's 16
                heads and 3,584 ffn columns a rank; zamba2's 40 mamba2
                heads a rank, one ssd_scan a layer, w_xbc gathered whole,
                and the shared block's 16 heads, one flash_attention),
                one bf16 AdamW step at B 4 x T 512 (remat) and decode at
                B 2, 4 tokens, f32 (the cache stacked under the plan's
                specs: rwkv6's wkv state over its key dim, zamba2's conv
                history over its batch, moved to the rank's layout and
                back each step), held to one process with phase 23's
                bounds, each rank's ssd_scan and flash_attention launches
                read; (c) the account of zamba2's step in a fake world of
                (2, 2): collectives equal to rank 0's, arguments equal,
                peak within PEAK_RATIO_BAND; (d) a rank's ssd_scan alone
                (RR_SSD: B 1, T 4,096, 40 heads, p = n = 64, bf16):
                kernel, plain version and bound for the kernels line.
                Alone (spawning its own ranks): ``python -c "import
                chip_smoke as c; card = c.phase_device();
                c.phase_build(); c.phase_ranks_recurrent(card)"``;
 25. the last line: ``{"ok": true, "device": {...}}``.

Every launch count is set to 0 just before a main-path phase (4, 5, 5a,
5c, 6, each index of 8, each serving run of 8b, each burst of 8c, 8d's
tenant traffic, 8e's main run and each of its cuts, gemma's embed_pool
in 9, 10, each decode and each apply beside it in 12, 13 and 16c, each
training run and apply in 14, 15 and 16d, 16e, each forward, decode,
apply, training run and service batch of 17, and each forward, apply,
service run and training run of 18, each rank's PS work and sharded
serving in 20, each rank's forwards and loop in 21, each rank's
prefill and Eq. 4 step in 22, and each rank's prefill of each model in
23 and 24) and read just after
(5a launches no kernel: its gradient is the reference's plain autograd
product);
comparison launches come after the reading (or, for phase 9, before the
counts are reset).

Bounds (``bound_ms``): the larger of the bytes a function must move at
3.35 TB/s and its operations at the card's peak for their type: f32
products (metric_topk, dml_pair, pairwise_sqdist, ivf_scan) at the
3xTF32 rate, 495 / 3 TFLOP/s, the least time of an f32-accurate product
on the tensor cores, with the f32 FFMA figure (67 TFLOP/s) beside it in
the log lines only (the ``kernels`` line holds ``bound_ms``); ssd_scan
on bf16 inputs at the rate of its own f32-accurate arithmetic, three
bf16 passes a product (989 / 3 TFLOP/s) and C B^T in one (989), its
FLOP count at a chunk of 64 fixed in SSD_BOUND_CHUNK, with the 3xTF32
and 2xTF32 figures in its log line only; bf16 attention at 989 TFLOP/s;
pq_adc's table adds at the f32 rate, with its shared-memory lookups
(4 bytes each, 128 bytes a clock an SM at the 1.98 GHz boost clock)
beside the bound in its log line only.

Comparison rules (kernel vs plain, both f32, different summation order).
Distances (metric_topk, pairwise_sqdist) may differ by atol + rtol *
(||a_i||^2 + ||b_j||^2) with rtol = atol = 1e-5, since f32 rounding of
an + bn - 2 a.b scales with the operands, not with their (cancelling)
difference. metric_topk ids must be equal at every rank whose plain
distance is apart from its neighbours' by more than that tolerance; at a
(near-)tie the kernel's id must have the plain distance of that rank.
dml_pair: forward outputs within rtol 2e-5 / atol 1e-5, gradients within
rtol 1e-4 / atol 1e-5 on batches with no d2 within 1e-3 of the margin
(where the hinge mask could flip); the full-width dL within rtol 1e-4 and
atol 1e-4 * max |dL|. ivf_scan: the metric_topk rule, with the row's gn
(BIG on pads). pq_adc: ``torch.equal`` on distances and ids (the
subspace sum runs in the same sequential order on both sides).
flash_attention and ssd_scan: f32 against the f32 plain version within
the reference's bounds for its kernels against their oracles (flash rtol
1e-4 / atol 2e-5, SSD rtol = atol = 1e-4; only the summation order
differs). bf16 inputs against the plain version computed in f32 from the
same bf16 values, elementwise: both kernels compute in f32 and round
their output to bf16 once, at most 2^-8 |out|. So SSD y within
(1e-4 + 2^-8) |ref| + 1e-5, its f32 state h still within the f32 bound;
attention, which also rounds each probability to bf16 before p v (l sums
the f32 ones), within the f32 bound + 2^-8 (|ref| + attention(q, k, |v|)),
the second term bounding sum_s p_s eps_s v_s / l. Each check prints max
|d|, max |ref| and the worst share of its bound. The full-depth f32
forward: max |a - b| / max |b| <= 1e-4 on the final hidden state and
<= 1e-5 on embed_pool, 13 and 30 times the first card readings (7.6e-6
and 3.3e-7; the kernel chunks the SSD by 64, the plain form by 128). The service's
ranked distances within atol + rtol * max D
(rtol = atol = 1e-5) of the plain ranking, ids equal wherever the plain
distances are apart by more than that.
"""

from __future__ import annotations

import contextlib
import gc
import json
import multiprocessing
import os
import queue
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.configs.dml_paper import (IMNET_1M, IMNET_63K,  # noqa: E402
                                           MNIST)
from repro_torch.core import dml, itml, kiss, xing2002  # noqa: E402
from repro_torch.core.dml import init_params  # noqa: E402
from repro_torch.core.eval_tasks import knn_accuracy, knn_vote  # noqa: E402
from repro_torch.checkpoint import (restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.core.losses import (dml_pair_loss,  # noqa: E402
                                     softmax_cross_entropy)
from repro_torch.core.ps import simulator, sync  # noqa: E402
from repro_torch.core.ps.trainer import (  # noqa: E402
    DMLTrainConfig, make_worker_streams, stack_worker_streams,
    train_dml_distributed, train_dml_single)
from repro_torch.data import pairs as pairdata  # noqa: E402
from repro_torch.data.loader import partition_pairs  # noqa: E402
from repro_torch.device import host_array  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._dispatch import (  # noqa: E402
    BIG, tf32x3_matmul, topk_by_distance)
from repro_torch.kernels.dml_pair import (  # noqa: E402
    dml_pair_fused, dml_pair_loss_fused, dml_pair_loss_reference,
    dml_pair_ref)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention)
from repro_torch.kernels.flash_attention.cases import (  # noqa: E402
    PARITY as FA_PARITY)
from repro_torch.kernels.ivf_scan import (  # noqa: E402
    ivf_scan_topk, ivf_scan_topk_fused, ivf_scan_topk_ref)
from repro_torch.kernels.metric_topk import (  # noqa: E402
    metric_sqdist_factored, metric_topk, metric_topk_fused,
    metric_topk_plain, project_gallery)
from repro_torch.kernels.pairwise_dist import (  # noqa: E402
    pairwise_sqdist, pairwise_sqdist_ref)
from repro_torch.kernels.pq_adc import (  # noqa: E402
    pq_adc_topk, pq_adc_topk_fused, pq_adc_topk_ref)
from repro_torch.kernels.ivf_scan.kernel import (  # noqa: E402
    device_plan, max_groups, work_plan)
from repro_torch.kernels.pq_adc.kernel import lut_plan  # noqa: E402
from repro_torch.kernels.ssd_chunk import (  # noqa: E402
    segment_plan, ssd_core, ssd_scan, ssd_scan_chunked)
from repro_torch.kernels.ssd_chunk import cases as ssd_cases  # noqa: E402
from repro_torch.kernels.ssd_chunk.cases import (  # noqa: E402
    BF16_ROUND, SSD_TOL)
from repro_torch.data.tokens import (embedding_stream,  # noqa: E402
                                     token_stream)
from repro_torch.launch import serve, serve_embeddings, train  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as card_figures  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.mining import (ClosedLoopConfig,  # noqa: E402
                                ClosedLoopTrainer, CurriculumSchedule,
                                HardPairMiner, MinerConfig)
from repro_torch.models import (Model, attention, common,  # noqa: E402
                                mamba2, moe, rwkv6)
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.transformer import shared_cfg  # noqa: E402
from repro_torch.obs import percentile  # noqa: E402
from repro_torch.optim import schedules, sgd  # noqa: E402
from repro_torch.serve import (DeadlineExceededError,  # noqa: E402
                               ExactIndex, IVFIndex, IVFPQIndex,
                               MicroBatcher, MutableIndex, RejectedError,
                               RequestScheduler, RetrievalEngine,
                               TenantFingerprintError, TenantRouter,
                               default_ladder, load_index, load_tenants,
                               recall_at_k, save_index, save_tenants)
from repro_torch.serve import pq as pq_mod  # noqa: E402
from repro_torch.serve import scan  # noqa: E402
from repro_torch.serve.ivf import probe  # noqa: E402
from repro_torch.serve.scan import project_queries  # noqa: E402
from repro_torch.sharding import partition  # noqa: E402
from repro_torch.tree import (tree_leaves, tree_map,  # noqa: E402
                              value_and_grad)

RTOL = ATOL = 1e-5
# the card's figures come from launch/mesh.py, as the dry-run account's do
PEAK_F32_FLOPS = card_figures.PEAK_FLOPS_F32    # f32 FFMA
PEAK_TF32_FLOPS = card_figures.PEAK_FLOPS_TF32  # dense TF32, tensor cores
# an f32-accurate product on the tensor cores: 3xTF32, three TF32 passes
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES = card_figures.HBM_BW                # HBM3
# shared memory: 128 bytes a clock an SM, 132 SMs, 1.98 GHz boost clock
PEAK_SMEM_BYTES = 128 * 132 * 1.98e9
PARITY_SHAPES = [(64, 1024, 128, 64, 10), (16, 300, 40, 12, 5),
                 (7, 129, 33, 9, 3), (200, 2048, 96, 48, 20),
                 (128, 512, 128, 128, 1), (8, 96, 24, 8, 96)]
# the query-tile sweep of metric_topk: Nq at and across its 8 / 16 / 64 /
# 128-row tiles; k_top 1 and 256 at d_out 1000 (31.25 stages of 32), and
# d_out 33 (the wrapper pads gp to 36 columns); (Nq, M, d_in, d_out, k_top)
MT_SWEEP = [(nq, 4000, 300, k, kt) for nq in (1, 7, 9, 64, 65, 200)
            for k, kt in ((1000, 1), (1000, 256), (33, 10))]
# k_top past the 256-entry shared-memory lists (the wide path): 257, 1024,
# 5000 (far past the widest list) and k_top = M
MT_WIDE = [(64, 4000, 300, 1000, 257), (7, 4000, 300, 1000, 1024),
           (65, 20000, 96, 200, 5000), (9, 600, 40, 33, 600)]
# (B, k, d); (1000, 600, 780) is Fig. 4's "ours" (phase 5c)
DML_SHAPES = [(8, 8, 8), (64, 32, 48), (256, 128, 512), (100, 60, 780),
              (512, 600, 780), (1000, 600, 780), (32, 100, 224),
              (37, 16, 24), (37, 16, 9), (130, 129, 33), (257, 1000, 4001)]
DML_FULL = (1000, 1000, 21504)  # the training width, forward only
# (N, M, k): square, ragged, k not a multiple of 4 (9, 1003; the wrapper
# pads), the eval width, and M above the grid's y limit of 65535 tiles
# of 128 (narrow k)
PD_SHAPES = [(256, 256, 256), (64, 128, 32), (37, 129, 9),
             (300, 1000, 1000), (129, 517, 1003), (2000, 8000, 1000),
             (5, 8_400_000, 3)]
LAM = 1.3
HINGE_GAP = 1e-3
N_WORKERS = 4
TRAIN_SAMPLES, TRAIN_CLASSES, N_HOLD = 10_000, 100, 2_000
TRAIN_STEPS = {"bsp": 50, "local": 8, "ssp": 6}
KNN_K = 5
# the asynchronous PS phase (dml-imnet1m width, phase 4's data): the P
# whose call takes the checks, constant lr (the base rate of bsp's
# schedule), messages an update; the Fig. 3 measurement at P = 1, 2, 4,
# steps a worker; the server-rule parity check's messages are chains of
# this many elementwise steps (few: every launch queued behind a held
# stream must fit the launch queue, or the host blocks until the hold
# ends), and the side it holds back spins this many cycles (about 2 s
# at the H100's clocks, so that the host's checks land inside the hold
# on a loaded host too)
ASYNC_P, ASYNC_LR, ASYNC_SERVER_BATCH = 4, 1e-3, 4
FIG3_WORKERS, FIG3_STEPS = (1, 2, 4), 100
ASYNC_MSG_CHAIN, ASYNC_HOLD_CYCLES = 2, 4_000_000_000
# Fig. 4 at dml-mnist width: noise 3.0, where the methods separate (at
# the default 0.3 every learned method saturates at AP ~1); lr 1e-2, as
# the reference's 5e-2 diverges at this width with or without the rescale
FIG4_NOISE, FIG4_STEPS, FIG4_LR = 3.0, 250, 1e-2
# ivf_scan parity: (Nq, C, cap, k, nprobe, kk, fill_lo, fill_hi, dup,
# probes); the CPU tests' shapes, then ragged ones (cap 45 / 70 against the
# 32-row tile, k = 1003 off the 16-byte path, empty and under-filled
# segments, kk = 1 and 256, duplicated rows), kk 257 and 1024 (the wide
# path; with pads and ties), the serving widths at Nq 64 and 1, and the
# cluster-major plan's edges: every query probing the same 16 clusters
# (groups of 8 pairs, one hot segment each), probe ids repeated in a row
# and out of range (clipped), 9,600 pairs (two plan launches), Nq 1 at kk
# 256 (more lists than the merge stages at once: merged in batches), and
# k 50,000 (past the old kernel's query row in shared memory). probes:
# "distinct", "skewed" or "repeat" (``_probes``)
IVF_PARITY = [(5, 6, 32, 12, 3, 7, 32, 32, False, "distinct"),
              (3, 5, 24, 8, 2, 5, 10, 24, False, "distinct"),
              (4, 7, 16, 5, 2, 32, 0, 5, False, "distinct"),
              (2, 4, 8, 130, 3, 24, 2, 8, False, "distinct"),
              (9, 12, 45, 1000, 8, 1, 0, 45, False, "distinct"),
              (9, 12, 45, 1000, 8, 256, 0, 45, False, "distinct"),
              (3, 40, 70, 1003, 6, 256, 20, 70, False, "distinct"),
              (7, 10, 45, 64, 4, 30, 10, 45, True, "distinct"),
              (9, 12, 45, 1000, 8, 257, 0, 45, False, "distinct"),
              (3, 40, 70, 1003, 16, 1024, 20, 70, False, "distinct"),
              (7, 10, 45, 64, 8, 300, 10, 45, True, "distinct"),
              (64, 48, 1224, 1000, 16, 10, 1000, 1224, False, "distinct"),
              (1, 48, 1224, 1000, 16, 10, 1000, 1224, False, "distinct"),
              (64, 48, 1224, 1000, 16, 10, 1000, 1224, False, "skewed"),
              (64, 40, 70, 1003, 16, 300, 20, 70, False, "skewed"),
              (9, 12, 45, 1000, 8, 20, 0, 45, False, "repeat"),
              (7, 10, 45, 64, 8, 300, 10, 45, True, "repeat"),
              (600, 64, 40, 16, 16, 10, 10, 40, False, "distinct"),
              (1, 48, 1224, 64, 16, 256, 1000, 1224, False, "distinct"),
              (3, 4, 40, 50_000, 2, 7, 20, 40, False, "distinct")]
# pq_adc parity: (Nq, C, cap, S, bits, nprobe, kk, fill_lo, fill_hi, ties,
# probes); the CPU tests' shapes, ragged ones, kk 257 and 1024 (the wide
# path, with pads and ties), S 200 and 1000 (d_out 1000 in 5- and
# 1-dimensional subspaces: the table in chunks), S 128 (whole table, one
# code tile), the serving widths at Nq 64 and 1 (and Nq 1 at kk 256: more
# lists than the merge stages at once, merged in batches), every query
# probing the same clusters, and probe ids repeated in a row (in range:
# the plain version gathers without clipping)
PQ_PARITY = [(5, 6, 32, 4, 8, 3, 7, 32, 32, False, "distinct"),
             (3, 5, 24, 3, 8, 2, 5, 10, 24, False, "distinct"),
             (4, 7, 16, 2, 8, 2, 32, 0, 5, False, "distinct"),
             (3, 4, 16, 5, 1, 2, 6, 8, 16, False, "distinct"),
             (3, 4, 16, 5, 2, 2, 6, 8, 16, False, "distinct"),
             (2, 4, 8, 3, 4, 3, 24, 2, 8, False, "distinct"),
             (9, 12, 300, 100, 8, 6, 1, 0, 300, False, "distinct"),
             (9, 12, 300, 100, 8, 6, 256, 0, 300, False, "distinct"),
             (6, 7, 24, 3, 2, 4, 15, 20, 24, True, "distinct"),
             (9, 12, 300, 100, 8, 6, 257, 0, 300, False, "distinct"),
             (6, 20, 100, 3, 2, 12, 1024, 20, 100, True, "distinct"),
             (5, 8, 300, 200, 8, 4, 50, 100, 300, False, "distinct"),
             (3, 8, 300, 200, 8, 4, 1024, 100, 300, False, "distinct"),
             (2, 4, 64, 1000, 8, 3, 20, 30, 64, False, "distinct"),
             (4, 8, 600, 128, 8, 4, 256, 300, 600, False, "distinct"),
             (64, 48, 1224, 100, 8, 16, 50, 1000, 1224, False, "distinct"),
             (1, 48, 1224, 100, 8, 16, 50, 1000, 1224, False, "distinct"),
             (1, 48, 1224, 100, 8, 16, 256, 1000, 1224, False, "distinct"),
             (64, 48, 1224, 200, 8, 16, 50, 1000, 1224, False, "distinct"),
             (64, 48, 1224, 100, 8, 16, 50, 1000, 1224, False, "skewed"),
             (64, 48, 1224, 100, 8, 16, 512, 1000, 1224, False, "skewed"),
             (9, 12, 300, 100, 8, 6, 40, 0, 300, True, "repeat")]
N_CLUSTERS, NPROBE, CAP_FACTOR, KM_ITERS = 1024, 16, 1.25, 10
PQ_SUBSPACES, PQ_BITS, RERANK, RERANK_WIDE = 100, 8, 50, 512
SERVE_BUCKETS = (1, 8, 64, 512)
N_REQUESTS = 256
MAX_BATCH = 64
K_TOP = 10
WIDE_K = 1024               # a k_top on metric_topk's wide path, timed
# phase 8b: the churn at full width (rows upserted as new, ids re-upserted
# with fresh rows, ids deleted; batches of MUT_BATCH rows), the engine's
# buckets there (the batcher's batches reach 64), and the cut for the
# metric swaps, the spill and the raw-row snapshots: rows (widths kept),
# IVF clusters, the changed rank; snapshots go to a git-ignored directory
MUT_NEW, MUT_UPDATE, MUT_DELETE, MUT_BATCH = 16_384, 4_096, 4_096, 4_096
MUT_BUCKETS = (1, 8, 64)
CUT_ROWS, CUT_CLUSTERS, CUT_RANK = 32_768, 128, 500
SNAPSHOT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "snapshots")
DEV = torch.device("cuda")


def log(msg: str) -> None:
    print(msg, flush=True)


# -- comparison -------------------------------------------------------------

def compare(L, q, gp, gn, k_top, dk, ik):
    """Hold a kernel result (dk, ik) against the plain version on the
    same inputs (rule in the module docstring). Returns max |d_k - d_p|."""
    dp, ip = metric_topk_plain(L, q, gp, gn, k_top)
    qp = q @ L.T
    qn = torch.sum(qp * qp, dim=1)
    D = metric_sqdist_factored(qp, gp, gn)              # (Nq, M) plain
    tol = ATOL + RTOL * (qn[:, None] + gn[ip.long()])
    err = (dk - dp).abs()
    assert bool((err <= tol).all()), \
        f"distances disagree: max err {err.max().item():.3e}"
    # ranks whose plain distance is apart from both neighbours' (the
    # (k_top+1)-th plain distance bounds the last rank)
    ext = torch.sort(D, dim=1, stable=True).values[:, :k_top + 1]
    if ext.shape[1] == k_top:
        ext = torch.cat([ext, torch.full_like(ext[:, :1], float("inf"))], 1)
    lo = torch.cat([torch.full_like(dp[:, :1], -float("inf")), dp[:, :-1]], 1)
    apart = ((dp - lo) > tol) & ((ext[:, 1:] - dp) > tol)
    same = ik == ip
    assert bool(same[apart].all()), "ids disagree at distinct distances"
    # near-ties: the kernel's id must carry the plain distance of its rank
    dk_plain = torch.gather(D, 1, ik.long())
    assert bool(((dk_plain - dp).abs() <= tol).all()), \
        "kernel returned a neighbour outside the tie group"
    srt = torch.sort(ik, dim=1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all()), "duplicate ids"
    return err.max().item(), int((~same).sum().item())


def _data(nq, m, d, k, seed):
    rng = np.random.RandomState(seed)
    L = torch.tensor(0.3 * rng.randn(k, d), dtype=torch.float32, device=DEV)
    q = torch.tensor(rng.randn(nq, d), dtype=torch.float32, device=DEV)
    G = torch.tensor(rng.randn(m, d), dtype=torch.float32, device=DEV)
    return L, q, G


# -- phases -----------------------------------------------------------------

def phase_device():
    assert torch.cuda.is_available(), "CUDA is not available"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    return smi


def phase_build():
    t0 = time.perf_counter()
    sources = _build.all_sources()
    libs = _build.build(sources)
    log(f"build: {len(libs)} librar(y/ies) in "
        f"{time.perf_counter() - t0:.1f}s -> {sorted(libs)}")
    for name, text in _build.build_logs.items():
        kernel = "?"
        for line in text.splitlines():
            entry = re.search(r"(?:entry function|properties for) '?(\w+)",
                              line)
            if entry:
                kernel = _demangle(entry.group(1))
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}] {kernel}: {line.strip()}")


def _demangle(symbol):
    """A kernel's readable name for the ptxas report (c++filt, shipped with
    the host compiler nvcc needs), its anonymous namespace and parameter
    list dropped; the symbol itself where c++filt is missing."""
    try:
        out = subprocess.run(["c++filt", symbol], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol
    out = re.sub(r"\(anonymous namespace\)::", "", out or symbol)
    return re.sub(r"^void |\(.*\)$", "", out)


def phase_parity():
    for nq, m, d, k, kt in PARITY_SHAPES + MT_SWEEP + MT_WIDE:
        L, q, G = _data(nq, m, d, k, seed=nq + m + k)
        gp, gn = project_gallery(L, G)
        before = metric_topk_fused.launches
        dk, ik = metric_topk_fused(q, L, gp, gn, k_top=kt)
        dk2, ik2 = metric_topk_fused(q, L, gp, gn, k_top=kt)
        torch.cuda.synchronize()
        assert metric_topk_fused.launches == before + 2
        err, n_diff = compare(L, q, gp, gn, kt, dk, ik)
        assert torch.equal(dk, dk2) and torch.equal(ik, ik2), \
            "two metric_topk calls differ"
        log(f"parity {(nq, m, d, k, kt)}: max |dd| {err:.3e}, "
            f"{n_diff} tie-resolved id differences; repeat bit-equal")
    # duplicated gallery rows: every row appears 3 times, so each true
    # neighbour ties with two copies and the smaller ids must win
    L, q, G = _data(24, 200, 32, 16, seed=7)
    G = torch.cat([G, G, G])[torch.randperm(600, generator=torch.Generator(
        device="cpu").manual_seed(0)).to(DEV)]
    gp, gn = project_gallery(L, G)
    for kt in (9, 256, 257, 600):
        dk, ik = metric_topk_fused(q, L, gp, gn, k_top=kt)
        torch.cuda.synchronize()
        err, n_diff = compare(L, q, gp, gn, kt, dk, ik)
        tied = dk[:, 1:] == dk[:, :-1]      # copies give bitwise-equal d
        assert int(tied.sum()) > 0, "no exact ties in the duplicated gallery"
        assert bool((ik[:, 1:] > ik[:, :-1])[tied].all()), \
            "equal distances not in ascending id order"
        log(f"parity duplicated rows, k_top {kt}: max |dd| {err:.3e}, "
            f"{int(tied.sum())} exact ties all smallest-id-first, {n_diff} "
            f"id differences")
    for bad in (0, 601):
        try:
            metric_topk_fused(q, L, gp, gn, k_top=bad)
        except ValueError:
            continue
        raise AssertionError(f"k_top={bad} was not refused")


# -- training kernels: parity ----------------------------------------------

def _pair_data(B, k, d, seed):
    """Pairs with O(1) d2, both sim values, and a margin in the widest gap
    between consecutive d2 values of the middle half (no pair within
    HINGE_GAP of the hinge)."""
    rng = np.random.RandomState(seed)
    L = rng.randn(k, d) / np.sqrt(k * d)
    xs, ys = rng.randn(B, d), rng.randn(B, d)
    sim = (np.arange(B) % 2).astype(np.int32)
    rng.shuffle(sim)
    d2 = np.sort(np.sum(((xs - ys) @ L.T) ** 2, axis=1))
    lo = B // 4
    i = lo + int(np.argmax(np.diff(d2[lo:max(lo + 2, 3 * B // 4)])))
    margin = float(0.5 * (d2[i] + d2[i + 1]))
    assert np.min(np.abs(d2 - margin)) > HINGE_GAP
    f32 = dict(dtype=torch.float32, device=DEV)
    return (torch.tensor(L, **f32), torch.tensor(xs, **f32),
            torch.tensor(ys, **f32), torch.tensor(sim, device=DEV), margin)


def _grads(loss_fn, L, xs, ys, sim, lam, margin, wrt=3):
    """Gradients of ``loss_fn`` w.r.t. the first ``wrt`` of (L, xs, ys)."""
    args = [t.detach().clone().requires_grad_(i < wrt)
            for i, t in enumerate((L, xs, ys))]
    loss_fn(*args, sim, lam, margin).backward()
    return [a.grad for a in args[:wrt]]


def _max_err(outs, refs):
    return max(float((a - b).abs().max()) for a, b in zip(outs, refs))


def compare_dist(D, xp, yp):
    """Hold a kernel distance matrix against the plain version (distance
    rule in the module docstring). Returns (max |D - D_plain|, D_plain)."""
    D_ref = pairwise_sqdist_ref(xp, yp)
    xn, yn = torch.sum(xp * xp, 1), torch.sum(yp * yp, 1)
    err = (D - D_ref).abs()
    assert D.shape == D_ref.shape and bool((D >= 0).all())
    assert bool((err <= ATOL + RTOL * (xn[:, None] + yn[None, :])).all()), \
        f"distances disagree: max err {err.max().item():.3e}"
    return err.max().item(), D_ref


def phase_parity_training():
    for B, k, d in DML_SHAPES:
        L, xs, ys, sim, margin = _pair_data(B, k, d, seed=B + k + d)
        out = dml_pair_fused(L, xs, ys, sim, lam=LAM, margin=margin)
        ref = dml_pair_ref(L, xs, ys, sim, LAM, margin)
        gk = _grads(dml_pair_loss_fused, L, xs, ys, sim, LAM, margin)
        gp = _grads(dml_pair_loss_reference, L, xs, ys, sim, LAM, margin)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-5)
        for a, b in zip(gk, gp):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        log(f"parity dml_pair (B, k, d) {(B, k, d)}: forward max |d| "
            f"{_max_err(out, ref):.3e}, gradient max |d| "
            f"{_max_err(gk, gp):.3e}")
    # the training width, forward only (a margin amid 1000 pairs' d2 has
    # no 1e-3 gap to hold gradients at; the hinge is continuous)
    B, k, d = DML_FULL
    gen = torch.Generator(device=DEV).manual_seed(1)
    L = torch.randn((k, d), generator=gen, device=DEV) / (k * d) ** 0.5
    xs, ys = (torch.randn((B, d), generator=gen, device=DEV)
              for _ in range(2))
    sim = (torch.rand((B,), generator=gen, device=DEV) < 0.5).to(torch.int32)
    margin = float(torch.median(dml_pair_ref(L, xs, ys, sim)[1]))
    out = dml_pair_fused(L, xs, ys, sim, lam=LAM, margin=margin)
    again = dml_pair_fused(L, xs, ys, sim, lam=LAM, margin=margin)
    ref = dml_pair_ref(L, xs, ys, sim, LAM, margin)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(out, again)), \
        "two dml_pair calls differ"
    # the plain 3xTF32 model of the kernel's product, for comparison
    model_err = float((tf32x3_matmul(xs - ys, L) - ref[2]).abs().max())
    log(f"parity dml_pair (B, k, d) {DML_FULL}: forward max |d| "
        f"{_max_err(out, ref):.3e} (proj {_max_err(out[2:], ref[2:]):.3e}; "
        f"the 3xTF32 model's proj {model_err:.3e}); repeat bit-equal")
    del L, xs, ys, out, again, ref
    for n, m, k in PD_SHAPES:
        rng = np.random.RandomState(n + m + k)
        xp = torch.tensor(rng.randn(n, k), dtype=torch.float32, device=DEV)
        yp = torch.tensor(rng.randn(m, k), dtype=torch.float32, device=DEV)
        D = pairwise_sqdist(xp, yp)
        err, _ = compare_dist(D, xp, yp)
        assert torch.equal(D, pairwise_sqdist(xp, yp)), \
            "two pairwise_sqdist calls differ"
        log(f"parity pairwise_sqdist (N, M, k) {(n, m, k)}: max |dD| "
            f"{err:.3e}; repeat bit-equal")


# -- the asynchronous PS and the Fig. 4 baselines: parity -------------------

def _message(i, shape):
    """A deterministic gradient message: a short chain of elementwise
    ops, bit-reproducible on any stream."""
    x = torch.arange(shape[1], dtype=torch.float32, device=DEV) * 1e-4 \
        + 0.01 * (i + 1)
    x = x.expand(shape).contiguous()
    for _ in range(ASYNC_MSG_CHAIN):
        x = torch.sin(x) * 1.25 + 0.1
    return x


def _server_case(late, first, P=4, K=4, shape=(2048, 4096)):
    """One ``_Server`` run on P x K messages (``_message(first + i)``)
    made on P worker streams and queued before it starts, with one side
    held back by a spinning kernel, so that a missing guard of
    ``simulator._receive`` shows:

    ``late="producers"``: each worker stream spins before it writes its
    messages, so the server's stream reads them before they are written
    unless it waits on the producer's event (``wait_event``);
    ``late="server"``: the server's stream spins before its first read;
    once the server thread has taken every message (and dropped the
    references to all but the last batch), each worker stream allocates
    and writes NaN into P x K blocks of the messages' size, so a message
    block handed back to its producer's stream before the server's read
    ran is overwritten unless the server marked it (``record_stream``).

    Checks that the window was open (the held side had not finished when
    the other side's work was done), then that the server's L and every
    broadcast equal the same means and updates done sequentially on one
    stream."""
    cfg = simulator.AsyncPSConfig(n_workers=P, lr=1e-2, server_batch=3)
    L0 = torch.randn(shape, generator=torch.Generator(
        device=DEV).manual_seed(11), device=DEV)
    # the sequential rule first: it also loads every kernel the held run
    # launches (a first launch loads its module, which can block the host
    # until the hold ends)
    msgs = [_message(first + i, shape) for i in range(P * K)]
    L = L0
    for c in range(0, len(msgs), cfg.server_batch):
        grp = msgs[c:c + cfg.server_batch]
        g = grp[0]
        for h in grp[1:]:
            g = g + h
        L = L - cfg.lr * (g / len(grp))
    del msgs, grp, g
    torch.cuda._sleep(1)
    torch.full((1,), float("nan"), device=DEV)
    inboxes = [queue.Queue(maxsize=1) for _ in range(P)]
    server = simulator._Server(L0, cfg, inboxes)
    streams = [torch.cuda.Stream() for _ in range(P)]
    n_up = -(-P * K // cfg.server_batch)
    torch.cuda.synchronize()
    for s in (streams if late == "producers" else [server.stream]):
        with torch.cuda.stream(s):
            torch.cuda._sleep(ASYNC_HOLD_CYCLES)
    for j in range(K):
        for w, s in enumerate(streams):
            with torch.cuda.stream(s):
                server.inbound.put(simulator._send(
                    _message(first + j * P + w, shape), s))
    server.start()
    while server.n_updates < n_up and server.thread.is_alive():
        time.sleep(1e-3)
    junk = []
    if late == "server":
        for s in streams:
            with torch.cuda.stream(s):
                junk += [torch.full(shape, float("nan"), device=DEV)
                         for _ in range(P * K)]
        for s in streams:
            s.synchronize()
        assert not server.stream.query(), \
            "the server's stream ran before the worker streams' writes"
    else:
        assert not any(s.query() for s in streams), \
            "a worker stream finished before the server took its messages"
    server.stop()
    assert server.error is None and not server.thread.is_alive()
    torch.cuda.synchronize()
    del junk
    assert server.n_updates == n_up, f"{server.n_updates} server updates"
    assert torch.equal(server.L, L), \
        f"late {late}: server L differs from the sequential rule"
    for inbox in inboxes:
        assert torch.equal(simulator._receive(inbox.get_nowait(), None), L), \
            f"late {late}: a broadcast differs from the sequential rule"
    log(f"parity async PS server, {late} held back: {P * K} messages of "
        f"{shape} from {P} worker streams, server_batch "
        f"{cfg.server_batch}: {server.n_updates} updates, L and {P} "
        f"broadcasts bit-equal to the sequential rule on one stream")


def parity_async_server():
    """``_Server``'s update rule across streams: the two cases of
    ``_server_case``, each of which fails without one of ``_receive``'s
    guards (the producer's event, ``record_stream``)."""
    _server_case("producers", 0)
    _server_case("server", 100)


def parity_async_worker():
    """One worker message (the worker on its own stream) against
    ``objective_value_and_grad`` on the same L and batch."""
    B, k, d, n = 512, 128, 1024, 4096
    rng = np.random.RandomState(12)
    pairs_np = {"xs": rng.randn(n, d).astype(np.float32),
                "ys": rng.randn(n, d).astype(np.float32),
                "sim": (rng.rand(n) < 0.5).astype(np.int32)}
    L0 = torch.tensor(rng.randn(k, d) / np.sqrt(2.0 * d * k),
                      dtype=torch.float32, device=DEV)
    cfg = simulator.AsyncPSConfig(n_workers=2, lr=1e-2, batch_size=B,
                                  steps_per_worker=1, seed=4)
    streams = make_worker_streams(pairs_np, 2, B, seed=cfg.seed + 1000,
                                  device=DEV)
    server = simulator._Server(L0, cfg, [])
    trace = []
    torch.cuda.synchronize()
    worker = simulator._Worker(1, L0, streams[1], cfg, server,
                               queue.Queue(maxsize=1),
                               simulator._make_grad_fn(cfg.lam, cfg.margin),
                               trace, threading.Lock(), time.perf_counter())
    worker.start()
    worker.join()
    assert worker.error is None and not worker.thread.is_alive()
    torch.cuda.synchronize()
    g = simulator._receive(server.inbound.get_nowait(), None)
    b = next(make_worker_streams(pairs_np, 2, B, seed=cfg.seed + 1000,
                                 device=DEV)[1])
    loss, g_ref = dml.objective_value_and_grad(L0, b["xs"], b["ys"],
                                               b["sim"], cfg.lam, cfg.margin)
    torch.testing.assert_close(g, g_ref, rtol=1e-5, atol=1e-7)
    assert abs(trace[0][2] - float(loss)) <= 1e-5 * abs(float(loss))
    log(f"parity async PS worker message (B, k, d) {(B, k, d)}: max |dg| "
        f"{float((g - g_ref).abs().max()):.3e} (max |g| "
        f"{float(g_ref.abs().max()):.3e}), bit-equal {torch.equal(g, g_ref)}; "
        f"loss {trace[0][2]:.6f} vs {float(loss):.6f}")


def _rel_err(a, b):
    a, b = a.cpu(), b.cpu()
    return float((a - b).abs().max() / b.abs().max())


def parity_baselines():
    """``xing2002.pgd_step``, one ITML sweep and KISS ``fit`` (PCA) on the
    card against the same calls with ``device="cpu"``: eigh and inv are
    cuSOLVER there and LAPACK here, products sum in other orders. Held to
    max |card - cpu| <= tol * max |cpu|: 1e-4 for pgd_step and ITML,
    1e-3 for KISS (two inversions of covariances before its projection)."""
    d = 96
    feats, labels = pairdata.make_features(pairdata.PairDatasetConfig(
        n_samples=800, feat_dim=d, n_classes=5, kind="noisy_subspace",
        noise=1.0, seed=3))
    feats = feats / np.float32(np.sqrt(2 * 9.0 * d))
    p = pairdata.sample_pairs(feats, labels, 1000, 1000, seed=4)
    rng = np.random.RandomState(6)
    A = rng.randn(d, d // 2) / np.sqrt(d)
    M0 = torch.tensor(A @ A.T, dtype=torch.float32)
    outs = {}
    for dev in ("cpu", DEV):
        t = {k: torch.from_numpy(v).to(dev) for k, v in p.items()}
        M, loss = xing2002.pgd_step(M0.to(dev), t["xs"][:500],
                                    t["ys"][:500], t["sim"][:500],
                                    lam=1.0, margin=1.0, lr=5.0)
        Mi = itml.fit(itml.ITMLConfig(feat_dim=d, sweeps=1), t["xs"][:300],
                      t["ys"][:300], t["sim"][:300], device=dev)
        Mk, proj = kiss.fit(kiss.KISSConfig(feat_dim=d, pca_dim=d // 2,
                                            ridge=1e-4),
                            t["xs"], t["ys"], t["sim"], device=dev)
        outs[str(dev)] = (M, loss, Mi, proj @ Mk @ proj.T)
    cpu, card = outs["cpu"], outs[str(DEV)]
    errs = {name: _rel_err(card[i], cpu[i])
            for i, name in ((0, "pgd_step M"), (1, "pgd_step loss"),
                            (2, "ITML M"), (3, "KISS proj M proj^T"))}
    for name, tol in (("pgd_step M", 1e-4), ("pgd_step loss", 1e-4),
                      ("ITML M", 1e-4), ("KISS proj M proj^T", 1e-3)):
        assert errs[name] <= tol, f"{name}: card vs cpu {errs[name]:.3e}"
    log("parity baselines, card vs cpu (max |d| / max |cpu|), d 96: " +
        ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))


def phase_parity_async():
    parity_async_server()
    parity_async_worker()
    parity_baselines()


# -- segment-scan kernels: parity --------------------------------------------

def _segments(rng, C, cap, lo, hi):
    """Per-cluster fills in [lo, hi] (possibly empty) and global ids."""
    fills = rng.randint(lo, hi + 1, size=C)
    ids = np.full((C, cap), -1, np.int32)
    nid = 0
    for c in range(C):
        ids[c, :fills[c]] = np.arange(nid, nid + fills[c])
        nid += fills[c]
    return fills, ids


def _probes(rng, nq, C, nprobe, mode="distinct"):
    """(nq, nprobe) int32 probe ids: distinct clusters a row; "skewed":
    every row the same clusters; "repeat": ids repeated within a row and,
    in the ivf cases, out of range (the scan clips them)."""
    if mode == "skewed":
        pr = np.tile(rng.choice(C, nprobe, replace=False), (nq, 1))
    elif mode == "repeat":
        pr = rng.randint(0, C, (nq, nprobe))
        pr[:, 1] = pr[:, 0]
        pr[:, 2::3] = pr[:, 2:3]
    else:
        pr = np.stack([rng.choice(C, nprobe, replace=False)
                       for _ in range(nq)])
    return torch.tensor(pr, dtype=torch.int32, device=DEV)


def ivf_case(seed, nq, C, cap, k, nprobe, lo, hi, dup, mode="distinct"):
    """(qp, probes, g, gn, ids) on the card in the IVF segment layout;
    ``dup`` repeats each segment's first real row, so distances tie;
    ``mode`` as ``_probes`` ("repeat" also puts ids out of range)."""
    rng = np.random.RandomState(seed)
    fills, ids = _segments(rng, C, cap, lo, hi)
    real = torch.tensor(ids >= 0, device=DEV)
    g = torch.tensor(rng.randn(C, cap, k).astype(np.float32), device=DEV)
    if dup:
        g = g[:, :1].expand(-1, cap, -1).contiguous()
    g = g * real[..., None]
    gn = torch.where(real, torch.sum(g * g, dim=2), torch.full_like(g[..., 0],
                                                                  BIG))
    qp = torch.tensor(rng.randn(nq, k).astype(np.float32), device=DEV)
    probes = _probes(rng, nq, C, nprobe, mode)
    if mode == "repeat":
        probes[:, -1] = C + 3
        probes[0, 0] = -2
    return qp, probes, g, gn, torch.tensor(ids, device=DEV)


def pq_case(seed, nq, C, cap, S, bits, nprobe, lo, hi, ties,
            mode="distinct"):
    """(tables, dc, probes, codes, t, ids) on the card in the IVFPQ
    layout; ``ties`` draws codes from two values and t, tables from
    coarse grids, so many candidates tie exactly."""
    rng = np.random.RandomState(seed)
    K = 1 << bits
    fills, ids = _segments(rng, C, cap, lo, hi)
    real = ids >= 0
    codes = rng.randint(0, 2 if ties else K, (C, cap, S)) * real[..., None]
    t = np.where(real, rng.randint(0, 3, (C, cap)) if ties
                 else rng.randn(C, cap), BIG).astype(np.float32)
    tables = rng.randn(nq, S * K).astype(np.float32)
    if ties:
        tables = np.round(tables * 4) / 4
    dc = np.abs(rng.randn(nq, nprobe)).astype(np.float32)
    return (torch.tensor(tables, device=DEV), torch.tensor(dc, device=DEV),
            _probes(rng, nq, C, nprobe, mode),
            torch.tensor(codes.astype(np.uint8), device=DEV),
            torch.tensor(t, device=DEV), torch.tensor(ids, device=DEV))


def compare_ivf(qp, probes, g, gn, ids, kk, dk, ik, repeats=False):
    """Hold an ivf_scan kernel result against the plain version on the
    same inputs (the metric_topk rule with each row's gn). Returns
    (max |d_k - d_p|, ids differing at ties). ``repeats``: a row probes
    some cluster twice, so an id may come back twice."""
    dp, ip = ivf_scan_topk_ref(qp, probes, g, gn, ids, kk)
    qn = torch.sum(qp * qp, dim=1)
    gn_of = torch.full((int(ids.max()) + 2,), BIG, device=DEV)
    gn_of[ids[ids >= 0].long()] = gn[ids >= 0]            # id -1 -> BIG
    tol = ATOL + RTOL * (qn[:, None] + gn_of[ip.long()])
    err = (dk - dp).abs()
    assert bool((err <= tol).all()), \
        f"distances disagree: max err {err.max().item():.3e}"
    pool = probes.shape[1] * g.shape[1]
    inf = torch.full_like(dp[:, :1], float("inf"))
    nxt = (ivf_scan_topk_ref(qp, probes, g, gn, ids, kk + 1)[0][:, kk:]
           if kk < pool else inf)
    apart = ((dp - torch.cat([-inf, dp[:, :-1]], 1)) > tol) & \
        ((torch.cat([dp[:, 1:], nxt], 1) - dp) > tol)
    same = ik == ip
    assert bool(same[apart].all()), "ids disagree at distinct distances"
    real = torch.sort(ik, dim=1).values
    dup = (real[:, 1:] == real[:, :-1]) & (real[:, 1:] >= 0)
    assert repeats or not bool(dup.any()), "duplicate ids"
    assert torch.equal(ik < 0, ip < 0), "pad slots disagree"
    return err.max().item(), int((~same).sum().item())


def phase_parity_ann():
    # ivf_scan's work plan, made on the card, against its plain mirror
    rng = np.random.RandomState(0)
    for nq, C, nprobe, mode in ((1, 1024, 16, "distinct"),
                                (64, 1024, 16, "distinct"),
                                (64, 1024, 16, "skewed"),
                                (64, 7, 16, "repeat"),
                                (512, 1024, 16, "distinct")):
        probes = _probes(rng, nq, C, nprobe, mode)
        if mode == "repeat":
            probes[:, -1] = C + 3
        got = device_plan(probes, C)
        (_, *want), = work_plan(probes.cpu(), C)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            f"ivf_scan's plan differs from work_plan at {(nq, C, nprobe)}"
        log(f"ivf_scan plan (Nq, C, nprobe) {(nq, C, nprobe)} {mode}: "
            f"{len(got[1])} groups (at most {max_groups(nq * nprobe, C)}), "
            f"equal to work_plan")
    for seed, case in enumerate(IVF_PARITY):
        *shape, kk, lo, hi, dup, mode = case
        args = ivf_case(seed, *shape, lo, hi, dup, mode)
        before = ivf_scan_topk_fused.launches
        dk, ik = ivf_scan_topk(*args, kk=kk)
        torch.cuda.synchronize()
        assert ivf_scan_topk_fused.launches == before + 1
        err, n_diff = compare_ivf(*args, kk, dk, ik, mode == "repeat")
        n_pad = int((ik < 0).sum())
        if dup:
            tied = dk[:, 1:] == dk[:, :-1]
            assert int(tied.sum()) > 0, "no exact ties in the duplicated rows"
            order = (ik[:, 1:] >= ik[:, :-1] if mode == "repeat"
                     else ik[:, 1:] > ik[:, :-1])
            assert bool(order[tied & (ik[:, :-1] >= 0)].all()), \
                "equal distances not in ascending id order"
        log(f"parity ivf_scan (Nq, C, cap, k, nprobe) {tuple(shape)} kk={kk} "
            f"{mode}: max |dd| {err:.3e}, {n_diff} tie-resolved id "
            f"differences, {n_pad} pad (-1) entries"
            f"{', exact ties' if dup else ''}")
    for seed, case in enumerate(PQ_PARITY):
        *shape, kk, lo, hi, ties, mode = case
        args = pq_case(seed, *shape, lo, hi, ties, mode)
        before = pq_adc_topk_fused.launches
        dk, ik = pq_adc_topk(*args, kk=kk)
        dp, ip = pq_adc_topk_ref(*args, kk)
        torch.cuda.synchronize()
        assert pq_adc_topk_fused.launches == before + 1
        assert torch.equal(dk, dp) and torch.equal(ik, ip), \
            f"pq_adc {tuple(shape)} kk={kk} {mode} is not bit-identical"
        S, K = shape[3], 1 << shape[4]
        log(f"parity pq_adc (Nq, C, cap, S, bits, nprobe) {tuple(shape)} "
            f"kk={kk} {mode}: bit-identical, {int((ik < 0).sum())} pad "
            f"entries{', exact ties' if ties else ''}; table plan (subspaces "
            f"a chunk, code tiles) {lut_plan(S, K, kk)}")
    args = ivf_case(0, 2, 4, 300, 16, 2, 300, 300, False)
    for bad in (0, 601):
        try:
            ivf_scan_topk(*args, kk=bad)
        except ValueError:
            continue
        raise AssertionError(f"ivf_scan kk={bad} was not refused")


# -- training at dml-imnet1m width ------------------------------------------

class IndexPairs:
    """Index pairs over a feature store resident on the card, as a pair
    source of ``train_dml_distributed``: partitioned over workers (paper
    §4.1), each worker's batches gathered on the card by index."""

    def __init__(self, features, idx):
        self.features, self.idx = features, idx

    def worker_streams(self, n_workers, batch_size, seed):
        return [pairdata.pair_batches_from_indices(
            self.features, shard, batch_size, seed=seed + i, device=DEV)
            for i, shard in enumerate(partition_pairs(self.idx, n_workers))]


# every kernel wrapper, under its name in the kernels line
KERNEL_WRAPPERS = {"dml_pair": dml_pair_fused,
                   "pairwise_sqdist": pairwise_sqdist,
                   "metric_topk": metric_topk_fused,
                   "ivf_scan": ivf_scan_topk_fused,
                   "pq_adc": pq_adc_topk_fused, "ssd_scan": ssd_scan,
                   "flash_attention": flash_attention}


def _reset_counts():
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def _counts():
    """Every kernel's launches since the last reset, by name."""
    return {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}


def phase_training(exp=IMNET_1M):
    cfg = exp.dml
    t0 = time.perf_counter()
    feats_np, labels = pairdata.make_features(pairdata.PairDatasetConfig(
        n_samples=TRAIN_SAMPLES, feat_dim=cfg.feat_dim,
        n_classes=TRAIN_CLASSES, kind="noisy_subspace", noise=0.8, seed=0))
    train_idx = pairdata.sample_pair_indices(labels[:-N_HOLD], 50_000,
                                             50_000, seed=1)
    feats = torch.from_numpy(feats_np).to(DEV)
    del feats_np
    train_x = feats[:-N_HOLD]
    torch.cuda.synchronize()
    log(f"training data: {TRAIN_SAMPLES} x {cfg.feat_dim} noisy_subspace "
        f"rows ({feats.numel() * 4 / 1e9:.2f} GB on the card), "
        f"{TRAIN_CLASSES} classes, 50k + 50k index pairs over the first "
        f"{TRAIN_SAMPLES - N_HOLD} rows, in {time.perf_counter() - t0:.1f}s")

    # the example's scale-aware init: initial ||Lz||^2 ~ 2 * margin
    L = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    probe = next(pairdata.pair_batches_from_indices(
        train_x, train_idx, 256, seed=99, device=DEV))
    d2 = float(torch.mean(dml.mahalanobis_sqdist(L, probe["xs"],
                                                 probe["ys"])))
    L = L * float(np.sqrt(2.0 * cfg.margin / max(d2, 1e-9)))
    L_init = L.clone()                      # the async PS phases start here
    log(f"init rescale: mean d2 {d2:.1f} -> ~{2 * cfg.margin}")

    source = IndexPairs(train_x, train_idx)
    opt = sgd(schedules.inverse_time(1e-3, 1e-3))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                         # counts of the main path only
    histories, step_ms = {}, {}
    for mode, steps in TRAIN_STEPS.items():
        ps = sync.PSConfig(n_workers=N_WORKERS, sync=mode, tau=4,
                           staleness=2)
        tcfg = DMLTrainConfig(dml=cfg, ps=ps, batch_size=exp.batch_size,
                              steps=steps, log_every=1)
        L, hist = train_dml_distributed(
            tcfg, source, opt=opt, L0=L,
            step_hook=lambda t, _L: time.perf_counter())
        stamps = [h["hook"] for h in hist]
        step_ms[mode] = 1e3 * (stamps[-1] - stamps[0]) / (len(stamps) - 1)
        histories[mode] = [h["loss"] for h in hist]
        log(f"train {mode}: {steps} steps, loss {histories[mode][0]:.4f} "
            f"-> {histories[mode][-1]:.4f}; {step_ms[mode]:.2f} ms/step "
            f"after the first (host clock, each step ends in a sync), "
            f"{N_WORKERS * exp.batch_size / step_ms[mode] * 1e3:.0f} "
            f"pairs/s")
    # bsp keeps worker copies bit-identical (two more main-path steps)
    ps = sync.PSConfig(n_workers=N_WORKERS, sync="bsp")
    state = sync.init_state(opt, L, ps)
    step = sync.make_train_step(
        lambda p, b: dml_pair_loss(p, b, lam=cfg.lam, margin=cfg.margin),
        opt, ps)
    batches = stack_worker_streams(make_worker_streams(
        source, N_WORKERS, exp.batch_size, seed=5))
    for _ in range(2):
        state, _ = step(state, next(batches))
    torch.cuda.synchronize()
    launches = dml_pair_fused.launches
    n_steps = sum(TRAIN_STEPS.values()) + 2
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert all(torch.equal(state.params[0], state.params[w])
               for w in range(1, N_WORKERS)), "bsp copies differ"
    assert launches >= N_WORKERS * n_steps, \
        f"dml_pair launched {launches} times in {n_steps} steps"
    assert all(np.isfinite(v).all() for v in histories.values())
    bsp = histories["bsp"]
    assert np.mean(bsp[-5:]) < bsp[0], "the bsp loss did not fall"
    log(f"training: dml_pair launches {launches} in {n_steps} steps "
        f"({launches / n_steps:.1f} per step, P = {N_WORKERS}); bsp copies "
        f"bit-identical; peak memory {peak_gb:.2f} GB")
    step_parts = step_profile(lambda: step(state, next(batches)),
                              step_ms["bsp"])

    # one full-width step's dL, kernel path against plain path, on a batch
    # with no pair within HINGE_GAP of the margin
    batch = next(pairdata.pair_batches_from_indices(
        train_x, train_idx, exp.batch_size, seed=7, device=DEV))
    xs, ys, sim = batch["xs"], batch["ys"], batch["sim"]
    _, d2_plain, _ = dml_pair_ref(L, xs, ys, sim, cfg.lam, cfg.margin)
    keep = (d2_plain - cfg.margin).abs() > HINGE_GAP
    xs, ys, sim = xs[keep].contiguous(), ys[keep].contiguous(), sim[keep]
    (dk,) = _grads(dml_pair_loss_fused, L, xs, ys, sim, cfg.lam, cfg.margin,
                   wrt=1)
    (dp,) = _grads(dml_pair_loss_reference, L, xs, ys, sim, cfg.lam,
                   cfg.margin, wrt=1)
    scale = float(dp.abs().max())
    torch.testing.assert_close(dk, dp, rtol=1e-4, atol=1e-4 * scale)
    log(f"full-width dL ({int(keep.sum())} of {exp.batch_size} pairs, "
        f"{exp.batch_size - int(keep.sum())} within {HINGE_GAP} of the "
        f"margin left out): max |dL_kernel - dL_plain| "
        f"{float((dk - dp).abs().max()):.3e} (max |dL| {scale:.3e})")
    out = dml_pair_fused(L, batch["xs"], batch["ys"], batch["sim"],
                         lam=cfg.lam, margin=cfg.margin)
    ref = dml_pair_ref(L, batch["xs"], batch["ys"], batch["sim"], cfg.lam,
                       cfg.margin)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-5)
    return {"L": L, "L_init": L_init, "source": source, "feats": feats,
            "labels": labels, "batch": batch, "launches": launches,
            "launches_per_step": launches / n_steps,
            "max_err": _max_err(out, ref), "step_ms": step_ms,
            "step_parts": step_parts, "losses": histories, "peak_gb": peak_gb}


# -- kNN evaluation -----------------------------------------------------------

def phase_eval(L, feats, labels):
    d_in = feats.shape[1]
    train_x, test_x = feats[:-N_HOLD], feats[-N_HOLD:]
    y = torch.from_numpy(labels).to(DEV)
    train_y, test_y = y[:-N_HOLD], y[-N_HOLD:]
    torch.cuda.synchronize()
    _reset_counts()                         # counts of the main path only
    t0 = time.perf_counter()
    acc = {"learned": knn_accuracy(L, train_x, train_y, test_x, test_y,
                                   k=KNN_K),
           "euclidean": knn_accuracy(None, train_x, train_y, test_x, test_y,
                                     k=KNN_K)}
    wall = time.perf_counter() - t0
    launches = pairwise_sqdist.launches
    assert launches >= 2, f"pairwise_sqdist launched {launches} times"
    log(f"kNN@{KNN_K} accuracy on {N_HOLD} held-out rows against "
        f"{TRAIN_SAMPLES - N_HOLD} training rows: learned "
        f"{acc['learned']:.4f}, euclidean {acc['euclidean']:.4f} "
        f"(chance {1 / TRAIN_CLASSES:.3f}); {launches} pairwise_sqdist "
        f"launches; {wall:.2f}s for both (host clock)")

    # the kernel path's predictions against the plain path's
    errs, proj = {}, {}
    for name, M in (("learned", L), ("euclidean", None)):
        M = torch.eye(d_in, device=DEV) if M is None else M
        xp, xn = project_gallery(M, test_x)
        yp, yn = project_gallery(M, train_x)
        D = pairwise_sqdist(xp, yp)
        errs[name], D_ref = compare_dist(D, xp, yp)
        pk, pp = knn_vote(D, train_y, KNN_K), knn_vote(D_ref, train_y, KNN_K)
        rows = torch.nonzero(pk != pp).flatten()
        if len(rows):
            srt = torch.sort(D_ref[rows], dim=1, stable=True)
            gap = srt.values[:, KNN_K] - srt.values[:, KNN_K - 1]
            tol = ATOL + RTOL * (xn[rows] + torch.maximum(
                yn[srt.indices[:, KNN_K]], yn[srt.indices[:, KNN_K - 1]]))
            assert bool((gap <= tol).all()), \
                f"{name}: predictions differ away from a k-th distance tie"
        log(f"eval {name}: kernel vs plain max |dD| {errs[name]:.3e}; "
            f"{len(rows)} of {N_HOLD} predictions differ, each at a "
            f"k-th / (k+1)-th distance tie")
        proj[name] = (xp, yp)
    return {"acc": acc, "launches": launches, "max_err": errs["learned"],
            "xp": proj["learned"][0], "yp": proj["learned"][1]}


# -- the asynchronous parameter server (§4.2) and Fig. 3 ---------------------

def _async_cfg(exp, n_workers, steps):
    return simulator.AsyncPSConfig(
        n_workers=n_workers, lr=ASYNC_LR, batch_size=exp.batch_size,
        lam=exp.dml.lam, margin=exp.dml.margin, steps_per_worker=steps,
        server_batch=ASYNC_SERVER_BATCH)


def check_async(trace, stats, L, wall, peak_gb, launches, P, steps,
                exp=IMNET_1M):
    """Phase 5a's checks and prints on one ``run_async_dml`` call."""
    n_msg, span = len(trace), trace[-1][0]
    losses = [loss for _, _, loss in trace]
    assert n_msg == P * steps == stats["messages"], f"{n_msg} messages"
    assert {w for _, w, _ in trace} == set(range(P)), \
        "a worker is missing from the trace"
    assert 1 <= stats["n_updates"] <= n_msg, f"{stats['n_updates']} updates"
    assert bool(torch.isfinite(L).all()), "the final L is not finite"
    assert np.all(np.isfinite(losses))
    first, last = np.mean(losses[:20]), np.mean(losses[-20:])
    assert last < first, f"async loss did not fall: {first} -> {last}"
    log(f"async PS (d_in {exp.dml.feat_dim}, d_out {exp.dml.proj_dim}, "
        f"{exp.batch_size} pairs a message, P = {P}, server_batch "
        f"{ASYNC_SERVER_BATCH}, lr {ASYNC_LR}, {steps} steps a worker): "
        f"every thread finished; {n_msg} messages in {span:.3f}s after the "
        f"warm-up ({wall:.3f}s the whole call): "
        f"{1e3 * span / steps:.2f} ms a message a worker, "
        f"{n_msg / span:.1f} messages/s; {stats['n_updates']} server "
        f"updates, {n_msg / stats['n_updates']:.2f} messages an update; "
        f"deepest inbound queue {stats['max_queue']}; loss of the first 20 "
        f"messages {first:.4f} -> last 20 {last:.4f}; peak memory "
        f"{peak_gb:.2f} GB; kernel launches {launches} (host clock, under "
        f"the profiler)")


def phase_async_ps(train, exp=IMNET_1M):
    """Phases 5a and 5b: ``run_async_dml`` at dml-imnet1m width on phase
    4's on-card features and index pairs, from phase 4's rescaled initial
    L, at P = 1, 2 and 4: P worker threads and the server thread, each on
    a CUDA stream of its own, on one card. The gradient is the
    reference's plain autograd product, so no kernel of the port runs
    here. Each call runs once, under the profiler (``profiled``); the
    P = ASYNC_P call also takes 5a's checks.

    5b is the Fig. 3 measurement of ``benchmarks/fig3_speedup.py:53-87``.
    Virtual time: worker p's i-th message lands at i * tau, tau the
    seconds a message at P = 1; the target is the mean of P = 1's last 30
    losses; the curve is smoothed over 15 messages. Findings only: the P
    threads share one card, so the wall-clock speedup is not the paper's
    cluster speedup."""
    results, target = {}, None
    for P in FIG3_WORKERS:
        cfg = _async_cfg(exp, P, FIG3_STEPS)
        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()                     # counts of this path only
        (L, trace), wall = profiled(
            lambda: simulator.run_async_dml(cfg, train["source"],
                                            train["L_init"], stats=stats),
            what=f"one async PS call (P = {P}, {P + 1} streams, "
                 f"{P * FIG3_STEPS} messages)")
        if P == ASYNC_P:
            check_async(trace, stats, L, wall,
                        torch.cuda.max_memory_allocated() / 1e9,
                        {fn.__name__: fn.launches
                         for fn in (dml_pair_fused, pairwise_sqdist)},
                        P, FIG3_STEPS, exp)
        del L
        tau = wall / len(trace) if P == FIG3_WORKERS[0] else \
            results[FIG3_WORKERS[0]]["tau_s"]
        counts, vts, ls = {}, [], []
        for _, wid, loss in trace:
            counts[wid] = counts.get(wid, 0) + 1
            vts.append(counts[wid] * tau)
            ls.append(loss)
        vts, ls = np.array(vts), np.array(ls)
        order = np.argsort(vts, kind="stable")
        smooth = np.convolve(ls[order], np.ones(15) / 15, mode="same")
        if P == FIG3_WORKERS[0]:
            target = float(ls[-30:].mean())
            t_reach = float(vts.max())
        else:
            hit = np.nonzero(smooth <= target)[0]
            t_reach = float(vts[order][hit[0]]) if len(hit) else \
                float(vts.max())
        results[P] = {"wall_s": wall, "tau_s": tau, "t_reach": t_reach,
                      "messages_per_s": len(trace) / trace[-1][0]}
    r1 = results[FIG3_WORKERS[0]]
    for P, r in results.items():
        r["speedup"] = r1["t_reach"] / max(r["t_reach"], 1e-9)
        log(f"fig3 P = {P}: wall {r['wall_s']:.3f}s for {P * FIG3_STEPS} "
            f"messages, {r['messages_per_s']:.1f} messages/s on the one "
            f"card (wall-clock ratio to P = 1: "
            f"{r['messages_per_s'] / r1['messages_per_s']:.2f}); "
            f"virtual-time speedup {r['speedup']:.2f} (ideal {P}; tau "
            f"{1e3 * r['tau_s']:.2f} ms, target loss {target:.4f}, virtual "
            f"t_reach {r['t_reach']:.3f}s). The P threads share one card: "
            f"the wall clock is not the paper's cluster speedup")


# -- Fig. 4: ours against Xing 2002, ITML, KISS and Euclidean ---------------

def phase_fig4(exp=MNIST):
    """The reference's Fig. 4 recipe (``benchmarks/fig4_quality.py:37-91``)
    at dml-mnist full width (d 780, k 600, 1000 pairs a batch), on the
    card: noisy_subspace at noise FIG4_NOISE, 60,000 rows, 10 classes,
    100k + 100k train and 2,000 + 2,000 eval pairs. "Ours" is
    ``train_dml_single`` (Eq. 4 on ``dml_pair``) from the scale-aware
    rescale of ``init_params`` at lr FIG4_LR; the baselines take the
    reference's settings. Returns the dml_pair launches of "ours"."""
    d, k = exp.dml.feat_dim, exp.dml.proj_dim
    t0 = time.perf_counter()
    data_cfg = pairdata.PairDatasetConfig(
        n_samples=exp.n_samples, feat_dim=d, n_classes=exp.n_classes,
        kind="noisy_subspace", noise=FIG4_NOISE, seed=0)
    train_pairs, eval_pairs = pairdata.train_eval_split(
        data_cfg, exp.n_similar, exp.n_dissimilar, 2000, 2000)
    ev = {key: torch.from_numpy(v).to(DEV) for key, v in eval_pairs.items()}
    tr = {key: torch.from_numpy(v).to(DEV) for key, v in train_pairs.items()}
    torch.cuda.synchronize()
    gb = 2 * tr["xs"].numel() * 4 / 1e9
    log(f"fig4 data: {exp.n_samples} x {d} noisy_subspace rows (noise "
        f"{FIG4_NOISE}), {exp.n_classes} classes, {exp.n_similar} + "
        f"{exp.n_dissimilar} train pairs ({gb:.2f} GB on the card), 2000 + "
        f"2000 eval pairs, in {time.perf_counter() - t0:.1f}s")
    Ms, secs, scores = {}, {}, {}

    # ours: the example's scale-aware init (initial ||Lz||^2 ~ 2 * margin)
    L0 = init_params(exp.dml, torch.Generator(device=DEV).manual_seed(0), DEV)
    probe = next(pairdata.pair_batches(train_pairs, 256, seed=99,
                                       device=DEV))
    d2 = float(torch.mean(dml.mahalanobis_sqdist(L0, probe["xs"],
                                                 probe["ys"])))
    L0 = L0 * float(np.sqrt(2.0 * exp.dml.margin / max(d2, 1e-9)))
    _reset_counts()                         # counts of this path only
    (L, hist), secs["ours"] = profiled(
        lambda: train_dml_single(exp.dml, train_pairs, steps=FIG4_STEPS,
                                 batch_size=exp.batch_size, lr=FIG4_LR,
                                 seed=0, L0=L0),
        what=f"Fig. 4 ours ({FIG4_STEPS} steps, batches from host numpy)")
    launches = dml_pair_fused.launches
    assert launches == FIG4_STEPS, f"dml_pair launched {launches} times"
    Ms["ours"] = dml.M_from_L(L)
    scores["ours"] = dml.pair_scores(L, ev["xs"], ev["ys"])
    log(f"fig4 ours: init rescale mean d2 {d2:.1f} -> ~{2 * exp.dml.margin}"
        f"; loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} in "
        f"{FIG4_STEPS} steps; dml_pair launches {launches}")

    (Ms["xing2002"], xl), secs["xing2002"] = profiled(
        lambda: xing2002.fit(
            xing2002.XingConfig(feat_dim=d, lr=5e-2, steps=FIG4_STEPS // 5),
            tr["xs"], tr["ys"], tr["sim"], batch_size=exp.batch_size),
        what=f"Fig. 4 Xing2002 ({FIG4_STEPS // 5} steps, pairs on the card)")

    n_c = min(4000, tr["xs"].shape[0])
    t = time.perf_counter()
    Ms["itml"] = itml.fit(itml.ITMLConfig(feat_dim=d, gamma=1e-3, sweeps=2),
                          tr["xs"][:n_c], tr["ys"][:n_c], tr["sim"][:n_c])
    torch.cuda.synchronize()
    secs["itml"] = time.perf_counter() - t

    t = time.perf_counter()
    Ms["kiss"], proj = kiss.fit(
        kiss.KISSConfig(feat_dim=d, pca_dim=min(k, d // 2), ridge=1e-4),
        tr["xs"], tr["ys"], tr["sim"])
    torch.cuda.synchronize()
    secs["kiss"] = time.perf_counter() - t
    secs["euclidean"] = 0.0

    for name in ("xing2002", "itml"):
        scores[name] = dml.pair_scores_M(Ms[name], ev["xs"], ev["ys"])
    scores["kiss"] = dml.pair_scores_M(Ms["kiss"], ev["xs"] @ proj,
                                       ev["ys"] @ proj)
    scores["euclidean"] = dml.pair_scores_euclidean(ev["xs"], ev["ys"])
    ap = {name: float(dml.average_precision(s, ev["sim"]))
          for name, s in scores.items()}
    for name, M in Ms.items():
        w = torch.linalg.eigvalsh(M.double())
        assert bool(torch.isfinite(M).all()), f"{name}: M is not finite"
        assert float(w.min()) >= -1e-4 * float(w.max()), \
            f"{name}: M is not PSD (eigenvalues {float(w.min()):.3e} .. " \
            f"{float(w.max()):.3e})"
    assert all(0.0 <= v <= 1.0 for v in ap.values()), ap
    for name in ap:
        log(f"fig4 {name:10s} AP {ap[name]:.4f}, train {secs[name]:.3f}s"
            + (f" ({len(xl)} steps, loss {xl[0]:.4f} -> {xl[-1]:.4f})"
               if name == "xing2002" else ""))
    best_other = max(v for key, v in ap.items() if key != "ours")
    claims = {
        "ours at or near the best AP (within 0.02)":
            ap["ours"] >= best_other - 0.02,
        "ours above Euclidean": ap["ours"] > ap["euclidean"],
        "ours trains faster than Xing2002 (ours fed from host numpy, "
        "Xing2002 from pairs on the card)":
            secs["ours"] < secs["xing2002"],
    }
    for claim, holds in claims.items():
        log(f"fig4 claim: {claim}: {'holds' if holds else 'does not hold'}")
    log("fig4: every M finite and PSD (least eigenvalue >= -1e-4 x the "
        "largest), every AP in [0, 1]")
    return launches


# -- exact serving at dml-imnet1m width --------------------------------------

def class_rows(gen, lab, classes, noise=0.3, spread=0.0):
    """Raw llc_like rows of the classes ``lab`` (make_features' recipe:
    |center| magnitudes on the class support mask plus masked |noise|),
    on the card. ``classes`` is (mags, masks) from ``make_gallery``.
    ``spread`` adds N(0, spread^2) on every dimension, so that classes
    overlap."""
    mags, masks = classes
    x = mags[lab] + noise * torch.randn(
        (len(lab), mags.shape[1]), generator=gen, device=DEV).abs() \
        * masks[lab]
    if spread:
        x += spread * torch.randn(x.shape, generator=gen, device=DEV)
    return x


def make_gallery(gen, n, d_in, n_classes, L, query_rows, block=16384,
                 sparsity=0.9):
    """llc_like rows (class support masks, |center| magnitudes, masked
    |noise|) generated on the card block by block and projected through
    L; the raw rows never stay resident. Returns (gp, gn, labels, raw rows
    at ``query_rows``, the classes (mags, masks) for ``class_rows``)."""
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=DEV)
    centers = torch.randn((n_classes, d_in), generator=gen, device=DEV)
    masks = torch.rand((n_classes, d_in), generator=gen,
                       device=DEV) < (1.0 - sparsity)
    classes = (centers.abs() * masks, masks)
    gp = torch.empty((n, L.shape[0]), dtype=torch.float32, device=DEV)
    gn = torch.empty((n,), dtype=torch.float32, device=DEV)
    raw_q = torch.empty((len(query_rows), d_in), device=DEV)
    qrows = torch.as_tensor(query_rows, device=DEV)
    for b0 in range(0, n, block):
        b1 = min(n, b0 + block)
        x = class_rows(gen, labels[b0:b1], classes)
        gp[b0:b1], gn[b0:b1] = project_gallery(L, x)
        hit = (qrows >= b0) & (qrows < b1)
        raw_q[hit] = x[qrows[hit] - b0]
        del x
    return gp, gn, labels, raw_q, classes


def span_means(traces):
    """Mean duration in ms of each span name over finished trace dicts."""
    tot, cnt = {}, {}

    def walk(sp):
        if sp.get("t_end") is not None:
            tot[sp["name"]] = tot.get(sp["name"], 0.0) + \
                sp["t_end"] - sp["t_start"]
            cnt[sp["name"]] = cnt.get(sp["name"], 0) + 1
        for c in sp.get("children", ()):
            walk(c)

    for tr in traces:
        walk(tr["root"])
    return {k: round(1e3 * tot[k] / cnt[k], 3) for k in sorted(tot)}


def _serve(engine, queries_np):
    """The requests through a MicroBatcher, one at a time; returns
    ({wall, qps, p50_ms, p99_ms, batches, mean_batch}, dists, ids)."""
    front = MicroBatcher(engine, max_batch=MAX_BATCH, max_wait_ms=2.0)
    t0 = time.perf_counter()
    pending = [(time.perf_counter(), front.submit(q)) for q in queries_np]
    lat, dists, nbrs = [], [], []
    for t_sub, fut in pending:
        d, nbr = fut.result(timeout=300)
        lat.append(time.perf_counter() - t_sub)
        dists.append(d)
        nbrs.append(nbr)
    wall = time.perf_counter() - t0
    assert front.close(), "batcher worker did not stop"
    assert np.isfinite(lat).all()
    p50, p99 = percentile(np.sort(np.asarray(lat)) * 1e3, (50.0, 99.0))
    return ({"wall": wall, "qps": len(lat) / wall, "p50_ms": p50,
             "p99_ms": p99, "batches": front.n_batches,
             "mean_batch": float(np.mean(front.batch_sizes))},
            np.stack(dists), np.stack(nbrs))


def phase_serving(exp=IMNET_1M):
    cfg = exp.dml
    gen = torch.Generator(device=DEV).manual_seed(0)
    L = init_params(cfg, gen, DEV)
    rng = np.random.RandomState(1)
    qids = rng.randint(0, exp.n_samples, N_REQUESTS)
    t0 = time.perf_counter()
    gp, gn, labels, raw_q, classes = make_gallery(
        gen, exp.n_samples, cfg.feat_dim, exp.n_classes, L, qids)
    index = ExactIndex.from_projected(L, gp, gn)
    torch.cuda.synchronize()
    log(f"serving: {exp.name} gallery {index.size} x {cfg.feat_dim} -> "
        f"{cfg.proj_dim} generated+projected in "
        f"{time.perf_counter() - t0:.1f}s "
        f"(gp {gp.numel() * 4 / 1e9:.2f} GB on the card)")
    queries = raw_q + 0.1 * torch.randn(raw_q.shape, generator=gen,
                                        device=DEV)
    queries_np = queries.cpu().numpy()

    engine = RetrievalEngine(index, k_top=K_TOP, buckets=SERVE_BUCKETS)
    t0 = time.perf_counter()
    engine.warmup()
    log(f"warmup over buckets {SERVE_BUCKETS}: "
        f"{time.perf_counter() - t0:.2f}s")

    engine.tracer.sample_rate = 1.0         # every request's span tree
    metric_topk_fused.launches = 0          # counts of the main path only
    served, _, nbrs = _serve(engine, queries_np)
    launches = metric_topk_fused.launches
    assert launches > 0, "the serving path never launched the kernel"

    labels_np = labels.cpu().numpy()
    purity = float(np.mean(labels_np[nbrs] == labels_np[qids][:, None]))
    p50, p99 = served["p50_ms"], served["p99_ms"]
    st = engine.stats()
    log(f"served {N_REQUESTS} requests in {served['wall']:.3f}s: qps "
        f"{served['qps']:.1f} (device-side {st['qps']:.1f}), latency "
        f"ms p50 {p50:.2f} p99 {p99:.2f}, batches {served['batches']} mean "
        f"{served['mean_batch']:.1f}, kernel launches {launches}, "
        f"backend {st['backend']}")
    log(f"neighbour class purity@{K_TOP}: {purity:.3f} "
        f"(chance {1.0 / exp.n_classes:.3f})")
    spans = span_means(engine.tracer.drain())
    log(f"mean span ms (host clock): {spans}")
    assert st["backend"] == "cuda"
    assert purity > 10.0 / exp.n_classes, "purity at chance level"

    # one full batch, kernel against plain on the card
    qb = queries[:MAX_BATCH].contiguous()
    dk, ik = index.topk(qb, K_TOP)
    torch.cuda.synchronize()
    assert torch.isfinite(dk).all() and dk.shape == (MAX_BATCH, K_TOP)
    err, n_diff = compare(L, qb, gp, gn, K_TOP, dk, ik)
    log(f"full batch vs plain: max |dd| {err:.3e}, {n_diff} tie-resolved "
        f"id differences")
    serving = {"qps": served["qps"], "p50_ms": p50, "p99_ms": p99,
               "spans_ms": spans, "mean_batch": served["mean_batch"],
               "purity": purity, "launches": launches, "nbrs": nbrs,
               "labels": labels_np, "qids": qids,
               "n_classes": exp.n_classes, "classes": classes}
    return index, queries, serving, err


def _time(fn, iters):
    fn()                                       # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_graph(fn, iters):
    """Device ms per call of ``fn`` replayed from a CUDA graph, so the
    host's launch cost (the wrapper's torch calls, ctypes) drops out;
    None, with the reason printed, when the calls cannot be captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                            # allocations outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError as e:           # measurement only: no result used
        log(f"  graph capture failed, device time not measured: "
            f"{str(e).splitlines()[0]}")
        return None
    ms = _time(graph.replay, iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def roofline(ops, nbytes, peak_flops=PEAK_3XTF32_FLOPS):
    """(least ms for ``ops`` FLOP at ``peak_flops`` and ``nbytes`` moved,
    what bounds it). An f32 product's least time is at the 3xTF32 rate
    unless another peak is given; ``ffma_bound`` keeps the f32 FFMA
    figure for the record."""
    t_ops, t_bytes = ops / peak_flops, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def ffma_bound(ops, nbytes):
    """The same least time with every product f32 FFMA (67 TFLOP/s)."""
    return roofline(ops, nbytes, PEAK_F32_FLOPS)[0]


def bound(nq, d_in, d_out, m, k_top):
    """(3xTF32 bound ms, what bounds it, f32 FFMA bound ms)"""
    ops = 2.0 * nq * d_in * d_out + 2.0 * nq * m * d_out
    nbytes = 4.0 * (nq * d_in + d_out * d_in + m * d_out + m
                    + 2 * nq * k_top)
    return (*roofline(ops, nbytes), ffma_bound(ops, nbytes))


def library(L, q, gp, gn, k_top):
    """One PyTorch call chain for the same function (yardstick only)."""
    qp = q @ L.T
    d = torch.sum(qp * qp, 1)[:, None] + gn[None, :] - 2.0 * (qp @ gp.T)
    return torch.topk(d.clamp_min_(0.0), k_top, dim=1, largest=False)


def _by_kernel(prof):
    """Device ms by kernel name over a finished torch.profiler run; None
    when it recorded no device time."""
    out = {}
    for ev in prof.key_averages():
        ms = (getattr(ev, "device_time_total", 0) or 0) / 1e3
        if ms <= 0:
            continue
        key = ev.key.replace("(anonymous namespace)::", "")
        m = re.search(r"([A-Za-z_]\w*(?:<[^>]*>)?)\(", key)
        name = m.group(1) if m else key[:40]
        out[name] = round(out.get(name, 0.0) + ms, 4)
    return out or None


def device_breakdown(fn):
    """Device milliseconds by kernel name over one call (torch.profiler);
    None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _by_kernel(prof)


def step_profile(fn, step_ms, top=6):
    """Device ms by kernel over one training step (the largest ``top``
    kernels, the rest as ``other``) and the device's idle share of the
    step time measured on the host clock; single stream, so the kernel
    times add up."""
    parts = device_breakdown(fn)
    if parts is None:
        log("one bsp step on the card: device time not measured")
        return None
    busy = sum(parts.values())
    out = dict(sorted(parts.items(), key=lambda kv: -kv[1])[:top])
    out["other"] = round(busy - sum(out.values()), 4)
    log(f"one bsp step on the card: device busy {busy:.3f} ms of "
        f"{step_ms:.3f} ms per step (host clock), idle share "
        f"{1 - busy / step_ms:.1%}; device ms by kernel {out}")
    return {"busy_ms": round(busy, 4), "by_kernel": out}


def _profile_busy(fn):
    """(fn's result, host s, device busy ms as the union of kernel and
    copy intervals over all streams, device operations, the profiler)
    of one call under torch.profiler; busy None when it records no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return out, host, (busy_us / 1e3 if spans else None), len(spans), prof


def profiled(fn, what, top=6):
    """Run ``fn`` once under torch.profiler and log where its time went:
    the host time of this very call, the device's busy time as the union
    of its kernel and copy intervals over every stream (kernels on
    several streams overlap, so their sum can pass the busy time), the
    device's idle share of the host time, and device ms by kernel (the
    largest ``top``, summed over streams). Returns (fn's result, host
    seconds of the call)."""
    out, host, busy, _, prof = _profile_busy(fn)
    parts = _by_kernel(prof)
    if busy is None or parts is None:
        log(f"{what} on the card: {1e3 * host:.3f} ms (host clock); "
            f"device time not measured")
        return out, host
    summed = sum(parts.values())
    top_parts = dict(sorted(parts.items(), key=lambda kv: -kv[1])[:top])
    top_parts["other"] = round(summed - sum(top_parts.values()), 4)
    log(f"{what} on the card, profiled: {1e3 * host:.3f} ms (host clock, "
        f"this call); device busy {busy:.3f} ms (union of kernel and copy "
        f"intervals over all streams), idle share {1 - busy / (1e3 * host):.1%}"
        f"; kernel and copy ms summed over streams {summed:.3f}; device ms "
        f"by kernel {top_parts}")
    return out, host


def phase_kernels(index, queries, launches, max_err):
    L, gp, gn = index.L, index.gp, index.gn
    d_out, d_in = L.shape
    m = gp.shape[0]
    rows = {}
    for nq in (1, MAX_BATCH):
        q = queries[:nq].contiguous()
        ms = _time(lambda: metric_topk_fused(q, L, gp, gn, k_top=K_TOP), 10)
        plain_ms = _time(lambda: metric_topk_plain(L, q, gp, gn, K_TOP), 3)
        lib_ms = _time(lambda: library(L, q, gp, gn, K_TOP), 3)
        b_ms, b_by, ffma_ms = bound(nq, d_in, d_out, m, K_TOP)
        parts = device_breakdown(
            lambda: metric_topk_fused(q, L, gp, gn, k_top=K_TOP))
        rows[nq] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms,
                        breakdown_ms=parts)
        log(f"metric_topk Nq={nq} M={m} d_in={d_in} d_out={d_out} "
            f"k={K_TOP}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"library {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; f32 "
            f"FFMA {ffma_ms:.3f}), {b_ms / ms:.1%} of bound; device ms by "
            f"kernel "
            f"{parts if parts else 'not measured'}")
    # the wide path (k_top past the 256-entry lists) at the serving width
    q = queries[:MAX_BATCH].contiguous()
    ms = _time(lambda: metric_topk_fused(q, L, gp, gn, k_top=WIDE_K), 5)
    lib_ms = _time(lambda: library(L, q, gp, gn, WIDE_K), 3)
    wide = dict(k_top=WIDE_K, ms=ms, library_ms=lib_ms,
                breakdown_ms=device_breakdown(
                    lambda: metric_topk_fused(q, L, gp, gn, k_top=WIDE_K)))
    log(f"metric_topk wide path Nq={MAX_BATCH} k={WIDE_K}: kernel {ms:.3f} "
        f"ms, library {lib_ms:.3f} ms; device ms by kernel "
        f"{wide['breakdown_ms'] or 'not measured'}")
    main = rows[MAX_BATCH]
    return {"name": "metric_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/metric_topk/csrc/"
                      "metric_topk.cu",
            "replaces": "src/repro/kernels/metric_topk/kernel.py:103",
            "launches": launches, "max_abs_err": max_err,
            **main,
            "shape": {"nq": MAX_BATCH, "m": m, "d_in": d_in,
                      "d_out": d_out, "k_top": K_TOP},
            "at_nq1": rows[1], "wide": wide}


# -- approximate serving: IVF on ivf_scan, IVFPQ on pq_adc --------------------

ANN_KERNELS = {"ivf": ivf_scan_topk_fused, "ivfpq": pq_adc_topk_fused}


def _build_ann(name, L, gp, gn, timings):
    if name == "ivf":
        return IVFIndex.build_projected(
            L, gp, gn, n_clusters=N_CLUSTERS, nprobe=NPROBE,
            cap_factor=CAP_FACTOR, iters=KM_ITERS, seed=0, timings=timings)
    return IVFPQIndex.build_projected(
        L, gp, gn, n_clusters=N_CLUSTERS, nprobe=NPROBE,
        n_subspaces=PQ_SUBSPACES, bits=PQ_BITS, rerank_depth=RERANK,
        store="device", cap_factor=CAP_FACTOR, iters=KM_ITERS, seed=0,
        timings=timings)


def phase_ann(index, queries, serving):
    """IVF and IVFPQ serving over phase 6's projected gallery and
    requests; recall against phase 6's exact answers."""
    L, gp, gn = index.L, index.gp, index.gn
    queries_np = queries.cpu().numpy()
    labels, qids = serving["labels"], serving["qids"]
    out, built = {}, {}
    for name, kern in ANN_KERNELS.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps, t0 = {}, time.perf_counter()
        ann = _build_ann(name, L, gp, gn, steps)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        fills = torch.bincount(ann.ids_pad.view(N_CLUSTERS, ann.cap)
                               .ge(0).sum(1), minlength=ann.cap + 1)
        extra = (f", {ann.pq.n_subspaces} x {ann.pq.bits}-bit codes "
                 f"({ann.codes_pad.numel() / 1e6:.1f} MB, "
                 f"{ann.code_bytes_per_row} B/row, compression "
                 f"{ann.compression_ratio:.1f}x), rerank {ann.rerank_depth} "
                 f"from the card" if name == "ivfpq" else
                 f", gp_pad {ann.gp_pad.numel() * 4 / 1e9:.2f} GB")
        log(f"{name}: built in {build_s:.1f}s "
            f"({ {k: round(v, 2) for k, v in steps.items()} }): "
            f"{ann.n_clusters} clusters, cap {ann.cap}, nprobe {ann.nprobe} "
            f"-> {ann.nprobe * ann.cap} rows scanned per query; segments "
            f"empty {int(fills[0])}, full {int(fills[-1])}{extra}")
        engine = RetrievalEngine(ann, k_top=K_TOP, buckets=SERVE_BUCKETS)
        engine.warmup()
        kern.launches = 0                   # counts of the main path only
        served, _, nbrs = _serve(engine, queries_np)
        launches = kern.launches
        assert launches > 0, f"{name} serving never launched its kernel"
        recall = recall_at_k(nbrs, serving["nbrs"])
        purity = float(np.mean(labels[np.maximum(nbrs, 0)]
                               == labels[qids][:, None]))
        p50, p99 = served["p50_ms"], served["p99_ms"]
        st = engine.stats()
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"{name}: served {N_REQUESTS} requests in {served['wall']:.3f}s: "
            f"qps {served['qps']:.1f} (device-side {st['qps']:.1f}), "
            f"latency ms p50 {p50:.2f} p99 {p99:.2f}, batches "
            f"{served['batches']}, kernel calls {launches}; recall@{K_TOP} "
            f"vs exact {recall:.4f}, purity@{K_TOP} {purity:.3f} (chance "
            f"{1 / serving['n_classes']:.3f}); peak memory {peak:.2f} GB "
            f"(build included)")
        assert st["backend"] == "cuda"
        assert recall > 0.0, f"{name}: recall@{K_TOP} is 0"
        assert purity > 10.0 / serving["n_classes"], \
            f"{name}: purity at chance level"
        out[name] = {"qps": served["qps"], "device_qps": st["qps"],
                     "p50_ms": p50, "p99_ms": p99, "recall": recall,
                     "purity": purity, "peak_gb": peak, "build_s": build_s,
                     "build_steps_s": steps, "launches": launches,
                     "batches": served["batches"], "cap": ann.cap}
        built[name] = ann
    ivf, pq = built["ivf"], built["ivfpq"]
    # IVF scanning every cluster is the exact scan (ids apart from ties)
    qb = queries[:MAX_BATCH].contiguous()
    dk, ik = ivf.topk(qb, K_TOP, nprobe=N_CLUSTERS)
    torch.cuda.synchronize()
    err, n_diff = compare(L, qb, gp, gn, K_TOP, dk, ik)
    log(f"ivf at nprobe = n_clusters vs exact plain: max |dd| {err:.3e}, "
        f"{n_diff} tie-resolved id differences")
    # each kernel against its plain version at the serving widths
    qp = project_queries(L, qb)
    args = _ivf_args(ivf, qp)
    dk, ik = ivf_scan_topk(*args, kk=K_TOP)
    out["ivf"]["max_abs_err"], n_diff = compare_ivf(*args, K_TOP, dk, ik)
    log(f"ivf_scan at the serving widths vs plain: max |dd| "
        f"{out['ivf']['max_abs_err']:.3e}, {n_diff} tie-resolved id "
        f"differences")
    args = _pq_args(pq, qp)
    dk, ik = pq_adc_topk(*args, kk=RERANK)
    dp, ip = pq_adc_topk_ref(*args, RERANK)
    assert torch.equal(dk, dp) and torch.equal(ik, ip), \
        "pq_adc at the serving widths is not bit-identical"
    out["ivfpq"]["max_abs_err"] = 0.0
    log("pq_adc at the serving widths vs plain: bit-identical")
    # an exact rerank of RERANK_WIDE ADC candidates: pq_adc at kk 512 (the
    # wide path), bit-identical, and a recall no lower than rerank 50's
    dk, ik = pq_adc_topk(*args, kk=RERANK_WIDE)
    dp, ip = pq_adc_topk_ref(*args, RERANK_WIDE)
    assert torch.equal(dk, dp) and torch.equal(ik, ip), \
        f"pq_adc at kk {RERANK_WIDE} is not bit-identical"
    exact = serving["nbrs"][:MAX_BATCH]
    before = pq_adc_topk_fused.launches
    recall = {rr: recall_at_k(pq.topk(qb, K_TOP, rerank=rr)[1].cpu().numpy(),
                              exact) for rr in (RERANK, RERANK_WIDE)}
    assert pq_adc_topk_fused.launches == before + 2
    assert recall[RERANK_WIDE] >= recall[RERANK], recall
    log(f"ivfpq with rerank {RERANK_WIDE} (pq_adc kk {RERANK_WIDE} "
        f"bit-identical to plain): recall@{K_TOP} of the first {MAX_BATCH} "
        f"requests {recall[RERANK_WIDE]:.4f} (rerank {RERANK}: "
        f"{recall[RERANK]:.4f})")
    out["ivfpq"]["recall_by_rerank"] = recall
    return built, out


def _ivf_args(ivf, qp, nprobe=NPROBE):
    C, cap, k = ivf.n_clusters, ivf.cap, qp.shape[1]
    probes, _ = probe(qp, ivf.centroids, nprobe)
    return (qp, probes, ivf.gp_pad.view(C, cap, k), ivf.gn_pad.view(C, cap),
            ivf.ids_pad.view(C, cap))


def _pq_args(pq, qp, nprobe=NPROBE):
    C, cap, S = pq.n_clusters, pq.cap, pq.pq.n_subspaces
    probes, dc = probe(qp, pq.centroids, nprobe)
    tables = pq.pq.ip_tables(qp).reshape(qp.shape[0], -1)
    return (tables, dc, probes, pq.codes_pad.view(C, cap, S),
            pq.t_pad.view(C, cap), pq.ids_pad.view(C, cap))


def _ivf_fused(args, kk, marks):
    """ivf_scan_topk_fused on ``_ivf_args``'s tensors, as
    ops.ivf_scan_topk calls it, recording ``marks`` between launches."""
    qp, probes, g, gn, ids = args
    C, cap, k = g.shape
    return ivf_scan_topk_fused(
        probes.to(torch.int32).contiguous(), qp.contiguous(),
        g.reshape(C * cap, k).contiguous(), gn.reshape(-1).contiguous(),
        ids.reshape(-1).contiguous(), cap=cap, kk=kk, marks=marks)


def _pq_fused(args, kk, stamps=None, marks=None):
    """pq_adc_topk_fused on ``_pq_args``'s tensors, as ops.pq_adc_topk
    calls it, with the blocks' clock stamps written to ``stamps`` and
    ``marks`` recorded between launches."""
    tables, dc, probes, codes, t, ids = args
    C, cap, S = codes.shape
    return pq_adc_topk_fused(
        probes.to(torch.int32).contiguous(), tables.contiguous(),
        dc.contiguous(), codes.reshape(C * cap, S).contiguous(),
        t.reshape(-1).contiguous(), ids.reshape(-1).contiguous(),
        n_codes=tables.shape[1] // S, cap=cap, kk=kk, stamps=stamps,
        marks=marks)


def launch_split(call, names):
    """Device ms of each launch of one segment-scan call: the time
    between the CUDA events its launcher records around them (``call``
    takes the events). torch.profiler's record of these launches is not
    to be relied on in chip_smoke's runs (PERF.md §7)."""
    call(None)                                  # warm
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(len(names) + 1)]
    call(marks)
    torch.cuda.synchronize()
    out = {n: marks[i].elapsed_time(marks[i + 1])
           for i, n in enumerate(names)}
    log(f"  launches (CUDA events): "
        f"{ {n: round(v, 4) for n, v in out.items()} } ms")
    return out


def stamp_split(call, rows):
    """Where a scan kernel's block time goes, from one call that writes
    five stamps a block (``%globaltimer`` ns, thread 0): start, table and
    first tile landed, tiles done, end; and the time thread 0's warp
    spent inserting candidates. Shares of the summed block time."""
    st = torch.zeros((rows, 5), dtype=torch.int64, device=DEV)
    call(st)
    torch.cuda.synchronize()
    st = st[st[:, 3] > 0].double()
    t0, t1, t2, t3, ins = st.unbind(1)
    busy = float((t3 - t0).sum())
    out = {"blocks": st.shape[0],
           "span_ms": float(t3.max() - t0.min()) / 1e6,
           "mean_block_us": busy / st.shape[0] / 1e3,
           "share": {"table_and_first_tile": float((t1 - t0).sum()) / busy,
                     "score": float((t2 - t1 - ins).sum()) / busy,
                     "insert": float(ins.sum()) / busy,
                     "block_list": float((t3 - t2).sum()) / busy}}
    log(f"  clock stamps: {out['blocks']} blocks over {out['span_ms']:.3f} "
        f"ms, {out['mean_block_us']:.2f} us a block; shares "
        f"{ {k: round(v, 4) for k, v in out['share'].items()} }")
    return out


def library_ivf(qp, probes, g, gn, k_top):
    """Gather the probed segments + torch.bmm + torch.topk (yardstick)."""
    nq, k = qp.shape
    rows = g[probes.long()].reshape(nq, -1, k)
    cross = torch.bmm(rows, qp[:, :, None])[..., 0]
    d = torch.sum(qp * qp, 1)[:, None] + gn[probes.long()].reshape(nq, -1) \
        - 2.0 * cross
    return torch.topk(d.clamp_min_(0.0), k_top, dim=1, largest=False)


def time_ann(built, ann, queries):
    """Kernel, plain and library times of ivf_scan and pq_adc at Nq = 1
    and 64 of the ANN phase's shapes; their kernels-line entries. Each is
    timed twice: eager calls between CUDA events (the host's launch cost
    included: about 30 torch calls around the kernel) and replays of a
    CUDA graph of the same call (device time); the line's ``ms``,
    ``plain_ms`` and ``library_ms`` are the device times."""
    entries = []
    for name, kk in (("ivf", K_TOP), ("ivfpq", RERANK)):
        idx = built[name]
        rows = {}
        for nq in (1, MAX_BATCH):
            qp = project_queries(idx.L, queries[:nq].contiguous())
            if name == "ivf":
                args = _ivf_args(idx, qp)
                k = qp.shape[1]
                fn = lambda: ivf_scan_topk(*args, kk=kk)  # noqa: E731
                plain = lambda: ivf_scan_topk_ref(*args, kk)  # noqa: E731
                probes, row_bytes = args[1], 4 * k + 8
                ops = 2.0 * nq * NPROBE * idx.cap * k
                extra_bytes = 4 * nq * k
                lib = lambda: library_ivf(*args[:4], kk)  # noqa: E731
                lib_ms = _time(lib, 3)
            else:
                args = _pq_args(idx, qp)
                S = idx.pq.n_subspaces
                fn = lambda: pq_adc_topk(*args, kk=kk)  # noqa: E731
                plain = lambda: pq_adc_topk_ref(*args, kk)  # noqa: E731
                probes, row_bytes = args[2], S + 8
                ops = float(nq * NPROBE * idx.cap * (S + 3))
                extra_bytes = 4 * (args[0].numel() + args[1].numel())
                lib, lib_ms = None, None
            distinct = int(torch.unique(probes).numel())
            nbytes = (distinct * idx.cap * row_bytes + extra_bytes
                      + 4 * probes.numel() + 8 * nq * kk)
            eager = {"ms": _time(fn, 20), "plain_ms": _time(plain, 3),
                     "library_ms": lib_ms}
            graphed = {"ms": _time_graph(fn, 20),
                       "plain_ms": _time_graph(plain, 3),
                       "library_ms": (_time_graph(lib, 3) if lib_ms
                                      is not None else None)}
            # device time where the calls could be replayed from a graph
            best = {k: graphed[k] if graphed[k] is not None else eager[k]
                    for k in eager}
            # ivf_scan's dot products at the 3xTF32 rate; pq_adc's LUT adds
            # are no product: f32 outside the tensor cores
            b_ms, b_by = roofline(ops, nbytes, PEAK_3XTF32_FLOPS
                                  if name == "ivf" else PEAK_F32_FLOPS)
            rows[nq] = dict(**best, bound_ms=b_ms, bound_by=b_by,
                            eager_ms=eager, graph_ms=graphed,
                            distinct_segments=distinct, bytes=nbytes,
                            ops=ops)
            # pq_adc's S table lookups a scanned row, in the log line only
            lookup_ms = (1e3 * nq * NPROBE * idx.cap * S * 4 / PEAK_SMEM_BYTES
                         if name == "ivfpq" else None)
            if nq == MAX_BATCH:
                # the launches apart (CUDA events), and pq_adc's own phases
                # from its blocks' clock stamps
                if name == "ivf":
                    rows[nq]["launch_ms"] = launch_split(
                        lambda m: _ivf_fused(args, kk, marks=m),
                        ("plan", "scan", "merge"))
                else:
                    rows[nq]["launch_ms"] = launch_split(
                        lambda m: _pq_fused(args, kk, marks=m),
                        ("scan", "merge"))
                    rows[nq]["split"] = stamp_split(
                        lambda st: _pq_fused(args, kk, stamps=st),
                        nq * NPROBE * idx.cap)
            fmt = lambda v: "-" if v is None else f"{v:.3f}"  # noqa: E731
            log(f"{name} kernel Nq={nq} nprobe={NPROBE} cap={idx.cap} "
                f"kk={kk} ({distinct} distinct segments, {nbytes / 1e6:.1f} "
                f"MB): device ms by graph replay: kernel "
                f"{fmt(graphed['ms'])}, plain {fmt(graphed['plain_ms'])}, "
                f"library {fmt(graphed['library_ms'])}; eager calls "
                f"(host launch cost included): kernel {fmt(eager['ms'])}, "
                f"plain {fmt(eager['plain_ms'])}, library "
                f"{fmt(eager['library_ms'])}; bound {b_ms:.3f} ms ({b_by}), "
                f"{b_ms / best['ms']:.1%} of bound"
                + (f"; shared-memory lookups {lookup_ms:.3f} ms"
                   if lookup_ms is not None else ""))
        kname, src = (("ivf_scan", "kernels/ivf_scan/csrc/ivf_scan.cu")
                      if name == "ivf" else
                      ("pq_adc", "kernels/pq_adc/csrc/pq_adc.cu"))
        entry = {"name": kname, "route": "cuda",
                 "source": f"src/repro_torch/{src}",
                 "replaces": ("src/repro/kernels/ivf_scan/kernel.py:63"
                              if name == "ivf" else
                              "src/repro/kernels/pq_adc/kernel.py:94"),
                 "launches": ann[name]["launches"],
                 "max_abs_err": ann[name]["max_abs_err"],
                 **rows[MAX_BATCH],
                 "shape": {"nq": MAX_BATCH, "n_clusters": N_CLUSTERS,
                           "nprobe": NPROBE, "cap": idx.cap, "kk": kk},
                 "at_nq1": rows[1],
                 "serving": {k: v for k, v in ann[name].items()
                             if k not in ("launches", "max_abs_err")}}
        if name == "ivfpq":
            entry["library_note"] = "no single PyTorch call computes it"
        entries.append(entry)
    return entries


# -- the mutable gallery and its snapshots at dml-imnet1m width --------------

MUT_KERNELS = {"exact": metric_topk_fused, "ivf": ivf_scan_topk_fused,
               "ivfpq": pq_adc_topk_fused}
MUT_KNAMES = {"exact": "metric_topk", "ivf": "ivf_scan", "ivfpq": "pq_adc"}


def _churn_plan(serving, exp, rng):
    """The full-width churn: MUT_NEW new rows of the requests' classes (so
    they compete for the answers), MUT_UPDATE ids re-upserted with fresh
    rows of their own classes and MUT_DELETE ids deleted, each id set
    holding phase 6's first or second neighbours of the requests. Its raw
    rows are made on the card by ``class_rows`` for each base anew, from
    one seed (the same rows each time), MUT_BATCH rows a batch."""
    labels = serving["labels"]
    hot = np.unique(serving["nbrs"][:, :2])
    order = rng.permutation(exp.n_samples)
    cold = order[~np.isin(order, hot)]
    n_u = MUT_UPDATE - len(hot[1::2])
    upd = np.concatenate([hot[1::2], cold[:n_u]])
    dele = np.concatenate([hot[0::2],
                           cold[n_u:n_u + MUT_DELETE - len(hot[0::2])]])
    new_lab = labels[serving["qids"]][rng.randint(0, N_REQUESTS, MUT_NEW)]
    return {"new_lab": torch.from_numpy(new_lab).to(DEV), "upd": upd,
            "upd_lab": torch.from_numpy(labels[upd]).to(DEV), "del": dele,
            "classes": serving["classes"], "seed": 2}


def _churn(mut, engine, plan, probe):
    """Apply the plan in batches (one version bump each), checking that
    each batch flushes the engine's cache once: the probe request, cached
    before the batch, misses after it and hits again. Returns rows/s of
    upserts and of deletes, and the number of batches."""
    gen = torch.Generator(device=DEV).manual_seed(plan["seed"])
    batches = [("upsert", plan["new_lab"][s:s + MUT_BATCH], None)
               for s in range(0, MUT_NEW, MUT_BATCH)]
    batches += [("upsert", plan["upd_lab"], plan["upd"]),
                ("delete", None, plan["del"])]
    engine.search(probe)
    secs, rows = {"upsert": 0.0, "delete": 0.0}, {"upsert": 0, "delete": 0}
    for kind, lab, ids in batches:
        x = None if lab is None else class_rows(gen, lab, plan["classes"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if x is None:
            mut.delete(ids)
        else:
            mut.upsert(x, ids=ids)
        torch.cuda.synchronize()
        secs[kind] += time.perf_counter() - t0
        rows[kind] += len(ids) if x is None else len(x)
        misses, hits = engine.cache_misses, engine.cache_hits
        engine.search(probe)
        engine.search(probe)
        assert engine.cache_misses == misses + 1 and \
            engine.cache_hits == hits + 1, \
            "a mutation batch did not flush the engine's cache once"
    return {k: rows[k] / secs[k] for k in secs}, len(batches)


def _check_live(L, queries, dists, nbrs, gp, gn, live):
    """Served answers (external ids) against the plain exact scan over the
    live rows (gp, gn in ascending-id order ``live``), under compare()'s
    rule, MAX_BATCH requests at a time. Returns the max |dd|."""
    live_t = torch.from_numpy(live).to(DEV)
    err = 0.0
    for s in range(0, len(nbrs), MAX_BATCH):
        ik = torch.from_numpy(nbrs[s:s + MAX_BATCH]).to(DEV)
        pos = torch.searchsorted(live_t, ik).clamp_max(len(live) - 1)
        assert torch.equal(live_t[pos], ik), "an answer is not a live row"
        e, _ = compare(L, queries[s:s + MAX_BATCH].contiguous(), gp, gn,
                       ik.shape[1], torch.from_numpy(
                           dists[s:s + MAX_BATCH]).to(DEV), pos)
        err = max(err, e)
    return err


def _counted_serve(engine, queries_np, name):
    """_serve with every mutable-path launch count set to 0 just before
    and read just after; the base's kernel must have launched, and the
    delta scan's (metric_topk) while the delta holds rows."""
    for kern in MUT_KERNELS.values():
        kern.launches = 0
    served = _serve(engine, queries_np)
    launches = {MUT_KNAMES[k]: kern.launches
                for k, kern in MUT_KERNELS.items()}
    assert launches[MUT_KNAMES[name]] > 0, f"{name}: base kernel idle"
    assert launches["metric_topk"] > 0 or not len(engine.index.delta_ids), \
        f"{name}: delta scan idle"
    served[0]["launches"] = launches
    return served


def _snapshot_round_trip(mut, sub, L, q, card):
    """save_index / load_index through build/snapshots/<sub> on the card:
    the loaded index answers bit for bit as the saved one. Returns GB,
    save s, load s."""
    path = os.path.join(SNAPSHOT_DIR, sub)
    d0, i0 = mut.topk(q, K_TOP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_index(mut, path)
    save_s = time.perf_counter() - t0
    gb = sum(os.path.getsize(os.path.join(path, f))
             for f in os.listdir(path)) / 1e9
    t0 = time.perf_counter()
    loaded = load_index(path, expect_L=L)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    d1, i1 = loaded.topk(q, K_TOP)
    assert torch.equal(d0, d1) and torch.equal(i0, i1), \
        f"{sub}: the loaded snapshot answers differently"
    assert loaded.version == mut.version and loaded.size == mut.size
    log(f"mutation snapshot {sub}: {gb:.3f} GB, save {save_s:.2f} s, load "
        f"{load_s:.2f} s, answers bit for bit [{card}]")
    return {"gb": gb, "save_s": save_s, "load_s": load_s}


def _mutable_run(name, base, L, queries, queries_np, plan, card,
                 exact=None):
    """Phase 8b on one base: wrap it, churn, serve with tombstones live,
    check, (exact: snapshot round trip), compact, serve again, check.
    ``exact``: the exact mutable's answers before and after compaction,
    which IVF and IVFPQ recall is measured against."""
    M = base.size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mut = MutableIndex(base, L, auto_compact_delta=0, auto_compact_dead=0)
    wrap_s = time.perf_counter() - t0
    engine = RetrievalEngine(mut, k_top=K_TOP, buckets=MUT_BUCKETS)
    engine.warmup()
    rates, n_batches = _churn(mut, engine, plan, queries_np[:1])
    n_dead = len(plan["upd"]) + len(plan["del"])
    assert mut.size == M + MUT_NEW - MUT_DELETE and \
        mut.tombstones == n_dead and \
        mut.delta_rows == MUT_NEW + MUT_UPDATE, "churn counts"
    out = {"wrap_s": wrap_s, "upsert_rows_s": rates["upsert"],
           "delete_rows_s": rates["delete"], "batches": n_batches,
           "k_base": K_TOP + n_dead}
    live, d_live, n_live = _counted_serve(engine, queries_np, name)
    out["live"] = live
    if name == "exact":
        gp, gn, ids, _ = mut._live_state()
        out["max_abs_err"] = _check_live(L, queries, d_live, n_live, gp, gn,
                                         ids)
        del gp, gn
        out["snapshot"] = _snapshot_round_trip(
            mut, "exact", L, queries[:MAX_BATCH].contiguous(), card)
    else:
        live["recall"] = recall_at_k(n_live, exact["live"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assert mut.compact()
    torch.cuda.synchronize()
    out["compact_s"] = time.perf_counter() - t0
    assert mut.n_rebuilds == 0, f"{name}: compaction spilled"
    assert len(engine.registry.events("index_compaction")) == 1
    assert mut.size == mut.base.size == M + MUT_NEW - MUT_DELETE
    post, d_post, n_post = _counted_serve(engine, queries_np, name)
    out["compacted"] = post
    if name == "exact":
        b = mut.base
        out["max_abs_err"] = max(out["max_abs_err"], _check_live(
            L, queries, d_post, n_post, b.gp, b.gn, mut.base_ids))
        answers = {"live": n_live, "compacted": n_post}
    else:
        post["recall"] = recall_at_k(n_post, exact["compacted"])
        answers = None
    st = engine.stats()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    recall = (f", recall@{K_TOP} vs the exact mutable {live['recall']:.4f} "
              f"-> {post['recall']:.4f}" if name != "exact" else
              f", answers = the plain scan over the live rows (max |dd| "
              f"{out['max_abs_err']:.3e})")
    log(f"mutation {name}: wrapped {M} rows in {wrap_s:.2f} s; {n_batches} "
        f"batches: upsert {rates['upsert']:.0f} rows/s, delete "
        f"{rates['delete']:.0f} rows/s; tombstones live (base at k "
        f"{out['k_base']}): qps {live['qps']:.1f}, p50 {live['p50_ms']:.2f} "
        f"p99 {live['p99_ms']:.2f} ms, launches {live['launches']}; "
        f"compaction {out['compact_s']:.2f} s; compacted: qps "
        f"{post['qps']:.1f}, p50 {post['p50_ms']:.2f} p99 "
        f"{post['p99_ms']:.2f} ms{recall}; stats size "
        f"{st['gallery_size']}, compactions {st['compactions']}; peak "
        f"memory {out['peak_gb']:.2f} GB [{card}]")
    del mut, engine
    gc.collect()
    torch.cuda.empty_cache()
    return out, answers


def _project(L, raw, block=8192):
    """Host raw rows projected on the card (a fresh build's rows)."""
    parts = [project_gallery(L, torch.from_numpy(raw[s:s + block]).to(DEV))
             for s in range(0, raw.shape[0], block)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _check_fresh(mut, L, q, **kw):
    """A mutable just swapped or compacted (its raw rows are the live ones,
    in ascending-id order) against a fresh exact build under L of those
    rows (compare()'s rule). Returns the max |dd|."""
    assert mut.delta_rows == 0 and mut.tombstones == 0
    gp, gn = _project(L, mut.raw_base)
    dk, ik = mut.topk(q, K_TOP, **kw)
    return _check_live(L, q, dk.cpu().numpy(), ik.cpu().numpy(), gp, gn,
                       mut.base_ids)


def _mutation_cut(L, classes, exp, gen, card):
    """Metric swaps, an IVF spill rebuild and the raw-row snapshots on a
    CUT_ROWS-row gallery at full width, raw rows retained in host
    memory."""
    d_out, d_in = L.shape
    lab = torch.randint(0, exp.n_classes, (CUT_ROWS + 2048,), generator=gen,
                        device=DEV)
    raw = torch.cat([class_rows(gen, lab[s:s + MUT_BATCH], classes)
                     for s in range(0, CUT_ROWS, MUT_BATCH)])
    q = (raw[::CUT_ROWS // MAX_BATCH] + 0.1 * torch.randn(
        (MAX_BATCH, d_in), generator=gen, device=DEV)).contiguous()
    extra = class_rows(gen, lab[CUT_ROWS:], classes)
    kw = {"exact": {},
          "ivf": dict(n_clusters=CUT_CLUSTERS, nprobe=CUT_CLUSTERS,
                      iters=KM_ITERS),
          "ivfpq": dict(n_clusters=CUT_CLUSTERS, nprobe=NPROBE,
                        n_subspaces=PQ_SUBSPACES, bits=PQ_BITS,
                        rerank_depth=RERANK, iters=KM_ITERS)}
    muts = {}
    for name, bkw in kw.items():
        t0 = time.perf_counter()
        muts[name] = MutableIndex.build(L, raw, base=name, retain_raw=True,
                                        auto_compact_delta=0,
                                        auto_compact_dead=0, **bkw)
        muts[name].upsert(extra[:1024])
        muts[name].delete(np.arange(0, CUT_ROWS, 32))
        torch.cuda.synchronize()
        log(f"mutation cut {name}: built over {CUT_ROWS} x {d_in} rows "
            f"(raw {muts[name].raw_base.nbytes / 1e9:.2f} GB in host "
            f"memory) and churned in {time.perf_counter() - t0:.2f} s "
            f"[{card}]")
    del raw
    out = {"swap": {}}
    L2 = torch.randn((d_out, d_in), generator=gen, device=DEV) / d_in ** 0.5
    L3 = torch.randn((CUT_RANK, d_in), generator=gen, device=DEV) / d_in ** 0.5
    for name in ("exact", "ivf"):
        m = muts[name]
        probe_kw = {"nprobe": CUT_CLUSTERS} if name == "ivf" else {}
        for tag, L_new in (("same_rank", L2), (f"rank_{CUT_RANK}", L3)):
            steps = {}
            t0 = time.perf_counter()
            m.swap_metric(L_new, timings=steps)
            total = time.perf_counter() - t0
            err = _check_fresh(m, L_new, q, **probe_kw)
            out["swap"][f"{name}_{tag}"] = dict(s=total, **steps)
            log(f"mutation cut {name}: swap_metric to {tuple(L_new.shape)} "
                f"over {m.size} rows in {total:.2f} s "
                f"({ {k: round(v, 3) for k, v in steps.items()} }); equals "
                f"a fresh build (max |dd| {err:.3e}) [{card}]")
    m = muts["ivf"]
    m.upsert(extra[1024:1280])
    m.delete(np.arange(1, CUT_ROWS, 64))
    out["snapshot"] = {n: _snapshot_round_trip(muts[n], f"cut_{n}",
                                               muts[n].L, q, card)
                       for n in ("ivf", "ivfpq")}
    free = m.base.n_clusters * m.base.cap - m.base.size
    m.upsert(class_rows(gen, lab[:free + 512], classes))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.compact()
    torch.cuda.synchronize()
    spill_s = time.perf_counter() - t0
    assert m.n_rebuilds == 1, "the IVF fold past its headroom did not spill"
    err = _check_fresh(m, m.L, q, nprobe=CUT_CLUSTERS)
    out["spill_s"] = spill_s
    log(f"mutation cut ivf: {free + 512} rows upserted past {free} free "
        f"slots -> spill rebuild in {spill_s:.2f} s over {m.size} rows "
        f"(n_rebuilds {m.n_rebuilds}); equals a fresh build (max |dd| "
        f"{err:.3e}) [{card}]")
    return out



def phase_mutation(index, queries, serving, built, card, exp=IMNET_1M):
    """Phase 8b: the mutable gallery over phase 6's and phase 8's indexes
    and requests, the cut, then each base's kernel at k_base on Nq 64
    against its plain version, and the base calls' device ms."""
    t_phase = time.perf_counter()
    L = index.L
    queries_np = queries.cpu().numpy()
    gen = torch.Generator(device=DEV).manual_seed(3)
    plan = _churn_plan(serving, exp, np.random.RandomState(3))
    shutil.rmtree(SNAPSHOT_DIR, ignore_errors=True)
    try:
        runs, exact = {}, None
        for name, base in (("exact", index), ("ivf", built["ivf"]),
                           ("ivfpq", built["ivfpq"])):
            runs[name], answers = _mutable_run(name, base, L, queries,
                                               queries_np, plan, card, exact)
            exact = exact or answers
        new_hit = float(np.mean((exact["live"] >= index.size).any(1)))
        del plan
        cut = _mutation_cut(L, serving["classes"], exp, gen, card)
    finally:
        shutil.rmtree(SNAPSHOT_DIR, ignore_errors=True)

    # the bases at k_base on Nq 64 (the wide paths): each kernel against
    # its plain version, then the base calls' device ms at k 10 and k_base
    k_wide = runs["exact"]["k_base"]
    qb = queries[:MAX_BATCH].contiguous()
    ivf, pq = built["ivf"], built["ivfpq"]
    errs = {}
    dk, ik = metric_topk(L, qb, index.gp, index.gn, k_top=k_wide)
    errs["metric_topk"], _ = compare(L, qb, index.gp, index.gn, k_wide, dk,
                                     ik)
    qp = project_queries(L, qb)
    args = _ivf_args(ivf, qp)
    dk, ik = ivf_scan_topk(*args, kk=k_wide)
    errs["ivf_scan"], _ = compare_ivf(*args, k_wide, dk, ik)
    args = _pq_args(pq, qp)
    dk, ik = pq_adc_topk(*args, kk=k_wide)
    dp, ip = pq_adc_topk_ref(*args, k_wide)
    assert torch.equal(dk, dp) and torch.equal(ik, ip), \
        f"pq_adc at kk {k_wide} is not bit-identical"
    errs["pq_adc"] = 0.0
    del dk, ik, dp, ip, args
    calls = {n: {k: _time(lambda b=b, k=k: b.topk(qb, k), 5)
                 for k in (K_TOP, k_wide)}
             for n, b in (("exact", index), ("ivf", ivf), ("ivfpq", pq))}
    peak = max(torch.cuda.max_memory_allocated() / 1e9,
               *(r["peak_gb"] for r in runs.values()))
    log(f"mutation: base calls at Nq {MAX_BATCH} against their plain "
        f"versions at k {k_wide}: max |dd| {errs}; device ms at k "
        f"{K_TOP} / {k_wide}: "
        f"{ {n: [round(v, 3) for v in c.values()] for n, c in calls.items()} }"
        f"; requests answered with an upserted row (exact, tombstones live): "
        f"{new_hit:.3f}; peak memory {peak:.2f} GB; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    kernels = {MUT_KNAMES[n]: {
        "launches": {f"{when}_{k}": r[when]["launches"][MUT_KNAMES[n]]
                     for k, r in runs.items()
                     for when in ("live", "compacted")},
        "k_base": k_wide, "max_abs_err_k_base": errs[MUT_KNAMES[n]],
        "base_call_ms": calls[n]} for n in MUT_KERNELS}
    return {"runs": runs, "cut": cut, "kernels": kernels, "peak_gb": peak,
            "new_row_share": new_hit}


# -- the traffic-shaped front end at dml-imnet1m width (phase 8c) ------------

FE_CLASSES, FE_MIX = ("interactive", "batch", "mining"), (0.7, 0.2, 0.1)
FE_BURST = 4_096            # requests submitted at once (16 x the 256 rows)
FE_STEADY_GROUP, FE_STEADY_GAP_S = 8, 0.008     # 1,000 requests/s
FE_TRICKLE_GAP_S, FE_TRICKLE_MAX_S = 0.01, 5.0  # after the burst drains
FE_OTHER_MAX = N_REQUESTS // 50   # steady requests on other segments
CHECK_ROWS = 32             # query rows a plain IVF / IVFPQ check holds
FE_KERNELS = {"exact": metric_topk_fused, "ivf": ivf_scan_topk_fused,
              "ivfpq": pq_adc_topk_fused}


def _same_answers(L, queries, gn, d, i, d_ref, i_ref):
    """Two served answers to the same requests, held as compare() holds a
    kernel to its plain version: distances within atol + rtol * (qn + gn
    of the id), ids equal at every rank whose distance is apart from its
    neighbours' by more than that (the last rank's right neighbour is not
    known, so it counts as near), and at a near-tie the other answer's id
    carries the same distance. Returns (max |dd|, requests whose ids
    differ at a near-tie)."""
    qn = torch.sum(torch.square(project_queries(L, queries)), dim=1)
    ids = torch.from_numpy(np.asarray(i_ref, np.int64)).to(DEV)
    tol = ATOL + RTOL * (qn[:, None] + gn[ids])
    dr = torch.from_numpy(d_ref).to(DEV)
    err = (torch.from_numpy(d).to(DEV) - dr).abs()
    assert bool((err <= tol).all()), \
        f"distances differ: max err {err.max().item():.3e}"
    inf = torch.full_like(dr[:, :1], float("inf"))
    apart = ((dr - torch.cat([-inf, dr[:, :-1]], 1)) > tol) & \
        ((torch.cat([dr[:, 1:], -inf], 1) - dr) > tol)
    same = torch.from_numpy(np.asarray(i) == np.asarray(i_ref)).to(DEV)
    bad = (~same & apart).any(1)
    if bool(bad.any()):
        r = int(torch.nonzero(bad)[0])
        raise AssertionError(f"ids differ at distinct distances: "
                             f"{i[r]} vs {i_ref[r]}, {d[r]} vs {d_ref[r]}")
    return float(err.max()), int((~same).any(1).sum())


def _pq_plain_topk(pq, q, k, **knobs):
    """IVFPQIndex.topk with pq_adc's plain version in place of the kernel
    (everything else in the call unchanged), CHECK_ROWS query rows at a
    time (each row's answer is its own: the plain version's gathers stay
    a few GB)."""
    def plain(tables, dc, probes, *seg, kk, block_q):
        outs = [pq_adc_topk_ref(tables[s:s + CHECK_ROWS],
                                dc[s:s + CHECK_ROWS],
                                probes[s:s + CHECK_ROWS], *seg, kk)
                for s in range(0, probes.shape[0], CHECK_ROWS)]
        return tuple(torch.cat(o) for o in zip(*outs))

    saved = pq_mod.pq_adc_topk
    pq_mod.pq_adc_topk = plain
    try:
        return pq.topk(q, k, **knobs)
    finally:
        pq_mod.pq_adc_topk = saved


def _check_batch(name, base, gn, qs, knobs, dk, ik, bucket, k=K_TOP):
    """One engine call at ``knobs`` and k_top ``k`` against the plain
    version at the same knobs on the same (bucket-padded) queries.
    ``gn``: the exact index's row norms (unused by IVF and IVFPQ).
    Returns max |dd|."""
    n = qs.shape[0]
    q = torch.zeros((bucket, qs.shape[1]), device=DEV)
    q[:n] = torch.from_numpy(qs).to(DEV)
    dk = torch.from_numpy(dk).to(DEV)
    ik = torch.from_numpy(ik).to(DEV)
    if name == "exact":
        return compare(base.L, q[:n].contiguous(), base.gp, gn, k, dk,
                       ik)[0]
    if name == "ivf":
        qp = project_queries(base.L, q)
        qp, probes, *seg = _ivf_args(base, qp,
                                     knobs.get("nprobe", base.nprobe))
        err = 0.0
        for s in range(0, n, CHECK_ROWS):
            r = slice(s, min(s + CHECK_ROWS, n))
            err = max(err, compare_ivf(qp[r], probes[r], *seg, k, dk[r],
                                       ik[r])[0])
        return err
    dp, ip = _pq_plain_topk(base, q, K_TOP, **knobs)
    assert torch.equal(dp[:n], dk) and torch.equal(ip[:n], ik), \
        "ivfpq: a served answer differs from the plain version at its knobs"
    return 0.0


def _check_calls(name, base, gn, engine, calls, k=K_TOP):
    """Every recorded engine call (``_record``) against the plain version
    at its knobs and k_top ``k``, on ``engine``'s bucket for its size.
    Returns max |dd|."""
    assert calls, "no engine call was recorded"
    return max(_check_batch(name, base, gn, qs, kw, *ans,
                            engine._bucket(len(qs)), k)
               for qs, kw, ans in calls)


def _level_times(transitions, t0, t1):
    """Seconds at each ladder level between clock times t0 and t1."""
    out, level, t = {}, 0, t0
    for tr in transitions:
        out[level] = out.get(level, 0.0) + tr.t - t
        level, t = tr.level_to, tr.t
    out[level] = out.get(level, 0.0) + t1 - t
    return {lv: round(s, 4) for lv, s in sorted(out.items())}


def _gc_pauses():
    """Time every collection of the garbage collector from here on, as
    (generation, ms); ``gc.callbacks.remove(cb)`` stops it. Returns
    (cb, the list)."""
    pauses, started = [], []

    def cb(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            pauses.append((info["generation"],
                           (time.perf_counter() - started.pop()) * 1e3))

    gc.callbacks.append(cb)
    return cb, pauses


def _steady(sched, queries_np, mix):
    """The requests at FE_STEADY_GROUP every FE_STEADY_GAP_S (below the
    high watermark): every one must be served. A full collection of the
    garbage collector comes first: this process holds the earlier phases'
    objects, and the bursts leave cyclic garbage (failed futures, their
    tracebacks), so one collection of the oldest generation stops every
    thread for 0.2-0.36 s on the card's host, past the interactive
    class's 0.1 s deadline, and one fell into this window by chance
    once (``tools/frontend_gc.py``). Returns qps, p50, p99, that
    collection's ms and the collections inside the window."""
    t_gc = time.perf_counter()
    gc.collect()
    gc_ms = (time.perf_counter() - t_gc) * 1e3
    cb, pauses = _gc_pauses()
    futs, done = [], {}
    try:
        t0 = time.perf_counter()
        for i, q in enumerate(queries_np):
            f = sched.submit(q, priority=str(mix[i]))
            f.add_done_callback(lambda _, i=i: done.__setitem__(
                i, time.perf_counter()))
            futs.append((time.perf_counter(), f))
            if (i + 1) % FE_STEADY_GROUP == 0:
                time.sleep(FE_STEADY_GAP_S)
        for _, f in futs:
            f.result(timeout=120)
        wall = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(cb)
    lat = np.array([done[i] - t for i, (t, _) in enumerate(futs)]) * 1e3
    p50, p99 = percentile(lat, (50.0, 99.0))
    return {"qps": len(futs) / wall, "p50_ms": p50, "p99_ms": p99,
            "gc": {"before_ms": gc_ms, **_gc_summary(pauses)}}


def _gc_summary(pauses):
    """Collections by generation and the longest pause in ms."""
    return {"by_generation": [sum(g == n for g, _ in pauses)
                              for n in range(3)],
            "longest_ms": max((ms for _, ms in pauses), default=0.0)}


def _record(engine, limit=None):
    """Record every engine.search call from here on (the first ``limit``
    of them) as (query rows, knobs, (dists, ids)), a single query as one
    row, on the host; ``del engine.search`` stops it. Returns the list."""
    calls, real = [], engine.search

    def record(qs, k_top=None, *, span=None, **kw):
        out = real(qs, k_top, span=span, **kw)
        if limit is None or len(calls) < limit:
            rows = np.array(host_array(qs), np.float32)
            calls.append((np.atleast_2d(rows), dict(kw),
                          tuple(np.atleast_2d(a) for a in out)))
        return out

    engine.search = record
    return calls


def _by_request(calls, queries_np):
    """Each request row's (call index, row in the call)."""
    where = {}
    for c, (qs, _, _) in enumerate(calls):
        for r, row in enumerate(qs):
            where[row.tobytes()] = (c, r)
    return [where[q.tobytes()] for q in queries_np]


def _candidates(name, base, engine, calls):
    """Per call, the segments each row probed and (IVFPQ) the ADC
    candidates it reranked, recomputed as the index computed them: on the
    call's bucket-padded queries (the projection's rounding depends on
    the bucket, a cuBLAS shape)."""
    out = []
    for qs, kw, _ in calls:
        n = qs.shape[0]
        q = torch.zeros((engine._bucket(n), qs.shape[1]), device=DEV)
        q[:n] = torch.from_numpy(qs).to(DEV)
        qp = project_queries(base.L, q)
        nprobe = kw.get("nprobe", base.nprobe)
        if name == "ivf":
            probes = _ivf_args(base, qp, nprobe)[1]
            cand = None
        else:
            args = _pq_args(base, qp, nprobe)
            probes = args[2]
            rr = min(kw.get("rerank", base.rerank_depth), nprobe * base.cap)
            cand = pq_adc_topk(*args, kk=max(K_TOP, rr))[1][:n].cpu()
        out.append((torch.sort(probes[:n], 1).values.cpu(), cand))
    return out


def _agree(name, base, engine, queries, gn, ref_calls, calls):
    """Two runs' answers to the same requests (each run's engine calls as
    ``_record`` keeps them), request by request: wherever both runs
    scanned the same segments (and, IVFPQ, reranked the same ADC
    candidates), the answers agree under ``_same_answers``; requests
    that scanned others are counted. ``gn``: the row norms by answer id.
    Returns (max |dd|, requests with ids resolved otherwise at a
    near-tie, requests with other ids in all, requests with other
    segments or candidates)."""
    queries_np = queries.cpu().numpy()
    at_ref, at = (_by_request(cl, queries_np) for cl in (ref_calls, calls))
    d_ref, i_ref, d, i = (np.stack([cl[c][2][j][r] for c, r in where])
                          for cl, where, j in ((ref_calls, at_ref, 0),
                                               (ref_calls, at_ref, 1),
                                               (calls, at, 0),
                                               (calls, at, 1)))
    same = np.ones(len(queries_np), bool)
    if name != "exact":
        cr, cc = (_candidates(name, base, engine, cl)
                  for cl in (ref_calls, calls))
        for k, ((c1, r1), (c2, r2)) in enumerate(zip(at_ref, at)):
            same[k] = torch.equal(cr[c1][0][r1], cc[c2][0][r2]) and (
                cr[c1][1] is None or torch.equal(
                    torch.sort(cr[c1][1][r1]).values,
                    torch.sort(cc[c2][1][r2]).values))
    err, ties = _same_answers(base.L, queries[same], gn, d[same], i[same],
                              d_ref[same], i_ref[same]) \
        if same.any() else (0.0, 0)
    return err, ties, int((i_ref != i).any(1).sum()), int((~same).sum())


def _burst(sched, engine, qb, mix):
    """FE_BURST requests submitted at once under the tracer; every future
    resolves exactly once (served, RejectedError at submit, or
    DeadlineExceededError). Returns the burst's outcome record."""
    calls = _record(engine)
    engine.tracer.sample_rate, engine.tracer.max_traces = 1.0, 2 * FE_BURST
    engine.tracer.drain()
    n_q, n_dev, n_hit = (engine.n_queries, engine.n_device_queries,
                         engine.cache_hits)
    futs, done, rejected = [], {}, {c: 0 for c in FE_CLASSES}
    t_clock0, t0 = sched.clock.now(), time.perf_counter()
    for i in range(len(qb)):
        try:
            f = sched.submit(qb[i], priority=str(mix[i]))
        except RejectedError:
            rejected[str(mix[i])] += 1
            continue
        f.add_done_callback(lambda _, i=i: done.__setitem__(
            i, time.perf_counter()))
        futs.append((i, time.perf_counter(), f))
    served, expired = {}, {c: 0 for c in FE_CLASSES}
    lat = {c: [] for c in FE_CLASSES}
    for i, t_sub, f in futs:
        try:
            served[i] = f.result(timeout=300)
            lat[str(mix[i])].append(done[i] - t_sub)
        except DeadlineExceededError:
            expired[str(mix[i])] += 1
    wall = time.perf_counter() - t0
    # a trace is handed to the tracer just after its future resolves
    traces, t_wait = [], time.perf_counter()
    while len(traces) < len(futs) and time.perf_counter() - t_wait < 30:
        traces += engine.tracer.drain()
        time.sleep(0.001)
    assert len(traces) == len(futs), "an admitted request left no trace"
    del engine.search
    engine.tracer.sample_rate = 0.0
    assert all(f.done() for _, _, f in futs)
    assert len(served) + sum(expired.values()) == len(futs)
    assert len(futs) + sum(rejected.values()) == len(qb)
    rows = sum(len(qs) for qs, _, _ in calls)
    # expired and rejected requests never reach the engine
    assert rows == len(served) == engine.n_queries - n_q, \
        "the engine saw rows that were not served"
    assert engine.n_device_queries - n_dev == \
        len(served) - (engine.cache_hits - n_hit)
    return {"calls": calls, "served": served, "rejected": rejected,
            "expired": expired, "lat": lat, "wall": wall,
            "clock0": t_clock0, "traces": traces}


def _check_burst(name, base, gn, engine, sched, qb, burst):
    """Served answers are the batches' own rows; each batch span carries
    its level and knobs; each batch equals the plain version at its
    knobs. Returns max |dd|."""
    served = sorted(burst["served"])
    for i, (c, r) in zip(served, _by_request(burst["calls"], qb[served])):
        (d, ids), (dk, ik) = burst["served"][i], burst["calls"][c][2]
        assert np.array_equal(d, dk[r]) and np.array_equal(ids, ik[r])
    ladder = sched.controller.ladder
    spans = sorted((sp for tr in burst["traces"]
                    for sp in tr["root"]["children"] if sp["name"] == "batch"),
                   key=lambda sp: sp["t_start"])
    assert [(sp["attrs"]["size"], ladder[sp["attrs"]["level"]])
            for sp in spans] == [(len(qs), kw)
                                 for qs, kw, _ in burst["calls"]]
    for sp in spans:
        knobs = {k[5:]: v for k, v in sp["attrs"].items()
                 if k.startswith("knob_")}
        assert knobs == ladder[sp["attrs"]["level"]]
    return _check_calls(name, base, gn, engine, burst["calls"])


def _level_ms(name, base, q64):
    """Device ms at Nq 64 of the scan kernel, and of the whole index.topk
    call, at each ladder level's knobs: graph replay (device time) and
    eager calls between CUDA events (the host's launch cost included), as
    time_ann times them."""
    out = {}
    qp = project_queries(base.L, q64)
    for lv, kw in enumerate(default_ladder(base, K_TOP)):
        nprobe = kw.get("nprobe", base.nprobe)
        if name == "ivf":
            args = _ivf_args(base, qp, nprobe)
            kern = lambda: ivf_scan_topk(*args, kk=K_TOP)  # noqa: E731
        else:
            rr = min(kw.get("rerank", base.rerank_depth), nprobe * base.cap)
            args = _pq_args(base, qp, nprobe)
            kern = lambda: pq_adc_topk(  # noqa: E731
                *args, kk=max(K_TOP, rr))
        call = lambda: base.topk(q64, K_TOP, **kw)  # noqa: E731
        out[lv] = {"knobs": kw, "kernel_ms": _time_graph(kern, 20),
                   "kernel_eager_ms": _time(kern, 20),
                   "topk_ms": _time_graph(call, 10),
                   "topk_eager_ms": _time(call, 10)}
    return out


def phase_frontend(index, queries, serving, built, card):
    """Phase 8c: a RequestScheduler with default settings in front of an
    engine over each of phases 6 and 8's indexes; steady traffic held to
    the MicroBatcher's answers, then an overload burst."""
    t_phase = time.perf_counter()
    queries_np = queries.cpu().numpy()
    rng = np.random.RandomState(4)
    mix = rng.choice(FE_CLASSES, size=N_REQUESTS, p=FE_MIX)
    gen = torch.Generator(device=DEV).manual_seed(4)
    qb = (queries.repeat(FE_BURST // N_REQUESTS, 1) + 0.1 * torch.randn(
        (FE_BURST, queries.shape[1]), generator=gen, device=DEV))
    qb = qb.cpu().numpy()
    mix_b = rng.choice(FE_CLASSES, size=FE_BURST, p=FE_MIX)
    bases = {"exact": index, "ivf": built["ivf"], "ivfpq": built["ivfpq"]}
    out = {}
    for name, base in bases.items():
        engine = RetrievalEngine(base, k_top=K_TOP, buckets=SERVE_BUCKETS)
        engine.warmup()
        mb_calls = _record(engine)
        mb = _serve(engine, queries_np)[0]
        del engine.search
        engine.invalidate_cache()
        sched = RequestScheduler(engine)
        try:
            sched.warmup()
            ladder = sched.controller.ladder
            st_calls = _record(engine)
            steady = _steady(sched, queries_np, mix)
            del engine.search
            assert not sched.controller.transitions, \
                f"{name}: the steady traffic moved the ladder"
            assert all(kw == {} for _, kw, _ in st_calls), \
                f"{name}: a steady batch ran below level 0's knobs"
            (steady["max_abs_err"], steady["tie_ids"], steady["other_ids"],
             steady["other_segments"]) = _agree(
                    name, base, engine, queries, index.gn, mb_calls,
                    st_calls)
            assert steady["other_segments"] <= FE_OTHER_MAX, \
                f"{name}: {steady['other_segments']} steady requests " \
                f"scanned other segments than the MicroBatcher's"
            steady["plain_max_abs_err"] = _check_calls(
                name, base, index.gn, engine, st_calls)
            engine.invalidate_cache()
            for kern in FE_KERNELS.values():
                kern.launches = 0               # counts of the burst only
            burst = _burst(sched, engine, qb, mix_b)
            launches = {k: kern.launches
                        for k, kern in FE_KERNELS.items()}
            assert launches[name] > 0, \
                f"{name}: the burst launched no kernel"
            ctrl = sched.controller
            deepest = max([tr.level_to for tr in ctrl.transitions],
                          default=0)
            t_trickle, n_trickle = time.perf_counter(), 0
            while ctrl.level > 0 and \
                    time.perf_counter() - t_trickle < FE_TRICKLE_MAX_S:
                sched.submit(queries_np[n_trickle % N_REQUESTS],
                             priority="mining").result(timeout=60)
                n_trickle += 1
                time.sleep(FE_TRICKLE_GAP_S)
            levels = _level_times(ctrl.transitions, burst["clock0"],
                                  sched.clock.now())
            obs = sched.observability()
        finally:
            closed = sched.close()
        assert closed, "scheduler workers did not stop"
        if name != "exact":
            assert deepest >= 1, f"{name}: the burst never stepped down"
            assert ctrl.level == 0, f"{name}: the ladder did not restore"
        else:
            assert ladder == ({},) and not ctrl.transitions
        for tr in ctrl.transitions:
            log(f"  {name} ladder {tr.level_from} -> {tr.level_to} at "
                f"+{tr.t - burst['clock0']:.3f} s (depth {tr.queue_depth}): "
                f"{tr.reason}")
        err = _check_burst(name, base, index.gn, engine, sched, qb, burst)
        by_cls = {}
        for c in FE_CLASSES:
            lat = np.array(burst["lat"][c]) * 1e3
            p50, p99 = (percentile(lat, (50.0, 99.0)) if len(lat)
                        else (None, None))
            by_cls[c] = {"served": len(lat), "rejected": burst["rejected"][c],
                         "expired": burst["expired"][c], "p50_ms": p50,
                         "p99_ms": p99}
        n_served = len(burst["served"])
        out[name] = {
            "ladder": [dict(kw) for kw in ladder], "microbatcher": mb,
            "steady": steady, "burst_qps": n_served / burst["wall"],
            "burst_wall_s": burst["wall"], "by_class": by_cls,
            "deepest_level": deepest, "s_at_level": levels,
            "transitions": len(ctrl.transitions), "trickle": n_trickle,
            "batches": len(burst["calls"]), "launches": launches,
            "max_abs_err": err, "frontend_rejections": obs["rejections"],
            "frontend_expired": obs["expired"]}
        if name != "exact":
            out[name]["level_ms"] = _level_ms(name, base,
                                              queries[:MAX_BATCH]
                                              .contiguous())
        log(f"frontend {name}: ladder {out[name]['ladder']}; steady "
            f"{N_REQUESTS} requests: qps {steady['qps']:.1f}, p50 "
            f"{steady['p50_ms']:.2f} p99 {steady['p99_ms']:.2f} ms; "
            f"a full collection before it {steady['gc']['before_ms']:.1f} "
            f"ms, collections inside it by generation "
            f"{steady['gc']['by_generation']}, longest "
            f"{steady['gc']['longest_ms']:.1f} ms; each batch "
            f"= the plain version (max |dd| "
            f"{steady['plain_max_abs_err']:.3e}); against the "
            f"MicroBatcher's answers: {steady['other_ids']} requests with "
            f"other ids, {steady['other_segments']} of them (at most "
            f"{FE_OTHER_MAX}) scanned other segments or candidates (the "
            f"projection's rounding follows the batch's bucket), {steady['tie_ids']} resolved a near-tie "
            f"otherwise; the rest equal (max |dd| "
            f"{steady['max_abs_err']:.3e}); MicroBatcher qps "
            f"{mb['qps']:.1f} [{card}]")
        cls_txt = {c: {k: (round(v, 2) if isinstance(v, float) else v)
                       for k, v in b.items()} for c, b in by_cls.items()}
        log(f"frontend {name}: burst of {FE_BURST}: served {n_served} in "
            f"{burst['wall']:.3f} s ({out[name]['burst_qps']:.1f} qps), "
            f"{len(burst['calls'])} batches, launches {launches}; by class "
            f"{cls_txt}; "
            f"deepest level {deepest}, seconds at each level {levels} "
            f"({n_trickle} trickle requests to restore); each batch = the "
            f"plain version at its knobs (max |dd| {err:.3e}) [{card}]")
        if name != "exact":
            keys = ("kernel_ms", "kernel_eager_ms", "topk_ms",
                    "topk_eager_ms")
            lv_txt = {lv: (r["knobs"], *(None if r[k] is None
                                         else round(r[k], 4) for k in keys))
                      for lv, r in out[name]["level_ms"].items()}
            log(f"frontend {name}: ms at Nq {MAX_BATCH} by level (knobs: "
                f"kernel graph / eager, index.topk graph / eager): "
                f"{lv_txt} [{card}]")
        del engine, sched, burst
    log(f"frontend: phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return out


# -- multi-tenant serving over one shared raw store (phase 8d) ---------------

TEN_ROWS, TEN_BLOCK, TEN_CLUSTERS = 262_144, 16_384, 256
TEN_EXTEND, TEN_REMOVE, TEN_RANK, TEN_CUT = 16_384, 4_096, 500, 32_768
TEN_SHADOW_RATE, TEN_DEADLINE_S = 0.25, 10.0


def _tenant_specs(L, gen):
    """(name, L, backend, build kwargs, class) of the four tenants, and
    the shadow's candidate factor for t1; the factors after phase 6's L
    are seeded."""
    d_out, d_in = L.shape
    draw = lambda rows: torch.randn((rows, d_in), generator=gen,  # noqa
                                    device=DEV) / d_in ** 0.5
    L1, L2, L3, L_cand = draw(d_out), draw(d_out), draw(TEN_RANK), draw(d_out)
    ivf = dict(n_clusters=TEN_CLUSTERS, nprobe=NPROBE, iters=KM_ITERS)
    pq = dict(ivf, n_subspaces=PQ_SUBSPACES, bits=PQ_BITS,
              rerank_depth=RERANK)
    return ([("t0", L, "exact", {}, "interactive"),
             ("t1", L1, "ivf", ivf, "batch"),
             ("t2", L2, "ivfpq", pq, "batch"),
             ("t3", L3, "exact", {}, "mining")], L_cand)


def _add_tenants(router, specs):
    for name, Lt, backend, kw, cls in specs:
        router.add_tenant(name, Lt, backend=backend, build_kwargs=kw,
                          priority=cls, deadline_s=TEN_DEADLINE_S)


def _tenant_traffic(router, queries_np, names):
    """The requests to every tenant through router.submit, interleaved;
    returns ({name: (dists, ids)}, wall s, {name: latencies s}, {name:
    requests / s until its last answer})."""
    futs, done = [], {}
    t0 = time.perf_counter()
    for i, q in enumerate(queries_np):
        for name in names:
            f = router.submit(name, q)
            key = (name, i)
            f.add_done_callback(lambda _, key=key: done.__setitem__(
                key, time.perf_counter()))
            futs.append((key, time.perf_counter(), f))
    res = {(key): f.result(timeout=300) for key, _, f in futs}
    wall = time.perf_counter() - t0
    lat = {n: [] for n in names}
    for key, t_sub, _ in futs:
        lat[key[0]].append(done[key] - t_sub)
    n = len(queries_np)
    answers = {t: (np.stack([res[(t, i)][0] for i in range(n)]),
                   np.stack([res[(t, i)][1] for i in range(n)]))
               for t in names}
    qps = {t: n / (max(done[(t, i)] for i in range(n)) - t0) for t in names}
    return answers, wall, lat, qps


def _tenant_snapshot(store, specs, queries_np, card):
    """save_tenants / load_tenants on a TEN_CUT-row cut of the store:
    every tenant answers bit for bit after the load; a swapped factor
    raises TenantFingerprintError. Returns GB, save s, load s."""
    path = os.path.join(SNAPSHOT_DIR, "tenants")
    cut = TenantRouter(store[:TEN_CUT], k_top=K_TOP, copy=False)
    _add_tenants(cut, specs)
    before = {n: cut.search(n, queries_np[:MAX_BATCH]) for n, *_ in specs}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_tenants(cut, path)
    save_s = time.perf_counter() - t0
    gb = sum(os.path.getsize(os.path.join(dp, f))
             for dp, _, fs in os.walk(path) for f in fs) / 1e9
    t0 = time.perf_counter()
    back = load_tenants(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for name, *_ in specs:
        assert back.tenant(name).warm
        d, i = back.search(name, queries_np[:MAX_BATCH])
        assert np.array_equal(d, before[name][0]) and \
            np.array_equal(i, before[name][1]), \
            f"{name}: the loaded tenant answers differently"
    del back
    with np.load(os.path.join(path, "factors.npz")) as z:
        factors = {k: z[k] for k in z.files}
    factors["t0"], factors["t1"] = factors["t1"], factors["t0"]
    np.savez(os.path.join(path, "factors.npz"), **factors)
    try:
        load_tenants(path)
        raise AssertionError("a swapped factor loaded")
    except TenantFingerprintError:
        pass
    log(f"tenants snapshot: {TEN_CUT}-row cut, {gb:.3f} GB, save "
        f"{save_s:.2f} s, load {load_s:.2f} s, answers bit for bit; a "
        f"swapped factor raises TenantFingerprintError [{card}]")
    return {"gb": gb, "save_s": save_s, "load_s": load_s}


def phase_tenants(L, queries, serving, card, exp=IMNET_1M):
    """Phase 8d: four tenants over one TEN_ROWS-row raw store on the card,
    a scheduler in front, a shadow arm promoted, the store mutated, and a
    tenant snapshot round trip on a cut."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    d_in = L.shape[1]
    queries_np = queries.cpu().numpy()
    gen = torch.Generator(device=DEV).manual_seed(5)
    lab = torch.randint(0, exp.n_classes, (TEN_ROWS + TEN_EXTEND,),
                        generator=gen, device=DEV)
    t0 = time.perf_counter()
    store = torch.empty((TEN_ROWS, d_in), device=DEV)
    for s in range(0, TEN_ROWS, TEN_BLOCK):
        store[s:s + TEN_BLOCK] = class_rows(gen, lab[s:s + TEN_BLOCK],
                                            serving["classes"])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    router = TenantRouter(store, k_top=K_TOP, copy=False)  # shares store
    assert torch.cuda.memory_allocated() == held, "the store was copied"
    specs, L_cand = _tenant_specs(L, gen)
    names = [s[0] for s in specs]
    _add_tenants(router, specs)
    build_s = {}
    for name in names:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        router.warm(name)
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
    router.register_shadow("t1", L_cand, sample_rate=TEN_SHADOW_RATE)
    t0 = time.perf_counter()
    for i in range(int(1 / TEN_SHADOW_RATE)):   # the last one mirrors
        router.search("t1", queries_np[i])
    build_s["t1#shadow"] = time.perf_counter() - t0
    shadow = router.tenant("t1").shadow.engine
    for engine in (router.tenant("t1").engine, shadow):
        engine.invalidate_cache()       # each call below runs its kernel
    sched = RequestScheduler(router.tenant("t0").engine,
                             registry=router.registry, degrade=False)
    router.attach_scheduler(sched)
    kerns = {"metric_topk": metric_topk_fused,
             "ivf_scan": ivf_scan_topk_fused, "pq_adc": pq_adc_topk_fused}
    for kern in kerns.values():
        kern.launches = 0                       # counts of the traffic only
    calls = {n: _record(router.tenant(n).engine) for n in names}
    calls["t1#shadow"] = _record(shadow)
    try:
        answers, wall, lat, qps = _tenant_traffic(router, queries_np,
                                                  names)
        launches = {k: kern.launches for k, kern in kerns.items()}
    finally:
        closed = sched.close()
        for n in names:
            del router.tenant(n).engine.search
        del shadow.search
    assert closed, "scheduler workers did not stop"
    assert all(launches.values()), f"a tenant kernel never ran: {launches}"
    arm = router.tenant("t1").shadow.stats()
    assert arm["n_mirrored"] >= TEN_SHADOW_RATE * N_REQUESTS
    assert all(kw == {} for cl in calls.values() for _, kw, _ in cl)
    # every engine call of the traffic (the shadow's single-query calls
    # too) = the plain version on its inputs; each answer = router.search
    # on the same tenant (as _agree holds it: the scheduler's batches and
    # one 256-row call project the queries at other cuBLAS shapes); t0 =
    # the plain scan over the store
    err, other = {}, {}
    err["t1#shadow_plain"] = _check_calls("ivf", shadow.index, None, shadow,
                                          calls["t1#shadow"])
    for name, _, backend, *_ in specs:
        engine = router.tenant(name).engine
        v = engine.index
        err[f"{name}_plain"] = _check_calls(
            backend, v, v.gn if backend == "exact" else None, engine,
            calls[name])
        engine.invalidate_cache()
        again = _record(engine)
        router.search(name, queries_np)
        del engine.search
        gn = v.gn if backend == "exact" else v.gn_full if \
            backend == "ivfpq" else torch.zeros(v.size, device=DEV) \
            .index_put_((v.ids_pad[v.ids_pad >= 0].long(),),
                        v.gn_pad[v.ids_pad >= 0])
        err[name], *other[name] = _agree(backend, v, engine, queries, gn,
                                         calls[name], again)
        assert other[name][2] <= FE_OTHER_MAX, \
            f"{name}: {other[name][2]} requests scanned other segments"
    v0 = router.tenant("t0").engine.index
    err["t0_plain"] = compare(L, queries, v0.gp, v0.gn, K_TOP,
                              torch.from_numpy(answers["t0"][0]).to(DEV),
                              torch.from_numpy(answers["t0"][1]).to(DEV))[0]
    # promote t1's shadow; a fresh build in a second router over the store
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    router.promote("t1")
    promote_s = time.perf_counter() - t0
    fresh = TenantRouter(store, k_top=K_TOP, copy=False)
    fresh.add_tenant("f", L_cand, backend="ivf", build_kwargs=specs[1][3])
    t0 = time.perf_counter()
    fresh.warm("f")
    torch.cuda.synchronize()
    fresh_s = time.perf_counter() - t0
    t1 = router.tenant("t1").engine
    promoted = _record(t1)
    d_live, i_live = router.search("t1", queries_np)
    del t1.search
    err["t1_promoted_plain"] = _check_calls("ivf", t1.index, None, t1,
                                            promoted)
    d_fresh, i_fresh = fresh.search("f", queries_np)
    assert np.array_equal(i_live, i_fresh) and \
        np.array_equal(d_live, d_fresh), \
        "promote is not bit-identical to a fresh build"
    del fresh
    # mutate the store; the next query rebuilds each view lazily
    gen_before = router.generation
    new_ids = router.extend(class_rows(gen, lab[TEN_ROWS:],
                                       serving["classes"]))
    hot = np.unique(answers["t0"][1][:, :2])[:TEN_REMOVE // 2]
    cold = np.setdiff1d(np.arange(TEN_ROWS), hot)[:TEN_REMOVE - len(hot)]
    gone = np.concatenate([hot, cold])
    assert router.remove(gone) == TEN_REMOVE
    assert router.generation == gen_before + 2
    rebuild_s, after = {}, {}
    for name, _, backend, *_ in specs:
        engine = router.tenant(name).engine
        rebuilt = _record(engine)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        after[name] = router.search(name, queries_np)
        torch.cuda.synchronize()
        rebuild_s[name] = time.perf_counter() - t0
        del engine.search
        assert router.tenant(name).built_generation == router.generation
        assert not np.isin(after[name][1], gone).any(), \
            f"{name}: a removed row was answered"
        if backend != "exact":      # exact: _check_live below
            err[f"{name}_rebuilt_plain"] = _check_calls(
                backend, engine.index, None, engine, rebuilt)
    for name in ("t0", "t3"):
        t = router.tenant(name)
        v = t.engine.index
        err[f"{name}_live"] = _check_live(v.L, queries, *after[name], v.gp,
                                          v.gn, t.ids)
    new_share = float(np.mean(np.isin(after["t0"][1], new_ids).any(1)))
    mem = router.memory()
    store_bytes = (TEN_ROWS + TEN_EXTEND) * d_in * 4
    assert mem["gallery"] == store_bytes + TEN_ROWS + TEN_EXTEND
    assert mem["total"] == mem["gallery"] + sum(mem["tenants"].values())
    independent = sum(mem["gallery"] + v for v in mem["tenants"].values())
    try:
        snap = _tenant_snapshot(store, specs, queries_np, card)
    finally:
        shutil.rmtree(SNAPSHOT_DIR, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    by_tenant = {}
    for name in names:
        ms = np.array(lat[name]) * 1e3
        p50, p99 = percentile(ms, (50.0, 99.0))
        by_tenant[name] = {"qps": qps[name], "p50_ms": p50, "p99_ms": p99,
                           "build_s": build_s[name],
                           "rebuild_s": rebuild_s[name]}
    out = {"rows": TEN_ROWS, "gen_s": gen_s, "qps": 4 * N_REQUESTS / wall,
           "by_tenant": by_tenant, "shadow_build_s": build_s["t1#shadow"],
           "shadow": arm, "promote_s": promote_s, "fresh_build_s": fresh_s,
           "launches": launches, "max_abs_err": err, "other": other,
           "memory_gb": {k: (v / 1e9 if isinstance(v, int) else
                             {n: b / 1e9 for n, b in v.items()})
                         for k, v in mem.items()},
           "independent_gb": independent / 1e9, "new_row_share": new_share,
           "snapshot": snap, "peak_gb": peak}
    log(f"tenants: {TEN_ROWS} x {d_in} raw rows on the card "
        f"({store.nbytes / 1e9:.2f} GB, generated in {gen_s:.1f} s, taken "
        f"without a copy); view build s "
        f"{ {n: round(s, 2) for n, s in build_s.items()} }; "
        f"{4 * N_REQUESTS} requests through router.submit in {wall:.3f} s "
        f"({out['qps']:.1f} qps); by tenant qps, p50 / p99 ms "
        f"{ {n: (round(b['qps'], 1), round(b['p50_ms'], 2),
                 round(b['p99_ms'], 2)) for n, b in by_tenant.items()} }, "
        f"launches {launches} [{card}]")
    log(f"tenants: answers = router.search (max |dd| "
        f"{ {k: float(f'{v:.3e}') for k, v in err.items()} }; requests "
        f"with ids resolved otherwise at a near-tie, with other ids, with "
        f"other segments or candidates, by tenant {other}); "
        f"shadow on t1 "
        f"mirrored {arm['n_mirrored']}, overlap@{K_TOP} "
        f"{arm['overlap_at_k']:.4f}, latency ratio "
        f"{arm['latency_ratio']:.3f}; promote {promote_s:.3f} s, bit-"
        f"identical to a fresh build ({fresh_s:.2f} s) [{card}]")
    log(f"tenants: +{TEN_EXTEND} rows / -{TEN_REMOVE} rows -> generation "
        f"{router.generation}; lazy rebuild s "
        f"{ {n: round(s, 2) for n, s in rebuild_s.items()} }; exact "
        f"tenants = the plain scan over the live rows; requests answered "
        f"with a new row (t0) {new_share:.3f}; memory GB: store "
        f"{mem['gallery'] / 1e9:.2f} once, views "
        f"{ {n: round(b / 1e9, 3) for n, b in mem['tenants'].items()} }, "
        f"total {mem['total'] / 1e9:.2f} against "
        f"{independent / 1e9:.2f} for independent stacks; peak "
        f"{peak:.2f} GB; phase {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    del router, store
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- the closed loop at dml-imnet1m width (phase 8e) -------------------------

# the main run: 8d's cut of the raw rows (1M would be 86 GB), a held-out
# set for the kNN hook (evaluated against the first LOOP_EVAL_ROWS
# training rows every LOOP_EVAL_EVERY steps), train_mined's refresh
# period; the cuts: a mutable IVF loop (rows, clusters, nprobe), a frozen
# exact loop, their steps / refresh period / anchors, and the anchors
# mined through a RequestScheduler. LOOP_SPREAD: N(0, 1.1^2) on every
# dimension makes the classes overlap, so that most anchors' 20 nearest
# rows under L0 hold another class (hard negatives to mine); the engine
# calls of each loop's last sweep held to the plain version
LOOP_ROWS, LOOP_HOLD, LOOP_BLOCK, LOOP_SPREAD = 262_144, 4_096, 16_384, 1.1
LOOP_CHECK_CALLS = 2
LOOP_STEPS, LOOP_REFRESH, LOOP_MINE = 60, 15, 16_384
LOOP_EVAL_EVERY, LOOP_EVAL_ROWS = 20, 65_536
LOOP_IVF = (65_536, 256, 16)
LOOP_FROZEN_ROWS = 32_768
LOOP_CUT_STEPS, LOOP_CUT_REFRESH, LOOP_CUT_MINE = 20, 10, 4_096
LOOP_FRONT = 2_048
LOOP_QUERY_BATCH = 512      # the miner's anchors a search (its default)


def _loop_cfg(exp, index, steps, refresh, mine, index_kwargs=None):
    """train_mined's miner and curriculum defaults (k 20, 1 negative, 3
    positives, warm-up 10, ramp 20, mined share up to 0.7) at
    dml-imnet1m width: P = 4 bsp, 1000 pairs a worker a step."""
    return ClosedLoopConfig(
        train=DMLTrainConfig(dml=exp.dml,
                             ps=sync.PSConfig(n_workers=N_WORKERS),
                             batch_size=exp.batch_size, steps=steps,
                             log_every=1),
        miner=MinerConfig(k_neighbors=20, max_negatives=1, max_positives=3),
        schedule=CurriculumSchedule(warmup_steps=10, ramp_steps=20,
                                    max_mined_frac=0.7),
        index=index, index_kwargs=index_kwargs, refresh_every=refresh,
        mine_queries=mine)


def _label_rule(pairs, labels):
    """Every mined pair obeys its label rule: no self-pair, negatives
    across classes, positives within one."""
    a, b, sim = pairs["a"], pairs["b"], pairs["sim"]
    assert len(a) and (a != b).all(), "a self-pair was mined"
    assert (labels[a[sim == 0]] != labels[b[sim == 0]]).all(), \
        "a mined negative shares its anchor's class"
    assert (labels[a[sim == 1]] == labels[b[sim == 1]]).all(), \
        "a mined positive crosses classes"


def _pair_rows(rows, pairs):
    """(xs, ys, sim) of index pairs over ``rows``, gathered on the card."""
    return tuple(rows[torch.from_numpy(pairs[k]).to(DEV)]
                 for k in ("a", "b")) + (
        torch.from_numpy(pairs["sim"]).to(DEV),)


def _by_anchor(pairs):
    out = {}
    for a, b, s in zip(pairs["a"].tolist(), pairs["b"].tolist(),
                       pairs["sim"].tolist()):
        out.setdefault(a, set()).add((b, s))
    return out


def _pools_differ_at_ties(L, rows, gp, gn, labels, pool, ref, k, margin):
    """Anchors whose mined pairs differ between two pools over the same
    L. Each may differ only where its plain distances tie (within
    compare()'s tolerance) at a gap the label filter reads: the edge of
    the (k + 1)-row neighbourhood (ranks k + 1 and k + 2), which alone
    decides the positives; or, where only the negatives differ, the two
    chosen negatives' distances, or a chosen negative at an edge of the
    semi-hard band (the farthest positive in the neighbourhood, that
    plus ``margin``). Returns how many anchors differ."""
    pa, pr = _by_anchor(pool), _by_anchor(ref)
    diff = sorted(a for a in set(pa) | set(pr) if pa.get(a) != pr.get(a))
    if not diff:
        return 0
    q = rows[torch.tensor(diff, device=DEV)]
    d, i = metric_topk_plain(L, q, gp, gn, k + 2)
    qp = q @ L.T
    qn = torch.sum(qp * qp, dim=1)
    edge = ((d[:, k + 1] - d[:, k]) <= ATOL + RTOL * (qn + torch.maximum(
        gn[i[:, k].long()], gn[i[:, k + 1].long()]))).tolist()
    d, i = d.cpu().numpy(), i.cpu().numpy()

    def split(pairs, sim):
        return {b for b, s in pairs if s == sim}

    away = []
    for r, a in enumerate(diff):
        if edge[r]:
            continue
        mine, plain = pa.get(a, set()), pr.get(a, set())
        if split(mine, 1) != split(plain, 1) or len(split(mine, 0)) != \
                len(split(plain, 0)):
            away.append(a)
            continue
        b = torch.tensor(sorted(split(mine, 0) ^ split(plain, 0)),
                         device=DEV)
        dn = (qn[r] + gn[b] - 2 * gp[b] @ qp[r]).tolist()
        tol = ATOL + RTOL * (float(qn[r]) + float(gn[b].max()))
        nb = i[r, :k + 1]
        same = (labels[nb] == labels[a]) & (nb != a)
        edges = ([float(d[r, :k + 1][same].max())] if same.any() else [])
        edges += [e + margin for e in edges]
        if not any(abs(x - y) <= tol
                   for j, x in enumerate(dn)
                   for y in dn[:j] + dn[j + 1:] + edges):
            away.append(a)
    assert not away, \
        f"{len(away)} anchors mined otherwise away from a tie: {away[:8]}"
    return len(diff)


class _PlainExact:
    """An exact index whose scan is metric_topk's plain version on the
    card: the yardstick the loop's mining sweep is held to."""

    def __init__(self, L, gp, gn):
        self.L, self.gp, self.gn, self.version = L, gp, gn, 0

    size = property(lambda self: self.gp.shape[0])
    n_shards = 1

    def topk(self, queries, k_top):
        return metric_topk_plain(self.L, queries, self.gp, self.gn, k_top)


def _promoted_is_fresh(router, store, name):
    """The tenant's live view, promoted through its shadow arm, against a
    fresh build under the same L in a second router over the same store:
    bit for bit."""
    t = router.tenant(name)
    fresh = TenantRouter(store, k_top=K_TOP, copy=False, device=DEV)
    fresh.add_tenant("f", t.L)
    f = fresh.warm("f")
    v, w = t.engine.index, f.engine.index
    return (torch.equal(v.gp, w.gp) and torch.equal(v.gn, w.gn)
            and torch.equal(v.L, w.L) and np.array_equal(t.ids, f.ids))


def _record_sweeps(clt):
    """Record the first LOOP_CHECK_CALLS engine calls of every refresh's
    sweep, keeping the last sweep's. Returns (that list, the loop's own
    refresh, to put back)."""
    calls, refresh = [], clt.refresh

    def recorded(L, step, swap=True):
        got = _record(clt.engine, LOOP_CHECK_CALLS)
        try:
            return refresh(L, step, swap=swap)
        finally:
            del clt.engine.search
            calls[:] = got

    clt.refresh = recorded
    return calls, refresh


def _check_sweep(clt, calls):
    """The recorded calls of the loop's last sweep against the plain
    version of its scan (metric_topk or ivf_scan) at the sweep's k,
    under the L the sweep ran with. Returns max |dd|."""
    index = clt.engine.index
    base = getattr(index, "base", index)        # a mutable wraps its base
    if base is not index:
        assert np.array_equal(index.base_ids, np.arange(base.size)), \
            "the mutable's ids are not its base's rows"
    kind = "ivf" if isinstance(base, IVFIndex) else "exact"
    return _check_calls(kind, base, getattr(base, "gn", None), clt.engine,
                        calls, clt.cfg.miner.k_neighbors + 1)


def _run_cut(exp, name, rows, labels, L0, index_kwargs, kname, kern):
    """One cut loop (no router): its steps, one refresh every
    LOOP_CUT_REFRESH, LOOP_CUT_MINE anchors, its scan kernel ``kern``
    (named ``kname``) counted; returns its summary."""
    cfg = _loop_cfg(exp, name, LOOP_CUT_STEPS, LOOP_CUT_REFRESH,
                    LOOP_CUT_MINE, index_kwargs)
    t0 = time.perf_counter()
    clt = ClosedLoopTrainer(cfg, rows, labels, L0=L0,
                            opt=sgd(schedules.inverse_time(1e-3, 1e-3)),
                            device=DEV)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    index0 = clt.engine.index
    v0 = index0.version
    calls, refresh = _record_sweeps(clt)
    _reset_counts()
    t0 = time.perf_counter()
    _, hist = clt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dml_pair": dml_pair_fused.launches, kname: kern.launches}
    clt.refresh = refresh
    losses = [h["loss"] for h in hist["steps"]]
    assert np.isfinite(losses).all(), f"{name}: a loss is not finite"
    assert all(v > 0 for v in launches.values()), \
        f"{name}: a kernel never ran: {launches}"
    assert launches["dml_pair"] == N_WORKERS * LOOP_CUT_STEPS
    n_swaps = clt.n_refreshes - 1
    if name.startswith("mutable"):
        assert clt.engine.index is index0
        assert clt.engine.index.version == v0 + n_swaps
    else:                               # a frozen base is rebuilt
        assert clt.engine.index is not index0
        assert sum("rebuild" in t for t in clt.timings) == n_swaps
    _label_rule(clt.source._pool, labels)
    err = _check_sweep(clt, calls)
    return {"rows": rows.shape[0], "build_s": build_s, "wall_s": wall,
            "launches": launches, "refreshes": clt.n_refreshes,
            "timings": clt.timings, "loss": [losses[0], losses[-1]],
            "pairs": [r["n_pairs"] for r in hist["refreshes"]],
            "neg_yield": [r["neg_yield"] for r in hist["refreshes"]],
            "plain_max_abs_err": err}


def _convergence_finding():
    """benchmarks/mining_convergence.py's recipe (its --smoke rows) on the
    port, at its own widths: N 8000, D 64, rank 16, 128 classes. Prints
    whether each of its pinned claims holds on the card; checks
    nothing."""
    n, d, kproj, c, lr, batch, steps = 8000, 64, 16, 128, 3e-3, 128, 300
    t_start = time.perf_counter()
    x, y = pairdata.make_features(pairdata.PairDatasetConfig(
        n_samples=n, feat_dim=d, n_classes=c, kind="noisy_subspace",
        noise=0.3, seed=0))
    n_tr = int(n * 0.8)
    ev = [torch.from_numpy(a).to(DEV)
          for a in (x[:n_tr], y[:n_tr], x[n_tr:], y[n_tr:])]

    def hook(t, L):
        return knn_accuracy(L, *ev, k=5, device=DEV)

    tcfg = DMLTrainConfig(dml=dml.DMLConfig(feat_dim=d, l_rank=kproj),
                          ps=sync.PSConfig(n_workers=1, seed=0),
                          batch_size=batch, steps=steps, lr=lr,
                          log_every=10)
    idx = pairdata.sample_pair_indices(y[:n_tr], 20000, 20000, seed=1)
    uni = {"xs": x[idx["a"]], "ys": x[idx["b"]], "sim": idx["sim"]}
    _, hist_u = train_dml_distributed(tcfg, uni, step_hook=hook,
                                      device=DEV)
    target = float(np.mean([h["hook"] for h in hist_u[-5:]]))

    def mined(dml_cfg):
        cfg = ClosedLoopConfig(
            train=DMLTrainConfig(dml=dml_cfg, ps=tcfg.ps, batch_size=batch,
                                 steps=steps // 2, lr=lr, log_every=10),
            miner=MinerConfig(k_neighbors=20, max_negatives=1,
                              max_positives=3),
            schedule=CurriculumSchedule(warmup_steps=10, ramp_steps=20,
                                        max_mined_frac=0.7),
            refresh_every=15, mine_queries=n_tr)
        _, hist = ClosedLoopTrainer(cfg, ev[0], y[:n_tr],
                                    device=DEV).run(step_hook=hook)
        return [(h["step"], h["hook"]) for h in hist["steps"]]

    accs = mined(tcfg.dml)
    cross = next((s for s, a in accs if a >= target), None)
    final = float(np.mean([a for _, a in accs[-5:]]))
    square = float(np.mean([a for _, a in mined(
        dml.DMLConfig(feat_dim=d, l_rank=d))[-5:]]))
    claims = {
        "uniform final >= 0.95": target >= 0.95,
        "mined crosses the uniform final within half the steps":
            cross is not None and cross <= steps // 2,
        "mined final >= uniform final - 0.005": final >= target - 0.005,
        "rank 16 final within 0.02 of square-L": final >= square - 0.02}
    out = {"uniform_final": target, "mined_cross_step": cross,
           "mined_final": final, "square_final": square,
           "claims": claims, "s": time.perf_counter() - t_start}
    log(f"closed loop, mining_convergence recipe (N {n}, D {d}, rank "
        f"{kproj}, {c} classes; a finding, not a check): uniform final "
        f"{target:.4f} over {steps} steps, mined crosses it at step "
        f"{cross} of {steps // 2}, mined final {final:.4f}, square-L "
        f"final {square:.4f}; claims held: "
        f"{ {k: bool(v) for k, v in claims.items()} } ({out['s']:.1f} s)")
    return out


def phase_closed_loop(classes, bsp_ms, card, exp=IMNET_1M):
    """Phase 8e: the closed loop at dml-imnet1m width over LOOP_ROWS raw
    rows on the card, its tenant promoted through the shadow arm at
    every refresh; then the IVF and frozen cuts, mining through a
    scheduler, and the mining_convergence recipe."""
    t_phase = time.perf_counter()
    cfg = exp.dml
    d_in = cfg.feat_dim
    gen = torch.Generator(device=DEV).manual_seed(8)
    lab = torch.randint(0, exp.n_classes, (LOOP_ROWS + LOOP_HOLD,),
                        generator=gen, device=DEV)
    t0 = time.perf_counter()
    store = torch.empty((LOOP_ROWS, d_in), device=DEV)
    for s in range(0, LOOP_ROWS, LOOP_BLOCK):
        store[s:s + LOOP_BLOCK] = class_rows(gen, lab[s:s + LOOP_BLOCK],
                                             classes, spread=LOOP_SPREAD)
    hold = class_rows(gen, lab[LOOP_ROWS:], classes, spread=LOOP_SPREAD)
    labels = lab[:LOOP_ROWS].cpu().numpy()
    hold_y, ev_y = lab[LOOP_ROWS:], lab[:LOOP_EVAL_ROWS]
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0

    # the example's scale-aware init (initial ||Lz||^2 ~ 2 * margin) on
    # a fixed uniform pair set, on which the objective is also read
    L0 = init_params(cfg, gen, DEV)
    uniform = pairdata.sample_pair_indices(labels, 2000, 2000, seed=11)
    d2 = float(torch.mean(dml.mahalanobis_sqdist(
        L0, *_pair_rows(store, uniform)[:2])))
    L0 = L0 * float(np.sqrt(2.0 * cfg.margin / max(d2, 1e-9)))

    def objective(L, pairs):
        return float(dml.objective(L, *_pair_rows(store, pairs), cfg.lam,
                                   cfg.margin))

    router = TenantRouter(store, k_top=K_TOP, copy=False, device=DEV)
    router.add_tenant("loop", L0)
    router.warm("loop")
    ccfg = _loop_cfg(exp, "mutable-exact", LOOP_STEPS, LOOP_REFRESH,
                     LOOP_MINE)
    t0 = time.perf_counter()
    clt = ClosedLoopTrainer(ccfg, store, labels, L0=L0,
                            opt=sgd(schedules.inverse_time(1e-3, 1e-3)),
                            router=router, tenant="loop", device=DEV)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert clt.features.data_ptr() == store.data_ptr() == \
        clt.source.features.data_ptr(), "the feature table was copied"
    index = clt.engine.index
    v0 = index.version

    # each refresh: its pool kept, the metric_topk launches of its sweep
    # and probes, its wall time, and the promoted view held to a fresh
    # build (outside the refresh's own timings)
    pools, sweep_launches, refresh_s, fresh_views = [], [], {}, []
    sweep_calls, _ = _record_sweeps(clt)
    refresh = clt.refresh

    def counted_refresh(L, step, swap=True):
        n0, t_r = metric_topk_fused.launches, time.perf_counter()
        rec = refresh(L, step, swap=swap)
        torch.cuda.synchronize()
        refresh_s[step] = time.perf_counter() - t_r
        sweep_launches.append(metric_topk_fused.launches - n0)
        pools.append(clt.source._pool)
        if swap:
            fresh_views.append(_promoted_is_fresh(router, store, "loop"))
        return rec

    clt.refresh = counted_refresh
    enter, leave, accs = {}, {}, {}

    def hook(t, L):
        enter[t] = time.perf_counter()
        if t % LOOP_EVAL_EVERY == 0 or t == LOOP_STEPS - 1:
            accs[t] = knn_accuracy(L, store[:LOOP_EVAL_ROWS], ev_y, hold,
                                   hold_y, k=KNN_K, device=DEV)
        leave[t] = time.perf_counter()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                         # counts of the main path only
    t0 = time.perf_counter()
    L, hist = clt.run(step_hook=hook)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"dml_pair": dml_pair_fused.launches,
                "metric_topk": metric_topk_fused.launches,
                "pairwise_sqdist": pairwise_sqdist.launches,
                "ivf_scan": ivf_scan_topk_fused.launches,
                "pq_adc": pq_adc_topk_fused.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9

    # -- the checks on the main run
    recs = hist["refreshes"]
    n_ref = len(recs)
    assert n_ref == 1 + (LOOP_STEPS - 1) // LOOP_REFRESH
    assert launches["dml_pair"] == N_WORKERS * LOOP_STEPS, \
        f"dml_pair launched {launches['dml_pair']} times in {LOOP_STEPS} " \
        f"steps at P = {N_WORKERS}"
    per_sweep = -(-LOOP_MINE // LOOP_QUERY_BATCH)
    assert all(n >= per_sweep for n in sweep_launches), \
        f"a mining sweep launched metric_topk {sweep_launches} times"
    assert launches["pairwise_sqdist"] >= len(accs)
    assert launches["ivf_scan"] == launches["pq_adc"] == 0
    assert [r["index_version"] for r in recs] == list(range(v0, v0 + n_ref))
    assert clt.engine.index is index and index.n_swaps == n_ref - 1
    assert clt.engine.stats()["n_device_queries"] == n_ref * LOOP_MINE
    assert all(r["n_queries"] == LOOP_MINE and r["n_dropped"] == 0
               for r in recs)
    for pool in pools:
        _label_rule(pool, labels)
    assert len(fresh_views) == n_ref - 1 and all(fresh_views), \
        "a promoted view differs from a fresh build"
    assert router.tenant("loop").shadow is None
    assert np.array_equal(router.tenant("loop").L, index.L.cpu().numpy())
    # the loss on the loop's batches follows their mined share; the
    # objective on the last pool's constraints (the pairs the loop
    # trains on) must fall from L0 to the final L
    losses = [h["loss"] for h in hist["steps"]]
    assert np.isfinite(losses).all(), "a loss is not finite"
    mined = {k: v[:4000] for k, v in pools[-1].items()}
    obj = {"mined": [objective(L0, mined), objective(L, mined)],
           "uniform": [objective(L0, uniform), objective(L, uniform)]}
    assert obj["mined"][1] < obj["mined"][0], \
        f"the objective on the mined pool rose: {obj['mined']}"
    # step time: hook to hook, leaving out the steps after a refresh
    gaps = [enter[t] - leave[t - 1] for t in range(1, LOOP_STEPS)
            if t not in refresh_s]
    step_ms = 1e3 * float(np.mean(gaps))
    step_ms_median = 1e3 * float(np.median(gaps))
    pairs_s = N_WORKERS * exp.batch_size / step_ms * 1e3
    # the stream's host draws alone (P batches of indices a step): all
    # uniform (before the warm-up ends), then at the full mined share
    draw_ms = {}
    for first in (0, LOOP_STEPS - LOOP_REFRESH):
        rng = np.random.RandomState(0)
        t0 = time.perf_counter()
        for step in range(first, first + 10):
            for w in range(N_WORKERS):
                clt.source._draw(rng, w, N_WORKERS, exp.batch_size, step)
        draw_ms[round(clt.cfg.schedule.mined_frac(first), 2)] = \
            1e3 * (time.perf_counter() - t0) / 10

    # -- the last sweep's first engine calls, and the kNN hook's distance
    # matrix under the final L, against their plain versions
    sweep_err = _check_sweep(clt, sweep_calls)
    xp, yp = hold @ L.T, store[:LOOP_EVAL_ROWS] @ L.T
    hook_err, _ = compare_dist(pairwise_sqdist(xp, yp), xp, yp)
    del xp, yp

    # -- the last sweep against the plain version on the card, same L
    last = recs[-1]
    plain_engine = RetrievalEngine(_PlainExact(index.L, index.base.gp,
                                               index.base.gn),
                                   k_top=ccfg.miner.k_neighbors + 1)
    t0 = time.perf_counter()
    plain = HardPairMiner(plain_engine, store, labels, ccfg.miner,
                          warmup=False).mine(
        n_queries=LOOP_MINE, seed=ccfg.train.ps.seed + n_ref - 1)
    plain_s = time.perf_counter() - t0
    n_tie = _pools_differ_at_ties(index.L, store, index.base.gp,
                                  index.base.gn, labels, pools[-1],
                                  plain.pairs, ccfg.miner.k_neighbors,
                                  ccfg.miner.margin)
    # the same sweep through an engine without the hot-query LRU (no
    # host copies of the anchors' rows, no keys)
    t0 = time.perf_counter()
    HardPairMiner(RetrievalEngine(index, k_top=ccfg.miner.k_neighbors + 1,
                                  cache_size=0), store, labels, ccfg.miner,
                  warmup=False).mine(n_queries=LOOP_MINE,
                                     seed=ccfg.train.ps.seed + n_ref - 1)
    no_lru_s = time.perf_counter() - t0
    for key in ("n_pairs", "n_hard_neg", "n_hard_pos"):
        if n_tie == 0:
            assert plain.stats[key] == last[key], key

    # -- LOOP_FRONT anchors through a RequestScheduler = the direct path
    anchors = pairdata.distinct_draws(np.random.RandomState(5), LOOP_ROWS,
                                      LOOP_FRONT)
    direct = HardPairMiner(clt.engine, store, labels, ccfg.miner,
                           warmup=False).mine(query_ids=anchors)
    sched = RequestScheduler(clt.engine, degrade=False)
    t0 = time.perf_counter()
    try:
        routed = HardPairMiner(clt.engine, store, labels, ccfg.miner,
                               warmup=False, frontend=sched).mine(
            query_ids=anchors)
        front_s = time.perf_counter() - t0
        mining = sched.observability()["classes"]["mining"]
    finally:
        closed = sched.close()
    assert closed, "scheduler workers did not stop"
    assert routed.stats["n_dropped"] == 0 and \
        mining["completed"] == LOOP_FRONT
    n_front_tie = _pools_differ_at_ties(index.L, store, index.base.gp,
                                        index.base.gn, labels, routed.pairs,
                                        direct.pairs, ccfg.miner.k_neighbors,
                                        ccfg.miner.margin)
    main = {
        "rows": LOOP_ROWS, "gen_s": gen_s, "build_s": build_s,
        "run_s": run_s, "launches": launches,
        "sweep_launches": sweep_launches, "step_ms": step_ms,
        "step_ms_median": step_ms_median, "pairs_s": pairs_s,
        "draw_ms": draw_ms, "mine_no_lru_s": no_lru_s,
        "bsp_step_ms_phase4": bsp_ms,
        "refresh_s": refresh_s, "timings": clt.timings,
        "records": [{k: r[k] for k in ("step", "n_pairs", "n_hard_neg",
                                       "n_semi_hard", "n_fallback_neg",
                                       "n_hard_pos", "n_starved",
                                       "neg_yield", "pos_yield",
                                       "mine_busy_s", "engine_qps",
                                       "index_version")}
                    for r in recs],
        "shadow": [r.get("shadow") for r in recs],
        "knn": accs, "loss": [losses[0], losses[-1]],
        "objective": obj, "plain_s": plain_s,
        "sweep_plain_max_abs_err": sweep_err, "hook_max_abs_err": hook_err,
        "plain_tie_anchors": n_tie, "front_s": front_s,
        "front_tie_anchors": n_front_tie, "peak_gb": peak}
    for i, (r, t) in enumerate(zip(recs, clt.timings)):
        split = {k: round(v, 3) for k, v in t.items()}
        log(f"closed loop refresh {i} (step {r['step']}): seconds "
            f"{split}, whole refresh {refresh_s[r['step']]:.3f}; mined "
            f"{r['n_pairs']} pairs from {LOOP_MINE} anchors (neg yield "
            f"{r['neg_yield']:.3f}, pos yield {r['pos_yield']:.3f}, "
            f"{r['n_semi_hard']} semi-hard, {r['n_fallback_neg']} "
            f"fallback, {r['n_starved']} starved), "
            f"{LOOP_MINE / t['mine']:.0f} anchors/s on the host clock, "
            f"engine busy {r['mine_busy_s']:.3f} s, "
            f"{r['engine_qps']:.0f} qps on its device time; "
            f"metric_topk launches {sweep_launches[i]} [{card}]")
    del clt, plain_engine, direct, routed, router, index
    gc.collect()
    torch.cuda.empty_cache()
    log(f"closed loop: {LOOP_ROWS} x {d_in} rows on the card "
        f"({store.nbytes / 1e9:.2f} GB, made in {gen_s:.1f} s, shared by "
        f"the miner, the stream and the tenant router without a copy; "
        f"mutable index built in {build_s:.1f} s, raw rows copied to the "
        f"host); {LOOP_STEPS} steps P = {N_WORKERS} bsp in {run_s:.1f} s "
        f"with {n_ref} refreshes; {step_ms:.2f} ms a step (median "
        f"{step_ms_median:.2f}; phase 4's bsp {bsp_ms:.2f}), "
        f"{pairs_s:.0f} pairs/s, the stream's host draws alone "
        f"{ {f: round(ms, 2) for f, ms in draw_ms.items()} } ms a step by "
        f"mined share; loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"objective L0 -> L on 4000 pairs of the last pool "
        f"{obj['mined'][0]:.5f} -> {obj['mined'][1]:.5f}, on 4000 fixed "
        f"uniform pairs {obj['uniform'][0]:.5f} -> "
        f"{obj['uniform'][1]:.5f}; "
        f"kNN@{KNN_K} on {LOOP_HOLD} held-out rows "
        f"{ {t: round(a, 4) for t, a in accs.items()} }; launches "
        f"{launches}; every promoted view = a fresh build; the last "
        f"sweep's first {len(sweep_calls)} calls (Nq {LOOP_QUERY_BATCH}, "
        f"k {ccfg.miner.k_neighbors + 1}) vs metric_topk's plain version "
        f"max |dd| {sweep_err:.3e}; the hook's {LOOP_HOLD} x "
        f"{LOOP_EVAL_ROWS} pairwise_sqdist vs plain max |dD| "
        f"{hook_err:.3e}; last sweep = "
        f"the plain version's ({plain_s:.1f} s) but {n_tie} anchors at "
        f"a near-tie; the same sweep without the engine's LRU "
        f"{no_lru_s:.2f} s; {LOOP_FRONT} anchors through a "
        f"RequestScheduler in "
        f"{front_s:.2f} s = the direct path but {n_front_tie} at a "
        f"near-tie; peak {peak:.2f} GB [{card}]")

    # -- the cuts: a mutable IVF loop, a frozen exact loop
    rows, clusters, nprobe = LOOP_IVF
    cuts = {"mutable-ivf": _run_cut(
                exp, "mutable-ivf", store[:rows], labels[:rows], L0,
                dict(n_clusters=clusters, nprobe=nprobe), "ivf_scan",
                ivf_scan_topk_fused),
            "exact": _run_cut(exp, "exact", store[:LOOP_FROZEN_ROWS],
                              labels[:LOOP_FROZEN_ROWS], L0, None,
                              "metric_topk", metric_topk_fused)}
    for name, cut in cuts.items():
        split = [{k: round(v, 3) for k, v in t.items()}
                 for t in cut["timings"]]
        log(f"closed loop cut {name}: {cut['rows']} rows, built in "
            f"{cut['build_s']:.1f} s, {LOOP_CUT_STEPS} steps in "
            f"{cut['wall_s']:.1f} s, {cut['refreshes']} refreshes "
            f"(seconds {split}), pairs {cut['pairs']}, neg yield "
            f"{[round(y, 3) for y in cut['neg_yield']]}, loss "
            f"{cut['loss'][0]:.4f} -> {cut['loss'][1]:.4f}, launches "
            f"{cut['launches']}; the last sweep's first calls vs the "
            f"plain version max |dd| {cut['plain_max_abs_err']:.3e} "
            f"[{card}]")
    del store, hold
    gc.collect()
    torch.cuda.empty_cache()
    finding = _convergence_finding()
    log(f"closed loop phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"main": main, "cuts": cuts, "convergence": finding,
            "launches": {**{k: v for k, v in launches.items() if v},
                         "ivf_scan": cuts["mutable-ivf"]["launches"][
                             "ivf_scan"]}}


def library_pair(L, xs, ys, sim, lam, margin):
    """PyTorch calls for the Eq. 4 forward (yardstick only)."""
    proj = torch.matmul(xs - ys, L.T)
    d2 = torch.sum(proj * proj, 1)
    simf = sim.to(torch.float32)
    return simf * d2 + (1 - simf) * lam * torch.clamp_min(margin - d2, 0.0)


def library_pairwise(xp, yp):
    """PyTorch calls for the all-pairs distances (yardstick only)."""
    xn, yn = torch.sum(xp * xp, 1), torch.sum(yp * yp, 1)
    return (xn[:, None] + yn[None, :]
            - 2.0 * torch.matmul(xp, yp.T)).clamp_min_(0.0)


def _backward(loss_fn, L, xs, ys, sim, lam, margin):
    _grads(loss_fn, L, xs, ys, sim, lam, margin, wrt=1)


def time_dml_pair(L, batch, launches, launches_per_step, max_err,
                  cfg=IMNET_1M.dml):
    xs, ys, sim = batch["xs"], batch["ys"], batch["sim"]
    (B, d), k = xs.shape, L.shape[0]
    args = (L, xs, ys, sim, cfg.lam, cfg.margin)
    fwd = lambda: dml_pair_fused(*args[:4], lam=cfg.lam,  # noqa: E731
                                 margin=cfg.margin)
    ms = _time(fwd, 10)
    plain_ms = _time(lambda: dml_pair_ref(*args), 10)
    lib_ms = _time(lambda: library_pair(*args), 10)
    fb_ms = _time(lambda: _backward(dml_pair_loss_fused, *args), 5)
    plain_fb_ms = _time(lambda: _backward(dml_pair_loss_reference, *args), 5)
    ops, nbytes = 2.0 * B * d * k, 4.0 * (2 * B * d + k * d + 3 * B + B * k)
    b_ms, b_by = roofline(ops, nbytes)
    ffma_ms = ffma_bound(ops, nbytes)
    parts = device_breakdown(fwd)
    log(f"dml_pair B={B} d={d} k={k}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, library {lib_ms:.3f} ms, bound {b_ms:.3f} ms "
        f"({b_by}; f32 FFMA {ffma_ms:.3f}), {b_ms / ms:.1%} of bound; "
        f"forward+backward(L) kernel "
        f"path {fb_ms:.3f} ms, plain {plain_fb_ms:.3f} ms; device ms by "
        f"kernel {parts if parts else 'not measured'}")
    return {"name": "dml_pair", "route": "cuda",
            "source": "src/repro_torch/kernels/dml_pair/csrc/dml_pair.cu",
            "replaces": "src/repro/kernels/dml_pair/kernel.py:79",
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms,
            "breakdown_ms": parts, "fwd_bwd_ms": fb_ms, "plain_fwd_bwd_ms": plain_fb_ms,
            "launches_per_step": launches_per_step,
            "shape": {"B": B, "d_in": d, "d_out": k}}


def time_pairwise(xp, yp, launches, max_err):
    (n, k), m = xp.shape, yp.shape[0]
    ms = _time(lambda: pairwise_sqdist(xp, yp), 10)
    plain_ms = _time(lambda: pairwise_sqdist_ref(xp, yp), 10)
    lib_ms = _time(lambda: library_pairwise(xp, yp), 10)
    ops, nbytes = 2.0 * n * m * k, 4.0 * (n * k + m * k + n * m)
    b_ms, b_by = roofline(ops, nbytes)
    ffma_ms = ffma_bound(ops, nbytes)
    parts = device_breakdown(lambda: pairwise_sqdist(xp, yp))
    log(f"pairwise_sqdist N={n} M={m} k={k}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, library {lib_ms:.3f} ms, bound {b_ms:.3f} ms "
        f"({b_by}; f32 FFMA {ffma_ms:.3f}), {b_ms / ms:.1%} of bound; "
        f"device ms by kernel "
        f"{parts if parts else 'not measured'}")
    return {"name": "pairwise_sqdist", "route": "cuda",
            "source": "src/repro_torch/kernels/pairwise_dist/csrc/"
                      "pairwise_dist.cu",
            "replaces": "src/repro/kernels/pairwise_dist/kernel.py:52",
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms,
            "breakdown_ms": parts, "shape": {"N": n, "M": m, "k": k}}


# -- the zamba2-2.7b backbone: ssd_scan and flash_attention -------------------

BACKBONE = "zamba2-2.7b"
SEQ = 8192                  # tokens a sequence: the 4096 window bites
EMB_BATCH, CORPUS_SEQS, REQUEST_BATCHES, EMB_K, EMB_PROJ = 4, 16, 4, 5, 64
PEAK_BF16_FLOPS = card_figures.PEAK_FLOPS_BF16  # dense bf16, tensor cores
# kernel against plain, f32 on both sides (only the summation order
# differs): flash rtol 1e-4 / atol 2e-5, the reference's bound for its
# kernel against its oracle (SSD_TOL: kernels/ssd_chunk/cases.py). bf16
# inputs against the plain version computed in f32 from the same bf16
# values: the kernel computes in f32 and rounds its output to bf16 once
# (at most BF16_ROUND = 2^-8 of |out|, round to nearest), and also rounds
# each probability to bf16 before p v while l sums the f32 ones, which
# moves out by at most 2^-8 sum_s p_s |v_s| / l = 2^-8 attention(q, k,
# |v|): its bound is the f32 one + 2^-8 (|ref| + attention(q, k, |v|)),
# elementwise.
FA_TOL = dict(rtol=1e-4, atol=2e-5)
# the full-depth f32 forward at B 1, kernel path against the plain path (the
# SSD runs in chunks of 64 against the plain form's 128, attention streams
# instead of chunking): the final hidden state and embed_pool, each as
# max |a - b| / max |b|, within 13 and 30 times the first card readings
# (7.6e-6 and 3.3e-7; NVIDIA H100 80GB HBM3, 700 W)
HIDDEN_REL_BOUND = 1e-4
EMBED_REL_BOUND = 1e-5
# the SSD bound's FLOP count takes the chunk length of the TPU kernel's
# chunked algorithm at Q = 64, fixed here so that a change of the kernel's
# own chunk does not move the yardstick
SSD_BOUND_CHUNK = 64
PEAK_2XTF32_FLOPS = PEAK_TF32_FLOPS / 2     # two TF32 passes, for comparison


def within(out, ref, allowed, what):
    """Asserts |out - ref| <= allowed elementwise; returns (max |d|,
    max |ref|, max |d| / allowed)."""
    d = (out.float() - ref).abs()
    worst = float((d / allowed).max())
    assert worst <= 1.0, f"{what}: |d| reaches {worst:.3g} x its bound"
    return float(d.max()), float(ref.abs().max()), worst


def check_flash(q, k, v, causal, window, q_offset=0):
    """flash_attention against attention_ref in f32 on the same values;
    returns (max |out - ref|, max |ref|, worst |d| / bound)."""
    out = flash_attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset)
    qf, kf, vf = q.float(), k.float(), v.float()
    ref = attention_ref(qf, kf, vf, causal=causal, window=window,
                        q_offset=q_offset)
    allowed = FA_TOL["atol"] + FA_TOL["rtol"] * ref.abs()
    if q.dtype == torch.bfloat16:
        allowed += BF16_ROUND * (ref.abs() + attention_ref(
            qf, kf, vf.abs(), causal=causal, window=window,
            q_offset=q_offset))
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    return within(out, ref, allowed, "flash_attention")


def check_ssd(xs, Bm, Cm, dt, la):
    """ssd_core (the kernel) against ssd_scan_chunked in f32 on the same
    values, model layout; returns (max |dy|, max |y|, worst |dy| / bound,
    max |dh|)."""
    y, h = ssd_core(xs, Bm, Cm, dt, la)
    yr, hr = ssd_scan_chunked(xs.float().transpose(1, 2),
                              Bm.float()[:, None], Cm.float()[:, None],
                              dt.transpose(1, 2), la.transpose(1, 2))
    yr = yr.transpose(1, 2)
    torch.cuda.synchronize()
    assert y.dtype == xs.dtype and y.shape == xs.shape and y.is_contiguous()
    tol = SSD_TOL[xs.dtype]
    ey = within(y, yr, tol["atol"] + tol["rtol"] * yr.abs(), "ssd_scan y")
    torch.testing.assert_close(h, hr, **SSD_TOL[torch.float32])
    return (*ey, float((h - hr).abs().max()))


def check_ssd_panes(args, chunks_per_segment=None):
    """ssd_scan on pane-layout inputs (any views) under an explicit plan
    against ssd_scan_chunked in float64 (ssd_cases.reference); returns (y,
    max |dy|, worst |dy| / bound, max |dh|)."""
    xs = args[0]
    y, h = ssd_scan(*args, chunks_per_segment=chunks_per_segment)
    yr, hr = ssd_cases.reference(*args)
    torch.cuda.synchronize()
    assert y.dtype == xs.dtype and y.shape == xs.shape
    tol = SSD_TOL[xs.dtype]
    ey = within(y, yr, tol["atol"] + tol["rtol"] * yr.abs(), "ssd_scan y")
    torch.testing.assert_close(h, hr.float(), **SSD_TOL[torch.float32])
    return y, ey[0], ey[2], float((h - hr).abs().max())


def parity_ssd(dtype):
    """Every SSD case of kernels/ssd_chunk/cases.py in ``dtype``."""
    name = str(dtype)[6:]
    for B, H, T, p, n in ssd_cases.PARITY:
        xs, Bm, Cm, dt, la = ssd_cases.inputs(B, H, T, p, n, dtype, DEV,
                                              seed=B + H + T)
        ey, top, worst, eh = check_ssd(xs, Bm, Cm, dt, la)
        log(f"parity ssd_scan {name} (B, H, T, p, n) {(B, H, T, p, n)} "
            f"plan {segment_plan(B, H, T)[0]} chunks a segment: max |dy| "
            f"{ey:.3e} (max |y| {top:.3f}), {worst:.3f} of the bound; max "
            f"|dh| {eh:.3e}")
    for B, H, T, p, n, cps in ssd_cases.PLANNED:
        args = ssd_cases.panes(*ssd_cases.inputs(B, H, T, p, n, dtype, DEV,
                                                 seed=T + cps,
                                                 decay=ssd_cases.SLOW))
        _, ey, worst, eh = check_ssd_panes(args, cps)
        log(f"parity ssd_scan {name} (B, H, T, p, n) {(B, H, T, p, n)} "
            f"{cps} chunks a segment: max |dy| {ey:.3e}, {worst:.3f} of the "
            f"bound; max |dh| {eh:.3e}")
    B, H, T, p, n, plans = ssd_cases.TWO_PLANS
    args = ssd_cases.panes(*ssd_cases.inputs(B, H, T, p, n, dtype, DEV,
                                             seed=3, decay=ssd_cases.SLOW))
    y1, *_ = check_ssd_panes(args, plans[0])
    y2, *_ = check_ssd_panes(args, plans[1])
    # the two outputs round to bf16 once each: one bf16 step apart at most
    tol = SSD_TOL[torch.float32]
    rtol = tol["rtol"] + (2 * BF16_ROUND if dtype == torch.bfloat16 else 0)
    e12 = within(y1, y2.float(), tol["atol"] + rtol * y2.float().abs(),
                 "ssd_scan under two plans")
    log(f"parity ssd_scan {name} {(B, H, T, p, n)} under {plans[0]} and "
        f"{plans[1]} chunks a segment: max |y1 - y2| {e12[0]:.3e}, "
        f"{e12[2]:.3f} of the bound")
    B, H, T, p, n, grow_cps = ssd_cases.GROWING
    growing = ssd_cases.panes(*ssd_cases.inputs(B, H, T, p, n, dtype, DEV,
                                                seed=11,
                                                decay=ssd_cases.GROW))
    for what, args, cps in (
            ("views TMA cannot describe", ssd_cases.strided(dtype, DEV), None),
            ("B and C per head", ssd_cases.per_head(dtype, DEV), 2),
            ("la > 0", growing, grow_cps)):
        _, ey, worst, eh = check_ssd_panes(args, cps)
        log(f"parity ssd_scan {name} {what} {tuple(args[0].shape)}: max "
            f"|dy| {ey:.3e}, {worst:.3f} of the bound; max |dh| {eh:.3e}")


def phase_parity_backbone():
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, S, H, K, dh, causal, window, off in FA_PARITY:
            rng = np.random.RandomState(T + H + dh)
            q, k, v = (torch.tensor(rng.randn(*shape), dtype=torch.float32,
                                    device=DEV).to(dtype)
                       for shape in ((B, T, H, dh), (B, S, K, dh),
                                     (B, S, K, dh)))
            err, top, worst = check_flash(q, k, v, causal, window, off)
            log(f"parity flash_attention {str(dtype)[6:]} (B, T, S, H, K, Dh)"
                f" {(B, T, S, H, K, dh)} causal={causal} window={window} "
                f"q_offset={off}: max |d| {err:.3e} (max |ref| {top:.3f}), "
                f"{worst:.3f} of the bound")
        parity_ssd(dtype)
    # strided views into one fused (B, T, 3, H, Dh) projection, bf16 at Dh
    # 80 (the tensor maps' strides) and f32
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.tensor(np.random.RandomState(5).randn(2, 300, 3, 4, 80),
                           dtype=torch.float32, device=DEV).to(dtype)
        err, top, worst = check_flash(qkv[:, :, 0], qkv[:, :, 1],
                                      qkv[:, :, 2], True, 40)
        log(f"parity flash_attention {str(dtype)[6:]} on strided views of "
            f"a fused (2, 300, 3, 4, 80) projection, window 40: max |d| "
            f"{err:.3e} (max |ref| {top:.3f}), {worst:.3f} of the bound")
    q = torch.randn(1, 16, 4, 64, device=DEV)
    for bad in ((q, q[:, :, :3], q[:, :, :3]),              # H % K
                (q.half(), q.half(), q.half()),             # dtype
                (q.clone().requires_grad_(), q, q)):        # forward-only
        try:
            flash_attention(*bad)
        except ValueError:
            continue
        raise AssertionError("flash_attention took what it cannot do")


def _layer_inputs(model, tokens, dtype):
    """Real inputs of layer 0's SSD core and of the shared attention
    block at full width: (xs, Bm, Cm, dt, la) and (q, k, v), in
    ``dtype``."""
    cfg = model.cfg
    with torch.inference_mode():
        x = common.embed_tokens(model.embedding, tokens, cfg, dtype)
        h = common.apply_norm(model.blocks[0]["norm1"], x, cfg)
        _, xs, Bm, Cm, dt_v, A = mamba2._ssm_inputs(
            model.blocks[0]["mamba"], h, cfg)
        ssd = (xs, Bm, Cm, dt_v, dt_v * A[None, None, :])
        scfg = shared_cfg(cfg)
        h = common.apply_norm(model.shared["norm1"], x, scfg)
        positions = torch.arange(tokens.shape[1], device=DEV)[None].expand(
            tokens.shape[0], -1)
        qkv = attention.qkv_proj(model.shared["attn"], h, positions, scfg)
    return ssd, qkv


def phase_backbone_parity():
    """Full-width kernel parity (B = 2) and the full-depth f32 forward,
    kernel path against plain path (B = 1). Returns the full-width max
    errors."""
    cfg = get_config(BACKBONE).replace(dtype="float32",
                                       ssm_tile_dtype="float32")
    t0 = time.perf_counter()
    model = Model(cfg, device=DEV, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    gb = n_params * 4 / 1e9
    log(f"{BACKBONE}: {n_params / 1e9:.3f}B parameters ({gb:.2f} GB f32) "
        f"from the seeded init in "
        f"{time.perf_counter() - t0:.1f}s; {cfg.n_layers} mamba2 layers "
        f"(d_model {cfg.d_model}, {cfg.ssm_heads} SSM heads, p "
        f"{mamba2._dims(cfg)[2]}, n {cfg.ssm_state}), shared attention "
        f"({cfg.n_heads} heads of "
        f"{cfg.dim_per_head}, window {cfg.shared_attn_window}) every "
        f"{cfg.shared_attn_every}")
    rng = np.random.RandomState(2)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (2, SEQ))).to(DEV)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        (xs, Bm, Cm, dt, la), (q, k, v) = _layer_inputs(model, tokens, dtype)
        ey, ty, wy, eh = check_ssd(xs, Bm, Cm, dt, la)
        ef, tf, wf = check_flash(q, k, v, True, cfg.shared_attn_window)
        errs[dtype] = {"ssd_scan": ey, "flash_attention": ef}
        log(f"full-width parity {str(dtype)[6:]} (B 2, T {SEQ}): ssd_scan on "
            f"layer 0's SSD core max |dy| {ey:.3e} (max |y| {ty:.4f}), "
            f"{wy:.3f} of the bound, max |dh| {eh:.3e}; flash_attention on "
            f"the shared block's q, k, v max |d| {ef:.3e} (max |ref| "
            f"{tf:.4f}), {wf:.3f} of the bound")
        del xs, Bm, Cm, dt, la, q, k, v
    # (a) the whole f32 forward, kernel path against plain path: the final
    # hidden state, then embed_pool (the entry point the service calls)
    tokens = tokens[:1]
    rel = {}
    with torch.inference_mode():
        h_k, _ = model.hidden({"tokens": tokens})
        h_p, _ = model.hidden({"tokens": tokens}, plain=True)
        assert bool(torch.isfinite(h_k).all())
        rel["hidden"] = float((h_k - h_p).abs().max() / h_p.abs().max())
        del h_k, h_p
        _reset_counts()
        t0 = time.perf_counter()
        emb_k = model.embed_pool({"tokens": tokens})
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        t0 = time.perf_counter()
        emb_p = model.embed_pool({"tokens": tokens}, plain=True)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
    assert ssd_scan.launches == cfg.n_layers and \
        flash_attention.launches == cfg.n_layers // cfg.shared_attn_every
    assert bool(torch.isfinite(emb_k).all()) and emb_k.shape == (1,
                                                                 cfg.d_model)
    rel["embed_pool"] = float((emb_k - emb_p).abs().max() / emb_p.abs().max())
    log(f"f32 forward, {cfg.n_layers} layers, B 1, T {SEQ}: embed_pool "
        f"kernel path {t_k:.2f}s, plain path {t_p:.2f}s (host clock); max "
        f"|a - b| / max |b|: final hidden state {rel['hidden']:.3e} (bound "
        f"{HIDDEN_REL_BOUND}), embed_pool {rel['embed_pool']:.3e} (bound "
        f"{EMBED_REL_BOUND})")
    assert rel["hidden"] <= HIDDEN_REL_BOUND and \
        rel["embed_pool"] <= EMBED_REL_BOUND, \
        "the kernel path left the plain path"
    del model
    torch.cuda.empty_cache()
    return {"errs": errs, "f32_rel_err": rel}


GEMMA = "gemma-7b"
GEMMA_LAYERS, GEMMA_SEQ = 2, 2048
GEMMA_ATTN = (1, 8192)      # (B, T) of its kernels-line entry, bf16


def phase_gemma():
    """gemma-7b at full width (d_model 3072, 16 heads of 256, GeGLU d_ff
    24576, vocab 256,000), depth cut to 2 layers, random f32 weights from a
    seed, B 1, T 2048: flash_attention at Dh 256 on layer 0's real q, k, v
    in bf16 and f32 against the plain version, then the forward through
    the kernels against the plain path (``plain=True``) by the final
    hidden state and by ``embed_pool``, with the launch count of that
    main-path call."""
    cfg = get_config(GEMMA).replace(n_layers=GEMMA_LAYERS, dtype="float32")
    t0 = time.perf_counter()
    model = Model(cfg, device=DEV, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{GEMMA}: depth cut to {cfg.n_layers} of 28 layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.dim_per_head}, d_ff "
        f"{cfg.d_ff}: {n_params / 1e9:.3f}B parameters from the seeded "
        f"init in {time.perf_counter() - t0:.1f}s")
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (1, GEMMA_SEQ))).to(DEV)
    batch = {"tokens": tokens}
    errs = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            x = common.embed_tokens(model.embedding, tokens, cfg, dtype)
            h = common.apply_norm(model.blocks[0]["norm1"], x, cfg)
            q, k, v = attention.qkv_proj(model.blocks[0]["attn"], h,
                                         torch.arange(GEMMA_SEQ,
                                                      device=DEV)[None], cfg)
            err, top, worst = check_flash(q, k, v, True, 0)
            errs[dtype] = err
            log(f"gemma parity flash_attention {str(dtype)[6:]} on layer 0's "
                f"q, k, v {tuple(q.shape)}: max |d| {err:.3e} (max |ref| "
                f"{top:.4f}), {worst:.3f} of the bound")
            del x, h, q, k, v
        h_k, _ = model.hidden(batch)
        h_p, _ = model.hidden(batch, plain=True)
        assert bool(torch.isfinite(h_k).all())
        rel = {"hidden": float((h_k - h_p).abs().max() / h_p.abs().max())}
        del h_k, h_p
        _reset_counts()                 # counts of the main path only
        emb_k = model.embed_pool(batch)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        emb_p = model.embed_pool(batch, plain=True)
    assert launches == cfg.n_layers, \
        f"flash_attention launched {launches} times in {cfg.n_layers} layers"
    assert bool(torch.isfinite(emb_k).all()) and emb_k.shape == (
        1, cfg.d_model)
    rel["embed_pool"] = float((emb_k - emb_p).abs().max() / emb_p.abs().max())
    log(f"gemma f32 forward, {cfg.n_layers} layers, B 1, T {GEMMA_SEQ}: "
        f"{launches} flash_attention launches; max |a - b| / max |b|: "
        f"final hidden state {rel['hidden']:.3e} (bound {HIDDEN_REL_BOUND}),"
        f" embed_pool {rel['embed_pool']:.3e} (bound {EMBED_REL_BOUND})")
    assert rel["hidden"] <= HIDDEN_REL_BOUND and \
        rel["embed_pool"] <= EMBED_REL_BOUND, \
        "the gemma kernel path left the plain path"
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "errs": errs, "f32_rel_err": rel}


def time_gemma_attention(gemma):
    """flash_attention at gemma-7b's attention shape (B 1, T 8192, 16
    heads of 256, causal, bf16) on seeded random q, k, v: kernel, plain
    version and one ``scaled_dot_product_attention`` call, by CUDA-graph
    replay; the kernels-line entry."""
    B, T = GEMMA_ATTN
    cfg = get_config(GEMMA)
    H, dh = cfg.n_heads, cfg.dim_per_head
    gen = torch.Generator(device=DEV).manual_seed(4)
    q, k, v = (torch.randn((B, T, H, dh), generator=gen, device=DEV)
               .to(torch.bfloat16) for _ in range(3))
    fn = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
    plain = lambda: attention_ref(q, k, v, causal=True)  # noqa: E731
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True)
    with torch.inference_mode():
        eager, graphed, best = _device_times(fn, plain, lib, (10, 2, 10))
    entries_band = T * (T + 1) // 2             # causal (t, s) pairs a head
    b_ms, b_by = roofline(4.0 * dh * entries_band * B * H,
                          2.0 * 4 * q.numel(), PEAK_BF16_FLOPS)
    fmt = lambda x: "-" if x is None else f"{x:.3f}"  # noqa: E731
    log(f"flash_attention gemma shape B={B} T={T} H={H} Dh={dh} causal "
        f"(bf16): device ms by graph replay: kernel {fmt(graphed['ms'])}, "
        f"plain {fmt(graphed['plain_ms'])}, library "
        f"{fmt(graphed['library_ms'])}; eager: kernel {fmt(eager['ms'])}, "
        f"plain {fmt(eager['plain_ms'])}, library {fmt(eager['library_ms'])}"
        f"; bound {b_ms:.3f} ms ({b_by}), {b_ms / best['ms']:.1%} of bound")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:80",
            "launches": gemma["launches"],
            "max_abs_err": gemma["errs"][torch.bfloat16], **best,
            "bound_ms": b_ms, "bound_by": b_by, "eager_ms": eager,
            "graph_ms": graphed,
            "max_abs_err_f32": gemma["errs"][torch.float32],
            "forward_f32_rel_err": gemma["f32_rel_err"],
            "shape": {"B": B, "T": T, "H": H, "K": cfg.kv_heads, "Dh": dh,
                      "window": 0, "band_entries_per_head": entries_band,
                      "config": GEMMA},
            "launches_note": f"{GEMMA} cut to {GEMMA_LAYERS} layers, B 1, "
                             f"T {GEMMA_SEQ}, one embed_pool"}


def _category(name):
    low = name.lower()
    if "ssd_chunk_scan" in low or "ssd_chunk_states" in low:
        return "ssd_scan"
    if "flash_wgmma" in low or "flash_f32" in low:
        return "flash_attention"
    if any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet", "cublas",
                              "sm90_")):
        return "gemm"
    return "other"


def _service_launches(cfg, n_fwd, n_ranked):
    """The launches one service run must make: one pairwise_sqdist a
    ranked batch, and for the hybrid family each forward batch's
    ssd_scan and flash_attention, for the dense, moe, vlm and audio
    families one flash_attention a layer (the ssm family has no
    kernel)."""
    expect = dict.fromkeys(KERNEL_WRAPPERS, 0)
    expect["pairwise_sqdist"] = n_ranked
    if cfg.family == "hybrid":
        expect["ssd_scan"] = cfg.n_layers * n_fwd
        expect["flash_attention"] = cfg.n_layers // cfg.shared_attn_every \
            * n_fwd
    elif cfg.family != "ssm":
        expect["flash_attention"] = cfg.n_layers * n_fwd
    return expect


def _check_ranking(out, L):
    """The service's answers against the plain distances on the same
    embeddings: finite embeddings, ascending distances within atol + rtol
    * max D, ids equal wherever the plain distances are apart by more.
    Returns max |d - d_plain|."""
    req, corp = out["request_emb"], out["corpus_emb"]
    assert bool(torch.isfinite(req).all() and torch.isfinite(corp).all())
    d, ids = out["dists"].to(DEV), out["ids"].to(DEV)
    assert bool((d[:, 1:] >= d[:, :-1]).all())
    Lf = L.to(torch.float32)
    D = pairwise_sqdist_ref(req @ Lf.T, corp @ Lf.T)
    d_ref, i_ref = topk_by_distance(D, torch.arange(
        corp.shape[0], dtype=torch.int32, device=DEV).expand(
        D.shape[0], -1), EMB_K)
    err = float((d - d_ref).abs().max())
    tol = ATOL + RTOL * float(D.max())
    assert err <= tol, f"ranked distances off by {err:.3e}"
    gaps = torch.diff(torch.cat([d_ref, torch.sort(D, 1).values[:, EMB_K:
                                                                EMB_K + 1]],
                                1), dim=1)
    apart = torch.cat([gaps[:, :1], torch.minimum(gaps[:, 1:],
                                                  gaps[:, :-1])], 1) > tol
    assert bool((ids == i_ref)[apart].all()), "ranking differs from plain"
    log(f"ranking: max |d - d_plain| {err:.3e}; ids equal to the plain "
        f"ranking's wherever distances are apart; spread of the corpus "
        f"embeddings {float(corp.std(0).mean()):.4f}")
    return err


def _serve_checked(model, L, corpus, requests, what):
    """``serve_embeddings.serve`` on ``corpus`` and ``requests`` (token
    arrays or batch dicts), k = EMB_K, with the launch counts set to 0
    just before and held to ``_service_launches`` just after; the ranking
    held to the plain distances; one request batch's device ms by kind."""
    B, T = serve_embeddings._rows_and_len(requests[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                         # counts of the main path only
    out = serve_embeddings.serve(model, L, corpus, requests, EMB_K)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_fwd = len(corpus) + len(requests)
    expect = _service_launches(model.cfg, n_fwd, len(requests))
    assert counts == expect, f"launch counts {counts}, expected {expect}"
    n_corpus = sum(serve_embeddings._rows_and_len(b)[0] for b in corpus)
    res = {"requests_per_s": out["requests_per_s"],
           "tokens_per_s": out["tokens_per_s"], "p50_ms": out["p50_ms"],
           "p99_ms": out["p99_ms"], "batch_ms": out["batch_ms"],
           "corpus_s": out["corpus_s"],
           "corpus_tokens_per_s": n_corpus * T / out["corpus_s"],
           "peak_gb": peak, "launches": counts}
    log(f"{what}: corpus {n_corpus} x {T} embedded in "
        f"{out['corpus_s']:.2f}s ({res['corpus_tokens_per_s']:.0f} "
        f"tokens/s); {len(requests)} request batches of {B} x {T}: "
        f"requests/s {out['requests_per_s']:.3f}, tokens/s "
        f"{out['tokens_per_s']:.0f}, batch ms p50 {out['p50_ms']:.1f} p99 "
        f"{out['p99_ms']:.1f} ({[round(x, 1) for x in out['batch_ms']]}); "
        f"peak memory {peak:.2f} GB; launches "
        f"{ {k: v for k, v in counts.items() if v} } over {n_fwd} forward "
        f"batches and {len(requests)} ranked ones (the others 0)")
    res["rank_max_abs_err"] = _check_ranking(out, L)
    parts = device_breakdown(lambda: serve_embeddings.embed(model,
                                                            requests[0]))
    split = None
    if parts:
        split = {}
        for name, ms in parts.items():
            split[_category(name)] = round(split.get(_category(name), 0.0)
                                           + ms, 3)
        busy = sum(parts.values())
        res["flash_share"] = split.get("flash_attention", 0.0) / busy
        top = dict(sorted(parts.items(), key=lambda kv: -kv[1])[:6])
        log(f"one request batch's forward on the card: device busy "
            f"{busy:.1f} ms (batch p50 {out['p50_ms']:.1f} ms host clock); "
            f"by kind {split} (flash_attention {res['flash_share']:.1%}); "
            f"largest kernels {top}")
    else:
        log("one request batch's forward: device time not measured")
    res["device_ms_by_kind"] = split
    return res


def phase_embedding_service(arch=BACKBONE, seq=SEQ, batch=EMB_BATCH,
                            corpus_seqs=CORPUS_SEQS,
                            request_batches=REQUEST_BATCHES):
    """The embedding service at full width and depth: ``corpus_seqs``
    sequences of ``seq`` tokens (16 x 8192 by default) embedded in
    batches of ``batch`` (4), then ``request_batches`` (4) request
    batches of ``batch`` x ``seq`` tokens ranked under a seeded L
    (d_model -> 64), k = 5."""
    t0 = time.perf_counter()
    model, L = serve_embeddings.build(arch, device=DEV, proj_dim=EMB_PROJ,
                                      seed=0)
    cfg = model.cfg
    rng = np.random.RandomState(1)
    corpus = serve_embeddings.token_batches(cfg.vocab_size, corpus_seqs, seq,
                                            batch, rng)
    requests = serve_embeddings.token_batches(
        cfg.vocab_size, request_batches * batch, seq, batch, rng)
    torch.cuda.synchronize()
    log(f"embedding service: {arch} ({cfg.dtype} activations, f32 "
        f"weights) and L {tuple(L.shape)} built in "
        f"{time.perf_counter() - t0:.1f}s")
    return model, requests, _serve_checked(model, L, corpus, requests,
                                           f"{arch} service")


def library_attention(q, k, v, window):
    """One PyTorch call for the banded attention (yardstick only):
    scaled_dot_product_attention with the causal / window mask."""
    T = q.shape[1]
    pos = torch.arange(T, device=q.device)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=band)


def _device_times(kern, plain, lib, iters):
    """(eager, graphed, best) ms of ``kern``, ``plain`` and ``lib`` (None
    where there is no library call): eager calls between CUDA events,
    CUDA-graph replays, and the replay where it could be captured (the
    device time), else the eager time; ``iters`` per callable."""
    fns = {"ms": kern, "plain_ms": plain, "library_ms": lib}
    eager = {k: None if f is None else _time(f, n)
             for (k, f), n in zip(fns.items(), iters)}
    graphed = {k: None if f is None else _time_graph(f, n)
               for (k, f), n in zip(fns.items(), iters)}
    best = {k: graphed[k] if graphed[k] is not None else eager[k]
            for k in eager}
    return eager, graphed, best


def time_backbone_kernels(model, tokens, launches, errs):
    """Kernel, plain and library times of ssd_scan and flash_attention at
    the service's shapes (B 4, T 8192, bf16) on real layer inputs; device
    times from CUDA-graph replays, eager calls beside them."""
    cfg = model.cfg
    (xs, Bm, Cm, dt, la), (q, k, v) = _layer_inputs(model, tokens,
                                                    torch.bfloat16)
    B, T, H, p = xs.shape
    n = Bm.shape[-1]
    window = cfg.shared_attn_window
    fmt = lambda x: "-" if x is None else f"{x:.3f}"  # noqa: E731
    entries = []
    with torch.inference_mode():
        ops, ops_bf16, nbytes = _ssd_bound(B, T, H, p, n)
        cps, hpb, grid = segment_plan(B, H, T)
        fn = lambda: ssd_core(xs, Bm, Cm, dt, la)  # noqa: E731
        plain = lambda: ssd_scan_chunked(  # noqa: E731
            xs.transpose(1, 2), Bm[:, None], Cm[:, None], dt.transpose(1, 2),
            la.transpose(1, 2))
        # flash: the allowed (t, s) entries of the causal 4096 window
        t = np.arange(T)
        entries_band = int(np.sum(np.minimum(t + 1, window)))
        fa_ops = 4.0 * q.shape[-1] * entries_band * B * cfg.n_heads
        fa_bytes = 2.0 * (q.numel() + k.numel() + v.numel() + q.numel())
        fa = lambda: flash_attention(q, k, v, causal=True,  # noqa: E731
                                     window=window)
        fa_plain = lambda: attention_ref(q, k, v, causal=True,  # noqa: E731
                                         window=window)
        fa_lib = lambda: library_attention(q, k, v, window)  # noqa: E731
        for name, kern, pl, lib, (b_ms, b_by), src, rep in (
                ("ssd_scan", fn, plain, None,
                 roofline(ops_bf16, nbytes, PEAK_BF16_FLOPS / 3),
                 "ssd_chunk/csrc/ssd_chunk.cu", "ssd_chunk/kernel.py:80"),
                ("flash_attention", fa, fa_plain, fa_lib,
                 roofline(fa_ops, fa_bytes, PEAK_BF16_FLOPS),
                 "flash_attention/csrc/flash_attention.cu",
                 "flash_attention/kernel.py:80")):
            eager, graphed, best = _device_times(kern, pl, lib, (10, 2, 5))
            ffma = (f"; operations at the bf16 arithmetic "
                    f"{1e3 * ops_bf16 * 3 / PEAK_BF16_FLOPS:.3f}"
                    f"; 3xTF32 {roofline(ops, nbytes)[0]:.3f}; 2xTF32 "
                    f"{roofline(ops, nbytes, PEAK_2XTF32_FLOPS)[0]:.3f}"
                    f"; f32 FFMA {ffma_bound(ops, nbytes):.3f}; plan "
                    f"{cps} chunks a segment, {hpb} heads a block, grid "
                    f"{grid}" if name == "ssd_scan" else "")
            log(f"{name} B={B} T={T} (bf16): device ms by graph replay: "
                f"kernel {fmt(graphed['ms'])}, plain "
                f"{fmt(graphed['plain_ms'])}, library "
                f"{fmt(graphed['library_ms'])}; eager: kernel "
                f"{fmt(eager['ms'])}, plain {fmt(eager['plain_ms'])}, "
                f"library {fmt(eager['library_ms'])}; bound {b_ms:.3f} ms "
                f"({b_by}{ffma}), {b_ms / best['ms']:.1%} of bound")
            entry = {"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/{src}",
                     "replaces": f"src/repro/kernels/{rep}",
                     "launches": launches[name],
                     "max_abs_err": errs[torch.bfloat16][name],
                     **best, "bound_ms": b_ms, "bound_by": b_by,
                     "eager_ms": eager, "graph_ms": graphed,
                     "max_abs_err_f32": errs[torch.float32][name]}
            if name == "ssd_scan":
                entry.update(shape={"B": B, "T": T, "H": H, "p": p, "n": n,
                                    "chunk": SSD_BOUND_CHUNK,
                                    "plan": {"chunks_per_segment": cps,
                                             "heads_per_block": hpb,
                                             "segments": grid[0],
                                             "blocks": grid[0] * grid[1]
                                             * grid[2]}},
                             library_note="no single PyTorch call computes "
                                          "it")
            else:
                entry["shape"] = {"B": B, "T": T, "H": cfg.n_heads,
                                  "K": cfg.kv_heads, "Dh": q.shape[-1],
                                  "window": window,
                                  "band_entries_per_head": entries_band}
            entries.append(entry)
    return entries


# -- decode and backbone training (phases 12-15) -----------------------------

# decode: B 4, a 16-token prompt and 32 generated tokens (max_seq 48); the
# ring cut: the shared block's window at 16 slots, which wrap three times
# in 48 positions
DECODE_B, DECODE_PROMPT, DECODE_GEN = 4, 16, 32
DECODE_RING = 16
# decode's logits at every teacher-forced position against apply on the
# same tokens (f32), as max |a - b| / max |b|: decode runs the exact
# recurrence and the cache's naive scores, apply the SSD in chunks (the
# kernel's 64 or the plain form's) and streamed or naive attention, so
# only summation orders differ: the full-depth forward's bound
DECODE_REL_BOUND = HIDDEN_REL_BOUND
# gemma-7b decode at full depth (34 GB of f32 weights) if the card has room
# for it and this much beside it
GEMMA_HEADROOM_GB = 6.0
# training: smollm-135m at full width and depth through launch/train.py's
# loop (train_4k cut in batch and length), a checkpoint at LM_RESUME_AT;
# zamba2-2.7b at full width cut to one group of 6 mamba2 layers and the
# shared block, remat on, f32 (its first step's loss held to apply through
# the kernels within ZTRAIN_LOSS_REL)
LM_ARCH = "smollm-135m"
LM_B, LM_T, LM_STEPS, LM_RESUME_AT = 8, 512, 30, 15
LM_LR = 1e-3
# test_system.py's stream (its vocabulary of 512 ids) for the loss-fall
# check: over the full 49,152 ids each id comes up about 2.5 times in 30
# steps of 4,096 tokens, and the loss stays within a few percent
LM_DATA_VOCAB = 512
ZTRAIN_LAYERS, ZTRAIN_B, ZTRAIN_T, ZTRAIN_STEPS = 6, 2, 512, 10
ZTRAIN_LR = 1e-3
ZTRAIN_LOSS_REL = 1e-5
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "checkpoints")
# phase 16: rwkv6-1.6b. apply_rwkv6's chunk (apply pads decode's tokens to
# a multiple); layer 0's time mix on its real input at T RWKV_T (B 1),
# the gradients at T RWKV_GRAD_T, again with every w0 at RWKV_CLAMP_W0,
# which puts every per-token log decay at its clamp of -5 (a chunk sums
# to -160: the chunked form's factors multiply to e^160 above the
# diagonal); chunked against the recurrence within the reference's own
# bound (tests/test_model_internals.py TestRWKV6), the gradients within
# RWKV_GRAD_REL of each leaf's largest |b|
RWKV = "rwkv6-1.6b"
RWKV_CHUNK = 32
RWKV_T, RWKV_GRAD_T, RWKV_CLAMP_W0 = 2048, 256, 2.0
RWKV_TOL = dict(rtol=1e-3, atol=1e-4)
RWKV_GRAD_REL = 1e-3
# decode against apply end to end is reported, not held: at the seeded
# init a head whose bonus r.(u*k) nearly cancels leaves its group norm a
# near-zero variance, where the norm's gain reaches 1/sqrt(64e-5) ~ 40,
# so f32 rounding compounds over 24 layers (two f32 forms of the model
# part by up to 9e-2, and the reference's own decode and apply by 4e-4 at
# 24 layers of reduced width). Decode is held layer by layer instead, and
# the yardstick is how far apply moves under RWKV_PROBE relative noise on
# its embeddings
RWKV_PROBE = 1e-6


def _rel(a, b, chunk=1 << 26):
    """max |a - b| / max |b|, over slices of ``chunk`` elements (a full
    pass at f32 would hold three f32 copies of a 1G-element logit
    tensor)."""
    a, b = a.reshape(-1), b.reshape(-1)
    d = m = 0.0
    for i in range(0, b.numel(), chunk):
        x, y = a[i:i + chunk].float(), b[i:i + chunk].float()
        d = max(d, float((x - y.to(x.device)).abs().max()))
        m = max(m, float(y.abs().max()))
    return d / m


def _hold_decode(model, prompts, what, bound=DECODE_REL_BOUND):
    """``launch/serve.generate`` (prefill by decode, then greedy) in f32,
    every step's logits held against ``apply`` on the prompt and the
    generated tokens, through the kernels and with ``plain=True``.
    Decode launches no kernel of ours; apply's launches are counted. The
    ssm family's apply runs whole chunks of RWKV_CHUNK, so its input is
    padded with zeros to a multiple: causal, the padding changes no
    earlier logit. ``bound`` None reports the logits' difference without
    holding it (rwkv6: ``_rwkv_decode_by_layer`` holds decode instead)."""
    cfg = model.cfg
    _reset_counts()
    with _moe_routes() as routes:
        out = serve.generate(model, prompts, DECODE_GEN, keep_logits=True)
    assert not any(_counts().values()), "decode launched a kernel"
    decode_dropped = _dropped(routes)
    seq = torch.cat([prompts, out["tokens"]], dim=1)[:, :-1]
    steps = out["step_logits"]
    assert steps.shape == (prompts.shape[0], seq.shape[1], cfg.vocab_size)
    assert bool(torch.isfinite(steps).all())
    full_in = seq
    if cfg.family == "ssm":
        full_in = torch.cat([seq, seq.new_zeros(
            (seq.shape[0], -seq.shape[1] % RWKV_CHUNK))], dim=1)
    T = seq.shape[1]
    held, config_dropped = model, 0
    if cfg.family == "moe":
        # apply routes all B x T tokens under one capacity, decode B a step
        # under one no queue can pass: the two agree only where apply drops
        # nothing. The pairs the config's capacity drops are counted; apply
        # is held at factor E / k, a capacity of B x T + 8
        with torch.inference_mode(), _moe_routes() as routes:
            model.apply({"tokens": full_in})
        config_dropped = _dropped(routes)
        held = Model(cfg.replace(moe_capacity_factor=cfg.n_experts
                                 / cfg.top_k), device=DEV,
                     params=model.param_tree())
    with torch.inference_mode():
        _reset_counts()
        with _moe_routes() as routes:
            full_k, _ = held.apply({"tokens": full_in})
        torch.cuda.synchronize()
        launches = {k: _counts()[k] for k in ("ssd_scan", "flash_attention")}
        assert not any(v for k, v in _counts().items() if k not in launches)
        # apply routes all B x T tokens under one capacity, decode B a
        # step: the two agree only where apply drops no pair
        apply_dropped = _dropped(routes)
        assert apply_dropped == 0 and decode_dropped == 0, \
            f"{what}: MoE pairs dropped: apply {apply_dropped}, decode " \
            f"{decode_dropped}"
        rel_k = _rel(steps, full_k[:, :T])
        del full_k
        full_p, _ = held.apply({"tokens": full_in}, plain=True)
        rel_p = _rel(steps, full_p[:, :T])
        del full_p
    hybrid = cfg.family == "hybrid"
    expect = {"ssd_scan": cfg.n_layers if hybrid else 0,
              "flash_attention": (cfg.n_layers // cfg.shared_attn_every
                                  if hybrid else 0 if cfg.family == "ssm"
                                  else cfg.n_layers)}
    assert launches == expect, f"{what}: apply launched {launches}"
    per_tok = 1e3 * out["decode_s"] / out["decode_steps"]
    drops = (f"; MoE pairs dropped: at the config's capacity "
             f"{config_dropped} of apply's {routes['pairs']}, at factor "
             f"E / k 0, in decode 0" if cfg.family == "moe" else "")
    log(f"{what}: decode of B {prompts.shape[0]}, {prompts.shape[1]} + "
        f"{DECODE_GEN} tokens in f32 ({1e3 * out['prefill_s']:.1f} ms "
        f"prefill, {per_tok:.2f} ms/token); logits at all {seq.shape[1]} "
        f"positions against apply, max |a - b| / max |b|: through the "
        f"kernels {rel_k:.3e} ({launches}), plain {rel_p:.3e} (bound "
        f"{bound}){drops}")
    assert bound is None or (rel_k <= bound and rel_p <= bound), \
        f"{what}: decode left apply"
    return {"rel_err_kernel": rel_k, "rel_err_plain": rel_p,
            "apply_launches": launches, "moe_config_dropped": config_dropped,
            "f32_prefill_ms":
            1e3 * out["prefill_s"], "f32_ms_per_token": per_tok}


def phase_decode_zamba(model):
    """Phase 12: zamba2-2.7b decode at full width and depth on the
    service's weights. f32 activations: B 4, 16 + 32 tokens held against
    apply (kernels and plain), then with the shared block's window cut to
    16 (the ring wraps); then ``launch/serve.py``'s loop at the config's
    bf16 activations, timed, then once under the profiler."""
    t_phase = time.perf_counter()
    cfg = model.cfg.replace(dtype="float32", ssm_tile_dtype="float32")
    params = model.param_tree()
    prompts = torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.vocab_size, (DECODE_B, DECODE_PROMPT))).to(DEV)
    res = {}
    for name, c in (("window", cfg),
                    ("ring", cfg.replace(shared_attn_window=DECODE_RING))):
        m32 = Model(c, device=DEV, params=params)
        res[name] = _hold_decode(
            m32, prompts, f"{BACKBONE} decode, shared window "
            f"{c.shared_attn_window} (cache of "
            f"{attention.cache_len(shared_cfg(c), DECODE_PROMPT + DECODE_GEN)}"
            f" slots)")
        del m32
    timing = _time_decode(model, prompts)
    log(f"{BACKBONE} serving loop ({model.cfg.dtype} activations, f32 "
        f"weights), B {DECODE_B}: prefill {timing['prefill_ms']:.1f} ms for "
        f"{DECODE_PROMPT} tokens, {timing['ms_per_token']:.2f} ms/token, "
        f"{timing['tokens_per_s']:.1f} tokens/s, peak memory "
        f"{timing['peak_gb']:.2f} GB; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {**res, "serve_bf16": timing}


def _time_decode(model, prompts):
    """``launch/serve.py``'s loop at the model's activations: one short
    warm call, then timed (prefill ms, ms/token, tokens/s, peak memory),
    then a short loop under the profiler (device busy a step, operations
    a step). Decode launches no kernel of ours (checked)."""
    serve.generate(model, prompts[:, :4], 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    out = serve.generate(model, prompts, DECODE_GEN)
    assert not any(_counts().values()), "decode launched a kernel"
    assert bool(torch.isfinite(out["logits"]).all())
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_steps = DECODE_PROMPT + DECODE_GEN - 1
    per_tok = 1e3 * out["decode_s"] / out["decode_steps"]
    # under the profiler, a short loop (4 + 4 tokens: 7 steps; the
    # profiler's own processing grows with its events, about 3,800 a step)
    prof_steps = 7
    _, host, busy, n_ops, _ = _profile_busy(
        lambda: serve.generate(model, prompts[:, :4], 4))
    timing = {"prefill_ms": 1e3 * out["prefill_s"], "ms_per_token":
              per_tok, "tokens_per_s": DECODE_B * 1e3 / per_tok,
              "peak_gb": peak, "steps": n_steps,
              "device_ops_per_step": n_ops / prof_steps,
              "profiled_host_ms": 1e3 * host, "busy_ms": busy}
    if busy is None:
        log("decode loop: device time not measured")
    else:
        timing["busy_share_profiled"] = busy / (1e3 * host)
        timing["busy_ms_per_step"] = busy / prof_steps
        timing["busy_share"] = busy / prof_steps / per_tok
        log(f"decode loop under the profiler ({prof_steps} steps): "
            f"{1e3 * host:.1f} ms host, device busy {busy:.1f} ms "
            f"({timing['busy_share_profiled']:.1%} of the profiled call; "
            f"{timing['busy_ms_per_step']:.3f} ms a step = "
            f"{timing['busy_share']:.1%} of the unprofiled {per_tok:.2f} "
            f"ms/token); {n_ops / prof_steps:.0f} device operations a "
            f"step")
    return timing


def phase_decode_gemma():
    """Phase 13: gemma-7b decode at full width (16 heads of 256, vocab
    256,000), f32 weights and activations, at full depth where the card
    has room (else the deepest cut that fits, listed): B 4, 16 + 32
    tokens held against apply."""
    t_phase = time.perf_counter()
    cfg = get_config(GEMMA).replace(dtype="float32")
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd = cfg.n_heads * cfg.dim_per_head
    layer_gb = 4 * (2 * d * hd + 2 * d * cfg.kv_heads * cfg.dim_per_head
                    + 3 * d * f + 2 * d) / 1e9
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    fit = int((free_gb - 4 * V * d / 1e9 - GEMMA_HEADROOM_GB) // layer_gb)
    layers = max(1, min(cfg.n_layers, fit))
    if layers < cfg.n_layers:
        log(f"{GEMMA}: {free_gb:.1f} GB free holds {layers} of "
            f"{cfg.n_layers} layers: depth cut")
        cfg = cfg.replace(n_layers=layers)
    model = Model(cfg, device=DEV, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{GEMMA}: {cfg.n_layers} layers, {n_params / 1e9:.3f}B parameters "
        f"({4 * n_params / 1e9:.1f} GB f32) from the seeded init in "
        f"{time.perf_counter() - t_phase:.1f}s")
    prompts = torch.from_numpy(np.random.RandomState(7).randint(
        0, V, (DECODE_B, DECODE_PROMPT))).to(DEV)
    torch.cuda.reset_peak_memory_stats()
    res = _hold_decode(model, prompts, f"{GEMMA} decode")
    res.update(layers=cfg.n_layers, peak_gb=torch.cuda.max_memory_allocated()
               / 1e9)
    log(f"{GEMMA} decode phase: peak memory {res['peak_gb']:.2f} GB; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


def phase_train_smollm(lr=LM_LR):
    """Phase 14: smollm-135m at full width and depth through
    ``launch/train.py``'s loop on ``token_stream``: AdamW, bf16
    activations, f32 weights, B 8, T 512, 30 steps. First on the stream
    over the full vocabulary (the loss logged), then on
    ``test_system.py``'s stream (ids below LM_DATA_VOCAB), where the
    loss must fall under 0.85x, with a checkpoint at step 15 restored
    and resumed bit-exact against the run that went on; one step under
    the profiler."""
    t_phase = time.perf_counter()
    model, step, state = train.build(LM_ARCH, LM_STEPS, lr=lr,
                                          device=DEV)
    cfg = model.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    full = train.train_loop(
        step, state, token_stream(cfg.vocab_size, LM_B, LM_T,
                                  device=DEV), LM_STEPS, log=None)[1]
    stream = token_stream(LM_DATA_VOCAB, LM_B, LM_T, device=DEV)
    batches = [next(stream) for _ in range(LM_STEPS)]
    k = LM_RESUME_AT
    mid, h1 = train.train_loop(step, state, iter(batches[:k]), k, log=None)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    save_checkpoint(CKPT_DIR, k, {"params": mid.params,
                                  "opt": mid.opt_state})
    end_a, h2 = train.train_loop(step, mid, iter(batches[k:]),
                                 LM_STEPS - k, log=None)
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert ssd_scan.launches == 0 and flash_attention.launches == 0
    restored, at = restore_checkpoint(
        CKPT_DIR, tree_map(torch.zeros_like, {"params": mid.params,
                                              "opt": mid.opt_state}))
    assert at == k
    end_b, h3 = train.train_loop(
        step, steps_lib.TrainState(restored["params"], restored["opt"],
                                   torch.tensor(k, dtype=torch.int32,
                                                device=DEV)),
        iter(batches[k:]), LM_STEPS - k, log=None)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    _, host, busy, n_ops, _ = _profile_busy(lambda: step(end_a,
                                                         batches[0]))
    losses = h1["loss"] + h2["loss"]
    assert all(np.isfinite(losses + full["loss"]))
    ratio = lambda ls: float(np.mean(ls[-5:]) / np.mean(ls[:5]))  # noqa
    bitexact = (_equal_trees(end_a.params, end_b.params)
                and _equal_trees(end_a.opt_state, end_b.opt_state)
                and h2["loss"] == h3["loss"])
    secs = full["step_s"][1:] + h1["step_s"] + h2["step_s"]
    ms = 1e3 * float(np.median(secs))
    out = {"losses_full_vocab": full["loss"], "ratio_full_vocab":
           ratio(full["loss"]), "losses": losses, "ratio": ratio(losses),
           "ms_per_step": ms, "tokens_per_s": LM_B * LM_T * 1e3 / ms,
           "first_step_ms": 1e3 * full["step_s"][0], "peak_gb": peak,
           "resume_bitexact": bitexact, "lr": lr,
           "profiled_step_ms": 1e3 * host, "busy_ms": busy,
           "device_ops_per_step": n_ops}
    busy_txt = ("device time not measured" if busy is None else
                f"one step under the profiler {1e3 * host:.1f} ms host, "
                f"device busy {busy:.1f} ms ({busy / ms:.1%} of the "
                f"unprofiled step), {n_ops} device operations")
    log(f"{LM_ARCH} training ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"GQA {cfg.n_heads}/{cfg.kv_heads}, {cfg.dtype} activations, f32 "
        f"weights, AdamW lr {lr}), B {LM_B}, T {LM_T}, {LM_STEPS} "
        f"steps: full vocabulary loss {full['loss'][0]:.4f} -> "
        f"{full['loss'][-1]:.4f} (last 5 / first 5 "
        f"{out['ratio_full_vocab']:.3f}); ids below {LM_DATA_VOCAB}: "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (ratio {out['ratio']:.3f}, "
        f"bound 0.85); {ms:.1f} ms/step (median; first step "
        f"{out['first_step_ms']:.0f} ms), {out['tokens_per_s']:.0f} "
        f"tokens/s, peak memory {peak:.2f} GB; {busy_txt}; resumed from "
        f"step {k}: bit-exact {bitexact}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    assert out["ratio"] < 0.85, "the loss did not fall by 15%"
    assert bitexact, "the resumed run left the one that went on"
    del model, state, mid, end_a, end_b, restored
    return out


def phase_train_zamba(lr=ZTRAIN_LR):
    """Phase 15: zamba2-2.7b at full width, depth cut to one group (6
    mamba2 layers and the shared block), through ``_train_checked``."""
    cfg = get_config(BACKBONE).replace(n_layers=ZTRAIN_LAYERS,
                                       dtype="float32",
                                       ssm_tile_dtype="float32")
    return _train_checked(
        BACKBONE, cfg, {"ssd_scan": ZTRAIN_LAYERS, "flash_attention": 1}, lr,
        f"{BACKBONE} training cut to {ZTRAIN_LAYERS} mamba2 layers + the "
        f"shared block")


def _train_checked(arch, cfg, expect, lr, what, steps=ZTRAIN_STEPS,
                   shape=(ZTRAIN_B, ZTRAIN_T), loss_rel=ZTRAIN_LOSS_REL,
                   perturb_seed=None):
    """``cfg`` (f32) trained with remat, B x T ``shape``, ``steps`` steps
    through ``launch/train.py``'s loop on ``test_system.py``'s stream
    (ids below LM_DATA_VOCAB), or for ``input_kind="embeddings"`` on the
    launcher's own frame / patch batches (``train.embedding_batches``:
    the reference launcher's, labels over the vocabulary); the first
    step's loss held against ``apply`` through the kernels on the same
    batch within ``loss_rel`` (its CE, plus ``moe_aux_weight`` times its
    router loss for the moe family; ``expect``: its launches by kernel),
    every leaf updated and finite (a leaf the batches do not reach, the
    token embedding under frames, by AdamW's decay alone), the loss
    falling (the mean of the last third of the steps below the first
    third's, a step at least). ``perturb_seed``: the model's constant
    leaves are given seeded noise first (``_perturb_constant``; the
    state's params share their storage)."""
    t_phase = time.perf_counter()
    B, T = shape
    model, step, state = train.build(arch, steps, lr=lr, remat=True,
                                     device=DEV, cfg=cfg)
    if perturb_seed is not None:
        _perturb_constant(model, perturb_seed)
    stream = (train.embedding_batches(cfg, B, T, device=DEV)
              if cfg.input_kind == "embeddings" else
              token_stream(LM_DATA_VOCAB, B, T, device=DEV))
    batches = [next(stream) for _ in range(steps)]
    with torch.inference_mode():
        _reset_counts()
        logits, aux = model.apply({k: v for k, v in batches[0].items()
                                   if k != "labels"})
        torch.cuda.synchronize()
        launches = {k: v for k, v in _counts().items() if v}
        aux_k = float(aux["moe_aux"])
        ce_k = float(softmax_cross_entropy(logits, batches[0]["labels"])) \
            + cfg.moe_aux_weight * aux_k
        del logits
    assert launches == expect, f"{what}: apply launched {launches}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    _reset_counts()
    # the loop holds the only reference to the first state, so its zero
    # moments are freed after the first step; its params are the model's
    init_params, first = state.params, [state]
    del state
    end, hist = train.train_loop(step, first.pop(), iter(batches),
                                 steps, log=None)
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert not any(_counts().values()), "training launched a kernel"
    losses = hist["loss"]
    rel = abs(losses[0] - ce_k) / ce_k
    finite = all(bool(torch.isfinite(p).all()) for p in
                 tree_leaves(end.params))
    moved = sum(float((a - b).abs().max()) > 0 for a, b in
                zip(tree_leaves(end.params), tree_leaves(init_params)))
    n_leaves = len(tree_leaves(init_params))
    ms = 1e3 * float(np.median(hist["step_s"][1:]))
    out = {"layers": cfg.n_layers, "losses": losses, "first_loss_apply":
           ce_k, "first_loss_rel": rel, "ms_per_step": ms, "tokens_per_s":
           B * T * 1e3 / ms, "peak_gb": peak,
           "state_gb": base_gb, "apply_launches": launches, "lr": lr}
    aux_txt = ""
    if cfg.family == "moe":
        out.update(moe_aux=hist["moe_aux"], first_aux_apply=aux_k)
        aux_txt = (f" (CE + {cfg.moe_aux_weight} x router loss "
                   f"{aux_k:.6f})")
        log(f"{what}: the router loss a step "
            f"{[round(a, 5) for a in hist['moe_aux']]}")
    log(f"{what} (f32, remat, AdamW lr {lr}), B {B}, T {T}, {steps} "
        f"steps: first loss {losses[0]:.6f} against "
        f"apply through the kernels {ce_k:.6f}{aux_txt} (|d| / loss "
        f"{rel:.2e}, bound {loss_rel}); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; "
        f"{moved} of {n_leaves} leaves moved, finite {finite}; {ms:.1f} "
        f"ms/step, {out['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{peak:.2f} GB ({base_gb:.2f} GB before the first step); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    assert rel <= loss_rel, "the training forward left apply"
    assert finite and moved == n_leaves, "updates not finite or missing"
    w = max(1, steps // 3)
    assert np.mean(losses[-w:]) < np.mean(losses[:w]), "the loss did not fall"
    del model, init_params, end
    return out


# -- rwkv6-1.6b: forward, decode, training, the embedding service (16) -------

def _rwkv_layer_checks(model):
    """Phase 16 (a) and (b): layer 0's time mix on its real input (B 1,
    T RWKV_T, f32), chunked against the token-by-token recurrence, at
    the seeded init and with every w0 at RWKV_CLAMP_W0; then at the clamp
    (T RWKV_GRAD_T) the gradients of x and of every leaf through both
    forms: finite, and within RWKV_GRAD_REL of each leaf's largest |b|."""
    cfg = model.cfg
    tokens = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab_size, (1, RWKV_T))).to(DEV)
    with torch.inference_mode():
        x = common.embed_tokens(model.embedding, tokens, cfg, torch.float32)
        h = common.apply_norm(model.blocks[0]["norm1"], x, cfg)
    p0 = model.param_tree()["blocks"][0]["tmix"]
    clamped = dict(p0, w0=torch.full_like(p0["w0"], RWKV_CLAMP_W0))
    out = {}
    for name, p in (("init", p0), ("clamp", clamped)):
        with torch.inference_mode():
            logw = rwkv6._mix_heads(p, h, torch.zeros_like(h[:, 0]), cfg)[4]
            chunk_sum = float(logw.reshape(1, -1, RWKV_CHUNK, cfg.n_heads,
                                           cfg.dim_per_head).sum(2).min())
            y_c = rwkv6.apply_rwkv6(p, h, cfg)
            y_r = rwkv6.apply_rwkv6_ref(p, h, cfg)
        torch.cuda.synchronize()
        rel = _rel(y_c, y_r)
        log(f"{RWKV} layer 0 time mix ({name}; log decay "
            f"{float(logw.min()):.4f} .. {float(logw.max()):.4f}, the "
            f"lowest chunk sum {chunk_sum:.1f}), B 1, T {RWKV_T}, f32: "
            f"chunked against the recurrence max |a - b| / max |b| "
            f"{rel:.3e}, finite {bool(torch.isfinite(y_c).all())}")
        torch.testing.assert_close(y_c, y_r, **RWKV_TOL)
        out[name] = {"rel_err": rel, "log_decay_min": float(logw.min()),
                     "chunk_log_decay_min": chunk_sum}
    xg = h[:, :RWKV_GRAD_T].clone()
    gy = torch.randn(xg.shape, device=DEV,
                     generator=torch.Generator(device=DEV).manual_seed(9))
    grads = []
    for fn in (rwkv6.apply_rwkv6, rwkv6.apply_rwkv6_ref):
        live = {k: v.clone().requires_grad_(True) for k, v in
                clamped.items()}
        xl = xg.clone().requires_grad_(True)
        (fn(live, xl, cfg) * gy).sum().backward()
        grads.append({"x": xl.grad, **{k: live[k].grad for k in live}})
    worst, finite = {}, True
    for k, a in grads[0].items():
        b = grads[1][k]
        finite = finite and bool(torch.isfinite(a).all())
        scale = float(b.abs().max())
        worst[k] = float((a - b).abs().max()) / scale if scale else \
            float((a - b).abs().max())
    log(f"{RWKV} layer 0 at the clamp, B 1, T {RWKV_GRAD_T}: gradients of "
        f"x and {len(grads[0]) - 1} leaves finite {finite}; max |a - b| / "
        f"max |b| against the recurrence's, worst "
        f"{max(worst.values()):.3e} ({max(worst, key=worst.get)}; bound "
        f"{RWKV_GRAD_REL}; leaves past the clamp have exact 0 gradients on "
        f"both sides)")
    assert finite, "non-finite gradients at the decay clamp"
    assert max(worst.values()) <= RWKV_GRAD_REL, worst
    out["clamp_grad_rel_err"] = worst
    return out


def _rwkv_decode_by_layer(model, tokens):
    """Phase 16 (c), decode held layer by layer: each block's decode over
    ``tokens`` (B, T), step by step from a fresh cache, against the
    block's chunked form on the same input (the hidden state ``apply``
    feeds it; the tokens padded to whole chunks, causal), f32: max |a -
    b| / max |b| of every layer, each within DECODE_REL_BOUND. Held
    block by block, no layer's rounding is carried into the next. Also
    the end-to-end yardstick: how far ``apply``'s logits move when the
    embeddings move by RWKV_PROBE (relative, seeded)."""
    cfg = model.cfg
    B, T = tokens.shape
    padded = torch.cat([tokens, tokens.new_zeros((B, -T % RWKV_CHUNK))], 1)
    gen = torch.Generator(device=DEV).manual_seed(11)
    rels = []
    with torch.inference_mode():
        x = common.embed_tokens(model.embedding, padded, cfg, torch.float32)
        xp = x * (1 + RWKV_PROBE * torch.randn(x.shape, device=DEV,
                                               generator=gen))
        for p in model.blocks:
            y_full = transformer._apply_rwkv_block(p, x, cfg)
            cache = rwkv6.init_cache(cfg, B, torch.float32, DEV)
            ys = []
            for t in range(T):
                y, cache = transformer._decode_rwkv_block(p, x[:, t:t + 1],
                                                          cache, cfg)
                ys.append(y)
            rels.append(_rel(torch.cat(ys, dim=1), y_full[:, :T]))
            x, xp = y_full, transformer._apply_rwkv_block(p, xp, cfg)
        logits = [common.unembed(model.embedding, common.apply_norm(
            model.final_norm, h[:, :T], cfg), cfg) for h in (x, xp)]
        probe = _rel(logits[1], logits[0])
    log(f"{RWKV} decode held layer by layer (B {B}, {T} steps, f32): max "
        f"|a - b| / max |b| against the chunked block on the same input, "
        f"worst {max(rels):.3e} at layer {int(np.argmax(rels))} (bound "
        f"{DECODE_REL_BOUND}); apply's logits move by {probe:.3e} (max |a "
        f"- b| / max |b|) when the embeddings move by {RWKV_PROBE} "
        f"relative")
    assert max(rels) <= DECODE_REL_BOUND, f"{RWKV}: a layer's decode left " \
        f"its chunked form: {rels}"
    return {"layer_rel_err": rels, "probe_rel": probe}


def phase_rwkv6():
    """Phase 16: rwkv6-1.6b at full width and depth (24 layers, d_model
    2048, 32 heads of 64, d_ff 7168, vocab 65,536) from the port's seeded
    init, f32 weights: (a)-(b) layer 0's chunked time mix against the
    recurrence, forward and at the decay clamp gradients; (c) decode of
    B 4, 16 + 32 tokens in f32 held against ``apply`` at every step, then
    the loop at bf16 activations, timed and profiled; (d) training through
    ``launch/train.py``'s loop at full depth (peak 58.2 GB on an NVIDIA
    H100 80GB HBM3); (e) the embedding service at phase 10's traffic.
    rwkv6 has no kernel of its own: only (e)'s ranking launches one
    (pairwise_sqdist)."""
    t_phase = time.perf_counter()
    cfg = get_config(RWKV).replace(dtype="float32")
    model = Model(cfg, device=DEV, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{RWKV}: {cfg.n_layers} layers, {n_params / 1e9:.3f}B parameters "
        f"({4 * n_params / 1e9:.1f} GB f32) from the seeded init in "
        f"{time.perf_counter() - t_phase:.1f}s")
    out = {"params": n_params, "layer0": _rwkv_layer_checks(model)}
    prompts = torch.from_numpy(np.random.RandomState(10).randint(
        0, cfg.vocab_size, (DECODE_B, DECODE_PROMPT))).to(DEV)
    torch.cuda.reset_peak_memory_stats()
    out["decode"] = _hold_decode(model, prompts, f"{RWKV} decode",
                                 bound=None)
    out["decode"].update(_rwkv_decode_by_layer(
        model, torch.from_numpy(np.random.RandomState(12).randint(
            0, cfg.vocab_size, (DECODE_B, DECODE_PROMPT + DECODE_GEN - 1)))
        .to(DEV)))
    served = Model(get_config(RWKV), device=DEV, params=model.param_tree())
    timing = _time_decode(served, prompts)
    log(f"{RWKV} serving loop ({served.cfg.dtype} activations, f32 weights),"
        f" B {DECODE_B}: prefill {timing['prefill_ms']:.1f} ms for "
        f"{DECODE_PROMPT} tokens, {timing['ms_per_token']:.2f} ms/token, "
        f"{timing['tokens_per_s']:.1f} tokens/s, peak memory "
        f"{timing['peak_gb']:.2f} GB")
    out["decode"]["serve_bf16"] = timing
    del model, served
    gc.collect()
    torch.cuda.empty_cache()
    out["training"] = _train_checked(RWKV, cfg, {}, ZTRAIN_LR,
                                     f"{RWKV} training at full depth")
    gc.collect()
    torch.cuda.empty_cache()
    svc_model, _, out["service"] = phase_embedding_service(RWKV)
    del svc_model
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"{RWKV} phase {out['phase_s']:.1f} s")
    return out


# -- the moe family: granite-moe-1b and qwen3-moe-30b (17) --------------------

# phase 17: granite-moe-1b-a400m at full width and depth; qwen3-moe-30b-a3b
# at full width cut to MOE_QWEN_LAYERS of its 48 layers (about 120 GB of
# f32 weights at full depth), or the deepest cut that leaves
# MOE_QWEN_HEADROOM_GB free. (a) and (b) at B 1, T MOE_T, f32: (a) the
# grouped layer against the dense oracle within the reference's own bound
# (tests/test_model_internals.py TestMoE), again at capacity factor
# MOE_LOW_FACTOR, where queues overflow, and its gradients within
# MOE_GRAD_REL of each leaf's largest |b|; (b) the full forward through the
# kernels against plain=True within HIDDEN_REL_BOUND, the router loss
# within MOE_AUX_KERNEL_REL. (e) granite-3.0's context of 4,096 tokens a
# sequence: phase 10's token count in batches of 8; flash_attention held
# to attention_ref on layer 0's q, k, v of a service batch (both configs)
MOE = "granite-moe-1b-a400m"
MOE_QWEN = "qwen3-moe-30b-a3b"
MOE_T = 2048
MOE_LOW_FACTOR = 0.25
MOE_TOL = dict(rtol=1e-3, atol=1e-4)
MOE_AUX_REL = 1e-4
MOE_GRAD_REL = 1e-3
MOE_AUX_KERNEL_REL = 1e-6
MOE_SEQ, MOE_BATCH, MOE_CORPUS, MOE_REQUESTS = 4096, 8, 32, 4
MOE_QWEN_LAYERS, MOE_QWEN_HEADROOM_GB = 16, 16.0
MOE_QWEN_TRAIN_LAYERS, MOE_QWEN_TRAIN_STEPS = 2, 3


@contextlib.contextmanager
def _moe_routes():
    """Records every MoE layer's routing while open: ``topi`` and the
    dropped pairs (device tensors, no sync) a call, and the pairs routed
    (``moe._queue_slots`` wrapped)."""
    rec = {"topi": [], "dropped": [], "pairs": 0}
    queue_slots = moe._queue_slots

    def recording(topi, *args):
        keep, dest = queue_slots(topi, *args)
        rec["topi"].append(topi)
        rec["dropped"].append(torch.sum(~keep))
        rec["pairs"] += topi.numel()
        return keep, dest

    moe._queue_slots = recording
    try:
        yield rec
    finally:
        moe._queue_slots = queue_slots


def _dropped(rec):
    return int(sum(rec["dropped"])) if rec["dropped"] else 0


def _moe_h2(model, tokens):
    """Layer 0's real MoE input (B, T, d) in f32: the embeddings through
    layer 0's attention (plain form) and its second norm."""
    cfg = model.cfg
    p0 = model.blocks[0]
    B, T = tokens.shape
    with torch.no_grad():
        x = common.embed_tokens(model.embedding, tokens, cfg, torch.float32)
        h = common.apply_norm(p0["norm1"], x, cfg)
        positions = torch.arange(T, device=DEV)[None, :].expand(B, T)
        q, k, v = attention.qkv_proj(p0["attn"], h, positions, cfg)
        x = x + attention.out_proj(
            p0["attn"], attention.attend_plain(q, k, v, cfg), cfg)
        return common.apply_norm(p0["norm2"], x, cfg)


def _keep_token_major(topi, n_experts, capacity):
    """The pairs that queues of ``capacity`` keep, found apart from
    ``moe._queue_slots``: a stable sort of the flattened (token, slot)
    expert ids leaves each expert's pairs in token-major order, so a
    pair's place in its queue is its rank among its expert's pairs."""
    flat = topi.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=flat.device) \
        - starts[flat[order]]
    return rank < capacity


def _moe_dense_kept(p, x, cfg, keep):
    """The every-expert oracle with the dropped pairs' combine weights at
    0, in plain torch: what the grouped form computes where queues
    overflow."""
    B, T, d = x.shape
    E, N = cfg.n_experts, B * T
    xf = x.reshape(N, d)
    topv, topi, _ = moe._route(p["router"], xf, cfg)
    w = topv * keep.reshape(N, cfg.top_k)
    combine = torch.sum(torch.nn.functional.one_hot(topi, E).to(
        torch.float32) * w[..., None], dim=1)
    ye = moe._expert_ffn(p, xf[None].expand(E, N, d), cfg)
    return torch.einsum("end,ne->nd", ye.to(torch.float32),
                        combine).to(x.dtype).reshape(B, T, d)


def _moe_layer_checks(model, name):
    """17 (a): layer 0's MoE on its real input (B 1, T MOE_T, f32). At the
    config's capacity the pairs dropped are counted and the grouped
    ``apply_moe`` is held against the every-expert oracle with their
    combine weights at 0 (``_moe_dense_kept``; the pairs kept found by
    ``_keep_token_major`` and required equal to ``moe._queue_slots``'
    at every factor); at factor E / k (a
    capacity of T + 8, which no queue can pass) nothing drops and it is
    held against ``apply_moe_dense`` itself; at MOE_LOW_FACTOR pairs
    must drop. At the config's capacity the gradients of x and every leaf
    are held against the oracle's, and forward and backward run twice
    must be bit-identical."""
    cfg = model.cfg
    tokens = torch.from_numpy(np.random.RandomState(16).randint(
        0, cfg.vocab_size, (1, MOE_T))).to(DEV)
    x = _moe_h2(model, tokens)
    p = model.param_tree()["blocks"][0]["moe"]
    factors = {"config": cfg.moe_capacity_factor,
               "ample": cfg.n_experts / cfg.top_k, "low": MOE_LOW_FACTOR}
    out = {"pairs": MOE_T * cfg.top_k}
    with torch.no_grad():
        y_d, aux_d = moe.apply_moe_dense(p, x, cfg)
        for case, factor in factors.items():
            c = cfg.replace(moe_capacity_factor=factor)
            cap = moe._capacity(MOE_T, c, cfg.n_experts)
            with _moe_routes() as rec:
                y, aux = moe.apply_moe(p, x, c)
            keep = _keep_token_major(rec["topi"][0], cfg.n_experts, cap)
            assert torch.equal(keep, moe._queue_slots(
                rec["topi"][0], 0, cfg.n_experts, cap)[0]), \
                f"{name}: the queues keep other pairs at factor {factor}"
            ref = y_d if case == "ample" else _moe_dense_kept(p, x, cfg, keep)
            out[case] = {"factor": factor, "capacity": cap,
                         "dropped": _dropped(rec), "y_rel_err": _rel(y, ref)}
            torch.testing.assert_close(y, ref, **MOE_TOL)
            del y, ref
        load = torch.bincount(rec["topi"][0].reshape(-1),
                              minlength=cfg.n_experts)
    torch.cuda.synchronize()
    out.update(max_load=int(load.max()), mean_load=float(load.float().mean()),
               aux=float(aux), aux_rel_err=abs(float(aux) - float(aux_d))
               / float(aux_d))
    log(f"{name} layer 0 MoE ({cfg.n_experts} experts, top {cfg.top_k}), "
        f"B 1, T {MOE_T}, f32: expert load max {out['max_load']} (mean "
        f"{out['mean_load']:.1f}); by capacity factor, pairs dropped of "
        f"{out['pairs']} and the grouped form against the dense oracle "
        f"(with the dropped pairs' weights at 0) max |a - b| / max |b|: "
        + "; ".join(f"{k} {v['factor']:g} (capacity {v['capacity']}): "
                    f"{v['dropped']} dropped, {v['y_rel_err']:.3e}"
                    for k, v in out.items() if isinstance(v, dict))
        + f"; aux {out['aux']:.6f} against the oracle's (rel "
        f"{out['aux_rel_err']:.2e})")
    assert out["ample"]["dropped"] == 0, "a pair dropped at capacity T + 8"
    assert out["low"]["dropped"] > 0, "no queue overflowed at the low factor"
    assert out["aux_rel_err"] <= MOE_AUX_REL, out
    gy = torch.randn(x.shape, device=DEV,
                     generator=torch.Generator(device=DEV).manual_seed(17))
    cap = out["config"]["capacity"]

    def run(fn):
        live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xl = x.clone().requires_grad_(True)
        y, aux = fn(live, xl)
        (torch.sum(y * gy) + aux).backward()
        return [y.detach(), aux.detach(), xl.grad] + \
            [live[k].grad for k in sorted(live)]

    def dense(live, xl):
        with torch.no_grad():
            _, topi, _ = moe._route(live["router"], xl[0], cfg)
            keep = _keep_token_major(topi, cfg.n_experts, cap)
        return _moe_dense_kept(live, xl, cfg, keep), \
            moe._route(live["router"], xl[0], cfg)[2]

    grouped = lambda live, xl: moe.apply_moe(live, xl, cfg)  # noqa: E731
    first, again = run(grouped), run(grouped)
    bitwise = all(torch.equal(a, b) for a, b in zip(first, again))
    del again
    oracle = run(dense)
    worst, finite = {}, True
    for key, a, b in zip(["x"] + sorted(p), first[2:], oracle[2:]):
        finite = finite and bool(torch.isfinite(a).all())
        worst[key] = float((a - b).abs().max()) / float(b.abs().max())
    del first, oracle
    log(f"{name} layer 0 MoE at the config's capacity, gradients of x and "
        f"{len(p)} leaves, grouped against the oracle: finite {finite}; max "
        f"|a - b| / max |b| "
        f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} } (bound "
        f"{MOE_GRAD_REL}); forward and backward twice bit-identical "
        f"{bitwise}")
    assert finite and max(worst.values()) <= MOE_GRAD_REL, worst
    assert bitwise, "the grouped layer's forward or backward is not stable"
    out.update(grad_rel_err=worst, bitwise=bitwise)
    return out


def _moe_kernel_path(model, name):
    """17 (b): the full forward (B 1, T MOE_T, f32) through the kernels
    against ``plain=True``: the final hidden state within
    HIDDEN_REL_BOUND, the router loss within MOE_AUX_KERNEL_REL; one
    flash_attention launch a layer, counted; the routes of the two forms
    compared layer by layer and the pairs each drops counted."""
    cfg = model.cfg
    tokens = torch.from_numpy(np.random.RandomState(18).randint(
        0, cfg.vocab_size, (1, MOE_T))).to(DEV)
    with torch.inference_mode():
        with _moe_routes() as rk:
            _reset_counts()
            h_k, aux_k = model.hidden({"tokens": tokens})
            torch.cuda.synchronize()
            counts = _counts()
        with _moe_routes() as rp:
            h_p, aux_p = model.hidden({"tokens": tokens}, plain=True)
    moved = sum(int((a != b).any(-1).sum()) for a, b in zip(rk["topi"],
                                                           rp["topi"]))
    rel = _rel(h_k, h_p)
    aux_k, aux_p = float(aux_k["moe_aux"]), float(aux_p["moe_aux"])
    aux_rel = abs(aux_k - aux_p) / aux_p
    expect = dict.fromkeys(KERNEL_WRAPPERS, 0)
    expect["flash_attention"] = cfg.n_layers
    drops = (_dropped(rk), _dropped(rp))
    log(f"{name} forward at {cfg.n_layers} layers, B 1, T {MOE_T}, f32: "
        f"hidden through the kernels against plain max |a - b| / max |b| "
        f"{rel:.3e} (bound {HIDDEN_REL_BOUND}); router loss {aux_k:.6f} "
        f"against {aux_p:.6f} (rel {aux_rel:.2e}, bound "
        f"{MOE_AUX_KERNEL_REL}); tokens routed apart {moved} of "
        f"{MOE_T * cfg.n_layers} token-layers; pairs dropped {drops}; "
        f"launches { {k: v for k, v in counts.items() if v} }")
    assert counts == expect, f"{name}: launches {counts}, expected {expect}"
    assert rel <= HIDDEN_REL_BOUND and aux_rel <= MOE_AUX_KERNEL_REL, \
        f"{name}: the kernel path left the plain forward"
    return {"rel_err": rel, "aux": aux_k, "aux_rel_err": aux_rel,
            "routed_apart": moved, "dropped": list(drops),
            "launches": counts["flash_attention"]}


def _moe_kinds(fn):
    """Device ms of one call of ``fn`` by kind, for the moe family, from
    the kernels each aten operation launched: attention
    (flash_attention's kernels), expert GEMMs (``aten::bmm``, which only
    the expert layer calls), other GEMMs (``aten::mm``: projections,
    router), dispatch and combine (``aten::index_put_``, ``aten::index``;
    the embedding lookup is one ``aten::index`` too), the queue places'
    scan (``aten::cumsum``), the router's sort (``aten::sort``), the rest,
    and the busy total. None when the profiler records no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = attention_ms = 0.0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms = (ev.time_range.end - ev.time_range.start) / 1e3
            busy += ms
            if _category(ev.name) == "flash_attention":
                attention_ms += ms
    if not busy:
        return None
    kinds = {"expert_gemm": ("aten::bmm",), "other_gemm": ("aten::mm",),
             "dispatch_combine": ("aten::index_put_", "aten::index"),
             "queue_scan": ("aten::cumsum",), "route_sort": ("aten::sort",)}
    split = dict.fromkeys(kinds, 0.0)
    for ev in prof.key_averages():
        for kind, ops in kinds.items():
            if ev.key in ops:
                split[kind] += (getattr(ev, "device_time_total", 0)
                                or 0) / 1e3
    split["attention"] = attention_ms
    split["other"] = busy - sum(split.values())
    split["busy"] = busy
    return {k: round(v, 3) for k, v in split.items()}


def _layer0_flash_parity(model, batch):
    """flash_attention on layer 0's real q, k, v of a service batch
    (tokens, or frame / patch embeddings, through ``Model._embed_inputs``
    and the first norm, at the model's activations, causal as the config)
    against attention_ref, as phase 9's gemma check: granite-moe's GQA
    16/8 at Dh 64, qwen3-moe's GQA 32/4 at Dh 128, pixtral's GQA 32/8 at
    Dh 128 (causal), hubert's MHA 16/16 at Dh 80 (non-causal)."""
    cfg = model.cfg
    with torch.inference_mode():
        x = model._embed_inputs({"embedding": model.embedding}, batch,
                                getattr(torch, cfg.dtype))
        h = common.apply_norm(model.blocks[0]["norm1"], x, cfg)
        positions = torch.arange(x.shape[1], device=DEV)[None].expand(
            x.shape[0], -1)
        q, k, v = attention.qkv_proj(model.blocks[0]["attn"], h, positions,
                                     cfg)
        del x, h
        err, top, worst = check_flash(q, k, v, cfg.causal, 0)
    log(f"{cfg.name} parity flash_attention {str(q.dtype)[6:]} on layer "
        f"0's q, k, v of a service batch, q {tuple(q.shape)}, k "
        f"{tuple(k.shape)}, causal {cfg.causal}: max |d| {err:.3e} (max "
        f"|ref| {top:.4f}), {worst:.3f} of the bound")
    return {"shape": list(q.shape) + [k.shape[2]], "max_abs_err": err,
            "of_bound": worst}


def _moe_service_batch(model):
    """17 (f): one service batch of MOE_BATCH x MOE_SEQ tokens through
    ``serve_embeddings.embed`` at the model's activations, timed after a
    warm call (host clock, synchronised): one flash_attention launch a
    layer, finite embeddings; first, flash_attention on the batch's
    layer-0 q, k, v against attention_ref."""
    cfg = model.cfg
    toks = serve_embeddings.token_batches(
        cfg.vocab_size, MOE_BATCH, MOE_SEQ, MOE_BATCH,
        np.random.RandomState(19))[0]
    parity = _layer0_flash_parity(
        model, {"tokens": torch.from_numpy(toks).to(DEV)})
    torch.cuda.empty_cache()
    serve_embeddings.embed(model, toks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    emb = serve_embeddings.embed(model, toks)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: v for k, v in _counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = {"batch_ms": 1e3 * secs, "tokens_per_s": toks.size / secs,
           "peak_gb": peak, "launches": counts, "flash_parity": parity}
    log(f"{cfg.name} service batch of {MOE_BATCH} x {MOE_SEQ} tokens "
        f"({cfg.dtype} activations, {cfg.n_layers} layers): "
        f"{out['batch_ms']:.1f} ms, {out['tokens_per_s']:.0f} tokens/s, "
        f"peak memory {peak:.2f} GB; launches {counts}")
    assert counts == {"flash_attention": cfg.n_layers}, counts
    assert emb.shape == (MOE_BATCH, cfg.d_model)
    assert bool(torch.isfinite(emb).all())
    return out


def _moe_qwen():
    """17 (f): qwen3-moe-30b-a3b at full width, cut to MOE_QWEN_LAYERS
    layers (or the deepest cut that fits): (a)-(c) as for granite-moe,
    one timed service batch at bf16, and three training steps cut to
    MOE_QWEN_TRAIN_LAYERS layers (the first loss against apply's, every
    leaf finite and moved)."""
    t0 = time.perf_counter()
    full = get_config(MOE_QWEN)
    d, E, f, V = full.d_model, full.n_experts, full.d_ff, full.vocab_size
    hd, kvd = full.n_heads * full.dim_per_head, \
        full.kv_heads * full.dim_per_head
    layer_gb = 4 * (2 * d * hd + 2 * d * kvd + 3 * E * d * f + d * E) / 1e9
    emb_gb = 4 * 2 * V * d / 1e9
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    fit = int((free_gb - emb_gb - MOE_QWEN_HEADROOM_GB) // layer_gb)
    layers = max(1, min(MOE_QWEN_LAYERS, fit))
    cfg = full.replace(n_layers=layers, dtype="float32")
    model = Model(cfg, device=DEV, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{MOE_QWEN}: full width cut to {layers} of {full.n_layers} layers "
        f"({free_gb:.1f} GB free, {layer_gb:.2f} GB a layer), "
        f"{n_params / 1e9:.3f}B parameters ({4 * n_params / 1e9:.1f} GB "
        f"f32) from the seeded init in {time.perf_counter() - t0:.1f}s")
    out = {"layers": layers, "params": n_params,
           "layer0": _moe_layer_checks(model, MOE_QWEN),
           "forward": _moe_kernel_path(model, MOE_QWEN)}
    prompts = torch.from_numpy(np.random.RandomState(20).randint(
        0, V, (DECODE_B, DECODE_PROMPT))).to(DEV)
    torch.cuda.reset_peak_memory_stats()
    out["decode"] = _hold_decode(model, prompts,
                                 f"{MOE_QWEN} decode ({layers} layers)")
    out["decode"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    served = Model(full.replace(n_layers=layers), device=DEV,
                   params=model.param_tree())
    out["service_batch"] = _moe_service_batch(served)
    del model, served
    gc.collect()
    torch.cuda.empty_cache()
    out["training"] = _train_checked(
        MOE_QWEN, full.replace(n_layers=MOE_QWEN_TRAIN_LAYERS,
                               dtype="float32"),
        {"flash_attention": MOE_QWEN_TRAIN_LAYERS}, ZTRAIN_LR,
        f"{MOE_QWEN} training cut to {MOE_QWEN_TRAIN_LAYERS} layers",
        steps=MOE_QWEN_TRAIN_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    return out


def phase_moe():
    """Phase 17: the moe family from the port's seeded init, f32
    weights. granite-moe-1b-a400m at full width and depth (24 layers,
    d_model 1024, GQA 16/8 at Dh 64, 32 experts top 8, expert d_ff 512,
    vocab 49,155, tied): (a) layer 0's MoE, (b) the kernel path against
    the plain forward, (c) decode held against ``apply`` in f32, then the
    bf16 loop timed and profiled, (d) training at full depth, (e) the
    embedding service at 4,096 tokens a sequence, its flash_attention
    held to attention_ref on a batch's layer-0 q, k, v; then (f)
    qwen3-moe-30b cut in depth. The expert layer is plain torch;
    attention runs on flash_attention and the ranking on
    pairwise_sqdist."""
    t_phase = time.perf_counter()
    cfg = get_config(MOE).replace(dtype="float32")
    model = Model(cfg, device=DEV, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{MOE}: {cfg.n_layers} layers, {n_params / 1e9:.3f}B parameters "
        f"({4 * n_params / 1e9:.1f} GB f32) from the seeded init in "
        f"{time.perf_counter() - t_phase:.1f}s")
    g = {"params": n_params, "layer0": _moe_layer_checks(model, MOE),
         "forward": _moe_kernel_path(model, MOE)}
    prompts = torch.from_numpy(np.random.RandomState(21).randint(
        0, cfg.vocab_size, (DECODE_B, DECODE_PROMPT))).to(DEV)
    g["decode"] = _hold_decode(model, prompts, f"{MOE} decode")
    served = Model(get_config(MOE), device=DEV, params=model.param_tree())
    timing = _time_decode(served, prompts)
    log(f"{MOE} serving loop ({served.cfg.dtype} activations, f32 weights),"
        f" B {DECODE_B}: prefill {timing['prefill_ms']:.1f} ms for "
        f"{DECODE_PROMPT} tokens, {timing['ms_per_token']:.2f} ms/token, "
        f"{timing['tokens_per_s']:.1f} tokens/s, peak memory "
        f"{timing['peak_gb']:.2f} GB")
    g["decode"]["serve_bf16"] = timing
    del model, served
    gc.collect()
    torch.cuda.empty_cache()
    g["training"] = _train_checked(MOE, cfg,
                                   {"flash_attention": cfg.n_layers},
                                   ZTRAIN_LR, f"{MOE} training at full depth")
    gc.collect()
    torch.cuda.empty_cache()
    svc_model, requests, g["service"] = phase_embedding_service(
        MOE, seq=MOE_SEQ, batch=MOE_BATCH, corpus_seqs=MOE_CORPUS,
        request_batches=MOE_REQUESTS)
    split = _moe_kinds(lambda: serve_embeddings.embed(svc_model,
                                                      requests[0]))
    log(f"{MOE} one request batch's forward on the card, device ms by "
        f"kind: " + ("not measured" if split is None else
                     f"{split} (batch p50 {g['service']['p50_ms']:.1f} ms "
                     f"host clock)"))
    g["service"]["device_ms_by_kind"] = split
    g["service"]["flash_parity"] = _layer0_flash_parity(
        svc_model, {"tokens": torch.from_numpy(requests[0]).to(DEV)})
    del svc_model, requests
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{MOE} done at {time.perf_counter() - t_phase:.1f} s of phase 17")
    out = {MOE: g, MOE_QWEN: _moe_qwen()}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"moe phase {out['phase_s']:.1f} s")
    return out


def _moe_launches(moe_out):
    """flash_attention's launches in phase 17, by run."""
    out = {}
    for name in (MOE, MOE_QWEN):
        res = moe_out[name]
        out[f"{name}_forward"] = res["forward"]["launches"]
        out[f"{name}_decode_apply"] = \
            res["decode"]["apply_launches"]["flash_attention"]
        out[f"{name}_train_first_step"] = \
            res["training"]["apply_launches"]["flash_attention"]
    out[f"{MOE}_service"] = \
        moe_out[MOE]["service"]["launches"]["flash_attention"]
    out[f"{MOE_QWEN}_service_batch"] = \
        moe_out[MOE_QWEN]["service_batch"]["launches"]["flash_attention"]
    return out


# -- the vlm and audio families: pixtral-12b and hubert-xlarge (18) -----------

# phase 18: pixtral-12b at full width and depth (f32, 49.1 GB), its training
# cut to VLM_TRAIN_LAYERS of 40 layers (f32 params, grads and two moments
# at full depth would be 196 GB); hubert-xlarge at full width and depth.
# Every leaf the init leaves constant (biases at 0, norm scales at 1) is
# given seeded N(0, 0.1^2) noise first, so no bias is held at zero. The
# forwards through the kernels against plain=True within HIDDEN_REL_BOUND
# / EMBED_REL_BOUND; the first training loss against apply within
# VLM_LOSS_REL; the services on embedding_stream's frame / patch batches
# (pixtral VLM_BATCH x VLM_SEQ, hubert AUDIO_BATCH x AUDIO_SEQ, bf16
# activations), one hubert forward at AUDIO_LONG_T (prefill_32k's T, its
# batch cut from 32 to 1); flash_attention alone at both services' shapes.
# The launcher's frame / patch batches draw labels uniformly over the
# vocabulary, independent of the inputs, so training can only take the
# logits from the init's spread toward uniform: pixtral's init starts
# about 1 nat above ln V (logits of std 0.02 sqrt(5120)), hubert's about
# 0.26 nat (0.02 sqrt(1280)). AdamW's first step moves every weight by
# about lr, which at hubert's 48 layers and ZTRAIN_LR lifts the loss
# more than the 0.26 nat four more steps recover (6.478 -> 6.540 on the
# card); hubert trains at AUDIO_LR, launch/train.py's default --lr
VLM, AUDIO = "pixtral-12b", "hubert-xlarge"
VLM_T = 2048
VLM_TRAIN_LAYERS, VLM_TRAIN_SHAPE, VLM_TRAIN_STEPS = 2, (1, 512), 5
VLM_SEQ, VLM_BATCH, VLM_CORPUS, VLM_REQUESTS = 4096, 2, 8, 8
VLM_LOSS_REL = 1e-6
AUDIO_SHAPE, AUDIO_TRAIN_STEPS, AUDIO_LR = (4, 1500), 5, 3e-4
AUDIO_SEQ, AUDIO_BATCH, AUDIO_CORPUS, AUDIO_REQUESTS = 4096, 8, 16, 8
AUDIO_LONG_T = 32768
# the bidirectional check: the frames from AUDIO_CUT on moved, the
# positions before it must move by more than this share of max |h|
AUDIO_CUT, AUDIO_MOVED_REL = 750, 1e-3


def _perturb_constant(model, seed):
    """Seeded N(0, 0.1^2) noise on every parameter the init leaves
    constant (biases at 0, norm scales at 1), in place; returns how many
    leaves it moved."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    moved = 0
    with torch.no_grad():
        for p in model.parameters():
            if p.numel() > 1 and bool((p == p.reshape(-1)[0]).all()):
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device=DEV))
                moved += 1
    return moved


def _frames(cfg, batch, seq, n_batches, seed):
    """``n_batches`` frame / patch embedding batches (batch, seq,
    d_model) f32 from ``data/tokens.embedding_stream`` on the card."""
    stream = embedding_stream(cfg.d_model, batch, seq, seed=seed, device=DEV)
    return [next(stream)["embeddings"] for _ in range(n_batches)]


def _frame_forward(model, frames, what):
    """(a), (f): the f32 forward on frame / patch embeddings through the
    kernels (one flash_attention launch a layer, counted) against
    plain=True: the final hidden state within HIDDEN_REL_BOUND and
    embed_pool within EMBED_REL_BOUND, as max |a - b| / max |b|."""
    cfg = model.cfg
    batch = {"embeddings": frames}
    with torch.inference_mode():
        _reset_counts()
        t0 = time.perf_counter()
        h_k, _ = model.hidden(batch)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        counts = {k: v for k, v in _counts().items() if v}
        t0 = time.perf_counter()
        h_p, _ = model.hidden(batch, plain=True)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
        assert bool(torch.isfinite(h_k).all())
        rel = {"hidden": _rel(h_k, h_p)}
        del h_k, h_p
        rel["embed_pool"] = _rel(model.embed_pool(batch),
                                 model.embed_pool(batch, plain=True))
    B, T, _ = frames.shape
    log(f"{what}: f32 forward on frame / patch embeddings, {cfg.n_layers} "
        f"layers, B {B}, T {T}: through the kernels {t_k:.2f} s, plain "
        f"{t_p:.2f} s (host clock); max |a - b| / max |b|: final hidden "
        f"state {rel['hidden']:.3e} (bound {HIDDEN_REL_BOUND}), embed_pool "
        f"{rel['embed_pool']:.3e} (bound {EMBED_REL_BOUND}); launches {counts}")
    assert counts == {"flash_attention": cfg.n_layers}, counts
    assert rel["hidden"] <= HIDDEN_REL_BOUND and \
        rel["embed_pool"] <= EMBED_REL_BOUND, f"{what}: kernels left plain"
    return {**rel, "kernel_s": t_k, "plain_s": t_p,
            "launches": counts["flash_attention"]}


def _bidirectional(model, frames):
    """(f): hubert's encoder sees both ways: with the frames from
    AUDIO_CUT on moved, the positions before it move too (through the
    kernels); the moved share printed."""
    rng = torch.Generator(device=DEV).manual_seed(23)
    moved = frames.clone()
    moved[:, AUDIO_CUT:] += torch.randn(moved[:, AUDIO_CUT:].shape,
                                        generator=rng, device=DEV)
    with torch.inference_mode():
        h1, _ = model.hidden({"embeddings": frames})
        h2, _ = model.hidden({"embeddings": moved})
    early = float((h1[:, :AUDIO_CUT] - h2[:, :AUDIO_CUT]).abs().max()
                  / h1.abs().max())
    late = float((h1[:, AUDIO_CUT:] - h2[:, AUDIO_CUT:]).abs().max()
                 / h1.abs().max())
    log(f"{AUDIO} bidirectional: frames {AUDIO_CUT}+ moved; positions "
        f"before {AUDIO_CUT} move by {early:.3e} of max |h| (must pass "
        f"{AUDIO_MOVED_REL}), those after by {late:.3e}")
    assert early > AUDIO_MOVED_REL, "the encoder did not see ahead"
    return {"early_rel": early, "late_rel": late}


def _service_model(model, seed=0):
    """The config's bf16 activations over ``model``'s f32 weights (shared,
    not copied) and a seeded (EMB_PROJ, d_model) L, as
    ``serve_embeddings.build`` makes it."""
    cfg = get_config(model.cfg.name)
    served = Model(cfg, device=DEV, params=model.param_tree())
    L = dml.init_params(dml.DMLConfig(feat_dim=cfg.d_model,
                                      proj_dim=EMB_PROJ),
                        torch.Generator(device=DEV).manual_seed(seed + 7),
                        DEV)
    return served, L


def _phase_vlm():
    """18 (a)-(e): pixtral-12b."""
    t0 = time.perf_counter()
    cfg = get_config(VLM).replace(dtype="float32")
    model = Model(cfg, device=DEV, seed=0)
    moved = _perturb_constant(model, 24)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{VLM}: {cfg.n_layers} layers, d_model {cfg.d_model}, GQA "
        f"{cfg.n_heads}/{cfg.kv_heads} at Dh {cfg.dim_per_head}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}: {n_params / 1e9:.3f}B "
        f"parameters ({4 * n_params / 1e9:.1f} GB f32) from the seeded init "
        f"({moved} constant leaves given noise) in "
        f"{time.perf_counter() - t0:.1f}s")
    out = {"params": n_params, "forward": _frame_forward(
        model, _frames(cfg, 1, VLM_T, 1, 25)[0], f"{VLM} (a)")}
    prompts = torch.from_numpy(np.random.RandomState(26).randint(
        0, cfg.vocab_size, (DECODE_B, DECODE_PROMPT))).to(DEV)
    torch.cuda.reset_peak_memory_stats()
    out["decode"] = _hold_decode(model, prompts, f"{VLM} (b) decode on "
                                                 f"tokens")
    served, L = _service_model(model)
    timing = _time_decode(served, prompts)
    log(f"{VLM} serving loop ({served.cfg.dtype} activations, f32 weights),"
        f" B {DECODE_B}: prefill {timing['prefill_ms']:.1f} ms for "
        f"{DECODE_PROMPT} tokens, {timing['ms_per_token']:.2f} ms/token, "
        f"{timing['tokens_per_s']:.1f} tokens/s, peak memory "
        f"{timing['peak_gb']:.2f} GB")
    out["decode"]["serve_bf16"] = timing
    frames = _frames(served.cfg, VLM_BATCH, VLM_SEQ,
                     VLM_CORPUS // VLM_BATCH + VLM_REQUESTS, 27)
    out["flash_parity"] = _layer0_flash_parity(served,
                                               {"embeddings": frames[-1]})
    batches = [{"embeddings": e} for e in frames]
    out["service"] = _serve_checked(
        served, L, batches[:-VLM_REQUESTS], batches[-VLM_REQUESTS:],
        f"{VLM} (d) service on patch batches (bf16 activations)")
    del model, served, frames, batches, L
    gc.collect()
    torch.cuda.empty_cache()
    out["training"] = _train_checked(
        VLM, cfg.replace(n_layers=VLM_TRAIN_LAYERS),
        {"flash_attention": VLM_TRAIN_LAYERS}, ZTRAIN_LR,
        f"{VLM} (c) training cut to {VLM_TRAIN_LAYERS} layers on patch "
        f"embeddings", steps=VLM_TRAIN_STEPS, shape=VLM_TRAIN_SHAPE,
        loss_rel=VLM_LOSS_REL, perturb_seed=33)
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    return out


def _phase_audio():
    """18 (f)-(j): hubert-xlarge."""
    t0 = time.perf_counter()
    cfg = get_config(AUDIO).replace(dtype="float32")
    model = Model(cfg, device=DEV, seed=0)
    moved = _perturb_constant(model, 28)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{AUDIO}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.dim_per_head}, non-causal, "
        f"{cfg.norm_kind}, {cfg.mlp_kind}, attention biases: "
        f"{n_params / 1e9:.3f}B parameters ({4 * n_params / 1e9:.2f} GB "
        f"f32) from the seeded init ({moved} constant leaves given noise) "
        f"in {time.perf_counter() - t0:.1f}s")
    frames = _frames(cfg, *AUDIO_SHAPE, 1, 29)[0]
    out = {"params": n_params,
           "forward": _frame_forward(model, frames, f"{AUDIO} (f)"),
           "bidirectional": _bidirectional(model, frames)}
    try:
        model.init_decode_cache(DECODE_B, 16)
    except ValueError as e:                 # (g) encoder-only
        out["decode"] = str(e)
    assert "encoder-only" in out.get("decode", ""), \
        f"{AUDIO}: init_decode_cache did not refuse"
    log(f"{AUDIO} (g): init_decode_cache raises: {out['decode']}")
    served, L = _service_model(model)
    frames = _frames(served.cfg, AUDIO_BATCH, AUDIO_SEQ,
                     AUDIO_CORPUS // AUDIO_BATCH + AUDIO_REQUESTS, 30)
    out["flash_parity"] = _layer0_flash_parity(served,
                                               {"embeddings": frames[-1]})
    batches = [{"embeddings": e} for e in frames]
    out["service"] = _serve_checked(
        served, L, batches[:-AUDIO_REQUESTS], batches[-AUDIO_REQUESTS:],
        f"{AUDIO} (i) service on frame batches (bf16 activations)")
    del frames, batches
    long = _frames(served.cfg, 1, AUDIO_LONG_T, 1, 31)[0]
    with torch.inference_mode():
        served.embed_pool({"embeddings": long[:, :AUDIO_SEQ]})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t1 = time.perf_counter()
        emb = served.embed_pool({"embeddings": long})
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
    counts = {k: v for k, v in _counts().items() if v}
    assert counts == {"flash_attention": cfg.n_layers}, counts
    assert emb.shape == (1, cfg.d_model) and bool(torch.isfinite(emb).all())
    parts = device_breakdown(lambda: served.embed_pool({"embeddings": long}))
    flash_share = None
    if parts:
        flash_share = sum(ms for name, ms in parts.items()
                          if _category(name) == "flash_attention") \
            / sum(parts.values())
    out["long"] = {"T": AUDIO_LONG_T, "ms": 1e3 * secs,
                   "tokens_per_s": AUDIO_LONG_T / secs,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "launches": counts["flash_attention"],
                   "flash_share": flash_share}
    log(f"{AUDIO} (i) one forward of B 1 x T {AUDIO_LONG_T} (bf16): "
        f"{1e3 * secs:.1f} ms, {AUDIO_LONG_T / secs:.0f} tokens/s, peak "
        f"memory {out['long']['peak_gb']:.2f} GB, launches {counts}; "
        f"flash_attention's share of device time "
        + ("not measured" if flash_share is None else f"{flash_share:.1%}"))
    del model, served, long, L
    gc.collect()
    torch.cuda.empty_cache()
    out["training"] = _train_checked(
        AUDIO, cfg, {"flash_attention": cfg.n_layers}, AUDIO_LR,
        f"{AUDIO} (h) training at full depth on frame embeddings",
        steps=AUDIO_TRAIN_STEPS, shape=AUDIO_SHAPE, loss_rel=VLM_LOSS_REL,
        perturb_seed=34)
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    return out


def time_frame_attention(vlm, audio):
    """flash_attention alone at both services' shapes on seeded random q,
    k, v (bf16): hubert's (B AUDIO_BATCH, T AUDIO_SEQ, 16 heads of 80,
    non-causal) and pixtral's (B VLM_BATCH, T VLM_SEQ, GQA 32/8 at Dh
    128, causal); kernel, plain version and one
    ``scaled_dot_product_attention`` call by CUDA-graph replay; the
    kernels-line entries, with each model's launches in phase 18."""
    entries = []
    for res, name, B, T in ((audio, AUDIO, AUDIO_BATCH, AUDIO_SEQ),
                            (vlm, VLM, VLM_BATCH, VLM_SEQ)):
        cfg = get_config(name)
        H, K, dh, causal = cfg.n_heads, cfg.kv_heads, cfg.dim_per_head, \
            cfg.causal
        gen = torch.Generator(device=DEV).manual_seed(32)
        q = torch.randn((B, T, H, dh), generator=gen, device=DEV).to(
            torch.bfloat16)
        k, v = (torch.randn((B, T, K, dh), generator=gen, device=DEV).to(
            torch.bfloat16) for _ in range(2))
        fn = lambda: flash_attention(q, k, v, causal=causal)  # noqa: E731
        plain = lambda: attention_ref(q, k, v, causal=causal)  # noqa: E731
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=K != H)
        with torch.inference_mode():
            eager, graphed, best = _device_times(fn, plain, lib, (10, 2, 10))
        pairs = T * (T + 1) // 2 if causal else T * T
        b_ms, b_by = roofline(4.0 * dh * pairs * B * H,
                              2.0 * (2 * q.numel() + 2 * k.numel()),
                              PEAK_BF16_FLOPS)
        fmt = lambda x: "-" if x is None else f"{x:.3f}"  # noqa: E731
        log(f"flash_attention {name} service shape B={B} T={T} H={H} K={K} "
            f"Dh={dh} causal {causal} (bf16): device ms by graph replay: "
            f"kernel {fmt(graphed['ms'])}, plain {fmt(graphed['plain_ms'])},"
            f" library {fmt(graphed['library_ms'])}; eager: kernel "
            f"{fmt(eager['ms'])}, plain {fmt(eager['plain_ms'])}, library "
            f"{fmt(eager['library_ms'])}; bound {b_ms:.3f} ms ({b_by}), "
            f"{b_ms / best['ms']:.1%} of bound")
        launches = {"forward": res["forward"]["launches"],
                    "service": res["service"]["launches"]["flash_attention"],
                    "train_first_step": res["training"]["apply_launches"][
                        "flash_attention"]}
        if name == VLM:
            launches["decode_apply"] = \
                res["decode"]["apply_launches"]["flash_attention"]
        else:
            launches["long"] = res["long"]["launches"]
        entries.append({
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:80",
            "launches": sum(launches.values()),
            "max_abs_err": res["flash_parity"]["max_abs_err"], **best,
            "bound_ms": b_ms, "bound_by": b_by, "eager_ms": eager,
            "graph_ms": graphed, "launches_by_run": launches,
            "shape": {"B": B, "T": T, "H": H, "K": K, "Dh": dh,
                      "causal": causal, "window": 0, "config": name,
                      "pairs_per_head": pairs}})
        del q, k, v
        torch.cuda.empty_cache()
    return entries


def phase_vlm_audio():
    """Phase 18: the vlm and audio families from the port's seeded init,
    f32 weights, constant leaves given noise. pixtral-12b at full width
    and depth (40 layers, d_model 5120, GQA 32/8 at Dh 128, d_ff 14336,
    vocab 131,072, RoPE at 1e9): (a) the forward on patch embeddings
    against plain, (b) decode on tokens against apply, then the bf16 loop
    timed and profiled, (d) and (e) the service on patch batches and
    flash_attention on its layer-0 q, k, v, (c) training cut to 2 layers
    on the launcher's patch batches; hubert-xlarge at full width and
    depth (48 layers, d_model 1280, 16 heads of 80, non-causal, attention
    biases): (f) the forward on frame embeddings against plain and the
    bidirectional check, (g) no decode, (i) and (j) the service on frame
    batches, one forward at T 32,768 and flash_attention on a batch's
    layer-0 q, k, v, (h) training at full depth; then flash_attention
    alone at both services' shapes."""
    t0 = time.perf_counter()
    out = {VLM: _phase_vlm()}
    log(f"{VLM} done at {time.perf_counter() - t0:.1f} s of phase 18")
    out[AUDIO] = _phase_audio()
    log(f"{AUDIO} done at {time.perf_counter() - t0:.1f} s of phase 18")
    entries = time_frame_attention(out[VLM], out[AUDIO])
    out["phase_s"] = time.perf_counter() - t0
    log(f"vlm and audio phase {out['phase_s']:.1f} s")
    return out, entries

# phase 19: the dry-run account (launch/dryrun.py). (a) The records of a
# subset of the registry's arch x shape pairs that holds every family and
# every mode, and of the paper's three DML configs, traced on meta tensors
# in a pool of ACCOUNT_JOBS processes (the --all sweep takes tens of
# minutes of host time: ``python -m repro_torch.launch.dryrun --all
# --jobs 8``). The prefill pair takes attention chunks of 8192
# (ACCOUNT_CHUNKS), which leaves its FLOPs as they are (the full T x S
# product either way) and cuts its tiles 64-fold. (b) The account of
# three steps the card runs, at shapes earlier phases run, held against
# the card: the step's
# host time (median of ACCOUNT_STEPS calls from the same state, each
# ended by a sync) must be at least the account's compute_s; the step's
# peak on the card (max_memory_allocated over those calls less what was
# allocated before its state and batch were built) at least its
# argument_size, and the account's peak within PEAK_RATIO_BAND of it
# (0.971-0.989 at the three steps run alone, NVIDIA H100 80GB HBM3).
ACCOUNT_CHUNKS = {"attn_q_chunk": 8192, "attn_kv_chunk": 8192}
ACCOUNT_SUBSET = [("smollm-135m", "train_4k", None),
                  ("granite-moe-1b-a400m", "train_4k", None),
                  ("smollm-135m", "prefill_32k", ACCOUNT_CHUNKS),
                  ("yi-6b", "decode_32k", None),
                  ("zamba2-2.7b", "decode_32k", None),
                  ("rwkv6-1.6b", "long_500k", None),
                  ("pixtral-12b", "decode_32k", None),
                  ("hubert-xlarge", "train_4k", None),
                  ("hubert-xlarge", "long_500k", None)]
ACCOUNT_JOBS = 2             # beside phases 12-18, with 22-24's pools
ACCOUNT_STEPS = 3
PEAK_RATIO_BAND = (0.9, 1.02)


# the pools that trace records on meta (19 (a), 22 (a)-24 (a)) run beside
# phases 12-21, whose host thread drives the card: their processes run at
# a lower priority, so that the card's launches come first
POOL_NICE = 10


def meta_pool(n):
    """A pool of ``n`` spawned processes at POOL_NICE."""
    return multiprocessing.get_context("spawn").Pool(
        n, initializer=os.nice, initargs=(POOL_NICE,))


def account_sweep_start():
    """19 (a), started: the subset's records and the DML configs' in a
    pool of ACCOUNT_JOBS processes beside the card's phases (meta
    tensors: no card)."""
    pool = meta_pool(ACCOUNT_JOBS)
    jobs = [pool.apply_async(dryrun._record, (dryrun.Job(a, s, ov), "h100"))
            for a, s, ov in ACCOUNT_SUBSET]
    dml = pool.apply_async(dryrun.dryrun_dml)
    pool.close()
    return {"pool": pool, "jobs": jobs, "dml": dml,
            "t0": time.perf_counter()}


def _account_subset(started=None):
    """19 (a), collected (started here if ``started`` is None): a line a
    record."""
    started = started or account_sweep_start()
    t_wait = time.perf_counter()
    records = {}
    for job in started["jobs"]:
        key, rec = job.get(timeout=RK_TIMEOUT)
        assert rec["status"] in ("ok", "skipped"), f"{key}: {rec}"
        log(dryrun.summary_line(key, rec))
        records[key] = rec
    for name, rec in started["dml"].get(timeout=RK_TIMEOUT).items():
        records[f"{name}|paper_batch"] = rec
        log(dryrun.summary_line(f"{name}|paper_batch", rec))
    started["pool"].join()
    wait_s = time.perf_counter() - t_wait
    secs = time.perf_counter() - started["t0"]
    families = {get_config(a).family for a, s, _ in ACCOUNT_SUBSET}
    modes = {rec["mode"] for rec in records.values() if "mode" in rec}
    assert families == set(transformer.FAMILIES), families
    assert modes == {"train", "prefill", "decode"}, modes
    log(f"19 (a) account of {len(records)} records, collected {secs:.1f} s "
        f"after their start on {ACCOUNT_JOBS} processes beside phases "
        f"12-18; the phase waited {wait_s:.1f} s for them (card figures: "
        f"{card_figures.CARD})")
    return {"records": records, "sweep_s": secs, "wait_s": wait_s}


def _meta_like(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _gemm_kernels(prof, top=4):
    """The largest device kernels of a profiled step that ``_category``
    reads as matrix products (cuBLAS / CUTLASS), ms each."""
    parts = _by_kernel(prof) or {}
    gemm = {k: v for k, v in parts.items() if _category(k) == "gemm"}
    return dict(sorted(gemm.items(), key=lambda kv: -kv[1])[:top])


def _allocated_before():
    """The bytes allocated on the card before a held step's state and
    batch are built (what earlier phases still hold)."""
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _held(what, step, state, batch, acct, model_flops, dtype, before):
    """19 (b): time ``step(state, batch)`` and its peak memory on the
    card (less ``before``, ``_allocated_before``'s reading), hold them to
    the account ``acct`` of the same step, and print the ratios and the
    step's GEMM kernels."""
    step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(ACCOUNT_STEPS):
        t0 = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        del out
    card_peak = torch.cuda.max_memory_allocated()
    peak = card_peak - before
    ms = 1e3 * float(np.median(secs))
    _, _, busy, n_ops, prof = _profile_busy(lambda: step(state, batch))
    terms = acct["roofline"]
    rate = card_figures.PEAK_FLOPS_BY_DTYPE[dtype]
    res = {"ms": ms, "peak_bytes": peak, "allocated_before": before,
           "compute_s": terms["compute_s"],
           "memory_s": terms["memory_s"], "dominant": terms["dominant"],
           "flops": acct["flops_per_chip"],
           "flops_by_dtype": acct["flops_by_dtype"],
           "hbm_bytes": acct["hbm_bytes_per_chip"],
           "account_ops": acct["ops"], "device_ops": n_ops,
           "busy_ms": busy, "argument_size": acct["memory"]["argument_size"],
           "account_peak": acct["peak_bytes"],
           "peak_ratio": acct["peak_bytes"] / peak,
           "peak_ratio_whole_card": acct["peak_bytes"] / card_peak,
           "memory_s_ratio": 1e3 * terms["memory_s"] / ms,
           "compute_s_ratio": 1e3 * terms["compute_s"] / ms,
           "model_flops": model_flops, "rate": rate,
           "mfu": model_flops / (ms / 1e3 * rate),
           "gemm_kernels": _gemm_kernels(prof),
           "trace_s": acct["trace_s"]}
    log(f"{what}: {ms:.2f} ms a step (median of {ACCOUNT_STEPS}, host "
        f"clock), device busy "
        + ("not measured" if busy is None else f"{busy:.2f} ms")
        + f", {n_ops} device operations (account {acct['ops']} ops); "
        f"account {acct['flops_per_chip']:.4g} FLOP "
        f"{acct['flops_by_dtype']}, compute_s {1e3 * terms['compute_s']:.3f}"
        f" ms ({res['compute_s_ratio']:.3f} of the step), memory_s "
        f"{1e3 * terms['memory_s']:.3f} ms ({res['memory_s_ratio']:.3f} of "
        f"the step), {terms['dominant']}; peak: account "
        f"{acct['peak_bytes'] / 1e9:.3f} GB, card {peak / 1e9:.3f} GB "
        f"above the {before / 1e9:.3f} GB allocated before (ratio "
        f"{res['peak_ratio']:.3f}; {res['peak_ratio_whole_card']:.3f} of "
        f"max_memory_allocated), argument "
        f"{acct['memory']['argument_size'] / 1e9:.3f} GB; mfu "
        f"{res['mfu']:.4f} ({model_flops:.4g} model FLOP at {dtype}'s "
        f"{rate / 1e12:.0f} TFLOP/s); GEMM kernels {res['gemm_kernels']}; "
        f"traced in {acct['trace_s']:.1f} s")
    assert ms / 1e3 >= terms["compute_s"], \
        f"{what}: the card beat the account's compute bound"
    assert peak >= acct["memory"]["argument_size"], \
        f"{what}: the card held less than the step's arguments"
    lo, hi = PEAK_RATIO_BAND
    assert lo <= res["peak_ratio"] <= hi, \
        f"{what}: the account's peak is {res['peak_ratio']:.3f} of the card's"
    return res


def _lm_train_held(arch, cfg, lr, remat, shape, what, **batch_kw):
    """The training step ``launch/train.py`` builds, on the card and on
    meta (the account), at B x T ``shape``."""
    B, T = shape
    before = _allocated_before()
    model, step, state = train.build(arch, 2, lr=lr, remat=remat,
                                     device=DEV, cfg=cfg)
    batch = next(train.embedding_batches(cfg, B, T, device=DEV)
                 if cfg.input_kind == "embeddings" else
                 token_stream(cfg.vocab_size, B, T, device=DEV))
    _, mstep, mstate = train.build(arch, 2, lr=lr, remat=remat,
                                   device="meta", cfg=cfg)
    acct = dryrun.account(mstep, mstate, _meta_like(batch))
    mflops = dryrun.model_flops(cfg, InputShape("held", T, B, "train"))
    res = _held(what, step, state, batch, acct, mflops, cfg.dtype, before)
    del model, step, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _bsp_held(exp=IMNET_1M):
    """Phase 4's bsp PS step (P 4 x 1000 pairs, d 21504 -> k 1000): the
    dml_pair kernel's forward and the closed-form backward on the card;
    the account traces the plain forward (the same products)."""
    cfg = exp.dml
    opt = sgd(schedules.inverse_time(1e-3, 1e-3))
    ps = sync.PSConfig(n_workers=N_WORKERS, sync="bsp")

    def build(device, gen=None):
        L = init_params(cfg, gen, device) if gen is not None else \
            torch.empty((cfg.proj_dim, cfg.feat_dim), device=device)
        step = sync.make_train_step(
            lambda p, b: dml_pair_loss(p, b, lam=cfg.lam,
                                       margin=cfg.margin), opt, ps)
        return step, sync.init_state(opt, L, ps)

    before = _allocated_before()
    gen = torch.Generator(device=DEV).manual_seed(19)
    step, state = build(DEV, gen)
    P, B, d = N_WORKERS, exp.batch_size, cfg.feat_dim
    batch = {"xs": torch.randn(P, B, d, device=DEV, generator=gen),
             "ys": torch.randn(P, B, d, device=DEV, generator=gen),
             "sim": (torch.rand(P, B, device=DEV, generator=gen) < 0.5)
             .to(torch.int32)}
    mstep, mstate = build("meta")
    acct = dryrun.account(mstep, mstate, _meta_like(batch))
    # the model's work: the projection of each pair's difference and the
    # gradient of L, 2 P B d k each (no input gradient)
    mflops = 4.0 * P * B * d * cfg.proj_dim
    _reset_counts()
    res = _held(f"19 (b) {exp.name} bsp PS step (P {P} x {B} pairs, d {d} "
                f"-> k {cfg.proj_dim}, f32)", step, state, batch, acct,
                mflops, "float32", before)
    res["dml_pair_launches"] = dml_pair_fused.launches
    assert res["dml_pair_launches"] >= P * (ACCOUNT_STEPS + 2)
    del step, state, batch
    torch.cuda.empty_cache()
    return res


def phase_account(sweep=None):
    """Phase 19: the dry-run account, (a) on meta (``sweep``, from
    ``account_sweep_start``; started here if None), (b) held against the
    card."""
    t0 = time.perf_counter()
    out = _account_subset(sweep)
    out["held"] = {
        LM_ARCH: _lm_train_held(
            LM_ARCH, get_config(LM_ARCH), LM_LR, False, (LM_B, LM_T),
            f"19 (b) {LM_ARCH} training (B {LM_B}, T {LM_T}, bf16 "
            f"activations, launch/train.py's step)"),
        AUDIO: _lm_train_held(
            AUDIO, get_config(AUDIO).replace(dtype="float32"), AUDIO_LR,
            True, AUDIO_SHAPE,
            f"19 (b) {AUDIO} training (B {AUDIO_SHAPE[0]}, T "
            f"{AUDIO_SHAPE[1]}, f32, remat)"),
        IMNET_1M.name: _bsp_held()}
    out["phase_s"] = time.perf_counter() - t0
    log(f"account phase {out['phase_s']:.1f} s")
    return out


# -- phase 20: multi-rank, several ranks sharing the card --------------------

MR_RANKS = 4                 # ranks of the PS and the sharded gallery
MR_STEPS = 4                 # train_dml_distributed steps a mode
MR_TIMED = 3                 # timed PS steps a mode, after one warm step
MR_BATCHES = 4               # timed sharded query batches, after one warm
MR_QUERIES = MAX_BATCH       # phase 6's first 64 requests, one batch
MR_WIDE_K = 300              # a k_top past metric_topk's 256-entry lists
MR_CHUNK_SEED = 5
MR_TIMEOUT = 300.0           # each collective; the whole spawn twice that
# merged L over the ranks against the one-process port: the all-reduce
# sums the workers in another order than torch.mean, so they part by f32
# rounding; held within this share of max |L|
MR_L_RTOL = 1e-5
MR_MODES = {"bsp": {}, "local": {"tau": 4}, "ssp": {"staleness": 2}}


def _mr_cfg(mode, steps=MR_STEPS):
    return DMLTrainConfig(
        dml=IMNET_1M.dml, ps=sync.PSConfig(n_workers=MR_RANKS, sync=mode,
                                           **MR_MODES[mode]),
        batch_size=IMNET_1M.batch_size, steps=steps, log_every=1)


def _mr_opt():
    return sgd(schedules.inverse_time(1e-3, 1e-3))


def _mr_loss(L, batch):
    cfg = IMNET_1M.dml
    return dml_pair_loss(L, batch, lam=cfg.lam, margin=cfg.margin)


def _mr_chunk_batch(stream, tau):
    steps = [next(stream) for _ in range(tau)]
    return {k: torch.stack([b[k] for b in steps]) for k in steps[0]}


def _mr_ps(inp, mesh):
    """A rank's PS work over the worker mesh: train_dml_distributed under
    each mode, a timed step loop a mode (draws included, as phase 4's),
    the bsp copies gathered, one make_train_chunk call."""
    rank = mesh.rank
    source = IndexPairs(torch.from_numpy(inp["train_x"]).to(DEV),
                        inp["train_idx"])
    L0 = torch.from_numpy(inp["L0"]).to(DEV)
    delays = inp["delays"]
    out = {"modes": {}}
    torch.cuda.synchronize()
    dml_pair_fused.launches = 0             # the rank's main path only
    for mode in MR_MODES:
        L, hist = train_dml_distributed(
            _mr_cfg(mode), source, opt=_mr_opt(), L0=L0,
            delays=lambda t: delays[t], mesh=mesh)
        res = {"loss": [h["loss"] for h in hist],
               "L_sum": float(L.double().sum())}
        ps = _mr_cfg(mode).ps
        state = sync.shard_state(sync.init_state(_mr_opt(), L0, ps), ps,
                                 mesh)
        step = sync.make_train_step(_mr_loss, _mr_opt(), ps,
                                    delays=lambda t: delays[t % MR_STEPS],
                                    mesh=mesh)
        stream = source.worker_streams(MR_RANKS, IMNET_1M.batch_size,
                                       seed=MR_CHUNK_SEED + 1)[rank]
        draw = lambda: {k: v[None] for k, v in  # noqa: E731
                        next(stream).items()}
        state, _ = step(state, draw())
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MR_TIMED):
            state, _ = step(state, draw())
        torch.cuda.synchronize()
        res["step_ms"] = 1e3 * (time.perf_counter() - t0) / MR_TIMED
        if mode == "bsp":                   # every copy, on every rank
            copies = partition.all_gather(state.params[0], ps.axis, mesh)
            res["copies_equal"] = all(torch.equal(copies[0], copies[w])
                                      for w in range(1, MR_RANKS))
            del copies
        if rank == 0:
            res["L"] = L
        out["modes"][mode] = res
    ps = sync.PSConfig(n_workers=MR_RANKS, sync="local", tau=4)
    state = sync.shard_state(sync.init_state(_mr_opt(), L0, ps), ps, mesh)
    batch = _mr_chunk_batch(source.worker_streams(
        MR_RANKS, IMNET_1M.batch_size, seed=MR_CHUNK_SEED)[rank], ps.tau)
    state, m = sync.make_train_chunk(_mr_loss, _mr_opt(), ps, mesh=mesh)(
        state, {k: v[None] for k, v in batch.items()})
    torch.cuda.synchronize()
    out["launches"] = dml_pair_fused.launches
    out["chunk"] = {"loss": float(m["loss"]),
                    **({"L": state.params[0]} if rank == 0 else {})}
    return out


def _mr_timed(call):
    """(the last answer, ms a call over MR_BATCHES after a warm one); a
    collective call: every rank times the same calls."""
    call()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MR_BATCHES):
        ans = call()
    torch.cuda.synchronize()
    return ans, 1e3 * (time.perf_counter() - t0) / MR_BATCHES


def _mr_serve(inp, mesh):
    """A rank's share of phase 6's gallery: the seeded blocks made and
    projected as phase 6 makes them (the whole gallery on every rank: the
    IVF layout takes a rank's clusters' rows from all of it), the exact
    index keeping this rank's quarter of the rows, the IVF build its
    clusters (k-means on rank 0); timed sharded batches, then an engine
    on rank 0, the rest following."""
    exp, cfg, rank = IMNET_1M, IMNET_1M.dml, mesh.rank
    gen = torch.Generator(device=DEV).manual_seed(0)
    L = init_params(cfg, gen, DEV)
    t0 = time.perf_counter()
    gp, gn, _, _, _ = make_gallery(gen, exp.n_samples, cfg.feat_dim,
                                   exp.n_classes, L, inp["qids"])
    exact = ExactIndex.from_projected(L, gp, gn, mesh=mesh)
    torch.cuda.synchronize()
    out = {"gallery_s": time.perf_counter() - t0, "timings": {}}
    t0 = time.perf_counter()
    ivf = IVFIndex.build_projected(
        L, gp, gn, n_clusters=N_CLUSTERS, nprobe=NPROBE,
        cap_factor=CAP_FACTOR, iters=KM_ITERS, seed=0, mesh=mesh,
        timings=out["timings"])
    out["ivf_build_s"] = time.perf_counter() - t0
    del gp, gn
    gc.collect()
    torch.cuda.empty_cache()
    out["exact_gb"] = (exact.gp.numel() + exact.gn.numel()) * 4 / 1e9
    out["ivf_gb"] = (ivf.gp_pad.numel() + 2 * ivf.gn_pad.numel()) * 4 / 1e9
    out["n_shards"] = (exact.n_shards, ivf.n_shards)
    q = torch.from_numpy(inp["queries"]).to(DEV)
    torch.cuda.synchronize()
    metric_topk_fused.launches = ivf_scan_topk_fused.launches = 0
    answers, ms = {}, {}
    for name, call in (("exact", lambda: exact.topk(q, K_TOP)),
                       ("exact_wide", lambda: exact.topk(q, MR_WIDE_K)),
                       ("ivf", lambda: ivf.topk(q, K_TOP))):
        answers[name], ms[name] = _mr_timed(call)
    for name, index in (("exact", exact), ("ivf", ivf)):
        if rank == 0:
            with scan.lead(index) as served:
                engine = RetrievalEngine(served, k_top=K_TOP,
                                         buckets=(MR_QUERIES,), cache_size=0)
                engine.warmup()
                d, i = engine.search(inp["queries"])
                answers[f"{name}_engine"] = (d, i)
                out[f"{name}_engine_shards"] = engine.stats()["n_shards"]
        else:
            out[f"{name}_followed"] = scan.follow(index)
    torch.cuda.synchronize()
    out["launches"] = {"metric_topk": metric_topk_fused.launches,
                       "ivf_scan": ivf_scan_topk_fused.launches}
    out["ms"] = ms
    if rank == 0:
        out["answers"] = answers
    return out


def _mr_collective_ms(mesh):
    """ms of one pmean of an L-sized tensor (86 MB, what a PS step
    reduces) and of one all_gather of a batch's (64, 10) candidates, on
    the worker axis; the mean of three after a warm one."""
    out = {}
    for name, fn, x in (
            ("pmean_L", partition.pmean, torch.ones(
                (IMNET_1M.dml.proj_dim, IMNET_1M.dml.feat_dim), device=DEV)),
            ("gather_candidates", partition.all_gather,
             torch.ones((MR_QUERIES, K_TOP), device=DEV))):
        fn(x, "workers", mesh)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn(x, "workers", mesh)
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t0) / 3
    return out


def _mr_rank(inp):
    """One rank of phase 20 (a spawned process on the shared card)."""
    walls = {"start": time.time() - inp["t_spawn"]}
    t0 = time.perf_counter()
    mesh = sync.make_worker_mesh(MR_RANKS)
    out = {"rank": mesh.rank, "backend": mesh.backend,
           "device": str(mesh.device), "ps": _mr_ps(inp, mesh)}
    walls["ps"] = time.perf_counter() - t0
    out["collective_ms"] = _mr_collective_ms(mesh)
    gc.collect()
    torch.cuda.empty_cache()
    out["ps_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out["serve"] = _mr_serve(inp, card_figures.make_local_mesh())
    walls["serve"] = time.perf_counter() - t0
    out["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["walls_s"] = walls
    return out


def _host_state():
    """The host's free memory and load as this process sees them (read
    from /proc), and this process's resident set."""
    fields = {}
    for path, keys in (("/proc/meminfo", ("MemAvailable",)),
                       ("/proc/self/status", ("VmRSS",))):
        with open(path) as f:
            for line in f:
                key = line.split(":")[0]
                if key in keys:
                    fields[key] = round(int(line.split()[1]) / 1e6, 2)
    return {"mem_available_gb": fields.get("MemAvailable"),
            "rss_gb": fields.get("VmRSS"), "load": os.getloadavg()}


def _mr_nccl():
    """A one-rank NCCL mesh: one bsp step at full width, against the same
    step without a mesh (a mean over one worker: bit-identical)."""
    mesh = sync.make_worker_mesh(1)
    cfg = IMNET_1M.dml
    gen = torch.Generator(device=DEV).manual_seed(3)
    L0 = init_params(cfg, gen, DEV)
    B = IMNET_1M.batch_size
    batch = {"xs": torch.randn((1, B, cfg.feat_dim), generator=gen,
                               device=DEV),
             "ys": torch.randn((1, B, cfg.feat_dim), generator=gen,
                               device=DEV),
             "sim": (torch.rand((1, B), generator=gen, device=DEV) < 0.5)
             .to(torch.int32)}
    ps = sync.PSConfig(n_workers=1, sync="bsp")
    dml_pair_fused.launches = 0
    ranked, m = sync.make_train_step(_mr_loss, _mr_opt(), ps, mesh=mesh)(
        sync.shard_state(sync.init_state(_mr_opt(), L0, ps), ps, mesh),
        batch)
    torch.cuda.synchronize()
    launches = dml_pair_fused.launches
    alone, _ = sync.make_train_step(_mr_loss, _mr_opt(), ps)(
        sync.init_state(_mr_opt(), L0, ps), batch)
    return {"backend": mesh.backend, "launches": launches,
            "loss": float(m["loss"]),
            "equal": torch.equal(ranked.params, alone.params)}


def _mr_agree(a, b):
    """Ids at which two answers (dists, ids) differ, and their largest
    distance gap there (a tie-resolved difference has none)."""
    da, ia = (torch.as_tensor(x).to(DEV) for x in a)
    db, ib = (torch.as_tensor(x).to(DEV) for x in b)
    diff = ia != ib
    gap = float((da - db).abs().max())
    return int(diff.sum()), gap


def phase_multirank(card, data=None, bsp_ms=None):
    """Phase 20: the PS with one worker a rank and the exact and IVF
    galleries sharded over ranks, four processes sharing the one card
    over gloo; a one-rank NCCL mesh. ``data`` is phase 4's (host rows,
    labels, rescaled L0), made again when not given."""
    t_phase = time.perf_counter()
    exp, cfg = IMNET_1M, IMNET_1M.dml
    if data is None:
        feats_np, labels = pairdata.make_features(pairdata.PairDatasetConfig(
            n_samples=TRAIN_SAMPLES, feat_dim=cfg.feat_dim,
            n_classes=TRAIN_CLASSES, kind="noisy_subspace", noise=0.8,
            seed=0))
        L0 = None
    else:
        feats_np, labels, L0 = data
    train_x_np = np.ascontiguousarray(feats_np[:-N_HOLD])
    del feats_np
    train_idx = pairdata.sample_pair_indices(labels[:-N_HOLD], 50_000,
                                             50_000, seed=1)
    train_x = torch.from_numpy(train_x_np).to(DEV)
    if L0 is None:                          # phase 4's init rescale
        L0 = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
        probe_b = next(pairdata.pair_batches_from_indices(
            train_x, train_idx, 256, seed=99, device=DEV))
        d2 = float(torch.mean(dml.mahalanobis_sqdist(L0, probe_b["xs"],
                                                     probe_b["ys"])))
        L0 = L0 * float(np.sqrt(2.0 * cfg.margin / max(d2, 1e-9)))
    L0 = torch.as_tensor(L0).to(DEV)
    delays = np.stack([sync.default_delays(_mr_cfg("ssp").ps)(t).numpy()
                       for t in range(MR_STEPS)])
    # the one-process port on the same batches and delays
    source = IndexPairs(train_x, train_idx)
    one, one_ms = {}, {}
    for mode in MR_MODES:
        L, hist = train_dml_distributed(
            _mr_cfg(mode), source, opt=_mr_opt(), L0=L0,
            delays=lambda t: delays[t], device=DEV,
            step_hook=lambda t, _L: time.perf_counter())
        one[mode] = (L, [h["loss"] for h in hist])
        stamps = [h["hook"] for h in hist]
        one_ms[mode] = 1e3 * (stamps[-1] - stamps[0]) / (len(stamps) - 1)
    ps = sync.PSConfig(n_workers=MR_RANKS, sync="local", tau=4)
    per_worker = [_mr_chunk_batch(s, ps.tau) for s in source.worker_streams(
        MR_RANKS, exp.batch_size, seed=MR_CHUNK_SEED)]
    batch = {k: torch.stack([b[k] for b in per_worker]) for k in per_worker[0]}
    del per_worker
    chunk_one, _ = sync.make_train_chunk(_mr_loss, _mr_opt(), ps)(
        sync.init_state(_mr_opt(), L0, ps), batch)
    chunk_one = chunk_one.params[0]
    del batch, source, train_x
    torch.cuda.synchronize()
    log(f"20 one-process references: ms/step (host clock, draws included) "
        f"{ {k: round(v, 3) for k, v in one_ms.items()} }"
        + (f"; phase 4's bsp {bsp_ms:.3f}" if bsp_ms else ""))

    # the single-process serving references on phase 6's gallery
    gen = torch.Generator(device=DEV).manual_seed(0)
    L = init_params(cfg, gen, DEV)
    qids = np.random.RandomState(1).randint(0, exp.n_samples, N_REQUESTS)
    gp, gn, _, raw_q, _ = make_gallery(gen, exp.n_samples, cfg.feat_dim,
                                       exp.n_classes, L, qids)
    queries = (raw_q + 0.1 * torch.randn(raw_q.shape, generator=gen,
                                         device=DEV))[:MR_QUERIES]
    single = ExactIndex.from_projected(L, gp, gn, device=DEV)
    t0 = time.perf_counter()
    ivf1 = IVFIndex.build_projected(L, gp, gn, n_clusters=N_CLUSTERS,
                                    nprobe=NPROBE, cap_factor=CAP_FACTOR,
                                    iters=KM_ITERS, seed=0, device=DEV)
    torch.cuda.synchronize()
    ivf1_s = time.perf_counter() - t0
    ref, ref_ms = {}, {}
    for name, call in (("exact", lambda: single.topk(queries, K_TOP)),
                       ("exact_wide", lambda: single.topk(queries,
                                                          MR_WIDE_K)),
                       ("ivf", lambda: ivf1.topk(queries, K_TOP))):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MR_BATCHES):
            ref[name] = call()
        torch.cuda.synchronize()
        ref_ms[name] = 1e3 * (time.perf_counter() - t0) / MR_BATCHES
    torch.cuda.synchronize()
    log(f"20 single-process references: IVF build {ivf1_s:.1f} s; ms a "
        f"batch of {MR_QUERIES} (host clock, synchronised) "
        f"{ {k: round(v, 3) for k, v in ref_ms.items()} }")

    host = _host_state()
    inp = {"train_x": train_x_np, "train_idx": train_idx,
           "L0": L0.cpu().numpy(), "delays": delays, "qids": qids,
           "queries": queries.cpu().numpy(), "t_spawn": time.time()}
    # the one-rank NCCL group starts beside the four (its one step is
    # done while they still load their rows)
    nccl_box = []
    nccl_thread = threading.Thread(target=lambda: nccl_box.append(
        spawn(_mr_nccl, 1, timeout=MR_TIMEOUT)))
    t0 = time.perf_counter()
    nccl_thread.start()
    try:
        ranks = spawn(_mr_rank, MR_RANKS, args=(inp,), timeout=MR_TIMEOUT)
    finally:
        nccl_thread.join()
    spawn_s = time.perf_counter() - t0
    del inp, train_x_np
    assert nccl_box, "the one-rank NCCL group failed (its traceback above)"
    (nccl,) = nccl_box[0]

    # -- checks --------------------------------------------------------------
    assert {r["backend"] for r in ranks} == {"gloo"}, ranks[0]["backend"]
    assert [r["rank"] for r in ranks] == list(range(MR_RANKS))
    n_main = len(MR_MODES) * (MR_STEPS + 1 + MR_TIMED) + 4
    for r in ranks:
        assert r["ps"]["launches"] >= n_main, \
            f"rank {r['rank']}: dml_pair launched {r['ps']['launches']}"
        for mode, res in r["ps"]["modes"].items():
            assert np.isfinite(res["loss"]).all(), (r["rank"], mode)
        assert np.isfinite(r["ps"]["chunk"]["loss"])
        for k in ("metric_topk", "ivf_scan"):
            assert r["serve"]["launches"][k] > 0, \
                f"rank {r['rank']}: {k} never launched"
        assert r["serve"]["n_shards"] == (MR_RANKS, MR_RANKS)
    assert ranks[0]["ps"]["modes"]["bsp"]["copies_equal"], \
        "bsp copies differ across ranks"
    worst = {}
    for mode in MR_MODES:
        sums = {r["ps"]["modes"][mode]["L_sum"] for r in ranks}
        assert len(sums) == 1, f"{mode}: ranks return different L"
        L_r, L_1 = ranks[0]["ps"]["modes"][mode]["L"].to(DEV), one[mode][0]
        scale = float(L_1.abs().max())
        worst[mode] = float((L_r - L_1).abs().max()) / scale
        assert worst[mode] <= MR_L_RTOL, (mode, worst[mode])
        np.testing.assert_allclose(ranks[0]["ps"]["modes"][mode]["loss"],
                                   one[mode][1], rtol=1e-5)
    c_r = ranks[0]["ps"]["chunk"]["L"].to(DEV)
    worst["chunk"] = float((c_r - chunk_one).abs().max()) / \
        float(chunk_one.abs().max())
    assert worst["chunk"] <= MR_L_RTOL, worst["chunk"]
    assert nccl["backend"] == "nccl" and nccl["launches"] >= 1
    assert nccl["equal"], "the one-rank NCCL step differs from one process"
    assert np.isfinite(nccl["loss"])
    ans = ranks[0]["serve"]["answers"]
    err = {}
    for name, k in (("exact", K_TOP), ("exact_wide", MR_WIDE_K)):
        d, i = (x.to(DEV) for x in ans[name])
        err[name] = compare(L, queries, gp, gn, k, d, i)
    qp = project_queries(L, queries)
    d, i = (x.to(DEV) for x in ans["ivf"])
    err["ivf"] = compare_ivf(*_ivf_args(ivf1, qp, ivf1.nprobe), K_TOP, d, i)
    vs_single = {name: _mr_agree(ans[name], ref[name]) for name in ref}
    for name in ("exact", "ivf"):
        e = ans[f"{name}_engine"]
        assert torch.equal(torch.as_tensor(e[1]), ans[name][1].cpu()), \
            f"{name}: the engine's answers differ from the direct call"
        assert ranks[0]["serve"][f"{name}_engine_shards"] == MR_RANKS
        assert all(r["serve"][f"{name}_followed"] == 2 for r in ranks[1:])

    # -- report -------------------------------------------------------------
    r0 = ranks[0]
    note = (f"the {MR_RANKS} ranks share one card, and gloo stages every "
            f"collective through the host; {card}")
    log(f"20 mesh: {MR_RANKS} ranks over {r0['backend']} on "
        f"{r0['device']} (spawn and work {spawn_s:.1f} s); a one-rank mesh "
        f"over {nccl['backend']} beside them, its bsp step bit-identical "
        f"to one process's")
    for mode in MR_MODES:
        res = r0["ps"]["modes"][mode]
        log(f"20 PS {mode}: {res['step_ms']:.3f} ms/step over {MR_RANKS} "
            f"ranks (rank 0's host clock, draws included) against "
            f"{one_ms[mode]:.3f} one process; loss "
            f"{res['loss'][0]:.4f} -> {res['loss'][-1]:.4f}; merged L "
            f"within {worst[mode]:.2e} x max |L| of one process "
            f"(held {MR_L_RTOL:g}); {note}")
    log(f"20 where a rank's time went: started {r0['walls_s']['start']:.1f} "
        f"s after the spawn, PS {r0['walls_s']['ps']:.1f} s, serving "
        f"{r0['walls_s']['serve']:.1f} s; one pmean of L (86 MB) "
        f"{r0['collective_ms']['pmean_L']:.2f} ms, one all_gather of a "
        f"batch's candidates {r0['collective_ms']['gather_candidates']:.2f}"
        f" ms; the host before the spawn: {host}; {note}")
    log(f"20 PS chunk (tau 4): loss {r0['ps']['chunk']['loss']:.4f}, "
        f"within {worst['chunk']:.2e} x max |L| of one process; bsp "
        f"copies bit-identical; dml_pair launches by rank "
        f"{[r['ps']['launches'] for r in ranks]}")
    for name in ref:
        log(f"20 sharded {name}: {r0['serve']['ms'][name]:.3f} ms a batch "
            f"of {MR_QUERIES} over {MR_RANKS} ranks (rank 0's host clock) "
            f"against {ref_ms[name]:.3f} one process; vs the plain version "
            f"max |dd| {err[name][0]:.3e}, {err[name][1]} tie-resolved id "
            f"differences; vs the one-process index {vs_single[name][0]} "
            f"ids differ, max |dd| {vs_single[name][1]:.3e}; {note}")
    log(f"20 ranks: gallery made and projected in "
        f"{[round(r['serve']['gallery_s'], 1) for r in ranks]} s, IVF built "
        f"in {[round(r['serve']['ivf_build_s'], 1) for r in ranks]} s "
        f"(rank 0's k-means {r0['serve']['timings']}), exact "
        f"{r0['serve']['exact_gb']:.2f} GB and IVF {r0['serve']['ivf_gb']:.2f}"
        f" GB a rank; launches by rank "
        f"{[r['serve']['launches'] for r in ranks]}; peak GB a rank PS "
        f"{[round(r['ps_peak_gb'], 2) for r in ranks]}, serving "
        f"{[round(r['serve_peak_gb'], 2) for r in ranks]}; {note}")
    out = {"ranks": MR_RANKS, "backend": r0["backend"],
           "nccl_backend": nccl["backend"], "card": card,
           "ps_step_ms": {m: r0["ps"]["modes"][m]["step_ms"]
                          for m in MR_MODES},
           "one_process_step_ms": one_ms, "l_rel_err": worst,
           "batch_ms": r0["serve"]["ms"], "one_process_batch_ms": ref_ms,
           "launches": {"dml_pair": [r["ps"]["launches"] for r in ranks],
                        **{k: [r["serve"]["launches"][k] for r in ranks]
                           for k in ("metric_topk", "ivf_scan")}},
           "peak_gb": {"ps": [r["ps_peak_gb"] for r in ranks],
                       "serve": [r["serve_peak_gb"] for r in ranks]},
           "ivf_build_s": [r["serve"]["ivf_build_s"] for r in ranks],
           "collective_ms": r0["collective_ms"], "walls_s": r0["walls_s"],
           "host": host,
           "one_process_ivf_build_s": ivf1_s,
           "phase_s": time.perf_counter() - t_phase}
    log(f"multi-rank phase {out['phase_s']:.1f} s")
    return out


# -- phase 21: expert-parallel moe, training and the closed loop over ranks --
# granite-moe-1b at full width and depth (f32) on (data 1, model 4) and
# (data 2, model 2): the forward batch and the decode; the training cut in
# depth to MRM_TRAIN_LAYERS, where four replicas with their AdamW state
# fit in 80 GB: the first step's update holds 36 bytes a parameter a rank
# (the module's weights, the gradients and their clipped copy, the two
# moments and their successors, the updates and the new parameters; the
# first card call OOMed at 12 layers with 18.75 GB a rank allocated
# before its peak), and 6 layers (0.37 B parameters) took 13.4 GB a rank;
# the step now runs the per-rank program, whose FSDP gathers and
# reduce-scatters gloo stages through the host (15-24 s a step at 6
# layers on the card, 4.6-13 s before), so 3 layers keep the script
# inside its time; the closed loop at phase 8e's recipe on a store cut to
# MRM_LOOP_ROWS rows, since each of the four ranks holds the feature
# table (262,144 rows would be 90 GB)
MRM_RANKS = MR_RANKS
MRM_B, MRM_T = 4, 1024
MRM_DECODE = 8
MRM_TRAIN_LAYERS, MRM_TRAIN_B, MRM_TRAIN_T = 3, 2, 512
MRM_TRAIN_STEPS, MRM_TRAIN_LR = 3, 1e-3
# the first step's loss and gradient norm against the one-process oracle:
# the same f32 model, the expert partials summed in another order (and
# GEMMs at another batch size), so they part by rounding that can move a
# near-tied route; held within the full forward's bound
MRM_TRAIN_RTOL = HIDDEN_REL_BOUND
MRM_LOOP_ROWS, MRM_LOOP_SEED = 65_536, 21
MRM_LOOP_STEPS, MRM_LOOP_REFRESH = 24, 10
MRM_POOL_OVERLAP = 0.99
MRM_TIMEOUT = 600.0


def _mrm_cfg(layers=None):
    cfg = get_config(MOE).replace(dtype="float32")
    return cfg if layers is None else cfg.replace(n_layers=layers)


def _mrm_batches():
    """The forward batch (B MRM_B x T MRM_T), the decode prompt (B 1) and
    the training batch (B MRM_TRAIN_B x T MRM_TRAIN_T), seeded."""
    vocab = _mrm_cfg().vocab_size
    rng = np.random.RandomState(21)
    return {"tokens": rng.randint(0, vocab, (MRM_B, MRM_T)),
            "decode": rng.randint(0, vocab, (1, MRM_DECODE)),
            "train_tokens": rng.randint(0, vocab, (MRM_TRAIN_B, MRM_TRAIN_T)),
            "train_labels": rng.randint(0, vocab,
                                        (MRM_TRAIN_B, MRM_TRAIN_T))}


def _mrm_store():
    """Phase 8e's store, cut to MRM_LOOP_ROWS rows: classes, labels and
    rows from one seeded generator on the card, the same in every
    process."""
    exp, cfg = IMNET_1M, IMNET_1M.dml
    gen = torch.Generator(device=DEV).manual_seed(MRM_LOOP_SEED)
    centers = torch.randn((exp.n_classes, cfg.feat_dim), generator=gen,
                          device=DEV)
    masks = torch.rand((exp.n_classes, cfg.feat_dim), generator=gen,
                       device=DEV) < 0.1
    classes = (centers.abs() * masks, masks)
    lab = torch.randint(0, exp.n_classes, (MRM_LOOP_ROWS,), generator=gen,
                        device=DEV)
    store = torch.empty((MRM_LOOP_ROWS, cfg.feat_dim), device=DEV)
    for s in range(0, MRM_LOOP_ROWS, LOOP_BLOCK):
        store[s:s + LOOP_BLOCK] = class_rows(gen, lab[s:s + LOOP_BLOCK],
                                             classes, spread=LOOP_SPREAD)
    return store, lab.cpu().numpy()


def _mrm_loop(store, labels, L0, mesh=None):
    """Phase 8e's loop (mutable-exact, P = 4 bsp) for MRM_LOOP_STEPS steps,
    a refresh every MRM_LOOP_REFRESH: (L, history, the pool after each
    refresh, run s, refresh s, ms a step)."""
    ccfg = _loop_cfg(IMNET_1M, "mutable-exact", MRM_LOOP_STEPS,
                     MRM_LOOP_REFRESH, LOOP_MINE)
    clt = ClosedLoopTrainer(ccfg, store, labels, L0=L0,
                            opt=sgd(schedules.inverse_time(1e-3, 1e-3)),
                            device=DEV, mesh=mesh)
    pools, refresh_s = [], []
    refresh = clt.refresh

    def timed_refresh(L, step, swap=True):
        t0 = time.perf_counter()
        rec = refresh(L, step, swap=swap)
        torch.cuda.synchronize()
        refresh_s.append(time.perf_counter() - t0)
        pools.append(dict(clt.source._pool))
        return rec

    clt.refresh = timed_refresh
    torch.cuda.synchronize()
    if mesh is not None:
        dist.barrier()
    t0 = time.perf_counter()
    L, hist = clt.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    return {"L": L, "hist": hist, "pools": pools, "run_s": run_s,
            "refresh_s": refresh_s, "lead": clt.engine is not None,
            "step_ms": 1e3 * (run_s - sum(refresh_s)) / MRM_LOOP_STEPS}


def _mrm_checksum(tree):
    """Each leaf's bits summed as integers of its element's width: equal
    trees give equal lists, and any flipped bit changes its leaf's
    entry."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

    def total(x, chunk=1 << 26):        # in slices: no int64 copy of x
        w = x.contiguous().view(ints[x.element_size()]).reshape(-1)
        return sum(int(w[i:i + chunk].to(torch.int64).sum())
                   for i in range(0, w.numel(), chunk))

    return [total(x) for x in tree_leaves(tree)]


def _time_once(fn, barrier=False):
    """(fn(), s) on the host clock, synchronised; under ``barrier`` every
    rank of the group starts it together."""
    torch.cuda.synchronize()
    if barrier:
        dist.barrier()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _mrm_forward(inp, meshes):
    """A rank's (a): the full-depth forward on each mesh (a warm call,
    then the checked and timed one) and 8 decode steps on (1, 4)."""
    model = Model(_mrm_cfg(), device=DEV, seed=0)
    tokens = torch.from_numpy(inp["tokens"]).to(DEV)
    out = {"forward": {}}
    with torch.inference_mode():
        model.hidden({"tokens": tokens}, mesh=meshes["1x4"])
        for name, mesh in meshes.items():
            torch.cuda.synchronize()
            flash_attention.launches = 0    # this rank's main path only
            with _moe_routes() as rec:
                (h, aux), s = _time_once(lambda: model.hidden(
                    {"tokens": tokens}, mesh=mesh), barrier=True)
            out["forward"][name] = {
                "ms": 1e3 * s, "launches": flash_attention.launches,
                "aux": float(aux["moe_aux"]), "checksum": _mrm_checksum([h]),
                **({"h": h} if mesh.rank == 0 else {}),
                # each batch half's routes, from its model rank 0
                **({"routes": rec["topi"]} if name == "2x2"
                   and mesh.axis_index("model") == 0 else {})}
        cache = model.init_decode_cache(1, MRM_DECODE)
        prompt = torch.from_numpy(inp["decode"]).to(DEV)
        logits, stamps = [], []
        torch.cuda.synchronize()
        dist.barrier()
        for t in range(MRM_DECODE):
            stamps.append(time.perf_counter())
            lg, cache = model.decode_step(cache, prompt[:, t], t,
                                          mesh=meshes["1x4"])
            logits.append(lg)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    out["decode"] = {"ms_token": 1e3 * (stamps[-1] - stamps[1])
                     / (MRM_DECODE - 1),
                     "checksum": _mrm_checksum(logits),
                     **({"logits": torch.stack(logits)}
                        if meshes["1x4"].rank == 0 else {})}
    del model, cache
    return out


def _mrm_train(inp, mesh):
    """A rank's (b): MRM_TRAIN_STEPS AdamW steps of make_train_step(mesh=)
    on (2, 2) over one batch; the losses, gradient norms, ms a step and
    the parameters' checksum after the steps."""
    run = RunConfig(arch=MOE, lr=MRM_TRAIN_LR,
                    total_steps=MRM_TRAIN_STEPS, warmup=0)
    model = Model(_mrm_cfg(MRM_TRAIN_LAYERS), device=DEV, seed=0)
    opt = steps_lib.make_optimizer(run)
    state = steps_lib.init_train_state(model, opt)
    step = steps_lib.make_train_step(model, opt, run, mesh=mesh,
                                     loss_chunks=2)
    batch = {"tokens": torch.from_numpy(inp["train_tokens"]).to(DEV),
             "labels": torch.from_numpy(inp["train_labels"]).to(DEV)}
    losses, gnorms, secs = [], [], []
    for _ in range(MRM_TRAIN_STEPS):
        (state, m), s = _time_once(lambda: step(state, batch),
                                   barrier=True)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        secs.append(s)
    out = {"loss": losses, "grad_norm": gnorms,
           "step_ms": [1e3 * s for s in secs],
           "checksum": _mrm_checksum(state.params)}
    del model, state
    return out


def _mrm_rank(inp):
    """One rank of phase 21 (a spawned process on the shared card)."""
    meshes = {"1x4": card_figures.make_local_mesh(model=4),
              "2x2": card_figures.make_local_mesh(model=2)}
    worker = sync.make_worker_mesh(MRM_RANKS)
    out = {"rank": worker.rank, "backend": worker.backend,
           "start_s": time.time() - inp["t_spawn"], "peak_gb": {}}
    torch.cuda.reset_peak_memory_stats()
    out.update(_mrm_forward(inp, meshes))
    out["peak_gb"]["forward"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["train"] = _mrm_train(inp, meshes["2x2"])
    out["peak_gb"]["train"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    store, labels = _mrm_store()
    L0 = torch.from_numpy(inp["loop_L0"]).to(DEV)
    torch.cuda.synchronize()
    _reset_counts()                         # the loop's main path only
    loop = _mrm_loop(store, labels, L0, mesh=worker)
    torch.cuda.synchronize()
    loop["launches"] = {k: v for k, v in _counts().items() if v}
    loop["pool_checksums"] = [
        [int(np.asarray(p[k], np.int64).sum()) for k in ("a", "b", "sim")]
        for p in loop["pools"]]
    if worker.rank != 0:
        loop.pop("pools")
    out["loop"] = loop
    out["peak_gb"]["loop"] = torch.cuda.max_memory_allocated() / 1e9
    return out


@contextlib.contextmanager
def _moe_as_on_2x2(follow=None):
    """While open, every moe layer of a one-process model computes what
    the ranks of (data 2, model 2) compute: on each half of the batch
    apart (capacity and aux a half, aux the halves' mean), the sum of
    its two expert shards' partials (``moe._moe_local`` on experts 0-15,
    then 16-31), the rest of the model on the whole batch: the
    one-process oracle there. Two terms sum the same in any order, so
    the ranks' answers should be these bit for bit. The one-device layer
    is no oracle at this size: its single combine sums the slots in
    another order, about one near-tied route in 4,096 tokens x 24 layers
    moves under that rounding, and the seeded router's skew lets a moved
    route reorder its expert's capacity queue (the second and third card
    calls of phase 21 parted by 3.5e-2 and 2.5e-2 of max so, whole half
    batches and the one-device layer by halves; (1, 4) matched the
    one-device layer within 1.6e-6).

    ``follow`` ([batch half][layer] -> (N, k) top-k ids, as the ranks
    routed that half's N tokens) routes each token whose own top-k set
    differs from the ranks' to the ranks' experts, weighted by its own
    probabilities there (``moe._routed``), and yields a list that gets
    one (half, layer, token, gap) a moved routing: ``gap`` how far the
    weakest expert the ranks chose and it did not falls below its own
    k-th probability, as a share of that probability (``_route_gap``).
    A near-tie moved by the ranks' rounding has a gap at rounding
    level."""
    apply, route = moe.apply_moe, moe._route
    moved, calls = [], [0]

    def as_ranks(p, x, cfg, mesh=None, expert_axis="model"):
        e_loc = cfg.n_experts // 2
        layer = calls[0]
        calls[0] += 1
        ys, auxs = [], []
        for half, xb in enumerate(x.chunk(2)):
            Bl, Tl, d = xb.shape
            xf = xb.reshape(Bl * Tl, d)
            cap = moe._capacity(Bl * Tl, cfg, e_loc)
            routed = route(p["router"], xf, cfg)
            if follow is not None:
                ids = follow[half][layer].to(xf.device)
                apart = (routed[1].sort(dim=-1)[0] != ids.sort(dim=-1)[0]
                         ).any(dim=-1).nonzero()[:, 0]
                if len(apart):
                    probs = moe._router_probs(p["router"], xf)
                    gaps = _route_gap(probs[apart], ids[apart], cfg.top_k)
                    moved.extend((half, layer, int(t), float(g))
                                 for t, g in zip(apart, gaps))
                    routed = moe._routed(probs, ids, cfg)
            # both expert shards route this half as the ranks' do
            moe._route = lambda *_, routed=routed: routed
            try:
                parts = [moe._moe_local(
                    {k: p[k] if k == "router" else
                     p[k][m * e_loc:(m + 1) * e_loc]
                     for k in ("router", "w_gate", "w_up", "w_down")},
                    xf, cfg, m * e_loc, e_loc, cap) for m in (0, 1)]
            finally:
                moe._route = route
            ys.append((parts[0][0] + parts[1][0]).reshape(Bl, Tl, d))
            auxs.append(parts[0][1])
        return torch.cat(ys), (auxs[0] + auxs[1]) / 2

    moe.apply_moe = as_ranks
    try:
        yield moved
    finally:
        moe.apply_moe = apply


def _route_gap(probs, ids, k):
    """A token's gap (probs (n, E) one process's router probabilities,
    ids (n, k) the experts the ranks chose): how far the weakest chosen
    expert it does not rank in its own top k falls below its own k-th
    probability, as a share of that probability."""
    kth = torch.sort(probs, dim=-1, descending=True)[0][:, k - 1]
    chosen = torch.gather(probs, 1, ids).min(dim=-1)[0]
    return ((kth - chosen).clamp(min=0) / kth).tolist()


# One process's (2, 2) oracle follows the ranks' routes (_moe_as_on_2x2's
# ``follow``) only where they moved a near-tie under the ranks' rounding:
# each moved routing's gap at most ROUTE_TIE_REL (the share the hidden
# states are held to), at most MOVED_ROUTES_MAX of them a forward
# (readings: 1 of 98,304 in phase 21's (2, 2) forward on three card
# calls, 0 of 16,384 in phase 23's f32 prefill), and the oracle that
# routes itself still held to the ranks on every token that no moved
# routing reaches (_unmoved).
ROUTE_TIE_REL = HIDDEN_REL_BOUND
MOVED_ROUTES_MAX = 4


def _unmoved(moved, B, T):
    """(B, T) bool: the tokens no moved routing reaches. A half's tokens
    run in token-major order, and a token reads only earlier tokens of
    its own sequence (causal attention) and earlier places in its
    experts' queues, so the tokens of a half before its first moved one
    are the oracle's own, layer after layer."""
    first = [T * B // 2] * 2
    for half, _, t, _ in moved:
        first[half] = min(first[half], t)
    keep = torch.zeros(B * T, dtype=torch.bool)
    for half in (0, 1):
        keep[half * B * T // 2:half * B * T // 2 + first[half]] = True
    return keep.reshape(B, T)


def _followed(moved, routings, got, free):
    """The figures of a forward of ``routings`` (token, layer) routings
    whose oracle followed the ranks' routes (``moved`` from
    ``_moe_as_on_2x2``): the moved routings, the largest gap, and the
    ranks' ``got`` (B, T, ...) against the oracle that routes itself
    (``free``) on the tokens no moved routing reaches (``_unmoved``) and
    on all of them; ``ok`` with every check held (that error within
    HIDDEN_REL_BOUND)."""
    B, T = got.shape[:2]
    keep = _unmoved(moved, B, T)
    gap = max((g for *_, g in moved), default=0.0)
    kept = int(keep.sum())
    err = _rel(got[keep.to(got.device)], free[keep.to(free.device)]) \
        if kept else float("inf")
    ok = len(moved) <= MOVED_ROUTES_MAX and gap <= ROUTE_TIE_REL and \
        err <= HIDDEN_REL_BOUND
    return {"moved": len(moved), "gap": gap, "routings": routings,
            "unmoved": kept, "tokens": B * T, "free_err": err,
            "free_err_all": _rel(got, free), "ok": ok}


def _followed_line(f):
    """The words of a followed forward's figures (``_followed``)."""
    return (f"one process routed as the ranks where they moved a near-tie: "
            f"{f['moved']} of {f['routings']} (token, layer) routings "
            f"moved (held <= {MOVED_ROUTES_MAX}), largest gap "
            f"{f['gap']:.2e} of the k-th probability (held <= "
            f"{ROUTE_TIE_REL:g}); one process routing itself: within "
            f"{f['free_err']:.3e} on the {f['unmoved']} of {f['tokens']} "
            f"tokens no moved routing reaches (bound {HIDDEN_REL_BOUND}), "
            f"{f['free_err_all']:.3e} on all")


def _pool_overlap(a, b):
    """Share of b's (a, b, sim) pairs that a holds."""
    pa = set(zip(*(np.asarray(a[k]).tolist() for k in ("a", "b", "sim"))))
    pb = set(zip(*(np.asarray(b[k]).tolist() for k in ("a", "b", "sim"))))
    return len(pa & pb) / max(len(pb), 1)


def phase_multirank_moe(card):
    """Phase 21: granite-moe-1b expert-parallel over four ranks sharing the
    card over gloo (the forward on (1, 4) and (2, 2), decode on (1, 4),
    AdamW steps on (2, 2)) and the closed loop over a worker mesh, each
    held against one-process answers computed here first."""
    t_phase = time.perf_counter()
    inp = _mrm_batches()
    cfg = _mrm_cfg()

    # -- (a) the one-process answers: the batch, as on (2, 2)
    # (_moe_as_on_2x2), decode
    model = Model(cfg, device=DEV, seed=0)
    tokens = torch.from_numpy(inp["tokens"]).to(DEV)
    with torch.inference_mode():
        model.hidden({"tokens": tokens})
        (h1, aux1), s1 = _time_once(lambda: model.hidden({"tokens": tokens}))
        with _moe_as_on_2x2():
            h_halves, aux_halves = model.hidden({"tokens": tokens})
        cache = model.init_decode_cache(1, MRM_DECODE)
        prompt = torch.from_numpy(inp["decode"]).to(DEV)
        logits1, stamps = [], []
        for t in range(MRM_DECODE):
            stamps.append(time.perf_counter())
            lg, cache = model.decode_step(cache, prompt[:, t], t)
            logits1.append(lg)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    one = {"forward_ms": 1e3 * s1, "h": h1.cpu(),
           "aux": float(aux1["moe_aux"]), "h_halves": h_halves.cpu(),
           "aux_halves": float(aux_halves["moe_aux"]),
           "decode": torch.stack(logits1).cpu(),
           "ms_token": 1e3 * (stamps[-1] - stamps[1]) / (MRM_DECODE - 1)}
    del model, cache, h1, h_halves
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) the one-device oracle of the first step, and one process's steps
    run = RunConfig(arch=MOE, lr=MRM_TRAIN_LR, total_steps=MRM_TRAIN_STEPS,
                    warmup=0)
    model = Model(_mrm_cfg(MRM_TRAIN_LAYERS), device=DEV, seed=0)
    batch = {"tokens": torch.from_numpy(inp["train_tokens"]).to(DEV),
             "labels": torch.from_numpy(inp["train_labels"]).to(DEV)}

    def oracle_loss(params, _):
        h, aux = model.hidden(batch, plain=True, params=params)
        ce = steps_lib.chunked_ce_loss(model, params, h, batch["labels"], 2)
        return ce + model.cfg.moe_aux_weight * aux["moe_aux"], {}

    with _moe_as_on_2x2():
        (o_loss, _), grads = value_and_grad(oracle_loss, model.param_tree(),
                                            None)
    o_gnorm = float(torch.sqrt(sum(torch.sum(g * g)
                                   for g in tree_leaves(grads))))
    del grads
    opt = steps_lib.make_optimizer(run)
    state = steps_lib.init_train_state(model, opt)
    step = steps_lib.make_train_step(model, opt, run, loss_chunks=2)
    one_steps = []
    for _ in range(MRM_TRAIN_STEPS):
        (state, m), s = _time_once(lambda: step(state, batch))
        one_steps.append(1e3 * s)
    one.update(train_loss=float(o_loss), train_gnorm=o_gnorm,
               train_step_ms=one_steps)
    del model, state, step, opt
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) the one-process loop on the same store and L0
    store, labels = _mrm_store()
    cfg_dml = IMNET_1M.dml
    gen = torch.Generator(device=DEV).manual_seed(MRM_LOOP_SEED + 1)
    L0 = init_params(cfg_dml, gen, DEV)
    uniform = pairdata.sample_pair_indices(labels, 2000, 2000, seed=11)
    d2 = float(torch.mean(dml.mahalanobis_sqdist(
        L0, *_pair_rows(store, uniform)[:2])))
    L0 = L0 * float(np.sqrt(2.0 * cfg_dml.margin / max(d2, 1e-9)))
    loop1 = _mrm_loop(store, labels, L0)
    inp["loop_L0"] = L0.cpu().numpy()
    loop1["L"] = loop1["L"].cpu()
    del store, L0
    gc.collect()
    torch.cuda.empty_cache()
    log(f"21 one-process answers: forward {one['forward_ms']:.1f} ms a "
        f"batch of {MRM_B} x {MRM_T}, decode {one['ms_token']:.2f} "
        f"ms/token, training ({MRM_TRAIN_LAYERS} layers) "
        f"{[round(x, 1) for x in one_steps]} ms/step, the loop "
        f"{loop1['step_ms']:.2f} ms a step; {card}")

    # -- the ranks
    inp["t_spawn"] = time.time()
    t0 = time.perf_counter()
    ranks = spawn(_mrm_rank, MRM_RANKS, args=(inp,), timeout=MRM_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]

    # -- checks: every figure is read and reported before any fails the run
    failed = []

    def need(ok, what):
        if not ok:
            failed.append(what)

    need({r["backend"] for r in ranks} == {"gloo"}, "backend")
    need([r["rank"] for r in ranks] == list(range(MRM_RANKS)), "ranks")
    # the (2, 2) oracle following the ranks' near-tied routes: rank 0
    # holds batch half 0's routes, rank 2 half 1's
    model = Model(cfg, device=DEV, seed=0)
    with torch.inference_mode(), _moe_as_on_2x2(follow=[
            ranks[0]["forward"]["2x2"]["routes"],
            ranks[2]["forward"]["2x2"]["routes"]]) as moved:
        h_routed, aux_routed = model.hidden({"tokens": torch.from_numpy(
            inp["tokens"]).to(DEV)})
    del model
    one.update(h_routed=h_routed.cpu(),
               aux_routed=float(aux_routed["moe_aux"]),
               followed=_followed(moved, MRM_B * MRM_T * cfg.n_layers,
                                  ranks[0]["forward"]["2x2"]["h"],
                                  one["h_halves"]))
    del h_routed
    gc.collect()
    torch.cuda.empty_cache()
    need(one["followed"]["ok"], f"2x2 routes: {one['followed']}")
    err = {}
    for name, h_ref, aux_ref in (("1x4", one["h"], one["aux"]),
                                 ("2x2", one["h_routed"],
                                  one["aux_routed"])):
        fw = [r["forward"][name] for r in ranks]
        need(all(f["launches"] == cfg.n_layers for f in fw),
             f"{name}: flash_attention launches "
             f"{[f['launches'] for f in fw]}")
        need(all(f["checksum"] == fw[0]["checksum"] for f in fw),
             f"{name}: the ranks' hidden states differ")
        h = fw[0]["h"]
        need(bool(torch.isfinite(h).all()), f"{name}: hidden not finite")
        err[name] = {"hidden": _rel(h, h_ref),
                     "embed_pool": _rel(h.mean(dim=1), h_ref.mean(dim=1)),
                     "aux": abs(fw[0]["aux"] - aux_ref) / aux_ref}
        need(err[name]["hidden"] <= HIDDEN_REL_BOUND
             and err[name]["embed_pool"] <= EMBED_REL_BOUND
             and err[name]["aux"] <= MOE_AUX_KERNEL_REL,
             f"{name}: {err[name]}")
    need(all(r["decode"]["checksum"] == r0["decode"]["checksum"]
             for r in ranks), "the ranks' decode logits differ")
    err["decode"] = max(_rel(a, b) for a, b in zip(r0["decode"]["logits"],
                                                   one["decode"]))
    need(err["decode"] <= DECODE_REL_BOUND, f"decode {err['decode']}")
    tr = [r["train"] for r in ranks]
    need(all(t["checksum"] == tr[0]["checksum"] for t in tr),
         "parameters differ across ranks after the steps")
    need(all(t["loss"] == tr[0]["loss"] for t in tr),
         "the ranks' losses differ")
    need(bool(np.isfinite(tr[0]["loss"]).all())
         and tr[0]["loss"][-1] < tr[0]["loss"][0],
         f"the loss did not fall: {tr[0]['loss']}")
    err["train_loss"] = abs(tr[0]["loss"][0] - one["train_loss"]) \
        / one["train_loss"]
    err["train_gnorm"] = abs(tr[0]["grad_norm"][0] - one["train_gnorm"]) \
        / one["train_gnorm"]
    need(err["train_loss"] <= MRM_TRAIN_RTOL
         and err["train_gnorm"] <= MRM_TRAIN_RTOL,
         f"the first step against the oracle: {err['train_loss']}, "
         f"{err['train_gnorm']}")
    lp = [r["loop"] for r in ranks]
    need(lp[0]["lead"] and not any(x["lead"] for x in lp[1:]),
         "the serving stack is not on rank 0 alone")
    n_ref = 1 + (MRM_LOOP_STEPS - 1) // MRM_LOOP_REFRESH
    need(len(lp[0]["hist"]["refreshes"]) == n_ref
         == len(loop1["hist"]["refreshes"]), "refresh counts")
    need(all(x["pool_checksums"] == lp[0]["pool_checksums"] for x in lp)
         and all(x["hist"]["refreshes"] == lp[0]["hist"]["refreshes"]
                 for x in lp), "the ranks' pools or records differ")
    need(all(np.array_equal(lp[0]["pools"][0][k], loop1["pools"][0][k])
             for k in ("a", "b", "sim")),
         "the first pool (under L0) differs from one process's")
    overlap = [_pool_overlap(a, b) for a, b in zip(lp[0]["pools"][1:],
                                                     loop1["pools"][1:])]
    need(min(overlap) >= MRM_POOL_OVERLAP, f"pool overlap {overlap}")
    err["loop_L"] = _rel(lp[0]["L"], loop1["L"])
    need(err["loop_L"] <= MR_L_RTOL, f"loop L {err['loop_L']}")
    for r in ranks:
        n = r["loop"]["launches"]
        need(n.get("dml_pair", 0) >= MRM_LOOP_STEPS,
             f"rank {r['rank']}: dml_pair launches {n}")
    need(lp[0]["launches"].get("metric_topk", 0) > 0,
         f"rank 0: metric_topk launches {lp[0]['launches']}")

    # -- report
    note = (f"the {MRM_RANKS} ranks share one card, and gloo stages every "
            f"collective through the host: the runtime's overhead, not "
            f"scaling; {card}")
    for name in ("1x4", "2x2"):
        routed = "" if name == "1x4" else \
            f" ({_followed_line(one['followed'])})"
        log(f"21 {MOE} forward on {name} (f32, B {MRM_B} x T {MRM_T}, "
            f"{cfg.n_layers} layers): {r0['forward'][name]['ms']:.1f} ms a "
            f"batch over {MRM_RANKS} ranks against {one['forward_ms']:.1f} "
            f"one process; hidden max |a - b| / max |b| "
            f"{err[name]['hidden']:.3e} (bound {HIDDEN_REL_BOUND}), "
            f"embed_pool {err[name]['embed_pool']:.3e} (bound "
            f"{EMBED_REL_BOUND}), moe_aux rel {err[name]['aux']:.2e} (bound "
            f"{MOE_AUX_KERNEL_REL}){routed}; flash_attention launches by "
            f"rank {[r['forward'][name]['launches'] for r in ranks]}; "
            f"{note}")
    log(f"21 decode on 1x4 (B 1, {MRM_DECODE} tokens): "
        f"{r0['decode']['ms_token']:.2f} ms/token over ranks against "
        f"{one['ms_token']:.2f} one process; logits within "
        f"{err['decode']:.3e} (bound {DECODE_REL_BOUND}); {note}")
    log(f"21 training on 2x2 ({MRM_TRAIN_LAYERS} of {cfg.n_layers} layers, "
        f"B {MRM_TRAIN_B} x T {MRM_TRAIN_T}, AdamW lr {MRM_TRAIN_LR}): "
        f"loss {[round(x, 4) for x in tr[0]['loss']]}, ms/step "
        f"{[round(x, 1) for x in tr[0]['step_ms']]} over ranks against "
        f"{[round(x, 1) for x in one['train_step_ms']]} one process; first "
        f"loss rel {err['train_loss']:.2e}, grad norm rel "
        f"{err['train_gnorm']:.2e} of the oracle (bound {MRM_TRAIN_RTOL}); "
        f"parameters bit-identical across ranks; {note}")
    log(f"21 closed loop over {MRM_RANKS} worker ranks ({MRM_LOOP_ROWS} "
        f"rows, {MRM_LOOP_STEPS} steps, a refresh every "
        f"{MRM_LOOP_REFRESH}): {lp[0]['step_ms']:.1f} ms a step against "
        f"{loop1['step_ms']:.1f} one process; refresh s "
        f"{[round(x, 2) for x in lp[0]['refresh_s']]} against "
        f"{[round(x, 2) for x in loop1['refresh_s']]}; first pool equal, "
        f"later pools' overlap {[round(x, 4) for x in overlap]} (held "
        f">= {MRM_POOL_OVERLAP}); L within {err['loop_L']:.2e} x max |L| "
        f"(held {MR_L_RTOL}); launches by rank "
        f"{[r['loop']['launches'] for r in ranks]}; {note}")
    peaks = {k: [round(r["peak_gb"][k], 2) for r in ranks]
             for k in r0["peak_gb"]}
    log(f"21 ranks: started {[round(r['start_s'], 1) for r in ranks]} s "
        f"after the spawn; peak GB a rank {peaks}; spawn and work "
        f"{spawn_s:.1f} s; {note}")
    out = {"ranks": MRM_RANKS, "card": card, "err": err,
           "forward_ms": {n: r0["forward"][n]["ms"] for n in ("1x4", "2x2")},
           "one_process_forward_ms": one["forward_ms"],
           "decode_ms_token": r0["decode"]["ms_token"],
           "one_process_decode_ms_token": one["ms_token"],
           "train_step_ms": tr[0]["step_ms"],
           "one_process_train_step_ms": one["train_step_ms"],
           "train_loss": tr[0]["loss"],
           "loop_step_ms": lp[0]["step_ms"],
           "one_process_loop_step_ms": loop1["step_ms"],
           "loop_refresh_s": lp[0]["refresh_s"],
           "one_process_loop_refresh_s": loop1["refresh_s"],
           "pool_overlap": overlap, "followed": one["followed"],
           "launches": {
               "flash_attention": [r["forward"]["1x4"]["launches"]
                                   + r["forward"]["2x2"]["launches"]
                                   for r in ranks],
               **{k: [r["loop"]["launches"].get(k, 0) for r in ranks]
                  for k in ("dml_pair", "metric_topk")}},
           "peak_gb": [r["peak_gb"] for r in ranks],
           "start_s": [r["start_s"] for r in ranks],
           "phase_s": time.perf_counter() - t_phase}
    log(f"multi-rank moe phase {out['phase_s']:.1f} s")
    assert not failed, f"phase 21 failed: {failed}"
    return out


# -- phase 22: the dry run's per-rank program, on meta and on the card -------

RK_ARCH = "yi-6b"
# yi-6b at full width cut to one layer (two until the attention families'
# phase 23 joined the script: the cut keeps the whole near 1,050 s)
RK_LAYERS = 1
RK_MESH = (2, 2)             # (data, model): 16 q heads and 2 kv heads a rank
RK_PREFILL = (2, 4096)       # B x T
RK_TRAIN = (4, 512)
RK_DECODE_B, RK_DECODE_STEPS = 2, 4
RK_LR = 1e-3
RK_DML = IMNET_63K           # L 10,000 x 21,504: its rows over model
RK_SWEEP = [(a, s) for a in ("smollm-135m", "yi-6b", "gemma-7b",
                             "command-r-35b")
            for s in ("train_4k", "decode_32k")]
RK_SWEEP_MESHES = ("16x16", "pod2x16x16")
RK_JOBS = 4                  # the sweep's processes, beside phases 12-21
RK_SWEEP_TARGET_S = 120.0
RK_TIMEOUT = 600.0
# bf16 forms against one process: the ranks' partial sums round to bf16
# apart (each rank's share of a row-parallel product, then their sum), so
# the ranks' bf16 answer and one process's each carry bf16's error, and
# by the triangle inequality they part by at most twice one process's
# bf16-to-f32 distance (leaf by leaf for the gradients)
RK_BF16_SLACK = 2.0


def _rk_cfg(dtype):
    return get_config(RK_ARCH).replace(n_layers=RK_LAYERS, dtype=dtype)


def _rk_inputs():
    """The seeded batches of (b): prefill tokens, training tokens and
    labels, the decode prompt, and the DML step's L and pairs."""
    V = _rk_cfg("float32").vocab_size
    rng = np.random.RandomState(22)
    B, T = RK_PREFILL
    Bt, Tt = RK_TRAIN
    dcfg = RK_DML.dml
    n = RK_DML.batch_size * RK_MESH[0]          # the paper's batch a rank
    return {"prefill": rng.randint(0, V, (B, T)).astype(np.int32),
            "tokens": rng.randint(0, V, (Bt, Tt)).astype(np.int32),
            "labels": rng.randint(0, V, (Bt, Tt)).astype(np.int32),
            "decode": rng.randint(0, V, (RK_DECODE_B, RK_DECODE_STEPS))
            .astype(np.int32),
            "dml_xs": rng.randn(n, dcfg.feat_dim).astype(np.float32),
            "dml_ys": rng.randn(n, dcfg.feat_dim).astype(np.float32),
            "dml_sim": (rng.rand(n) < 0.5).astype(np.int32)}


def rk_sweep_start():
    """22 (a), started: rank 0's records of the dense archs at train_4k
    and decode_32k and of the DML configs on both production meshes,
    each in a fake world of its own, in a pool of RK_JOBS processes that
    run on the host's idle cores beside the card's phases (meta tensors:
    no card, nothing allocated)."""
    pool = meta_pool(RK_JOBS)
    jobs = [(m, pool.apply_async(dryrun._record, (dryrun.Job(a, s), m)))
            for m in RK_SWEEP_MESHES for a, s in RK_SWEEP]
    dml = [(m, pool.apply_async(dryrun.dryrun_dml, (m,)))
           for m in RK_SWEEP_MESHES]
    pool.close()
    return {"pool": pool, "jobs": jobs, "dml": dml,
            "t0": time.perf_counter()}


def _rk_sweep(started):
    """22 (a), collected: a line a record; each "ok", its arguments the
    plan's, collectives issued."""
    records = {}
    for m, job in started["jobs"]:
        key, rec = job.get(timeout=RK_TIMEOUT)
        records[f"{key}|{m}"] = rec
    for m, job in started["dml"]:
        for name, rec in job.get(timeout=RK_TIMEOUT).items():
            records[f"{name}|paper_batch|{m}"] = rec
    started["pool"].join()
    secs = time.perf_counter() - started["t0"]
    cpu_s = sum(rec["trace_s"] for rec in records.values())
    for key, rec in records.items():
        log("22 (a) " + dryrun.summary_line(key, rec))
        assert rec["status"] == "ok", f"{key}: {rec}"
        assert rec["memory"]["argument_size"] == \
            rec["plan"]["argument_size"]
        assert rec["collectives"]["total_bytes"] > 0
    log(f"22 (a) {len(records)} per-rank records, {cpu_s:.1f} s of tracing "
        f"on {RK_JOBS} processes, collected {secs:.1f} s after their start "
        f"(they ran beside phases 12-21; target {RK_SWEEP_TARGET_S:.0f} s "
        f"alone)")
    return {"records": records, "sweep_s": secs, "trace_s": cpu_s}


def _rk_events(fn, barrier=True):
    """(fn(), ms between CUDA events around it on this rank's stream);
    under ``barrier`` every rank of the group starts it together."""
    torch.cuda.synchronize()
    if barrier:
        dist.barrier()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def _rk_prefill(inp, mesh, models, batch=None, ranks_dtypes=None,
                oracle=contextlib.nullcontext, follow_routes=()):
    """(b) the per-rank prefill through ``Model.apply(mesh=)`` in each
    dtype of ``ranks_dtypes`` (every one of ``models`` by default) on
    ``batch`` (phase 22's tokens by default); rank 0 holds the gathered
    logits and moe_aux to one process's forward (under ``oracle``; in
    the dtypes of ``follow_routes`` following the ranks' near-tied
    routes, each batch half's gathered over ``data``, beside the oracle
    routing itself: ``_followed``) and reads one process's bf16-to-f32
    distance (``bf16_err``, its aux's ``bf16_aux_err``). Every model's
    one-process forward runs, so a bf16-only prefill still has its f32
    yardstick."""
    if batch is None:
        batch = {"tokens": torch.from_numpy(inp["prefill"]).to(DEV)}
    out, ones = {}, {}
    with torch.inference_mode():
        for dtype, model in models.items():
            logits, routes = None, None
            follow = dtype in follow_routes
            if ranks_dtypes is None or dtype in ranks_dtypes:
                _reset_counts()
                with _moe_routes() as rec:
                    (logits, aux), ms = _rk_events(lambda: model.apply(
                        batch, mesh=mesh))
                out[dtype] = {"ms": ms,
                              "launches": _counts()["flash_attention"],
                              "ssd_launches": _counts()["ssd_scan"],
                              "checksum": _mrm_checksum([logits]),
                              "aux": float(aux["moe_aux"])}
                if follow:              # (halves, layers, tokens, k)
                    routes = partition.all_gather(torch.stack(rec["topi"]),
                                                  "data", mesh)
                del rec
            if mesh.rank == 0:
                _reset_counts()
                with oracle(**({"follow": routes} if follow else {})) \
                        as moved:
                    (one, one_aux), one_ms = _rk_events(
                        lambda: model.apply(batch), barrier=False)
                ones[dtype] = (one, float(one_aux["moe_aux"]))
                if logits is not None:
                    out[dtype].update(one_ms=one_ms, err=_rel(logits, one),
                                      one_aux=ones[dtype][1])
                if follow:
                    with oracle():
                        free = model.apply(batch)[0]
                    out[dtype]["followed"] = _followed(
                        moved, routes[..., 0].numel(), logits, free)
                    del free
                del one             # kept in ones until the last dtype
            del logits, routes
    if mesh.rank == 0:
        ref32, aux32 = ones.pop("float32")
        one16, aux16 = ones.pop("bfloat16")
        out["bfloat16"]["bf16_err"] = _rel(one16, ref32)
        out["bfloat16"]["bf16_aux_err"] = abs(aux16 - aux32) / max(
            abs(aux32), 1e-30)
    return out


def _rk_leaf_errs(a, b):
    return [float((x.float() - y.float()).abs().max())
            for x, y in zip(tree_leaves(a), tree_leaves(b))]


def _token_ce(model, batch):
    """One process's cross-entropy a token, f32 (B * T,), of the model's
    plain forward (the training step's) on ``batch``."""
    with torch.no_grad():
        logits = model.apply(batch, plain=True)[0]
        return torch.nn.functional.cross_entropy(
            logits.float().flatten(0, 1), batch["labels"].flatten().long(),
            reduction="none")


def _rk_train(inp, mesh, model, acct_mode, batch=None,
              oracle=contextlib.nullcontext, spread=False):
    """(b) and (c): one AdamW step on the rank's own blocks (the step's
    per-rank map; phase 22's batch unless ``batch``), counted by
    ``acct_mode`` (a ``CostMode``, or None) and its peak read; rank 0
    holds the loss, the first moments and the gathered parameters to one
    process's step in the model's dtype (and a bf16 step to the f32 one),
    both under ``oracle``. With ``spread`` a bf16 model's per-token
    cross-entropy is read against the f32 model's, d = ce16 - ce32 over
    the N tokens: ``tok_se``, std(d) / sqrt(N), the spread that bf16
    rounding gives a mean over N tokens."""
    run = RunConfig(arch=model.cfg.name, lr=RK_LR, total_steps=10,
                    warmup=0)
    opt = steps_lib.make_optimizer(run)
    if batch is None:
        batch = {"tokens": torch.from_numpy(inp["tokens"]).to(DEV),
                 "labels": torch.from_numpy(inp["labels"]).to(DEV)}
    out = {}
    if mesh.rank == 0:
        one32 = met32 = None
        if model.cfg.dtype != "float32":
            m32 = Model(model.cfg.replace(dtype="float32"), device=DEV,
                        params=model.param_tree())
            st = steps_lib.init_train_state(m32, opt)
            with oracle():
                one32, met32 = steps_lib.make_train_step(m32, opt, run)(
                    st, batch)
                ce32 = _token_ce(m32, batch) if spread else None
            del st, m32
        st = steps_lib.init_train_state(model, opt)
        one_step = steps_lib.make_train_step(model, opt, run)
        with oracle():
            (one, met), out["one_ms"] = _rk_events(
                lambda: one_step(st, batch), barrier=False)
        out["one_loss"] = float(met["loss"])
        out["one_gnorm"] = float(met["grad_norm"])
        if spread and one32 is not None:
            with oracle():
                d = _token_ce(model, batch) - ce32
            out["tok_se"] = float(d.std() / d.numel() ** 0.5)
            out["tok_rms"] = float(d.square().mean().sqrt())
            del d, ce32
        if one32 is not None:
            out["loss32"] = float(met32["loss"])
            out["bf16_m_err"] = _rk_leaf_errs(one.opt_state.m,
                                              one32.opt_state.m)
        out["m_max"] = max(float(x.abs().max())
                           for x in tree_leaves(one.opt_state.m))
        one_params, one_m = one.params, one.opt_state.m
        del one, st, one32
        gc.collect()
        torch.cuda.empty_cache()
    rmap = steps_lib.rank_train_map(model, opt, run, mesh, batch)
    pblocks, bblocks = partition.rank_blocks(
        (model.param_tree(), batch),
        (rmap.in_specs[0].params, rmap.in_specs[1]), mesh)
    # fresh moments as the plan places them (hubert's norm moments are
    # sharded over data where the leaves are not): zeros of the blocks
    # of the parameters under the moments' specs
    mshapes = partition.rank_blocks(model.param_tree(),
                                    rmap.in_specs[0].opt_state.m, mesh)
    state = steps_lib.TrainState(pblocks, opt.init(mshapes),
                                 torch.zeros((), dtype=torch.int32,
                                             device=DEV))
    args = (state, bblocks)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    argument = sum(t.untyped_storage().nbytes() for t in
                   {id(t): t for t in tree_leaves(args)}.values())
    torch.cuda.reset_peak_memory_stats()
    mode = acct_mode() if acct_mode else None
    with mode or contextlib.nullcontext():
        (new, met), ms = _rk_events(lambda: rmap.body(*args))
    peak = torch.cuda.max_memory_allocated() - base + argument
    out.update(ms=ms, loss=float(met["loss"]), gnorm=float(met["grad_norm"]),
               collectives=mode.collectives() if mode else None, peak=peak,
               argument=argument)
    # the parameters and first moments gathered leaf by leaf (every rank
    # takes part), held on rank 0
    sspecs = rmap.in_specs[0]
    out["errs"] = {"params": [], "m": []}
    for name, blocks, specs in (("params", new.params, sspecs.params),
                                ("m", new.opt_state.m, sspecs.opt_state.m)):
        refs = tree_leaves(one_params if name == "params" else one_m) \
            if mesh.rank == 0 else None
        with torch.no_grad():
            for i, (x, spec) in enumerate(partition.spec_leaves(blocks,
                                                                specs)):
                full = partition.unblock(x, spec, mesh)
                if mesh.rank == 0:
                    out["errs"][name].append(float(
                        (full.float() - refs[i].float()).abs().max()))
                del full
    del new, state, args
    return out


def _rk_decode(inp, mesh, model, prompt=None):
    """(b) decode (phase 22's prompt unless ``prompt``: B 2, f32) on the
    rank's heads (the cache over kv heads: 4 on a model axis of 2); rank
    0 holds its logits to one process's decode."""
    if prompt is None:
        prompt = torch.from_numpy(inp["decode"]).to(DEV)
    B, n = prompt.shape
    out = {}
    with torch.inference_mode():
        for name, m in (("ranks", mesh), ("one", None)):
            if name == "one" and mesh.rank != 0:
                continue
            cache = model.init_decode_cache(B, n)
            logits = []
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(n + 1)]
            torch.cuda.synchronize()
            for t in range(n):
                marks[t].record()
                lg, cache = model.decode_step(cache, prompt[:, t], t, mesh=m)
                logits.append(lg)
            marks[-1].record()
            torch.cuda.synchronize()
            # the first token's step left out (first calls)
            out[name] = {"logits": torch.stack(logits),
                         "ms_token": marks[1].elapsed_time(marks[-1])
                         / (n - 1)}
            del cache
    if mesh.rank == 0:
        out["err"] = _rel(out["ranks"]["logits"], out["one"]["logits"])
    out["checksum"] = _mrm_checksum([out["ranks"].pop("logits")])
    out.get("one", {}).pop("logits", None)
    return out


def _rk_dml(inp, mesh):
    """(b) the per-rank Eq. 4 step of imnet63k at its paper width: L's
    10,000 rows over model, the pairs over data, dml_pair on each rank;
    rank 0 holds the gathered L to one process's step."""
    dcfg = RK_DML.dml
    gen = torch.Generator(device=DEV).manual_seed(22)
    L = init_params(dcfg, gen, DEV)
    batch = {"xs": torch.from_numpy(inp["dml_xs"]).to(DEV),
             "ys": torch.from_numpy(inp["dml_ys"]).to(DEV),
             "sim": torch.from_numpy(inp["dml_sim"]).to(DEV)}
    _, specs = dryrun.dml_specs(dcfg, batch["xs"].shape[0], mesh)
    assert specs[0][0] == "model", specs
    blocks = partition.rank_blocks((L, batch), specs, mesh)
    step = dryrun._dml_step(dcfg, mesh, rows_split=True)
    _reset_counts()
    (new, loss), ms = _rk_events(lambda: step(*blocks))
    out = {"ms": ms, "launches": _counts()["dml_pair"], "loss": float(loss)}
    full = partition.all_gather(new, "model", mesh, tiled=True)
    if mesh.rank == 0:
        one_step = dryrun._dml_step(dcfg)
        (one, one_loss), one_ms = _rk_events(lambda: one_step(L, batch),
                                             barrier=False)
        d2 = dml.mahalanobis_sqdist(L, batch["xs"], batch["ys"])
        out.update(one_ms=one_ms, one_loss=float(one_loss),
                   near_margin=int(((d2 - dcfg.margin).abs() < 1e-3).sum()),
                   dL_err=float(((L - full) - (L - one)).abs().max()
                                / (L - one).abs().max()))
    return out


def _rk_rank(inp, mesh):
    """Phase 22 (b) and (c) on this rank of ``ranks_spawn``."""
    from repro_torch.launch.cost_analysis import CostMode
    out = {}
    model = Model(_rk_cfg("float32"), device=DEV, seed=0)
    models = {"bfloat16": Model(_rk_cfg("bfloat16"), device=DEV,
                                params=model.param_tree()),
              "float32": model}
    out["prefill"] = _rk_prefill(inp, mesh, models)
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = _rk_train(inp, mesh, models["bfloat16"], CostMode)
    gc.collect()
    torch.cuda.empty_cache()
    out["decode"] = _rk_decode(inp, mesh, model)
    del model, models
    gc.collect()
    torch.cuda.empty_cache()
    out["dml"] = _rk_dml(inp, mesh)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def phase_ranks(card, sweep=None, spawned=None):
    """Phase 22: the dry run's per-rank program: (a) rank 0's records on
    the production meshes, traced on meta (``sweep``, from
    ``rk_sweep_start``; started here if None); (b) the same program on
    four ranks sharing the card over gloo, held to one process
    (``spawned``, from ``ranks_spawn``; spawned here if None); (c) the
    account of (b)'s training step in a fake world of the same (2, 2),
    held to what rank 0 issued and allocated."""
    t_phase = time.perf_counter()
    sweep = _rk_sweep(sweep or rk_sweep_start())
    shape = InputShape("held", RK_TRAIN[1], RK_TRAIN[0], "train")
    with card_figures.fake_world(card_figures.Mesh(("data", "model"),
                                                   RK_MESH)) as live:
        acct = dryrun.rank_account(_rk_cfg("bfloat16"), shape, live)
    spawned = spawned or ranks_spawn(dense=True)
    ranks, spawn_s = spawned["dense"], spawned["spawn_s"]
    r0 = ranks[0]
    note = (f"{card}; {len(ranks)} ranks share one card over "
            f"{r0['backend']}, which stages every collective through the "
            f"host")
    failed = []

    def hold(ok, what):
        if not ok:
            failed.append(what)

    # (b) prefill
    for dtype in ("float32", "bfloat16"):
        p = r0["prefill"][dtype]
        bound = DECODE_REL_BOUND if dtype == "float32" else \
            RK_BF16_SLACK * p["bf16_err"]
        hold(p["err"] <= bound, f"prefill {dtype}")
        hold(all(r["prefill"][dtype]["checksum"] == p["checksum"]
                 for r in ranks), f"prefill {dtype} ranks differ")
        hold(all(r["prefill"][dtype]["launches"] == RK_LAYERS
                 for r in ranks), f"prefill {dtype} launches")
        log(f"22 (b) {RK_ARCH} prefill ({RK_LAYERS} layers at full width, "
            f"B {RK_PREFILL[0]} x T {RK_PREFILL[1]}, {dtype}; a rank's 16 q "
            f"and 2 kv heads of 128 on flash_attention): "
            f"{p['ms']:.2f} ms over ranks against {p['one_ms']:.2f} ms one "
            f"process (device ms, CUDA events on rank 0); logits within "
            f"{p['err']:.3e} x max of one process's (bound {bound:.3e}"
            + ("" if dtype == "float32" else ", its bf16 forward's own "
               "distance from f32") + f"); flash_attention launches by "
            f"rank {[r['prefill'][dtype]['launches'] for r in ranks]}; "
            f"{note}")
    # (b) training, (c) its account
    tr = r0["train"]
    loss_rel = abs(tr["loss"] - tr["one_loss"]) / abs(tr["one_loss"])
    loss_bound = RK_BF16_SLACK * abs(tr["one_loss"] - tr["loss32"]) \
        / abs(tr["loss32"])
    hold(loss_rel <= loss_bound, "train loss")
    by_leaf = [round(e / (b + 1e-30), 2) for e, b in
               zip(tr["errs"]["m"], tr["bf16_m_err"])]
    m_share = max(e / (RK_BF16_SLACK * b + 1e-12) for e, b in
                  zip(tr["errs"]["m"], tr["bf16_m_err"]))
    hold(m_share <= 1.0, "train first moments")
    hold(max(tr["errs"]["params"]) <= 2 * RK_LR + 1e-6, "train params")
    log(f"22 (b) {RK_ARCH} training ({RK_LAYERS} layers, B {RK_TRAIN[0]} x "
        f"T {RK_TRAIN[1]}, bf16 activations, f32 weights, AdamW lr {RK_LR}, "
        f"remat): {tr['ms']:.1f} ms a step over ranks against "
        f"{tr['one_ms']:.1f} ms one process (device ms); loss "
        f"{tr['loss']:.5f} against {tr['one_loss']:.5f} one process (rel "
        f"{loss_rel:.2e}, bound {loss_bound:.2e}: bf16's own distance from "
        f"f32); first moments within {max(tr['errs']['m']):.3e}, the worst "
        f"leaf at {m_share:.3f} of its bound ({RK_BF16_SLACK:g} x its bf16-"
        f"to-f32 distance; by leaf {by_leaf}); parameters within "
        f"{max(tr['errs']['params']):.3e} (bound 2 lr); {note}")
    live_c, acct_c = tr["collectives"], acct["collectives"]
    same = live_c["counts"] == acct_c["counts"] and \
        live_c["bytes"] == acct_c["bytes"]
    hold(same, "account collectives")
    ratio = acct["peak_bytes"] / tr["peak"]
    lo, hi = PEAK_RATIO_BAND
    hold(lo <= ratio <= hi, "account peak")
    hold(acct["memory"]["argument_size"] == tr["argument"],
         "account arguments")
    log(f"22 (c) account of the step in a fake world of (2, 2): collectives "
        f"{acct_c['counts']} ({acct_c['total_bytes'] / 1e9:.4f} GB), rank "
        f"0 issued {live_c['counts']} ({live_c['total_bytes'] / 1e9:.4f} "
        f"GB): equal {same}; peak {acct['peak_bytes'] / 1e9:.3f} GB against "
        f"rank 0's {tr['peak'] / 1e9:.3f} GB (ratio {ratio:.3f}, band "
        f"{PEAK_RATIO_BAND}); arguments {acct['memory']['argument_size']} "
        f"B, rank 0's {tr['argument']} B; {note}")
    # (b) decode and DML
    dc = r0["decode"]
    hold(dc["err"] <= DECODE_REL_BOUND, "decode")
    hold(all(r["decode"]["checksum"] == dc["checksum"] for r in ranks),
         "decode ranks differ")
    log(f"22 (b) {RK_ARCH} decode (B {RK_DECODE_B}, {RK_DECODE_STEPS} "
        f"tokens, f32, the cache over kv heads): "
        f"{dc['ranks']['ms_token']:.2f} ms/token over ranks against "
        f"{dc['one']['ms_token']:.2f} one process (device ms, CUDA events "
        f"on rank 0); logits "
        f"within {dc['err']:.3e} (bound {DECODE_REL_BOUND}); {note}")
    dm = r0["dml"]
    hold(dm["near_margin"] == 0, "dml hinge")
    hold(dm["dL_err"] <= 1e-4, "dml step")
    hold(abs(dm["loss"] - dm["one_loss"]) <= 1e-5 * abs(dm["one_loss"]),
         "dml loss")
    hold(all(r["dml"]["launches"] == 1 for r in ranks), "dml launches")
    log(f"22 (b) {RK_DML.name} per-rank Eq. 4 step (L "
        f"{RK_DML.dml.proj_dim} x {RK_DML.dml.feat_dim}, its rows over "
        f"model, {RK_DML.batch_size} pairs a data rank): {dm['ms']:.2f} ms "
        f"over ranks against {dm['one_ms']:.2f} ms one process (device ms); "
        f"dL within {dm['dL_err']:.3e} x max |dL| (bound 1e-4); loss "
        f"{dm['loss']:.6f} against {dm['one_loss']:.6f}; dml_pair launches "
        f"by rank {[r['dml']['launches'] for r in ranks]}; {note}")
    log(f"22 ranks: peak GB {[round(r['peak_gb'], 2) for r in ranks]}; "
        f"spawn and work {spawn_s:.1f} s ({spawned['phases']}); {note}")
    out = {"card": card, "sweep_s": sweep["sweep_s"],
           "sweep_trace_s": sweep["trace_s"],
           "records": {k: {f: v.get(f) for f in (
               "flops_per_chip", "hbm_bytes_per_chip", "memory",
               "collectives", "roofline", "trace_s")}
               for k, v in sweep["records"].items()},
           "prefill": r0["prefill"], "train": {
               k: tr[k] for k in ("ms", "one_ms", "loss", "one_loss",
                                  "loss32", "gnorm", "one_gnorm", "peak",
                                  "argument", "collectives")},
           "account": {"collectives": acct_c, "peak": acct["peak_bytes"],
                       "ratio": ratio},
           "decode": dc, "dml": dm, "spawn_s": spawn_s,
           "launches": {
               "flash_attention": [
                   sum(r["prefill"][d]["launches"]
                       for d in ("float32", "bfloat16")) for r in ranks],
               "dml_pair": [r["dml"]["launches"] for r in ranks]},
           "peak_gb": [r["peak_gb"] for r in ranks],
           "phase_s": time.perf_counter() - t_phase}
    log(f"per-rank phase {out['phase_s']:.1f} s")
    assert not failed, f"phase 22 failed: {failed}"
    return out


# -- phase 23: the per-rank program of the attention families ---------------

# (a): rank 0's records of the moe, vlm and audio families at full depth;
# hubert's 32k prefill is traced at phase 19's 8,192-token attention
# chunks (ACCOUNT_CHUNKS: 16 tiles a layer, not 1,024, for the trace's
# time; the plain path computes every tile's product either way)
RF_SWEEP = ([(a, s) for a in (MOE, MOE_QWEN, VLM)
             for s in ("train_4k", "decode_32k")]
            + [(AUDIO, "train_4k"), (AUDIO, "prefill_32k")])
RF_OVERRIDES = {(AUDIO, "prefill_32k"): ACCOUNT_CHUNKS}
RF_JOBS = 1                  # beside phase 22's RK_JOBS, phases 12-22
RF_SWEEP_TARGET_S = 90.0
# (b): full width, cut in depth; four ranks on (data 2, model 2); the
# whole script took 1,080.9 s with granite-moe at 4 layers and yi-6b (22)
# at 2, so both were cut by half; then 959.1-1,098.5 s on the same code,
# so the decode was cut to phase 22's 4 tokens (pixtral's step gathers
# its 131,072 x 5,120 embedding over data through gloo: 4.6 s a token)
RF_LAYERS = {MOE: 2, VLM: 2, AUDIO: 4, LM_ARCH: 4}
RF_PREFILL = (2, 4096)       # B x T
RF_TRAIN = (4, 512)
RF_DECODE = (2, 4)           # B, tokens
RF_TARGET_S = 150.0
# the bf16 steps' loss yardstick: one process's bf16-to-f32 distance
# plus this many standard errors of its per-token distance (_rk_train's
# ``tok_se``)
RF_LOSS_SE = 4.0


def _rf_cfg(arch, dtype):
    return get_config(arch).replace(n_layers=RF_LAYERS[arch], dtype=dtype)


def _rf_cp_split():
    """smollm-135m's context-parallel split on RK_MESH's model axis:
    (q chunk, chunks, rows a rank of each), the offsets of the last
    rank's slices."""
    cfg = _rf_cfg(LM_ARCH, "bfloat16")
    M = RK_MESH[1]
    cp = attention._cp_rows(RF_PREFILL[1], cfg, M)
    return cp, attention.cp_offsets(cp, M - 1)


def rf_sweep_start(pairs=None, overrides=None, jobs=RF_JOBS):
    """23 (a), started: rank 0's records of ``pairs`` (RF_SWEEP's; each
    with its ``overrides``, RF_OVERRIDES') on both production meshes,
    each in a fake world of its own, in a pool of ``jobs`` processes
    beside the card's phases (meta tensors: no card); 24 (a) too."""
    pairs = RF_SWEEP if pairs is None else pairs
    overrides = RF_OVERRIDES if overrides is None else overrides
    pool = meta_pool(jobs)
    started = [(m, pool.apply_async(dryrun._record, (
        dryrun.Job(a, s, overrides.get((a, s))), m)))
        for m in RK_SWEEP_MESHES for a, s in pairs]
    pool.close()
    return {"pool": pool, "jobs": started, "n": jobs,
            "t0": time.perf_counter()}


def _rf_sweep(started, tag="23 (a)", what="of the moe, vlm and audio "
              "families (full depth; hubert's prefill_32k at "
              f"{ACCOUNT_CHUNKS['attn_q_chunk']}-token attention chunks)",
              target_s=RF_SWEEP_TARGET_S):
    """23 (a) (or 24 (a), ``tag``), collected: a line a record; each "ok",
    its arguments the plan's, collectives issued."""
    t_wait = time.perf_counter()
    records = {}
    for m, job in started["jobs"]:
        key, rec = job.get(timeout=RK_TIMEOUT)
        records[f"{key}|{m}"] = rec
    started["pool"].join()
    wait_s = time.perf_counter() - t_wait
    secs = time.perf_counter() - started["t0"]
    cpu_s = sum(rec.get("trace_s", 0.0) for rec in records.values())
    bad = []
    for key, rec in records.items():
        log(f"{tag} " + dryrun.summary_line(key, rec))
        if rec["status"] != "ok" or \
                rec["memory"]["argument_size"] != \
                rec["plan"]["argument_size"] or \
                rec["collectives"]["total_bytes"] <= 0:
            bad.append(key)
    log(f"{tag} {len(records)} per-rank records {what}, {cpu_s:.1f} s of "
        f"tracing on {started['n']} processes beside the card's phases, "
        f"collected {secs:.1f} s after their start; the phase waited "
        f"{wait_s:.1f} s for them (target {target_s:.0f} s)")
    return {"records": records, "sweep_s": secs, "trace_s": cpu_s,
            "wait_s": wait_s, "bad": bad}


def _rf_inputs():
    """The seeded batches of (b): granite-moe's prefill tokens, training
    tokens and labels and decode prompt; pixtral's patch embeddings and
    decode prompt; hubert's frame embeddings and training frames and
    labels; smollm's prefill tokens."""
    rng = np.random.RandomState(23)
    B, T = RF_PREFILL
    Bt, Tt = RF_TRAIN
    V = {a: get_config(a).vocab_size for a in (MOE, VLM, AUDIO, LM_ARCH)}
    d = {a: get_config(a).d_model for a in (VLM, AUDIO)}
    def ids(arch, shape):               # int32, as the plan's inputs
        return rng.randint(0, V[arch], shape).astype(np.int32)

    return {MOE: {"prefill": ids(MOE, (B, T)), "tokens": ids(MOE, (Bt, Tt)),
                  "labels": ids(MOE, (Bt, Tt)),
                  "decode": ids(MOE, RF_DECODE)},
            VLM: {"prefill": rng.randn(B, T, d[VLM]).astype(np.float32),
                  "decode": ids(VLM, RF_DECODE)},
            AUDIO: {"prefill": rng.randn(B, T, d[AUDIO]).astype(np.float32),
                    "embeddings": rng.randn(Bt, Tt, d[AUDIO]).astype(
                        np.float32),
                    "labels": ids(AUDIO, (Bt, Tt))},
            LM_ARCH: {"prefill": ids(LM_ARCH, (B, T))}}


def _rf_on(x):
    return torch.from_numpy(np.asarray(x)).to(DEV)


def _rf_models(arch, make_cfg=None):
    """(f32 model, {"bfloat16": ..., "float32": ...}) sharing one seeded
    f32 weight set (bf16 activations, f32 weights); ``make_cfg(arch,
    dtype)`` is ``_rf_cfg`` unless given."""
    make_cfg = make_cfg or _rf_cfg
    model = Model(make_cfg(arch, "float32"), device=DEV, seed=0)
    return model, {"bfloat16": Model(make_cfg(arch, "bfloat16"), device=DEV,
                                     params=model.param_tree()),
                   "float32": model}


def _rf_free():
    gc.collect()
    torch.cuda.empty_cache()


def _rf_rank(inp, mesh):
    """Phase 23 (b) and (c) on this rank of ``ranks_spawn``: the four
    models one after another."""
    from repro_torch.launch.cost_analysis import CostMode
    out = {"t": {}}
    t0 = time.perf_counter()
    # granite-moe-1b: the moe nested in the program (one process's oracle
    # routes each batch half apart, as the ranks of (2, 2) do)
    x = inp[MOE]
    model, models = _rf_models(MOE)
    out[MOE] = {"prefill": _rk_prefill(
        inp, mesh, models, batch={"tokens": _rf_on(x["prefill"])},
        oracle=_moe_as_on_2x2, follow_routes=("float32",))}
    _rf_free()
    out[MOE]["train"] = _rk_train(
        inp, mesh, models["bfloat16"], CostMode,
        batch={"tokens": _rf_on(x["tokens"]), "labels": _rf_on(x["labels"])},
        oracle=_moe_as_on_2x2, spread=True)
    _rf_free()
    out[MOE]["decode"] = _rk_decode(inp, mesh, model,
                                    prompt=_rf_on(x["decode"]))
    del model, models
    _rf_free()
    out["t"][MOE] = time.perf_counter() - t0
    # pixtral-12b: patch embeddings in (bf16), decode on tokens (f32)
    t0 = time.perf_counter()
    x = inp[VLM]
    model, models = _rf_models(VLM)
    out[VLM] = {"prefill": _rk_prefill(
        inp, mesh, models, batch={"embeddings": _rf_on(x["prefill"])},
        ranks_dtypes=("bfloat16",))}
    _rf_free()
    out[VLM]["decode"] = _rk_decode(inp, mesh, model,
                                    prompt=_rf_on(x["decode"]))
    del model, models
    _rf_free()
    out["t"][VLM] = time.perf_counter() - t0
    # hubert-xlarge: frame embeddings in, non-causal, biases
    t0 = time.perf_counter()
    x = inp[AUDIO]
    model, models = _rf_models(AUDIO)
    out[AUDIO] = {"prefill": _rk_prefill(
        inp, mesh, models, batch={"embeddings": _rf_on(x["prefill"])},
        ranks_dtypes=("bfloat16",))}
    _rf_free()
    out[AUDIO]["train"] = _rk_train(
        inp, mesh, models["bfloat16"], None,
        batch={"embeddings": _rf_on(x["embeddings"]),
               "labels": _rf_on(x["labels"])}, spread=True)
    del model, models
    _rf_free()
    out["t"][AUDIO] = time.perf_counter() - t0
    # smollm-135m: 9 heads on a model axis of 2, context parallelism
    t0 = time.perf_counter()
    model, models = _rf_models(LM_ARCH)
    out[LM_ARCH] = {"prefill": _rk_prefill(
        inp, mesh, models, batch={"tokens": _rf_on(inp[LM_ARCH]["prefill"])},
        ranks_dtypes=("bfloat16",))}
    del model, models
    _rf_free()
    out["t"][LM_ARCH] = time.perf_counter() - t0
    return out


def _rf_cp_entry(launches, card):
    """The kernels-line entry of smollm's context-parallel slice: the
    last rank's last slice (512 rows at q_offset 3,584 of a causal 4,096,
    9 heads on 3 kv heads of 64, B 2, bf16) against every key, on seeded
    q, k, v: kernel, plain version (``attention_ref`` at the offset) and
    ``scaled_dot_product_attention`` with the offset's causal mask as an
    explicit ``attn_mask``; its parity against the plain version."""
    cfg = get_config(LM_ARCH)
    (qc, nq, rows), offs = _rf_cp_split()
    off = offs[-1]
    B, S = RF_PREFILL
    H, K, dh = cfg.n_heads, cfg.kv_heads, cfg.dim_per_head
    gen = torch.Generator(device=DEV).manual_seed(33)
    q = torch.randn((B, rows, H, dh), generator=gen, device=DEV).to(
        torch.bfloat16)
    k, v = (torch.randn((B, S, K, dh), generator=gen, device=DEV).to(
        torch.bfloat16) for _ in range(2))
    err, top, worst = check_flash(q, k, v, True, 0, off)
    pos = off + torch.arange(rows, device=DEV)
    mask = torch.arange(S, device=DEV)[None, :] <= pos[:, None]
    fn = lambda: flash_attention(q, k, v, causal=True,  # noqa: E731
                                 q_offset=off)
    plain = lambda: attention_ref(q, k, v, causal=True,  # noqa: E731
                                  q_offset=off)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)
    with torch.inference_mode():
        eager, graphed, best = _device_times(fn, plain, lib, (20, 3, 20))
    pairs = rows * off + rows * (rows + 1) // 2
    b_ms, b_by = roofline(4.0 * dh * pairs * B * H,
                          2.0 * (2 * q.numel() + 2 * k.numel()),
                          PEAK_BF16_FLOPS)
    log(f"flash_attention {LM_ARCH} context-parallel slice B={B} rows="
        f"{rows} at q_offset {off} of T={S}, H={H} K={K} Dh={dh} causal "
        f"(bf16): device ms by graph replay: kernel {best['ms']:.4f}, plain "
        f"{best['plain_ms']:.4f}, library {best['library_ms']:.4f} (SDPA, "
        f"explicit mask); eager kernel {eager['ms']:.4f}; bound {b_ms:.4f} "
        f"ms ({b_by}), {b_ms / best['ms']:.1%} of bound; parity max |d| "
        f"{err:.3e} (max |ref| {top:.3f}), {worst:.3f} of the bound; "
        f"launches in 23 (b) by rank {launches}; {card}")
    del q, k, v
    torch.cuda.empty_cache()
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:80",
            "launches": sum(launches), "launches_by_rank": launches,
            "max_abs_err": err, **best, "bound_ms": b_ms, "bound_by": b_by,
            "eager_ms": eager, "graph_ms": graphed,
            "shape": {"B": B, "T": rows, "S": S, "H": H, "K": K, "Dh": dh,
                      "causal": True, "window": 0, "q_offset": off,
                      "config": LM_ARCH, "pairs_per_head": pairs}}


def phase_ranks_families(card, sweep=None, spawned=None):
    """Phase 23: the per-rank program of the attention families: (a)
    rank 0's records of the moe, vlm and audio families on the
    production meshes, traced on meta (``sweep``, from
    ``rf_sweep_start``; started here if None); (b) granite-moe-1b,
    pixtral-12b, hubert-xlarge and smollm-135m (context parallelism) on
    four ranks sharing the card over gloo, held to one process; (c) the
    account of (b)'s granite-moe step in a fake world of the same (2, 2),
    held to what rank 0 issued and allocated; smollm's context-parallel
    slice timed for the kernels line. (b) runs in ``spawned`` (from
    ``ranks_spawn``; spawned here if None)."""
    t_phase = time.perf_counter()
    sweep = _rf_sweep(sweep or rf_sweep_start())
    shape = InputShape("held", RF_TRAIN[1], RF_TRAIN[0], "train")
    with card_figures.fake_world(card_figures.Mesh(("data", "model"),
                                                   RK_MESH)) as live:
        acct = dryrun.rank_account(_rf_cfg(MOE, "bfloat16"), shape, live)
    spawned = spawned or ranks_spawn(families=True)
    ranks, spawn_s = spawned["families"], spawned["spawn_s"]
    r0 = ranks[0]
    note = (f"{card}; {len(ranks)} ranks share one card over "
            f"{r0['backend']}, which stages every collective through the "
            f"host")
    failed = [f"23 (a) {k}" for k in sweep["bad"]]

    def hold(ok, what):
        if not ok:
            failed.append(what)

    (qc, nq, rows), offs = _rf_cp_split()
    # the flash_attention launches a rank a prefill: one a layer on the
    # rank's heads, smollm's one a q chunk a layer at its offsets
    want = {MOE: RF_LAYERS[MOE], VLM: RF_LAYERS[VLM],
            AUDIO: RF_LAYERS[AUDIO], LM_ARCH: RF_LAYERS[LM_ARCH] * nq}
    what = {MOE: "tokens; 8 of 16 q and 4 of 8 kv heads of 64 and 16 of 32 "
                 "experts a rank",
            VLM: "patch embeddings; GQA 32/8 at Dh 128, 16 q and 4 kv heads "
                 "a rank",
            AUDIO: "frame embeddings; non-causal, biases, 8 heads of 80 a "
                   "rank",
            LM_ARCH: f"tokens; 9 heads on a model axis of 2: context "
                     f"parallelism, {nq} q chunks of {qc}, {rows} rows a "
                     f"rank of each at q_offset c x {qc} + m x {rows}"}
    for arch in (MOE, VLM, AUDIO, LM_ARCH):
        for dtype, p in r0[arch]["prefill"].items():
            bound = DECODE_REL_BOUND if dtype == "float32" else \
                RK_BF16_SLACK * r0[arch]["prefill"]["bfloat16"]["bf16_err"]
            hold(p["err"] <= bound, f"{arch} prefill {dtype}")
            hold(all(r[arch]["prefill"][dtype]["checksum"] == p["checksum"]
                     for r in ranks), f"{arch} prefill {dtype} ranks differ")
            launches = [r[arch]["prefill"][dtype]["launches"] for r in ranks]
            hold(all(n == want[arch] for n in launches),
                 f"{arch} prefill {dtype} launches {launches}")
            aux = ""
            if "followed" in p:
                hold(p["followed"]["ok"],
                     f"{arch} prefill {dtype} routes: {p['followed']}")
                aux = f"; {_followed_line(p['followed'])}"
            if arch == MOE:
                aux_rel = abs(p["aux"] - p["one_aux"]) / p["one_aux"]
                aux_bound = MOE_AUX_KERNEL_REL if dtype == "float32" else \
                    RK_BF16_SLACK * r0[MOE]["prefill"]["bfloat16"][
                        "bf16_aux_err"]
                hold(aux_rel <= aux_bound, f"{arch} moe_aux {dtype}")
                aux += (f"; moe_aux {p['aux']:.6f} against "
                        f"{p['one_aux']:.6f} (rel {aux_rel:.2e}, bound "
                        f"{aux_bound:.2e})")
            log(f"23 (b) {arch} prefill ({RF_LAYERS[arch]} layers at full "
                f"width, B {RF_PREFILL[0]} x T {RF_PREFILL[1]}, {dtype}, "
                f"{what[arch]}): {p['ms']:.2f} ms over ranks against "
                f"{p['one_ms']:.2f} ms one process (device ms, CUDA events on "
                f"rank 0); logits within {p['err']:.3e} x max of one "
                f"process's (bound {bound:.3e}"
                + ("" if dtype == "float32" else ", twice its bf16 forward's "
                   "own distance from f32") + f"){aux}; flash_attention "
                f"launches by rank {launches} (want {want[arch]}); {note}")
    for arch in (MOE, AUDIO):
        # bf16 activations, f32 weights: phase 22's bounds, the loss's
        # yardstick (one process's bf16-to-f32 distance) plus RF_LOSS_SE
        # standard errors of the per-token distance (``tok_se``): alone, a
        # scalar's distance can fall below the ranks' bf16 noise by chance
        # (hubert's did, at 5.4e-6 against the ranks' 2.87e-5)
        tr = r0[arch]["train"]
        loss_rel = abs(tr["loss"] - tr["one_loss"]) / abs(tr["one_loss"])
        shift = abs(tr["one_loss"] - tr["loss32"])
        loss_bound = RK_BF16_SLACK * (shift + RF_LOSS_SE * tr["tok_se"]) \
            / abs(tr["loss32"])
        m_share = max(e / (RK_BF16_SLACK * b + 1e-12) for e, b in
                      zip(tr["errs"]["m"], tr["bf16_m_err"]))
        held = (f"loss bound {loss_bound:.2e}: twice bf16's own distance "
                f"from f32, {shift:.3e}, plus {RF_LOSS_SE:g} x its "
                f"per-token standard error {tr['tok_se']:.3e} (per-token "
                f"rms {tr['tok_rms']:.3e}); moments: the worst leaf at "
                f"{m_share:.3f} of twice its bf16-to-f32 distance")
        dtypes = "bf16 activations, f32 weights"
        hold(loss_rel <= loss_bound, f"{arch} train loss")
        hold(m_share <= 1.0, f"{arch} train first moments")
        hold(max(tr["errs"]["params"]) <= 2 * RK_LR + 1e-6,
             f"{arch} train params")
        log(f"23 (b) {arch} training ({RF_LAYERS[arch]} layers, B "
            f"{RF_TRAIN[0]} x T {RF_TRAIN[1]}, {dtypes}, AdamW lr {RK_LR}, "
            f"remat): {tr['ms']:.1f} ms a step over ranks against "
            f"{tr['one_ms']:.1f} ms one process (device ms); loss "
            f"{tr['loss']:.5f} against {tr['one_loss']:.5f} one process "
            f"(rel {loss_rel:.2e}; {held}); first moments within "
            f"{max(tr['errs']['m']):.3e}; parameters within "
            f"{max(tr['errs']['params']):.3e} (bound 2 lr); {note}")
    tr = r0[MOE]["train"]
    live_c, acct_c = tr["collectives"], acct["collectives"]
    same = live_c["counts"] == acct_c["counts"] and \
        live_c["bytes"] == acct_c["bytes"]
    hold(same, "account collectives")
    ratio = acct["peak_bytes"] / tr["peak"]
    lo, hi = PEAK_RATIO_BAND
    hold(lo <= ratio <= hi, "account peak")
    hold(acct["memory"]["argument_size"] == tr["argument"],
         "account arguments")
    log(f"23 (c) account of the {MOE} step in a fake world of (2, 2): "
        f"collectives {acct_c['counts']} ({acct_c['total_bytes'] / 1e9:.4f} "
        f"GB), rank 0 issued {live_c['counts']} "
        f"({live_c['total_bytes'] / 1e9:.4f} GB): equal {same}; peak "
        f"{acct['peak_bytes'] / 1e9:.3f} GB against rank 0's "
        f"{tr['peak'] / 1e9:.3f} GB (ratio {ratio:.3f}, band "
        f"{PEAK_RATIO_BAND}); arguments {acct['memory']['argument_size']} "
        f"B, rank 0's {tr['argument']} B; {note}")
    for arch in (MOE, VLM):
        dc = r0[arch]["decode"]
        hold(dc["err"] <= DECODE_REL_BOUND, f"{arch} decode")
        hold(all(r[arch]["decode"]["checksum"] == dc["checksum"]
                 for r in ranks), f"{arch} decode ranks differ")
        log(f"23 (b) {arch} decode (B {RF_DECODE[0]}, {RF_DECODE[1]} tokens, "
            f"f32, {RF_LAYERS[arch]} layers, the cache over kv heads): "
            f"{dc['ranks']['ms_token']:.2f} ms/token over ranks against "
            f"{dc['one']['ms_token']:.2f} one process (device ms, CUDA "
            f"events on rank 0); logits within {dc['err']:.3e} (bound "
            f"{DECODE_REL_BOUND}); {note}")
    log(f"23 ranks: peak GB {[round(r['peak_gb'], 2) for r in ranks]}; s by "
        f"model on rank 0 {dict((k, round(v, 1)) for k, v in r0['t'].items())}"
        f"; spawn and work {spawn_s:.1f} s ({spawned['phases']}; target "
        f"{RF_TARGET_S:.0f} s for 23 alone); "
        f"{note}")
    cp_launches = [r[LM_ARCH]["prefill"]["bfloat16"]["launches"]
                   for r in ranks]
    entry = _rf_cp_entry(cp_launches, card)
    launches = [sum(r[a]["prefill"][d]["launches"]
                    for a in (MOE, VLM, AUDIO, LM_ARCH)
                    for d in r[a]["prefill"]) for r in ranks]
    out = {"card": card, "sweep_s": sweep["sweep_s"],
           "sweep_trace_s": sweep["trace_s"], "sweep_wait_s": sweep["wait_s"],
           "records": {k: {f: v.get(f) for f in (
               "status", "flops_per_chip", "hbm_bytes_per_chip", "memory",
               "collectives", "roofline", "trace_s")}
               for k, v in sweep["records"].items()},
           "prefill": {a: r0[a]["prefill"] for a in (MOE, VLM, AUDIO,
                                                      LM_ARCH)},
           "train": {a: {k: r0[a]["train"].get(k) for k in (
               "ms", "one_ms", "loss", "one_loss", "loss32", "gnorm",
               "one_gnorm", "peak", "argument")} for a in (MOE, AUDIO)},
           "decode": {a: r0[a]["decode"] for a in (MOE, VLM)},
           "account": {"collectives": acct_c, "peak": acct["peak_bytes"],
                       "ratio": ratio},
           "spawn_s": spawn_s, "cp_entry": entry,
           "launches": {"flash_attention": launches},
           "peak_gb": [r["peak_gb"] for r in ranks],
           "phase_s": time.perf_counter() - t_phase}
    log(f"per-rank families phase {out['phase_s']:.1f} s")
    assert not failed, f"phase 23 failed: {failed}"
    return out


# -- phase 24: the per-rank program of the recurrent families ---------------

# (a): rank 0's records of rwkv6-1.6b and zamba2-2.7b at full depth, in a
# pool of RR_JOBS processes started beside phases 12-18
RR_SWEEP = [(a, s) for a in (RWKV, BACKBONE)
            for s in ("train_4k", "decode_32k")]
RR_JOBS = 1
RR_SWEEP_TARGET_S = 120.0
# (b): full width, cut in depth; four ranks on (data 2, model 2), in the
# spawn of phases 22-24 (``ranks_spawn``): rwkv6's 32 heads of 64 (16 a
# rank), its channel mix's
# 7,168 (3,584 a rank); zamba2's 80 mamba2 heads of 64 (40 a rank, one
# ssd_scan a layer), w_xbc's 5,248 columns (2,624 a block: not whole
# heads, so gathered whole), one use of the shared block (32 heads of 80,
# 16 a rank, window 4,096)
RR_CUT = {RWKV: {"n_layers": 2},
          BACKBONE: {"n_layers": 2, "shared_attn_every": 2}}
RR_PREFILL = RF_PREFILL      # B x T
RR_TRAIN = RF_TRAIN
RR_DECODE = RF_DECODE        # B, tokens
# (d): the rank's ssd_scan alone: B 1, T 4,096, its 40 heads, p = n = 64
RR_SSD = (1, 4096, 40, 64, 64)


def _rr_cfg(arch, dtype):
    return get_config(arch).replace(dtype=dtype, **RR_CUT[arch])


def rr_sweep_start():
    """24 (a), started: rank 0's records of RR_SWEEP (``rf_sweep_start``)."""
    return rf_sweep_start(RR_SWEEP, {}, RR_JOBS)


def _rr_inputs():
    """The seeded batches of (b) for each model: prefill tokens, training
    tokens and labels, the decode prompt."""
    rng = np.random.RandomState(24)
    B, T = RR_PREFILL
    Bt, Tt = RR_TRAIN
    out = {}
    for arch in (RWKV, BACKBONE):
        V = get_config(arch).vocab_size

        def ids(shape):                 # int32, as the plan's inputs
            return rng.randint(0, V, shape).astype(np.int32)

        out[arch] = {"prefill": ids((B, T)), "tokens": ids((Bt, Tt)),
                     "labels": ids((Bt, Tt)), "decode": ids(RR_DECODE)}
    return out


def _rr_rank(inp, mesh):
    """Phase 24 (b) and (c) on this rank of ``ranks_spawn``: each model's
    prefill in f32 and bf16, one bf16 step (zamba2's counted by
    ``CostMode`` for (c)) and the f32 decode, held to one process on
    rank 0."""
    from repro_torch.launch.cost_analysis import CostMode
    out = {"t": {}}
    for arch in (RWKV, BACKBONE):
        t0 = time.perf_counter()
        x = inp[arch]
        model, models = _rf_models(arch, _rr_cfg)
        res = {"prefill": _rk_prefill(
            inp, mesh, models, batch={"tokens": _rf_on(x["prefill"])})}
        _rf_free()
        res["train"] = _rk_train(
            inp, mesh, models["bfloat16"],
            CostMode if arch == BACKBONE else None,
            batch={"tokens": _rf_on(x["tokens"]),
                   "labels": _rf_on(x["labels"])}, spread=True)
        _rf_free()
        res["decode"] = _rk_decode(inp, mesh, model,
                                   prompt=_rf_on(x["decode"]))
        del model, models
        _rf_free()
        out[arch] = res
        out["t"][arch] = time.perf_counter() - t0
    return out


def _ssd_bound(B, T, H, p, n):
    """(FLOP, FLOP at the kernel's bf16 arithmetic, bytes) of the SSD at
    (B, T, H, p, n): the chunked algorithm's products at Q =
    SSD_BOUND_CHUNK, only what the function needs: in each chunk the
    lower triangle of C B^T (Q (Q + 1) / 2 entries of n products, once a
    batch row as B and C are shared by the heads), and per head the
    lower triangle of att . xs (p products an entry), C h^T and the state
    update (Q p n products each). The kernel's bf16 arithmetic runs three
    bf16 passes a product (989 / 3 TFLOP/s), but C B^T, bf16 on both
    sides, in one: it counts a third at the three-pass rate. Bytes: bf16
    x, y, B and C, f32 dt and la read once, the f32 end state written."""
    Qb = SSD_BOUND_CHUNK
    ops_g = 2.0 * B * T * (Qb + 1) / 2 * n
    ops = ops_g + 2.0 * B * T * H * ((Qb + 1) / 2 * p + 2 * p * n)
    nbytes = (2 * 2 * B * T * H * p + 2 * 2 * B * T * n + 2 * 4 * B * T * H
              + 4 * B * H * p * n)
    return ops, ops - ops_g + ops_g / 3, nbytes


def _rr_ssd_entry(launches, card):
    """The kernels-line entry of a rank's ssd_scan: RR_SSD (zamba2's 40
    heads a rank on a model axis of 2), bf16, seeded inputs; kernel and
    plain version timed, its parity against the plain version (SSD_TOL)
    and its bound. No single PyTorch call computes it."""
    B, T, H, p, n = RR_SSD
    xs, Bm, Cm, dt, la = ssd_cases.inputs(B, H, T, p, n, torch.bfloat16,
                                          DEV, seed=24)
    err, top, worst, _ = check_ssd(xs, Bm, Cm, dt, la)
    ops, ops_bf16, nbytes = _ssd_bound(B, T, H, p, n)
    b_ms, b_by = roofline(ops_bf16, nbytes, PEAK_BF16_FLOPS / 3)
    cps, hpb, grid = segment_plan(B, H, T)
    fn = lambda: ssd_core(xs, Bm, Cm, dt, la)  # noqa: E731
    plain = lambda: ssd_scan_chunked(  # noqa: E731
        xs.transpose(1, 2), Bm[:, None], Cm[:, None], dt.transpose(1, 2),
        la.transpose(1, 2))
    with torch.inference_mode():
        eager, graphed, best = _device_times(fn, plain, None, (20, 3, 0))
    log(f"ssd_scan a rank's heads B={B} T={T} H={H} p={p} n={n} (bf16): "
        f"device ms by graph replay: kernel {best['ms']:.4f}, plain "
        f"{best['plain_ms']:.4f}; eager kernel {eager['ms']:.4f}; bound "
        f"{b_ms:.4f} ms ({b_by}), {b_ms / best['ms']:.1%} of bound; plan "
        f"{cps} chunks a segment, {hpb} heads a block, grid {grid}; parity "
        f"max |d| {err:.3e} (max |ref| {top:.3f}), {worst:.3f} of the "
        f"bound; launches in 24 (b) by rank {launches}; {card}")
    del xs, Bm, Cm, dt, la
    torch.cuda.empty_cache()
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_chunk/kernel.py:80",
            "launches": sum(launches), "launches_by_rank": launches,
            "max_abs_err": err, **best, "bound_ms": b_ms, "bound_by": b_by,
            "eager_ms": eager, "graph_ms": graphed,
            "library_note": "no single PyTorch call computes it",
            "shape": {"B": B, "T": T, "H": H, "p": p, "n": n,
                      "config": BACKBONE, "heads_of": 80, "model_axis": 2,
                      "plan": {"chunks_per_segment": cps,
                               "heads_per_block": hpb, "grid": grid}}}


def phase_ranks_recurrent(card, sweep=None, spawned=None):
    """Phase 24: the per-rank program of the recurrent families: (a)
    rank 0's records of rwkv6-1.6b and zamba2-2.7b on the production
    meshes, traced on meta (``sweep``, from ``rr_sweep_start``; started
    here if None); (b) both on four ranks sharing the card over gloo,
    held to one process (``spawned``, from ``ranks_spawn``; spawned
    here if None); (c) the account of (b)'s zamba2 step
    in a fake world of the same (2, 2), held to what rank 0 issued and
    allocated; (d) a rank's ssd_scan timed for the kernels line."""
    t_phase = time.perf_counter()
    sweep = _rf_sweep(sweep or rr_sweep_start(), "24 (a)",
                      "of the ssm and hybrid families (full depth)",
                      RR_SWEEP_TARGET_S)
    shape = InputShape("held", RR_TRAIN[1], RR_TRAIN[0], "train")
    with card_figures.fake_world(card_figures.Mesh(("data", "model"),
                                                   RK_MESH)) as live:
        acct = dryrun.rank_account(_rr_cfg(BACKBONE, "bfloat16"), shape,
                                   live)
    spawned = spawned or ranks_spawn(recurrent=True)
    ranks, spawn_s = spawned["recurrent"], spawned["spawn_s"]
    r0 = ranks[0]
    note = (f"{card}; {len(ranks)} ranks share one card over "
            f"{r0['backend']}, which stages every collective through the "
            f"host")
    failed = [f"24 (a) {k}" for k in sweep["bad"]]

    def hold(ok, what):
        if not ok:
            failed.append(what)

    # launches a rank a prefill: zamba2's one ssd_scan a mamba layer (its
    # 40 heads) and one flash_attention a use of the shared block; rwkv6
    # has no kernel of its own
    zl = RR_CUT[BACKBONE]["n_layers"]
    want = {RWKV: {"launches": 0, "ssd_launches": 0},
            BACKBONE: {"launches": zl // RR_CUT[BACKBONE][
                "shared_attn_every"], "ssd_launches": zl}}
    what = {RWKV: "16 of 32 heads of 64 and 3,584 of 7,168 ffn columns a "
                  "rank; the wkv state's key dim over model in the plan, "
                  "its heads in the rank's work",
            BACKBONE: "40 of 80 mamba2 heads of 64 a rank, w_xbc gathered "
                      "whole, the gated norm's squares summed over model; "
                      "the shared block's 16 of 32 heads of 80"}
    for arch in (RWKV, BACKBONE):
        for dtype, p in r0[arch]["prefill"].items():
            bound = DECODE_REL_BOUND if dtype == "float32" else \
                RK_BF16_SLACK * r0[arch]["prefill"]["bfloat16"]["bf16_err"]
            hold(p["err"] <= bound, f"{arch} prefill {dtype}")
            hold(all(r[arch]["prefill"][dtype]["checksum"] == p["checksum"]
                     for r in ranks), f"{arch} prefill {dtype} ranks differ")
            got = {k: [r[arch]["prefill"][dtype][k] for r in ranks]
                   for k in ("launches", "ssd_launches")}
            hold(all(n == want[arch][k] for k, ns in got.items()
                     for n in ns), f"{arch} prefill {dtype} launches {got}")
            log(f"24 (b) {arch} prefill ({RR_CUT[arch]} at full width, B "
                f"{RR_PREFILL[0]} x T {RR_PREFILL[1]}, {dtype}, "
                f"{what[arch]}): {p['ms']:.2f} ms over ranks against "
                f"{p['one_ms']:.2f} ms one process (device ms, CUDA events on "
                f"rank 0); logits within {p['err']:.3e} x max of one "
                f"process's (bound {bound:.3e}"
                + ("" if dtype == "float32" else ", twice its bf16 forward's "
                   "own distance from f32") + f"); ssd_scan launches by rank "
                f"{got['ssd_launches']}, flash_attention {got['launches']} "
                f"(want {want[arch]}); {note}")
        tr = r0[arch]["train"]
        loss_rel = abs(tr["loss"] - tr["one_loss"]) / abs(tr["one_loss"])
        shift = abs(tr["one_loss"] - tr["loss32"])
        loss_bound = RK_BF16_SLACK * (shift + RF_LOSS_SE * tr["tok_se"]) \
            / abs(tr["loss32"])
        m_share = max(e / (RK_BF16_SLACK * b + 1e-12) for e, b in
                      zip(tr["errs"]["m"], tr["bf16_m_err"]))
        hold(loss_rel <= loss_bound, f"{arch} train loss")
        hold(m_share <= 1.0, f"{arch} train first moments")
        hold(max(tr["errs"]["params"]) <= 2 * RK_LR + 1e-6,
             f"{arch} train params")
        log(f"24 (b) {arch} training ({RR_CUT[arch]}, B {RR_TRAIN[0]} x T "
            f"{RR_TRAIN[1]}, bf16 activations, f32 weights, AdamW lr "
            f"{RK_LR}, remat): {tr['ms']:.1f} ms a step over ranks against "
            f"{tr['one_ms']:.1f} ms one process (device ms); loss "
            f"{tr['loss']:.5f} against {tr['one_loss']:.5f} one process "
            f"(rel {loss_rel:.2e}; bound {loss_bound:.2e}: twice bf16's own "
            f"distance from f32, {shift:.3e}, plus {RF_LOSS_SE:g} x its "
            f"per-token standard error {tr['tok_se']:.3e}); moments: the "
            f"worst leaf at {m_share:.3f} of twice its bf16-to-f32 "
            f"distance; parameters within {max(tr['errs']['params']):.3e} "
            f"(bound 2 lr); {note}")
        dc = r0[arch]["decode"]
        hold(dc["err"] <= DECODE_REL_BOUND, f"{arch} decode")
        hold(all(r[arch]["decode"]["checksum"] == dc["checksum"]
                 for r in ranks), f"{arch} decode ranks differ")
        log(f"24 (b) {arch} decode (B {RR_DECODE[0]}, {RR_DECODE[1]} tokens, "
            f"f32, {RR_CUT[arch]}, the cache stacked under the plan's specs "
            f"and moved to the rank's layout and back each step): "
            f"{dc['ranks']['ms_token']:.2f} ms/token over ranks against "
            f"{dc['one']['ms_token']:.2f} one process (device ms, CUDA "
            f"events on rank 0); logits within {dc['err']:.3e} (bound "
            f"{DECODE_REL_BOUND}); {note}")
    tr = r0[BACKBONE]["train"]
    live_c, acct_c = tr["collectives"], acct["collectives"]
    same = live_c["counts"] == acct_c["counts"] and \
        live_c["bytes"] == acct_c["bytes"]
    hold(same, "account collectives")
    ratio = acct["peak_bytes"] / tr["peak"]
    lo, hi = PEAK_RATIO_BAND
    hold(lo <= ratio <= hi, "account peak")
    hold(acct["memory"]["argument_size"] == tr["argument"],
         "account arguments")
    log(f"24 (c) account of the {BACKBONE} step in a fake world of (2, 2): "
        f"collectives {acct_c['counts']} ({acct_c['total_bytes'] / 1e9:.4f} "
        f"GB), rank 0 issued {live_c['counts']} "
        f"({live_c['total_bytes'] / 1e9:.4f} GB): equal {same}; peak "
        f"{acct['peak_bytes'] / 1e9:.3f} GB against rank 0's "
        f"{tr['peak'] / 1e9:.3f} GB (ratio {ratio:.3f}, band "
        f"{PEAK_RATIO_BAND}); arguments {acct['memory']['argument_size']} "
        f"B, rank 0's {tr['argument']} B; {note}")
    log(f"24 ranks: peak GB {[round(r['peak_gb'], 2) for r in ranks]}; s "
        f"by model on rank 0 "
        f"{dict((k, round(v, 1)) for k, v in r0['t'].items())}; spawn and "
        f"work {spawn_s:.1f} s ({spawned['phases']}); {note}")
    launches = {k: [sum(r[a]["prefill"][d][f] for a in (RWKV, BACKBONE)
                        for d in r[a]["prefill"]) for r in ranks]
                for k, f in (("ssd_scan", "ssd_launches"),
                             ("flash_attention", "launches"))}
    entry = _rr_ssd_entry(launches["ssd_scan"], card)
    out = {"card": card, "sweep_s": sweep["sweep_s"],
           "sweep_trace_s": sweep["trace_s"], "sweep_wait_s": sweep["wait_s"],
           "records": {k: {f: v.get(f) for f in (
               "status", "flops_per_chip", "hbm_bytes_per_chip", "memory",
               "collectives", "roofline", "trace_s")}
               for k, v in sweep["records"].items()},
           "prefill": {a: r0[a]["prefill"] for a in (RWKV, BACKBONE)},
           "train": {a: {k: r0[a]["train"].get(k) for k in (
               "ms", "one_ms", "loss", "one_loss", "loss32", "gnorm",
               "one_gnorm", "peak", "argument")} for a in (RWKV, BACKBONE)},
           "decode": {a: r0[a]["decode"] for a in (RWKV, BACKBONE)},
           "account": {"collectives": acct_c, "peak": acct["peak_bytes"],
                       "ratio": ratio},
           "spawn_s": spawn_s, "ssd_entry": entry, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    log(f"per-rank recurrent phase {out['phase_s']:.1f} s")
    assert not failed, f"phase 24 failed: {failed}"
    return out


# -- phases 22-24 (b): one spawn ------------------------------------------

# (b) of phases 22-24 run in one spawn of four ranks (``ranks_spawn``): a
# spawn costs each rank its start (13 s in phase 21), a CUDA context and a
# group; each phase's part runs in turn, its models freed before the next
RANKS_PARTS = {"dense": (_rk_rank, _rk_inputs),
               "families": (_rf_rank, _rf_inputs),
               "recurrent": (_rr_rank, _rr_inputs)}


def _ranks_rank(inp):
    """One rank of ``ranks_spawn``: each part of ``inp`` (RANKS_PARTS'
    names) in turn on one mesh of (data 2, model 2); each part's result
    with this rank's index, backend and the part's peak device
    memory."""
    mesh = card_figures.make_local_mesh(data=RK_MESH[0], model=RK_MESH[1])
    out = {}
    for name, part in inp.items():
        torch.cuda.reset_peak_memory_stats()
        res = RANKS_PARTS[name][0](part, mesh)
        res.update(rank=mesh.rank, backend=mesh.backend,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        out[name] = res
    return out


def ranks_spawn(dense=False, families=False, recurrent=False):
    """(b) of the phases named, in one spawn of four ranks sharing the
    card: {part: [each rank's result], "spawn_s": seconds, "phases":
    which}."""
    parts = [n for n, on in (("dense", dense), ("families", families),
                             ("recurrent", recurrent)) if on]
    inp = {n: RANKS_PARTS[n][1]() for n in parts}
    t0 = time.perf_counter()
    ranks = spawn(_ranks_rank, RK_MESH[0] * RK_MESH[1], args=(inp,),
                  timeout=RK_TIMEOUT)
    out = {n: [r[n] for r in ranks] for n in parts}
    out["spawn_s"] = time.perf_counter() - t0
    out["phases"] = "one spawn for " + ", ".join(
        {"dense": "22", "families": "23", "recurrent": "24"}[n]
        for n in parts)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    phase_parity()
    phase_parity_training()
    phase_parity_async()
    phase_parity_ann()
    phase_parity_backbone()
    log(f"parity phases done at {time.perf_counter() - t0:.1f}s")
    train = phase_training()
    bsp_ms = train["step_ms"]["bsp"]
    ev = phase_eval(train["L"], train["feats"], train["labels"])
    entries = [time_dml_pair(train["L"], train["batch"], train["launches"],
                             train["launches_per_step"], train["max_err"]),
               time_pairwise(ev["xp"], ev["yp"], ev["launches"],
                             ev["max_err"])]
    entries[0]["train_step"] = {"ms": train["step_ms"]["bsp"],
                                "device": train["step_parts"]}
    log(f"training and eval done at {time.perf_counter() - t0:.1f}s")
    phase_async_ps(train)
    log(f"async PS and Fig. 3 done at {time.perf_counter() - t0:.1f}s")
    # phase 20 trains on phase 4's rows again: keep them on the host
    mr_data = (train["feats"].cpu().numpy(), train["labels"],
               train["L_init"].cpu().numpy())
    del train, ev
    torch.cuda.empty_cache()
    entries[0]["fig4_launches"] = phase_fig4()
    torch.cuda.empty_cache()
    log(f"Fig. 4 done at {time.perf_counter() - t0:.1f}s")
    index, queries, serving, err = phase_serving()
    entries.insert(0, phase_kernels(index, queries, serving["launches"],
                                    err))
    log(f"exact serving done at {time.perf_counter() - t0:.1f}s")
    built, ann = phase_ann(index, queries, serving)
    entries += time_ann(built, ann, queries)
    log(f"ANN serving done at {time.perf_counter() - t0:.1f}s")
    mutation = phase_mutation(index, queries, serving, built, card)
    for entry in entries:
        if entry["name"] in mutation["kernels"]:
            entry["mutation"] = mutation["kernels"][entry["name"]]
    log(f"mutation done at {time.perf_counter() - t0:.1f}s")
    frontend = phase_frontend(index, queries, serving, built, card)
    log(f"front end done at {time.perf_counter() - t0:.1f}s")
    L = index.L
    del index, built, ann, mutation
    gc.collect()
    torch.cuda.empty_cache()
    tenants = phase_tenants(L, queries, serving, card)
    for entry in entries:
        kname = entry["name"]
        if kname in MUT_KNAMES.values():
            name = {v: k for k, v in MUT_KNAMES.items()}[kname]
            entry["frontend"] = {
                "launches_burst": frontend[name]["launches"][name],
                "ladder": frontend[name]["ladder"],
                "level_ms": frontend[name].get("level_ms")}
            entry["tenants"] = {"launches": tenants["launches"][kname]}
    log(f"tenants done at {time.perf_counter() - t0:.1f}s")
    loop = phase_closed_loop(serving["classes"], bsp_ms, card)
    for entry in entries:
        if entry["name"] in loop["launches"]:
            entry["closed_loop"] = {
                "launches": loop["launches"][entry["name"]],
                **({"step_ms": loop["main"]["step_ms"],
                    "pairs_s": loop["main"]["pairs_s"]}
                   if entry["name"] == "dml_pair" else {})}
    log(f"closed loop done at {time.perf_counter() - t0:.1f}s")
    del L, queries, serving, frontend, tenants, loop
    gc.collect()
    torch.cuda.empty_cache()
    bb = phase_backbone_parity()
    log(f"backbone parity done at {time.perf_counter() - t0:.1f}s")
    sweep = rk_sweep_start()        # phase 22 (a), on the host's idle cores
    rf_sweep = rf_sweep_start()     # phase 23 (a), beside it
    account_sweep = account_sweep_start()     # phase 19 (a)
    rr_sweep = rr_sweep_start()     # phase 24 (a)
    gemma = phase_gemma()
    log(f"gemma forward done at {time.perf_counter() - t0:.1f}s")
    model, requests, svc = phase_embedding_service()
    log(f"embedding service done at {time.perf_counter() - t0:.1f}s")
    bb_entries = time_backbone_kernels(
        model, torch.from_numpy(requests[0]).to(DEV), svc["launches"],
        bb["errs"])
    bb_entries[0]["service"] = svc
    bb_entries[0]["forward_f32_rel_err"] = bb["f32_rel_err"]
    entries += bb_entries
    entries.append(time_gemma_attention(gemma))
    log(f"backbone kernels timed at {time.perf_counter() - t0:.1f}s")
    decode = {BACKBONE: phase_decode_zamba(model)}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{BACKBONE} decode done at {time.perf_counter() - t0:.1f}s")
    decode[GEMMA] = phase_decode_gemma()
    log(f"{GEMMA} decode done at {time.perf_counter() - t0:.1f}s")
    training = {LM_ARCH: phase_train_smollm()}
    gc.collect()
    torch.cuda.empty_cache()
    training[BACKBONE] = phase_train_zamba()
    log(f"training done at {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    rwkv = phase_rwkv6()
    log(f"{RWKV} done at {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    moe_out = phase_moe()
    log(f"moe done at {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    vlm_audio, frame_entries = phase_vlm_audio()
    log(f"vlm and audio done at {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    account = phase_account(account_sweep)
    log(f"account done at {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    multirank = phase_multirank(card, mr_data, bsp_ms)
    del mr_data
    log(f"multi-rank done at {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    multirank_moe = phase_multirank_moe(card)
    log(f"multi-rank moe done at {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    spawned = ranks_spawn(dense=True, families=True, recurrent=True)
    log(f"ranks of phases 22-24 done at {time.perf_counter() - t0:.1f}s")
    ranks = phase_ranks(card, sweep, spawned)
    log(f"per-rank program done at {time.perf_counter() - t0:.1f}s")
    families = phase_ranks_families(card, rf_sweep, spawned)
    log(f"per-rank families done at {time.perf_counter() - t0:.1f}s")
    recurrent = phase_ranks_recurrent(card, rr_sweep, spawned)
    del spawned
    log(f"per-rank recurrent families done at "
        f"{time.perf_counter() - t0:.1f}s")
    # the backbone kernels' launches in phases 12-15: apply through the
    # kernels beside decode (window, ring; gemma) and beside the first
    # training step (decode and the training steps launch none)
    later = {f"{BACKBONE}_decode_{k}": decode[BACKBONE][k]["apply_launches"]
             for k in ("window", "ring")}
    later[f"{GEMMA}_decode"] = decode[GEMMA]["apply_launches"]
    later[f"{BACKBONE}_train_first_step"] = \
        training[BACKBONE]["apply_launches"]
    for entry in entries:
        if entry["name"] in ("ssd_scan", "flash_attention"):
            entry["decode_and_training_launches"] = {
                k: v[entry["name"]] for k, v in later.items()}
        if entry["name"] == "pairwise_sqdist":
            entry[f"{RWKV}_service_launches"] = \
                rwkv["service"]["launches"]["pairwise_sqdist"]
            entry[f"{MOE}_service_launches"] = \
                moe_out[MOE]["service"]["launches"]["pairwise_sqdist"]
            for name in (VLM, AUDIO):
                entry[f"{name}_service_launches"] = \
                    vlm_audio[name]["service"]["launches"]["pairwise_sqdist"]
        if entry["name"] == "flash_attention":
            entry["moe_launches"] = _moe_launches(moe_out)
        if entry["name"] in multirank["launches"]:
            entry["multirank_launches_by_rank"] = \
                multirank["launches"][entry["name"]]
        if entry["name"] in multirank_moe["launches"]:
            entry["multirank_moe_launches_by_rank"] = \
                multirank_moe["launches"][entry["name"]]
        if entry["name"] in ranks["launches"]:
            entry["per_rank_launches_by_rank"] = \
                ranks["launches"][entry["name"]]
        if entry["name"] in families["launches"]:
            entry["per_rank_families_launches_by_rank"] = \
                families["launches"][entry["name"]]
        if entry["name"] in recurrent["launches"]:
            entry["per_rank_recurrent_launches_by_rank"] = \
                recurrent["launches"][entry["name"]]
    entries += frame_entries        # flash_attention at phase 18's shapes
    entries.append(families.pop("cp_entry"))    # a context-parallel slice
    entries.append(recurrent.pop("ssd_entry"))  # a rank's SSD heads
    print(json.dumps({"decode": decode, "training": training, RWKV: rwkv,
                      "moe": moe_out, "vlm_audio": vlm_audio,
                      "account": account, "multirank": multirank,
                      "multirank_moe": multirank_moe, "ranks": ranks,
                      "ranks_families": families,
                      "ranks_recurrent": recurrent}),
          flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    log(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
