#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, one JSON line each (any failed check raises; the script then exits
non-zero and prints no result line):

1. device   - the card's name and power limit from nvidia-smi;
2. build    - compile the CUDA kernels from csrc/ with nvcc (sm_90a), one
              nvcc per source, all started together; ptxas's registers
              and spill bytes of every kernel that spills and of K2's core,
              the GEMMs of K5/K3/K2, K1 and P1 (both instances of the
              log-mel kernel), K4, P2, P4's four launches, every K9
              instance and K11's TMA kernel, which must not; and the SASS
              of the int8 K9 instances and K11's TMA kernel
              (cuobjdump), which must convert no byte to float by I2F;
3. kernels  - each kernel against its plain PyTorch version at main-path
              shapes, with the bars stated below: K1 (four 30 s rows at 80
              and 128 mels, and B=32 x 30 s of noise; both also against an
              f64 log-mel, printed), K2 (4 heads of 128 and 8 of 64,
              lengths including 0 and 1, and the timed B=32 shape; launched
              twice and bitwise equal), K3's GELU table against gelu_tanh
              and gelu_erf on all 65,536 bf16 inputs (no bit may differ),
              K3 (d 256, 512 and 1024, launched
              twice and bitwise equal), K4 (B=32 x 750 at d 512, V 4336
              from an f32 kernel and from its padded bf16 serving copy,
              launched twice and bitwise equal, timed against plain; ties
              at duplicate columns inside a tile, across tiles, across
              P2's chunks, far apart and in the ragged last tile; a
              ragged row count; d 256 and 1024; V 100 and 40); K6 (out,
              lse) and K8 (dQ, dK, dV) at B=16, T'=750, 8 heads of 64 and
              4 of 128, plus a causal case, each launched twice and
              bitwise equal;
              K7 (both WF-folded sublayers);
3b. ctc_loss - jl_ctc_loss (csrc/ctc_loss.cu, the port's own kernel: the
              JAX package's CTC loss is XLA's scan) at B=16, T'=750,
              V=4336, S=128, logit lengths spread over 1..T', repeats, an
              empty label and infeasible rows: the NLL within
              CTC_NLL_REL_BAR of the plain recursion (an infeasible row
              1e30 exactly, with a zero gradient), the dense gradient
              within CTC_GRAD_BAR of its largest value, both launched
              twice and bitwise equal; forward and backward timed beside
              their bounds (the dense gradient's write), their plain
              versions and the library's aten._ctc_loss /
              _ctc_loss_backward;
4. e2e      - main path 1, serving: api.load of the full-width flagship
              (12 x d512, 4 heads of 128, mlp 2048, V 4336, random init
              from seed 0) and api.transcribe of six requests (0.5 s to
              42 s; the last is chunked in two), plain and with timestamps;
              the same requests through the plain versions must agree;
5. finetune - main path 2, training: api.fine_tune on
              configs/adapter_finetune.yaml at full width (WF rank 8, 8
              heads of 64) over a synthetic manifest of sixteen 30 s WAVs
              whose transcripts use 4334 distinct characters (V = 4336), B=16
              from the 30 s bucket (T'=750, so K6/K8 run), a few steps and
              the checkpoint, each bucket's step captured once as a CUDA
              graph and replayed (K1, K6, K8 and jl_ctc_loss a step, the
              replays' included); the backbone must stay bitwise frozen;
              GRAPH_STEPS captured steps against GRAPH_STEPS graph=False
              steps from one state (every step's metrics, the trainable
              tensors and the AdamW state bit for bit, or within the
              spread of two graph=False runs), and the same across two
              bucket shapes (B=4 of 10 s and of 30 s: two graphs); then
              one step without dropout or SpecAugment on the kernel path
              against the plain path (loss and adapter gradients);
6. adapted  - main path 3, serving the fine-tuned checkpoint: api.load +
              api.transcribe of the six requests through K7, held against
              the plain path;
7. timing   - seconds per batch of 32 x 30 s through the kernel path and the
              plain path; train steps/s at B=16 x 30 s (this config) and
              B=16 x 10 s (flagship defaults + WF rank 8) on both paths, and
              this config's captured step against graph=False in
              GRAPH_TURNS (steps/s, each route's idle share and kernels a
              step, the capture's seconds, counted launches a replay); each
              kernel alone against its plain version with its bound-counted
              TFLOP/s (K2, K3 and K7 run on K5's and K3c's launches; K2
              and K3 on the block's kept bf16 serving copies), the four
              GEMM launches of a block apart (q/k/v, fc1 + GELU, fc2 +
              residual, the out-projection; each queued beside cuBLAS
              addmm with the bias on the same operands, with its bound,
              bound-counted TFLOP/s and launches a batch), K2's core beside
              the library's masked fused attention forward on the same
              q/k/v (queued), the copy kernels a greedy batch launches
              (the serving copies leave none of the weight casts), K1
              beside its f32 CUDA-core bound, K4
              on the head's bf16 serving copy beside torch.addmm +
              torch.argmax (two library calls, its library_ms) and,
              for K6/K8, the library's fused attention
              (examples/torch_kernel_yardsticks.py; both sides timed queued
              behind a spin kernel, with executed TFLOP/s too);
8. whisper  - main path 4, Whisper large-v3 serving (d=1280, 32 + 32
              blocks, 20 heads of 64, mlp 5120, V=51866, 128 mels; random
              init from seed 0 on the card): K9, K5 and K3c (an LN pass
              and TMA + wgmma GEMMs, csrc/ln_gemm.cu), the out-projection +
              residual (K2h-out, the same GEMM) at B=16 x 1500 and at the six
              requests' ragged B=7 (K5 and K3c launched twice, bitwise
              equal), K6 at 20 heads of 64 and K1 at 128 mels against their
              plain versions; K9 (bf16 caches) at Tk 1536, 256 and 128, Tq
              1, 3 and 8, dh 64 and 128, lengths 0, 1, 15, 16, 17, around
              the kernel's block steps and Tk, launched twice, bitwise
              equal;
              api.load + api.transcribe of the six requests (seven 30 s chunks, one
              batch) through K1, K5, K6, K2h-out, K3 and K9; the encoder
              held against the plain path (relative L2) and the generated
              tokens teacher-forced through the plain decoder (the margin
              rule); then encoder seconds per B=16 x 30 s batch, decode ms
              per step (building the caches timed apart) and tokens/s at
              B=16 (32 steps) on both paths, the kernel path's peak device
              memory in one encoder call, main path 13: the AR beam (K=4,
              two chunks, 32 decode steps; exact K9 launches, a beam of one
              bitwise greedy, a second run naming an LM at lm_weight 0,
              which loads none, bitwise the first: determinism only;
              fusion is held on the joint beam in phase 14), and
              K5, K3c (with bound-counted TFLOP/s and, as context, cuBLAS's
              products alone on a precomputed LN(x)), K2h-out (beside cuBLAS
              addmm, its library_ms), K9 (cycling through caches that
              exceed the L2 twice, the host's dispatch included; and K6 at
              this shape, queued, beside the library's masked call and, as
              context, its unmasked one) alone;
9. int8     - main path 5, int8 Whisper large-v3 serving: K9's int8 half
              (phase 8's cases on int8 caches), K10 (one cluster launch
              with the bias folded in: R 1, 2, 4, 7, 8, 16, 32, 64, each of
              its 16-row-tile instances, at the decoder's three shapes, with
              and without a bias, two launches bitwise equal) and K11 (R 1,
              7, 8, 16, 32, 64 at V=51866, R 16 on a table holding every
              int8 value; R 5, 40, 64 at a ragged D; two launches bitwise
              equal) against their plain versions;
              ModelBundle.quantize() of phase 8's bundle and
              api.transcribe of the six requests (B=7: K9-int8 on the cross
              caches, K9 on bf16 self caches, K10 256 and K11 once a step,
              exactly), greedy_from_enc at B=16 (int8 self caches: K9-int8
              64 a step, K9 none); the generated tokens teacher-forced
              through the plain int8 decoder's steps (the margin rule) and
              the int8-vs-bf16 top-1 agreement and logit cosine (printed);
              then decode ms per step and tokens/s at B=16 and B=8 (64
              steps each) on both paths with peak device memory; K9
              (bf16 and int8 caches, cross and self) and K11 alone by
              device time, cycling through inputs that exceed the L2
              twice (examples/torch_profile_decode_kernels.py, run in a
              process of its own), beside
              bound, library call (masked SDPA; none for int8 caches;
              cuBLAS's bf16 tied logits) and the parent's reading; K10
              alone beside cuBLAS's bf16 product;
10. probes  - main path 6, the A/B probes of examples/: P4 (W8A8 LN + MLP +
              residual on the int8 tensor cores), P1 (bf16x3 log-mel) and P2
              (head + argmax carried over 512-column chunks) against their plain
              versions at the flagship's shapes (P4 at B=32, T'=750 within
              ULP_BAR, two launches bitwise equal, stage by stage: its LN
              codes counted against the plain LN's, its hidden codes and
              output bit for bit the plain stages' on its own LN and
              hidden codes, and a refused width leaving no error; P1, the
              bf16 instance of K1's kernel, at 32 x 30 s within
              LOGMEL_BAR on the normalized surface, twice bitwise equal,
              P1 and K1 against an f64 log-mel printed; P2 at B=32,
              T'=750, V=4336: ids equal to K4's
              everywhere, to the plain version's under the margin rule, ties
              at K4's positions to the first index, two launches bitwise
              equal); then each profiler's main() at B=32
              (examples/torch_profile_w8a8_mlp.py, _frontend_precision.py,
              _head_kernel.py: each runs its probe beside its partner, K3,
              K1 or K4, and reports the A/B difference and both times), and
              each probe alone beside its plain version, its partner and its
              bound, with the two-call library context of
              examples/torch_kernel_yardsticks.py;
11. transfer - run after phase 7: main paths 7-9, the multi-dialect
              transfer through the CLI at the published widths of
              configs/multi_dialect_transfer.yaml (12 x d512, 8 heads of 64,
              mlp 2048, Att adapters of 4 x 64 after both sublayers, B=16 x
              30 s, V 4336): `cli prepare` of three seeded corpora (jilu,
              zhongyuan, jiaoliao; --cmvn on jiaoliao: K1); `cli train` of
              both stages (K1, K6, K8; exact launches a stage), stage 1
              moving every Dense kernel, the subsampler and the head, stage
              2 leaving the backbone bitwise and moving every adapter
              tensor, and `train --resume` taking no step; one stage-1 step
              with every parameter trainable, kernel path against plain,
              and stage 1's captured step against graph=False (bit for bit
              over GRAPH_STEPS);
              the bundle serving the six requests and `cli evaluate
              --per-utt` (K1, K2 at 8 x 64, K3, K4, K6 24 a batch), held
              against the plain path; each stage's captured step against
              graph=False in turns (steps/s, idle shares, the capture,
              launches a replay), peak device memory, and the bundle's
              greedy RTFx at B=32 x 30 s;
12. engine  - run after phase 9: main path 10, Whisper continuous-batching
              serving (serve/engine.py) on phase 8's large-v3 bundle and on
              phase 9's quantize()d one: ServingEngine(16 lanes, 32 steps a
              dispatch, max_len 224), its decode step captured once as a
              CUDA graph and replayed; 16 windows (the six requests' seven
              and 9 seeded ones of 1-30 s) in staggered waves of 8, so
              lanes sit at different positions in one step. Exact launches:
              K1, K5, K6, K2h-out and K3c a wave, the captured step's K9 64
              (bf16) or K9-int8 64, K10 256 and K11 1 (int8) times its
              replays, confirmed by the profiler's kernel names over one
              replay; one dispatch replayed against the eager step from the
              same state (tokens, positions and done flags equal, caches
              within ULP_BAR, bitwise printed); every request's tokens
              through the plain decoder's steps (the margin rule); a second
              run timed: decode ms a step (graph and eager), tokens/s
              against static waves (224 steps) through bundle.transcribe's
              decode, latency, a dispatch's device idle share, peak memory,
              capture seconds; timestamps of two requests against
              whisper_token_spans; `cli serve` of three WAVs (plain,
              --int8, --timestamps);
13. streaming - main paths 11 and 12, CTC streaming (serve/streaming.py) on
              the flagship (random init, seed 0): StreamingPool(32 slots,
              10 s windows, 0.4 s hops, 0.64 s lookahead) on the device
              ring, its step (ring update, K1, K2 and K3 a block, K4)
              captured once as a CUDA graph and replayed; 40 seeded streams
              of 4-25 s fed a hop a step, opened at staggered steps and
              finished as they end (8 of them on reused rows). Exact
              launches: the captured step's K1 1, K2 12, K3 12, K4 1 times
              its replays (confirmed by the profiler's kernel names over one
              replay), and those of finish()'s host-assembled steps; the
              same streams through a second captured pool and a pool built
              with graph=False in lockstep, every replay bitwise the eager
              step from the same state (frames, ids, ring, results); the
              windows' ids against the plain path
              every 8 steps (the margin rule); texts equal to the
              host-assembled pool's and to single StreamingTranscribers';
              finish() over one window equal to bundle.transcribe of 10 s
              chunks; api.stream of one WAV and `cli transcribe --stream` of
              two, a line a hop; then the pool step timed with every slot
              busy (graph and eager in turns), a replay's and a step's
              device idle share, host-to-device bytes a step, latency,
              real-time capacity, capture seconds, peak memory, and K1-K4
              alone at this shape against their plain versions (K1 within
              LOGMEL_BAR, K2 and K3 within ULP_BAR and bitwise repeatable,
              K4 by the margin rule) beside their bounds. Main path 12: the
              banded flagship (left 12, right 6, position_mode "none",
              whisper_norm off) streaming three seeded utterances at a 3.2 s
              lookahead: K1, K3 and K4 launched exactly, never K2; its
              committed frames against the offline path's by the margin
              rule, the differing frames and tokens printed;
14. joint   - main paths 14-18, the joint CTC/attention family at the
              published widths of configs/joint_ctc_attention.yaml (12 + 6
              blocks of d 512, 4 heads of 128, mlp 2048, V 4336, WF rank 8;
              random init, seed 0, the WF inserts' B drawn from a seed-0
              generator): 16 seeded 30 s utterances through
              bundle.transcribe with ctc_greedy, greedy, beam (K 8, CTC
              rescoring) and spec_greedy, each with exact launches (K1,
              K7 through K2 and K3 a block, K4 for the CTC ids, K9 twice a
              decoder block a step, K7-mlp and K6 a decoder block a
              teacher-forced pass, spec's passes after the first replayed
              from one captured pass) and run twice to the same texts; the
              kernel path against the plain one: log-mel, the encoder
              (relative L2), CTC ids by the margin rule, greedy and spec
              tokens through the plain decoder's steps by the margin rule,
              spec against greedy (they part only where no token is
              clear), a beam of one bitwise greedy; every hypothesis of the
              beam (K 8), and of the beam with a seeded bigram LM fused at
              JOINT_LM_WEIGHT, fed back through the kernel steps: its score
              their summed log-probs (plus the LM's) within
              BEAM_RESCORE_BAR, each position within BEAM_TOKEN_BAR of the
              plain steps', a row's K hypotheses distinct and sorted, and
              the LM moving the fused beam toward its tokens; K7 at this
              model's shapes (encoder B x 750, decoder B x 64), K6 at the
              spec pass's cross-attention (B 16, Tq 64 against Tk 750, 4 x
              128, ragged lengths) and K9 at the beam's (128 rows, 4 x 128,
              Tk 768 and 128; in phase 8's cases) against plain, twice
              bitwise; the encoder a batch, an
              eager decode step (greedy, beam), spec passes and a profiled
              beam; K6 and K9 alone at the joint shapes beside bound and
              masked SDPA; the CTC branch streamed through a captured
              StreamingPool(16), 8 s and 12 s a slot (the ring rolls;
              texts = the host pool's; 30 s windows fed whole = offline
              ctc_greedy), api.stream, and `cli
              transcribe --strategy beam`;
15. ctc_beam - main paths 19 and 20, CTC prefix beam search at the
              published widths of configs/ctc_batched_beam.yaml (12 x d512,
              8 heads of 64, mlp 2048, V 4336; random init, seed 0): 128
              seeded 30 s utterances (bench.py::bench_beam_rtfx's shape)
              through bundle.transcribe with `beam` (the C++ engine,
              native/beam.cpp built from the checkout, over the card's
              top-16 posteriors) and `beam_device` (the fixed-width beam on
              the card), exact launches (K1 1, K2 12, K3 12); the frame
              argmax against the plain path (the margin rule);
              ctc_topk_posteriors on the card bitwise the host's over the
              same log-probs (f16 / int16 at k 16, f32 / int32 at k = V - 1);
              the engine's ids at one thread and at the default; on 4 rows,
              the device beam's and the engine's winners within 0.3 nats of
              the host searcher's by the CTC likelihood, and the host
              searcher with a seeded bigram LM fused at 0.5 moving its
              winners toward the LM; the six requests through
              bundle.transcribe and `cli transcribe --strategy beam |
              beam_device` twice; then encoder + top-k ms a batch (both
              paths), bytes to the host, the engine at prune 0 and -10, the
              device beam's ms and launches, and the pipelined RTFx
              (random init: not a ledger number);
16. joint_train - main paths 21 and 22, `cli train` of
              configs/joint_ctc_attention.yaml at its published widths (WF
              rank 8, train_adapters_only, ctc_weight 0.3) on 16 seeded 30 s
              WAVs, 3 steps: exact launches (K1 1, K6 12, K8 12 a step), the
              three losses finite, the backbone bitwise, every WF B moved;
              one step's loss, loss_ctc, loss_att and adapter gradients on
              the kernel path against plain; K6 and K8 alone at the
              encoder's shape (B 16, T' 750, 4 x 128, lengths 750 / 517 /
              129 / 1) against plain, twice bitwise, timed beside bound and
              SDPA, with ptxas's dh=128 report; the saved bundle through
              api.load with ctc_greedy and greedy (exact launches); the
              captured step against graph=False (bit for bit over
              GRAPH_STEPS), steps/s in turns and each route's idle share;
17. whisper_finetune - main paths 23-25 (phase_whisper_finetune; its
              captured step against graph=False bit for bit, then steps/s
              of both routes in turns);
18. real_audio - main paths 26 and 27, real recordings in: 32 seeded
              utterances of 30 s, eight each of 44.1 kHz 16-bit FLAC (the
              script's own encoder), 48 kHz 24-bit, 22.05 kHz float and
              8 kHz 8-bit WAV, through `cli transcribe` on the flagship
              (phase 4's seeded weights; K1, K2 and K3 12 times, K4 on the
              batch the card resampled); every file decoded exactly; the
              card's resample within RESAMPLE_SCIPY_BAR of scipy's f64
              resample_poly on the interior; the file path's ids against
              the plain path on scipy-resampled 16 kHz arrays by the margin
              rule. Then `cli train --profile` of
              configs/adapter_finetune.yaml with every waveform
              augmentation on over 16 of the files (AUG_OVERRIDES; the
              loader resamples them; K1 1, K6 and K8 12 a step): finite
              losses, one MetricsLogger record a step, the trace naming
              K1's, K6's and K8's kernels; the same step timed with the
              augmentation off and on in turns (its cost a step); and
              evals/rtfx.measure_rtfx on the flagship's greedy batch (B=32
              x 30 s) beside phase 7's reading;
19. multigpu - main path 28, run right after phase 5 on its corpus:
              `cli train --multihost` of configs/adapter_finetune.yaml at
              full width under `python -m torch.distributed.run
              --nproc-per-node 1` (a 1 x 1 x 1 mesh: NCCL, the FSDP2 wrap
              and the kernels under it), 3 steps of B=16 x 30 s: the
              losses bitwise phase 5's (the one-process loop on the same
              batches; under a process group the step runs eagerly by
              rule, on the same capturable AdamW), K1, K6, K8 and
              jl_ctc_loss launched as often as in phase 5 (the
              launcher's process counts them, `--multigpu-worker`), and
              its step-3 checkpoint restored into this process, which has
              no process group: the step and every tensor bitwise phase
              5's checkpoint;
20. tp      - main path 29, tensor parallelism's kernel forms on this one
              card (phase_tp): the collective is the one piece a single
              card cannot run, so the ranks of a model group are copies of
              the same sharded modules the multi-card run uses
              (parallel/tp.apply_tp), each rank's partial products are
              summed here on the card, and a decode step's ranks take turns
              as threads of this process (TurnGroup: the sums and the
              vocab gather made on the card in rank order). Per rank, at
              large-v3 width (d 1280, 20 heads of 64, mlp 5120) at tp 2 and
              4 (and with WF inserts folded per shard at tp 2): K5 on the
              rank's packed q/k/v (1,920 columns at tp 2; 960 padded to
              1,024 at tp 4), K6 on its 10 or 5 heads, the row-parallel
              partial GEMM (jl_row_partial, f32 out) of the out-projection,
              ln_fc1 (K3's first two launches on the rank's 2,560 or
              1,280 hidden columns, erf) and the row-parallel fc2; on the
              flagship (d 512, 4 heads of 128, mlp 2048, tanh) at tp 2,
              K2's first three launches on 2 heads of 128
              (attention_core_tp), ln_fc1 and both row-parallel products.
              Each launch against its plain version (ULP_BAR; the f32
              partials within ROW_REL_BAR) and launched twice, bitwise
              equal; the ranks' summed sublayer (K2's or K2h-out's and
              K3's epilogue on the sum) against the unsharded kernel
              route (K5 -> K6 -> K2h-out and K3c; K2 and K3) within
              ULP_BAR; one Whisper decode step a position over 8
              teacher-forced positions of a large-v3-width decoder cut to
              TP_DECODE_LAYERS blocks (V 51866, vocab-split at tp 2,
              replicated at tp 4), every rank on head-major caches of its
              heads (K9 on 10 and 5 heads), its joined logits equal on
              every rank and held against the unsharded step by the
              margin rule; then each decoder rank's decode-step launches
              against their plain versions and twice bitwise: the row
              partials of block 0's self- and cross-attention
              out-projections and fc2 on B=16 one-token rows (ROW_REL_BAR)
              and K9 on its self and cross caches (ULP_BAR); each rank's
              vocab columns of the tied logits against the unsharded
              product's (ULP_BAR; cuBLAS chooses its own sum order at each
              width); exact launch counts; the row-parallel GEMM, ln_fc1,
              attention_core_tp and K5 at the padded width timed beside
              plain, bound and cuBLAS.
21. tp_serve - main path 30, Whisper serving on a split model
              (phase_tp_serving): a large-v3-width model (d 1280, 20 heads
              of 64, mlp 5120, V 51866) cut to TPS_LAYERS encoder and
              decoder blocks, each rank of a model group a copy split
              (parallel/tp.apply_tp) and quantized after the split (a row
              layer's scales the group's max), the ranks threads taking
              turns (TurnGroup), at tp 2 (10 heads, 25,933 vocab rows a
              rank) and tp 4 (5 heads, the int8 table replicated): every
              rank's ServingEngine stepped eagerly (a stand-in group cannot
              be captured) over TPS_SLOTS seeded requests of 1-30 s in one
              wave, TPS_MAX_LEN tokens a lane; exact launch counts (a wave:
              K1, each encoder block's K5, K6, ln_fc1 and two bf16 row
              partials; a step: each decoder block's five K10 on the
              rank's columns, three K10 row partials (jl_int8_row_partial,
              f32 out) and two K9-int8 on its heads, then K11 on its vocab
              rows); every rank's results equal; the tokens through the
              unsplit int8 decoder's teacher-forced steps (the margin
              rule); rank 0's launches at the decode shapes against their
              plain versions and twice bitwise (the K10 row partial at 1,
              16 and 64 rows of 640 / 320 and 2,560 / 1,280 -> 1,280
              within ROW_REL_BAR, K10 on q_proj's and fc1's columns
              within ULP_BAR, K11 on 25,933 and 51,866 rows within
              ROW_REL_BAR, K9-int8 on its engine's self and cross caches
              within ULP_BAR); the K10 row partial, K11 and K9-int8 timed
              at the split shapes beside plain, bound and library; then
              the AR beam over 2 utterances x 4 beams and the timestamps
              of 2 requests on every rank (equal on every rank), held to
              one card: each beam score within TPS_BEAM_REL_BAR of the
              unsplit decoder's steps fed the same hypothesis and the
              split's best within the bar of one card's best; the
              timestamps' tokens equal and each span within
              TPS_SPAN_BAR_FRAMES of one card's; then the beam bar's upper
              reading: the split beam with the self caches not gathered
              along the winning beams, and with the last rank's share left
              out of every all-reduce, each above TPS_BEAM_REL_BAR.
22. tp_ctc  - main path 31, the CTC and joint paths on a split model
              (phase_tp_ctc_joint): the flagship (CTCModelConfig's widths)
              and configs/joint_ctc_attention.yaml (WF inserts drawn), each
              stack cut to TPC_LAYERS blocks, every rank of a model group a
              copy split as its rank, the ranks TurnGroup threads at tp 2
              and 4 (2 and 1 heads of 128), eager: a StreamingPool of
              TPC_SLOTS streams over TPC_STEPS ring steps, the device CTC
              beam (beam 8) through transcribe, and the joint greedy,
              spec_greedy (64-position teacher passes) and beam through
              transcribe; exact launch counts (from the decode steps and
              teacher passes the ranks took); every rank's results equal;
              held to the unsplit models on the same card: the pool's rings
              bitwise and its ids where one card's top-2 margin passes
              ARGMAX_MARGIN, the beam's best NLL within NLL_REL_BAR of one
              card's under one card's log-probs, the joint greedy and
              spec_greedy tokens by the margin rule, the joint beam's
              scores within TPS_BEAM_REL_BAR of one card's steps fed them
              (an EOS-only hypothesis's within ULP_BAR ulps of its logit);
              then every bar's upper reading, the same paths with the last
              rank's share left out of every all-reduce (tp 2), each of
              which must fail its bar; then K2-tp, ln_fc1 and the row
              partials at the ring's, the joint's and the beam's rows, the
              teacher pass's ln_fc1 and fc2 partial, K9 on a rank's self
              and cross caches, each twice bitwise against its plain
              version; K2-tp, ln_fc1 and the row partials timed at the
              ring's rows, K9 at 2 and 1 heads, K6 and K8 at the joint's
              training shape on 2 and 1 heads (held and timed);
23. decode_graphs - main path 32, the offline decode loops on captured
              CUDA graphs (phase_decode_graphs; utils/graphs.py): the
              forced prompt steps and the first generated one eagerly as
              the warm-up, then a chunk of 8 steps captured and replayed,
              one host read of "every row done" a replay. Whisper
              large-v3 greedy at B=16 x 30 s, bf16 and quantize()d int8,
              captured against graph=False bitwise over DG_EAGER_LEN, int8
              also captured with the plain int8 write (the kernels a step
              jl_int8_kv_write saves); the captured loops alone over 224
              (exact launches) with ms a step, tokens/s, the capture's
              seconds, kernels a replayed step and the replays' idle
              share; jl_int8_kv_write (the port's own kernel: the int8
              self-cache write in one launch) bitwise its plain version
              at large-v3's self caches and a joint rank's beam rows
              (ragged positions with 0 and the last rows, rows of zeros),
              timed with its bound; the Whisper AR beam at WHISPER_BEAM,
              the joint greedy and beam of 8 (16 x 30 s) and the device
              CTC beam (128 x 30 s, beam 8, f32 and f64), each captured
              against eager, bitwise, with both routes' times;
              temperature sampling (T 1.0, one seeded CUDA generator
              registered with the graph) on large-v3 bf16 and int8 over
              DG_EAGER_LEN, bitwise eager, a replayed sampled step timed
              beside the replayed greedy one; spec_greedy on the joint
              config (16 x 30 s, the CTC draft): its first pass eagerly,
              then one captured pass a replay, tokens, lengths and passes
              bitwise eager, ms a pass both ways; then a process of its
              own (`--cold-capture-worker`) whose first decode work is
              greedy and the beam under prompt=() captured, on the joint
              config and a quantize()d large-v3 cut to 2 + 2 blocks, twice
              on new encoder outputs, each bitwise its graph=False run.

Each main path runs with every launch count set to 0 just before it and read
just after; a kernel of that path that never launched fails the run. A
launch replayed from a CUDA graph is not counted by its wrapper (the
wrapper ran once, at capture): main paths 10's, 11's and 18's launches are
their counted ones plus the captured step's launches times its replays,
and every path's launches include the offline decode loops' and the train
step's replays (utils/graphs.TALLY, added by drive()). The offline loops (greedy, the
AR beam, the device CTC beam) capture on the card, so a captured loop's
steps run in whole chunks of 8: phase 8's AR beam takes captured_steps()
steps; the eager decode readings of phases 8, 9, 14 and 15, kept for
comparison with earlier runs, pass graph=False.
Every JSON line carries t_s, the seconds since the script started. Then a
line {"kernels": [...]} and, last, {"ok": true, "device": {...}}. There is
no CPU path: without CUDA the script exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import itertools
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# --- bars -----------------------------------------------------------------
# K1: the JAX package's log-mel parity bar (docs/COMPONENTS.md C3), on the
# Whisper-normalized surface. Both sides are full f32; only summation order
# differs.
LOGMEL_BAR = 2e-4
# K2, K3: max |kernel - plain| <= ULP_BAR bf16 ulps of the output magnitude
# (the ulp of max |plain|). Both round to bf16 at the same points and differ
# only in the order of f32 sums, which can flip a rounding of an
# intermediate by one ulp; the output itself passes three roundings (product,
# + residual, + bias). The per-element figure (ulps of each element's own
# magnitude, floored at the mean) is printed too: it read 3 on K2's first run.
ULP_BAR = 2.0
# P4 at the other widths and the erf form its wrapper takes (d, mlp, GELU
# form): the other LN row passes and GEMM instances, d > mlp included
P4_CASES = ((1024, 2048, "erf"), (2048, 1024, "tanh"))
# K4 and the end-to-end ids: compared on every frame whose plain top-2 logit
# margin exceeds ARGMAX_MARGIN. K4 alone differs from its plain version by
# f32 summation order (~1e-4 on logits of O(1)); end to end, bf16 rounding
# flips compound through 12 blocks. At least MIN_COVERAGE of the frames must
# clear the margin, or the comparison would be hollow.
ARGMAX_MARGIN = 0.05
MIN_COVERAGE = 0.5
# K6: lse (f32) within LSE_BAR absolute of the plain version; out under the
# K2/K3 ulp bar. K8: each of dQ, dK, dV within GRAD_REL_BAR of that
# gradient's largest magnitude, against the plain backward in f32 (the
# kernel rounds P and dS to bf16 for its tensor-core products and writes
# bf16); keys past kv_len get exactly zero dK and dV.
LSE_BAR = 1e-3
GRAD_REL_BAR = 0.01
# Whisper: the kernel-path encoder output within ENC_REL_BAR (relative L2)
# of the plain path's: both are bf16 through 32 blocks, and a one-ulp flip
# of an intermediate in one block moves the rest (ULP_BAR holds each
# kernel alone). Decoder tokens: the margin rule above, teacher-forced.
ENC_REL_BAR = 0.05
# K11: f32 logits, the same bf16 products as the plain version summed in
# another order (tensor-core k16 steps against cuBLAS): max |kernel - plain|
# within LOGITS_REL_BAR of max |plain| (2.3e-7 to 4.2e-7 on an H100 at
# the shapes below). K9-int8 and K10 round to bf16 and take ULP_BAR.
LOGITS_REL_BAR = 1e-5
# The row-parallel partial (f32 out): the same bf16 products as its plain
# version's f32 matmul summed in another order, max |kernel - plain|
# within ROW_REL_BAR of max |plain| (0.3e-6 to 2.1e-6 on an H100 at the
# shapes of phase 20).
ROW_REL_BAR = 1e-5

TPU = "jiao_liao_speech_recognition_tpu/"
KERNELS = [  # key, name, wrapper module, counter, CUDA source, TPU kernel it replaces
    ("K1", "K1 fused_log_mel_raw", "frontend.fused_frontend", "COUNTER",
     "csrc/log_mel_tf32.cu", TPU + "frontend/pallas_frontend.py:91"),
    # K2: K5's two launches and its out-projection are csrc/ln_gemm.cu's; its
    # attention core (the source named) is csrc/flash_attention.cu's
    ("K2", "K2 fused_attention_sublayer", "ops.fused_attention", "COUNTER",
     "csrc/flash_attention.cu", TPU + "ops/fused_attention.py:163"),
    ("K3", "K3 fused_ln_mlp_residual", "ops.fused_mlp", "COUNTER", "csrc/ln_gemm.cu",
     TPU + "ops/fused_mlp.py:180"),
    ("K4", "K4 fused_head_argmax", "ops.fused_head", "COUNTER", "csrc/head.cu",
     TPU + "ops/fused_head.py:78"),
    ("K6", "K6 flash_forward", "ops.flash_attention", "COUNTER", "csrc/flash_attention.cu",
     TPU + "ops/flash_attention.py:667"),
    ("K8", "K8 flash_backward", "ops.flash_attention", "BWD_COUNTER", "csrc/flash_attention.cu",
     TPU + "ops/flash_attention.py:340"),
    ("K7-attn", "K7 fused_attention_sublayer_wf", "ops.fused_attention", "WF_COUNTER",
     "csrc/flash_attention.cu", TPU + "ops/fused_attention.py:561"),
    ("K7-mlp", "K7 fused_ln_mlp_residual_wf", "ops.fused_mlp", "WF_COUNTER", "csrc/ln_gemm.cu",
     TPU + "ops/fused_mlp.py:401"),
    ("K5", "K5 fused_ln_qkv", "ops.fused_mlp", "QKV_COUNTER", "csrc/ln_gemm.cu",
     TPU + "ops/fused_mlp.py:510"),
    # K3's d=1280 instance, counted apart
    ("K3c", "K3c fused_ln_mlp_residual d=1280", "ops.fused_mlp", "K3C_COUNTER", "csrc/ln_gemm.cu",
     TPU + "ops/fused_mlp.py:294"),
    # the out-projection + residual of the head-group-split K2h, which the TPU
    # runs for the large-v3 encoder; on the card K5 -> K6 -> this launch
    ("K2h-out", "K2h out_proj_residual", "ops.fused_attention", "OUT_COUNTER",
     "csrc/ln_gemm.cu", TPU + "ops/fused_attention.py:387"),
    ("K9", "K9 grouped_decode_attention", "ops.decode_attention", "COUNTER",
     "csrc/decode_attention.cu", TPU + "ops/decode_attention.py:151"),
    # K9's int8 half: the same kernel templated on the cache type
    ("K9-int8", "K9 grouped_decode_attention int8", "ops.decode_attention", "INT8_COUNTER",
     "csrc/decode_attention.cu", TPU + "ops/quant.py:80"),
    ("K10", "K10 int8_matmul", "ops.quant", "MATMUL_COUNTER", "csrc/quant.cu",
     TPU + "ops/quant.py:248"),
    ("K11", "K11 int8_tied_logits", "ops.quant", "LOGITS_COUNTER", "csrc/quant.cu",
     TPU + "ops/quant.py:111"),
    # the A/B probes: kernels of the example scripts, not of the JAX package
    ("P4", "P4 w8a8_ln_mlp_residual", "ops.probes", "W8A8_COUNTER", "csrc/w8a8_mlp.cu",
     "examples/profile_w8a8_mlp.py:95"),
    ("P1", "P1 log_mel_bf16x3_raw", "ops.probes", "BF16X3_COUNTER", "csrc/log_mel_tf32.cu",
     "examples/profile_frontend_precision.py:105"),
    ("P2", "P2 head_argmax_chunked", "ops.probes", "CHUNKED_COUNTER", "csrc/head.cu",
     "examples/profile_head_kernel.py:113"),
    # tensor parallelism's forms (phase 20): K2's first three launches on a
    # rank's heads, K3's first two on its hidden columns, and the
    # row-parallel partial GEMM (csrc/ln_gemm.cu's kRowPartial instance)
    # that ends both sublayers before the ranks' sum
    ("K2-tp", "K2 attention_core_tp", "ops.fused_attention", "TP_CORE_COUNTER",
     "csrc/flash_attention.cu", TPU + "ops/fused_attention.py:163"),
    ("K3-tp", "K3 ln_fc1", "ops.fused_mlp", "LN_FC1_COUNTER", "csrc/ln_gemm.cu",
     TPU + "ops/fused_mlp.py:294"),
    ("row-partial", "row_parallel_partial", "ops.fused_attention", "ROW_COUNTER",
     "csrc/ln_gemm.cu", TPU + "ops/fused_attention.py:387"),
    # K10's row-parallel form (phase 21): the same cluster kernel with an
    # f32 epilogue, a rank's unrounded share of an int8 row layer
    ("K10-row", "K10 int8_row_partial", "ops.quant", "ROW_PARTIAL_COUNTER", "csrc/quant.cu",
     TPU + "ops/quant.py:248"),
    # the port's own kernel (phase 23): the int8 self-cache write, which the
    # JAX package leaves to XLA (quantize_kv + the cache update, fused in
    # its decode loop); no Pallas kernel stands behind it
    ("KVW", "jl_int8_kv_write", "ops.quant", "KV_WRITE_COUNTER", "csrc/quant.cu",
     TPU + "ops/quant.py:61"),
    # the port's own kernel (phase 3b): the CTC loss of a train step, which
    # the JAX package leaves to XLA (a lax.scan); forward, and backward in
    # two launches counted as one call
    ("CTC", "jl_ctc_loss forward", "ops.ctc_loss", "COUNTER", "csrc/ctc_loss.cu",
     TPU + "ops/ctc_loss.py:34"),
    ("CTC-bwd", "jl_ctc_loss backward", "ops.ctc_loss", "BWD_COUNTER", "csrc/ctc_loss.cu",
     TPU + "ops/ctc_loss.py:34"),
]
# main path -> the kernels it must launch
PATHS = {
    "serve": ("K1", "K2", "K3", "K4"),
    "finetune": ("K1", "K6", "K8", "CTC", "CTC-bwd"),
    "adapted_serve": ("K1", "K2", "K3", "K4", "K7-attn", "K7-mlp"),
    "whisper_serve": ("K1", "K5", "K6", "K2h-out", "K3c", "K9"),
    "whisper_int8_serve": ("K1", "K5", "K6", "K2h-out", "K3c", "K9", "K9-int8", "K10", "K11"),
    "whisper_int8_b16": ("K9-int8", "K10", "K11", "KVW"),
    "probes": ("K1", "K3", "K4", "P1", "P2", "P4"),
    "prepare": ("K1",),
    "transfer": ("K1", "K6", "K8", "CTC", "CTC-bwd"),
    "transfer_serve": ("K1", "K2", "K3", "K4", "K6"),
    "whisper_engine": ("K1", "K5", "K6", "K2h-out", "K3c", "K9"),
    "whisper_int8_engine": ("K1", "K5", "K6", "K2h-out", "K3c", "K9-int8", "K10", "K11", "KVW"),
    "streaming": ("K1", "K2", "K3", "K4"),
    "streaming_banded": ("K1", "K3", "K4"),
    "whisper_beam": ("K1", "K5", "K6", "K2h-out", "K3c", "K9"),
    "joint_ctc_greedy": ("K1", "K2", "K3", "K4", "K7-attn", "K7-mlp"),
    "joint_greedy": ("K1", "K2", "K3", "K7-attn", "K7-mlp", "K9"),
    "joint_beam": ("K1", "K2", "K3", "K7-attn", "K7-mlp", "K9"),
    "joint_spec": ("K1", "K2", "K3", "K4", "K6", "K7-attn", "K7-mlp"),
    "joint_stream": ("K1", "K2", "K3", "K4", "K7-attn", "K7-mlp"),
    "ctc_beam": ("K1", "K2", "K3"),
    "ctc_beam_device": ("K1", "K2", "K3"),
    "joint_train": ("K1", "K6", "K8", "CTC", "CTC-bwd"),
    "joint_trained_ctc_greedy": ("K1", "K2", "K3", "K4", "K7-attn", "K7-mlp"),
    "joint_trained_greedy": ("K1", "K2", "K3", "K7-attn", "K7-mlp", "K9"),
    "whisper_finetune": ("K1", "K6", "K8"),
    "whisper_adapted_serve": ("K1", "K5", "K6", "K2h-out", "K3c", "K7-attn", "K7-mlp", "K9"),
    "whisper_adapted_int8": ("K1", "K5", "K6", "K2h-out", "K3c", "K7-attn", "K7-mlp", "K9",
                             "K9-int8", "K10", "K11"),
    "real_audio": ("K1", "K2", "K3", "K4"),
    "augmented_train": ("K1", "K6", "K8", "CTC", "CTC-bwd"),
    "multigpu": ("K1", "K6", "K8", "CTC", "CTC-bwd"),
    "tp": ("K5", "K6", "K9", "K2-tp", "K3-tp", "row-partial"),
    "tp_serve": ("K1", "K5", "K6", "K3-tp", "row-partial", "K9-int8", "K10", "K10-row", "K11",
                 "KVW"),
    "tp_ctc": ("K1", "K2-tp", "K3-tp", "row-partial", "K4", "K6", "K9"),
    "decode_graphs": ("K9", "K9-int8", "K10", "K11", "KVW"),
}
# phase 3b: jl_ctc_loss at the fine-tune's training shape (B, T', V, S),
# against its plain version: the NLL within CTC_NLL_REL_BAR (relative; an
# infeasible row's 1e30 exactly) and the gradient within CTC_GRAD_BAR of its
# largest value (the recursions in the same f32 order; the plain gradient
# sums a label's states by a scatter in another order)
CTC_SHAPE = (16, 750, 4336, 128)
CTC_NLL_REL_BAR = 1e-5
CTC_GRAD_BAR = 1e-5
CTC_TIMED_ITERS = 10
# the captured train step (phases 5, 7, 11, 16, 17): GRAPH_STEPS steps on
# graph=False and on the captured route from one state, held bit for bit;
# then steps/s in GRAPH_TURNS of GRAPH_RATE_STEPS (True = captured; each
# captured turn captures anew, untimed, and releases its graph), and
# GRAPH_PROFILE_STEPS steps of each route under the profiler
GRAPH_STEPS = 3
GRAPH_TURNS = (False, True, True, False)
GRAPH_RATE_STEPS = 3
GRAPH_PROFILE_STEPS = 1
# phase 5's run across two bucket shapes: B=4 of 10 s and of 30 s
BUCKET_B, BUCKET_SECONDS, BUCKET_STEPS = 4, (10.0, 30.0), 4
WHISPER_GRAPH_RATE_STEPS = 2  # large-v3's timed steps a turn
# phase 19: the launcher's limit (its start, ~10 s to reach the card, and
# 3 steps of phase 5's fine-tune)
MULTIGPU_TIMEOUT_S = 300
# the Whisper fine-tune: configs/whisper_large_v3_adapters.yaml at B=16 x 30 s
WHISPER_FT_CONFIG = "configs/whisper_large_v3_adapters.yaml"
WHISPER_FT_STEPS = 3  # the config's total_steps, cut
# whisper.remat stays the config's (off): one B=16 step peaks at 72.0 GB
# without it on the H100 (39.3 GB with it)
WHISPER_FT_REMAT = False
WHISPER_FT_EOT = 50257  # ordinary BPE ids below it, large-v3's specials from it
WHISPER_FT_CHECK_B = 2  # the kernel-vs-plain step: plain attention keeps [B, 20, T, T] f32
WHISPER_FT_LENS = (1500, 1033, 257, 1)  # key lengths of K6 / K8 alone at the training shape
FT_STEP_LOSS_BAR = 1e-3  # relative
# the Whisper configuration and the shapes of its kernel checks
WHISPER_PRESET = "large-v3"
WHISPER_B, WHISPER_T = 16, 1500  # a batch of 30 s chunks, encoder positions
WHISPER_MAX_LEN = 224
# decode steps of the timed greedy runs at B=16 (phases 8 and 9): a step's
# cost barely moves with the position (the self caches' K9 takes ~0.2 ms of
# a step's ~70); 224 steps a run took ~190 s of the whole script on a slow
# host, and 64 (until phases 15-16 came) more than 32
WHISPER_TIMED_LEN = 32
# the offline decode timings' turns, kernel path then plain (a second pair
# would repeat the first's reading)
DECODE_TURNS = (True, False)
INT8_B16_COUNT_LEN = 32  # the B=16 launch-count run decodes this far
INT8_BENCH = (8, 64)  # bench.py::bench_large_v3_decode: B=8, max_len 64
# the serving engine (main path 10): lanes, decode steps a dispatch, the
# windows served, and the max_decode_len of the `cli serve` runs
ENGINE_SLOTS, ENGINE_SPD = 16, 32
ENGINE_WINDOWS = 16  # 24 before PR 27, cut to keep the run under its limit
ENGINE_CLI_LEN = 32
PROFILE_ATTEMPTS = 2  # profiles of a replay read before a kernel-name count fails
# CTC streaming (main paths 11 and 12): the pool's slots and geometry
# (StreamingConfig's defaults: 10 s windows, 0.4 s hops, 0.64 s lookahead),
# the streams served (8 more than the slots: they reuse freed rows), steps
# between two plain-path checks of the windows, and the timed steps (each
# pool warmed, then turns of graph, eager, eager, graph)
STREAM_SLOTS, STREAM_GEOMETRY, STREAM_COUNT = 32, (10.0, 0.4, 0.64), 40
STREAM_PLAIN_EVERY = 8
STREAM_WARM_STEPS, STREAM_TURN_STEPS = 6, 10
# the banded flagship: examples/streaming_quality.py's band, streamed at a
# lookahead that covers 12 blocks x 6 frames of right context (3.2 s = 80
# frames) and a window whose committed frames keep 12 x 12 frames of left
# context (250 - 10 - 80 >= 146)
BANDED = {"attention_left_context": 12, "attention_right_context": 6, "position_mode": "none"}
BANDED_GEOMETRY = (10.0, 0.4, 3.2)
# one replay of the pool's graph by the profiler's kernel names (one launch
# of each kernel's tag a K1 or K4 call, one a block for K2 and K3)
STREAM_KERNEL_NAMES = {"K1": "log_mel_tf32_kernel", "K2 core": "attention_core_kernel",
                       "K2 out-projection": "gemm_kernel<4, 2>", "K3 fc2": "gemm_kernel<3, 0>",
                       "K4 tiles": "head_tile_argmax_kernel"}
# Whisper's AR beam on phase 8's bundle (main path 13): rows, K, max_len
# (32 decode steps)
WHISPER_BEAM = (2, 4, 33)
# the joint CTC/attention family (main paths 14-18): its config at the
# published widths, the batch (data.batch_size), the beam and horizon of
# its decode section; the std of the seeded WF inserts' B matrices; seconds
# of each utterance streamed, even and odd slots (past the 10 s window,
# so the ring rolls and the transcribers trim); beam steps under the
# profiler; the bigram LM fused into the joint beam on the card (trained
# on seeded sequences over its first JOINT_LM_IDS ids) and its weight
JOINT_CONFIG = "configs/joint_ctc_attention.yaml"
JOINT_B, JOINT_BEAM, JOINT_MAX_LEN = 16, 8, 64
JOINT_WF_B_STD = 0.02
JOINT_STREAM_SECONDS = (8.0, 12.0)
JOINT_PROFILE_STEPS = 4
JOINT_LM_IDS, JOINT_LM_WEIGHT = 64, 0.5
# the beam's hypotheses fed back through the decoder's kernel steps as the
# beam runs them: each beam score must be the sum of those steps' log-probs
# (the same f32 operations; only the order of the additions may differ, a
# few f32 ulps of a ~300-nat sum, 2^-15 each) within BEAM_RESCORE_BAR, far
# under the spread of a row's K scores (0.2-0.5 nats), so a score on the
# wrong hypothesis or a self cache gathered from the wrong beam shows. Each
# position's log-prob on the kernel steps against the plain steps' within
# BEAM_TOKEN_BAR: the margin rule's ARGMAX_MARGIN, the drift it lets two
# logits have between the paths
BEAM_RESCORE_BAR = 1e-3
BEAM_TOKEN_BAR = ARGMAX_MARGIN
# CTC prefix beam search (main paths 19-20): configs/ctc_batched_beam.yaml at
# bench.py::bench_beam_rtfx's shape (128 x 30 s, beam 8, top-k 16); the rows
# the Python host searcher runs; tests/test_decode.py's bar on the CTC
# log-likelihood of two searchers' winners, held where both search at one
# precision (the device beam in f64 on the card, the engine over the f32
# top-k: the host searcher and the engine sum in f64). At T' = 750 on flat
# random-init rows the shipped precisions (the f32 device beam, the engine
# over the f16 transfer) part from it at near-ties in either direction, by
# up to a few nats of ~3,750 (tests/test_torch_ctc_beam.py shows the f64
# beam equal to the host searcher where the f32 one is not): those are
# held within NLL_REL_BAR of the host's NLL instead, and printed. The seeded bigram LM fused on the host
# (its ids, its weight); the batches of the pipelined RTFx; the frames of
# the two device-beam profiles whose difference gives launches a frame
CTC_BEAM_CONFIG = "configs/ctc_batched_beam.yaml"
CTC_BEAM_B, CTC_BEAM_K, CTC_BEAM_TOPK = 128, 8, 16
CTC_BEAM_HOST_ROWS = 4
NLL_BAR = 0.3
NLL_REL_BAR = 1e-3
CTC_BEAM_PROFILE_FRAMES = (25, 50)
CTC_BEAM_LM_IDS, CTC_BEAM_LM_WEIGHT = 64, 0.5
CTC_BEAM_RTFX_BATCHES = 4
# joint CTC/attention training (main paths 21-22): `cli train` steps of the
# published config, and the kernel-path steps timed under the profiler
JOINT_TRAIN_STEPS = 3
# the probes' profilers in examples/ and their main()'s arguments at the
# flagship's B=32 (the probes' own defaults are B=128)
PROBES = {
    "P4": ("torch_profile_w8a8_mlp", ["--b", "32", "--t", "750"]),
    "P1": ("torch_profile_frontend_precision", ["--batch", "32", "--secs", "30"]),
    "P2": ("torch_profile_head_kernel", ["--batch", "32", "--frames", "750"]),
}
# the fine-tune: optimizer steps through api.fine_tune; the one-step
# kernel-against-plain comparison: loss within FT_LOSS_BAR (relative); the
# adapter gradients, all as one vector and the median tensor, within
# FT_GRAD_BAR (relative L2); each single tensor no further from the plain
# path than the plain path is from the same step in float32, plus
# FT_GRAD_BAR. A one-ulp change anywhere in 12 bf16 blocks moves a few
# small adapter gradients (the q_proj inserts: sums over 12,000 frames that
# nearly cancel) by several percent, and both bf16 paths sit up to ~10%
# from float32 there; K6 and K8 alone are held to GRAD_REL_BAR above.
FT_STEPS = 3
FT_LOSS_BAR = 0.005
FT_GRAD_BAR = 0.02
# the multi-dialect transfer (configs/multi_dialect_transfer.yaml at its
# published widths): three seeded corpora of TRANSFER_UTTS 30 s WAVs, so
# that each train split keeps 16 rows (B=16) beside the one dev and one
# test row prepare always takes; TRANSFER_STEPS steps a stage. Launches a
# step: K6 at every self-attention and every Att-adapter attention (T'=750
# >= flash_train_min_q), K8 at each that sees a tensor needing a gradient
# (in stage 2 not block 0's self-attention, whose input is frozen).
TRANSFER_CORPORA = ("jilu", "zhongyuan", "jiaoliao")
TRANSFER_UTTS = 18
TRANSFER_STEPS = 3
# steps a timed turn of each stage: the host clock spreads by tens of
# percent over four steps on a shared host
# published H100 SXM peaks (NVIDIA's data sheet, dense): the bound of a
# kernel is the larger of its bytes over HBM_BYTES_S and its operations over
# the peak rate of their type
HBM_BYTES_S = 3.35e12
L2_BYTES = 50e6
PEAK_OPS_S = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "int8": 1979e12}
PKG = "jiao_liao_speech_recognition_torch"
SAMPLE_RATE = 16000


START = time.monotonic()


def emit(obj) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**obj, "t_s": round(time.monotonic() - START, 1)}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def bf16_ulp_err(got, want):
    """-> (max |got - want| in bf16 ulps of max |want|, the same per element
    in ulps of max(|want_i|, mean |want|), share of elements over 1 such ulp)."""
    import torch

    def ulp(v):
        return torch.exp2(torch.floor(torch.log2(v.clamp_min(2.0 ** -126))) - 7)

    w = want.float()
    diff = (got.float() - w).abs()
    per_elem = diff / ulp(torch.maximum(w.abs(), w.abs().mean()))
    return (float(diff.max() / ulp(w.abs().max())), float(per_elem.max()),
            float((per_elem > 1).float().mean()))


def margins(logits):
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def margin_check(logits, toks, lens, P):
    """Teacher-forced f32 logits [B, L - 1, V] of toks [B, L] (the prompt,
    then the generated ids padded with EOT): positions P-1 .. P-1+len predict
    the generated ids and the EOT. -> (coverage, mismatched positions,
    positions scored, agreement on every scored position)."""
    import torch

    pos = torch.arange(toks.shape[1] - 1, device=toks.device)[None, :]
    n_pred = torch.clamp(lens + 1, max=toks.shape[1] - P)
    scored = (pos >= P - 1) & (pos < P - 1 + n_pred[:, None])
    plain = logits.argmax(-1)
    clear = scored & (margins(logits) > ARGMAX_MARGIN)
    return (float(clear.sum() / scored.sum()), int(((plain != toks[:, 1:]) & clear).sum()),
            int(scored.sum()), float(((plain == toks[:, 1:]) & scored).sum() / scored.sum()))


def device_ms(fn, iters: int = 20) -> float:
    """The port's utils.timing.device_ms, imported once the port is on the path."""
    from jiao_liao_speech_recognition_torch.utils.timing import device_ms as timed

    return timed(fn, iters)


def queued_ms(fn, iters: int = 20) -> float:
    """The port's utils.timing.queued_ms (device_ms's stand-in when the
    profiler sees no device time)."""
    from jiao_liao_speech_recognition_torch.utils.timing import queued_ms as timed

    return timed(fn, iters)


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device milliseconds per call (CUDA events), after a warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --- phases -----------------------------------------------------------------

# phase 20: the flagship's rows (B x T'), the decoder's depth and the
# teacher-forced positions of its decode steps
TP_FLAG_B, TP_FLAG_T = 8, 750
TP_DECODE_LAYERS = 2
TP_DECODE_STEPS = 8
TP_TIMED_ITERS = 10
# phase 21: split Whisper serving at large-v3 width, encoder and decoder cut
# to TPS_LAYERS blocks; 16 lanes (int8 self caches, as the JAX engine keeps
# them at 16), TPS_MAX_LEN tokens a lane, TPS_STEPS a dispatch; the beam
# over TPS_BEAM = (utterances, beams) and timestamps of TPS_TIMED requests
TPS_LAYERS = 2
TPS_SLOTS, TPS_MAX_LEN, TPS_STEPS = 16, 16, 8
TPS_BEAM = (2, 4)
TPS_TIMED = 2
TPS_TIMED_ITERS = 10
TPS_ROWS = (1, 16, 64)  # K10's decode-step row counts: a lane, the pool, the beam's 16 x 4
# split timestamps against one card's: the same tokens, each span's start
# and end within one encoder frame (20 ms). The split sums the row layers'
# partials in another order, so the cross-attention matrix differs in its
# low bits, and the DTW moves a boundary between near-tied frames: on an
# H100 at 24 tokens a lane, 4 of 40 spans moved by one frame at tp 2 and at
# tp 4 (at 16 tokens all 24 read equal)
TPS_SPAN_BAR_FRAMES = 1
# the split beam against one card's decoder: each hypothesis's score within
# TPS_BEAM_REL_BAR (relative) of one card's steps fed the same tokens, and
# the split's best hypothesis, scored by one card, within the bar of one
# card's own best. Its tokens may differ from one card's where two
# continuations tie in the low bits (a tie broken another way at V 51,866:
# on an H100 at 24 tokens a lane the split beams' tokens differed from one
# card's at tp 2 and at tp 4; at 16 they read equal). Sound split beams
# read 1.4e-4 to 3.1e-4 there. The bar's upper reading is taken in every
# run: the same split beam with a fault put in by this script (the self
# caches not gathered along the winning beams; the last rank's share left
# out of every all-reduce), which must read above the bar
TPS_BEAM_REL_BAR = 1e-3


def phase_device():
    import torch

    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(line, flush=True)
    name, limit = (s.strip() for s in line.split(",", 1))
    emit({"phase": "device", "name": name, "power_limit": limit,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})
    return line


# kernels that must build without spills (ptxas's report): K2's attention
# core at both head widths, every instance of csrc/ln_gemm.cu's persistent
# GEMM (K5's and K2's q/k/v product, K3's fc1 with each GELU and fc2,
# K2h-out, K2's out-projection), K1, K4's two launches and P2, P4, K9 and
# K11
NO_SPILL = ("attention_core_kernelILi64", "attention_core_kernelILi128",
            "gemm_kernelILi0ELi0E", "gemm_kernelILi1ELi0E", "gemm_kernelILi2ELi0E",
            "gemm_kernelILi3ELi0E", "gemm_kernelILi3ELi1E", "gemm_kernelILi4ELi2E",
            "gemm_kernelILi5ELi3E",  # the row-parallel partial
            "log_mel_tf32_kernelILi0E", "log_mel_tf32_kernelILi1E",  # K1, P1
            "head_tile_argmax_kernel", "head_merge_kernel", "head_chunk_carry_kernel",
            # P4's four launches (the GEMM as <epilogue, erf form>)
            "ln_quant_kernelILi4E", "ln_quant_kernelILi8E", "ln_quant_kernelILi16E",
            "w8a8_tile_kernelILi0ELi0E", "w8a8_tile_kernelILi0ELi1E",
            "w8a8_tile_kernelILi1ELi0E", "w8a8_tile_kernelILi1ELi1E",
            "w8a8_tile_kernelILi2ELi0E",
            # every K9 instance (int8 "a" and bf16 caches, dh, query rows)
            # and K11's TMA kernel at each count of x's n8 tiles
            *(f"decode_attention_kernel{t}Li{dh}ELi{tq}E" for t in ("Ia", "I13__nv_bfloat16")
              for dh in (64, 128) for tq in (1, 2, 4, 8)),
            *(f"int8_tied_logits_tma_kernelILi{nt}E" for nt in (1, 2, 4, 8)))


def phase_build():
    from jiao_liao_speech_recognition_torch import _build

    so, seconds = _build.build()
    _build._library()  # load and bind every exported function
    report = _build.ptxas_report()
    spills = {name: {"registers": regs, "spill_store_bytes": st, "spill_load_bytes": ld}
              for name, (regs, st, ld) in report.items()
              if st or ld or any(k in name for k in NO_SPILL)}
    emit({"phase": "build", "library": so.name, "seconds": seconds, "ptxas": spills})
    for key in NO_SPILL:
        found = [v for name, v in spills.items() if key in name]
        check(len(found) == 1 and found[0]["spill_store_bytes"] == 0
              and found[0]["spill_load_bytes"] == 0, f"{key}: ptxas reports spills or no entry")
    # the int8 K9 instances and K11's TMA kernel convert bytes by a permute
    # into 2^23 (csrc/common.cuh), not I2F: their only I2F is the
    # reciprocal step of an integer division
    profiler = _example("torch_profile_decode_kernels")
    i2f = profiler.sass_i2f()
    converted = profiler.byte_conversions(i2f)
    emit({"phase": "build", "sass_i2f": i2f, "byte_conversions": converted})
    check(len(converted) == 12 and not any(converted.values()),
          f"int8 K9 / K11 instances convert bytes by I2F: {converted}")


def k1_rows(rng):
    """Four 30 s rows of tone + noise, quieter in two (deeper spectral
    valleys), f32 [4, 480000], drawn from ``rng``."""
    t = np.arange(30 * SAMPLE_RATE) / SAMPLE_RATE
    return np.stack([
        a * np.sin(2 * np.pi * f * t) + n * rng.randn(len(t))
        for a, f, n in ((0.3, 440.0, 0.05), (0.1, 1200.0, 0.01), (0.0, 1.0, 0.1),
                        (0.02, 300.0, 0.0005))
    ]).astype(np.float32)


def log_mel_f64(wav, fe):
    """K1's function in float64 on the card (the DFT, power and mel product
    in f64, the result as f32): the yardstick that tells K1's own error
    from its plain version's (both f32)."""
    import torch
    import torch.nn.functional as F

    from jiao_liao_speech_recognition_torch.frontend import features

    pad = fe.n_fft // 2
    x = F.pad(wav.double()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, fe.n_fft, fe.hop_length)[:, :-1]
    basis = torch.from_numpy(features._dft_basis(fe.n_fft)).to(wav.device).double()
    mel = torch.from_numpy(features.mel_filterbank(fe.num_mels, fe.n_fft, scale=fe.mel_scale))
    y = frames @ basis.T
    n = fe.n_fft // 2 + 1
    spec = (y[..., :n] ** 2 + y[..., n:] ** 2) @ mel.to(wav.device).double().T
    return torch.log10(torch.clamp(spec, min=fe.log_floor)).transpose(1, 2).float()


def _attn_args(rng, B, T, d, lens, dev):
    import torch

    def w(*shape, s=0.05):
        return torch.from_numpy((rng.randn(*shape) * s).astype(np.float32)).to(dev)

    x = torch.from_numpy(rng.randn(B, T, d).astype(np.float32)).to(dev, torch.bfloat16)
    g = 1.0 + w(d, s=0.1)
    bl = w(d, s=0.1)
    return (x, g, bl, w(d, d), w(d), w(d, d), w(d, d), w(d), w(d, d), w(d),
            torch.tensor(lens, dtype=torch.int32, device=dev))


# K4 and P2: exact duplicate columns under a dominant bias tie on every
# frame: inside a 128-column tile, across a tile boundary, across P2's
# 512-column chunk boundary, far apart, inside the ragged last tile of V 4336
HEAD_TIES = ((130, 250), (127, 128), (511, 512), (7, 4000), (4330, 4335))


def head_ids_check(fn, key, x, w, b, **info):
    """fn's ids against the plain argmax on every frame whose plain top-2
    margin clears ARGMAX_MARGIN (at least MIN_COVERAGE of them) -> the
    largest id difference there (0) and the ids."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import fused_head

    got = fn(x, w, b)
    logits = fused_head.head_logits(x, w, b)
    want = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    clear = margins(logits) > ARGMAX_MARGIN
    coverage = float(clear.float().mean())
    mismatch = int(((got != want) & clear).sum())
    emit({"phase": "kernels", "kernel": key, **info, "coverage": coverage,
          "mismatched_frames": mismatch, "margin": ARGMAX_MARGIN,
          "agree_all_frames": float((got == want).float().mean())})
    check(coverage >= MIN_COVERAGE and mismatch == 0,
          f"{key} {info}: ids disagree with the plain argmax")
    return float((got - want).abs()[clear].max()), got


def head_ties_check(fn, key, x, w, b):
    """every frame ties between two equal columns: fn must answer the first"""
    for first, second in HEAD_TIES:
        wt, bt = w.clone(), b.clone()
        wt[:, second] = wt[:, first]
        bt[first] = bt[second] = 100.0
        ids = fn(x, wt, bt)
        check(bool((ids == first).all()), f"{key} tie {first}/{second}: not the first index")
    emit({"phase": "kernels", "kernel": key, "ties": [list(t) for t in HEAD_TIES],
          "first_index_wins": True})


def check_head():
    """K4 at the timed B=32, T'=750, d 512, V 4336 from an f32 kernel and
    from its padded bf16 serving copy (two launches bitwise equal, timed
    against the plain version), the forced ties, a ragged row count, d 256
    and 1024, and V below a tile (with a 64-column half of the tile wholly
    past V) -> the largest id difference on the frames compared."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import fused_head

    randn = _card_randn(3)
    B, T, d, V = 32, 750, 512, 4336
    x = randn(B, T, d).to(torch.bfloat16)
    w, b = randn(d, V, s=d ** -0.5), randn(V, s=0.1)
    err, got = head_ids_check(fused_head.fused_head_argmax, "K4", x, w, b, B=B, T=T, d=d, V=V)
    w16 = fused_head.serving_kernel(w)
    again = fused_head.fused_head_argmax(x, w16, b)
    repeat = fused_head.fused_head_argmax(x, w16, b)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "kernel": "K4", "B": B, "T": T, "d": d, "V": V,
          "serving_copy_equal": bool(torch.equal(got, again)),
          "bitwise_repeat": bool(torch.equal(again, repeat)),
          "ms": cuda_ms(lambda: fused_head.fused_head_argmax(x, w16, b), 20),
          "plain_ms": cuda_ms(lambda: fused_head.head_argmax_plain(x, w16, b), 5)})
    check(torch.equal(got, again), "K4: the serving copy gives other ids than the f32 kernel")
    check(torch.equal(again, repeat), "K4: two launches differ")
    head_ties_check(fused_head.fused_head_argmax, "K4", x[:4], w, b)
    for Bk, Tk, dk, Vk in ((3, 37, 512, V), (4, 750, 256, V), (4, 750, 1024, V),
                           (4, 750, 512, 100), (4, 750, 512, 40)):
        xk = randn(Bk, Tk, dk).to(torch.bfloat16)
        wk, bk = randn(dk, Vk, s=dk ** -0.5), randn(Vk, s=0.1)
        e, _ = head_ids_check(fused_head.fused_head_argmax, "K4", xk, wk, bk,
                              B=Bk, T=Tk, d=dk, V=Vk)
        err = max(err, e)
    return err


def phase_kernels():
    """Each kernel against its plain version at main-path shapes."""
    import torch

    from jiao_liao_speech_recognition_torch.frontend import features, fused_frontend
    from jiao_liao_speech_recognition_torch.ops import fused_attention, fused_mlp
    from jiao_liao_speech_recognition_torch.utils.config import FrontendConfig

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    errs = {}
    B, T, d = 4, 750, 512
    lens = [750, 600, 313, 1]

    # K1: the four rows of k1_rows at 80 and 128 mels; then the timed B=32 x
    # 30 s of noise
    wav = k1_rows(rng)
    noise = (0.1 * rng.randn(32, 30 * SAMPLE_RATE)).astype(np.float32)
    for rows, mels in ((wav, 80), (wav, 128), (noise, 80)):
        fe = FrontendConfig(num_mels=mels)
        wav_d = torch.from_numpy(rows).to(dev)
        raw = fused_frontend.fused_log_mel_raw(wav_d, fe.n_fft, fe.hop_length, mels)
        got = features.normalize_log_mel(raw, fe)
        want = features.normalize_log_mel(
            fused_frontend.log_mel_raw_plain(wav_d, fe.n_fft, fe.hop_length, mels), fe)
        exact = features.normalize_log_mel(log_mel_f64(wav_d, fe), fe)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        emit({"phase": "kernels", "kernel": "K1", "shape": list(rows.shape), "mels": mels,
              "max_abs_err": err, "bar": LOGMEL_BAR,
              "kernel_vs_f64": float((got - exact).abs().max()),
              "plain_vs_f64": float((want - exact).abs().max())})
        check(bool(torch.isfinite(raw).all()), f"K1 {list(rows.shape)}: not finite")
        check(err <= LOGMEL_BAR, f"K1 {list(rows.shape)} x {mels} mels: log-mel error {err}")
        errs["K1"] = max(errs.get("K1", 0.0), err)

    # K2 at both head widths: ragged lengths including 0 and 1, then the
    # timed B=32 shape; two launches bitwise equal
    for heads in (4, 8):
        for lens_k2 in (lens + [0], [T] * 32):
            args = _attn_args(rng, len(lens_k2), T, d, lens_k2, dev)
            got = fused_attention.fused_attention_sublayer(*args, heads)
            again = fused_attention.fused_attention_sublayer(*args, heads)
            want = fused_attention.attention_sublayer_plain(*args, heads)
            torch.cuda.synchronize()
            ulps, elem_ulps, over1 = bf16_ulp_err(got, want)
            err = float((got.float() - want.float()).abs().max())
            emit({"phase": "kernels", "kernel": "K2", "heads": heads, "dh": d // heads,
                  "B": len(lens_k2), "lens": lens_k2 if len(lens_k2) < 8 else "all 750",
                  "max_abs_err": err, "ulps": ulps, "bar_ulps": ULP_BAR,
                  "elementwise_max_ulps": elem_ulps, "elementwise_share_over_1ulp": over1,
                  "bitwise_repeat": bool(torch.equal(got, again))})
            check(ulps <= ULP_BAR, f"K2 (H={heads}, B={len(lens_k2)}) off by {ulps} bf16 ulps")
            check(torch.equal(got, again), f"K2 (H={heads}, B={len(lens_k2)}): two launches differ")
            if heads == 4:
                errs["K2"] = max(errs.get("K2", 0.0), err)

    # K3's GELUs as fc1's epilogue takes them (a table of each form's bf16
    # bits and exact rules outside it, csrc/common.cuh) against gelu_tanh and
    # gelu_erf on every one of the 65,536 bf16 inputs: no bit may differ
    values = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).to(dev)
    gelu = fused_mlp.gelu_check(values.view(torch.bfloat16)).view(torch.int16)
    torch.cuda.synchronize()
    mism = {form: int((gelu[2 * i] != gelu[2 * i + 1]).sum())
            for i, form in enumerate(("tanh", "erf"))}
    emit({"phase": "kernels", "kernel": "K3 GELU", "inputs": 65536,
          "mismatches_tanh": mism["tanh"], "mismatches_erf": mism["erf"]})
    check(mism == {"tanh": 0, "erf": 0}, f"K3's GELU table differs from its forms: {mism}")

    # K3 at the widths its launches serve below 1280 (mlp 4d), both GELU
    # forms at the flagship's; two launches bitwise equal
    for dk, form in ((512, "tanh"), (512, "erf"), (256, "tanh"), (1024, "tanh")):
        x = torch.from_numpy(rng.randn(B, T, dk).astype(np.float32)).to(dev, torch.bfloat16)
        p = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            1.0 + 0.1 * rng.randn(dk), 0.1 * rng.randn(dk),
            0.05 * rng.randn(dk, 4 * dk), 0.05 * rng.randn(4 * dk),
            0.05 * rng.randn(4 * dk, dk), 0.05 * rng.randn(dk))]
        got = fused_mlp.fused_ln_mlp_residual(x, *p, 1e-5, form)
        again = fused_mlp.fused_ln_mlp_residual(x, *p, 1e-5, form)
        want = fused_mlp.ln_mlp_residual_plain(x, *p, 1e-5, form)
        torch.cuda.synchronize()
        ulps, elem_ulps, over1 = bf16_ulp_err(got, want)
        err = float((got.float() - want.float()).abs().max())
        emit({"phase": "kernels", "kernel": "K3", "d": dk, "mlp": 4 * dk, "gelu_form": form,
              "max_abs_err": err, "ulps": ulps, "bar_ulps": ULP_BAR,
              "elementwise_max_ulps": elem_ulps, "elementwise_share_over_1ulp": over1,
              "bitwise_repeat": bool(torch.equal(got, again))})
        check(ulps <= ULP_BAR, f"K3 (d={dk}, {form}) off by {ulps} bf16 ulps")
        check(torch.equal(got, again), f"K3 (d={dk}, {form}): two launches differ")
        errs["K3"] = max(errs.get("K3", 0.0), err)

    errs["K4"] = check_head()
    return errs


def _flash_inputs(rng, B, T, H, dh, lens, dev):
    import torch

    def t(s=1.0):
        return torch.from_numpy((s * rng.randn(B, T, H, dh)).astype(np.float32)).to(
            dev, torch.bfloat16)

    return t(), t(), t(), torch.tensor(lens, dtype=torch.int32, device=dev), t()


def phase_flash():
    """K6 (out, lse) and K8 (dQ, dK, dV) against their plain versions at the
    fine-tune shapes: B=16, T'=750, (8 heads of 64), (4 of 128) and (4 of
    64, the transfer's Att adapters), ragged lengths; plus one causal case.
    Each is launched twice on the same inputs and must give the same bits."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import flash_attention as fl

    dev = torch.device("cuda")
    rng = np.random.RandomState(2)
    B, T = 16, 750
    lens = [750, 600, 313, 1] * (B // 4)
    errs = {}
    for H, dh, causal in ((8, 64, False), (4, 128, False), (4, 64, False), (8, 64, True)):
        q, k, v, kl, dout = _flash_inputs(rng, B, T, H, dh, lens, dev)
        out, lse = fl.flash_forward(q, k, v, kl, causal)
        out_p, lse_p = fl.flash_forward_plain(q, k, v, kl, causal)
        dq, dk, dv = fl.flash_backward(q, k, v, kl, out, lse, dout, causal)
        grads_p = fl.flash_backward_plain(q, k, v, kl, out, lse, dout, causal)
        # a second launch of each on the same inputs: no atomics, so the
        # same bits
        again = (*fl.flash_forward(q, k, v, kl, causal),
                 *fl.flash_backward(q, k, v, kl, out, lse, dout, causal))
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip((out, lse, dq, dk, dv), again))
        ulps, elem_ulps, over1 = bf16_ulp_err(out, out_p)
        lse_err = float((lse - lse_p).abs().max())
        rel = {}
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), grads_p):
            rel[name] = float((got.float() - want).abs().max() / want.abs().max())
        pad = torch.arange(T, device=dev)[None, :] >= kl[:, None]
        pad_max = float(torch.maximum(dk.float().abs().amax((2, 3)),
                                      dv.float().abs().amax((2, 3)))[pad].max())
        emit({"phase": "kernels", "kernel": "K6/K8", "B": B, "T": T, "heads": H, "dh": dh,
              "causal": causal, "out_ulps": ulps, "out_elementwise_max_ulps": elem_ulps,
              "out_share_over_1ulp": over1, "bar_ulps": ULP_BAR, "lse_max_abs_err": lse_err,
              "lse_bar": LSE_BAR, "grad_rel_err": rel, "grad_bar": GRAD_REL_BAR,
              "padded_key_grad_max": pad_max, "two_launches_bitwise_equal": bitwise})
        case = f"H={H}, dh={dh}, causal={causal}"
        check(ulps <= ULP_BAR, f"K6 out off by {ulps} ulps ({case})")
        check(lse_err <= LSE_BAR, f"K6 lse off by {lse_err} ({case})")
        check(all(r <= GRAD_REL_BAR for r in rel.values()), f"K8 grads off: {rel} ({case})")
        check(pad_max == 0.0, f"K8 padded keys got gradient {pad_max} ({case})")
        check(bitwise, f"K6/K8 differ between two launches ({case})")
        if (H, dh, causal) == (8, 64, False):
            errs["K6"] = float((out.float() - out_p.float()).abs().max())
            errs["K8"] = max(float((g.float() - w).abs().max()) for g, w in
                             zip((dq, dk, dv), grads_p))
    return errs


def ctc_inputs(seed: int = 17):
    """CTC_SHAPE's log-probs (a log-softmax of noise), labels with repeats,
    logit lengths spread over 1..T' and label lengths that leave some rows
    infeasible, all on the card."""
    import torch

    B, T, V, S = CTC_SHAPE
    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(torch.randn(B, T, V, generator=g), -1)
    labels = torch.randint(1, V, (B, S), generator=g, dtype=torch.int32)
    labels[:, 1::7] = labels[:, 0::7][:, :labels[:, 1::7].shape[1]]  # repeated pairs
    tl = torch.linspace(1, T, B).round().to(torch.int32)
    ll = torch.randint(0, S + 1, (B,), generator=g, dtype=torch.int32)
    ll[0], ll[1] = 0, S  # an empty label; a full one on few frames (infeasible)
    return [t.cuda() for t in (lp, tl, labels, ll)]


def phase_ctc_loss():
    """Phase 3b: jl_ctc_loss (csrc/ctc_loss.cu) against its plain version
    at CTC_SHAPE, forward and backward, each launched twice and bitwise
    equal; each alone timed beside its bound, its plain version and the
    library's CTC (aten._ctc_loss and _ctc_loss_backward, the calls under
    F.ctc_loss, which read the lengths on the host). -> (errors, rows)."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import ctc_loss as C

    B, T, V, S = CTC_SHAPE
    lp, tl, labels, ll = ctc_inputs()
    gout = torch.rand(B, generator=torch.Generator().manual_seed(18)).cuda()
    runs = []
    for _ in range(2):
        nll, alpha, lik = C.ctc_forward(lp, tl, labels, ll)
        grad = C.ctc_backward(lp, tl, labels, ll, alpha, lik, gout)
        runs.append((nll, grad))
    nll_p, alpha_p, lik_p = C.ctc_forward_plain(lp, tl, labels, ll)
    grad_p = C.ctc_backward_plain(lp, tl, labels, ll, alpha_p, lik_p, gout)
    torch.cuda.synchronize()
    (nll, grad), (nll2, grad2) = runs
    feasible = nll_p < C.INFEASIBLE_NLL
    nll_rel = float(((nll - nll_p).abs() / nll_p.abs().clamp_min(1e-30))[feasible].max())
    grad_err = float((grad - grad_p).abs().max() / grad_p.abs().max())
    bitwise = bool(torch.equal(nll, nll2) and torch.equal(grad, grad2))
    infeasible_same = bool(torch.equal(nll[~feasible], nll_p[~feasible]))
    zero_rows = bool((grad[~feasible] == 0).all())

    # the bound: the emissions each row's frames and states need (read once),
    # the NLL written; the backward also writes the dense gradient
    tlen, llen = tl.long().clamp(1, T), ll.long().clamp(0, S)
    need = float((tlen * (2 * llen + 1)).sum()) * 4
    fwd_bound, fwd_by = bound(need + 4 * B, {"f32": 12.0 * float((tlen * (2 * llen + 1)).sum())})
    bwd_bound, bwd_by = bound(need + 4.0 * B * T * V, {"f32": 14.0 * float(
        (tlen * (2 * llen + 1)).sum())})
    alpha_t = alpha.clone()
    ms_f = cuda_ms(lambda: C.ctc_forward(lp, tl, labels, ll), CTC_TIMED_ITERS)
    ms_b = cuda_ms(lambda: C.ctc_backward(lp, tl, labels, ll, alpha_t, lik, gout),
                   CTC_TIMED_ITERS)
    plain_f = cuda_ms(lambda: C.ctc_forward_plain(lp, tl, labels, ll), 2)
    plain_b = cuda_ms(lambda: C.ctc_backward_plain(lp, tl, labels, ll, alpha_p, lik_p, gout), 2)
    lpt, tgt = lp.transpose(0, 1), labels.long()
    il, tgl = tl.tolist(), ll.tolist()
    lib_nll, lib_alpha = torch.ops.aten._ctc_loss(lpt, tgt, il, tgl, 0, True)
    lib_f = cuda_ms(lambda: torch.ops.aten._ctc_loss(lpt, tgt, il, tgl, 0, True),
                    CTC_TIMED_ITERS)
    lib_b = cuda_ms(lambda: torch.ops.aten._ctc_loss_backward(
        gout, lpt, tgt, il, tgl, lib_nll, lib_alpha, 0, True), CTC_TIMED_ITERS)
    rows = {"CTC": {"ms": ms_f, "plain_ms": plain_f, "bound_ms": fwd_bound, "bound_by": fwd_by,
                    "library_ms": lib_f, "shape": list(CTC_SHAPE)},
            "CTC-bwd": {"ms": ms_b, "plain_ms": plain_b, "bound_ms": bwd_bound,
                        "bound_by": bwd_by, "library_ms": lib_b, "shape": list(CTC_SHAPE),
                        "launches_a_call": 2}}
    emit({"phase": "ctc_loss", "shape_B_T_V_S": list(CTC_SHAPE), "nll_rel_err": nll_rel,
          "nll_bar": CTC_NLL_REL_BAR, "grad_err_of_max": grad_err, "grad_bar": CTC_GRAD_BAR,
          "infeasible_rows": int((~feasible).sum()), "infeasible_1e30": infeasible_same,
          "infeasible_grad_zero": zero_rows, "bitwise_twice": bitwise,
          "library": "aten._ctc_loss / aten._ctc_loss_backward (F.ctc_loss's calls)", **{
              f"{k}_{f}": v[f] for k, v in rows.items() for f in ("ms", "plain_ms", "bound_ms",
                                                                   "library_ms")}})
    check(nll_rel <= CTC_NLL_REL_BAR and grad_err <= CTC_GRAD_BAR,
          f"jl_ctc_loss off its plain version: nll {nll_rel}, grad {grad_err}")
    check(bitwise and infeasible_same and zero_rows and 0 < int((~feasible).sum()) < B,
          "jl_ctc_loss: two launches differ, or an infeasible row is not 1e30 with zero gradient")
    return {"CTC": nll_rel, "CTC-bwd": grad_err}, rows


def phase_wf():
    """K7: both WF-folded sublayers against their plain versions at B=4,
    T'=750, d=512 (8 heads of 64, mlp 2048), with nonzero inserts."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import fused_attention, fused_mlp

    dev = torch.device("cuda")
    rng = np.random.RandomState(3)
    B, T, d, r, H = 4, 750, 512, 8, 8

    def w(*shape, s=0.05):
        return torch.from_numpy((s * rng.randn(*shape)).astype(np.float32)).to(dev)

    def insert(d_in, d_out):
        return {"a": w(d_in, r, s=0.1), "g": 1.0 + w(r, s=0.1), "b": w(r, d_out, s=0.1)}

    x, g, bl, wq, bq, wk, wv, bv, wo, bo, kl = _attn_args(rng, B, T, d, [750, 600, 313, 1], dev)
    base = {"wq": wq, "bq": bq, "wk": wk, "wv": wv, "bv": bv, "wo": wo, "bo": bo}
    wf = {n: insert(d, d) for n in "qkvo"}
    errs = {}
    got = fused_attention.fused_attention_sublayer_wf(x, g, bl, base, wf, H, 1e-5, 1.0, kl)
    want = fused_attention.attention_sublayer_wf_plain(x, g, bl, base, wf, H, 1e-5, 1.0, kl)
    mlp_args = (x, 1.0 + w(d, s=0.1), w(d, s=0.1), w(d, 4 * d), w(4 * d), w(4 * d, d), w(d),
                insert(d, 4 * d), insert(4 * d, d), 1e-5, "tanh", 1.0)
    got_m = fused_mlp.fused_ln_mlp_residual_wf(*mlp_args)
    want_m = fused_mlp.ln_mlp_residual_wf_plain(*mlp_args)
    torch.cuda.synchronize()
    for key, a, b in (("K7-attn", got, want), ("K7-mlp", got_m, want_m)):
        ulps, elem_ulps, over1 = bf16_ulp_err(a, b)
        errs[key] = float((a.float() - b.float()).abs().max())
        emit({"phase": "kernels", "kernel": key, "max_abs_err": errs[key], "ulps": ulps,
              "bar_ulps": ULP_BAR, "elementwise_max_ulps": elem_ulps,
              "elementwise_share_over_1ulp": over1})
        check(ulps <= ULP_BAR, f"{key} off by {ulps} bf16 ulps")
    return errs


def make_requests(seed: int = 0):
    """Six requests of 0.5, 3, 7.5, 12, 30 and 42 s: tones and noise."""
    rng = np.random.RandomState(seed)
    out = []
    for secs in (0.5, 3.0, 7.5, 12.0, 30.0, 42.0):
        t = np.arange(int(secs * SAMPLE_RATE)) / SAMPLE_RATE
        f = rng.uniform(150.0, 2000.0)
        out.append((0.2 * np.sin(2 * np.pi * f * t) * np.sin(2 * np.pi * 0.5 * t)
                    + 0.05 * rng.randn(len(t))).astype(np.float32))
    return out


def drive(counters, path, fn):
    """Run one main path with every launch count at 0 -> (fn's result,
    launches by kernel key); every kernel of the path must have launched.
    A path's launches are the counted ones plus those of the offline decode
    loops' graph replays (utils/graphs.TALLY: a captured chunk's launches,
    counted once at capture and taken back off the counters, times its
    replays)."""
    import torch

    from jiao_liao_speech_recognition_torch.utils import graphs

    for c in counters.values():
        c.reset()
    graphs.TALLY.reset()
    result = fn()
    torch.cuda.synchronize()
    launches = {key: c.launches + graphs.TALLY.launches.get(c.name, 0)
                for key, c in counters.items()}
    missing = [key for key in PATHS[path] if launches[key] == 0]
    check(not missing, f"{path}: kernels never launched: {missing} ({launches})")
    return result, launches


def serve_vs_plain(bundle, requests):
    """The requests' chunks through the kernel path (argmax ids) and the
    plain path (log-probs) on the card: log-mel within LOGMEL_BAR, ids equal
    on every frame whose plain top-2 margin exceeds ARGMAX_MARGIN."""
    import torch

    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch

    fe, m = bundle.config.frontend, bundle.config.ctc_model
    wavs, alens, _ = bundle._prepare_audio_chunked(requests, None)
    with torch.inference_mode():
        wav = torch.from_numpy(wavs).cuda()
        flens = torch.from_numpy(alens // fe.hop_length).cuda()
        feats_k = featurize_batch(wav, fe, kernels=True)
        feats_p = featurize_batch(wav, fe, kernels=False)
        ids_k, olens = bundle.model(feats_k, flens, head_mode="argmax_ids", kernels=True)
        log_probs, _ = bundle.model(feats_p, flens, head_mode="log_probs", kernels=False)
        torch.cuda.synchronize()
    logmel_err = float((feats_k - feats_p).abs().max())
    frames = torch.arange(ids_k.shape[1], device="cuda")[None, :] < olens[:, None]
    ids_p = log_probs.argmax(-1).to(torch.int32)
    clear = frames & (margins(log_probs) > ARGMAX_MARGIN)
    coverage = float(clear.sum() / frames.sum())
    mismatch = int(((ids_k != ids_p) & clear).sum())
    agree = float(((ids_k == ids_p) & frames).sum() / frames.sum())
    finite = bool(torch.isfinite(log_probs).all())
    out = {"chunks": int(wavs.shape[0]), "logmel_max_abs_err": logmel_err,
           "logmel_bar": LOGMEL_BAR, "frames": int(frames.sum()), "coverage": coverage,
           "margin": ARGMAX_MARGIN, "mismatched_frames": mismatch, "agree_all_frames": agree}
    check(finite and tuple(log_probs.shape) == (wavs.shape[0], 750, m.vocab_size),
          "plain log-probs are not finite [chunks, 750, V]")
    check(logmel_err <= LOGMEL_BAR, f"log-mel error {logmel_err}")
    check(coverage >= MIN_COVERAGE and mismatch == 0, "ids disagree with the plain path")
    return out


def check_texts(requests, texts, timed):
    check(len(texts) == len(requests) and all(isinstance(s, str) for s in texts),
          "one transcript per request")
    check(sum(len(s) for s in texts) > 0, "the model emitted no text at all")
    joined = ["".join(tok["token"] for tok in utt) for utt in timed]
    check(joined == texts, "timestamped tokens do not concatenate to the greedy text")
    check(all(tok["end"] <= len(r) / SAMPLE_RATE + 0.04 for utt, r in zip(timed, requests)
              for tok in utt), "a timestamp runs past its audio")


def phase_e2e(counters):
    from jiao_liao_speech_recognition_torch import api
    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig()
    bundle = api.load(config=cfg, device="cuda")
    m = cfg.ctc_model
    n_params = sum(p.numel() for p in bundle.model.parameters())
    # one character per non-special id, so every id decodes to text
    bundle.tokenizer = CharTokenizer([chr(0x4E00 + i) for i in range(m.vocab_size - 2)])
    requests = make_requests()

    t0 = time.perf_counter()
    (texts, timed), launches = drive(counters, "serve", lambda: (
        api.transcribe(bundle, requests), api.transcribe(bundle, requests, timestamps=True)))
    seconds = time.perf_counter() - t0
    emit({"phase": "e2e", "params": n_params, "layers": m.num_layers, "d_model": m.d_model,
          "heads": m.num_heads, "mlp": m.mlp_dim, "vocab": m.vocab_size,
          "requests_s": [len(r) / SAMPLE_RATE for r in requests],
          "text_chars": [len(s) for s in texts], "seconds_both_calls": seconds,
          "launches": launches})
    check_texts(requests, texts, timed)
    emit({"phase": "e2e", "vs_plain": serve_vs_plain(bundle, requests)})
    return launches, bundle


def write_corpus(d: Path, n: int = 16, secs: float = 30.0, chars: int = 4334, seed: int = 0):
    """n seeded WAVs (tone + noise) of `secs` and a manifest whose
    transcripts together use exactly `chars` distinct characters from
    U+4E00 on, so the char vocabulary has chars + 2 entries."""
    from jiao_liao_speech_recognition_torch.data.manifest import ManifestRow, write_manifest
    from jiao_liao_speech_recognition_torch.frontend.audio_io import write_wav

    rng = np.random.RandomState(seed)
    order = rng.permutation(chars)
    per = -(-chars // n)
    t = np.arange(int(secs * SAMPLE_RATE)) / SAMPLE_RATE
    rows = []
    for i in range(n):
        wav = 0.2 * np.sin(2 * np.pi * rng.uniform(150.0, 2000.0) * t) + 0.05 * rng.randn(len(t))
        path = d / f"u{i:02d}.wav"
        write_wav(path, wav, SAMPLE_RATE)
        text = "".join(chr(0x4E00 + int(j)) for j in order[i * per:(i + 1) * per])
        rows.append(ManifestRow(str(path), text, secs, "synthetic"))
    write_manifest(rows, d / "train.jsonl")
    return d / "train.jsonl"


def finetune_config(workdir: Path, manifest: Path):
    from jiao_liao_speech_recognition_torch.utils.config import load_yaml

    cfg = load_yaml(str(Path(__file__).resolve().parent / "configs" / "adapter_finetune.yaml"))
    cfg.data.train_manifest, cfg.data.eval_manifest = str(manifest), ""
    cfg.train.checkpoint_dir = str(workdir / "ckpt")
    cfg.train.metrics_path = str(workdir / "metrics.jsonl")
    return cfg


def phase_finetune(counters, workdir: Path):
    """api.fine_tune at full width: FT_STEPS steps of B=16 x 30 s; losses
    finite, K6 and K8 once per block per step, backbone bitwise frozen,
    adapters moved, the final bundle on disk."""
    import torch

    from jiao_liao_speech_recognition_torch import api
    from jiao_liao_speech_recognition_torch.models.adapters import param_is_adapter
    from jiao_liao_speech_recognition_torch.models.ctc_model import CTCEncoderModel

    manifest = write_corpus(workdir)
    cfg = finetune_config(workdir, manifest)
    t0 = time.perf_counter()
    (state, bundle), launches = drive(
        counters, "finetune", lambda: api.fine_tune(cfg, device="cuda", max_steps=FT_STEPS))
    seconds = time.perf_counter() - t0
    m = cfg.ctc_model
    losses = state.info["losses"]
    init = CTCEncoderModel(m, device="cuda", seed=cfg.train.seed).state_dict()
    frozen_same = adapters_moved = n_adapters = b_moved = n_b = 0
    for key, v in bundle.model.state_dict().items():
        same = torch.equal(v, init[key])
        if param_is_adapter(key):
            n_adapters += 1
            adapters_moved += not same
            if key.endswith(".b"):
                n_b += 1
                b_moved += not same
        else:
            frozen_same += same
    n_frozen = len(init) - n_adapters
    final = Path(cfg.train.checkpoint_dir) / "final"
    emit({"phase": "finetune", "config": "configs/adapter_finetune.yaml", "layers": m.num_layers,
          "d_model": m.d_model, "heads": m.num_heads, "vocab": m.vocab_size,
          "wf_rank": m.adapter.wf_rank, "batch": cfg.data.batch_size, "steps": state.step,
          "losses": losses, "seconds_incl_init_and_save": seconds, "launches": launches,
          "backbone_tensors_unchanged": f"{frozen_same}/{n_frozen}",
          "adapter_tensors_moved": f"{adapters_moved}/{n_adapters}",
          "adapter_b_tensors_moved": f"{b_moved}/{n_b}"})
    check(state.step == FT_STEPS and len(losses) == FT_STEPS, f"{state.step} steps taken")
    check(all(math.isfinite(x) for x in losses), f"a loss is not finite: {losses}")
    check(m.vocab_size == 4336, f"char vocab {m.vocab_size} != 4336")
    for key in ("K6", "K8"):
        check(launches[key] == m.num_layers * FT_STEPS,
              f"{key} launched {launches[key]} times, not {m.num_layers} x {FT_STEPS}")
    check(frozen_same == n_frozen, "the frozen backbone moved")
    check(n_b > 0 and b_moved == n_b, "an adapter B insert did not move")
    check(all((final / f).exists() for f in ("params.npz", "config.yaml", "vocab.json")),
          "the final bundle is incomplete")

    # the captured step against graph=False from one state, in this bucket
    # and across two bucket shapes
    from jiao_liao_speech_recognition_torch.data.manifest import read_manifest, write_manifest
    from jiao_liao_speech_recognition_torch.train import engine

    rows = read_manifest(manifest)
    routes_held("finetune", cfg, rows, engine.build_tokenizer_for(cfg, rows), workdir)
    parts = [read_manifest(write_corpus(workdir / f"b{int(sec)}", n=BUCKET_B, secs=sec,
                                        seed=61 + i)).rows
             for i, sec in enumerate(BUCKET_SECONDS)]
    (workdir / "buckets").mkdir()
    write_manifest(parts[0] + parts[1], workdir / "buckets" / "train.jsonl")
    two = finetune_config(workdir / "buckets", workdir / "buckets" / "train.jsonl")
    two.data.batch_size = BUCKET_B
    rows2 = read_manifest(two.data.train_manifest)
    routes_held("finetune_buckets", two, rows2, engine.build_tokenizer_for(two, rows2),
                workdir / "buckets", steps=BUCKET_STEPS, graphs=len(BUCKET_SECONDS))
    return launches, cfg, final, losses


def phase_finetune_vs_plain(cfg):
    """One step at the fine-tune's shapes, the backbone frozen (WF inserts)."""
    from jiao_liao_speech_recognition_torch.data.manifest import read_manifest
    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer

    manifest = read_manifest(cfg.data.train_manifest)
    step_vs_plain("finetune", cfg, manifest, CharTokenizer.build(manifest.texts()),
                  adapters_only=True)


def model_config(cfg):
    """The family's model section of an ExperimentConfig (ctc or joint)."""
    return cfg.joint if cfg.model_family == "joint" else cfg.ctc_model


def step_vs_plain(phase: str, cfg, manifest, tok, adapters_only: bool):
    """One train step on the first batch of `manifest` with dropout and
    SpecAugment off and every adapter tensor perturbed (WF's B and the Att
    adapters' out_proj start at zero): the losses (the joint family's
    loss, loss_ctc and loss_att) and the gradients of the trainable set
    (the adapters, or every parameter) on the kernel path (K1, K6, K8)
    against the plain path, and both against the same step in float32
    (plain, einsum attention)."""
    import copy

    import torch

    from jiao_liao_speech_recognition_torch.data.pipeline import BatchIterator
    from jiao_liao_speech_recognition_torch.models.adapters import param_is_adapter
    from jiao_liao_speech_recognition_torch.train import engine

    cfg = copy.deepcopy(cfg)
    mc = model_config(cfg)
    mc.dropout = mc.adapter.dropout = 0.0
    cfg.specaugment.enabled = False
    batch = engine.batch_to_device(next(BatchIterator(manifest, tok, cfg.data)), "cuda",
                                   family=cfg.model_family)
    model = engine.make_model(cfg, "cuda")
    params = engine.set_trainable(model, adapters_only)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for n, p in model.named_parameters():  # every adapter gradient nonzero
            if param_is_adapter(n):
                p.add_(0.02 * torch.randn(p.shape, generator=gen).to(p.device))
    loss_fn = engine.make_loss_fn(cfg, model)
    cfg32 = copy.deepcopy(cfg)
    model_config(cfg32).dtype = "float32"
    model32 = copy.deepcopy(model)
    model32.cfg = model_config(cfg32)
    params32 = [p for p in model32.parameters() if p.requires_grad]
    loss_fn32 = engine.make_loss_fn(cfg32, model32)

    runs, terms = {}, {}
    for run, fn, ps, kernels in (("kernels", loss_fn, params, True),
                                 ("plain", loss_fn, params, False),
                                 ("f32", loss_fn32, params32, False)):
        loss, metrics = fn(batch, (0, 0), True, kernels)
        runs[run] = (float(loss.detach()), torch.autograd.grad(loss, ps))
        terms[run] = {k: float(metrics[k]) for k in ("loss_ctc", "loss_att") if k in metrics}
    (lk, gk), (lp, gp), (l32, g32) = runs["kernels"], runs["plain"], runs["f32"]
    del model32, params32, runs
    terms_rel = {k: abs(v - terms["plain"][k]) / abs(terms["plain"][k])
                 for k, v in terms["kernels"].items()}

    def rel(a, b):
        return float(torch.linalg.vector_norm(a.float() - b.float())
                     / torch.linalg.vector_norm(b.float()))

    loss_rel = abs(lk - lp) / abs(lp)
    grad_rel = [rel(a, b) for a, b in zip(gk, gp)]
    plain_f32 = [rel(a, b) for a, b in zip(gp, g32)]
    kern_f32 = [rel(a, b) for a, b in zip(gk, g32)]
    whole = rel(torch.cat([g.flatten() for g in gk]), torch.cat([g.flatten() for g in gp]))
    over = [(r, n, pf) for r, n, pf in zip(grad_rel, names, plain_f32) if r > pf + FT_GRAD_BAR]
    what = "adapter" if adapters_only else "all"
    emit({"phase": phase, "vs_plain": {
        "T_frames": int(batch["audio"].shape[1] // cfg.frontend.hop_length // 4),
        "trainable": what, "loss_kernels": lk, "loss_plain": lp, "loss_f32": l32,
        "loss_rel_err": loss_rel, "loss_bar": FT_LOSS_BAR, "tensors": len(grad_rel),
        "grad_rel_l2_all": whole,
        "grad_rel_l2_median": statistics.median(grad_rel), "grad_rel_l2_max": max(grad_rel),
        "grad_bar": FT_GRAD_BAR,
        "plain_vs_f32_median": statistics.median(plain_f32), "plain_vs_f32_max": max(plain_f32),
        "kernels_vs_f32_median": statistics.median(kern_f32), "kernels_vs_f32_max": max(kern_f32),
        "worst": sorted(zip(grad_rel, names, plain_f32), reverse=True)[:4],
        "tensors_over_bar": len(over), "loss_terms": terms, "loss_terms_rel_err": terms_rel}})
    check(math.isfinite(lk) and loss_rel <= FT_LOSS_BAR, f"loss {lk} vs plain {lp}")
    check(all(r <= FT_LOSS_BAR for r in terms_rel.values()), f"loss terms off: {terms_rel}")
    check(whole <= FT_GRAD_BAR and statistics.median(grad_rel) <= FT_GRAD_BAR,
          f"{what} gradients off by {whole} (all) / {statistics.median(grad_rel)} (median)")
    check(not over, f"{what} gradients off by more than the bf16 error + bar: {over[:3]}")


def phase_adapted(counters, final: Path):
    """The fine-tuned checkpoint served: K7 in every block."""
    from jiao_liao_speech_recognition_torch import api

    bundle = api.load(str(final), device="cuda")
    check(bundle.config.ctc_model.adapter.kind == "wf", "the checkpoint lost its adapter config")
    requests = make_requests()
    (texts, timed), launches = drive(counters, "adapted_serve", lambda: (
        api.transcribe(bundle, requests), api.transcribe(bundle, requests, timestamps=True)))
    emit({"phase": "adapted", "checkpoint": "fine-tune final", "heads":
          bundle.config.ctc_model.num_heads, "text_chars": [len(s) for s in texts],
          "launches": launches})
    check_texts(requests, texts, timed)
    emit({"phase": "adapted", "vs_plain": serve_vs_plain(bundle, requests)})
    return launches, bundle


def greedy_rtfx(bundle, rng, B: int = 32):
    """Seconds per batch of B x 30 s of noise from `rng` through the kernel
    path and the plain path, turns: plain, kernels, kernels, plain; two
    distinct buffers, each warmed on both paths; a host sync after every
    batch. -> (record, the buffers, infer(wav, kernels))."""
    import torch

    from jiao_liao_speech_recognition_torch.decode.ctc import ctc_greedy_collapse
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch

    fe = bundle.config.frontend
    L = 30 * SAMPLE_RATE
    bufs = [torch.from_numpy((0.1 * rng.randn(B, L)).astype(np.float32)).cuda() for _ in range(2)]
    flens = torch.full((B,), L // fe.hop_length, dtype=torch.int32, device="cuda")

    @torch.inference_mode()
    def infer(wav, kernels):
        feats = featurize_batch(wav, fe, kernels=kernels)
        ids, olens = bundle.model(feats, flens, head_mode="argmax_ids", kernels=kernels)
        return ctc_greedy_collapse(ids, olens)

    times = {True: [], False: []}
    for kernels in (False, True):
        for w in bufs:
            infer(w, kernels)
    torch.cuda.synchronize()
    for kernels in (False, True, True, False):
        for i in range(4):
            t0 = time.perf_counter()
            infer(bufs[i % 2], kernels)
            torch.cuda.synchronize()
            times[kernels].append(time.perf_counter() - t0)
    kern_s, plain_s = statistics.median(times[True]), statistics.median(times[False])
    return ({"batch": B, "seconds_audio": 30.0,
             "kernel_path_s_per_batch": kern_s, "plain_path_s_per_batch": plain_s,
             "kernel_path_rtfx": B * 30.0 / kern_s, "plain_path_rtfx": B * 30.0 / plain_s,
             "kernel_path_samples_s": times[True], "plain_path_samples_s": times[False]},
            bufs, infer)


def phase_timing(bundle, adapted):
    """32 x 30 s through both paths (turns: plain, kernels, kernels, plain),
    then each kernel alone against its plain version, its bound and, where
    one exists, the library call, at the main paths' shapes."""
    import torch

    from jiao_liao_speech_recognition_torch.frontend import fused_frontend
    from jiao_liao_speech_recognition_torch.ops import flash_attention as fl
    from jiao_liao_speech_recognition_torch.ops import fused_attention, fused_head, fused_mlp

    fe = bundle.config.frontend
    B, L = 32, 30 * SAMPLE_RATE
    rng = np.random.RandomState(1)
    rtfx, bufs, infer = greedy_rtfx(bundle, rng, B)
    emit({"phase": "timing", **rtfx})

    # kernels alone at the main paths' shapes: K1-K4 and K7 at B=32, T'=750
    # (block 0 of the flagship, of the fine-tuned model for K7); K6/K8 at the
    # fine-tune's B=16, T'=750, 8 heads of 64
    blk = bundle.model.blocks[0]
    sa, ln1, ln2 = blk.self_attn, blk.self_attn_ln, blk.mlp_ln
    x = torch.from_numpy(rng.randn(B, 750, 512).astype(np.float32)).cuda().to(torch.bfloat16)
    lens = torch.full((B,), 750, dtype=torch.int32, device="cuda")
    attn_args = (x, ln1.scale, ln1.bias, sa.q_proj.kernel, sa.q_proj.bias, sa.k_proj.kernel,
                 sa.v_proj.kernel, sa.v_proj.bias, sa.out_proj.kernel, sa.out_proj.bias,
                 lens, sa.num_heads)
    mlp_args = (x, ln2.scale, ln2.bias, blk.mlp.fc1.kernel, blk.mlp.fc1.bias,
                blk.mlp.fc2.kernel, blk.mlp.fc2.bias, 1e-5, blk.mlp.gelu_form)
    with torch.inference_mode():  # K2's and K3's operands at serving: the kept bf16 copies
        w_qkv, b_qkv = sa.qkv_weights(torch.bfloat16)
        wo_b, bo_b = sa.out_proj.weights(torch.bfloat16)
        mlp_w = (*blk.mlp.fc1.weights(torch.bfloat16), *blk.mlp.fc2.weights(torch.bfloat16))
    attn_served = (x, ln1.scale, ln1.bias, w_qkv, b_qkv, wo_b, bo_b, lens, sa.num_heads)
    mlp_served = (x, ln2.scale, ln2.bias, *mlp_w, 1e-5, blk.mlp.gelu_form)
    head = bundle.model.ctc_head
    with torch.no_grad():  # K4's operand at serving: the head's kept bf16 copy
        head_w = head.weight(torch.bfloat16)
    check(head_w.dtype == torch.bfloat16 and head_w.shape[1] % 8 == 0,
          "the CTC head serves no padded bf16 copy of its kernel")
    ablk = adapted.model.blocks[0]
    asa, aln1, aln2, amlp = ablk.self_attn, ablk.self_attn_ln, ablk.mlp_ln, ablk.mlp
    wf_scale = float(ablk.adapter.scale)
    base, inserts = asa.wf_params()
    wf_attn_args = (x, aln1.scale, aln1.bias, base, inserts, asa.num_heads, aln1.eps, wf_scale,
                    lens)
    k2_64_args = (x, aln1.scale, aln1.bias, base["wq"], base["bq"], base["wk"], base["wv"],
                  base["bv"], base["wo"], base["bo"], lens, asa.num_heads)
    wf_mlp_args = (x, aln2.scale, aln2.bias, amlp.fc1.kernel, amlp.fc1.bias, amlp.fc2.kernel,
                   amlp.fc2.bias, {"a": amlp.fc1.adapter_wf.a, "g": amlp.fc1.adapter_wf.g,
                                   "b": amlp.fc1.adapter_wf.b},
                   {"a": amlp.fc2.adapter_wf.a, "g": amlp.fc2.adapter_wf.g,
                    "b": amlp.fc2.adapter_wf.b}, aln2.eps, amlp.gelu_form, wf_scale)
    Bf, Tf, Hf, dhf = 16, 750, 8, 64
    q, k, v, kl, dout = _flash_inputs(rng, Bf, Tf, Hf, dhf, [Tf] * Bf, "cuda")
    with torch.inference_mode():
        out, lse = fl.flash_forward(q, k, v, kl)
    pairs = {
        "K1": (lambda: fused_frontend.fused_log_mel_raw(bufs[0]),
               lambda: fused_frontend.log_mel_raw_plain(bufs[0])),
        "K2": (lambda: fused_attention.fused_attention_sublayer_packed(*attn_served),
               lambda: fused_attention.attention_sublayer_plain(*attn_args)),
        "K3": (lambda: fused_mlp.fused_ln_mlp_residual(*mlp_served),
               lambda: fused_mlp.ln_mlp_residual_plain(*mlp_args)),
        "K4": (lambda: fused_head.fused_head_argmax(x, head_w, head.bias),
               lambda: fused_head.head_argmax_plain(x, head_w, head.bias)),
        "K6": (lambda: fl.flash_forward(q, k, v, kl),
               lambda: fl.flash_forward_plain(q, k, v, kl)),
        "K8": (lambda: fl.flash_backward(q, k, v, kl, out, lse, dout),
               lambda: fl.flash_backward_plain(q, k, v, kl, out, lse, dout)),
        # K2 on the fine-tuned model's 8 heads of 64, unfolded: K7-attn's
        # time less this is the fold's
        "K2-8x64": (lambda: fused_attention.fused_attention_sublayer(*k2_64_args),
                    lambda: fused_attention.attention_sublayer_plain(*k2_64_args)),
        "K7-attn": (lambda: fused_attention.fused_attention_sublayer_wf(*wf_attn_args),
                    lambda: fused_attention.attention_sublayer_wf_plain(*wf_attn_args)),
        "K7-mlp": (lambda: fused_mlp.fused_ln_mlp_residual_wf(*wf_mlp_args),
                   lambda: fused_mlp.ln_mlp_residual_wf_plain(*wf_mlp_args)),
    }
    yard = _yardsticks()
    lib_fwd, lib_bwd = yard.sdpa_ms(q, k, v, kl, dout)
    # K4's: two library calls (cuBLAS's bf16 logits, then their argmax),
    # timed as K4 is
    x2, b16 = x.reshape(-1, x.shape[2]), head.bias.detach().to(torch.bfloat16)
    with torch.inference_mode():
        lib_head = cuda_ms(lambda: yard.addmm_argmax(x2, head_w, b16), 20)
    library = {"K6": lib_fwd, "K8": lib_bwd, "K4": lib_head}

    # the least time for each function on these inputs (see bound())
    T, n_fft, M = 750, fe.n_fft, fe.num_mels
    frames, freqs = L // fe.hop_length, n_fft // 2 + 1
    qkv = Bf * Tf * Hf * dhf * 2
    pairs_f = float(kl.sum()) * Tf

    def fold_ops(f):  # A * g, (A g) B, + W: f32 outside any kernel
        d_in, r = f["a"].shape
        return 2.0 * d_in * r * f["b"].shape[1] + d_in * r + d_in * f["b"].shape[1]

    def insert_bytes(inserts_):
        return sum(t.numel() * 4 for f in inserts_ for t in f.values())

    work = ctc_work(bundle, B, T, L, lens)
    work.update({
        "K2-8x64": work["K2"],
        "K6": (4 * qkv + Bf * Hf * Tf * 4 + Bf * 4, {"bf16": 4.0 * Hf * dhf * pairs_f}),
        "K8": (8 * qkv + Bf * Hf * Tf * 4 + Bf * 4, {"bf16": 10.0 * Hf * dhf * pairs_f}),
        "K7-attn": (work["K2"][0] + insert_bytes(inserts.values()),
                    {**work["K2"][1], "f32": sum(fold_ops(f) for f in inserts.values())}),
        "K7-mlp": (work["K3"][0] + insert_bytes(wf_mlp_args[7:9]),
                   {**work["K3"][1], "f32": sum(fold_ops(f) for f in wf_mlp_args[7:9])}),
    })
    # context only: K1's bound on its former route (the DFT in f32 on the CUDA
    # cores), which no kernel time may read below
    k1_f32_bound = bound(work["K1"][0], {"f32": B * frames * (
        2.0 * n_fft * 2 * freqs + 3 * freqs + 2 * freqs * M)})[0]
    shapes = {"K2": "B=32, T'=750, 4 x 128", "K2-8x64": "B=32, T'=750, 8 x 64",
              "K7-attn": "B=32, T'=750, 8 x 64", "K6": "B=16, T'=750, 8 x 64",
              "K8": "B=16, T'=750, 8 x 64"}
    rec = {}
    with torch.inference_mode():
        for key, (kern, plain) in pairs.items():
            # K6 and K8 take ~0.1-0.3 ms, near the host's time to issue a
            # call: their launches (and the library's) are timed queued
            # behind a spin kernel, so the events bracket the device's work
            timer = (lambda f: queued_ms(f, 20)) if key in ("K6", "K8") else cuda_ms
            p1, k1, k2, p2 = cuda_ms(plain), timer(kern), timer(kern), cuda_ms(plain)
            bound_ms, bound_by = bound(*work[key])
            rec[key] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library.get(key)}
            rate = {}
            if "bf16" in work[key][1]:  # the tensor-core rate the bound counts
                rate["bound_counted_tflops"] = tflops(work[key][1]["bf16"], rec[key]["ms"])
            if key in ("K6", "K8"):  # and what the flash kernels execute
                kind = "fwd" if key == "K6" else "bwd"
                rate.update({"ms_events": cuda_ms(kern, 20), "executed_tflops": tflops(
                    flash_flops(kind, Bf, Tf, [Tf] * Bf, Hf, dhf), rec[key]["ms"])})
            if key == "K1":
                rate["bound_ms_f32_route"] = k1_f32_bound
            if key == "K2":
                core = core_launch(attn_args, yard)
                rate.update(core)
            if key == "K4":
                rate["library_calls"] = "torch.addmm (bf16 logits) + torch.argmax: two calls"
            emit({"phase": "timing", "kernel": key, "shape": shapes.get(key, "B=32, T'=750"),
                  **rec[key], **rate, "turns_ms": [p1, k1, k2, p2]})
    gemm = gemm_launches(blk, x, lens, len(bundle.model.blocks))
    rec["K2"]["launches_ms"] = {"q/k/v": gemm["q/k/v"]["ms"], "core": core["core_ms"],
                                "out-projection": gemm["out-projection"]["ms"]}
    rec["K3"]["launches_ms"] = {"fc1": gemm["fc1"]["ms"], "fc2": gemm["fc2"]["ms"]}
    emit({"phase": "timing", "greedy_copy_launches_per_batch": copy_launches(
        lambda: infer(bufs[0], True))})
    return rec, rtfx


def gemm_launches(blk, x, lens, blocks):
    """The four GEMM launches of a greedy batch's block (csrc/ln_gemm.cu's
    persistent GEMM, each instance alone through jl_gemm, on the block's
    serving copies) at B=32, T'=750, each beside torch.addmm with the bias
    on the same bf16 operands, both timed queued in turns (kernel, addmm,
    kernel, addmm), with its bound (bytes: each operand read once, the
    output written once; operations at the bf16 peak), its bound-counted
    TFLOP/s and its launches a batch (one a block of `blocks`). addmm
    computes the product and the bias only: fc2's and the out-projection's
    residual read, and fc1's GELU, are the kernel's alone. One line each;
    -> {launch: row}."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import fused_attention as fa
    from jiao_liao_speech_recognition_torch.ops import fused_mlp as fm

    bf = torch.bfloat16
    sa, ln1, ln2, mlp = blk.self_attn, blk.self_attn_ln, blk.mlp_ln, blk.mlp
    B, T, d = x.shape
    M = B * T
    with torch.inference_mode():
        w_qkv, b_qkv = sa.qkv_weights(bf)
        wo, bo = sa.out_proj.weights(bf)
        (w1, b1), (w2, b2) = mlp.fc1.weights(bf), mlp.fc2.weights(bf)
        a1 = fm.ln_rows_plain(x, ln1.scale, ln1.bias, ln1.eps).reshape(M, d)
        a2 = fm.ln_rows_plain(x, ln2.scale, ln2.bias, ln2.eps).reshape(M, d)
        qkv = fm.gemm_launch("qkv", a1, w_qkv, b_qkv)
        attn = fa.attention_core_launch(qkv.view(B, T, -1), lens, sa.num_heads).reshape(M, d)
        h = fm.gemm_launch("fc1_" + mlp.gelu_form, a2, w1, b1)
        x2 = x.reshape(M, d)
        launches = {"q/k/v": ("qkv", a1, w_qkv, b_qkv, None),
                    "fc1": ("fc1_" + mlp.gelu_form, a2, w1, b1, None),
                    "fc2": ("fc2", h, w2, b2, x2),
                    "out-projection": ("out_proj", attn, wo, bo, x2)}
        rows = {}
        for name, (epi, a, w, b, res) in launches.items():
            def kern(epi=epi, a=a, w=w, b=b, res=res):
                return fm.gemm_launch(epi, a, w, b, res)

            def lib(a=a, w=w, b=b):
                return torch.addmm(b, a, w)

            turns = [queued_ms(f, 20) for f in (kern, lib, kern, lib)]
            K, N = w.shape
            nbytes = (a.numel() + w.numel() + b.numel() + M * N) * 2 + (
                0 if res is None else res.numel() * 2)
            flops = 2.0 * M * N * K
            bound_ms, bound_by = bound(nbytes, {"bf16": flops})
            ms = (turns[0] + turns[2]) / 2
            rows[name] = {"ms": ms, "addmm_ms": (turns[1] + turns[3]) / 2, "bound_ms": bound_ms,
                          "bound_by": bound_by, "bound_counted_tflops": tflops(flops, ms),
                          "launches_per_batch": blocks, "turns_ms": turns}
            emit({"phase": "timing", "launch": name, "shape": f"M={M}, K={K}, N={N}",
                  **rows[name]})
    return rows


def copy_launches(call, batches: int = 2) -> float:
    """Device copy kernels a call of `call` launches (PyTorch's copy and
    cast kernels, by name, under torch.profiler): the greedy batch's weight
    casts, which the serving copies remove."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(batches):
            call()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type.name == "CUDA" and "copy" in e.key.lower()) / batches


def core_launch(attn_args, yard):
    """K2's attention core alone on the timed inputs' q/k/v (queued), with
    its executed TFLOP/s (both passes' products on padded tiles), beside
    the library's masked fused attention forward on the same q, k, v
    (queued): context, since the library rounds P before normalising it."""
    from jiao_liao_speech_recognition_torch.ops import fused_attention as fa
    from jiao_liao_speech_recognition_torch.ops import fused_mlp

    x, g, bl, wq, bq, wk, wv, bv, wo, bo, lens, H = attn_args
    B, T, D = x.shape
    w_qkv, b_qkv = fused_mlp.pack_qkv(wq, bq, wk, wv, bv)
    qkv = fused_mlp.ln_qkv_launch(x, g, bl, w_qkv, b_qkv)
    q, k, v = (qkv[..., i * D:(i + 1) * D].view(B, T, H, D // H) for i in range(3))
    turns = [queued_ms(lambda: fa.attention_core_launch(qkv, lens, H), 20) for _ in range(2)]
    core_ms = sum(turns) / 2
    up = fa.CORE_KEYS  # rows a block owns and keys a tile, both 128
    rows = -(-T // up) * up
    keys = sum(-(-(min(int(n), T) or T) // up) * up for n in lens.tolist())
    executed = 3 * 2.0 * D * rows * keys  # S twice and P.V, every (b, h)
    return {"core_ms": core_ms, "core_turns_ms": turns,
            "core_executed_tflops": tflops(executed, core_ms),
            "core_library_ms": yard.sdpa_forward_ms(q, k, v, lens)}


def _example(name: str):
    """The module of examples/<name>.py."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _yardsticks():
    """examples/torch_kernel_yardsticks.py: the library call each kernel is
    held against (the port itself never calls it)."""
    return _example("torch_kernel_yardsticks")


def ctc_work(bundle, B: int, T: int, samples: int, lens) -> dict:
    """(bytes, {kind: operations}) of K1-K4 on the flagship `bundle` (its
    block 0 and head): K1 on [B, samples] PCM, K2, K3 and K4 at B x T
    encoder frames with lens [B] valid keys (query-key pairs: T x valid
    keys a row). K1: three TF32 products of the DFT on the tensor cores,
    the power and the mel product over each filter's nonzero band on the
    CUDA cores. Each input read once, each output written once (bound())."""
    from jiao_liao_speech_recognition_torch.frontend import fused_frontend

    fe, blk, head = bundle.config.frontend, bundle.model.blocks[0], bundle.model.ctc_head
    sa, ln1, ln2, m = blk.self_attn, blk.self_attn_ln, blk.mlp_ln, blk.mlp
    d, mlp, V = blk.mlp.fc1.kernel.shape[0], m.fc1.kernel.shape[1], head.kernel.shape[1]
    n_fft, M = fe.n_fft, fe.num_mels
    frames, freqs = samples // fe.hop_length, n_fft // 2 + 1
    keys = float(lens.sum()) * T
    act = B * T * d * 2  # one bf16 activation tensor
    attn_w = (ln1.scale, ln1.bias, sa.q_proj.kernel, sa.q_proj.bias, sa.k_proj.kernel,
              sa.v_proj.kernel, sa.v_proj.bias, sa.out_proj.kernel, sa.out_proj.bias)
    mlp_w = (ln2.scale, ln2.bias, m.fc1.kernel, m.fc1.bias, m.fc2.kernel, m.fc2.bias)
    hi, _, mel_fb, bands = fused_frontend._kernel_constants(n_fft, M, fe.mel_scale, "cuda")
    mel_terms = int((bands[:, 1] - bands[:, 0]).sum())
    return {
        "K1": (B * samples * 4 + B * M * frames * 4 + 2 * hi.numel() * 4 + mel_fb.numel() * 4,
               {"tf32": 3.0 * B * frames * 2 * n_fft * 2 * freqs,
                "f32": B * frames * (3.0 * freqs + 2.0 * mel_terms)}),
        "K2": (2 * act + sum(t.numel() * 4 for t in attn_w) + B * 4,
               {"bf16": 8.0 * B * T * d * d + 4.0 * d * keys}),
        "K3": (2 * act + sum(t.numel() * 4 for t in mlp_w), {"bf16": 4.0 * B * T * d * mlp}),
        "K4": (act + d * V * 2 + V * 4 + B * T * 4, {"bf16": 2.0 * B * T * d * V}),
    }


def bound(nbytes: float, ops: dict):
    """-> (ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = sum(n / PEAK_OPS_S[kind] for kind, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_flops(kind: str, B: int, Tq: int, lens, H: int, dh: int) -> float:
    """Tensor-core flops that K6 ("fwd") or K8 ("bwd") execute on these
    shapes: the products of every tile they load (blocks of BLOCK_ROWS rows,
    forward key tiles of FWD_KEYS, backward tiles of BWD_TILE), padding
    included; K8 forms S and dP in both launches and runs its P and dS
    products as hi + lo pairs."""
    from jiao_liao_speech_recognition_torch.ops import flash_attention as fl

    def up(n, m):
        return -(-n // m) * m

    rows, lens = up(Tq, fl.BLOCK_ROWS), [min(int(n), Tq) for n in lens]
    if kind == "fwd":
        return 4.0 * H * dh * sum(rows * up(n, fl.FWD_KEYS) for n in lens)
    dq = 8.0 * H * dh * sum(rows * up(n, fl.BWD_TILE) for n in lens)  # S, dP, dS.K hi + lo
    dkv = 12.0 * H * dh * sum(up(n, fl.BLOCK_ROWS) * up(Tq, fl.BWD_TILE) for n in lens)
    return dq + dkv


def tflops(flops: float, ms: float) -> float:
    return flops / (ms * 1e-3) / 1e12


TRAIN_RATE_STEPS = 2  # phase 7's steps a timed turn


def route_run(cfg, manifest, tok, graph: bool, workdir: Path, steps: int) -> dict:
    """train_loop of a fresh model from cfg's seed for `steps` steps on one
    route, writing no checkpoint -> its per-step metrics (a MetricsLogger
    record a step, the timing left out), its trainable tensors and
    optimizer state on the host, info["graph"], peak device GB, the device
    memory held before it and seconds."""
    import copy
    import io

    import torch

    from jiao_liao_speech_recognition_torch.train import checkpoints, engine
    from jiao_liao_speech_recognition_torch.utils.logging import MetricsLogger

    cfg = copy.deepcopy(cfg)
    cfg.train.log_every_steps = 1
    cfg.train.checkpoint_dir = str(workdir / f"route_{'graph' if graph else 'eager'}")
    model = engine.make_model(cfg, "cuda")
    buf = io.StringIO()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    save = checkpoints.TrainCheckpointer.save
    checkpoints.TrainCheckpointer.save = lambda *a, **k: None  # the comparison reads no file
    try:
        (state, info), seconds = timed(lambda: engine.train_loop(
            cfg, manifest, tok, model, logger=MetricsLogger(stream=buf), graph=graph,
            max_steps=steps))
    finally:
        checkpoints.TrainCheckpointer.save = save
    records = [{k: v for k, v in json.loads(line).items()
                if k not in ("ts", "steps_per_sec")} for line in buf.getvalue().splitlines()]
    names = {id(p): n for n, p in model.named_parameters()}
    out = {"records": records, "graph": info["graph"], "seconds": seconds,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "held_before_gb": held_gb,
           "tensors": {n: p.detach().cpu() for n, p in model.named_parameters()
                       if p.requires_grad}}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            out["tensors"][f"{names[id(p)]}/{k}"] = v.detach().cpu()
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def route_diffs(a: dict, b: dict) -> dict:
    """Largest |a - b| of each metric of each step and of each tensor."""
    out = {f"{i}/{k}": abs(ra[k] - rb[k]) for i, (ra, rb) in enumerate(
        zip(a["records"], b["records"])) for k in ra if k != "step"}
    for k, t in a["tensors"].items():
        out[k] = float((t.double() - b["tensors"][k].double()).abs().max()) if t.numel() else 0.0
    return out


def routes_held(name: str, cfg, manifest, tok, workdir: Path, steps: int = GRAPH_STEPS,
                graphs: int = 1) -> dict:
    """`steps` captured steps against `steps` graph=False steps from one
    state: every step's metrics, the trainable tensors and the optimizer
    state bit for bit. Where they differ, a second graph=False run gives the
    spread two eager runs show (an atomic in a backward), and the captured
    route must stay within it, tensor by tensor. -> the readings."""
    eager = route_run(cfg, manifest, tok, False, workdir, steps)
    graph = route_run(cfg, manifest, tok, True, workdir, steps)
    diffs = route_diffs(graph, eager)
    over = {k: v for k, v in diffs.items() if v}
    spread = None
    if over:
        spread = route_diffs(route_run(cfg, manifest, tok, False, workdir, steps), eager)
        over = {k: (v, spread[k]) for k, v in over.items() if v > spread[k]}
    g = graph["graph"]
    out = {"steps": steps, "bitwise": not any(diffs.values()),
           "differing": sum(bool(v) for v in diffs.values()), "compared": len(diffs),
           "eager_spread_nonzero": None if spread is None else sum(bool(v) for v in
                                                                    spread.values()),
           "over_spread": dict(list(over.items())[:6]), "losses": [
               r["loss"] for r in graph["records"]], "route": g["route"],
           "graphs": g["graphs"], "replays": g["replays"], "capture_s": g["capture_s"],
           "replay_launches": g["replay_launches"], "peak_gb": {
               "eager": eager["peak_gb"], "captured": graph["peak_gb"]},
           "held_before_gb": {"eager": eager["held_before_gb"],
                              "captured": graph["held_before_gb"]},
           "seconds": {"eager": eager["seconds"], "captured": graph["seconds"]}}
    emit({"phase": name, "graph_vs_eager": out})
    check(len(graph["records"]) == steps and g["route"].startswith("captured")
          and g["graphs"] == graphs and g["replays"] == steps - graphs,
          f"{name}: not {steps} steps on {graphs} captured graph(s): {g}")
    check(not over, f"{name}: the captured steps differ from graph=False beyond the eager "
          f"spread: {out['over_spread']}")
    return out


def route_rates(name: str, cfg, model, host_batches, rate_steps: int = GRAPH_RATE_STEPS,
                profile_steps: int = GRAPH_PROFILE_STEPS) -> dict:
    """Steps/s of `model` on the two routes in GRAPH_TURNS (a TrainStep a
    turn over one optimizer; the captured turn's capture, and the eager
    turn's first step, untimed), each route's idle share and kernels a
    step over `profile_steps` steps (device_profile), and of the captured
    step its capture seconds and counted launches a replay."""
    import torch

    from jiao_liao_speech_recognition_torch.train import engine

    state = engine.init_state(cfg, model)
    secs = {False: [], True: []}
    out = {"steps_a_turn": rate_steps, "turns": list(GRAPH_TURNS)}
    for graph in GRAPH_TURNS:
        runner = engine.TrainStep(cfg, state, True, graph=graph)
        runner(host_batches[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(rate_steps):
            loss = runner(host_batches[i % 2])["loss"]
        torch.cuda.synchronize()
        secs[graph].append((time.perf_counter() - t0) / rate_steps)
        check(math.isfinite(float(loss)), f"{name}: loss not finite")
        key = "captured" if graph else "eager"
        if f"{key}_profile" not in out:
            out[f"{key}_profile"] = prof = device_profile(
                lambda i: runner(host_batches[i % 2]), profile_steps, f"{name} {key}")
            if graph:
                cap = next(iter(runner.buckets.values())).captured
                out.update(capture_s=runner.capture_s[0], launches_per_replay=cap.launches,
                           kernels_per_replay=prof["launches_per_call"])
                del cap  # the graph goes with the runner
            else:
                out["eager_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        runner.release()
        del runner
        gc.collect()
        torch.cuda.empty_cache()
    out.update({"eager_steps_s": 1.0 / statistics.median(secs[False]),
                "captured_steps_s": 1.0 / statistics.median(secs[True]),
                "eager_s_per_step": secs[False], "captured_s_per_step": secs[True],
                "eager_idle_share": out["eager_profile"]["device_idle_share"],
                "captured_idle_share": out["captured_profile"]["device_idle_share"]})
    emit({"phase": "timing", "train_routes": name, **out})
    return out


def host_batches(cfg, manifest, tok, n: int = 2) -> list:
    """The first n batches of `manifest` as a train step takes them (host
    tensors, the family's teacher-forcing inputs built)."""
    from jiao_liao_speech_recognition_torch.data.pipeline import BatchIterator
    from jiao_liao_speech_recognition_torch.decode.whisper_generate import resolve_specials
    from jiao_liao_speech_recognition_torch.train import engine

    kw = {"family": cfg.model_family}
    if cfg.model_family == "whisper":
        kw["whisper_prompt"], kw["eot_id"] = resolve_specials(cfg.whisper)
    it = BatchIterator(manifest, tok, cfg.data, sample_rate=cfg.frontend.sample_rate)
    return [engine.batch_to_device(next(it), "cpu", **kw) for _ in range(n)]


def phase_train_rate(ft_cfg):
    """Train steps/s on the kernel path and the plain path (turns: plain,
    kernels, kernels, plain; two distinct batches): the fine-tune config at
    B=16 x 30 s (T'=750: K6/K8), and flagship defaults + WF rank 8 at B=16 x
    10 s (T'=250: einsum attention, so only K1 differs)."""
    import torch

    from jiao_liao_speech_recognition_torch.data.manifest import read_manifest
    from jiao_liao_speech_recognition_torch.data.pipeline import BatchIterator
    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.train import engine
    from jiao_liao_speech_recognition_torch.utils.config import AdapterConfig, ExperimentConfig

    manifest = read_manifest(ft_cfg.data.train_manifest)
    it = BatchIterator(manifest, CharTokenizer.build(manifest.texts()), ft_cfg.data)
    batches30 = [engine.batch_to_device(next(it), "cuda") for _ in range(2)]
    cfg10 = ExperimentConfig()
    cfg10.ctc_model.adapter = AdapterConfig(kind="wf", wf_rank=8)
    cfg10.train.train_adapters_only = True
    rng = np.random.RandomState(4)
    B, samples = 16, 10 * SAMPLE_RATE
    batches10 = [{
        "audio": torch.from_numpy((0.1 * rng.randn(B, samples)).astype(np.float32)).cuda(),
        "audio_lengths": torch.full((B,), samples, dtype=torch.int32, device="cuda"),
        "labels": torch.from_numpy(
            rng.randint(1, cfg10.ctc_model.vocab_size, (B, 24)).astype(np.int32)).cuda(),
        "label_lengths": torch.full((B,), 24, dtype=torch.int32, device="cuda"),
    } for _ in range(2)]
    out = {name: train_rate(name, cfg, batches, steps=TRAIN_RATE_STEPS)
           for name, cfg, batches in (("B16x30s_adapter_finetune_yaml", ft_cfg, batches30),
                                      ("B16x10s_flagship_wf8", cfg10, batches10))}
    tok = CharTokenizer.build(manifest.texts())
    out["routes"] = route_rates("B16x30s_adapter_finetune_yaml", ft_cfg,
                                engine.make_model(ft_cfg, "cuda"),
                                host_batches(ft_cfg, manifest, tok))
    return out


def train_rate(name: str, cfg, batches, profile_steps: int = 0, steps: int = 4,
               turns=(False, True, True, False)) -> dict:
    """Train steps/s of `cfg`'s trainable set on two batches, kernel path and
    plain path in turns (True = the kernel path; `steps` steps each), after
    a warm step of each batch on each path timed; with `profile_steps`,
    then that many kernel-path steps under the profiler (``device_profile``)."""
    import torch

    from jiao_liao_speech_recognition_torch.train import engine

    model = engine.make_model(cfg, "cuda")
    state = engine.init_state(cfg, model)
    step = engine.make_train_step(engine.make_loss_fn(cfg, model), cfg.train.optimizer)
    for kernels in sorted(set(turns)):
        for b in batches:
            step(state, b, kernels)
    torch.cuda.synchronize()
    secs = {True: [], False: []}
    for kernels in turns:
        t0 = time.perf_counter()
        for i in range(steps):
            loss = step(state, batches[i % 2], kernels)["loss"]
        check(math.isfinite(float(loss)), f"{name}: loss not finite")
        secs[kernels].append((time.perf_counter() - t0) / steps)
    out = {"steps_a_turn": steps, "kernel_path_steps_s": 1.0 / statistics.median(secs[True]),
           "plain_path_steps_s": 1.0 / statistics.median(secs[False]) if secs[False] else None,
           "kernel_path_s_per_step": secs[True], "plain_path_s_per_step": secs[False]}
    if profile_steps:
        out["profile"] = device_profile(lambda i: step(state, batches[i % 2], True),
                                        profile_steps, name)
    emit({"phase": "timing", "train": name, **out})
    return out


def device_profile(fn, calls: int, name: str, top: int = 8) -> dict:
    """fn(i) for i < calls under torch.profiler, then a sync -> wall and
    device busy seconds a call, the busy and idle shares of the wall, and
    the `top` kernels by device ms a call. A user-annotated range (such as
    the optimizer's step) is left out: its device time is that of the
    kernels inside it, already counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted(((e.device_time_total / 1e3 / calls, e.count // calls, e.key[:80])
                      for e in prof.key_averages()
                      if e.device_type.name == "CUDA" and e.device_time_total
                      and not getattr(e, "is_user_annotation", False)),
                     reverse=True)
    busy = sum(k[0] for k in kernels) / 1e3
    check(busy > 0, f"{name}: the profiler saw no device time")
    return {"calls": calls, "wall_s_per_call": wall / calls, "device_busy_s_per_call": busy,
            "device_busy_share": busy * calls / wall, "device_idle_share": 1 - busy * calls / wall,
            "launches_per_call": sum(k[1] for k in kernels),
            "top_kernels_ms_per_call": kernels[:top]}


# --- main paths 7-9: the multi-dialect transfer through the CLI -------------


def cli_run(argv) -> list:
    """cli.main(argv) with its standard output captured -> the output's
    lines (also printed); a non-zero exit code fails the run."""
    import contextlib
    import io

    from jiao_liao_speech_recognition_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    print(buf.getvalue(), end="", flush=True)
    check(rc == 0, f"cli {argv[0]} exited {rc}")
    return buf.getvalue().strip().splitlines()


def write_transfer_corpora(d: Path, chars: int = 4334, seed: int = 7) -> dict:
    """TRANSFER_CORPORA as WAVs (tone + noise, 30 s) and transcript tables.
    jiaoliao's rows take one of six slices of the `chars` characters in
    turn, so each character is in three rows and its train split (all but
    two rows) holds every one; the neighbours' rows draw 271 of them each.
    The stages' texts thus use `chars` characters: a char vocab of chars + 2.
    -> dialect -> table path."""
    from jiao_liao_speech_recognition_torch.frontend.audio_io import write_wav

    rng = np.random.RandomState(seed)
    order = rng.permutation(chars)
    slices = np.array_split(order, 6)
    t = np.arange(30 * SAMPLE_RATE) / SAMPLE_RATE
    tables = {}
    for dialect in TRANSFER_CORPORA:
        (d / dialect).mkdir(parents=True)
        lines = []
        for i in range(TRANSFER_UTTS):
            wav = (0.2 * np.sin(2 * np.pi * rng.uniform(150.0, 2000.0) * t)
                   + 0.05 * rng.randn(len(t)))
            write_wav(d / dialect / f"u{i:02d}.wav", wav, SAMPLE_RATE)
            ids = slices[i % 6] if dialect == "jiaoliao" else rng.choice(order, 271, False)
            lines.append(f"u{i:02d}.wav\t" + "".join(chr(0x4E00 + int(j)) for j in ids))
        tables[dialect] = d / dialect / "transcripts.tsv"
        tables[dialect].write_text("\n".join(lines), encoding="utf-8")
    return tables


def phase_prepare(counters, workdir: Path):
    """Main path 7: `cli prepare` of each corpus, with --cmvn (K1) on jiaoliao."""
    tables = write_transfer_corpora(workdir / "corpora")
    out = {}

    def run():
        for dialect, table in tables.items():
            out[dialect] = json.loads(cli_run(
                ["prepare", table, "--out-dir", workdir / "manifests", "--audio-root",
                 table.parent, "--dialect", dialect, *(["--cmvn"] * (dialect == "jiaoliao"))])[-1])

    _, launches = drive(counters, "prepare", run)
    with np.load(out["jiaoliao"]["cmvn_stats"]) as st:
        mean, std, count = st["mean"], st["std"], int(st["count"])
    rows = {d: {s: len(Path(p).read_text().splitlines()) for s, p in o.items() if s != "cmvn_stats"}
            for d, o in out.items()}
    emit({"phase": "prepare", "rows": rows, "cmvn_frames": count,
          "cmvn_mean_range": [float(mean.min()), float(mean.max())],
          "cmvn_std_range": [float(std.min()), float(std.max())], "launches": launches})
    check(all(r == {"train": TRANSFER_UTTS - 2, "dev": 1, "test": 1} for r in rows.values()),
          f"prepare's splits: {rows}")
    # 16 train rows in two batches of 8, 3000 valid frames each
    check(launches["K1"] == 2 and count == 16 * 3000, f"CMVN: {count} frames")
    check(mean.shape == std.shape == (80,) and np.isfinite(mean).all()
          and bool((std > 0).all()), "CMVN stats are not 80 finite means and positive stds")
    return launches, out


def transfer_config(workdir: Path, manifests: dict) -> Path:
    """A copy of configs/multi_dialect_transfer.yaml whose stages read these
    manifests and take TRANSFER_STEPS steps, checkpointing under `workdir`;
    nothing else changes."""
    import yaml

    src = Path(__file__).resolve().parent / "configs" / "multi_dialect_transfer.yaml"
    data = yaml.safe_load(src.read_text())
    neighbour, target = data["stages"]
    neighbour["manifests"] = [manifests["jilu"]["train"], manifests["zhongyuan"]["train"]]
    target["manifests"] = [manifests["jiaoliao"]["train"]]
    neighbour["steps"] = target["steps"] = TRANSFER_STEPS
    data["train"]["checkpoint_dir"] = str(workdir / "ckpt")
    data["train"]["metrics_path"] = str(workdir / "metrics.jsonl")
    path = workdir / "transfer.yaml"
    path.write_text(yaml.safe_dump(data, sort_keys=False, allow_unicode=True))
    return path


def phase_transfer(counters, workdir: Path, manifests: dict):
    """Main path 8: `cli train` of the transfer config: stage 1 (both
    neighbour corpora mixed, every parameter) then stage 2 (jiaoliao, the
    Att adapters alone), launch counts a stage, what each stage moved, and
    a resume that takes no step."""
    import torch

    from jiao_liao_speech_recognition_torch.models import convert
    from jiao_liao_speech_recognition_torch.models.adapters import param_is_adapter
    from jiao_liao_speech_recognition_torch.models.ctc_model import CTCEncoderModel
    from jiao_liao_speech_recognition_torch.train import schedules
    from jiao_liao_speech_recognition_torch.utils import graphs
    from jiao_liao_speech_recognition_torch.utils.config import load_yaml

    path = transfer_config(workdir, manifests)
    cfg = load_yaml(str(path))
    m, ad = cfg.ctc_model, cfg.ctc_model.adapter
    stages = []
    real = schedules.train_loop

    def counts():  # counted launches plus the captured steps' replayed ones
        return {k: c.launches + graphs.TALLY.launches.get(c.name, 0)
                for k, c in counters.items()}

    def counted(*args, **kw):  # launches and seconds of each stage's loop
        before = counts()
        t0 = time.perf_counter()
        state, info = real(*args, **kw)
        torch.cuda.synchronize()
        stages.append({"seconds": time.perf_counter() - t0, "steps": len(info["losses"]),
                       "losses": info["losses"], "graph": info["graph"], "launches": {
                           k: n - before[k] for k, n in counts().items()}})
        return state, info

    schedules.train_loop = counted
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, launches = drive(counters, "transfer", lambda: cli_run(["train", "--config", path]))
        seconds = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        history = [json.loads(line) for line in out[:-1]]
        ckpt = Path(cfg.train.checkpoint_dir)
        final = ckpt / "final"
        with np.load(final / "params.npz") as f:
            saved = dict(f)
        # resume over the finished stages: no step, the same bundle
        n_before = len(stages)
        for c in counters.values():
            c.reset()
        again = [json.loads(line) for line in cli_run(["train", "--config", path, "--resume"])[:-1]]
        resumed = stages[n_before:]
        torch.cuda.synchronize()
        resume_launches = {k: sum(st["launches"][k] for st in resumed) for k in counters}
    finally:
        schedules.train_loop = real
    with np.load(final / "params.npz") as f:
        unchanged = sorted(f.files) == sorted(saved) and all(
            np.array_equal(f[k], v) for k, v in saved.items())

    served = load_yaml(str(final / "config.yaml")).ctc_model
    init = CTCEncoderModel(served, seed=cfg.train.seed).state_dict()
    dirs = [ckpt / f"stage_{i}_{s.name}" / f"{TRANSFER_STEPS:08d}" for i, s in enumerate(cfg.stages)]
    end1, end2 = (torch.load(d / "state.pt", map_location="cpu", weights_only=False)["model"]
                  for d in dirs)
    final_sd = convert.params_to_state_dict(convert.read_npz_params(final / "params.npz"))
    dense = [k for k in init if not param_is_adapter(k) and (
        (k.startswith("blocks.") and k.endswith(".kernel")) or k.startswith("subsample.")
        or k.startswith("ctc_head."))]
    backbone = [k for k in init if not param_is_adapter(k)]
    adapters = [k for k in init if param_is_adapter(k)]
    moved1 = [k for k in dense if not torch.equal(end1[k], init[k])]
    still2 = [k for k in backbone if torch.equal(end2[k], end1[k])]
    moved2 = [k for k in adapters if not torch.equal(end2[k], end1[k])]
    final_is_end2 = all(torch.equal(final_sd[k], end2[k]) for k in init)
    per_stage = [{"stage": s.name, "steps": st["steps"], "seconds": st["seconds"],
                  "losses": st["losses"], "graph": st["graph"],
                  **{f"{k}_launches": st["launches"][k]
                     for k in ("K1", "K6", "K8", "CTC", "CTC-bwd")}}
                 for s, st in zip(cfg.stages, stages)]
    emit({"phase": "transfer", "config": "configs/multi_dialect_transfer.yaml",
          "layers": m.num_layers, "d_model": m.d_model, "heads": m.num_heads, "mlp": m.mlp_dim,
          "adapter": f"{ad.kind} {ad.att_num_heads} x {ad.att_key_dim}", "vocab": served.vocab_size,
          "batch": cfg.data.batch_size, "stages": per_stage, "history": history,
          "seconds_cli_train": seconds, "peak_device_gb": peak_gb, "launches": launches,
          "stage1_dense_moved": f"{len(moved1)}/{len(dense)}",
          "stage2_backbone_bitwise": f"{len(still2)}/{len(backbone)}",
          "stage2_adapters_moved": f"{len(moved2)}/{len(adapters)}",
          "final_is_stage2_end": final_is_end2, "resume_history": again,
          "resume_steps": [st["steps"] for st in resumed],
          "resume_launches": {k: v for k, v in resume_launches.items() if v},
          "resume_params_unchanged": unchanged})
    check(served.vocab_size == 4336 and m.num_heads == 8 and m.d_model == 512
          and m.num_layers == 12 and ad.kind == "att", "not the published transfer config")
    check(all((final / f).exists() for f in ("params.npz", "config.yaml", "vocab.json"))
          and all(d.is_dir() for d in dirs), "a stage checkpoint or the final bundle is missing")
    check([h["stage"] for h in history] == [s.name for s in cfg.stages]
          and all(math.isfinite(h["loss"]) for h in history), f"history {history}")
    check([st["steps"] for st in stages[:2]] == [TRANSFER_STEPS] * 2
          and all(math.isfinite(x) for st in stages[:2] for x in st["losses"]),
          "a stage did not take its steps with finite losses")
    n_attn = m.num_layers * (1 + ad.after_attention + ad.after_mlp)
    want = ({"K1": 1, "K6": n_attn, "K8": n_attn, "CTC": 1, "CTC-bwd": 1},
            {"K1": 1, "K6": n_attn, "K8": n_attn - 1, "CTC": 1, "CTC-bwd": 1})
    for st, w in zip(stages, want):
        got = {k: st["launches"][k] for k in w}
        check(got == {k: v * TRANSFER_STEPS for k, v in w.items()},
              f"stage launches {got}, not {TRANSFER_STEPS} x {w}")
    check(all(st["graph"]["route"].startswith("captured") and st["graph"]["graphs"] == 1
              for st in stages[:2]), "a stage's steps were not captured")
    check(len(moved1) == len(dense), f"stage 1 left {set(dense) - set(moved1)} as initialised")
    check(len(still2) == len(backbone), "stage 2 moved the backbone")
    check(len(moved2) == len(adapters), f"stage 2 left {set(adapters) - set(moved2)} unmoved")
    check(final_is_end2, "the final bundle is not stage 2's last checkpoint")
    check(again == [{"stage": s.name} for s in cfg.stages]
          and [st["steps"] for st in resumed] == [0, 0]
          and not any(resume_launches.values()) and unchanged,
          "the resume over finished stages took a step or changed the bundle")
    return launches, cfg, final


def phase_transfer_vs_plain(cfg, final: Path):
    """Stage 1's step with every parameter trainable, kernel path against
    plain (and both against float32), on the first batch of its mixture."""

    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.train.schedules import build_stage_manifest

    tok = CharTokenizer.load(final / "vocab.json")
    cfg = dataclasses.replace(cfg, ctc_model=dataclasses.replace(
        cfg.ctc_model, vocab_size=len(tok)))
    stage = cfg.stages[0]
    manifest = build_stage_manifest(stage)
    step_vs_plain("transfer", cfg, manifest, tok, adapters_only=stage.train_adapters_only)
    # stage 1's step (every parameter trainable) on both routes
    from jiao_liao_speech_recognition_torch.train import engine

    stage_cfg = dataclasses.replace(cfg, stages=[], train=dataclasses.replace(
        cfg.train, train_adapters_only=stage.train_adapters_only,
        optimizer=dataclasses.replace(cfg.train.optimizer, total_steps=stage.steps)))
    with tempfile.TemporaryDirectory() as tmp:
        routes_held("transfer_stage1", stage_cfg, manifest, tok, Path(tmp))


def phase_transfer_serve(counters, final: Path, manifests: dict, workdir: Path):
    """Main path 9: the transferred bundle serves the six requests (plain and
    with timestamps) and `cli evaluate --per-utt` scores jiaoliao's test
    split: K1, K2 at 8 x 64, K3 and K4 a batch, K6 24 a batch (both Att
    adapters of every block)."""
    from jiao_liao_speech_recognition_torch import api

    bundle = api.load(str(final), device="cuda")
    m = bundle.config.ctc_model
    check(m.adapter.kind == "att" and m.num_heads == 8, "the bundle lost its configuration")
    requests = make_requests()
    test = manifests["jiaoliao"]["test"]
    per_utt = workdir / "per_utt.jsonl"

    def run():
        texts = api.transcribe(bundle, requests)
        timed = api.transcribe(bundle, requests, timestamps=True)
        out = cli_run(["evaluate", "--manifest", test, "--checkpoint", final,
                       "--per-utt", per_utt])
        return texts, timed, json.loads(out[-1])

    (texts, timed, scores), launches = drive(counters, "transfer_serve", run)
    rows = [json.loads(line) for line in per_utt.read_text().splitlines()]
    n_test = len(Path(test).read_text().splitlines())
    batches = 2 + -(-n_test // 16)
    slots = m.adapter.after_attention + m.adapter.after_mlp
    want = {"K1": batches, "K2": m.num_layers * batches, "K3": m.num_layers * batches,
            "K4": batches, "K6": slots * m.num_layers * batches}
    emit({"phase": "transfer_serve", "heads": m.num_heads, "text_chars": [len(s) for s in texts],
          "evaluate": scores, "launches": launches,
          "per_utt": [{k: r[k] for k in ("audio", "dialect", "cer", "wer")} for r in rows]})
    check({k: launches[k] for k in want} == want, f"launches {launches}, not {want}")
    check(scores["utterances"] == n_test == len(rows) and math.isfinite(scores["cer"])
          and all({"audio", "dialect", "ref", "hyp", "cer", "wer"} <= set(r) for r in rows),
          f"evaluate --per-utt: {scores}")
    check_texts(requests, texts, timed)
    emit({"phase": "transfer_serve", "vs_plain": serve_vs_plain(bundle, requests)})
    emit({"phase": "transfer_serve", "adapters_perturbed": adapters_perturbed(bundle, requests)})
    return launches, bundle


def adapters_perturbed(bundle, requests) -> dict:
    """A few steps inside the warmup leave the adapters' out_proj near zero,
    so the adapter slots hardly move the served ids. Perturb every adapter
    tensor (as step_vs_plain does): the kernel path's ids must change, and
    still hold against the plain path under the margin rule; the trained
    tensors are put back after."""
    import torch

    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch
    from jiao_liao_speech_recognition_torch.models.adapters import param_is_adapter

    fe = bundle.config.frontend
    wavs, alens, _ = bundle._prepare_audio_chunked(requests, None)
    wav = torch.from_numpy(wavs).cuda()
    flens = torch.from_numpy(alens // fe.hop_length).cuda()

    def ids():
        with torch.inference_mode():
            feats = featurize_batch(wav, fe, kernels=True)
            return bundle.model(feats, flens, head_mode="argmax_ids", kernels=True)

    before, olens = ids()
    trained = {n: p.detach().clone() for n, p in bundle.model.named_parameters()
               if param_is_adapter(n)}
    gen = torch.Generator().manual_seed(5)
    params = dict(bundle.model.named_parameters())
    with torch.no_grad():
        for n in trained:
            params[n].add_(0.02 * torch.randn(params[n].shape, generator=gen).to(params[n].device))
    after, _ = ids()
    frames = torch.arange(before.shape[1], device="cuda")[None, :] < olens[:, None]
    changed = float(((before != after) & frames).sum() / frames.sum())
    out = {"tensors": len(trained), "ids_changed_share": changed,
           **serve_vs_plain(bundle, requests)}
    with torch.no_grad():
        for n, v in trained.items():
            params[n].copy_(v)
    check(changed > 0, "perturbed adapters left every served id as it was")
    check(torch.equal(ids()[0], before), "the trained adapters did not come back")
    return out


def phase_transfer_timing(cfg, final: Path, bundle):
    """Steps/s of each stage's captured step against graph=False in turns
    (route_rates: each route's idle share, the capture, launches a
    replay), and the transferred bundle's greedy RTFx at B=32 x 30 s (and
    four of its batches profiled)."""

    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.train import engine
    from jiao_liao_speech_recognition_torch.train.schedules import build_stage_manifest

    tok = CharTokenizer.load(final / "vocab.json")
    for i, stage in enumerate(cfg.stages):
        scfg = dataclasses.replace(
            cfg, stages=[], ctc_model=dataclasses.replace(cfg.ctc_model, vocab_size=len(tok)),
            train=dataclasses.replace(cfg.train, train_adapters_only=stage.train_adapters_only))
        manifest = build_stage_manifest(stage)
        route_rates(f"transfer_stage_{i}_{stage.name}", scfg, engine.make_model(scfg, "cuda"),
                    host_batches(scfg, manifest, tok))
    rtfx, bufs, infer = greedy_rtfx(bundle, np.random.RandomState(1))
    rtfx["profile"] = device_profile(lambda i: infer(bufs[i % 2], True), 4, "greedy")
    emit({"phase": "timing", "greedy": "transferred bundle", **rtfx})


# --- main path 4: Whisper large-v3 serving ------------------------------------


def whisper_config():
    from jiao_liao_speech_recognition_torch.utils.config import (
        ExperimentConfig,
        FrontendConfig,
        whisper_preset,
    )

    w = whisper_preset(WHISPER_PRESET)
    cfg = ExperimentConfig(model_family="whisper", whisper=w,
                           frontend=FrontendConfig(num_mels=w.num_mels))
    cfg.decode.max_decode_len = WHISPER_MAX_LEN
    return cfg


def _ulp_check(key, got, want, **info):
    import torch

    torch.cuda.synchronize()
    ulps, elem_ulps, over1 = bf16_ulp_err(got, want)
    err = float((got.float() - want.float()).abs().max())
    emit({"phase": "kernels", "kernel": key, **info, "max_abs_err": err, "ulps": ulps,
          "bar_ulps": ULP_BAR, "elementwise_max_ulps": elem_ulps,
          "elementwise_share_over_1ulp": over1})
    check(ulps <= ULP_BAR, f"{key} {info} off by {ulps} bf16 ulps")
    return err


def phase_whisper_kernels():
    """K1 at 128 mels, K5 and K3 at d=1280, K6 at 20 heads of 64 and K9
    against their plain versions at the Whisper path's shapes."""
    import torch

    from jiao_liao_speech_recognition_torch.frontend import features, fused_frontend
    from jiao_liao_speech_recognition_torch.ops import flash_attention as fl
    from jiao_liao_speech_recognition_torch.ops import fused_attention, fused_mlp

    cfg = whisper_config()
    w, fe = cfg.whisper, cfg.frontend
    dev = torch.device("cuda")
    rng = np.random.RandomState(6)
    B, T, d, H = WHISPER_B, WHISPER_T, w.d_model, w.num_heads
    dh, mlp = d // H, w.mlp_dim
    errs = {}

    t = np.arange(30 * SAMPLE_RATE) / SAMPLE_RATE
    wav = torch.from_numpy(np.stack([
        a * np.sin(2 * np.pi * f * t) + n * rng.randn(len(t))
        for a, f, n in ((0.3, 440.0, 0.05), (0.0, 1.0, 0.1), (0.02, 300.0, 0.0005))
    ]).astype(np.float32)).to(dev)
    mel_args = (fe.n_fft, fe.hop_length, fe.num_mels, fe.mel_scale, fe.log_floor)
    got = features.normalize_log_mel(fused_frontend.fused_log_mel_raw(wav, *mel_args), fe)
    want = features.normalize_log_mel(fused_frontend.log_mel_raw_plain(wav, *mel_args), fe)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    emit({"phase": "kernels", "kernel": "K1", "mels": fe.num_mels, "max_abs_err": err,
          "bar": LOGMEL_BAR})
    check(err <= LOGMEL_BAR, f"K1 (128 mels) log-mel error {err} > {LOGMEL_BAR}")

    def f32(*shape, s=0.05):
        return torch.from_numpy((s * rng.randn(*shape)).astype(np.float32)).to(dev)

    x = f32(B, T, d, s=1.0).to(torch.bfloat16)
    ln = (1.0 + f32(d, s=0.1), f32(d, s=0.1))
    w_qkv = fused_mlp.pack_qkv(f32(d, d), f32(d), f32(d, d), f32(d, d), f32(d))
    w_mlp = [t.to(torch.bfloat16) for t in (f32(d, mlp), f32(mlp), f32(mlp, d), f32(d))]
    # K5 and K3c at B=16 and at the six requests' seven chunks (a ragged
    # last 128-row tile), each launched twice: the same bits
    for b in (B, 7):
        qkv_args = (x[:b], *ln, *w_qkv)
        got = fused_mlp.fused_ln_qkv(*qkv_args)
        again = fused_mlp.fused_ln_qkv(*qkv_args)
        want = fused_mlp.ln_qkv_plain(*qkv_args)
        errs["K5"] = max([errs.get("K5", 0.0)] + [
            _ulp_check("K5", a, c, part=n, B=b, T=T, d=d) for n, a, c in zip("qkv", got, want)])
        check(all(torch.equal(a, c) for a, c in zip(got, again)), f"K5 (B={b}): launches differ")
        mlp_args = (x[:b], *ln, *w_mlp, 1e-5, "erf")
        got = fused_mlp.fused_ln_mlp_residual(*mlp_args)
        again = fused_mlp.fused_ln_mlp_residual(*mlp_args)
        err = _ulp_check("K3c", got, fused_mlp.ln_mlp_residual_plain(*mlp_args), B=b, T=T, d=d,
                         mlp=mlp, gelu="erf", bitwise_repeat=bool(torch.equal(got, again)))
        check(torch.equal(got, again), f"K3c (B={b}): two launches differ")
        errs["K3c"] = max(errs.get("K3c", 0.0), err)
    del got, again, want
    # K2h-out at B=16 and at the six requests' seven chunks (a ragged last
    # 128-row tile)
    wo, bo = f32(d, d).to(torch.bfloat16), f32(d, s=0.5).to(torch.bfloat16)
    for b in (B, 7):
        out_args = (x[:b], f32(b, T, d, s=1.0).to(torch.bfloat16), wo, bo)
        err = _ulp_check("K2h-out", fused_attention.out_proj_residual(*out_args),
                         fused_mlp.fc2_residual_plain(*out_args), B=b, T=T, d=d)
        errs["K2h-out"] = max(errs.get("K2h-out", 0.0), err)
    del out_args, x, qkv_args, mlp_args

    q, k, v, kl, _ = _flash_inputs(rng, B, T, H, dh, ([T, 1000, 313, 1] * B)[:B], dev)
    out, lse = fl.flash_forward(q, k, v, kl)
    out_p, lse_p = fl.flash_forward_plain(q, k, v, kl)
    _ulp_check("K6", out, out_p, B=B, T=T, heads=H, dh=dh)
    lse_err = float((lse - lse_p).abs().max())
    check(lse_err <= LSE_BAR, f"K6 (whisper shape) lse off by {lse_err}")
    del q, k, v, out, out_p, lse, lse_p

    errs["K9"] = k9_cases(int8=False)
    return errs


def k9_cases(int8: bool) -> float:
    """K9 on bf16 or int8 caches against decode_attention_plain within
    ULP_BAR at every horizon of the Whisper path (cross Tk 1536, self Tk 256
    and 128), Tq 1, 3 and 8, dh 64 (20 heads) and 128 (10 heads), B=16: the
    lengths 0, 1, 15, 16, 17, one short of, at and one past the kernel's
    block steps of 128 and 256 keys, and Tk; each case launched twice,
    bitwise equal. -> the largest abs error."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import decode_attention as da
    from jiao_liao_speech_recognition_torch.ops import quant

    key = "K9-int8" if int8 else "K9"
    randn = _card_randn(12 + int(int8))
    B, err = WHISPER_B, 0.0
    for tk in (da.round_tk(WHISPER_T), da.round_tk(WHISPER_MAX_LEN),
               da.round_tk(INT8_B16_COUNT_LEN)):
        for dh, H in ((64, 20), (128, 10)):
            for tq in (1, 3, 8):
                lens = [0, 1, 15, 16, 17, 127, 128, 129, 255, 256, 257, tk - 17, tk - 1, tk]
                lens = [min(n, tk) for n in lens] + [min(WHISPER_T, tk // 2)] * (B - len(lens))
                qh = randn(B, H, tq, dh).to(torch.bfloat16)
                if int8:
                    (kc, ks), (vc, vs) = (quant.quantize_kv(randn(B, H, tk, dh)) for _ in range(2))
                    scales = {"k_scale": ks, "v_scale": vs}
                else:
                    kc, vc = (randn(B, H, tk, dh).to(torch.bfloat16) for _ in range(2))
                    scales = {}
                lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
                got = da.grouped_decode_attention(qh, kc, vc, lt, **scales)
                again = da.grouped_decode_attention(qh, kc, vc, lt, **scales)
                want = da.decode_attention_plain(qh, kc, vc, lt, **scales)
                same = bool(torch.equal(got, again))
                err = max(err, _ulp_check(key, got, want, Tk=tk, dh=dh, Tq=tq, lens=lens,
                                          bitwise_repeat=same))
                check(bool(torch.isfinite(got).all()), f"{key}: a row is not finite")
                check(same, f"{key} Tk={tk} dh={dh} Tq={tq}: two launches differ")
    if int8:
        return err
    # the joint beam's decode shapes: 128 rows (16 utterances x 8 beams), 4
    # heads of 128, one query row, the cross horizon of 750 frames and the
    # self horizon of 64 positions
    R = JOINT_B * JOINT_BEAM
    for tk, full in ((da.round_tk(750), 750), (da.round_tk(JOINT_MAX_LEN), JOINT_MAX_LEN)):
        lens = [0, 1, 15, 16, 17, 63, 64, 65, 127, 128, tk - 1, tk]
        lens = [min(n, tk) for n in lens] + [full] * (R - len(lens))
        qh = randn(R, 4, 1, 128).to(torch.bfloat16)
        kc, vc = (randn(R, 4, tk, 128).to(torch.bfloat16) for _ in range(2))
        lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = da.grouped_decode_attention(qh, kc, vc, lt)
        again = da.grouped_decode_attention(qh, kc, vc, lt)
        same = bool(torch.equal(got, again))
        err = max(err, _ulp_check(key, got, da.decode_attention_plain(qh, kc, vc, lt), Tk=tk,
                                  dh=128, Tq=1, B=R, joint=True, bitwise_repeat=same))
        check(bool(torch.isfinite(got).all()) and same,
              f"{key} (joint, Tk={tk}): a row is not finite or two launches differ")
    return err


def with_generated_ids(fn):
    """fn() with decode/whisper_generate.generate watched -> (fn's result,
    the (ids, lengths) of its last generate call): the held checks read the
    ids the transcription itself decoded instead of decoding the same
    chunks again."""
    from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg

    seen, generate = [], wg.generate

    def watched(*args, **kwargs):
        seen.append(generate(*args, **kwargs))
        return seen[-1]

    wg.generate = watched
    try:
        out = fn()
    finally:
        wg.generate = generate
    check(len(seen) > 0, "the transcription did not go through generate")
    return out, seen[-1]


def phase_whisper(counters):
    """api.load (random init on the card) + api.transcribe of the six
    requests; the encoder against the plain path; the generated tokens
    teacher-forced through the plain decoder."""
    import torch

    from jiao_liao_speech_recognition_torch import api
    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch

    cfg = whisper_config()
    w = cfg.whisper
    t0 = time.perf_counter()
    bundle = api.load(config=cfg, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    model = bundle.model
    n_params = sum(p.numel() for p in model.parameters())
    # one character per non-special id, so every id decodes to text
    bundle.tokenizer = CharTokenizer([chr(0x4E00 + i) for i in range(w.vocab_size - 2)])
    requests = make_requests()
    wg.STEPS.reset()
    t0 = time.perf_counter()
    (texts, (ids, lens)), launches = drive(counters, "whisper_serve", lambda: with_generated_ids(
        lambda: api.transcribe(bundle, requests)))
    seconds = time.perf_counter() - t0
    steps = wg.STEPS.steps
    emit({"phase": "whisper", "preset": WHISPER_PRESET, "params": n_params,
          "d_model": w.d_model, "layers": [w.encoder_layers, w.decoder_layers],
          "heads": w.num_heads, "mlp": w.mlp_dim, "vocab": w.vocab_size, "mels": w.num_mels,
          "load_s": load_s, "requests_s": [len(r) / SAMPLE_RATE for r in requests],
          "text_chars": [len(s) for s in texts], "seconds": seconds, "decode_steps": steps,
          "launches": launches})
    check(len(texts) == len(requests) and all(isinstance(s, str) for s in texts),
          "one transcript per request")
    check(sum(len(s) for s in texts) > 0, "the model emitted no text at all")
    L = w.encoder_layers
    for key in ("K5", "K6", "K2h-out", "K3c"):
        check(launches[key] == L, f"{key} launched {launches[key]} times, not {L}")
    check(launches["K2"] == 0 and launches["K3"] == 0, "K2 or K3's d<1280 instances ran")
    check(launches["K9"] == 2 * w.decoder_layers * steps,
          f"K9 launched {launches['K9']} times, not 2 x {w.decoder_layers} x {steps}")

    fe = cfg.frontend
    prompt, eot = wg.resolve_specials(w)
    wavs, _, _ = bundle._prepare_audio_chunked(requests, None)
    with torch.inference_mode():
        wav = torch.from_numpy(wavs).cuda()
        feats_k = featurize_batch(wav, fe, kernels=True)
        feats_p = featurize_batch(wav, fe, kernels=False)
        enc_k = model.encode(feats_k, kernels=True)
        enc_p = model.encode(feats_p, kernels=False)
        P = len(prompt)
        toks = torch.cat([torch.tensor(prompt, device="cuda").expand(ids.shape[0], P), ids], 1)
        logits = model.decode(toks[:, :-1], enc_k, kernels=False).float()
        torch.cuda.synchronize()
    enc_rel = float((enc_k.float() - enc_p.float()).norm() / enc_p.float().norm())
    coverage, mismatch, scored, agree = margin_check(logits, toks, lens, P)
    emit({"phase": "whisper", "vs_plain": {
        "chunks": int(wavs.shape[0]), "encoder_rel_l2": enc_rel, "encoder_bar": ENC_REL_BAR,
        "logmel_max_abs_err": float((feats_k - feats_p).abs().max()),
        "generated_lengths": [int(n) for n in lens], "positions": scored,
        "coverage": coverage, "margin": ARGMAX_MARGIN, "mismatched_positions": mismatch,
        "agree_all_positions": agree, "logits_finite": bool(torch.isfinite(logits).all())}})
    check(bool(torch.isfinite(enc_k.float()).all()) and tuple(enc_k.shape) == (
        wavs.shape[0], w.max_source_positions, w.d_model), "encoder output not finite [N, 1500, d]")
    check(enc_rel <= ENC_REL_BAR, f"encoder off the plain path by {enc_rel}")
    check(coverage >= MIN_COVERAGE and mismatch == 0,
          f"decoder tokens disagree with the plain argmax ({mismatch}, coverage {coverage})")
    return launches, bundle


def phase_whisper_beam(counters, bundle, workdir: Path):
    """Main path 13: Whisper's AR beam (decode/whisper_generate.py) on phase
    8's large-v3 bundle, K=4 over two chunks for 32 decode steps, through
    bundle._whisper_ids (log-mel, then generate, as transcribe): exact K9
    launches; a beam of one bitwise greedy; a second beam naming an LM at
    lm_weight 0 bitwise the first. generate loads no LM at weight 0, so
    that shows determinism only: the shallow fusion is held on the joint
    beam (joint_beam_checks), whose [V, V] bigram matrix is 75 MB against
    10.8 GB at large-v3's V. -> launches."""
    import torch

    from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg
    from jiao_liao_speech_recognition_torch.decode.lm import NGramCharLM
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch
    from jiao_liao_speech_recognition_torch.utils.config import DecodeConfig

    B, K, max_len = WHISPER_BEAM
    w, model = bundle.config.whisper, bundle.model
    prompt, eot = wg.resolve_specials(w)
    wavs, _, _ = bundle._prepare_audio_chunked(make_requests()[3:3 + B], None)
    lm_path = workdir / "lm.npz"
    rng = np.random.RandomState(23)
    NGramCharLM.train([rng.randint(0, w.vocab_size, 20) for _ in range(8)], 2,
                      w.vocab_size).save(lm_path)
    dc = DecodeConfig(strategy="beam", beam_size=K, max_decode_len=max_len)
    wg.STEPS.reset()
    t0 = time.perf_counter()
    (ids, lens), launches = drive(counters, "whisper_beam", lambda: bundle._whisper_ids(wavs, dc))
    seconds = time.perf_counter() - t0
    steps = wg.STEPS.steps
    with torch.inference_mode():
        mel = featurize_batch(torch.from_numpy(wavs).cuda(), bundle.config.frontend)
        fused0 = wg.generate(bundle, mel, DecodeConfig(strategy="beam", beam_size=K,
                                                       max_decode_len=max_len,
                                                       lm_path=str(lm_path), lm_weight=0.0))
        one = wg.beam_generate(model, mel, 1, max_len, 1.0, prompt, eot,
                               suppress_ids=w.suppress_ids, begin_suppress_ids=w.begin_suppress_ids)
        greedy = wg.greedy_generate(model, mel, max_len, prompt, eot,
                                    suppress_ids=w.suppress_ids,
                                    begin_suppress_ids=w.begin_suppress_ids)
    rec = {"rows": B, "beam": K, "max_len": max_len, "steps": steps, "seconds": seconds,
           "ms_per_step_incl_encoder": 1e3 * seconds / steps, "lengths": lens.tolist(),
           "launches": launches,
           "determinism_lm_weight_0_run_equals_first": all(
               torch.equal(a, b) for a, b in zip(fused0, (ids, lens))),
           "beam_of_one_equals_greedy": all(torch.equal(a, b) for a, b in zip(one, greedy))}
    emit({"phase": "whisper", "beam": rec})
    check(steps == captured_steps(max_len, len(prompt))
          and launches["K9"] == 2 * w.decoder_layers * steps,
          f"whisper beam: {steps} steps, K9 launched {launches['K9']} times")
    check(rec["determinism_lm_weight_0_run_equals_first"] and rec["beam_of_one_equals_greedy"],
          f"whisper beam: {rec}")
    return launches


def phase_whisper_timing(bundle):
    """Encoder seconds per B=16 x 30 s batch (and the kernel path's peak
    device memory) and decode ms per step / tokens/s at B=16 (DECODE_TURNS),
    then K5, K3c, K2h-out, K9 (cross and self caches) and
    K6 at this shape alone, with bounds and library times."""
    import torch

    from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch
    from jiao_liao_speech_recognition_torch.ops import decode_attention as da
    from jiao_liao_speech_recognition_torch.ops import flash_attention as fl
    from jiao_liao_speech_recognition_torch.ops import fused_attention, fused_mlp
    from jiao_liao_speech_recognition_torch.utils.timing import cycling

    model, w, fe = bundle.model, bundle.config.whisper, bundle.config.frontend
    B, T, d, H = WHISPER_B, WHISPER_T, w.d_model, w.num_heads
    dh = d // H
    prompt, eot = wg.resolve_specials(w)
    rng = np.random.RandomState(7)
    with torch.inference_mode():
        wav = torch.from_numpy((0.1 * rng.randn(B, 30 * SAMPLE_RATE)).astype(np.float32)).cuda()
        feats = featurize_batch(wav, fe)
        enc = {}
        secs = {True: [], False: []}
        for kernels in (False, True):  # warm both paths
            enc[kernels] = model.encode(feats, kernels)
        for kernels in (False, True, True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.encode(feats, kernels)
            torch.cuda.synchronize()
            secs[kernels].append(time.perf_counter() - t0)
        # peak device memory of one kernel-path call (the process's weights
        # and inputs included), which holds LN(x) and the MLP's hidden
        # tensor as scratch
        torch.cuda.reset_peak_memory_stats()
        model.encode(feats, True)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # greedy_from_enc builds the caches first (the cross K/V projection
        # of every decoder block, the same on both paths): timed apart and
        # taken out of the per-step figure
        init_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.init_cache(B, enc[True], WHISPER_TIMED_LEN)
            torch.cuda.synchronize()
            init_s.append(time.perf_counter() - t0)
        init_cache_s = statistics.median(init_s)
        # eager steps (graph=False), the readings earlier PRs kept; the
        # captured loop's reading beside them (phase 23 reads it at 224)
        dec = {True: [], False: [], "graph": []}
        for kernels in (*DECODE_TURNS, "graph"):
            wg.STEPS.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, lens = wg.greedy_from_enc(model, enc[True], None, WHISPER_TIMED_LEN, prompt, eot,
                                           kernels=bool(kernels), graph=kernels == "graph")
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            dec[kernels].append((s, wg.STEPS.steps, int((lens + 1).clamp(max=ids.shape[1]).sum())))
    out = {"encoder_s_per_batch": {"kernels": statistics.median(secs[True]),
                                   "plain": statistics.median(secs[False]),
                                   "samples_kernels": secs[True], "samples_plain": secs[False]},
           "encoder_peak_gb_kernels": peak_gb}
    out["init_cache_s"] = {"median": init_cache_s, "samples": init_s}
    for kernels, name in ((True, "kernels"), (False, "plain"), ("graph", "kernels_graph")):
        runs = dec[kernels]
        out[f"decode_{name}"] = {
            "ms_per_step": statistics.median(1e3 * (s - init_cache_s) / n for s, n, _ in runs),
            "ms_per_step_incl_init_cache": statistics.median(1e3 * s / n for s, n, _ in runs),
            "tokens_per_s": statistics.median(B * n / s for s, n, _ in runs),
            "steps": [n for _, n, _ in runs], "seconds": [s for s, _, _ in runs],
            "generated_incl_eot": [g for _, _, g in runs]}
    emit({"phase": "timing", "whisper": f"B={B} x 30 s, max_len {WHISPER_TIMED_LEN}",
          "note": "random init rarely emits EOT, so every row decodes ~max_len tokens; "
                  "ms_per_step leaves out building the caches, tokens_per_s includes it; "
                  "decode_kernels / decode_plain step eagerly (graph=False), "
                  "decode_kernels_graph replays the captured loop (its capture included)",
          **out})

    blk = model.encoder.blocks[0]
    sa, ln1, ln2, m = blk.self_attn, blk.self_attn_ln, blk.mlp_ln, blk.mlp
    bf = torch.bfloat16
    x = torch.from_numpy(rng.randn(B, T, d).astype(np.float32)).cuda().to(bf)
    with torch.inference_mode():
        qkv_args = (x, ln1.scale, ln1.bias, *sa.qkv_weights(bf))
        out_args = (x, torch.from_numpy(rng.randn(B, T, d).astype(np.float32)).cuda().to(bf),
                    *sa.out_proj.weights(bf))
        # the serving copies (bf16), as the encoder passes them
        mlp_args = (x, ln2.scale, ln2.bias, *m.fc1.weights(bf), *m.fc2.weights(bf), 1e-5, "erf")
    q, k, v, kl, _ = _flash_inputs(rng, B, T, H, dh, [T] * B, "cuda")
    tk_cross, tk_self = da.round_tk(T), da.round_tk(WHISPER_MAX_LEN)
    qh = torch.from_numpy(rng.randn(B, H, 1, dh).astype(np.float32)).cuda().to(bf)
    # distinct (k, v) caches whose bytes exceed the L2 twice, cycled: a
    # decode step streams 0.9 GB between two reads of one layer's cache
    caches = {tk: [[torch.from_numpy(rng.randn(B, H, tk, dh).astype(np.float32)).cuda().to(bf)
                    for _ in range(2)]
                   for _ in range(max(2, math.ceil(2 * L2_BYTES / (4 * B * H * tk * dh))))]
              for tk in (tk_cross, tk_self)}
    lens9 = {tk_cross: torch.full((B,), T, dtype=torch.int32, device="cuda"),
             tk_self: torch.from_numpy(rng.randint(0, WHISPER_MAX_LEN, B) + 1).int().cuda()}

    def k9(tk):
        return (cycling(lambda kv: da.grouped_decode_attention(qh, *kv, lens9[tk]), caches[tk]),
                cycling(lambda kv: da.decode_attention_plain(qh, *kv, lens9[tk]), caches[tk]))

    def sdpa9(tk):  # the library yardstick: a boolean key mask per row
        calls = [_yardsticks().sdpa_decode(qh, *kv, lens9[tk]) for kv in caches[tk]]
        return cuda_ms(cycling(lambda call: call(), calls), 10)

    pairs = {
        "K5": (lambda: fused_mlp.fused_ln_qkv(*qkv_args),
               lambda: fused_mlp.ln_qkv_plain(*qkv_args)),
        "K3c": (lambda: fused_mlp.fused_ln_mlp_residual(*mlp_args),
                lambda: fused_mlp.ln_mlp_residual_plain(*mlp_args)),
        "K2h-out": (lambda: fused_attention.out_proj_residual(*out_args),
                    lambda: fused_mlp.fc2_residual_plain(*out_args)),
        "K6-whisper": (lambda: fl.flash_forward(q, k, v, kl),
                       lambda: fl.flash_forward_plain(q, k, v, kl)),
        "K9": k9(tk_cross),
        "K9-self": k9(tk_self),
    }
    # the forward's time, queued as K6-whisper's own launches are below
    library = {"K6-whisper": _yardsticks().sdpa_ms(q, k, v, kl, q)[0]}
    # context, not K6's function: every key is valid here, so the library
    # call without a mask (its fastest form) does the same work
    sdpa_unmasked = _yardsticks().sdpa_unmasked_ms(q, k, v)
    # K2h-out: cuBLAS's product with the residual as its C operand (one call;
    # it rounds once and adds no bias, the nearest library function)
    x2, a2 = out_args[0].view(B * T, d), out_args[1].view(B * T, d)
    with torch.inference_mode():
        library.update({"K9": sdpa9(tk_cross), "K9-self": sdpa9(tk_self),
                        "K2h-out": cuda_ms(lambda: torch.addmm(x2, a2, out_args[2]), 20)})
        # context for K5 and K3c, which no one library call computes: cuBLAS's
        # products alone (addmm with the bias) on a precomputed bf16 LN(x)
        # and, for fc2, the hidden tensor
        ln_q = fused_mlp.ln_rows_plain(x, ln1.scale, ln1.bias).view(B * T, d)
        ln_m = fused_mlp.ln_rows_plain(x, ln2.scale, ln2.bias).view(B * T, d)
        h = fused_mlp.fc1_gelu_plain(ln_m, *mlp_args[3:5], "erf")
        context = {"K5": _yardsticks().qkv_products_ms(ln_q, *qkv_args[3:]),
                   "K3c": _yardsticks().mlp_products_ms(ln_m, *mlp_args[3:7], h)}
        del ln_q, ln_m, h
    act = B * T * d * 2

    def w_bytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def k9_work(tk):  # keys read: the valid prefix (all Tk for a zero length)
        n = sum(int(t) if 0 < int(t) <= tk else tk for t in lens9[tk].tolist())
        return (B * H * dh * 2 + B * H * dh * 4 + B * 4 + 2 * n * H * dh * 2,
                {"bf16": 4.0 * H * dh * n})

    work = {
        "K5": (act * 4 + w_bytes(qkv_args[1:]), {"bf16": 6.0 * B * T * d * d}),
        "K3c": (act * 2 + w_bytes(mlp_args[1:7]), {"bf16": 4.0 * B * T * d * w.mlp_dim}),
        "K2h-out": (act * 3 + w_bytes(out_args[2:]), {"bf16": 2.0 * B * T * d * d}),
        "K6-whisper": (4 * act + B * H * T * 4 + B * 4, {"bf16": 4.0 * H * dh * B * T * T}),
        "K9": k9_work(tk_cross),
        "K9-self": k9_work(tk_self),
    }
    shapes = {"K5": f"B={B}, T={T}, d={d} -> 3 x {d}",
              "K3c": f"B={B}, T={T}, d={d}, mlp {w.mlp_dim}",
              "K2h-out": f"B={B}, T={T}, d={d} -> {d}, + residual",
              "K6-whisper": f"B={B}, T={T}, {H} x {dh}",
              "K9": f"B={B}, {H} x {dh}, Tq=1, Tk={tk_cross} (cross, lengths {T})",
              "K9-self": f"B={B}, {H} x {dh}, Tq=1, Tk={tk_self} "
                         f"(self, lengths 1-{WHISPER_MAX_LEN})"}
    rec = {}
    with torch.inference_mode():
        for key, (kern, plain) in pairs.items():
            timer = (lambda f: queued_ms(f, 10)) if key == "K6-whisper" else cuda_ms
            p1, k1, k2, p2 = cuda_ms(plain, 3), timer(kern), timer(kern), cuda_ms(plain, 3)
            bound_ms, bound_by = bound(*work[key])
            rec[key] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library.get(key)}
            extra = {}
            if key in context:
                extra = {"bound_counted_tflops": tflops(work[key][1]["bf16"], rec[key]["ms"]),
                         "cublas_products_ms": context[key]}
            if key == "K6-whisper":
                extra = {"ms_events": cuda_ms(kern, 10),
                         "executed_tflops": tflops(flash_flops("fwd", B, T, [T] * B, H, dh),
                                                   rec[key]["ms"]),
                         "bound_counted_tflops": tflops(work[key][1]["bf16"], rec[key]["ms"]),
                         "sdpa_unmasked_ms": sdpa_unmasked}
            emit({"phase": "timing", "kernel": key, "shape": shapes[key], **rec[key], **extra,
                  "turns_ms": [p1, k1, k2, p2]})
    return rec


# --- main path 5: int8 Whisper large-v3 serving ---------------------------------


def _card_randn(seed: int):
    """-> randn(*shape, s=1.0): seeded normal f32 tensors made on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return lambda *shape, s=1.0: torch.randn(*shape, device="cuda", generator=gen) * s


def _int8_table(randn, V, D):
    """A [V, D] table quantized per vocab row: (q int8 [V, D], scale [V])."""
    from jiao_liao_speech_recognition_torch.ops import quant

    q, s = quant.quantize_int8(randn(V, D, s=D ** -0.5).t())
    return q.t().contiguous(), s


def phase_int8_kernels():
    """K9's int8 half, K10 and K11 against their plain versions at the int8
    path's shapes: every cache horizon its main path reads, every row count
    its runs give K10 and K11 (B=7 serving, B=8 timing, B=16) and each of
    the kernels' row-block instances (and K11 at a ragged D)."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import quant

    w = whisper_config().whisper
    randn = _card_randn(8)
    d = w.d_model
    errs = {"K9-int8": k9_cases(int8=True)}
    # jl_int8_matmul's instances: one 16-row tile (R <= 16: R=7 serving, R=8
    # timing, R=16), two (R=32), four (R=64); each with and without a bias,
    # and two launches on the same inputs bitwise equal
    for R in (1, 2, 4, 7, 8, 16, 32, 64):
        for d_in, d_out in ((d, d), (d, w.mlp_dim), (w.mlp_dim, d)):
            x = randn(R, d_in).to(torch.bfloat16)
            q, sc = quant.quantize_int8(randn(d_in, d_out, s=d_in ** -0.5))
            for bias in (None, randn(d_out, s=0.5).to(torch.bfloat16)):
                got = quant.int8_gemv(x, q, sc, bias)
                again = quant.int8_gemv(x, q, sc, bias)
                err = _ulp_check("K10", got, quant.int8_matmul_plain(x, q, sc, bias), R=R,
                                 d_in=d_in, d_out=d_out, bias=bias is not None)
                check(torch.equal(got, again), f"K10 R={R} {d_in}x{d_out}: two launches differ")
                errs["K10"] = max(errs.get("K10", 0.0), err)
    # K11's TMA kernel (D % 16 == 0) at each of its x-tile instances (R <= 8,
    # 16, 32, 64) and the main path's row counts, once on a table holding
    # every int8 value -128 .. 127; its ragged-D kernel at each of its
    # instances (R <= 16, 32, 64); each launched twice, bitwise equal
    for R, D, V, full in ((1, d, w.vocab_size, False), (7, d, w.vocab_size, False),
                          (8, d, w.vocab_size, False), (16, d, w.vocab_size, False),
                          (32, d, w.vocab_size, False), (64, d, w.vocab_size, False),
                          (16, d, w.vocab_size, True), (5, 200, 301, False),
                          (40, 200, 301, False), (64, 200, 301, False)):
        x = randn(R, D).to(torch.bfloat16)
        if full:  # every byte value in every row, scales > 0
            q = (torch.arange(V * D, device="cuda") % 256 - 128).to(torch.int8).view(V, D)
            sv = randn(V).abs() / 127 + 1e-3
        else:
            q, sv = _int8_table(randn, V, D)
        got, again = quant.int8_logits(x, q, sv), quant.int8_logits(x, q, sv)
        want = quant.int8_tied_logits_plain(x, q, sv)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        same = bool(torch.equal(got, again))
        emit({"phase": "kernels", "kernel": "K11", "R": R, "D": D, "V": V,
              "every_int8_value": full, "max_abs_err": err, "rel_err": rel,
              "bar_rel": LOGITS_REL_BAR, "bitwise_repeat": same})
        check(rel <= LOGITS_REL_BAR, f"K11 R={R} D={D} off by {rel} of max |logit|")
        check(same, f"K11 R={R} D={D}: two launches differ")
        errs["K11"] = max(errs.get("K11", 0.0), err)
    return errs


def forced_logits(model, toks, enc, kernels, layout=None):
    """The decoder's steps fed `toks` [B, L] (teacher forcing through the
    cached decode path; caches in `layout`, init_cache's) -> f32 logits
    [B, L - 1, V]."""
    import torch

    caches = model.init_cache(toks.shape[0], enc, toks.shape[1], layout)
    out = []
    for pos in range(toks.shape[1] - 1):
        logits, caches = model.decode_step(toks[:, pos:pos + 1], pos, enc, caches, None, kernels)
        out.append(logits.float())
    return torch.stack(out, 1)


def phase_whisper_int8(counters, bundle):
    """bundle.quantize() + api.transcribe of the six requests (exact launch
    counts a step), greedy_from_enc at B=16; the generated tokens through
    the plain int8 decoder's steps (margin rule); int8 against bf16 logits."""
    import torch

    from jiao_liao_speech_recognition_torch import api
    from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch

    w, fe = bundle.config.whisper, bundle.config.frontend
    t0 = time.perf_counter()
    qb = bundle.quantize()
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    qmodel = qb.model
    int8_bytes = sum(b.numel() * b.element_size() for b in qmodel.decoder.buffers())
    requests = make_requests()
    wg.STEPS.reset()
    t0 = time.perf_counter()
    (texts, (ids, lens)), launches = drive(counters, "whisper_int8_serve", lambda: (
        with_generated_ids(lambda: api.transcribe(qb, requests))))
    seconds = time.perf_counter() - t0
    steps, L = wg.STEPS.steps, w.decoder_layers
    emit({"phase": "int8", "quantize_s": quantize_s, "decoder_int8_buffer_bytes": int8_bytes,
          "text_chars": [len(s) for s in texts], "seconds": seconds, "decode_steps": steps,
          "launches": launches})
    check(len(texts) == len(requests) and sum(len(s) for s in texts) > 0,
          "one non-empty transcript per request")
    want = {"K1": 1, "K5": w.encoder_layers, "K6": w.encoder_layers,
            "K2h-out": w.encoder_layers, "K3c": w.encoder_layers, "K2": 0, "K3": 0,
            "K9-int8": L * steps, "K9": L * steps, "K10": 8 * L * steps, "K11": steps,
            "KVW": 0}  # bf16 self caches below B=16
    wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    check(not wrong, f"int8 serving launch counts (got, want): {wrong}")

    prompt, eot = wg.resolve_specials(w)
    always, begin = wg.suppression_masks(w.vocab_size, w.suppress_ids, w.begin_suppress_ids,
                                         "cuda")
    rng = np.random.RandomState(9)
    wavs, _, _ = bundle._prepare_audio_chunked(requests, None)
    with torch.inference_mode():
        enc = qmodel.encode(featurize_batch(torch.from_numpy(wavs).cuda(), fe))
        P = len(prompt)
        toks = torch.cat([torch.tensor(prompt, device="cuda").expand(ids.shape[0], P), ids], 1)
        raw = forced_logits(qmodel, toks, enc, kernels=False)
        # greedy's suppression, position by position, before its argmax
        plain = torch.stack([wg.apply_suppression(raw[:, p], p, P, always, begin)
                             for p in range(raw.shape[1])], 1)
        bf16 = bundle.model.decode(toks[:, :-1], enc).float()
        wav16 = torch.from_numpy((0.1 * rng.randn(16, 30 * SAMPLE_RATE)).astype(np.float32)).cuda()
        enc16 = qmodel.encode(featurize_batch(wav16, fe))
        wg.STEPS.reset()
        (_, _), launches16 = drive(counters, "whisper_int8_b16", lambda: wg.greedy_from_enc(
            qmodel, enc16, None, INT8_B16_COUNT_LEN, prompt, eot))
        steps16 = wg.STEPS.steps
        torch.cuda.synchronize()
    pos = torch.arange(toks.shape[1] - 1, device="cuda")[None, :]
    n_pred = torch.clamp(lens + 1, max=ids.shape[1])
    scored = (pos >= P - 1) & (pos < P - 1 + n_pred[:, None])
    clear = scored & (margins(plain) > ARGMAX_MARGIN)
    coverage = float(clear.sum() / scored.sum())
    mismatch = int(((plain.argmax(-1) != toks[:, 1:]) & clear).sum())
    sel_i8, sel_bf = raw[scored].double(), bf16[scored].double()
    agree_bf16 = float((sel_i8.argmax(-1) == sel_bf.argmax(-1)).float().mean())
    cosine = float((sel_i8 * sel_bf).sum() / (sel_i8.norm() * sel_bf.norm()))
    emit({"phase": "int8", "vs_plain": {
        "generated_lengths": [int(n) for n in lens], "positions": int(scored.sum()),
        "coverage": coverage, "margin": ARGMAX_MARGIN, "mismatched_positions": mismatch,
        "logits_finite": bool(torch.isfinite(raw).all())},
        "int8_vs_bf16_report": {"top1_agreement": agree_bf16, "logit_cosine": cosine,
                                "note": "random init: reported, not held to a bar"},
        "b16": {"steps": steps16, "launches": launches16}})
    check(bool(torch.isfinite(raw).all()) and tuple(raw.shape) == (
        ids.shape[0], toks.shape[1] - 1, w.vocab_size), "plain int8 logits not finite [N, L, V]")
    check(coverage >= MIN_COVERAGE and mismatch == 0,
          f"int8 tokens disagree with the plain int8 decoder ({mismatch}, coverage {coverage})")
    want16 = {"K9-int8": 2 * L * steps16, "K9": 0, "K10": 8 * L * steps16, "K11": steps16,
              "KVW": L * steps16}
    wrong = {k: (launches16[k], n) for k, n in want16.items() if launches16[k] != n}
    check(not wrong, f"B=16 int8 launch counts (got, want): {wrong}")
    return {"whisper_int8_serve": launches, "whisper_int8_b16": launches16}, qb


def phase_int8_timing(qbundle):
    """Int8 decode ms per step and tokens/s at B=16 (WHISPER_TIMED_LEN steps)
    and B=8 (max_len 64) in DECODE_TURNS, caches timed apart, peak device
    memory."""
    import torch

    from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch

    model, w, fe = qbundle.model, qbundle.config.whisper, qbundle.config.frontend
    prompt, eot = wg.resolve_specials(w)
    rng = np.random.RandomState(10)
    for B, max_len in ((WHISPER_B, WHISPER_TIMED_LEN), INT8_BENCH):
        with torch.inference_mode():
            wav = torch.from_numpy((0.1 * rng.randn(B, 30 * SAMPLE_RATE)).astype(np.float32))
            enc = model.encode(featurize_batch(wav.cuda(), fe))
            init_s = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.init_cache(B, enc, max_len)
                torch.cuda.synchronize()
                init_s.append(time.perf_counter() - t0)
            init_cache_s = statistics.median(init_s)
            wg.greedy_from_enc(model, enc, None, 8, prompt, eot, graph=False)  # warm
            runs = {True: [], False: []}
            for kernels in DECODE_TURNS:
                wg.STEPS.reset()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                ids, lens = wg.greedy_from_enc(model, enc, None, max_len, prompt, eot,
                                               kernels=kernels, graph=False)
                torch.cuda.synchronize()
                s = time.perf_counter() - t0
                runs[kernels].append((s, wg.STEPS.steps, torch.cuda.max_memory_allocated()))
        out = {"init_cache_s": {"median": init_cache_s, "samples": init_s}}
        for kernels, name in ((True, "kernels"), (False, "plain")):
            r = runs[kernels]
            out[f"decode_{name}"] = {
                "ms_per_step": statistics.median(1e3 * (s - init_cache_s) / n for s, n, _ in r),
                "tokens_per_s": statistics.median(B * n / s for s, n, _ in r),
                "steps": [n for _, n, _ in r], "seconds": [s for s, _, _ in r],
                "peak_hbm_gb": max(m for _, _, m in r) / 1e9}
        emit({"phase": "timing", "whisper_int8": f"B={B} x 30 s, max_len {max_len}",
              "note": "eager steps (graph=False; phase 23 reads the captured loop); "
                      "ms_per_step leaves out building the caches, tokens_per_s includes it; "
                      "peak_hbm_gb: torch.cuda.max_memory_allocated over the decode call, "
                      "the process's weights included", **out})
        del enc


# device ms of each row of examples/torch_profile_decode_kernels.py on the
# kernels K9 and K11 replaced (I2F conversions; K11 a block a 256-row slice),
# timed the same way on an H100 80GB HBM3 at 700 W (PERF.md, section 6)
DECODE_PROFILE_ITERS = 10  # timed calls of each kernel in the decode profiler
PARENT_DECODE_MS = {"K9 cross": 0.04448, "K9-int8 cross": 0.03534, "K9 self": 0.00720,
                    "K9-int8 self": 0.00739, "K11": 0.05131}


def phase_int8_kernel_timing():
    """K9's four instances (bf16 and int8 caches, cross and self) and K11
    alone by device time, each cycling through inputs that exceed twice the
    L2 (examples/torch_profile_decode_kernels.py), beside its bound, its
    library call and the parent's reading; then K10 alone (device time,
    weights cycled the same way) beside cuBLAS's bf16 product, each kernel
    also by queued_ms, the CUDA-event timing that device_ms falls back on
    when the profiler sees nothing."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import quant

    # in a process of its own: late in this one the profiler stops seeing
    # the device and device_ms falls back on queued_ms, ~1.5 us a launch high
    script = Path(__file__).resolve().parent / "examples" / "torch_profile_decode_kernels.py"
    run = subprocess.run([sys.executable, str(script), "--iters", str(DECODE_PROFILE_ITERS)],
                         capture_output=True, text=True,
                         check=True, timeout=900)
    rows = {r.pop("row"): r for r in (json.loads(line) for line in run.stdout.splitlines()
                                      if line.startswith('{"row"'))}
    check(len(rows) == 5, f"decode profiler rows: {sorted(rows)}")
    for name, row in rows.items():
        emit({"phase": "timing", "kernel": name, **row,
              "parent_ms": PARENT_DECODE_MS[name],
              "parent": "the replaced kernels, timed the same way (PERF.md)"})
    w = whisper_config().whisper
    bf = torch.bfloat16
    randn = _card_randn(11)
    B, d = WHISPER_B, w.d_model

    def cycle(fns):  # one call of each in turn
        it = itertools.cycle(fns)
        return lambda: next(it)()

    x = {n: randn(B, n).to(bf) for n in (d, w.mlp_dim)}
    # a decode step streams 0.9 GB between two reads of one K10 weight, so
    # each K10 timing cycles through enough copies to exceed the L2 twice;
    # K10 with a bias, as 224 of a step's 256 launches (k_proj has none)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rec = {key: {k: rows[name][k] for k in keys}
           for key, name in (("K9", "K9 cross"), ("K9-int8", "K9-int8 cross"), ("K11", "K11"))}
    with torch.inference_mode():
        for d_in, d_out in ((d, d), (d, w.mlp_dim), (w.mlp_dim, d)):
            sets = [quant.quantize_int8(randn(d_in, d_out, s=d_in ** -0.5))
                    for _ in range(math.ceil(2 * L2_BYTES / (d_in * d_out)))]
            wb = [(q.float() * sc).to(bf) for q, sc in sets]
            xi, bi = x[d_in], randn(d_out, s=0.5).to(bf)
            kern = cycle([lambda q=q, sc=sc: quant.int8_gemv(xi, q, sc, bi) for q, sc in sets])
            plain = cycle([lambda q=q, sc=sc: quant.int8_matmul_plain(xi, q, sc, bi)
                           for q, sc in sets])
            lib = cycle([lambda w2=w2: torch.matmul(xi, w2) for w2 in wb])
            turns = [device_ms(plain, 5), device_ms(kern), device_ms(kern), device_ms(plain, 5)]
            bound_ms, bound_by = bound(d_in * d_out + d_out * 6 + 2 * B * (d_in + d_out),
                                       {"bf16": 2.0 * B * d_in * d_out})
            row = {"ms": (turns[1] + turns[2]) / 2, "plain_ms": (turns[0] + turns[3]) / 2,
                   "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": device_ms(lib)}
            emit({"phase": "timing", "kernel": f"K10 {d_in}x{d_out}", "B": B, **row,
                  "turns_ms": turns, "ms_with_dispatch": cuda_ms(kern, 50),
                  "ms_queued": queued_ms(kern), "library": "cuBLAS bf16 matmul, same shape"})
            if d_in == d_out:  # the table's K10 row: six of a block's eight launches
                rec["K10"] = row
    return rec


# --- main path 6: the A/B probes of examples/ -----------------------------------


def _w8a8_stage_checks(p, x, scratch, got, eps, form, **info):
    """P4's launches held to the plain version's arithmetic stage by stage,
    each bit for bit: its LN codes and scales against the plain LN's (the
    kernel sums the row statistics in PyTorch's order); the hidden amax and
    codes against the plain fc1 stage run on the kernel's own LN codes and
    scales; the output against the plain fc2 stage on the kernel's own
    hidden codes -> the counts of differing values."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import fused_mlp, probes
    from jiao_liao_speech_recognition_torch.ops.quant import quantize_int8

    (w1q, s1), (w2q, s2) = quantize_int8(p["w1"]), quantize_int8(p["w2"])
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    ln = (xc * torch.rsqrt(var + eps)) * p["g"] + p["bl"]
    lq, a_s = probes._quantize_rows(ln)
    got_lq, got_as = scratch["ln_codes"], scratch["ln_scale"]
    lq_diff = int((got_lq.float() != lq).sum())
    lq_max = int((got_lq.float() - lq).abs().max())
    scale_diff = int((got_as != a_s[:, 0]).sum())
    # the plain fc1 stage on the kernel's LN codes and scales
    h = probes._int_product(got_lq.float(), w1q) * (got_as[:, None] * s1) + p["b1"]
    gl = fused_mlp.gelu_f32(h, form)
    hq, _ = probes._quantize_rows(gl)
    amax_diff = int((scratch["hidden_amax"] != gl.abs().amax(-1)).sum())
    hq_diff = int((scratch["hidden_codes"].float() != hq).sum())
    # the plain fc2 stage on the kernel's hidden codes
    h_s_got = scratch["hidden_amax"][:, None] / 127.0
    y = probes._int_product(scratch["hidden_codes"].float(), w2q) * (h_s_got * s2) + p["b2"]
    out = (x.reshape(-1, d) + y.to(x.dtype)).view_as(x)
    out_diff = int((out != got).sum())
    counts = {"ln_codes_differing": lq_diff, "ln_codes_max_step": lq_max,
              "ln_scales_differing": scale_diff, "hidden_amax_differing": amax_diff,
              "hidden_codes_differing_on_its_ln_codes": hq_diff,
              "out_differing_on_its_hidden_codes": out_diff, "rows": lq.shape[0],
              "ln_codes": lq.numel(), "hidden_codes": hq.numel()}
    emit({"phase": "kernels", "kernel": "P4", **info, "stages": counts})
    check(lq_diff == 0 and scale_diff == 0,
          f"P4 {info}: LN codes or scales differ from the plain LN's {counts}")
    check(amax_diff == 0 and hq_diff == 0,
          f"P4 {info}: hidden amax or codes differ from the plain fc1 stage on its LN codes "
          f"{counts}")
    check(out_diff == 0, f"P4 {info}: the output differs from the plain fc2 stage {counts}")
    return counts


def _w8a8_case(d: int, mlp: int, gelu_form: str, seed: int = 13):
    """P4 at width d, hidden width mlp: the probe's parameter scales drawn
    on the card from ``seed``, x bf16 [3, 347, d] (1,041 rows: a ragged last
    row tile) -> (p, x, call(x, kernels=True, scratch=None))."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import probes
    from jiao_liao_speech_recognition_torch.ops.quant import quantize_int8

    randn = _card_randn(seed)
    p = {"g": 1.0 + randn(d, s=0.1), "bl": randn(d, s=0.05), "w1": randn(d, mlp, s=d ** -0.5),
         "b1": randn(mlp, s=0.02), "w2": randn(mlp, d, s=mlp ** -0.5), "b2": randn(d, s=0.02)}
    x = randn(3, 347, d, s=0.5).to(torch.bfloat16)
    (w1q, s1), (w2q, s2) = quantize_int8(p["w1"]), quantize_int8(p["w2"])
    ops = probes.w8a8_operands(w1q, s1, p["b1"], w2q, s2, p["b2"])

    def call(x, kernels=True, scratch=None):
        return probes.w8a8_ln_mlp_residual(x, p["g"], p["bl"], ops, 1e-5, gelu_form,
                                           kernels=kernels, scratch=scratch)

    return p, x, call


def phase_probe_kernels():
    """P4, P1 and P2 against their plain versions at the flagship's shapes:
    P4 at B=32, T'=750 and P1 at 32 x 30 s on their profilers' seeded
    inputs, each launched twice and bitwise equal (P4 also stage by stage,
    _w8a8_stage_checks, and so again at P4_CASES' widths and GELU forms on
    1,041 rows; P1 and K1 also against an f64 log-mel, printed);
    P2 at B=32, T'=750, V=4336 on K4's check's inputs (logits of O(1), so
    most frames clear the margin), held to K4's ids everywhere."""
    import torch

    from jiao_liao_speech_recognition_torch import _build
    from jiao_liao_speech_recognition_torch.frontend import fused_frontend
    from jiao_liao_speech_recognition_torch.frontend.features import normalize_log_mel
    from jiao_liao_speech_recognition_torch.ops import fused_head, probes
    from jiao_liao_speech_recognition_torch.utils.config import FrontendConfig

    errs = {}
    with torch.inference_mode():
        w8 = _example(PROBES["P4"][0])
        p, xs = w8.make_inputs(32, 750)
        _, w8a8 = w8.sublayers(p)
        scratch = {}
        got = w8a8(xs[0], scratch=scratch)
        errs["P4"] = _ulp_check("P4", got, w8a8(xs[0], kernels=False), B=32, T=750)
        _w8a8_stage_checks(p, xs[0], scratch, got, w8.EPS, w8.GELU_FORM)
        check(torch.equal(w8a8(xs[0]), got), "P4: two launches differ")
        for d, mlp, form in P4_CASES:
            info = {"d": d, "mlp": mlp, "gelu_form": form}
            p4p, x4, call = _w8a8_case(d, mlp, form)
            scratch = {}
            got4 = call(x4, scratch=scratch)
            _ulp_check("P4", got4, call(x4, kernels=False), rows=x4.shape[0] * x4.shape[1],
                       **info)
            _w8a8_stage_checks(p4p, x4, scratch, got4, 1e-5, form, **info)
            check(torch.equal(call(x4), got4), f"P4 {info}: two launches differ")
        # a width its LN row pass does not take: the C entry point refuses it
        # before any launch and leaves no error behind for the next launch
        d2 = 2176
        try:
            _build.launch("jl_w8a8_ln_mlp_residual", *[got.data_ptr()] * 14, 16, d2, d2,
                          0, 1e-5)
            refused = False
        except RuntimeError:
            refused = True
        check(refused, f"P4 launched at d={d2}, over the LN row pass's width")
        check(torch.equal(w8a8(xs[0]), got), "P4 differs after a refused launch")
        emit({"phase": "kernels", "kernel": "P4", "refused": f"d={d2}", "bitwise_repeat": True})

        fe = FrontendConfig()
        wav = _example(PROBES["P1"][0]).make_inputs(32, 30.0)[0]
        raw = probes.log_mel_bf16x3_raw(wav)
        got = normalize_log_mel(raw, fe)
        want = normalize_log_mel(probes.log_mel_bf16x3_raw(wav, kernels=False), fe)
        repeat = bool(torch.equal(probes.log_mel_bf16x3_raw(wav), raw))
        f64 = normalize_log_mel(log_mel_f64(wav, fe), fe)
        k1 = normalize_log_mel(fused_frontend.fused_log_mel_raw(wav), fe)
        torch.cuda.synchronize()
        errs["P1"] = float((got - want).abs().max())
        emit({"phase": "kernels", "kernel": "P1", "shape": list(wav.shape),
              "max_abs_err": errs["P1"], "bar": LOGMEL_BAR, "bitwise_repeat": repeat,
              "p1_vs_f64": float((got - f64).abs().max()),
              "p1_plain_vs_f64": float((want - f64).abs().max()),
              "k1_vs_f64": float((k1 - f64).abs().max())})
        check(errs["P1"] <= LOGMEL_BAR, f"P1 log-mel error {errs['P1']} > {LOGMEL_BAR}")
        check(repeat, "P1: two launches differ")
        # the precision half of P1's A/B on phase 3's K1 rows (deep valleys)
        rows = torch.from_numpy(k1_rows(np.random.RandomState(0))).cuda()
        f64 = normalize_log_mel(log_mel_f64(rows, fe), fe)
        p1 = normalize_log_mel(probes.log_mel_bf16x3_raw(rows), fe)
        emit({"phase": "kernels", "kernel": "P1", "shape": list(rows.shape),
              "rows": "k1_rows (tones, quiet rows)",
              "p1_vs_plain": float((p1 - normalize_log_mel(
                  probes.log_mel_bf16x3_raw(rows, kernels=False), fe)).abs().max()),
              "p1_vs_f64": float((p1 - f64).abs().max()),
              "k1_vs_f64": float((normalize_log_mel(fused_frontend.fused_log_mel_raw(rows), fe)
                                  - f64).abs().max())})

        randn = _card_randn(12)
        B, T, d, V = 32, 750, 512, 4336
        x = randn(B, T, d).to(torch.bfloat16)
        w, b = randn(d, V, s=d ** -0.5), randn(V, s=0.1)
        errs["P2"], got = head_ids_check(probes.head_argmax_chunked, "P2", x, w, b,
                                         B=B, T=T, d=d, V=V)
        k4_mismatch = int((got != fused_head.fused_head_argmax(x, w, b)).sum())
        repeat = bool(torch.equal(got, probes.head_argmax_chunked(x, w, b)))
        emit({"phase": "kernels", "kernel": "P2", "frames_differing_from_K4": k4_mismatch,
              "bitwise_repeat": repeat})
        check(k4_mismatch == 0, f"P2 ids differ from K4's on {k4_mismatch} frames")
        check(repeat, "P2: two launches differ")
        head_ties_check(probes.head_argmax_chunked, "P2", x[:4], w, b)
    return errs


def phase_probes(counters):
    """Main path 6: each probe's profiler, main() at the flagship's B=32
    (PROBES), with every launch count at 0 just before and read just after;
    each runs its probe beside its partner and prints its A/B report."""
    reports = {}

    def run():
        for key, (script, argv) in PROBES.items():
            reports[key] = _example(script).main(argv)

    _, launches = drive(counters, "probes", run)
    for key, report in reports.items():
        emit({"phase": "probes", "probe": key, "script": f"examples/{PROBES[key][0]}.py",
              **report})
    check(all(math.isfinite(v) for r in reports.values() for v in r.values()
              if isinstance(v, float)), "a probe's report is not finite")
    check(reports["P2"]["id_mismatches"] == 0, "P2's ids differ from K4's in its profiler")
    return launches


def phase_probe_timing():
    """P4, P1 and P2 alone (device time; turns: plain, kernel, kernel,
    plain) beside their bounds and the partner each is measured against (K3,
    K1, K4 on the same inputs, with its bound), at the profilers' shapes at
    B=32; then the two-call library context (torch._int_mm pair, addmm +
    argmax), printed apart from library_ms."""
    import torch

    from jiao_liao_speech_recognition_torch.frontend import fused_frontend
    from jiao_liao_speech_recognition_torch.ops import fused_head, probes
    from jiao_liao_speech_recognition_torch.utils.timing import cycling

    w8 = _example(PROBES["P4"][0])
    p, xs = w8.make_inputs(32, 750)
    bf16, w8a8 = w8.sublayers(p)
    wavs = _example(PROBES["P1"][0]).make_inputs(32, 30.0)
    hxs, w, bias = _example(PROBES["P2"][0]).make_inputs(32, 750, 4336)
    pairs = {  # probe: (kernel, plain version, partner), each over two distinct inputs
        "P4": (cycling(w8a8, xs), cycling(lambda x: w8a8(x, kernels=False), xs),
               cycling(bf16, xs)),
        "P1": (cycling(probes.log_mel_bf16x3_raw, wavs),
               cycling(lambda a: probes.log_mel_bf16x3_raw(a, kernels=False), wavs),
               cycling(fused_frontend.fused_log_mel_raw, wavs)),
        "P2": (cycling(lambda x: probes.head_argmax_chunked(x, w, bias), hxs),
               cycling(lambda x: fused_head.head_argmax_plain(x, w, bias), hxs),
               cycling(lambda x: fused_head.fused_head_argmax(x, w, bias), hxs)),
    }
    M, d, mlp, V = 32 * 750, w8.D, w8.MLP, w.shape[1]
    B, L = wavs[0].shape
    n_fft, mels = 400, 80
    frames, freqs = L // 160, n_fft // 2 + 1
    mlp_bytes = 2 * M * d * 2 + (4 * d + 2 * mlp) * 4
    logmel_bytes = B * L * 4 + B * mels * frames * 4 + n_fft * 2 * freqs * 4 + mels * freqs * 4
    head = (M * d * 2 + d * V * 2 + V * 4 + M * 4, {"bf16": 2.0 * M * d * V})
    # the mel product over each filter's band (its nonzero columns), as both
    # instances of the kernel run it
    bands = fused_frontend._kernel_constants(n_fft, mels, "slaney", "cuda")[3]
    mel_ops = B * frames * (3.0 * freqs + 2.0 * int((bands[:, 1] - bands[:, 0]).sum()))
    work = {  # probe: (its work, its partner's), as (bytes, {type: operations})
        "P4": ((mlp_bytes + 2 * d * mlp, {"int8": 4.0 * M * d * mlp}),
               (mlp_bytes + 4 * d * mlp, {"bf16": 4.0 * M * d * mlp})),
        "P1": ((logmel_bytes, {"bf16": 3.0 * B * frames * 2 * n_fft * 2 * freqs, "f32": mel_ops}),
               (logmel_bytes, {"tf32": 3.0 * B * frames * 2 * n_fft * 2 * freqs,
                               "f32": mel_ops})),
        "P2": (head, head),
    }
    partner = {"P4": "K3", "P1": "K1", "P2": "K4"}
    rec = {}
    with torch.inference_mode():
        for key, (kern, plain, other) in pairs.items():
            turns = [device_ms(plain, 5), device_ms(kern), device_ms(kern), device_ms(plain, 5)]
            bound_ms, bound_by = bound(*work[key][0])
            rec[key] = {"ms": (turns[1] + turns[2]) / 2, "plain_ms": (turns[0] + turns[3]) / 2,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
            emit({"phase": "timing", "kernel": key, "shape": PROBES[key][1], **rec[key],
                  "turns_ms": turns, "partner": partner[key], "partner_ms": device_ms(other),
                  "partner_bound_ms": bound(*work[key][1])[0]})
        yard = _yardsticks()
        codes = [torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda")
                 for shape in ((M, d), (d, mlp), (M, mlp), (mlp, d))]
        x2 = hxs[0].reshape(M, d)
        emit({"phase": "timing", "library_context": "two library calls each, not library_ms",
              "P4_int_mm_pair_ms": yard.int_mm_pair_ms(*codes),
              "K4_P2_addmm_argmax_ms": yard.addmm_argmax_ms(x2, w, bias.to(torch.bfloat16))})
    return rec


# --- main path 10: Whisper continuous-batching serving (serve/engine.py) -----


def engine_windows():
    """ENGINE_WINDOWS windows of tone + noise: the six requests' seven 30 s
    windows, then seeded ones of 1-30 s."""
    window = 30 * SAMPLE_RATE
    windows = [r[s:s + window] for r in make_requests() for s in range(0, len(r), window)]
    rng = np.random.RandomState(15)
    while len(windows) < ENGINE_WINDOWS:
        t = np.arange(int(rng.uniform(1.0, 30.0) * SAMPLE_RATE)) / SAMPLE_RATE
        f = rng.uniform(150.0, 2000.0)
        windows.append((0.2 * np.sin(2 * np.pi * f * t) * np.sin(2 * np.pi * 0.5 * t)
                        + 0.05 * rng.randn(len(t))).astype(np.float32))
    return windows


def graph_against_eager(eng, counters):
    """One dispatch replayed from the engine's graph against the eager step
    from the same saved state: tokens, positions and done flags equal, the
    caches within ULP_BAR (int8 codes within one step). The run goes on
    from the graph's state; the eager step's launches are taken back off
    the counts. -> the comparison and both dispatches' seconds."""
    import torch

    state = eng._state()
    saved = [t.clone() for t in state]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    type(eng)._dispatch(eng)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    graph = [t.clone() for t in state]
    for t, s in zip(state, saved):
        t.copy_(s)
    counts = {key: c.launches for key, c in counters.items()}
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(eng.steps_per_dispatch):
            eng._step()
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
    for key, c in counters.items():
        c.launches = counts[key]
    eager = [t.clone() for t in state]
    for t, g in zip(state, graph):
        t.copy_(g)
    bookkeeping = all(torch.equal(g, e) for g, e in zip(graph[:3], eager[:3]))
    worst_ulps, worst_codes = 0.0, 0
    for g, e in zip(graph[3:], eager[3:]):
        if g.dtype == torch.int8:
            worst_codes = max(worst_codes, int((g.int() - e.int()).abs().max()))
        elif e.abs().max() > 0:
            worst_ulps = max(worst_ulps, bf16_ulp_err(g, e)[0])
    out = {"tokens_pos_done_equal": bookkeeping,
           "bitwise": all(torch.equal(g, e) for g, e in zip(graph, eager)),
           "cache_max_ulps": worst_ulps, "int8_cache_max_code_step": worst_codes,
           "bar_ulps": ULP_BAR, "lanes_active": int((~eng._done).sum()),
           "positions": sorted(set(eng._pos.tolist()))}
    check(bookkeeping, f"graph and eager dispatches disagree on tokens / pos / done: {out}")
    check(worst_ulps <= ULP_BAR and worst_codes <= 1, f"graph and eager caches differ: {out}")
    del saved, graph, eager
    return out, graph_s, eager_s


def replay_profile(eng):
    """Kernels of one graph replay by the profiler's names -> (decode
    attention, int8 matmul, int8 tied logits, all kernels) launches, or
    None without a marker. Late in a long process the profiler has missed
    a window's first kernels (the first 25 of a replay: block 0's q, k and
    v K10 launches among them; a fresh process saw them all), so a replay
    runs first as a lead-in, then a spin kernel as a marker, and only the
    kernels that start after the marker are counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng._graph.replay()
        torch.cuda._sleep(1_000_000)
        eng._graph.replay()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    marks = [e.time_range.start for e in events if "spin_kernel" in e.name]
    if not marks:
        return None
    counted = [e.name for e in events if e.time_range.start > max(marks)]

    def count(name):
        return sum(name in n for n in counted)

    return (count("decode_attention_kernel"), count("int8_matmul_kernel"),
            count("int8_tied_logits"), len(counted))


def engine_drive(eng, windows, between=None):
    """Serve `windows` in staggered waves: 8, a dispatch, 8 (then
    between(eng) once they are admitted), a dispatch, the rest, drained.
    -> (the finished requests by request id, seconds)."""
    import torch

    finished = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in windows[:8]:
        eng.submit(x, admit=False)
    finished += eng.step()
    for x in windows[8:16]:
        eng.submit(x, admit=False)
    if between is not None:
        eng._fill_free_slots()
        between(eng)
    finished += eng.step()
    for x in windows[16:]:
        eng.submit(x, admit=False)
    while eng.in_flight:
        finished += eng.step()
    torch.cuda.synchronize()
    return sorted(finished, key=lambda r: r.rid), time.perf_counter() - t0


def token_check(model, eng, finished, windows):
    """Each request's tokens teacher-forced through the plain decoder's
    cached steps (forced_logits with kernels=False, caches in the pool's
    layout: the engine's computation with every kernel's plain version),
    under the margin rule. A mismatch is listed with its plain margin and
    the kernel path's own teacher-forced token there. (Phase 8's reference,
    the whole sequence at once through model.decode, reorders the
    attention and MLP sums: on an H100 it put one of 5,280 positions on
    the other side of a two-ulp margin, where the kernel path's own steps
    at one row also flip.)"""
    import torch

    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch, pad_or_trim

    fe, P, dev = eng.cfg.frontend, len(eng.prompt), eng.device
    rows = torch.full((len(finished), WHISPER_MAX_LEN), eng.eot, dtype=torch.long, device=dev)
    rows[:, :P] = torch.tensor(eng.prompt, device=dev)
    for i, r in enumerate(finished):
        rows[i, P:P + len(r.ids)] = torch.tensor(r.ids, dtype=torch.long, device=dev)
    lens = torch.tensor([len(r.ids) for r in finished], device=dev)

    def suppressed(logits):
        if eng._always is not None:
            logits = logits + eng._always
        if eng._begin is not None:
            logits[:, P - 1] += eng._begin
        return logits

    with torch.inference_mode():
        wav = torch.from_numpy(np.stack([pad_or_trim(x, fe) for x in windows])).to(dev)
        enc = model.encode(featurize_batch(wav, fe))
        logits = suppressed(forced_logits(model, rows, enc, False, eng._layout))
        coverage, mismatch, scored, agree = margin_check(logits, rows, lens, P)
        rec = {"positions": scored, "coverage": coverage, "margin": ARGMAX_MARGIN,
               "mismatched_positions": mismatch, "agree_all_positions": agree,
               "logits_finite": bool(torch.isfinite(logits).all())}
        if mismatch:
            pos = torch.arange(rows.shape[1] - 1, device=dev)[None, :]
            bad = ((logits.argmax(-1) != rows[:, 1:]) & (margins(logits) > ARGMAX_MARGIN)
                   & (pos >= P - 1) & (pos < P + lens[:, None])).nonzero().tolist()
            sel = sorted({b for b, _ in bad})
            kern = suppressed(forced_logits(model, rows[sel], enc[sel], True, eng._layout))
            rec["mismatches"] = [{
                "request": b, "position": p, "engine_token": int(rows[b, p + 1]),
                "plain_token": int(logits[b, p].argmax()),
                "plain_margin": float(margins(logits[b, p])),
                "kernel_steps_token": int(kern[sel.index(b), p].argmax()),
                "kernel_steps_margin": float(margins(kern[sel.index(b), p]))}
                for b, p in bad]
    return rec


def phase_engine(counters, bundle, path):
    """ServingEngine at ENGINE_SLOTS lanes, ENGINE_SPD steps a dispatch, max
    len WHISPER_MAX_LEN, on `bundle` (phase 8's bf16 large-v3 or phase 9's
    quantize()d one), serving ENGINE_WINDOWS windows in staggered waves
    twice. The counted run holds one dispatch replayed from the graph
    against the eager step from the same state once the second wave is in,
    and counts launches: the admission kernels a wave exactly, the captured
    step's kernels x its replays, confirmed by the profiler's kernel names
    over one replay. The timed run (no check in it) gives ms a step,
    tokens/s, latency and peak memory. Each request's tokens are held
    against the plain decoder (the margin rule). -> (launches by kernel
    key, the engine, the report)."""
    import torch

    from jiao_liao_speech_recognition_torch.serve import ServingEngine, ServingStats

    int8 = path == "whisper_int8_engine"
    L, E = bundle.config.whisper.decoder_layers, bundle.config.whisper.encoder_layers
    windows = engine_windows()
    torch.cuda.synchronize()
    eng = ServingEngine(bundle, slots=ENGINE_SLOTS, steps_per_dispatch=ENGINE_SPD,
                        max_len=WHISPER_MAX_LEN)
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    want_step = ({"grouped_decode_attention_int8": 2 * L, "int8_matmul": 8 * L,
                  "int8_tied_logits": 1, "int8_kv_write": L} if int8
                 else {"grouped_decode_attention": 2 * L})
    check(eng.step_launches == want_step,
          f"{path}: the captured step's launches {eng.step_launches}, not {want_step}")
    held = {}

    def hold(e):
        held["vs_eager"], held["graph_s"], held["eager_s"] = graph_against_eager(e, counters)

    for c in counters.values():
        c.reset()
    finished, _ = engine_drive(eng, windows, hold)
    counted = {key: c.launches for key, c in counters.items()}
    launches = {key: counted[key] + eng.step_launches.get(c.name, 0) * eng.replays
                for key, c in counters.items()}
    waves = eng.stats.waves
    want = {"K1": waves, "K5": E * waves, "K6": E * waves, "K2h-out": E * waves,
            "K3c": E * waves, "K2": 0, "K3": 0, "K9": 0, "K9-int8": 0, "K10": 0, "K11": 0}
    wrong = {k: (counted[k], n) for k, n in want.items() if counted[k] != n}
    check(not wrong, f"{path}: launches outside the graph (got, want): {wrong}")
    missing = [key for key in PATHS[path] if launches[key] == 0]
    check(not missing, f"{path}: kernels never launched: {missing} ({launches})")
    want_names = (2 * L, 8 * L if int8 else 0, 1 if int8 else 0)
    readings = []
    for _ in range(PROFILE_ATTEMPTS):
        readings.append(replay_profile(eng))
        if readings[-1] is not None and readings[-1][:3] == want_names:
            break
    check(readings[-1] is not None and readings[-1][:3] == want_names,
          f"{path}: one replay's K9, K10, K11 (and all kernels) by name: {readings}")
    check(len(finished) == len(windows) and all(r.ids is not None for r in finished),
          f"{path}: {len(finished)} of {len(windows)} requests finished")
    check(all(r.text == bundle.tokenizer.decode(r.ids) for r in finished), "texts are the ids'")
    checked = {"replays": eng.replays, "waves": waves, "dispatches": eng.stats.dispatches,
               "launches": launches, "step_launches": eng.step_launches,
               "one_replay_kernels": readings[-1][3], "profile_readings": readings,
               "graph_vs_eager": held["vs_eager"]}

    # the timed run: the same windows and waves, nothing held in between
    dispatch_s = []

    def timed_dispatch():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        type(eng)._dispatch(eng)
        torch.cuda.synchronize()
        dispatch_s.append(time.perf_counter() - t0)

    eng._dispatch = timed_dispatch
    eng.stats = ServingStats()
    torch.cuda.reset_peak_memory_stats()
    timed, wall = engine_drive(eng, windows)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del eng._dispatch
    # one dispatch (32 replays) with 16 idle lanes
    dev_prof = device_profile(lambda i: eng._dispatch(), 1, path)
    tokens = sum(len(r.ids) + 1 for r in timed)  # with the EOT (or the last step)
    same = sum(a.ids == b.ids for a, b in zip(finished, timed))
    report = {
        "phase": "engine", "path": path, "slots": ENGINE_SLOTS,
        "steps_per_dispatch": ENGINE_SPD, "max_len": WHISPER_MAX_LEN,
        "windows_s": [round(len(x) / SAMPLE_RATE, 2) for x in windows],
        "capture_s": eng.capture_s, "checked_run": checked,
        "graph_ms_per_step_16_lanes": 1e3 * held["graph_s"] / ENGINE_SPD,
        "eager_ms_per_step_16_lanes": 1e3 * held["eager_s"] / ENGINE_SPD,
        "graph_tokens_per_s_16_lanes": 16 * ENGINE_SPD / held["graph_s"],
        "eager_tokens_per_s_16_lanes": 16 * ENGINE_SPD / held["eager_s"],
        "dispatch_ms_per_step_median": 1e3 * statistics.median(dispatch_s) / ENGINE_SPD,
        "wall_s": wall, "generated_tokens_incl_eot": tokens, "tokens_per_s": tokens / wall,
        "timed_run_same_tokens": same, "dispatches": eng.stats.dispatches,
        "latency_mean_s": eng.stats.mean_latency_s, "latency_p95_s": eng.stats.p95_latency_s,
        "latency_max_s": max(eng.stats.latencies_s), "resident_gb": resident_gb,
        "peak_gb": peak_gb, "generated_lengths": [len(r.ids) for r in timed],
        "idle_lanes_dispatch_profile": dev_prof}
    report["vs_plain"] = token_check(bundle.model, eng, finished, windows)
    emit(report)
    check(same == len(windows), f"{path}: the timed run decoded other tokens ({same} the same)")
    rec = report["vs_plain"]
    check(rec["logits_finite"], f"{path}: plain logits not finite")
    check(rec["coverage"] >= MIN_COVERAGE and rec["mismatched_positions"] == 0,
          f"{path}: tokens disagree with the plain decoder: {rec}")
    return launches, eng, report


def engine_timestamps(eng, windows):
    """Two requests served with timestamps: spans monotone, inside the
    audio, equal to whisper_token_spans on the engine's own ids, and the
    tokens concatenate to the text."""
    import torch

    from jiao_liao_speech_recognition_torch.decode.align import whisper_token_spans
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch, pad_or_trim

    fe = eng.cfg.frontend
    eng.timestamps = True
    picked = (windows[2], windows[3])  # the 7.5 s and 12 s requests: more frames than tokens
    rids = [eng.submit(x) for x in picked]
    done = {}
    while eng.in_flight:
        done.update((r.rid, r) for r in eng.step())
    eng.timestamps = False
    frame_s = fe.hop_length * 2 / SAMPLE_RATE
    out = []
    for rid, x in zip(rids, picked):
        r = done[rid]
        mel = featurize_batch(torch.from_numpy(pad_or_trim(x, fe)[None]).to(eng.device), fe)
        valid = np.asarray([len(x) // (fe.hop_length * 2)])
        spans = whisper_token_spans(eng.model, mel, np.asarray([r.ids]), np.asarray([len(r.ids)]),
                                    eng.prompt, eng.eot, valid)[0]
        want = [(round(a * frame_s, 3), round(b * frame_s, 3)) for a, b in spans]
        got = [(t["start"], t["end"]) for t in r.timed]
        monotone = all(a["end"] <= b["start"] + 1e-9 and a["start"] < a["end"]
                       for a, b in zip(r.timed, r.timed[1:]))
        inside = all(t["end"] <= len(x) / SAMPLE_RATE + 0.04 for t in r.timed)
        joined = "".join(t["token"] for t in r.timed) == r.text
        out.append({"audio_s": len(x) / SAMPLE_RATE, "tokens": len(r.timed),
                    "monotone": monotone, "inside_audio": inside, "concatenate": joined,
                    "equal_whisper_token_spans": got == want,
                    "last_end_s": r.timed[-1]["end"] if r.timed else None})
        check(len(r.timed) == len(r.ids) > 0 and monotone and inside and joined and got == want,
              f"engine timestamps: {out[-1]}")
    return out


def engine_cli(workdir: Path, windows):
    """`cli serve` of three WAVs (plain, --int8, --timestamps) on a large-v3
    random-init bundle (seed 0, max_decode_len ENGINE_CLI_LEN): one JSONL
    line a file, with latency_s, and tokens and words with --timestamps."""
    from jiao_liao_speech_recognition_torch.frontend.audio_io import write_wav
    from jiao_liao_speech_recognition_torch.utils.config import save_yaml

    cfg = whisper_config()
    cfg.decode.max_decode_len = ENGINE_CLI_LEN
    save_yaml(cfg, str(workdir / "large_v3.yaml"))
    paths = []
    for i, x in enumerate(windows[:3]):
        paths.append(str(workdir / f"r{i}.wav"))
        write_wav(paths[-1], x, SAMPLE_RATE)
    out = {}
    for flags in ([], ["--int8"], ["--timestamps"]):
        t0 = time.perf_counter()
        lines = [json.loads(s) for s in cli_run(
            ["serve", *paths, "--config", workdir / "large_v3.yaml", "--slots", "4",
             "--steps-per-dispatch", "8", *flags])]
        name = flags[0] if flags else "plain"
        out[name] = {"seconds": time.perf_counter() - t0, "lines": len(lines),
                     "text_chars": [len(r["text"]) for r in lines]}
        check(sorted(r["audio"] for r in lines) == sorted(paths), f"cli serve {flags}: lines")
        check(all(r["latency_s"] >= 0 for r in lines), f"cli serve {flags}: latency_s")
        if flags == ["--timestamps"]:
            check(all(len(r["tokens"]) > 0 and "words" in r
                      and "".join(t["token"] for t in r["tokens"]) == r["text"]
                      for r in lines), "cli serve --timestamps: tokens / words")
    return out


def phase_engines(counters, bundle, qbundle, workdir: Path, card: str):
    """Main path 10 on the bf16 bundle and on its quantize()d form, the
    timestamps and `cli serve`. (Static waves of 224 eager steps would
    repeat phases 8-9's eager decode readings: the engine is not timed
    against them here.)"""
    import torch

    by_path = {}
    windows = engine_windows()
    reports = {}
    for b, path in ((bundle, "whisper_engine"), (qbundle, "whisper_int8_engine")):
        by_path[path], eng, reports[path] = phase_engine(counters, b, path)
        if path == "whisper_engine":
            stamps = engine_timestamps(eng, windows)
        del eng
        torch.cuda.empty_cache()
        r = reports[path]
        emit({"phase": "engine_timing", "path": path, "card": card,
              "graph_ms_per_step": r["graph_ms_per_step_16_lanes"],
              "eager_ms_per_step": r["eager_ms_per_step_16_lanes"],
              "graph_tokens_per_s_16_lanes": r["graph_tokens_per_s_16_lanes"],
              "eager_tokens_per_s_16_lanes": r["eager_tokens_per_s_16_lanes"],
              "engine_tokens_per_s": r["tokens_per_s"], "engine_wall_s": r["wall_s"],
              "engine_tokens": r["generated_tokens_incl_eot"],
              "idle_share_dispatch": r["idle_lanes_dispatch_profile"]["device_idle_share"],
              "device_busy_ms_per_step": 1e3 * r["idle_lanes_dispatch_profile"][
                  "device_busy_s_per_call"] / ENGINE_SPD,
              "latency_mean_s": r["latency_mean_s"], "latency_p95_s": r["latency_p95_s"],
              "resident_gb": r["resident_gb"], "peak_gb": r["peak_gb"],
              "capture_s": r["capture_s"]})
    emit({"phase": "engine", "timestamps": stamps,
          "cli_serve": engine_cli(workdir, windows)})
    return by_path


# --- main path 11: CTC streaming (serve/streaming.py) -------------------------


def stream_audio(n: int, seed: int, secs=None):
    """n seeded streams of `secs` (else 4-25 s): tones under a slow
    envelope, and noise."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = np.arange(int((secs or rng.uniform(4.0, 25.0)) * SAMPLE_RATE)) / SAMPLE_RATE
        f = rng.uniform(150.0, 2000.0)
        out.append((0.2 * np.sin(2 * np.pi * f * t) * np.sin(2 * np.pi * 0.3 * t)
                    + 0.05 * rng.randn(len(t))).astype(np.float32))
    return out


def pool_drive(pools, audios, on_step=None):
    """Stream k opens at step 2k or later, once a slot is free (so rows
    sit at different offsets, and streams past the slot count reuse
    rows); each open stream is fed one hop a step and finished once fed
    whole. Every pool of `pools` is driven alike, and on_step(pools, each
    pool's step results, step) follows each step. -> each pool's final
    texts in stream order, and the steps taken."""
    hop, slots = pools[0]._proto._hop, pools[0].slots
    waiting, open_, offs, step = list(range(len(audios))), {}, {}, 0
    texts = [{} for _ in pools]
    while waiting or open_:
        while waiting and len(open_) < slots and 2 * waiting[0] <= step:
            k = waiting.pop(0)
            open_[k], offs[k] = [p.open() for p in pools], 0
        for k in list(open_):
            if offs[k] < len(audios[k]):
                for p, sid in zip(pools, open_[k]):
                    p.feed(sid, audios[k][offs[k]:offs[k] + hop])
                offs[k] += hop
            else:
                for p, sid, out in zip(pools, open_.pop(k), texts):
                    out[k] = p.finish(sid).text
        results = [p.step() for p in pools]
        step += 1
        if on_step is not None:
            on_step(pools, results, step)
    return [[out[k] for k in range(len(audios))] for out in texts], step


def stream_texts(bundle, sc, audios):
    """Each audio through its own StreamingTranscriber (one window a step)."""
    from jiao_liao_speech_recognition_torch.serve import StreamingTranscriber

    out = []
    for a in audios:
        st = StreamingTranscriber(bundle, sc)
        st.feed(a)
        out.append(st.finish().text)
    return out


def replay_vs_eager(bundle, sc, audios, slots: int = STREAM_SLOTS):
    """The streams through two fresh pools of `slots` in lockstep: one
    replaying its captured step, one built with graph=False (the eager ring
    step). Every step must leave the same ring and read back the same
    frames and ids, and give the same results. -> (the report, the eager
    pool)."""
    import torch

    from jiao_liao_speech_recognition_torch.serve import StreamingPool

    pools = [StreamingPool(bundle, slots=slots, stream_cfg=sc),
             StreamingPool(bundle, slots=slots, stream_cfg=sc, graph=False)]
    rep = {"steps_compared": 0, "rows_advanced": 0, "differ_at_steps": []}

    def compare(ps, results, step):
        g, e = ps
        if not results[0] and not results[1]:
            return
        same = (torch.equal(g._ring, e._ring) and torch.equal(g._out, e._out)
                and results[0] == results[1])
        rep["steps_compared"] += 1
        rep["rows_advanced"] += len(results[0])
        if not same:
            rep["differ_at_steps"].append(step)

    (g_texts, e_texts), steps = pool_drive(pools, audios, compare)
    rep.update({"steps": steps, "replays": pools[0].replays, "eager_replays": pools[1].replays,
                "texts_equal": g_texts == e_texts})
    return rep, pools[1]


def ring_vs_plain(pool, acc):
    """The ring's windows after a step through the plain path (kernels=False,
    f32 log-probs): the step's ids on every advancing row's valid frames
    whose plain top-2 margin exceeds ARGMAX_MARGIN must be the plain argmax.
    Sums into acc."""
    import torch

    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch

    b = pool.bundle
    with torch.no_grad():
        feats = featurize_batch(pool._ring, b.config.frontend, kernels=False)
        lp, lens = b.model(feats, pool._ctrl[3], head_mode="log_probs", kernels=False)
    out = pool._out
    frames = ((torch.arange(lp.shape[1], device="cuda")[None, :] < out[:, :1])
              & (pool._ctrl[2] > 0)[:, None])
    clear = frames & (margins(lp) > ARGMAX_MARGIN)
    same = out[:, 1:] == lp.argmax(-1).to(torch.int32)
    for k, v in (("frames", frames), ("clear", clear), ("mismatched", clear & ~same),
                 ("agree", frames & same)):
        acc[k] = acc.get(k, 0) + int(v.sum())
    acc["lengths_equal"] = acc.get("lengths_equal", True) and bool(torch.equal(
        lens[pool._ctrl[2] > 0], out[pool._ctrl[2] > 0, 0]))
    acc["finite"] = acc.get("finite", True) and bool(torch.isfinite(lp).all())
    acc["windows"] = acc.get("windows", 0) + int((pool._ctrl[2] > 0).sum())


def pool_replay_names(pool):
    """Kernels of one replay of the pool's graph by the profiler's names
    (a lead-in replay, then a spin kernel as a marker, as replay_profile)
    -> {K1, K2's core, K2's out-projection, K3's fc2, K4's tiles, all}, or
    None without a marker."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pool._graph.replay()
        torch.cuda._sleep(1_000_000)
        pool._graph.replay()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    marks = [e.time_range.start for e in events if "spin_kernel" in e.name]
    if not marks:
        return None
    counted = [e.name for e in events if e.time_range.start > max(marks)]
    return {name: sum(tag in n for n in counted) for name, tag in STREAM_KERNEL_NAMES.items()} | {
        "all": len(counted)}


def stream_kernel_rows(bundle, ring, rng):
    """K1-K4 alone at the pool step's shape (B = slots, one 10 s window a
    row, T' = 250: one full and one ragged 128-key tile, lengths down to
    1, the flagship's block 0 and head, the kept bf16 copies) against their
    plain versions on the same inputs: K1's log-mel within LOGMEL_BAR on
    the Whisper-normalized surface, K2 and K3 within ULP_BAR and two
    launches bitwise equal, K4's ids the plain argmax on every frame whose
    margin clears ARGMAX_MARGIN (at least MIN_COVERAGE of them); each
    timed beside the bound of this run's inputs. -> {key: row}, "ok" false
    where a bar is missed."""
    import torch

    from jiao_liao_speech_recognition_torch.frontend import features, fused_frontend
    from jiao_liao_speech_recognition_torch.ops import fused_attention, fused_head, fused_mlp

    fe = bundle.config.frontend
    B, L = ring.shape
    T = L // fe.hop_length // bundle.config.ctc_model.subsample_factor
    blk, head = bundle.model.blocks[0], bundle.model.ctc_head
    sa, ln1, ln2, m = blk.self_attn, blk.self_attn_ln, blk.mlp_ln, blk.mlp
    d = bundle.config.ctc_model.d_model
    x = torch.from_numpy(rng.randn(B, T, d).astype(np.float32)).cuda().to(torch.bfloat16)
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    lens[-4:] = torch.tensor([T - 7, 120, 10, 1], dtype=torch.int32)  # young streams, idle rows
    with torch.inference_mode():
        w_qkv, b_qkv = sa.qkv_weights(torch.bfloat16)
        wo, bo = sa.out_proj.weights(torch.bfloat16)
        mlp_w = (*m.fc1.weights(torch.bfloat16), *m.fc2.weights(torch.bfloat16))
        head_w = head.weight(torch.bfloat16)
    pairs = {
        "K1": (lambda: fused_frontend.fused_log_mel_raw(ring),
               lambda: fused_frontend.log_mel_raw_plain(ring)),
        "K2": (lambda: fused_attention.fused_attention_sublayer_packed(
                   x, ln1.scale, ln1.bias, w_qkv, b_qkv, wo, bo, lens, sa.num_heads),
               lambda: fused_attention.attention_sublayer_plain(
                   x, ln1.scale, ln1.bias, sa.q_proj.kernel, sa.q_proj.bias, sa.k_proj.kernel,
                   sa.v_proj.kernel, sa.v_proj.bias, sa.out_proj.kernel, sa.out_proj.bias,
                   lens, sa.num_heads)),
        "K3": (lambda: fused_mlp.fused_ln_mlp_residual(x, ln2.scale, ln2.bias, *mlp_w, 1e-5,
                                                       m.gelu_form),
               lambda: fused_mlp.ln_mlp_residual_plain(x, ln2.scale, ln2.bias, *mlp_w, 1e-5,
                                                      m.gelu_form)),
        "K4": (lambda: fused_head.fused_head_argmax(x, head_w, head.bias),
               lambda: fused_head.head_argmax_plain(x, head_w, head.bias)),
    }
    work = ctc_work(bundle, B, T, L, lens)
    rows = {}
    with torch.inference_mode():
        for key, (kern, plain) in pairs.items():
            got, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            r = {"bitwise_repeat": bool(torch.equal(got, again))}
            if key == "K1":
                got, want = (features.normalize_log_mel(v, fe) for v in (got, want))
                r["max_abs_err"] = float((got - want).abs().max())
                r["bar"] = LOGMEL_BAR
                r["ok"] = bool(torch.isfinite(got).all()) and r["max_abs_err"] <= LOGMEL_BAR
            elif key == "K4":
                logits = fused_head.head_logits(x, head_w, head.bias)
                clear = margins(logits) > ARGMAX_MARGIN
                r.update({"coverage": float(clear.float().mean()),
                          "mismatched_frames": int(((got != want) & clear).sum()),
                          "max_abs_err": float(((got - want).abs() * clear).max()),
                          "margin": ARGMAX_MARGIN})
                r["ok"] = (r["coverage"] >= MIN_COVERAGE and r["mismatched_frames"] == 0
                           and r["bitwise_repeat"])
            else:
                ulps, elem_ulps, over1 = bf16_ulp_err(got, want)
                r.update({"max_abs_err": float((got.float() - want.float()).abs().max()),
                          "ulps": ulps, "bar_ulps": ULP_BAR, "elementwise_max_ulps": elem_ulps,
                          "elementwise_share_over_1ulp": over1})
                r["ok"] = ulps <= ULP_BAR and r["bitwise_repeat"]
            p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
            bound_ms, bound_by = bound(*work[key])
            rows[key] = {**r, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                         "bound_ms": bound_ms, "bound_by": bound_by, "turns_ms": [p1, k1, k2, p2]}
    return rows


def phase_streaming(counters, workdir: Path, card: str):
    """Main path 11 on the flagship (random init, seed 0): a
    StreamingPool(STREAM_SLOTS) on the device ring, its step captured once
    as a CUDA graph, serving STREAM_COUNT staggered streams; then the
    checks, the timing, api.stream and `cli transcribe --stream`. ->
    (launches by kernel key, K1-K4's errors at the pool step's shape)."""
    import torch

    from jiao_liao_speech_recognition_torch import api
    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.frontend.audio_io import read_wav, write_wav
    from jiao_liao_speech_recognition_torch.serve import (StreamingConfig, StreamingPool,
                                                          StreamingTranscriber)
    from jiao_liao_speech_recognition_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig()
    bundle = api.load(config=cfg, device="cuda")
    # one character per non-special id, so every id decodes to text
    bundle.tokenizer = CharTokenizer([chr(0x4E00 + i)
                                      for i in range(cfg.ctc_model.vocab_size - 2)])
    sc = StreamingConfig(*STREAM_GEOMETRY)
    audios = stream_audio(STREAM_COUNT, seed=16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pool = StreamingPool(bundle, slots=STREAM_SLOTS, stream_cfg=sc)
    want_step = {"fused_log_mel_raw": 1, "fused_attention_sublayer": cfg.ctc_model.num_layers,
                 "fused_ln_mlp_residual": cfg.ctc_model.num_layers, "fused_head_argmax": 1}
    check(pool._graph is not None and pool.step_launches == want_step,
          f"streaming: the captured step's launches {pool.step_launches}, not {want_step}")

    host_calls, plain = [0], {}
    host_dispatch, graph = pool._dispatch, pool._graph

    def counting(jobs):  # the host-assembled steps (finish() takes them)
        host_calls[0] += bool(jobs)
        return host_dispatch(jobs)

    def on_step(ps, results, step):
        if results[0] and step % STREAM_PLAIN_EVERY == 0:
            ring_vs_plain(ps[0], plain)

    pool._dispatch = counting
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    (texts,), steps = pool_drive([pool], audios, on_step)
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    del pool._dispatch
    counted = {key: c.launches for key, c in counters.items()}
    launches = {key: counted[key] + pool.step_launches.get(c.name, 0) * pool.replays
                for key, c in counters.items()}
    L, n = cfg.ctc_model.num_layers, host_calls[0]
    want = {key: 0 for key in counters} | {"K1": n, "K2": L * n, "K3": L * n, "K4": n}
    wrong = {k: (counted[k], w) for k, w in want.items() if counted[k] != w}
    check(not wrong, f"streaming: launches outside the graph (got, want): {wrong}")
    missing = [key for key in PATHS["streaming"] if launches[key] == 0]
    check(not missing, f"streaming: kernels never launched: {missing} ({launches})")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_names = {"K1": 1, "K2 core": L, "K2 out-projection": L, "K3 fc2": L, "K4 tiles": 1}
    readings = []
    for _ in range(PROFILE_ATTEMPTS):
        readings.append(pool_replay_names(pool))
        if readings[-1] is not None and all(readings[-1][k] == v for k, v in want_names.items()):
            break
    check(readings[-1] is not None and all(readings[-1][k] == v for k, v in want_names.items()),
          f"streaming: one replay's kernels by name: {readings} (want {want_names})")

    # the same streams: replayed against eager in lockstep, then through the
    # host-assembled pool and single transcribers
    vs_eager, eager = replay_vs_eager(bundle, sc, audios)
    check(vs_eager["steps_compared"] > 0 and not vs_eager["differ_at_steps"]
          and vs_eager["texts_equal"] and vs_eager["replays"] == vs_eager["steps_compared"]
          and vs_eager["eager_replays"] == 0,
          f"streaming: replayed steps against the eager ring step: {vs_eager}")
    host = StreamingPool(bundle, slots=STREAM_SLOTS, stream_cfg=sc, device_ring=False)
    (host_texts,), _ = pool_drive([host], audios)
    single = stream_texts(bundle, sc, audios)
    differ = {"ring_vs_host": [k for k, (a, b) in enumerate(zip(texts, host_texts)) if a != b],
              "ring_vs_single": [k for k, (a, b) in enumerate(zip(texts, single)) if a != b]}
    coverage = plain["clear"] / plain["frames"]
    checked = {
        "phase": "streaming", "card": card, "slots": STREAM_SLOTS,
        "geometry_s": list(STREAM_GEOMETRY),
        "streams": STREAM_COUNT, "streams_s": [round(len(a) / SAMPLE_RATE, 2) for a in audios],
        "steps": steps, "replays": pool.replays, "host_dispatches": n, "drive_s": drive_s,
        "capture_s": pool.capture_s, "step_launches": pool.step_launches,
        "launches": launches, "one_replay_kernels": readings[-1], "profile_readings": readings,
        "replay_vs_eager": vs_eager, "texts_differ": differ,
        "text_chars": [len(t) for t in texts], "peak_gb_drive": peak_gb,
        "vs_plain": {**plain, "coverage": coverage, "margin": ARGMAX_MARGIN}}
    emit(checked)
    check(not differ["ring_vs_host"] and not differ["ring_vs_single"],
          f"streaming: texts differ across the ring, host and single paths: {differ}")
    check(sum(len(t) for t in texts) > 0, "streaming: the model emitted no text at all")
    check(plain["finite"] and plain["lengths_equal"] and coverage >= MIN_COVERAGE
          and plain["mismatched"] == 0, f"streaming: ids disagree with the plain path: {plain}")

    # finish() over one window against the offline transcribe of 10 s chunks
    one = stream_audio(1, seed=20, secs=8.5)[0]
    st = StreamingTranscriber(bundle, StreamingConfig(10.0, 10.0, 0.0))
    st.feed(one)
    single_window = st.finish().text
    bundle.config.frontend.chunk_seconds = 10.0
    offline = bundle.transcribe(one)[0]
    bundle.config.frontend.chunk_seconds = cfg.frontend.chunk_seconds
    check(single_window == offline and offline,
          f"streaming: finish() over one window {single_window!r} != offline {offline!r}")

    # api.stream of one WAV and `cli transcribe --stream` of two: a line a hop
    paths = []
    for i, a in enumerate((audios[1][:3 * SAMPLE_RATE], audios[2][:int(2.2 * SAMPLE_RATE)])):
        paths.append(str(workdir / f"s{i}.wav"))
        write_wav(paths[-1], a, SAMPLE_RATE)
    hop = int(sc.hop_seconds * SAMPLE_RATE)
    pcms = [read_wav(p)[0] for p in paths]
    want_texts = stream_texts(bundle, sc, pcms)
    results = list(api.stream(bundle, (pcms[0][s:s + hop] for s in range(0, len(pcms[0]), hop)),
                              sc))
    check(len(results) == -(-len(pcms[0]) // hop) + 1 and results[-1].is_final
          and results[-1].text == want_texts[0], "api.stream: a result a hop, then the final text")
    bundle.save(str(workdir / "flagship"))
    lines = [json.loads(s) for s in cli_run(["transcribe", *paths, "--checkpoint",
                                             workdir / "flagship", "--stream"])]
    per_file = [[r for r in lines if r["audio"] == p] for p in paths]
    check(all(len(rs) == -(-len(x) // hop) + 1 and rs[-1]["text"] == w
              and all({"t", "partial", "preview"} <= set(r) for r in rs[:-1])
              for rs, x, w in zip(per_file, pcms, want_texts)),
          f"cli transcribe --stream: a line a hop, then the final text ({lines})")
    emit({"phase": "streaming", "card": card, "finish_one_window_equals_offline": True,
          "api_stream_results": len(results), "cli_stream_lines": [len(r) for r in per_file]})

    # timing: every slot busy with 25 s streams, the captured pool and the
    # graph=False one in turns, each pool's streams fed a hop a step of its own
    timed = stream_audio(STREAM_SLOTS, seed=17, secs=25.0)
    pools = {"graph": pool, "eager": eager}
    sids = {turn: [p.open() for _ in timed] for turn, p in pools.items()}
    fed = {turn: 0 for turn in pools}

    def fed_step(turn):
        p, j = pools[turn], fed[turn]
        for sid, a in zip(sids[turn], timed):
            p.feed(sid, a[j * hop:(j + 1) * hop])
        fed[turn] += 1
        return p.step()

    step_s = {"graph": [], "eager": []}
    warm = [turn for turn in pools for _ in range(STREAM_WARM_STEPS)]
    order = warm + [turn for turn in ("graph", "eager", "eager", "graph")
                    for _ in range(STREAM_TURN_STEPS)]
    for i, turn in enumerate(order):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fed_step(turn)
        torch.cuda.synchronize()
        if i >= len(warm):
            step_s[turn].append(time.perf_counter() - t0)
        check(len(res) == STREAM_SLOTS, "streaming timing: every slot advances a step")
    replay_ms = cuda_ms(graph.replay, 20)
    with torch.no_grad():
        eager_ms = cuda_ms(eager._ring_step, 10)
    replay_prof = device_profile(lambda i: graph.replay(), 8, "streaming replay")
    step_prof = device_profile(lambda i: fed_step("graph"), 4, "streaming pool step")
    for turn, p in pools.items():
        for sid in sids[turn]:
            p.finish(sid)
    graph_ms = 1e3 * statistics.median(step_s["graph"])
    rows = stream_kernel_rows(bundle, pool._ring, np.random.RandomState(18))
    frames = pool._proto._W // pool._proto._align
    for key, r in rows.items():
        emit({"phase": "timing", "kernel": key, "shape": f"streaming pool step: B={STREAM_SLOTS}, "
              f"{sc.window_seconds:g} s windows, T'={frames}", "card": card, **r})
    bad = {key: r for key, r in rows.items() if not r["ok"]}
    check(not bad, f"streaming: K1-K4 at the pool step's shape against their plain versions: "
          f"{bad}")
    emit({"phase": "streaming_timing", "card": card, "slots": STREAM_SLOTS,
          "pool_step_ms_graph_median": graph_ms,
          "pool_step_ms_eager_median": 1e3 * statistics.median(step_s["eager"]),
          "pool_step_ms": {k: [1e3 * x for x in v] for k, v in step_s.items()},
          "replay_ms": replay_ms, "eager_ring_step_ms": eager_ms,
          "replay_idle_share": replay_prof["device_idle_share"],
          "replay_busy_ms": 1e3 * replay_prof["device_busy_s_per_call"],
          "replay_kernels": replay_prof["launches_per_call"],
          "replay_top_kernels": replay_prof["top_kernels_ms_per_call"],
          "pool_step_idle_share": step_prof["device_idle_share"],
          "pool_step_wall_ms_profiled": 1e3 * step_prof["wall_s_per_call"],
          "h2d_bytes_per_step": pool._h_chunk.nbytes + pool._h_ctrl.nbytes,
          "latency_s": sc.hop_seconds + sc.lookahead_seconds + graph_ms / 1e3,
          "realtime_streams": STREAM_SLOTS * sc.hop_seconds / (graph_ms / 1e3),
          "capture_s": pool.capture_s, "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, {key: r["max_abs_err"] for key, r in rows.items()}


def phase_streaming_banded(counters, card: str):
    """Main path 12: the banded flagship (left 12, right 6 frames,
    position_mode "none", whisper_norm off; examples/streaming_quality.py's
    band at full width and depth) streaming three seeded utterances, one
    StreamingTranscriber each (K1, the module path of attention, K3, K4;
    never K2), at a lookahead covering 12 blocks x 6 frames of right context.
    Held against the offline path on the committed frames by the margin
    rule; the differing frames and tokens are printed."""
    import difflib

    import torch

    from jiao_liao_speech_recognition_torch import api
    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch
    from jiao_liao_speech_recognition_torch.serve import StreamingConfig, StreamingTranscriber
    from jiao_liao_speech_recognition_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig()
    for k, v in BANDED.items():
        setattr(cfg.ctc_model, k, v)
    cfg.frontend.whisper_norm = False
    bundle = api.load(config=cfg, device="cuda")
    # one character per non-special id, so every id decodes to text
    bundle.tokenizer = CharTokenizer([chr(0x4E00 + i)
                                      for i in range(cfg.ctc_model.vocab_size - 2)])
    sc = StreamingConfig(*BANDED_GEOMETRY)
    utts = stream_audio(3, seed=19)
    hop = int(sc.hop_seconds * SAMPLE_RATE)

    def run():
        out = []
        for a in utts:
            st = StreamingTranscriber(bundle, sc)
            frames, steps, absorb, step = {}, [0], st._absorb, st._step

            def counted(wav, nfr, step=step, steps=steps):
                steps[0] += 1
                return step(wav, nfr)

            def kept(ids, out_len, e0, final, st=st, frames=frames, absorb=absorb):
                before = st._committed
                absorb(ids, out_len, e0, final)
                frames.update((g, int(ids[g - e0])) for g in range(before, st._committed))

            st._step, st._absorb = counted, kept
            for s in range(0, len(a), hop):
                st.feed(a[s:s + hop])
            out.append((st.finish().text, frames, steps[0]))
        return out

    streamed, launches = drive(counters, "streaming_banded", run)
    n = sum(r[2] for r in streamed)
    L = cfg.ctc_model.num_layers
    want = {key: 0 for key in counters} | {"K1": n, "K3": L * n, "K4": n}
    wrong = {k: (launches[k], w) for k, w in want.items() if launches[k] != w}
    check(not wrong, f"streaming_banded: launches (got, want): {wrong}")
    offline = bundle.transcribe(utts)
    fe = cfg.frontend
    wavs, alens, _ = bundle._prepare_audio_chunked(utts, None)
    with torch.inference_mode():
        lp, olens = bundle.model(featurize_batch(torch.from_numpy(wavs).cuda(), fe),
                                 torch.from_numpy(alens // fe.hop_length).cuda())
    rec = []
    for i, (text, frames, steps) in enumerate(streamed):
        n_fr = int(olens[i])
        ids = torch.tensor([frames.get(g, -1) for g in range(n_fr)], device="cuda")
        clear = margins(lp[i, :n_fr]) > ARGMAX_MARGIN
        diff = ids != lp[i, :n_fr].argmax(-1)
        ops = difflib.SequenceMatcher(a=offline[i], b=text, autojunk=False).get_opcodes()
        rec.append({"audio_s": round(len(utts[i]) / SAMPLE_RATE, 2), "windows": steps,
                    "frames": n_fr, "committed": len(frames),
                    "coverage": float(clear.float().mean()),
                    "mismatched_clear_frames": int((diff & clear).sum()),
                    "differing_frames": int(diff.sum()), "text_equal": text == offline[i],
                    "text_chars": len(text), "differing_tokens": [
                        (tag, offline[i][a0:a1], text[b0:b1])
                        for tag, a0, a1, b0, b1 in ops if tag != "equal"]})
    emit({"phase": "streaming_banded", "card": card, "band": BANDED,
          "geometry_s": list(BANDED_GEOMETRY),
          "windows": n, "launches": launches, "utterances": rec})
    check(all(r["committed"] == r["frames"] for r in rec), "banded: every frame committed")
    check(all(r["coverage"] >= MIN_COVERAGE and r["mismatched_clear_frames"] == 0 for r in rec),
          f"banded: streamed frames disagree with offline ones: {rec}")
    return launches


# --- main paths 14-18: the joint CTC/attention family -----------------------------


def joint_bundle():
    """api.load of configs/joint_ctc_attention.yaml at its published widths
    (random init, seed 0), its WF inserts' B matrices drawn from a seed-0
    generator (zero at init, which would make every insert the identity)
    and a one-character-per-id vocabulary."""
    import torch

    from jiao_liao_speech_recognition_torch import api
    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.models.adapters import WFAdapter
    from jiao_liao_speech_recognition_torch.utils.config import load_yaml

    cfg = load_yaml(str(Path(__file__).resolve().parent / JOINT_CONFIG))
    bundle = api.load(config=cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for m in bundle.model.modules():
            if isinstance(m, WFAdapter):
                m.b.normal_(0.0, JOINT_WF_B_STD, generator=gen)
    bundle.tokenizer = CharTokenizer([chr(0x4E00 + i) for i in range(cfg.joint.vocab_size - 2)])
    return bundle


def joint_k7_rows(model, rng):
    """K7 at the joint model's shapes against its plain version, twice
    bitwise: the attention half on encoder block 0 at B x 750 (4 heads of
    128), the MLP half on encoder block 0 at B x 750 and decoder block 0 at
    B x 64 (a teacher-forced pass's rows) -> errors by key."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import fused_attention as fa
    from jiao_liao_speech_recognition_torch.ops import fused_mlp as fm

    B, d = JOINT_B, model.cfg.d_model
    errs = {}
    with torch.inference_mode():
        for key, blk, T in (("K7-attn", model.enc_blocks[0], 750),
                            ("K7-mlp", model.enc_blocks[0], 750),
                            ("K7-mlp", model.dec_blocks[0], JOINT_MAX_LEN)):
            x = torch.from_numpy(rng.randn(B, T, d).astype(np.float32)).cuda().to(torch.bfloat16)
            s = float(blk.adapter.scale)
            if key == "K7-attn":
                sa, ln = blk.self_attn, blk.self_attn_ln
                base, inserts = sa.wf_params()
                lens = torch.tensor(([T, 517, 1, 64] * B)[:B], dtype=torch.int32, device="cuda")
                args = (x, ln.scale, ln.bias, base, inserts, sa.num_heads, ln.eps, s, lens)
                kern, plain = fa.fused_attention_sublayer_wf, fa.attention_sublayer_wf_plain
            else:
                ln, m = blk.mlp_ln, blk.mlp
                args = (x, ln.scale, ln.bias, m.fc1.kernel, m.fc1.bias, m.fc2.kernel, m.fc2.bias,
                        m.fc1.insert(), m.fc2.insert(), ln.eps, m.gelu_form, s)
                kern, plain = fm.fused_ln_mlp_residual_wf, fm.ln_mlp_residual_wf_plain
            got, again = kern(*args), kern(*args)
            same = bool(torch.equal(got, again))
            err = _ulp_check(key, got, plain(*args), B=B, T=T, d=d, joint=True,
                             bitwise_repeat=same)
            check(same, f"{key} (joint, T={T}): two launches differ")
            errs[key] = max(errs.get(key, 0.0), err)
    return errs


def with_sos(ids):
    import torch

    return torch.cat([torch.zeros_like(ids[:, :1]), ids], 1)


def joint_decoder_checks(model, enc, greedy, spec):
    """Greedy and spec tokens by the margin rule against the plain decoder
    (teacher-forced cached steps); spec against greedy: where a row's two
    sequences first differ, the plain logits on their shared prefix have no
    clear winner. -> record."""
    import torch

    out = {}
    g_ids, _ = greedy
    s_ids, s_lens, passes = spec
    with torch.inference_mode():
        for name, (ids, lens) in (("greedy", greedy), ("spec_greedy", (s_ids, s_lens))):
            toks = with_sos(ids)
            logits = forced_logits(model, toks, enc, kernels=False)
            cov, mism, scored, agree = margin_check(logits, toks, lens, 1)
            out[name] = {"coverage": cov, "mismatched_positions": mism, "positions": scored,
                         "agree_all_positions": agree, "lengths": [int(n) for n in lens]}
            check(cov >= MIN_COVERAGE and mism == 0 and bool(torch.isfinite(logits).all()),
                  f"joint {name}: tokens disagree with the plain decoder ({out[name]})")
            if name == "greedy":
                g_logits = logits
        diverge = []
        for b in range(g_ids.shape[0]):
            d = (g_ids[b] != s_ids[b]).nonzero()
            if len(d):
                p = int(d[0])
                diverge.append({"row": b, "position": p,
                                "plain_margin": float(margins(g_logits[b, p]))})
        out["spec_vs_greedy"] = {"rows_equal": g_ids.shape[0] - len(diverge),
                                 "first_differences": diverge, "passes": passes}
        check(all(r["plain_margin"] <= ARGMAX_MARGIN for r in diverge),
              f"joint spec_greedy leaves greedy at a clear position: {diverge}")
    return out


def beam_forced_logp(model, gen, enc, enc_lengths, kernels):
    """Every hypothesis gen [B, K, L] fed through the decoder's cached steps
    as beam_from_enc runs them (init_cache(..., beams=K): B * K rows, the
    cross K/V projected once an utterance; each row's encoder length) ->
    f32 log-prob of each fed next token [B, K, L]."""
    import torch

    from jiao_liao_speech_recognition_torch.decode.whisper_generate import log_softmax_f32

    B, K, L = gen.shape
    toks = with_sos(gen.reshape(B * K, L))
    caches = model.init_cache(B, enc, L + 1, None, beams=K)
    lens_k = enc_lengths.repeat_interleave(K, 0)
    out = []
    for pos in range(L):
        logits, caches = model.decode_step(toks[:, pos:pos + 1], pos, enc, caches, lens_k,
                                           kernels)
        lp = log_softmax_f32(logits).reshape(B * K, -1)
        out.append(lp.gather(1, toks[:, pos + 1, None])[:, 0])
    return torch.stack(out, 1).view(B, K, L)


def lm_step_logp(mat, gen, lens):
    """log P_LM(next | previous) from a bigram matrix [V, V] at each step
    of gen [B, K, L] (the start token 0 first), 0 past each hypothesis's
    EOT step -> [B, K, L]."""
    import torch

    B, K, L = gen.shape
    prev = with_sos(gen.reshape(B * K, L))[:, :L].view(B, K, L)
    keep = torch.arange(L, device=gen.device)[None, None] < (lens + 1).clamp(max=L)[..., None]
    return torch.where(keep, mat[prev, gen], 0.0)


def beam_record(model, enc, el, beam, lm=None, plain=True):
    """One beam_from_enc result (tokens [B, K, L], lengths, scores) held to
    the decoder's steps: its hypotheses fed back through the kernel steps
    (BEAM_RESCORE_BAR on each score, the additions in the beam's order,
    plus lm_weight x the bigram log-prob of each step where `lm` = (bigram
    matrix, weight) was fused) and, with `plain`, each position against the
    plain steps (BEAM_TOKEN_BAR); a row's K hypotheses distinct and sorted
    by score. -> record."""
    import torch

    gen, lens, att = beam
    B, K, L = gen.shape
    lp_k = beam_forced_logp(model, gen, enc, el, True)
    keep = torch.arange(L, device=gen.device)[None, None] < (lens + 1).clamp(max=L)[..., None]
    terms = lp_k if lm is None else lp_k + lm[1] * lm_step_logp(lm[0], gen, lens)
    terms = torch.where(keep, terms, 0.0)
    acc = torch.zeros_like(att)
    for p in range(L):  # the beam's order: one step's log-prob added at a time
        acc = acc + terms[:, :, p]
    same = (gen[:, :, None] == gen[:, None]).all(-1) & ~torch.eye(K, dtype=torch.bool,
                                                                  device=gen.device)
    rec = {"K": K, "lengths": lens.tolist(), "scores": att.tolist(),
           "score_max_abs_diff_kernel_steps": float((acc - att).abs().max()),
           "rescore_bar": BEAM_RESCORE_BAR,
           "row_score_spread_min": float((att[:, 0] - att[:, -1]).min()),
           "sorted": bool((att[:, :-1] >= att[:, 1:]).all()),
           "distinct": not bool(same.any())}
    check(rec["score_max_abs_diff_kernel_steps"] <= BEAM_RESCORE_BAR,
          f"beam: scores are not the sums of their hypotheses' steps ({rec})")
    check(rec["sorted"] and rec["distinct"], f"beam: a row's hypotheses repeat or are out of "
                                             f"order ({rec})")
    if plain:
        lp_p = beam_forced_logp(model, gen, enc, el, False)
        drift = torch.where(keep, (lp_k - lp_p).abs(), 0.0)
        rec.update({"token_max_abs_diff_plain_steps": float(drift.max()),
                    "token_mean_abs_diff_plain_steps": float(drift.sum() / keep.sum()),
                    "token_bar": BEAM_TOKEN_BAR,
                    "score_max_abs_diff_plain_steps": float(
                        (torch.where(keep, lp_p, 0.0).sum(2) - att).abs().max())})
        check(rec["token_max_abs_diff_plain_steps"] <= BEAM_TOKEN_BAR,
              f"beam: a position's log-prob is off the plain decoder's ({rec})")
    return rec


def joint_beam_checks(model, feats, flens, enc, el, greedy, workdir: Path):
    """The beam on the kernel path: a beam of one bitwise greedy; the
    beam of JOINT_BEAM through beam_from_enc, its hypotheses held to the
    decoder's steps (beam_record), CTC-rescored (ctc_rescore) and ranked
    by the config's ctc_weight to joint_beam's pick; then the same beam
    with a seeded bigram LM fused at JOINT_LM_WEIGHT (beam_record with
    the LM's term), whose top hypotheses must differ from the unfused
    ones and carry more LM log-prob. -> record."""
    import torch

    from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg
    from jiao_liao_speech_recognition_torch.decode.joint_generate import (
        ctc_rescore, joint_beam)
    from jiao_liao_speech_recognition_torch.decode.lm import NGramCharLM

    K, L, V = JOINT_BEAM, JOINT_MAX_LEN, model.cfg.vocab_size
    out = {}
    with torch.inference_mode():
        b1 = joint_beam(model, feats, flens, 1, L, ctc_weight=0.0)
        out["beam_of_one_equals_greedy_bitwise"] = all(
            torch.equal(a, b) for a, b in zip(b1, greedy))
        check(out["beam_of_one_equals_greedy_bitwise"], "joint: a beam of one is not greedy")
        beam = wg.beam_from_enc(model, enc, el, K, L, (0,), 0)
        out["beam"] = beam_record(model, enc, el, beam)
        gen, lens, att = beam
        nll = ctc_rescore(model, enc, el, gen, lens)
        w, norm = model.cfg.ctc_weight, wg.length_norm(lens, 1.0)
        pick = wg.best_beam(gen, lens, w * (-nll / norm) + (1.0 - w) * att / norm)
        chosen = joint_beam(model, feats, flens, K, L)
        out["beam"].update({"ctc_nll_finite": bool(torch.isfinite(nll).all()),
                            "joint_beam_is_the_ctc_ranked_pick": all(
                                torch.equal(a, b) for a, b in zip(pick, chosen))})
        check(out["beam"]["ctc_nll_finite"] and out["beam"]["joint_beam_is_the_ctc_ranked_pick"],
              f"joint beam: CTC rescoring ({out['beam']})")

        rng = np.random.RandomState(24)
        path = workdir / "joint_lm.npz"
        NGramCharLM.train([rng.randint(1, JOINT_LM_IDS + 1, L) for _ in range(32)], 2,
                          V).save(path)
        mat = wg.load_bigram_matrix(str(path), V, enc.device)
        fused = wg.beam_from_enc(model, enc, el, K, L, (0,), 0, lm_bigram=mat,
                                 lm_weight=JOINT_LM_WEIGHT)
        rec = beam_record(model, enc, el, fused, (mat, JOINT_LM_WEIGHT), plain=False)
        lm_fused, lm_plain = (lm_step_logp(mat, g, n).sum(2) for g, n, _ in (fused, beam))
        top_f, top_u = fused[0][:, 0], gen[:, 0]
        rec.update({"lm_weight": JOINT_LM_WEIGHT, "lm_ids": JOINT_LM_IDS,
                    "rows_top_differs": int((top_f != top_u).any(1).sum()),
                    "top_lm_logp_fused": float(lm_fused[:, 0].sum()),
                    "top_lm_logp_unfused": float(lm_plain[:, 0].sum()),
                    "top_tokens_in_lm_ids_fused": float(
                        ((top_f >= 1) & (top_f <= JOINT_LM_IDS)).float().mean()),
                    "top_tokens_in_lm_ids_unfused": float(
                        ((top_u >= 1) & (top_u <= JOINT_LM_IDS)).float().mean())})
        out["beam_lm_fused"] = rec
        check(rec["rows_top_differs"] > 0
              and rec["top_lm_logp_fused"] > rec["top_lm_logp_unfused"],
              f"joint beam: the fused LM did not move the beam toward its tokens ({rec})")
    return out


def joint_k6(rng):
    """K6 at the spec pass's cross-attention: JOINT_B rows of 64 query
    positions (one partial query tile) against 750 encoder frames, 4 heads
    of 128, ragged key lengths; out within ULP_BAR and lse within LSE_BAR
    of flash_forward_plain, two launches bitwise; then timed (queued, as
    phase 4's K6) beside plain, its bound on the valid keys and masked
    SDPA's forward -> (max abs error, row)."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import flash_attention as fl

    B, Tq, Tk, H, dh = JOINT_B, JOINT_MAX_LEN, 750, 4, 128
    lens = ([Tk, 517, 129, 1] * B)[:B]

    def t(T):
        return torch.from_numpy(rng.randn(B, T, H, dh).astype(np.float32)).cuda().to(
            torch.bfloat16)

    q, k, v = t(Tq), t(Tk), t(Tk)
    kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        out, lse = fl.flash_forward(q, k, v, kl)
        again = fl.flash_forward(q, k, v, kl)
        out_p, lse_p = fl.flash_forward_plain(q, k, v, kl)
        same = all(torch.equal(a, b) for a, b in zip((out, lse), again))
        err = _ulp_check("K6", out, out_p, B=B, Tq=Tq, Tk=Tk, heads=H, dh=dh, lens=lens,
                         joint=True, bitwise_repeat=same)
        lse_err = float((lse - lse_p).abs().max())
        emit({"phase": "kernels", "kernel": "K6", "joint": True, "lse_max_abs_err": lse_err,
              "lse_bar": LSE_BAR})
        check(lse_err <= LSE_BAR, f"K6 (joint cross-attention) lse off by {lse_err}")
        check(same, "K6 (joint cross-attention): two launches differ")

        def kern():
            return fl.flash_forward(q, k, v, kl)

        def plain():
            return fl.flash_forward_plain(q, k, v, kl)

        p1, k1, k2, p2 = cuda_ms(plain), queued_ms(kern), queued_ms(kern), cuda_ms(plain)
        library_ms = _yardsticks().sdpa_forward_ms(q, k, v, kl)
    n = sum(lens)
    # q read and out written once, K and V read on the valid keys, lse
    # written, the lengths read; QK^T and PV on the valid keys
    bound_ms, bound_by = bound(2 * B * Tq * H * dh * 2 + 2 * n * H * dh * 2 + B * H * Tq * 4
                               + B * 4, {"bf16": 4.0 * H * dh * Tq * n})
    row = {"shape": f"B={B}, {H} x {dh}, Tq={Tq}, Tk={Tk} (cross, lengths "
                    f"{min(lens)}-{max(lens)})",
           "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    emit({"phase": "timing", "kernel": "K6", "joint": True, **row,
          "turns_ms": [p1, k1, k2, p2]})
    return err, row


def joint_k9_timing(rng, H: int = 4):
    """K9 alone at the joint beam's decode shapes (B*K = 128 rows, H heads
    of 128: 4, or a split rank's, Tq 1): cross over Tk 768 with lengths 750
    and self over Tk 128 with lengths 1-64, caches cycled past twice the
    L2, by device time, beside plain (CUDA events), bound and masked SDPA
    (device time) -> rows."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import decode_attention as da
    from jiao_liao_speech_recognition_torch.utils.timing import cycling

    R, dh = JOINT_B * JOINT_BEAM, 128
    bf = torch.bfloat16
    rows = []
    with torch.inference_mode():
        randn = _card_randn(int(rng.randint(1 << 30)))
        qh = randn(R, H, 1, dh).to(bf)
        for tk, lens, what in ((da.round_tk(750), np.full(R, 750), "cross"),
                               (da.round_tk(JOINT_MAX_LEN), rng.randint(1, JOINT_MAX_LEN + 1, R),
                                "self")):
            sets = max(2, math.ceil(2 * L2_BYTES / (4 * R * H * tk * dh)))
            caches = [[randn(R, H, tk, dh).to(bf) for _ in range(2)] for _ in range(sets)]
            lt = torch.from_numpy(lens.astype(np.int32)).cuda()
            kern = cycling(lambda kv: da.grouped_decode_attention(qh, *kv, lt), caches)
            plain = cycling(lambda kv: da.decode_attention_plain(qh, *kv, lt), caches)
            lib_calls = [_yardsticks().sdpa_decode(qh, *kv, lt) for kv in caches]
            # device time: a launch's host dispatch outlasts the self case
            p1, k1, k2, p2 = cuda_ms(plain, 3), device_ms(kern), device_ms(kern), cuda_ms(plain, 3)
            n = int(lens.sum())
            bound_ms, bound_by = bound(R * H * dh * 2 + R * H * dh * 4 + R * 4 + 2 * n * H * dh * 2,
                                       {"bf16": 4.0 * H * dh * n})
            row = {"shape": f"B={R}, {H} x {dh}, Tq=1, Tk={tk} ({what}, lengths "
                            f"{int(lens.min())}-{int(lens.max())})",
                   "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "bound_ms": bound_ms,
                   "bound_by": bound_by,
                   "library_ms": device_ms(cycling(lambda call: call(), lib_calls), 10)}
            emit({"phase": "timing", "kernel": "K9", "joint": True, "heads": H, **row,
                  "turns_ms": [p1, k1, k2, p2]})
            rows.append(row)
            del caches
    return rows


def joint_streaming(counters, bundle, utts, offline):
    """The CTC branch streamed (main path 18): a StreamingPool(JOINT_B) on
    the device ring at StreamingConfig's defaults, its step captured, the
    first JOINT_STREAM_SECONDS (8 s and 12 s in turn) of each utterance fed
    a hop a step from staggered opens, so the 12 s streams pass the 10 s
    window (the ring rolls and the transcribers trim); its texts against
    the host-assembled pool's; then a
    pool of 30 s windows fed each utterance whole: its finish() texts must
    be the offline ctc_greedy ones. -> (launches, record)."""
    import torch

    from jiao_liao_speech_recognition_torch import api
    from jiao_liao_speech_recognition_torch.serve import StreamingConfig, StreamingPool

    L = bundle.model.cfg.num_layers
    sc = StreamingConfig()
    clips = [u[:int(JOINT_STREAM_SECONDS[k % 2] * SAMPLE_RATE)] for k, u in enumerate(utts)]
    pool = StreamingPool(bundle, slots=JOINT_B, stream_cfg=sc)
    want_step = {"fused_log_mel_raw": 1, "fused_attention_sublayer": L,
                 "fused_attention_sublayer_wf": L, "fused_ln_mlp_residual": L,
                 "fused_ln_mlp_residual_wf": L, "fused_head_argmax": 1}
    check(pool._graph is not None and pool.step_launches == want_step,
          f"joint streaming: the captured step's launches {pool.step_launches}, not {want_step}")
    seen = {"max_shift": 0, "trimmed": False}

    def on_step(pools, results, step):
        seen["max_shift"] = max(seen["max_shift"], int(pools[0]._h_ctrl[0].max()))
        seen["trimmed"] |= any(st._base > 0 for st in pools[0]._active.values())

    for c in counters.values():
        c.reset()
    (texts,), steps = pool_drive([pool], clips, on_step)
    torch.cuda.synchronize()
    counted = {key: c.launches for key, c in counters.items()}
    names = {c.name: key for key, c in counters.items()}
    launches = {key: counted[key] for key in counted}
    for name, n in pool.step_launches.items():
        launches[names[name]] += n * pool.replays
    missing = [key for key in PATHS["joint_stream"] if launches[key] == 0]
    check(not missing, f"joint_stream: kernels never launched: {missing} ({launches})")
    host = StreamingPool(bundle, slots=JOINT_B, stream_cfg=sc, device_ring=False)
    (host_texts,), _ = pool_drive([host], clips)
    differ = [k for k, (a, b) in enumerate(zip(texts, host_texts)) if a != b]
    whole = StreamingPool(bundle, slots=JOINT_B, stream_cfg=StreamingConfig(30.0, 30.0, 0.0))
    sids = [whole.open() for _ in utts]
    for sid, u in zip(sids, utts):
        whole.feed(sid, u)
    whole.step()
    finished = [whole.finish(sid).text for sid in sids]
    one = list(api.stream(bundle, np.split(clips[0], 4), sc))
    rec = {"slots": JOINT_B, "geometry_s": [sc.window_seconds, sc.hop_seconds,
                                            sc.lookahead_seconds],
           "stream_s": JOINT_STREAM_SECONDS, "steps": steps, "replays": pool.replays,
           "step_launches": pool.step_launches, "launches": launches,
           "ring_max_shift_samples": seen["max_shift"], "trimmed": seen["trimmed"],
           "ring_vs_host_differ": differ, "text_chars": [len(t) for t in texts],
           "finish_30s_windows_equal_offline_ctc_greedy": finished == offline,
           "api_stream_results": len(one)}
    emit({"phase": "joint", "streaming": rec})
    check(seen["max_shift"] > 0 and seen["trimmed"],
          f"joint streaming: the ring never rolled or no stream trimmed ({seen})")
    check(not differ, f"joint streaming: ring and host pools differ at {differ}")
    check(finished == offline, "joint streaming: finish() over one window != offline ctc_greedy")
    check(one[-1].is_final and one[-1].text == stream_texts(bundle, sc, clips[:1])[0],
          "joint api.stream: the final text is not the transcriber's")
    return launches, rec


def phase_joint(counters, workdir: Path, card: str):
    """Main paths 14-18, the joint CTC/attention family at the published
    widths of configs/joint_ctc_attention.yaml (12 + 6 blocks of d 512, 4
    heads of 128, mlp 2048, V 4336, WF rank 8; random init, seed 0):
    JOINT_B seeded 30 s utterances through bundle.transcribe with each
    strategy (exact launches), the kernel path against the plain one, the
    beam (and the beam with a fused LM) held to the decoder's steps, K6,
    K7 and K9 at this model's shapes, timing, the CTC branch streamed, and
    `cli transcribe --strategy beam`. -> (launches by path, errors, K6's
    and K9's joint rows)."""

    import torch

    from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg
    from jiao_liao_speech_recognition_torch.decode.joint_generate import joint_greedy
    from jiao_liao_speech_recognition_torch.decode.speculative import joint_spec_greedy
    from jiao_liao_speech_recognition_torch.frontend.audio_io import write_wav
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch
    from jiao_liao_speech_recognition_torch.utils import graphs

    t_phase = time.perf_counter()
    bundle = joint_bundle()
    cfg, model = bundle.config, bundle.model
    jc = cfg.joint
    check(cfg.decode.beam_size == JOINT_BEAM and cfg.decode.max_decode_len == JOINT_MAX_LEN
          and jc.adapter.kind == "wf", f"the joint config changed: {cfg.decode}, {jc.adapter}")
    utts = stream_audio(JOINT_B, seed=21, secs=30.0)
    audio_s = JOINT_B * 30.0
    L, D = jc.num_layers, jc.decoder_layers
    paths, seconds, texts = {}, {}, {}
    for strategy, path in (("ctc_greedy", "joint_ctc_greedy"), ("greedy", "joint_greedy"),
                           ("beam", "joint_beam"), ("spec_greedy", "joint_spec")):
        dc = dataclasses.replace(cfg.decode, strategy=strategy)
        wg.STEPS.reset()
        texts[strategy], launches = drive(counters, path,
                                          lambda: bundle.transcribe(utts, decode_cfg=dc))
        steps, n = wg.STEPS.steps, wg.STEPS.passes  # n: spec_greedy's teacher-forced passes
        # the encoder: K7 a sublayer (through K2 and K3); the decoder: K9 for
        # self- and cross-attention a block a step; a teacher-forced pass of
        # 64 positions: K7-mlp a block, K6 for each cross-attention
        want = {key: 0 for key in counters} | {
            "K1": 1, "K7-attn": L, "K2": L, "K7-mlp": L + D * n, "K3": L + D * n,
            "K6": D * n, "K9": 2 * D * steps,
            "K4": int(strategy in ("ctc_greedy", "spec_greedy")),
            "CTC": int(strategy == "beam")}  # the beam's CTC rescoring
        wrong = {k: (launches[k], w) for k, w in want.items() if launches[k] != w}
        check(not wrong, f"{path}: launches (got, want): {wrong}")
        if strategy == "spec_greedy":  # the first pass eagerly, then one a replay
            check(graphs.TALLY.replays == n - 1,
                  f"{path}: {graphs.TALLY.replays} replays of the captured pass, {n} passes")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = bundle.transcribe(utts, decode_cfg=dc)
        torch.cuda.synchronize()
        seconds[strategy] = time.perf_counter() - t0
        check(again == texts[strategy], f"{path}: a second run gave other texts")
        paths[path] = launches
    emit({"phase": "joint", "config": JOINT_CONFIG, "card": card,
          "params": sum(p.numel() for p in model.parameters()),
          "utterances": JOINT_B, "audio_s": audio_s, "launches": paths,
          "seconds": seconds, "rtfx": {s: audio_s / t for s, t in seconds.items()},
          "text_chars": {s: [len(t) for t in v] for s, v in texts.items()}})
    check(all(len(v) == JOINT_B for v in texts.values())
          and sum(len(t) for t in texts["ctc_greedy"]) > 0, "joint: no text")

    # the kernel path against the plain path on the same 16 chunks
    fe = cfg.frontend
    wavs, alens, _ = bundle._prepare_audio_chunked(utts, None)
    rng = np.random.RandomState(22)
    with torch.inference_mode():
        wav = torch.from_numpy(wavs).cuda()
        flens = torch.from_numpy(alens // fe.hop_length).cuda()
        feats_k, feats_p = featurize_batch(wav, fe), featurize_batch(wav, fe, kernels=False)
        enc_k, el = model.encode(feats_k, flens)
        enc_p, _ = model.encode(feats_p, flens, kernels=False)
        ids_k = model.ctc_argmax_ids(enc_k)
        lp = model.ctc_log_probs(enc_p)
        greedy = joint_greedy(model, feats_k, flens, max_len=JOINT_MAX_LEN)
        spec = joint_spec_greedy(model, feats_k, flens, max_len=JOINT_MAX_LEN,
                                 return_passes=True)
    frames = torch.arange(ids_k.shape[1], device="cuda")[None] < el[:, None]
    clear = frames & (margins(lp) > ARGMAX_MARGIN)
    ctc = {"logmel_max_abs_err": float((feats_k - feats_p).abs().max()),
           "encoder_rel_l2": float((enc_k.float() - enc_p.float()).norm() / enc_p.float().norm()),
           "frames": int(frames.sum()), "coverage": float(clear.sum() / frames.sum()),
           "mismatched_frames": int(((ids_k != lp.argmax(-1)) & clear).sum())}
    dec = joint_decoder_checks(model, enc_k, greedy, spec)
    dec.update(joint_beam_checks(model, feats_k, flens, enc_k, el, greedy, workdir))
    emit({"phase": "joint", "vs_plain": {"ctc": ctc, **dec}})
    check(ctc["logmel_max_abs_err"] <= LOGMEL_BAR and ctc["coverage"] >= MIN_COVERAGE
          and ctc["mismatched_frames"] == 0 and ctc["encoder_rel_l2"] <= ENC_REL_BAR,
          f"joint CTC ids disagree with the plain path: {ctc}")
    errs = joint_k7_rows(model, rng)
    errs["K6"], k6_row = joint_k6(rng)

    # timing: the encoder a batch, an eager decode step (greedy at B rows,
    # the beam at B * K), the spec passes, and where a beam step's time goes
    tm = {"encoder_s_per_batch": {}}
    with torch.inference_mode():
        for kernels in (False, True, True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.encode(feats_k, flens, kernels)
            torch.cuda.synchronize()
            tm["encoder_s_per_batch"].setdefault("kernels" if kernels else "plain", []).append(
                time.perf_counter() - t0)
        # eager steps (graph=False), the readings earlier PRs kept; phase 23
        # reads the captured loops
        for name, fn in (("greedy", lambda: wg.greedy_from_enc(model, enc_k, el, JOINT_MAX_LEN,
                                                                (0,), 0, graph=False)),
                         ("beam", lambda: wg.beam_from_enc(model, enc_k, el, JOINT_BEAM,
                                                           JOINT_MAX_LEN, (0,), 0,
                                                           graph=False))):
            wg.STEPS.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            tm[f"{name}_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / wg.STEPS.steps
            tm[f"{name}_steps"] = wg.STEPS.steps
        beam_prof = device_profile(lambda i: wg.beam_from_enc(
            model, enc_k, el, JOINT_BEAM, JOINT_PROFILE_STEPS + 1, (0,), 0, graph=False), 1,
            "joint beam", top=12)
    tm["beam_rows"] = JOINT_B * JOINT_BEAM
    tm["spec_passes"] = spec[2]
    tm["beam_profile"] = {**beam_prof, "steps": JOINT_PROFILE_STEPS,
                          "note": "one beam_from_enc call of this many steps, its cache "
                                  "build included"}
    emit({"phase": "joint", "timing": tm})
    k9_rows = joint_k9_timing(rng)

    streaming_launches, _ = joint_streaming(counters, bundle, utts, texts["ctc_greedy"])
    paths["joint_stream"] = streaming_launches

    # `cli transcribe --strategy beam` of two WAVs: the bundle's texts
    wav_paths = []
    for i in range(2):
        wav_paths.append(str(workdir / f"j{i}.wav"))
        write_wav(wav_paths[-1], utts[i][:int(6.0 * SAMPLE_RATE)], SAMPLE_RATE)
    bundle.save(str(workdir / "joint"))
    lines = [json.loads(s) for s in cli_run(["transcribe", *wav_paths, "--checkpoint",
                                             workdir / "joint", "--strategy", "beam",
                                             "--beam-size", str(JOINT_BEAM)])]
    want_texts = bundle.transcribe(wav_paths)  # the config's strategy: beam of 8
    check([r["text"] for r in lines] == want_texts,
          f"joint cli transcribe --strategy beam: {lines} != {want_texts}")
    emit({"phase": "joint", "cli_beam_texts_equal": True,
          "phase_s": time.perf_counter() - t_phase})
    return paths, errs, {"K6": k6_row, "K9": k9_rows}


# --- main paths 19-20: CTC prefix beam search (configs/ctc_batched_beam.yaml) ---


def ctc_beam_bundle():
    """api.load of configs/ctc_batched_beam.yaml at its published widths
    (random init, seed 0) with a one-character-per-id vocabulary."""
    from jiao_liao_speech_recognition_torch import api
    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.utils.config import load_yaml

    cfg = load_yaml(str(Path(__file__).resolve().parent / CTC_BEAM_CONFIG))
    m, dc = cfg.ctc_model, cfg.decode
    check((m.num_layers, m.d_model, m.num_heads, m.mlp_dim, m.vocab_size) == (12, 512, 8, 2048, 4336)
          and (dc.strategy, dc.beam_size, dc.beam_topk) == ("beam", CTC_BEAM_K, CTC_BEAM_TOPK),
          f"{CTC_BEAM_CONFIG} changed: {m}, {dc}")
    bundle = api.load(config=cfg, device="cuda")
    bundle.tokenizer = CharTokenizer([chr(0x4E00 + i) for i in range(m.vocab_size - 2)])
    return bundle


def ctc_nll(lp, olens, ids, lens, rows):
    """-> the CTC negative log-likelihood [len(rows)] of each row's prefix
    (ids [B', T] and lens [B'] on the host, rows indexing them and lp) under
    log-probs lp [B, T', V] over olens valid frames (F.ctc_loss: every
    alignment summed)."""
    import torch
    import torch.nn.functional as F

    ids, lens = np.asarray(ids)[rows], np.asarray(lens)[rows]
    S = max(int(lens.max()), 1)
    x = lp[rows].float().transpose(0, 1)
    return F.ctc_loss(x, torch.from_numpy(ids[:, :S].astype(np.int64)).cuda(),
                      olens[rows].cpu().long(), torch.from_numpy(lens.astype(np.int64)),
                      blank=0, reduction="none", zero_infinity=False).cpu().numpy()


def ctc_beam_host_checks(lp, olens, dev_ids, nat_ids, engine, workdir: Path) -> dict:
    """The host searcher on CTC_BEAM_HOST_ROWS rows of the kernel path's
    log-probs: each row's winner from the device beam run in f64 on the
    card and from the native engine over the same log-probs (their f32
    top-k, unrounded) within NLL_BAR of the host searcher's winner by the
    CTC likelihood; the main path's winners (the f32 device beam, the
    engine over the f16 transfer) within NLL_REL_BAR of it; then the host
    searcher with a seeded bigram LM over the first CTC_BEAM_LM_IDS ids
    fused at CTC_BEAM_LM_WEIGHT, whose winners must differ and carry more
    LM log-prob."""
    import torch

    from jiao_liao_speech_recognition_torch.decode.ctc import (
        NEG, ctc_prefix_beam_search, ctc_prefix_beam_search_host, top_k_exact)
    from jiao_liao_speech_recognition_torch.decode.lm import NGramCharLM

    rows = list(range(CTC_BEAM_HOST_ROWS))
    lp_h = lp[rows].cpu().numpy()
    n_h = olens[rows].cpu().numpy()
    with torch.inference_mode():
        ext = lp[rows].clone()
        ext[..., 0] = NEG
        v32, i32 = (t.cpu().numpy() for t in top_k_exact(ext, CTC_BEAM_TOPK))
        dev64 = tuple(t.cpu().numpy() for t in ctc_prefix_beam_search(
            lp[rows].double(), olens[rows], CTC_BEAM_K, 0, topk_tokens=CTC_BEAM_TOPK))
    nat32 = engine.search(v32, i32, lp_h[..., 0], n_h, CTC_BEAM_K)
    t0 = time.perf_counter()
    host = ctc_prefix_beam_search_host(lp_h, n_h, CTC_BEAM_K, topk_tokens=CTC_BEAM_TOPK)
    host_s = time.perf_counter() - t0
    nll_host = ctc_nll(lp, olens, *host, rows)
    nll_dev = ctc_nll(lp, olens, *dev64, rows)
    nll_dev32 = ctc_nll(lp, olens, *dev_ids, rows)
    nll_nat = ctc_nll(lp, olens, *nat32, rows)
    nll_nat16 = ctc_nll(lp, olens, *nat_ids, rows)
    rng = np.random.RandomState(32)
    V = lp.shape[-1]
    lm = NGramCharLM.train([rng.randint(1, CTC_BEAM_LM_IDS + 1, 64) for _ in range(32)], 2, V)
    lm.save(workdir / "ctc_lm.npz")
    lm = NGramCharLM.load(workdir / "ctc_lm.npz")
    t0 = time.perf_counter()
    fused = ctc_prefix_beam_search_host(lp_h, n_h, CTC_BEAM_K, topk_tokens=CTC_BEAM_TOPK, lm=lm,
                                        lm_weight=CTC_BEAM_LM_WEIGHT)
    fused_s = time.perf_counter() - t0

    def lm_logp(ids, n):
        return sum(lm.logp(ids[:i], int(ids[i])) for i in range(int(n)))

    def in_lm(ids, lens):
        toks = np.concatenate([ids[r, :lens[r]] for r in range(len(lens))])
        return float(((toks >= 1) & (toks <= CTC_BEAM_LM_IDS)).mean()) if len(toks) else 0.0

    out = {"rows": len(rows), "host_s": host_s, "fused_host_s": fused_s, "nll_bar": NLL_BAR,
           "nll_rel_bar": NLL_REL_BAR, "nll_host": nll_host.tolist(),
           "nll_device_f64_minus_host": (nll_dev - nll_host).tolist(),
           "nll_device_f32_minus_host": (nll_dev32 - nll_host).tolist(),
           "nll_native_minus_host": (nll_nat - nll_host).tolist(),
           "nll_native_f16_transfer_minus_host": (nll_nat16 - nll_host).tolist(),
           "native_ids_equal_host": [bool(np.array_equal(nat32[0][r, :nat32[1][r]],
                                                         host[0][r, :host[1][r]])) for r in rows],
           "device_f64_ids_equal_host": [bool(np.array_equal(dev64[0][r, :dev64[1][r]],
                                                             host[0][r, :host[1][r]]))
                                         for r in rows],
           "device_f32_ids_equal_host": [bool(np.array_equal(dev_ids[0][r, :dev_ids[1][r]],
                                                             host[0][r, :host[1][r]]))
                                         for r in rows],
           "host_lengths": host[1].tolist(), "fused_lengths": fused[1].tolist(),
           "lm_weight": CTC_BEAM_LM_WEIGHT, "lm_ids": CTC_BEAM_LM_IDS,
           "rows_fused_differs": sum(not np.array_equal(fused[0][r], host[0][r]) for r in rows),
           "lm_logp_fused": sum(lm_logp(fused[0][r], fused[1][r]) for r in rows),
           "lm_logp_unfused": sum(lm_logp(host[0][r], host[1][r]) for r in rows),
           "tokens_in_lm_ids_fused": in_lm(*fused), "tokens_in_lm_ids_unfused": in_lm(*host)}
    emit({"phase": "ctc_beam", "host_searcher": out})
    check(np.all(np.isfinite(nll_host)) and np.abs(nll_dev - nll_host).max() < NLL_BAR
          and np.abs(nll_nat - nll_host).max() < NLL_BAR,
          f"CTC beam winners part by more than {NLL_BAR} nats: {out}")
    check(np.abs(nll_dev32 - nll_host).max() < NLL_REL_BAR * nll_host.min()
          and np.abs(nll_nat16 - nll_host).max() < NLL_REL_BAR * nll_host.min(),
          f"CTC beam winners at the shipped precisions part by more than {NLL_REL_BAR}: {out}")
    check(out["rows_fused_differs"] > 0 and out["lm_logp_fused"] > out["lm_logp_unfused"],
          f"CTC beam: the fused LM did not move the beam toward its tokens ({out})")
    return out


def phase_ctc_beam(counters, workdir: Path, card: str):
    """Main paths 19 and 20, CTC prefix beam search at the published widths
    of configs/ctc_batched_beam.yaml (12 x d512, 8 heads of 64, mlp 2048, V
    4336; random init, seed 0): CTC_BEAM_B seeded 30 s utterances through
    bundle.transcribe with ``beam`` (the C++ engine over the card's top-k)
    and ``beam_device`` (exact launches: K1 1, K2 and K3 12); the kernel
    path's frame argmax against the plain path's (the margin rule);
    ctc_topk_posteriors on the card bitwise the host's on the same
    log-probs in both regimes; the engine's ids at one thread and at the
    default; the host searcher's bars (ctc_beam_host_checks); the six
    requests through bundle.transcribe and `cli transcribe` twice each;
    then encoder + top-k ms, bytes to the host, the engine at two prunings,
    the device beam's ms and launches, and RTFx over a one-deep pipeline.
    -> launches by path."""

    import torch

    from jiao_liao_speech_recognition_torch.decode import ctc
    from jiao_liao_speech_recognition_torch.frontend.audio_io import write_wav
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch
    from jiao_liao_speech_recognition_torch.utils import native_ext

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    so = native_ext.build_native("beam")
    engine = native_ext.load_beam()
    build_s = time.perf_counter() - t0
    bundle = ctc_beam_bundle()
    cfg, model = bundle.config, bundle.model
    fe, L, K, k = cfg.frontend, cfg.ctc_model.num_layers, CTC_BEAM_K, CTC_BEAM_TOPK
    utts = stream_audio(CTC_BEAM_B, seed=31, secs=30.0)
    audio_s = CTC_BEAM_B * 30.0
    paths, seconds, texts = {}, {}, {}
    for strategy, path in (("beam", "ctc_beam"), ("beam_device", "ctc_beam_device")):
        dc = dataclasses.replace(cfg.decode, strategy=strategy)
        t0 = time.perf_counter()
        texts[strategy], launches = drive(counters, path,
                                          lambda: bundle.transcribe(utts, decode_cfg=dc))
        seconds[strategy] = time.perf_counter() - t0
        want = {key: 0 for key in counters} | {"K1": 1, "K2": L, "K3": L}
        wrong = {key: (launches[key], w) for key, w in want.items() if launches[key] != w}
        check(not wrong, f"{path}: launches (got, want): {wrong}")
        paths[path] = launches
    emit({"phase": "ctc_beam", "config": CTC_BEAM_CONFIG, "card": card,
          "library": so.name, "native_build_s": build_s,
          "params": sum(p.numel() for p in model.parameters()), "utterances": CTC_BEAM_B,
          "beam": K, "topk": k, "launches": paths, "seconds_transcribe": seconds,
          "rtfx_transcribe": {s: audio_s / t for s, t in seconds.items()},
          "text_chars": {s: sum(len(t) for t in v) for s, v in texts.items()}})
    check(all(len(v) == CTC_BEAM_B for v in texts.values())
          and all(sum(len(t) for t in v) > 0 for v in texts.values()), "CTC beam: no text")

    # the kernel path against the plain path on the same 128 chunks
    wavs, alens, _ = bundle._prepare_audio_chunked(utts, None)
    with torch.inference_mode():
        wav = torch.from_numpy(wavs).cuda()
        flens = torch.from_numpy(alens // fe.hop_length).cuda()
        feats_k = featurize_batch(wav, fe)
        lp, olens = model(feats_k, flens)
        lp_p, _ = model(featurize_batch(wav, fe, kernels=False), flens, kernels=False)
    frames = torch.arange(lp.shape[1], device="cuda")[None] < olens[:, None]
    clear = frames & (margins(lp_p) > ARGMAX_MARGIN)
    vs = {"frames": int(frames.sum()), "coverage": float(clear.sum() / frames.sum()),
          "mismatched_frames": int(((lp.argmax(-1) != lp_p.argmax(-1)) & clear).sum()),
          "log_probs_max_abs_diff": float((lp - lp_p).abs().max())}
    del lp_p
    emit({"phase": "ctc_beam", "vs_plain": vs})
    check(vs["coverage"] >= MIN_COVERAGE and vs["mismatched_frames"] == 0,
          f"CTC beam: the kernel path's frame argmax disagrees with plain: {vs}")

    # ctc_topk_posteriors on the card against the host, both regimes
    with torch.inference_mode():
        top = ctc.ctc_topk_posteriors(lp, k)
        top_host = ctc.ctc_topk_posteriors(lp.cpu(), k)
        exact = ctc.ctc_topk_posteriors(lp[:2], lp.shape[-1] - 1)
        exact_host = ctc.ctc_topk_posteriors(lp[:2].cpu(), lp.shape[-1] - 1)
    topk_rec = {"dtypes": [str(t.dtype) for t in top],
                "exact_dtypes": [str(t.dtype) for t in exact],
                "bitwise_equal_host": all(torch.equal(a.cpu(), b) for a, b in zip(top, top_host)),
                "exact_bitwise_equal_host": all(torch.equal(a.cpu(), b)
                                                for a, b in zip(exact, exact_host)),
                "bytes_to_host": sum(t.numel() * t.element_size() for t in top),
                "bytes_full_rows": lp.numel() * lp.element_size()}
    del top_host, exact, exact_host
    emit({"phase": "ctc_beam", "topk": topk_rec})
    check(topk_rec["bitwise_equal_host"] and topk_rec["exact_bitwise_equal_host"]
          and topk_rec["dtypes"] == ["torch.float16", "torch.int16", "torch.float16"],
          f"ctc_topk_posteriors on the card differs from the host: {topk_rec}")

    # the engine: one thread against the default, two prunings (timed)
    vals, ids, blank = (t.cpu().numpy() for t in top)
    lens_h = olens.cpu().numpy()
    eng = {}
    for name, threads, prune in (("threads_1", 1, 0.0), ("default", 0, 0.0),
                                 ("prune_-10", 0, -10.0)):
        t0 = time.perf_counter()
        eng[name] = engine.search(vals, ids, blank, lens_h, K, threads, prune)
        eng[name + "_ms"] = 1e3 * (time.perf_counter() - t0)
    same_threads = all(np.array_equal(a, b) for a, b in zip(eng["threads_1"], eng["default"]))
    prune_equal = all(np.array_equal(a, b) for a, b in zip(eng["prune_-10"], eng["default"]))

    # the device beam: timed, and its launches under the profiler over two
    # short prefixes of the frames (a frame's launches are their difference;
    # profiling all 750 frames' ~60,000 launches took ~40 s of host time)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = ctc.ctc_prefix_beam_search(lp, olens, K, 0, topk_tokens=min(k, 16), graph=False)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        profs = [device_profile(lambda i, n=n: ctc.ctc_prefix_beam_search(
            lp[:, :n], olens.clamp(max=n), K, 0, topk_tokens=min(k, 16), graph=False), 1,
            f"ctc device beam, {n} frames", top=6) for n in CTC_BEAM_PROFILE_FRAMES]
    (n1, n2), (c1, c2) = CTC_BEAM_PROFILE_FRAMES, (p["launches_per_call"] for p in profs)
    per_frame = (c2 - c1) / (n2 - n1)
    frames_run = int(olens.max())
    dev_ids = tuple(t.cpu().numpy() for t in dev)
    engine_rec = {"threads_1_ms": eng["threads_1_ms"], "default_threads_ms": eng["default_ms"],
                  "prune_-10_ms": eng["prune_-10_ms"], "threads_ids_equal": same_threads,
                  "prune_-10_texts_equal_prune_0": prune_equal,
                  "note": "random-init rows are flat: every frame keeps its full candidate "
                          "set, which overstates the engine's cost on a trained model",
                  "device_beam_ms": 1e3 * dev_s, "device_beam_frames": frames_run,
                  "device_beam_launches_per_frame": per_frame,
                  "device_beam_launches_per_batch": c1 + per_frame * (frames_run - n1),
                  "device_beam_profiles": dict(zip(CTC_BEAM_PROFILE_FRAMES, profs))}
    emit({"phase": "ctc_beam", "engine": engine_rec})
    check(same_threads, "the native engine's ids differ between 1 thread and the default")
    ctc_beam_host_checks(lp, olens, dev_ids, eng["default"], engine, workdir)

    # the six requests: bundle.transcribe and `cli transcribe`, twice each
    requests = make_requests()
    wav_paths = []
    for i, r in enumerate(requests):
        wav_paths.append(str(workdir / f"b{i}.wav"))
        write_wav(wav_paths[-1], r, SAMPLE_RATE)
    bundle.save(str(workdir / "ctc_beam"))
    req = {}
    for strategy in ("beam", "beam_device"):
        dc = dataclasses.replace(cfg.decode, strategy=strategy)
        a, b = (bundle.transcribe(wav_paths, decode_cfg=dc) for _ in range(2))
        lines = [[json.loads(s)["text"] for s in cli_run(
            ["transcribe", *wav_paths, "--checkpoint", workdir / "ctc_beam", "--strategy",
             strategy, "--beam-size", str(K)])] for _ in range(2)]
        req[strategy] = {"same_twice": a == b, "cli_same_twice": lines[0] == lines[1],
                         "cli_equals_bundle": lines[0] == a, "chars": [len(t) for t in a]}
    emit({"phase": "ctc_beam", "requests": req})
    check(all(v["same_twice"] and v["cli_same_twice"] and v["cli_equals_bundle"]
              for v in req.values()), f"CTC beam requests: {req}")

    # timing: encoder + top-k a batch on both paths, then RTFx by
    # bench.py::bench_beam_rtfx's one-deep pipeline (the card on the next
    # batch while the engine runs this one)
    bufs = [wav, torch.roll(wav, 1, 0) + 1e-4]

    def infer(w, kernels=True):
        with torch.inference_mode():
            f = featurize_batch(w, fe, kernels=kernels)
            x, n = model(f, flens, kernels=kernels)
            return (*ctc.ctc_topk_posteriors(x, k), n)

    tm = {}
    for kernels in (False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infer(bufs[0], kernels)
        torch.cuda.synchronize()
        tm.setdefault("kernels" if kernels else "plain", []).append(1e3 * (time.perf_counter() - t0))

    def pipeline(prune, batches=CTC_BEAM_RTFX_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = infer(bufs[0])
        for i in range(1, batches + 1):
            nxt = infer(bufs[i % 2]) if i < batches else None
            v, t, bl, n = (a.cpu().numpy() for a in pending)
            engine.search(v, t, bl, n, K, 0, prune)
            pending = nxt
        return audio_s * batches / (time.perf_counter() - t0)

    rtfx = {"prune_0": pipeline(0.0), "prune_-10": pipeline(-10.0)}
    emit({"phase": "ctc_beam", "timing": {
        "encoder_topk_ms_per_batch": tm, "batch": CTC_BEAM_B,
        "rtfx_pipelined": rtfx, "rtfx_batches": CTC_BEAM_RTFX_BATCHES,
        "rtfx_note": "random-init weights: not a ledger number",
        "phase_s": time.perf_counter() - t_phase}})
    del lp, top, wav, bufs
    return paths


# --- main paths 21-22: joint CTC/attention training (configs/joint_ctc_attention.yaml) ---


def joint_flash_rows(rng):
    """K6 and K8 alone at the joint encoder's training shape (B 16, T' 750,
    4 heads of 128, key lengths 750 / 517 / 129 / 1): ``flash_train_rows``,
    then ptxas's report of the dh=128 instances."""
    from jiao_liao_speech_recognition_torch import _build

    errs, rows = flash_train_rows(rng, JOINT_B, 750, 4, 128, [750, 517, 129, 1], "joint_train",
                                  "joint training")
    ptxas = {name: {"registers": r, "spill_store_bytes": st, "spill_load_bytes": ld}
             for name, (r, st, ld) in _build.ptxas_report().items()
             if any(f"{kern}ILi128E" in name for kern in
                    ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"))}
    emit({"phase": "build", "flash_dh128_ptxas": ptxas})
    return errs, rows


def flash_train_rows(rng, B, T, H, dh, lens4, tag: str, what: str, plain_iters: int = 10):
    """K6 and K8 alone at a training shape (B rows, T positions, H heads of
    dh, key lengths `lens4` repeated over the rows): K6's out within
    ULP_BAR and lse within LSE_BAR, each K8 gradient within GRAD_REL_BAR,
    exact zeros past kv_len, two launches bitwise each; then both timed
    (queued; the plain versions over `plain_iters` calls) beside plain,
    their bound and the library's masked forward and backward. -> (errors,
    rows)."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import flash_attention as fl

    lens = (list(lens4) * B)[:B]
    q, k, v, kl, dout = _flash_inputs(rng, B, T, H, dh, lens, "cuda")
    with torch.inference_mode():
        out, lse = fl.flash_forward(q, k, v, kl)
        out_p, lse_p = fl.flash_forward_plain(q, k, v, kl)
        grads = fl.flash_backward(q, k, v, kl, out, lse, dout)
        grads_p = fl.flash_backward_plain(q, k, v, kl, out, lse, dout)
        again = (*fl.flash_forward(q, k, v, kl), *fl.flash_backward(q, k, v, kl, out, lse, dout))
        torch.cuda.synchronize()
    bitwise = [torch.equal(a, b) for a, b in zip((out, lse, *grads), again)]
    ulps = bf16_ulp_err(out, out_p)[0]
    lse_err = float((lse - lse_p).abs().max())
    rel = {n: float((g.float() - w).abs().max() / w.abs().max())
           for n, g, w in zip(("dq", "dk", "dv"), grads, grads_p)}
    pad = torch.arange(T, device="cuda")[None, :] >= kl[:, None]
    pad_max = float(torch.maximum(grads[1].float().abs().amax((2, 3)),
                                  grads[2].float().abs().amax((2, 3)))[pad].max())
    errs = {"K6": float((out.float() - out_p.float()).abs().max()),
            "K8": max(float((g.float() - w).abs().max()) for g, w in zip(grads, grads_p))}
    del out_p, lse_p, grads_p, again
    emit({"phase": "kernels", "kernel": "K6/K8", tag: True, "B": B, "T": T,
          "heads": H, "dh": dh, "lens": lens[:4], "out_ulps": ulps, "bar_ulps": ULP_BAR,
          "lse_max_abs_err": lse_err, "lse_bar": LSE_BAR, "grad_rel_err": rel,
          "grad_bar": GRAD_REL_BAR, "padded_key_grad_max": pad_max,
          "two_launches_bitwise_equal": bitwise})
    check(ulps <= ULP_BAR and lse_err <= LSE_BAR, f"K6 ({what}) off: {ulps}, {lse_err}")
    check(all(r <= GRAD_REL_BAR for r in rel.values()) and pad_max == 0.0,
          f"K8 ({what}) off: {rel}, padded {pad_max}")
    check(all(bitwise), f"K6/K8 ({what}): two launches differ ({bitwise})")

    with torch.inference_mode():
        pairs = {"K6": (lambda: fl.flash_forward(q, k, v, kl),
                        lambda: fl.flash_forward_plain(q, k, v, kl)),
                 "K8": (lambda: fl.flash_backward(q, k, v, kl, out, lse, dout),
                        lambda: fl.flash_backward_plain(q, k, v, kl, out, lse, dout))}
        turns = {key: (cuda_ms(p, plain_iters), queued_ms(f), queued_ms(f),
                       cuda_ms(p, plain_iters))
                 for key, (f, p) in pairs.items()}
    lib_fwd, lib_bwd = _yardsticks().sdpa_ms(q, k, v, kl, dout)
    n, full = sum(lens), B * T * H * dh * 2
    # q (and dout, out) read and out (dq, dK, dV) written on every row, K and
    # V read on the valid keys, lse (and delta) and the lengths; QK^T and PV
    # on the valid keys forward, five such products backward
    work = {"K6": (2 * full + 2 * n * H * dh * 2 + B * H * T * 4 + B * 4,
                   {"bf16": 4.0 * H * dh * T * n}),
            "K8": (6 * full + 2 * n * H * dh * 2 + B * H * T * 4 + B * 4,
                   {"bf16": 10.0 * H * dh * T * n})}
    rows = {}
    for key, (p1, k1, k2, p2) in turns.items():
        bound_ms, bound_by = bound(*work[key])
        rows[key] = {"shape": f"B={B}, T={T}, {H} x {dh} (lengths {min(lens)}-{max(lens)}, "
                              f"{what})",
                     "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_fwd if key == "K6" else lib_bwd,
                     "executed_tflops": tflops(flash_flops("fwd" if key == "K6" else "bwd",
                                                           B, T, lens, H, dh), (k1 + k2) / 2)}
        emit({"phase": "timing", "kernel": key, tag: True, **rows[key],
              "turns_ms": [p1, k1, k2, p2]})
    return errs, rows


def phase_joint_train(counters, workdir: Path, card: str):
    """Main paths 21 and 22, joint CTC/attention training: `cli train` of
    configs/joint_ctc_attention.yaml at its published widths (12 + 6
    blocks of d512, 4 heads of 128, WF rank 8, train_adapters_only,
    ctc_weight 0.3) on JOINT_B seeded 30 s WAVs with seeded texts of 4,334
    characters (V 4336), JOINT_TRAIN_STEPS steps: exact launches a step
    (K1 1, K6 and K8 one an encoder block; the decoder's teacher-forced
    pass of 130 positions takes the einsum path), the three losses finite,
    the backbone bitwise and every WF insert moved; one step's losses and
    adapter gradients on the kernel path against plain; K6 and K8 alone at
    the encoder's shape; the saved bundle loaded by api.load and served
    with ctc_greedy and greedy (exact launches); steps/s in turns and the
    step's idle share. -> (launches by path, errors, K6 and K8 rows)."""

    import torch

    from jiao_liao_speech_recognition_torch import api
    from jiao_liao_speech_recognition_torch.data.manifest import read_manifest
    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg
    from jiao_liao_speech_recognition_torch.models.adapters import param_is_adapter
    from jiao_liao_speech_recognition_torch.train import engine
    from jiao_liao_speech_recognition_torch.utils.config import apply_overrides, load_yaml

    t_phase = time.perf_counter()
    manifest = write_corpus(workdir, n=JOINT_B, seed=41)
    ckpt = workdir / "ckpt"
    overrides = [f"data.train_manifest={manifest}", f"data.eval_manifest={workdir / 'none.jsonl'}",
                 f"train.checkpoint_dir={ckpt}", f"train.metrics_path={workdir / 'm.jsonl'}",
                 f"train.optimizer.total_steps={JOINT_TRAIN_STEPS}", "train.log_every_steps=1"]
    t0 = time.perf_counter()
    lines, launches = drive(counters, "joint_train", lambda: cli_run(
        ["train", "--config", Path(__file__).resolve().parent / JOINT_CONFIG, *overrides]))
    train_s = time.perf_counter() - t0
    cfg = apply_overrides(load_yaml(str(Path(__file__).resolve().parent / JOINT_CONFIG)),
                          overrides)
    jc, n = cfg.joint, JOINT_TRAIN_STEPS
    records = [json.loads(s) for s in (workdir / "m.jsonl").read_text().splitlines()]
    want = {key: 0 for key in counters} | {"K1": n, "K6": jc.num_layers * n,
                                           "K8": jc.num_layers * n, "CTC": n, "CTC-bwd": n}
    wrong = {key: (launches[key], w) for key, w in want.items() if launches[key] != w}
    final = ckpt / "final"
    trained = api.load(str(final), device="cuda")
    tok = trained.tokenizer
    cfg.joint.vocab_size = len(tok)
    init = engine.make_model(cfg, "cuda").state_dict()
    frozen_same = moved = n_adapters = b_moved = n_b = 0
    for key, v in trained.model.state_dict().items():
        same = torch.equal(v, init[key])
        if param_is_adapter(key):
            n_adapters += 1
            moved += not same
            if key.endswith(".b"):  # B starts at zero: it moves first
                n_b += 1
                b_moved += not same
        else:
            frozen_same += same
    n_frozen = len(init) - n_adapters
    emit({"phase": "joint_train", "config": JOINT_CONFIG, "card": card,
          "params": sum(p.numel() for p in trained.model.parameters()),
          "vocab": len(tok), "batch": cfg.data.batch_size, "steps": n,
          "ctc_weight": jc.ctc_weight, "cli_last_line": lines[-1],
          "losses": [{k: r[k] for k in ("loss", "loss_ctc", "loss_att")} for r in records],
          "seconds_cli_train": train_s, "launches": launches,
          "backbone_tensors_unchanged": f"{frozen_same}/{n_frozen}",
          "adapter_tensors_moved": f"{moved}/{n_adapters}",
          "adapter_b_tensors_moved": f"{b_moved}/{n_b}"})
    check(not wrong, f"joint_train: launches (got, want): {wrong}")
    check(len(records) == n and all(math.isfinite(r[k]) for r in records
                                    for k in ("loss", "loss_ctc", "loss_att")),
          f"joint train losses: {records}")
    check(len(tok) == 4336 and frozen_same == n_frozen and n_b > 0 and b_moved == n_b,
          "joint train: the backbone moved or an adapter B insert did not")

    m = read_manifest(manifest)
    step_vs_plain("joint_train", cfg, m, CharTokenizer.build(m.texts()), adapters_only=True)
    errs, rows = joint_flash_rows(np.random.RandomState(42))

    # the trained bundle served: ctc_greedy and greedy (exact launches)
    utts = stream_audio(2, seed=43, secs=20.0)
    L, D = jc.num_layers, jc.decoder_layers
    paths = {"joint_train": launches}
    served = {}
    for strategy in ("ctc_greedy", "greedy"):
        dc = dataclasses.replace(trained.config.decode, strategy=strategy)
        path = f"joint_trained_{strategy}"
        wg.STEPS.reset()
        served[strategy], paths[path] = drive(counters, path,
                                              lambda: trained.transcribe(utts, decode_cfg=dc))
        want = {key: 0 for key in counters} | {
            "K1": 1, "K7-attn": L, "K2": L, "K7-mlp": L, "K3": L,
            "K4": int(strategy == "ctc_greedy"), "K9": 2 * D * wg.STEPS.steps}
        wrong = {key: (paths[path][key], w) for key, w in want.items() if paths[path][key] != w}
        check(not wrong, f"{path}: launches (got, want): {wrong}")
    emit({"phase": "joint_train", "served": {s: [len(t) for t in v] for s, v in served.items()},
          "launches": {p: v for p, v in paths.items() if p.startswith("joint_trained_")}})
    check(all(len(v) == 2 and all(isinstance(t, str) for t in v) for v in served.values()),
          "the trained joint bundle did not transcribe")

    # the captured step against graph=False, then steps/s on both routes
    del trained
    routes_held("joint_train", cfg, m, tok, workdir)
    rate = route_rates("B16x30s_joint_ctc_attention_yaml", cfg, engine.make_model(cfg, "cuda"),
                       host_batches(cfg, m, tok))
    emit({"phase": "joint_train", "phase_s": time.perf_counter() - t_phase,
          "captured_steps_s": rate["captured_steps_s"], "eager_steps_s": rate["eager_steps_s"]})
    return paths, errs, rows


# --- main paths 23-25: Whisper fine-tuning (configs/whisper_large_v3_adapters.yaml) ---


def write_bpe_standin(d: Path, texts, seed: int) -> Path:
    """A byte-level BPE directory in the HF format ``ByteLevelBPE.from_hf_dir``
    reads (vocab.json, merges.txt), with large-v3's id layout: 51,866 ids,
    the 50,257 ordinary tokens first and Whisper's specials at large-v3's
    ids (<|endoftext|> 50257, <|startoftranscript|> 50258, 100 language
    tokens from 50259 with <|zh|> at 50260, <|translate|> 50359,
    <|transcribe|> 50360, <|startoflm|> 50361, <|startofprev|> 50362,
    <|nospeech|> 50363, <|notimestamps|> 50364, 1,501 timestamps from 50365).
    large-v3's real vocab.json and merges.txt are not in the repository,
    so this is a stand-in made from the seed: the 256 byte symbols, merges
    that make every character of `texts` one token, then seeded merges of
    existing tokens up to 50,257."""
    from jiao_liao_speech_recognition_torch.data.bpe import bytes_to_unicode

    b2u = bytes_to_unicode()
    vocab = {sym: i for i, sym in enumerate(b2u.values())}
    merges = []

    def add(a, b):
        if a + b not in vocab:
            vocab[a + b] = len(vocab)
            merges.append((a, b))

    for ch in sorted({c for t in texts for c in t if not c.isspace()}):
        syms = [b2u[b] for b in ch.encode("utf-8")]
        for i in range(1, len(syms)):
            add("".join(syms[:i]), syms[i])
    rng = np.random.RandomState(seed)
    keys = list(vocab)
    while len(vocab) < WHISPER_FT_EOT:
        a, b = keys[rng.randint(len(keys))], keys[rng.randint(256)]
        if a + b not in vocab:
            add(a, b)
            keys.append(a + b)
    langs = [f"<|lang{i:02d}|>" for i in range(100)]
    langs[1] = "<|zh|>"
    specials = (["<|endoftext|>", "<|startoftranscript|>", *langs, "<|translate|>",
                 "<|transcribe|>", "<|startoflm|>", "<|startofprev|>", "<|nospeech|>",
                 "<|notimestamps|>"] + [f"<|{0.02 * i:.2f}|>" for i in range(1501)])
    for name in specials:
        vocab[name] = len(vocab)
    check(len(vocab) == 51866 and vocab["<|zh|>"] == 50260 and vocab["<|0.00|>"] == 50365,
          f"BPE stand-in: {len(vocab)} ids")
    d.mkdir(parents=True, exist_ok=True)
    (d / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges),
                                  encoding="utf-8")
    return d


def k7_attn_route_plain(x, g, bl, base, wf, heads, eps, wf_scale, lens):
    """The plain versions of K7's d=1280 route, each launch's rounding
    points kept: the f32 fold, K5 (ln_qkv_plain), K6 (flash_forward_plain),
    K2h-out (fc2_residual_plain)."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import flash_attention as fl
    from jiao_liao_speech_recognition_torch.ops import fused_attention as fa
    from jiao_liao_speech_recognition_torch.ops import fused_mlp as fm

    w = {k: fa.fold_wf(base[k], wf[n], wf_scale) for n, k in fa.WF_PROJECTIONS}
    bf = torch.bfloat16
    q, k, v = fm.ln_qkv_plain(x, g, bl, *fm.pack_qkv(w["wq"], base["bq"], w["wk"], w["wv"],
                                                     base["bv"], bf), eps)
    B, T, D = q.shape
    o, _ = fl.flash_forward_plain(*(t.reshape(B, T, heads, D // heads) for t in (q, k, v)), lens)
    return fm.fc2_residual_plain(x, o.reshape(B, T, D), w["wo"].to(bf), base["bo"].to(bf))


def k7_d1280_rows(model, rng):
    """K7 at the large-v3 encoder's width on the trained model's first block
    (its weights and WF inserts), B=16 x 1500, attention also at the ragged
    B=7: each within ULP_BAR of the plain versions of its route and bitwise
    over two calls; then each timed beside its plain version and its bound.
    -> (errors, rows)."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import fused_attention as fa
    from jiao_liao_speech_recognition_torch.ops import fused_mlp as fm

    blk = model.encoder.blocks[0]
    sa, ln, mln, m = blk.self_attn, blk.self_attn_ln, blk.mlp_ln, blk.mlp
    base, inserts = sa.wf_params()
    H, scale, r = sa.num_heads, float(blk.adapter.scale), blk.adapter.wf_rank
    B, T, d, mlp = WHISPER_B, WHISPER_T, model.cfg.d_model, model.cfg.mlp_dim
    x = torch.from_numpy((0.5 * rng.randn(B, T, d)).astype(np.float32)).to("cuda", torch.bfloat16)
    full = torch.full((B,), T, dtype=torch.int32, device="cuda")
    ragged = torch.tensor([1500, 1033, 257, 1, 750, 1499, 129], dtype=torch.int32, device="cuda")
    wf1, wf2 = m.fc1.insert(), m.fc2.insert()
    calls = {
        "K7-attn": (lambda xx, ll: fa.fused_attention_sublayer_wf(
            xx, ln.scale, ln.bias, base, inserts, H, ln.eps, scale, ll),
            lambda xx, ll: k7_attn_route_plain(xx, ln.scale, ln.bias, base, inserts, H, ln.eps,
                                               scale, ll)),
        "K7-mlp": (lambda xx, ll: fm.fused_ln_mlp_residual_wf(
            xx, mln.scale, mln.bias, m.fc1.kernel, m.fc1.bias, m.fc2.kernel, m.fc2.bias, wf1, wf2,
            mln.eps, m.gelu_form, scale),
            lambda xx, ll: fm.ln_mlp_residual_wf_plain(
                xx, mln.scale, mln.bias, m.fc1.kernel, m.fc1.bias, m.fc2.kernel, m.fc2.bias, wf1,
                wf2, mln.eps, m.gelu_form, scale)),
    }
    errs, rows = {}, {}
    with torch.inference_mode():
        for key, (kern, plain) in calls.items():
            cases = [(x, full)] + ([(x[:7], ragged)] if key == "K7-attn" else [])
            err = 0.0
            for xx, ll in cases:
                got, again, want = kern(xx, ll), kern(xx, ll), plain(xx, ll)
                err = max(err, _ulp_check(key, got, want, d1280=True, B=xx.shape[0],
                                          lens=ll[:4].tolist(), bitwise=torch.equal(got, again)))
                check(torch.equal(got, again), f"{key} at d=1280: two calls differ")
                del got, again, want
            errs[key] = err
            turns = (cuda_ms(lambda: plain(x, full), 3), queued_ms(lambda: kern(x, full)),
                     queued_ms(lambda: kern(x, full)), cuda_ms(lambda: plain(x, full), 3))
            N = B * T
            if key == "K7-attn":
                nbytes = 2 * N * d * 2 + 4 * (4 * d * d + 3 * d) + 4 * 4 * r * 2 * d
                ops = {"bf16": 2.0 * N * d * 3 * d + 4.0 * d * T * N + 2.0 * N * d * d,
                       "f32": 4 * 2.0 * d * r * d}
            else:
                nbytes = 2 * N * d * 2 + 4 * (2 * d * mlp + d + mlp) + 4 * 2 * r * (d + mlp)
                ops = {"bf16": 4.0 * N * d * mlp, "f32": 2 * 2.0 * d * r * mlp}
            bound_ms, bound_by = bound(nbytes, ops)
            ms = (turns[1] + turns[2]) / 2
            rows[key] = {"shape": f"B={B}, T={T}, d={d} (large-v3 encoder, WF rank {r})",
                         "ms": ms, "plain_ms": (turns[0] + turns[3]) / 2, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None,
                         "tflops": tflops(ops["bf16"], ms)}
            emit({"phase": "timing", "kernel": key, "d1280": True, **rows[key],
                  "turns_ms": list(turns)})
    return errs, rows


def adapted_int8_kernel_checks(qmodel, enc, rng) -> dict:
    """K10, K11 and K9-int8 on the quantized WF-adapted decoder's own
    tensors at decode-step rows (16): block 0's q_proj (its int8 kernel with
    the WF insert beside it) within ULP_BAR, the int8 tied logits within
    LOGITS_REL_BAR, the int8 cross caches read by K9-int8 within ULP_BAR;
    each twice bitwise. -> errors."""
    import torch

    from jiao_liao_speech_recognition_torch.models.layers import int8_cache_attention

    blk = qmodel.decoder.blocks[0]
    lin = blk.self_attn.q_proj
    check(hasattr(lin, "adapter_wf") and lin.kernel_q.dtype == torch.int8,
          "the quantized decoder lost its WF inserts")
    R, d = WHISPER_B, qmodel.cfg.d_model
    H, dh = qmodel.cfg.num_heads, d // qmodel.cfg.num_heads
    x = torch.from_numpy((rng.randn(R, 1, d)).astype(np.float32)).to("cuda", torch.bfloat16)
    cross = {}
    B = enc.shape[0]
    qh = torch.from_numpy(rng.randn(B, H, 1, dh).astype(np.float32)).to("cuda", torch.bfloat16)
    lens = torch.full((B,), enc.shape[1], dtype=torch.int32, device="cuda")
    table = qmodel.decoder.embed_tokens
    fns = {
        "K10": lambda k: lin(x, k),
        "K11": lambda k: table.attend(x[:, 0], torch.bfloat16, k),
        "K9-int8": lambda k: int8_cache_attention(qh, cross["k"], cross["k_scale"], cross["v"],
                                                  cross["v_scale"], lens, None, torch.bfloat16,
                                                  kernels=k),
    }
    errs = {}
    with torch.inference_mode():
        cross = qmodel.init_cache(enc.shape[0], enc, 8)["block_0"]["cross"]
        for key, fn in fns.items():
            got, again, want = fn(True), fn(True), fn(False)
            check(torch.equal(got, again), f"{key} (WF-adapted int8 decoder): two calls differ")
            if key == "K11":
                rel = float((got - want).abs().max() / want.abs().max())
                emit({"phase": "kernels", "kernel": key, "wf_adapted_int8": True,
                      "rel_err": rel, "bar": LOGITS_REL_BAR})
                check(rel <= LOGITS_REL_BAR, f"K11 (WF-adapted) off by {rel}")
                errs[key] = float((got - want).abs().max())
            else:
                errs[key] = _ulp_check(key, got, want, wf_adapted_int8=True, rows=x.shape[0])
    return errs


def whisper_step_vs_plain(model, cfg, manifest, tok):
    """One train step at B=WHISPER_FT_CHECK_B with dropout and SpecAugment
    off on the trained model, on the kernel path (K1, K6, K8), the plain
    path and the plain path in float32: the loss within FT_STEP_LOSS_BAR of
    the plain path's; the 1,536 adapter gradients, concatenated, within
    FT_GRAD_BAR relative L2 of the plain path's, their median tensor too,
    and no farther from the f32 step's than the plain path's are, plus
    FT_GRAD_BAR. Per tensor, the rules are reported, not held: through 32 +
    32 bf16 blocks the two bf16 paths part on single tensors (the rank-16 g
    inserts most) by more than either's distance from f32 (up to 26% of a
    tensor's largest element, plain against f32), so a per-tensor bar
    measures that noise, not the kernels. Then one AdamW update from the
    kernel path's gradients leaves every backbone tensor bitwise and moves
    every WF B."""
    import copy

    import torch

    from jiao_liao_speech_recognition_torch.data.pipeline import BatchIterator
    from jiao_liao_speech_recognition_torch.decode.whisper_generate import resolve_specials
    from jiao_liao_speech_recognition_torch.train import engine

    cfg = copy.deepcopy(cfg)
    cfg.whisper.dropout = cfg.whisper.adapter.dropout = 0.0
    cfg.specaugment.enabled = False
    cfg.data.batch_size = WHISPER_FT_CHECK_B
    prompt, eot = resolve_specials(cfg.whisper)
    batch = engine.batch_to_device(next(BatchIterator(manifest, tok, cfg.data)), "cuda",
                                   family="whisper", whisper_prompt=prompt, eot_id=eot)
    params = engine.set_trainable(model, True)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    model32 = copy.deepcopy(model)
    model32.cfg.dtype = "float32"  # the encoder's and decoder's cfg: one object
    cfg32 = copy.deepcopy(cfg)
    cfg32.whisper.dtype = "float32"
    params32 = [p for p in model32.parameters() if p.requires_grad]
    runs = {}
    for run, mdl, ps, c, kernels in (("kernels", model, params, cfg, True),
                                     ("plain", model, params, cfg, False),
                                     ("f32", model32, params32, cfg32, False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = engine.make_loss_fn(c, mdl)(batch, (0, 0), True, kernels)
        grads = [g.float() for g in torch.autograd.grad(loss, ps)]
        torch.cuda.synchronize()
        runs[run] = (float(loss.detach()), grads, time.perf_counter() - t0)
    del model32, params32
    (lk, gk, sk), (lp, gp, sp), (l32, g32, _) = runs["kernels"], runs["plain"], runs["f32"]
    loss_rel = abs(lk - lp) / abs(lp)

    def err(a, b):  # the largest element error in b's largest magnitude
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    def l2(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))

    rel = [err(a, b) for a, b in zip(gk, gp)]
    k32, p32 = [err(a, w) for a, w in zip(gk, g32)], [err(b, w) for b, w in zip(gp, g32)]
    rel_l2 = [l2(a, b) for a, b in zip(gk, gp)]
    p32_l2 = [l2(b, w) for b, w in zip(gp, g32)]
    flat = [torch.cat([g.flatten() for g in gs]) for gs in (gk, gp, g32)]
    whole = l2(flat[0], flat[1])
    whole_k32, whole_p32 = l2(flat[0], flat[2]), l2(flat[1], flat[2])
    del flat
    over = [(r, p, n) for r, p, n in zip(rel_l2, p32_l2, names) if r > p + FT_GRAD_BAR]
    worst = sorted(zip(rel, names), reverse=True)[:4]
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    bs = {n: p.detach().clone() for n, p in model.named_parameters() if n.endswith("adapter_wf.b")}
    state = engine.init_state(cfg, model)
    for p, g in zip(params, gk):
        p.grad = g
    engine.apply_update(state, cfg.train.optimizer, lambda _: cfg.train.optimizer.learning_rate)
    named = dict(model.named_parameters())
    unchanged = sum(torch.equal(named[n], v) for n, v in frozen.items())
    b_moved = sum(not torch.equal(named[n], v) for n, v in bs.items())
    del frozen, bs, gk, gp, g32, runs
    emit({"phase": "whisper_finetune", "vs_plain": {
        "batch": WHISPER_FT_CHECK_B, "tokens": list(batch["tokens"].shape),
        "loss_kernels": lk, "loss_plain": lp, "loss_f32": l32, "loss_rel_err": loss_rel,
        "loss_bar": FT_STEP_LOSS_BAR, "adapter_tensors": len(rel),
        "grad_rel_l2_all": whole, "grad_rel_l2_median": statistics.median(rel_l2),
        "grad_rel_l2_max": max(rel_l2), "kernels_vs_f32_l2_all": whole_k32,
        "plain_vs_f32_l2_all": whole_p32, "plain_vs_f32_l2_median": statistics.median(p32_l2),
        "plain_vs_f32_l2_max": max(p32_l2), "grad_bar": FT_GRAD_BAR,
        "report_tensors_over_plain_f32_error_plus_bar": len(over),
        "report_worst_over": sorted(over, reverse=True)[:4], "elementwise_in_max": {
            "kernels_vs_plain_max": max(rel), "kernels_vs_plain_median": statistics.median(rel),
            "kernels_vs_f32_max": max(k32), "kernels_vs_f32_median": statistics.median(k32),
            "plain_vs_f32_max": max(p32), "plain_vs_f32_median": statistics.median(p32),
            "worst_kernels_vs_plain": worst},
        "step_s_kernels": sk, "step_s_plain": sp,
        "backbone_tensors_unchanged": f"{unchanged}/{len(named) - len(params)}",
        "wf_b_tensors_moved": f"{b_moved}/{sum(n.endswith('adapter_wf.b') for n in names)}"}})
    check(math.isfinite(lk) and loss_rel <= FT_STEP_LOSS_BAR, f"loss {lk} vs plain {lp}")
    check(whole <= FT_GRAD_BAR and statistics.median(rel_l2) <= FT_GRAD_BAR,
          f"adapter gradients off by {whole} (all) / {statistics.median(rel_l2)} (median)")
    check(whole_k32 <= whole_p32 + FT_GRAD_BAR,
          f"adapter gradients farther from f32 ({whole_k32}) than plain's ({whole_p32}) + bar")
    check(unchanged == len(named) - len(params), "an update moved the frozen backbone")
    check(b_moved == sum(n.endswith("adapter_wf.b") for n in names) > 0,
          "an update left a WF B insert in place")


def phase_whisper_finetune(counters, workdir: Path, card: str):
    """Main paths 23-25, the WF-adapted large-v3 fine-tune: `cli train` of
    configs/whisper_large_v3_adapters.yaml as published (d 1280, 32 + 32
    blocks, 20 heads of 64, V 51,866, 128 mels, WF rank 16,
    train_adapters_only, B=16 x 30 s) with `data.tokenizer_dir` at the BPE
    stand-in, total_steps cut to WHISPER_FT_STEPS and `whisper.remat` as
    WHISPER_FT_REMAT says: exact launches a step (K1 1, K6 one an encoder
    block, again in the backward's recompute under remat, K8 one an encoder
    block), finite losses, the backbone bitwise and every WF B moved, peak
    memory; K6 and K8 alone at the encoder's training shape; the bundle
    loaded by api.load and served in bf16 (K7 at d=1280: the fold, then
    K5, K6, K2h-out and K3c) and after quantize() in int8 (K10 with the
    inserts, K9-int8, K11), each with exact launches and held to the plain
    path; K7 at d=1280 and the int8 kernels alone on the trained weights;
    one B=2 step against plain; steps/s at B=16 in turns, the step's idle
    share and launches. -> (launches by path, errors, rows)."""
    import torch

    from jiao_liao_speech_recognition_torch import api
    from jiao_liao_speech_recognition_torch.data.bpe import ByteLevelBPE
    from jiao_liao_speech_recognition_torch.data.manifest import read_manifest
    from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch
    from jiao_liao_speech_recognition_torch.models.adapters import param_is_adapter
    from jiao_liao_speech_recognition_torch.train import engine
    from jiao_liao_speech_recognition_torch.utils.config import apply_overrides, load_yaml

    t_phase = time.perf_counter()
    manifest = write_corpus(workdir, n=WHISPER_B, seed=51)
    m = read_manifest(manifest)
    bpe = write_bpe_standin(workdir / "bpe", m.texts(), seed=52)
    ckpt = workdir / "ckpt"
    overrides = [f"data.train_manifest={manifest}", f"data.tokenizer_dir={bpe}",
                 f"train.checkpoint_dir={ckpt}", f"train.metrics_path={workdir / 'm.jsonl'}",
                 f"train.optimizer.total_steps={WHISPER_FT_STEPS}", "train.log_every_steps=1",
                 f"whisper.remat={str(WHISPER_FT_REMAT).lower()}"]
    config = Path(__file__).resolve().parent / WHISPER_FT_CONFIG
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0, t_cli = time.perf_counter(), time.time()
    lines, launches = drive(counters, "whisper_finetune", lambda: cli_run(
        ["train", "--config", config, *overrides]))
    train_s = time.perf_counter() - t0
    peak_train = torch.cuda.max_memory_allocated() / 2**30
    cfg = apply_overrides(load_yaml(str(config)), overrides)
    w, n = cfg.whisper, WHISPER_FT_STEPS
    records = [json.loads(s) for s in (workdir / "m.jsonl").read_text().splitlines()]
    # the captured step against graph=False and steps/s of both routes, first,
    # while nothing else holds the card's memory (a step peaks at 72 GB)
    gc.collect()
    torch.cuda.empty_cache()
    bpe_tok = ByteLevelBPE.from_hf_dir(str(bpe))
    routes_held("whisper_finetune", cfg, m, bpe_tok, workdir)
    torch.cuda.reset_peak_memory_stats()
    rate = route_rates("B16x30s_whisper_large_v3_adapters_yaml", cfg,
                       engine.make_model(cfg, "cuda"), host_batches(cfg, m, bpe_tok),
                       rate_steps=WHISPER_GRAPH_RATE_STEPS, profile_steps=1)
    peak_rate = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    remat = 2 if WHISPER_FT_REMAT else 1
    want = {key: 0 for key in counters} | {"K1": n, "K6": remat * w.encoder_layers * n,
                                           "K8": w.encoder_layers * n}
    wrong = {key: (launches[key], x) for key, x in want.items() if launches[key] != x}
    final = ckpt / "final"
    t0 = time.perf_counter()
    trained = api.load(str(final), device="cuda")
    load_s = time.perf_counter() - t0
    tok = trained.tokenizer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    init = engine.make_model(cfg, "cuda").state_dict()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frozen_same = moved = n_adapters = b_moved = n_b = 0
    for key, v in trained.model.state_dict().items():
        same = torch.equal(v, init[key])
        if param_is_adapter(key):
            n_adapters += 1
            moved += not same
            if key.endswith(".b"):
                n_b += 1
                b_moved += not same
        else:
            frozen_same += same
    n_frozen = len(init) - n_adapters
    del init
    emit({"phase": "whisper_finetune", "config": WHISPER_FT_CONFIG, "card": card,
          "params": sum(p.numel() for p in trained.model.parameters()),
          "adapter_params": sum(p.numel() for k, p in trained.model.named_parameters()
                                if param_is_adapter(k)),
          "d_model": w.d_model, "layers": [w.encoder_layers, w.decoder_layers],
          "heads": w.num_heads, "mlp": w.mlp_dim, "vocab": w.vocab_size, "mels": w.num_mels,
          "wf_rank": w.adapter.wf_rank, "batch": cfg.data.batch_size, "steps": n,
          "remat": WHISPER_FT_REMAT, "tokenizer": type(tok).__name__,
          "tokenizer_ids": len(tok), "note": "BPE stand-in from the seed (no large-v3 files)",
          "cli_last_line": lines[-1], "losses": [r["loss"] for r in records],
          "step_s": [r["ts"] - t for r, t in zip(records, [t_cli] + [r["ts"] for r in records])],
          "after_last_step_s": t_cli + train_s - records[-1]["ts"],
          "seconds_cli_train": train_s, "peak_gb_cli_train": peak_train, "load_s": load_s,
          "init_s": init_s,
          "launches": launches, "backbone_tensors_unchanged": f"{frozen_same}/{n_frozen}",
          "adapter_tensors_moved": f"{moved}/{n_adapters}",
          "adapter_b_tensors_moved": f"{b_moved}/{n_b}"})
    check(not wrong, f"whisper_finetune: launches (got, want): {wrong}")
    check(len(records) == n and all(math.isfinite(r["loss"]) for r in records),
          f"whisper fine-tune losses: {records}")
    check(len(tok) == w.vocab_size == 51866, f"BPE ids {len(tok)}, vocab {w.vocab_size}")
    check(frozen_same == n_frozen and n_b > 0 and b_moved == n_b,
          "whisper fine-tune: the backbone moved or a WF B insert did not")

    # the trained bundle served: bf16, then int8 (exact launches)
    requests = [make_requests()[i] for i in (1, 3, 5)]
    dc = dataclasses.replace(trained.config.decode, max_decode_len=WHISPER_TIMED_LEN)
    paths = {"whisper_finetune": launches}
    L, D = w.encoder_layers, w.decoder_layers
    enc_want = {"K1": 1, "K7-attn": L, "K5": L, "K6": L, "K2h-out": L, "K7-mlp": L, "K3c": L,
                "K2": 0, "K3": 0, "K8": 0}
    texts = {}
    wg.STEPS.reset()
    texts["bf16"], paths["whisper_adapted_serve"] = drive(
        counters, "whisper_adapted_serve", lambda: api.transcribe(trained, requests,
                                                                  decode_cfg=dc))
    steps = wg.STEPS.steps
    want = enc_want | {"K9": 2 * D * steps, "K9-int8": 0, "K10": 0, "K11": 0}
    wrong = {k: (paths["whisper_adapted_serve"][k], x) for k, x in want.items()
             if paths["whisper_adapted_serve"][k] != x}
    check(not wrong, f"whisper_adapted_serve: launches (got, want): {wrong}")
    qb = trained.quantize()
    wg.STEPS.reset()
    texts["int8"], paths["whisper_adapted_int8"] = drive(
        counters, "whisper_adapted_int8", lambda: api.transcribe(qb, requests, decode_cfg=dc))
    steps8 = wg.STEPS.steps
    want = enc_want | {"K9": D * steps8, "K9-int8": D * steps8, "K10": 8 * D * steps8,
                       "K11": steps8}
    wrong = {k: (paths["whisper_adapted_int8"][k], x) for k, x in want.items()
             if paths["whisper_adapted_int8"][k] != x}
    check(not wrong, f"whisper_adapted_int8: launches (got, want): {wrong}")
    check(all(len(t) == len(requests) and all(isinstance(s, str) for s in t)
              for t in texts.values()), "the trained Whisper bundle did not transcribe")

    # held to the plain path: the encoder, greedy ids (margin rule) in bf16
    # and through the plain int8 decoder's steps
    model, qmodel = trained.model, qb.model
    prompt, eot = wg.resolve_specials(w)
    P = len(prompt)
    wavs, _, _ = trained._prepare_audio_chunked(requests, None)
    margin_rows = {}
    with torch.inference_mode():
        wav = torch.from_numpy(wavs).cuda()
        enc_k = model.encode(featurize_batch(wav, cfg.frontend, kernels=True), kernels=True)
        enc_p = model.encode(featurize_batch(wav, cfg.frontend, kernels=False), kernels=False)
        for name, mdl in (("bf16", model), ("int8", qmodel)):
            ids, lens = wg.greedy_from_enc(mdl, enc_k, None, WHISPER_TIMED_LEN, prompt, eot,
                                           suppress_ids=w.suppress_ids,
                                           begin_suppress_ids=w.begin_suppress_ids)
            toks = torch.cat([torch.tensor(prompt, device="cuda").expand(ids.shape[0], P), ids],
                             1)
            if name == "bf16":
                logits = mdl.decode(toks[:, :-1], enc_k, kernels=False).float()
            else:
                logits = forced_logits(mdl, toks, enc_k, kernels=False)
            margin_rows[name] = margin_check(logits, toks, lens, P)
    enc_rel = float((enc_k.float() - enc_p.float()).norm() / enc_p.float().norm())
    emit({"phase": "whisper_finetune", "served": {
        "chunks": int(wavs.shape[0]), "decode_steps": [steps, steps8],
        "text_chars": {k: [len(s) for s in v] for k, v in texts.items()},
        "encoder_rel_l2": enc_rel, "encoder_bar": ENC_REL_BAR,
        "margin": {k: dict(zip(("coverage", "mismatched", "positions", "agree_all"), v))
                   for k, v in margin_rows.items()},
        "launches": {p: v for p, v in paths.items() if p != "whisper_finetune"}}})
    check(enc_rel <= ENC_REL_BAR, f"adapted encoder off the plain path by {enc_rel}")
    for name, (coverage, mismatch, _, _) in margin_rows.items():
        check(coverage >= MIN_COVERAGE and mismatch == 0,
              f"adapted {name} tokens disagree with plain ({mismatch}, coverage {coverage})")

    rng = np.random.RandomState(53)
    errs, rows = k7_d1280_rows(model, rng)
    errs.update(adapted_int8_kernel_checks(qmodel, enc_k, rng))
    del qb, qmodel, enc_k, enc_p
    f_errs, f_rows = flash_train_rows(rng, WHISPER_B, WHISPER_T, w.num_heads,
                                      w.d_model // w.num_heads, WHISPER_FT_LENS,
                                      "whisper_finetune", "Whisper training", plain_iters=2)
    for key, e in f_errs.items():
        errs[key] = max(errs.get(key, 0.0), e)
    rows.update(f_rows)

    whisper_step_vs_plain(model, cfg, m, tok)
    del trained, model
    emit({"phase": "whisper_finetune", "phase_s": time.perf_counter() - t_phase,
          "captured_steps_s": rate["captured_steps_s"], "eager_steps_s": rate["eager_steps_s"],
          "peak_gb_rate": peak_rate})
    return paths, errs, rows


# --- main paths 26-27: real audio in, augmented training, the RTFx harness ---

# 32 utterances of 30 s, eight of each format real recordings come in:
# (container, sample rate, sample format)
REAL_FORMATS = (("flac", 44100, 16), ("wav", 48000, 24), ("wav", 22050, "float"),
                ("wav", 8000, 8))
REAL_UTTS = 32
REAL_SECONDS = 30.0
# the card's resample against scipy's f64 resample_poly of the same decoded
# audio, on the interior (the JAX package's test bar; the edges differ by
# the padding convention)
RESAMPLE_SCIPY_BAR = 5e-3
RESAMPLE_EDGE = 200
# configs/adapter_finetune.yaml as published but for these: every transform
# of the augmentation on, three steps, a record a step (three records)
AUG_OVERRIDES = ("augment.enabled=true", "augment.lowpass_probability=0.5",
                 "augment.highpass_probability=0.5", "augment.bandpass_probability=0.5",
                 "augment.time_stretch_rates=[0.9,1.1]", "train.optimizer.total_steps=3",
                 "train.log_every_steps=1")
AUG_STEPS = 3
AUG_RATE_STEPS = 4  # steps a timed turn, augmentation off / on
AUG_TRACE_KERNELS = {"K1": ("log_mel_tf32_kernel",), "K6": ("flash_fwd_kernel",),
                     "K8": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")}
RTFX_ITERS = 10


@functools.lru_cache(maxsize=None)
def _crc_table(poly: int, width: int) -> np.ndarray:
    """The byte table of an MSB-first CRC of `width` bits (init 0)."""
    top, mask = 1 << (width - 1), (1 << width) - 1
    out = np.zeros(256, np.uint32)
    for b in range(256):
        c = b << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) & mask if c & top else (c << 1) & mask
        out[b] = c
    return out


@functools.lru_cache(maxsize=None)
def _crc16_by_distance(n: int) -> np.ndarray:
    """[n, 256]: the CRC-16 (poly 0x8005, FLAC's) of byte b followed by d
    zero bytes. The CRC is linear, so a message's CRC is the XOR of its
    bytes' rows at their distances from its end: one gather, no loop over
    the bytes in Python."""
    table = _crc_table(0x8005, 16)
    rows = np.zeros((n, 256), np.uint32)
    rows[0] = table
    for d in range(1, n):
        rows[d] = ((rows[d - 1] << 8) & 0xFFFF) ^ table[rows[d - 1] >> 8]
    return rows


def _crc16(data: bytes) -> int:
    b = np.frombuffer(data, np.uint8)
    rows = _crc16_by_distance(8320)  # a 4096-sample 16-bit frame and its header
    return int(np.bitwise_xor.reduce(rows[np.arange(len(b) - 1, -1, -1), b]))


def _crc8(data: bytes) -> int:
    table, c = _crc_table(0x07, 8), 0
    for byte in data:
        c = int(table[c ^ byte])
    return c


def write_flac16(path: Path, codes: np.ndarray, sample_rate: int, block: int = 4096) -> None:
    """Mono 16-bit FLAC (RFC 9639): STREAMINFO, then fixed-blocksize frames,
    each one VERBATIM subframe, with their frame numbers, CRC-8 and CRC-16.
    The codes are stored as they are, so the decoder must return exactly
    codes / 32768."""
    n = len(codes)
    info = (block.to_bytes(2, "big") * 2 + bytes(6)
            + ((sample_rate << 44) | (0 << 41) | (15 << 36) | n).to_bytes(8, "big") + bytes(16))
    out = bytearray(b"fLaC" + bytes([0x80, 0, 0, len(info)]) + info)
    for i, s in enumerate(range(0, n, block)):
        chunk = codes[s:s + block]
        full = len(chunk) == block
        hdr = bytearray(b"\xff\xf8")  # sync code, fixed block size
        hdr.append((12 if full else 7) << 4)  # 4096 samples or 16 bits below; rate: STREAMINFO's
        hdr.append(4 << 1)  # mono, 16-bit samples
        hdr += bytes([i]) if i < 0x80 else bytes([0xC0 | i >> 6, 0x80 | (i & 0x3F)])
        if not full:
            hdr += (len(chunk) - 1).to_bytes(2, "big")
        hdr.append(_crc8(bytes(hdr)))
        frame = bytes(hdr) + b"\x02" + chunk.astype(">i2").tobytes()  # VERBATIM subframe
        out += frame + _crc16(frame).to_bytes(2, "big")
    path.write_bytes(bytes(out))


def write_wav_codes(path: Path, codes: np.ndarray, sample_rate: int, fmt) -> None:
    """Mono WAV of 8-bit (unsigned), 24-bit or IEEE float32 samples."""
    import struct

    if fmt == "float":
        data, bits, tag = codes.astype("<f4").tobytes(), 32, 3
    elif fmt == 24:
        v = codes.astype("<i4")
        data, bits, tag = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF],
                                   1).astype(np.uint8).tobytes(), 24, 1
    else:
        data, bits, tag = codes.astype(np.uint8).tobytes(), 8, 1
    block = bits // 8
    body = (b"WAVEfmt " + struct.pack("<IHHIIHH", 16, tag, 1, sample_rate, sample_rate * block,
                                      block, bits) + b"data" + struct.pack("<I", len(data)) + data)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def write_real_audio(d: Path, seed: int = 0):
    """REAL_UTTS seeded utterances of REAL_SECONDS (tone, slow tremolo,
    noise), cycling through REAL_FORMATS, each quantized to its format at
    its own rate -> [(path, decoded PCM the file holds exactly, rate)]."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(REAL_UTTS):
        kind, sr, fmt = REAL_FORMATS[i % len(REAL_FORMATS)]
        t = np.arange(int(REAL_SECONDS * sr)) / sr
        x = (0.2 * np.sin(2 * np.pi * rng.uniform(150.0, 2000.0) * t)
             * np.sin(2 * np.pi * 0.5 * t) + 0.05 * rng.randn(len(t)))
        path = d / f"r{i:02d}_{sr}.{kind}"
        if fmt == 16:
            codes = np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)
            write_flac16(path, codes, sr)
            pcm = codes.astype(np.float32) / 32768.0
        elif fmt == 24:
            codes = np.round(x * 8388607).astype(np.int32)
            write_wav_codes(path, codes, sr, 24)
            pcm = codes.astype(np.float32) / 8388608.0
        elif fmt == 8:
            codes = np.clip(np.round(x * 127 + 128), 0, 255).astype(np.uint8)
            write_wav_codes(path, codes, sr, 8)
            pcm = (codes.astype(np.float32) - 128.0) / 128.0
        else:
            pcm = x.astype(np.float32)
            write_wav_codes(path, pcm, sr, "float")
        out.append((path, pcm, sr))
    return out


def real_audio_transcribe(counters, bundle, utts, workdir: Path) -> dict:
    """`cli transcribe` of the files on the flagship (K1-K4 on the batch the
    card resampled), the decoders exact, the card's resample against
    scipy's on the interior, and the file path's ids against the plain path
    on scipy-resampled 16 kHz arrays by the margin rule."""
    import torch
    from scipy.signal import resample_poly

    from jiao_liao_speech_recognition_torch.frontend.audio_io import read_audio
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch
    from jiao_liao_speech_recognition_torch.frontend.resample import resample

    ckpt = workdir / "flagship"
    bundle.save(str(ckpt))
    files = [str(p) for p, _, _ in utts]
    t0 = time.perf_counter()
    lines, launches = drive(counters, "real_audio", lambda: cli_run(
        ["transcribe", *files, "--checkpoint", ckpt]))
    cli_s = time.perf_counter() - t0
    texts = [json.loads(line)["text"] for line in lines]
    check(len(texts) == REAL_UTTS and sum(map(len, texts)) > 0, "cli transcribe: no text")
    check(launches["K2"] == launches["K3"] == 12 * launches["K1"] and launches["K4"]
          == launches["K1"], f"real audio launches {launches}")

    resample_err, ref16 = {}, []
    for path, pcm, sr in utts:
        got, got_sr = read_audio(path)
        check(got_sr == sr and np.array_equal(got, pcm), f"{path}: not decoded exactly")
        g = math.gcd(sr, SAMPLE_RATE)
        ref = resample_poly(pcm.astype(np.float64), SAMPLE_RATE // g, sr // g)
        card = resample(torch.from_numpy(pcm).cuda(), sr, SAMPLE_RATE).cpu().numpy()
        check(card.shape == ref.shape == (int(REAL_SECONDS * SAMPLE_RATE),),
              f"{path}: resampled to {card.shape}")
        e = float(np.abs(card - ref)[RESAMPLE_EDGE:-RESAMPLE_EDGE].max())
        resample_err[f"{sr}"] = max(resample_err.get(f"{sr}", 0.0), e)
        ref16.append(ref.astype(np.float32))
    check(max(resample_err.values()) <= RESAMPLE_SCIPY_BAR,
          f"resample off scipy's by {resample_err}")

    fe = bundle.config.frontend
    wav_f, alens_f, _ = bundle._prepare_audio_chunked(files, None)
    wav_r, alens_r, _ = bundle._prepare_audio_chunked(ref16, SAMPLE_RATE)
    check(np.array_equal(alens_f, alens_r), "file and array lengths differ")
    with torch.inference_mode():
        flens = torch.from_numpy(alens_f // fe.hop_length).cuda()
        ids_k, olens = bundle.model(featurize_batch(torch.from_numpy(wav_f).cuda(), fe,
                                                    kernels=True),
                                    flens, head_mode="argmax_ids", kernels=True)
        lp, _ = bundle.model(featurize_batch(torch.from_numpy(wav_r).cuda(), fe, kernels=False),
                             flens, head_mode="log_probs", kernels=False)
    frames = torch.arange(ids_k.shape[1], device="cuda")[None, :] < olens[:, None]
    clear = frames & (margins(lp) > ARGMAX_MARGIN)
    coverage = float(clear.sum() / frames.sum())
    mismatch = int(((ids_k != lp.argmax(-1).to(torch.int32)) & clear).sum())
    out = {"utterances": REAL_UTTS, "seconds": REAL_SECONDS,
           "formats": [f"{k} {sr} Hz {f}" for k, sr, f in REAL_FORMATS],
           "cli_transcribe_s": cli_s, "launches": launches,
           "resample_vs_scipy_interior_max": resample_err, "resample_bar": RESAMPLE_SCIPY_BAR,
           "frames": int(frames.sum()), "coverage": coverage, "margin": ARGMAX_MARGIN,
           "mismatched_frames": mismatch, "text_chars": [len(t) for t in texts]}
    emit({"phase": "real_audio", **out})
    check(coverage >= MIN_COVERAGE and mismatch == 0,
          f"file-path ids disagree with scipy-resampled plain ({mismatch}, {coverage})")
    return launches, ref16


def augmented_train(counters, utts, ref16, workdir: Path) -> dict:
    """`cli train --profile` of configs/adapter_finetune.yaml with every
    augmentation on (AUG_OVERRIDES) over 16 of the real-format files (the
    loader resamples them), B=16 x 30 s: exact launches (K1 1, K6 and K8
    12 a step), finite losses, one MetricsLogger record a step, the trace
    naming K1's, K6's and K8's kernels; then the same step timed with the
    augmentation off and on, in turns."""
    import torch

    from jiao_liao_speech_recognition_torch.data.manifest import ManifestRow, write_manifest
    from jiao_liao_speech_recognition_torch.train import engine
    from jiao_liao_speech_recognition_torch.utils.config import apply_overrides, load_yaml

    rng = np.random.RandomState(5)
    chars, per = rng.permutation(4334), -(-4334 // 16)  # V = 4336, as phase 5's
    rows = [ManifestRow(str(p), "".join(chr(0x4E00 + int(c)) for c in chars[i * per:(i + 1) * per]),
                        REAL_SECONDS, "real") for i, (p, _, _) in enumerate(utts[:16])]
    write_manifest(rows, workdir / "real.jsonl")
    logdir, metrics = workdir / "trace", workdir / "aug_metrics.jsonl"
    cfg_path = Path(__file__).resolve().parent / "configs" / "adapter_finetune.yaml"
    overrides = [f"data.train_manifest={workdir / 'real.jsonl'}", 'data.eval_manifest=""',
                 f"train.checkpoint_dir={workdir / 'aug_ckpt'}", f"train.metrics_path={metrics}",
                 *AUG_OVERRIDES]
    t0 = time.perf_counter()
    _, launches = drive(counters, "augmented_train", lambda: cli_run(
        ["train", "--config", cfg_path, "--profile", logdir, *overrides]))
    train_s = time.perf_counter() - t0
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    check(len(records) == AUG_STEPS and all(list(r)[:2] == ["step", "ts"] for r in records),
          f"{len(records)} MetricsLogger records, not {AUG_STEPS}")
    losses = [r["loss"] for r in records]
    check(all(math.isfinite(x) for x in losses), f"augmented losses {losses}")
    check(launches["K1"] == AUG_STEPS and launches["K6"] == launches["K8"] == 12 * AUG_STEPS,
          f"augmented train launches {launches}")
    traces = sorted(logdir.glob("*.pt.trace.json"))
    check(len(traces) == 1, f"--profile wrote {len(traces)} trace files")
    trace_mb = traces[0].stat().st_size / 2**20
    names = {e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]
             if e.get("cat") == "kernel"}
    named = {key: {k: sum(k in n for n in names) for k in ks}
             for key, ks in AUG_TRACE_KERNELS.items()}
    check(all(v > 0 for ks in named.values() for v in ks.values()),
          f"the trace misses a kernel: {named}")

    # the same step with the augmentation off and on (turns: off, on, on, off)
    cfg = apply_overrides(load_yaml(str(cfg_path)), list(overrides))
    T = cfg.data.max_text_len
    model = engine.make_model(cfg, "cuda")
    state = engine.init_state(cfg, model)
    step = engine.make_train_step(engine.make_loss_fn(cfg, model), cfg.train.optimizer)
    batches = [{
        "audio": torch.from_numpy(np.stack(ref16[16 * j:16 * (j + 1)])).cuda(),
        "audio_lengths": torch.full((16,), len(ref16[0]), dtype=torch.int32, device="cuda"),
        "labels": torch.from_numpy(rng.randint(1, 4336, (16, T)).astype(np.int32)).cuda(),
        "label_lengths": torch.full((16,), T, dtype=torch.int32, device="cuda"),
    } for j in range(2)]
    secs = {False: [], True: []}
    for on in (False, True):  # warm both
        cfg.augment.enabled = on
        step(state, batches[0])
    for on in (False, True, True, False):
        cfg.augment.enabled = on
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(AUG_RATE_STEPS):
            loss = step(state, batches[i % 2])["loss"]
        check(math.isfinite(float(loss)), "augmented step loss not finite")
        secs[on].append((time.perf_counter() - t1) / AUG_RATE_STEPS)
    off_s, on_s = statistics.median(secs[False]), statistics.median(secs[True])
    out = {"config": "configs/adapter_finetune.yaml", "overrides": list(AUG_OVERRIDES),
           "batch": cfg.data.batch_size, "cli_train_profiled_s": train_s, "losses": losses,
           "launches": launches, "trace_mb": trace_mb, "trace_kernels": named,
           "step_s_augment_off": off_s, "step_s_augment_on": on_s,
           "augment_cost_s_per_step": on_s - off_s, "turns_s": secs}
    emit({"phase": "real_audio", "augmented_train": out})
    return launches


def phase_real_audio(counters, workdir: Path, greedy: dict, card: str):
    """Main paths 26-27: real-format audio through `cli transcribe` on the
    flagship (phase 4's seeded weights), `cli train --profile` with the
    waveform augmentation, and measure_rtfx on the flagship's greedy batch
    beside phase 7's reading."""
    import torch

    from jiao_liao_speech_recognition_torch import api
    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.decode.ctc import ctc_greedy_collapse
    from jiao_liao_speech_recognition_torch.evals.rtfx import measure_rtfx
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch
    from jiao_liao_speech_recognition_torch.utils.config import ExperimentConfig

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    utts = write_real_audio(workdir)
    write_s = time.perf_counter() - t_phase
    bundle = api.load(config=ExperimentConfig(), device="cuda")
    bundle.tokenizer = CharTokenizer([chr(0x4E00 + i) for i in range(4334)])
    paths = {}
    paths["real_audio"], ref16 = real_audio_transcribe(counters, bundle, utts, workdir)
    paths["augmented_train"] = augmented_train(counters, utts, ref16, workdir)

    fe = bundle.config.frontend

    @torch.inference_mode()
    def infer(wav, lengths):
        ids, olens = bundle.model(featurize_batch(wav, fe, kernels=True),
                                  lengths // fe.hop_length, head_mode="argmax_ids", kernels=True)
        return ctc_greedy_collapse(ids, olens)

    res = measure_rtfx(infer, batch=32, chunk_seconds=30.0, iters=RTFX_ITERS, device="cuda")
    emit({"phase": "real_audio", "card": card, "measure_rtfx": res.to_json(),
          "measure_rtfx_s_per_batch": res.seconds_per_batch,
          "phase7_kernel_path_rtfx": greedy["kernel_path_rtfx"],
          "phase7_kernel_path_s_per_batch": greedy["kernel_path_s_per_batch"],
          "write_files_s": write_s, "phase_s": time.perf_counter() - t_phase})
    check(math.isfinite(res.rtfx) and res.rtfx > 0, "measure_rtfx")
    return paths


def multigpu_worker(argv) -> int:
    """One process of phase 19 under torch.distributed.run: every launch
    count at 0, `cli.main(argv[1:])`, then the counts written to argv[0]
    (JSON) with the exit code and the peak device memory."""
    import torch

    from jiao_liao_speech_recognition_torch import cli

    counters = load_counters()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for c in counters.values():
        c.reset()
    rc = cli.main(argv[1:])
    torch.cuda.synchronize()
    Path(argv[0]).write_text(json.dumps({
        "rc": rc, "launches": {key: c.launches for key, c in counters.items()},
        "peak_bytes": torch.cuda.max_memory_allocated()}))
    return rc


def phase_multigpu(counters, workdir: Path, ft_cfg, ft_losses, ft_launches, card: str):
    """Main path 28 (see phase 19 in the module docstring) -> launches."""
    import torch

    from jiao_liao_speech_recognition_torch.train import engine
    from jiao_liao_speech_recognition_torch.train.checkpoints import TrainCheckpointer

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the launcher's process shares this card
    root = Path(__file__).resolve().parent
    counts, metrics, ckpt = workdir / "mg_counts.json", workdir / "mg_metrics.jsonl", \
        workdir / "mg_ckpt"
    argv = ["train", "--multihost", "--config", root / "configs" / "adapter_finetune.yaml",
            f"data.train_manifest={ft_cfg.data.train_manifest}", 'data.eval_manifest=""',
            f"train.checkpoint_dir={ckpt}", f"train.metrics_path={metrics}",
            "train.log_every_steps=1", f"train.optimizer.total_steps={FT_STEPS}"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", str(root / "chip_smoke.py"), "--multigpu-worker", str(counts), *map(str, argv)]
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=MULTIGPU_TIMEOUT_S,
                          cwd=root)
    launch_s = time.perf_counter() - t0
    print(proc.stdout[-2000:], end="", flush=True)
    check(proc.returncode == 0, f"the 1-process launch exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    child = json.loads(counts.read_text())
    launches = child["launches"]
    check(not any(c.launches for c in counters.values()), "this process launched a kernel")
    missing = [key for key in PATHS["multigpu"] if launches[key] == 0]
    check(not missing, f"multigpu: kernels never launched: {missing} ({launches})")
    losses = [json.loads(line)["loss"] for line in metrics.read_text().splitlines()]

    # the launcher's step-3 checkpoint in this process, which has no group
    model = engine.make_model(ft_cfg, "cuda")
    state = engine.init_state(ft_cfg, model)
    extra = TrainCheckpointer(str(ckpt)).restore(state)
    mine = torch.load(Path(ft_cfg.train.checkpoint_dir) / f"{FT_STEPS:08d}" / "state.pt",
                      map_location="cuda", weights_only=False)
    same = sum(torch.equal(v, mine["model"][k]) for k, v in model.state_dict().items())
    adam_same = sum(torch.equal(v, mine["optimizer"]["state"][i][name])
                    for i, st in state.optimizer.state_dict()["state"].items()
                    for name, v in st.items() if name != "step")
    n_adam = sum(len(st) - 1 for st in mine["optimizer"]["state"].values())
    emit({"phase": "multigpu", "card": card, "config": "configs/adapter_finetune.yaml",
          "launcher": "python -m torch.distributed.run --standalone --nproc-per-node 1",
          "argv": [str(a) for a in argv], "losses": losses, "one_process_losses": ft_losses,
          "losses_bitwise": losses == ft_losses, "launches": launches,
          "one_process_launches": {k: ft_launches[k] for k in PATHS["multigpu"]},
          "peak_gb": child["peak_bytes"] / 1e9, "restored_step": state.step,
          "restored_data_iter": extra["data_iter"],
          "restored_tensors_bitwise": f"{same}/{len(mine['model'])}",
          "restored_adam_bitwise": f"{adam_same}/{n_adam}", "launch_s": launch_s,
          "phase_s": time.perf_counter() - t_phase})
    check(losses == ft_losses, f"multigpu losses {losses} != one-process {ft_losses}")
    check(all(launches[k] == ft_launches[k] for k in PATHS["multigpu"]),
          f"multigpu launches {launches} != one-process {ft_launches}")
    check(state.step == FT_STEPS and same == len(mine["model"]) and adam_same == n_adam,
          f"the restored checkpoint differs: step {state.step}, {same} tensors, "
          f"{adam_same} Adam moments bitwise")
    return launches


class TurnGroup:
    """A model group of `size` ranks played by threads of this process that
    take turns on one card: a rank runs until its next collective, where it
    leaves its tensor and hands the turn to the next rank; the last to
    arrive sums the tensors (in rank order, f32 as they come) or lists them
    on the card, and the ranks go on in order. One thread runs at a time,
    so the wrappers' launch counts stay exact. ``member(r)`` is rank r's
    stand-in group for parallel/tp.TPGroup. ``drop_last`` puts in a fault
    (phase 21's upper reading of its beam bar): each all-reduce leaves out
    the last rank's share."""

    def __init__(self, size: int):
        import threading

        self.size, self.cv = size, threading.Condition()
        self.turn, self.epoch, self.box, self.result, self.error = 0, 0, [None] * size, None, None
        self.drop_last = False

    def _wait(self, pred):
        if not self.cv.wait_for(lambda: self.error is not None or pred(), timeout=600):
            self.error = "a rank waited 600 s for its turn"
        if self.error is not None:
            raise RuntimeError(f"TurnGroup: {self.error}")

    def _collective(self, r: int, t, combine):
        with self.cv:
            self.box[r] = t
            epoch = self.epoch
            if r == self.size - 1:
                self.result, self.box = combine(self.box), [None] * self.size
                self.epoch += 1
            self.turn = (r + 1) % self.size
            self.cv.notify_all()
            self._wait(lambda: self.epoch > epoch and self.turn == r)
            return self.result

    def member(self, r: int):
        group = self

        class Member:
            def all_reduce(self, t):
                return group._collective(r, t, lambda ts: functools.reduce(
                    lambda a, b: a + b, ts[:-1] if group.drop_last else ts)).clone()

            def all_gather(self, t):
                return list(group._collective(r, t, list))

        return Member()

    def run(self, fns):
        """fns[r]() on rank r's thread, in turns -> their results."""
        import threading

        out = [None] * self.size

        def body(r):
            try:
                with self.cv:
                    self._wait(lambda: self.turn == r)
                out[r] = fns[r]()
                with self.cv:
                    self.turn = (r + 1) % self.size
                    self.cv.notify_all()
            except BaseException as e:  # noqa: BLE001 - handed to the caller
                with self.cv:
                    self.error = self.error or repr(e)
                    self.cv.notify_all()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self.error is not None:
            raise RuntimeError(f"TurnGroup: {self.error}")
        return out


def tp_ranks(module, tp: int, group=None):
    """`tp` copies of `module`, copy r split as rank r (parallel/tp.apply_tp;
    `group` a TurnGroup, else no collective), in bf16 serving form."""
    import copy

    import torch

    from jiao_liao_speech_recognition_torch.models.layers import cast_for_serving
    from jiao_liao_speech_recognition_torch.parallel.tp import TPGroup, apply_tp

    out = []
    for r in range(tp):
        m = copy.deepcopy(module)
        apply_tp(m, TPGroup(r, tp, None if group is None else group.member(r)))
        cast_for_serving(m, torch.bfloat16)
        out.append(m.eval())
    return out


def _rel_check(key, got, want, **info):
    """An f32 result against its plain version: max |diff| over max |plain|."""
    import torch

    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    emit({"phase": "tp", "kernel": key, **info, "max_abs_err": err, "rel": rel,
          "bar_rel": ROW_REL_BAR})
    check(rel <= ROW_REL_BAR, f"{key} {info}: relative error {rel} > {ROW_REL_BAR}")
    return err


def _twice(key, fn, **info):
    """fn() launched twice: the same bits -> the first result."""
    import torch

    a, b = fn(), fn()
    same = all(torch.equal(x, y) for x, y in zip(*((a, b) if isinstance(a, tuple)
                                                    else ((a,), (b,)))))
    check(same, f"{key} {info}: two launches differ")
    return a


def tp_rank_checks(block, x, lens, tag: str, errs: dict) -> None:
    """Each launch of a split block's serving sublayers against its plain
    version, twice bitwise: K5 or attention_core_tp, K6, the row-parallel
    partials, ln_fc1."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import flash_attention as fl
    from jiao_liao_speech_recognition_torch.ops import fused_attention as fa
    from jiao_liao_speech_recognition_torch.ops import fused_mlp as fm

    sa, ln, m, mln = block.self_attn, block.self_attn_ln, block.mlp, block.mlp_ln
    H, D = sa.num_heads, sa.num_heads * sa.head_dim
    tp = sa.q_proj.tp
    info = {"case": tag, "rank": tp.rank, "tp": tp.size, "heads": H}
    w_qkv, b_qkv, wo = block._attention_weights(torch.bfloat16)
    with torch.inference_mode():
        if block._k2_route(x):
            core = (x, ln.scale, ln.bias, w_qkv, b_qkv, lens, H, ln.eps)
            attn = _twice("K2-tp", lambda: fa.attention_core_tp(*core), **info)
            want = fa.attention_core_plain(fm.qkv_gemm_plain(
                fm.ln_rows_plain(x, ln.scale, ln.bias, ln.eps), w_qkv, b_qkv), lens, H)
            errs["K2-tp"] = max(errs.get("K2-tp", 0.0), _ulp_check("K2-tp", attn, want, **info))
        else:
            qkv = _twice("K5", lambda: fm.fused_ln_qkv(x, ln.scale, ln.bias, w_qkv, b_qkv, ln.eps,
                                                       width=D), **info)
            want = fm.ln_qkv_plain(x, ln.scale, ln.bias, w_qkv, b_qkv, ln.eps, width=D)
            errs["K5"] = max([errs.get("K5", 0.0)] + [
                _ulp_check("K5", a, c, part=n, packed=w_qkv.shape[1], **info)
                for n, a, c in zip("qkv", qkv, want)])
            attn = _twice("K6", lambda: fl.flash_attention_packed(*qkv, H, kv_lengths=lens),
                          **info)
            _ulp_check("K6", attn, fl.flash_attention_packed(*qkv, H, kv_lengths=lens,
                                                            kernels=False), **info)
        part = _twice("row-partial", lambda: fa.row_partial(attn, wo), **info)
        errs["row-partial"] = max(errs.get("row-partial", 0.0), _rel_check(
            "row-partial", part, fa.row_partial_plain(attn, wo), launch="out_proj", **info))
        (w1, w2), b1 = block._mlp_weights(torch.bfloat16), m.fc1.weights(torch.bfloat16)[1]
        args = (x, mln.scale, mln.bias, w1, b1, mln.eps, m.gelu_form)
        h = _twice("K3-tp", lambda: fm.ln_fc1(*args), **info)
        errs["K3-tp"] = max(errs.get("K3-tp", 0.0), _ulp_check(
            "K3-tp", h, fm.ln_fc1_plain(*args), mlp=w1.shape[1], **info))
        part = _twice("row-partial", lambda: fa.row_partial(h, w2), **info)
        errs["row-partial"] = max(errs["row-partial"], _rel_check(
            "row-partial", part, fa.row_partial_plain(h, w2), launch="fc2", **info))


def tp_block(d, H, mlp, gelu, wf: bool, seed: int):
    """One serving block on the card from a seeded generator (WF inserts
    with B drawn too, so the fold moves the weights)."""
    import torch

    from jiao_liao_speech_recognition_torch.models.layers import TransformerBlock, cast_for_serving
    from jiao_liao_speech_recognition_torch.utils.config import AdapterConfig

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("cuda"):
        block = TransformerBlock(d, H, mlp, gen, gelu,
                                 adapter=AdapterConfig(kind="wf", wf_rank=16) if wf else None)
        with torch.no_grad():
            for name, p in block.named_parameters():
                if name.endswith("adapter_wf.b"):
                    p.normal_(0.0, 0.02, generator=gen)
                elif name.endswith("ln.bias") or name.endswith("_proj.bias"):
                    p.normal_(0.0, 0.1, generator=gen)
    cast_for_serving(block, torch.bfloat16)
    return block.eval()


def tp_decode(model, ranks, enc, toks, group):
    """Teacher-forced decode steps of the split `ranks` in turns (group a
    TurnGroup) -> every rank's (logits a step, its caches after the last
    step)."""
    import torch

    def run(m):
        def fn():
            with torch.inference_mode():
                caches = m.init_cache(enc.shape[0], enc, TP_DECODE_STEPS + 1)
                out = []
                for pos in range(TP_DECODE_STEPS):
                    logits, caches = m.decode_step(toks[:, pos:pos + 1], pos, enc, caches)
                    out.append(logits)
                return out, caches
        return fn

    return group.run([run(m) for m in ranks])


def tp_decode_checks(ranks, caches, errs: dict) -> None:
    """Each split decoder rank's decode-step launches against their plain
    versions, twice bitwise: the row-parallel partials of block 0's
    self- and cross-attention out-projections and fc2 on B=16 one-token
    rows (10 CTAs a launch: fewer than the card's SMs), and K9 on the
    rank's head-major self and cross caches as the teacher-forced steps
    left them (its 10 or 5 heads), at ragged lengths up to each horizon."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import decode_attention as da
    from jiao_liao_speech_recognition_torch.ops import fused_attention as fa

    randn = _card_randn(22)
    B = WHISPER_B
    for rank, cache in zip(ranks, caches):
        block = rank.decoder.blocks[0]
        info = {"case": "decode", "rank": rank.tp.rank, "tp": rank.tp.size, "rows": B}
        with torch.inference_mode():
            for launch, dense in (("self out_proj", block.self_attn.out_proj),
                                  ("cross out_proj", block.cross_attn.out_proj),
                                  ("fc2", block.mlp.fc2)):
                w = dense.weights(torch.bfloat16)[0]
                a = randn(B, 1, w.shape[0]).to(torch.bfloat16)
                part = _twice("row-partial", lambda: fa.row_partial(a, w), launch=launch, **info)
                errs["row-partial"] = max(errs.get("row-partial", 0.0), _rel_check(
                    "row-partial", part, fa.row_partial_plain(a, w), launch=launch,
                    shape=[B, *w.shape], **info))
            entry = cache["block_0"]
            H, dh = block.self_attn.num_heads, block.self_attn.head_dim
            qh = randn(B, H, 1, dh).to(torch.bfloat16)
            for kind, full in (("self", TP_DECODE_STEPS), ("cross", WHISPER_T)):
                k, v = entry[kind]["k"], entry[kind]["v"]
                lens = torch.tensor(([full, full - 1, full // 2, 1] * B)[:B], dtype=torch.int32,
                                    device=k.device)
                got = _twice("K9", lambda: da.grouped_decode_attention(qh, k, v, lens),
                             cache=kind, **info)
                errs["K9"] = max(errs.get("K9", 0.0), _ulp_check(
                    "K9", got, da.decode_attention_plain(qh, k, v, lens), cache=kind,
                    heads=H, Tk=k.shape[2], **info))


def phase_tp(counters, card: str):
    """Phase 20 (main path 29; see the module docstring) -> (launches,
    errors by kernel key, timing rows)."""
    import torch

    from jiao_liao_speech_recognition_torch.models.layers import cast_for_serving
    from jiao_liao_speech_recognition_torch.models.whisper import WhisperModel
    from jiao_liao_speech_recognition_torch.ops.fused_attention import (attn_residual_after_sum,
                                                                          residual_after_sum)

    t0 = time.monotonic()
    dev = torch.device("cuda")
    rng = np.random.RandomState(20)
    w = whisper_config().whisper
    d, H, mlp = w.d_model, w.num_heads, w.mlp_dim
    B, T = WHISPER_B, WHISPER_T

    def bf(*shape, s=1.0):
        return torch.from_numpy((s * rng.randn(*shape)).astype(np.float32)).to(dev, torch.bfloat16)

    x = bf(B, T, d)
    lens = torch.tensor(([T, 1000, 313, 1] * B)[:B], dtype=torch.int32, device=dev)
    xf = bf(TP_FLAG_B, TP_FLAG_T, 512)
    lf = torch.tensor(([TP_FLAG_T, 600, 129, 1] * TP_FLAG_B)[:TP_FLAG_B], dtype=torch.int32,
                      device=dev)
    cases = [("large_v3", tp_block(d, H, mlp, "erf", False, 1), x, lens, (2, 4)),
             ("large_v3_wf", tp_block(d, H, mlp, "erf", True, 2), x, lens, (2,)),
             ("flagship", tp_block(512, 4, 2048, "tanh", False, 3), xf, lf, (2,))]
    errs, wants, split = {}, {}, {}
    with torch.inference_mode():
        for name, block, xx, ll, sizes in cases:
            # the unsharded kernel route: K5 -> K6 -> K2h-out and K3c (K7
            # folds first), or K2 and K3
            wants[name] = (block._serve_attention(xx, ll, True), block._serve_mlp(xx, True))
            for tp in sizes:
                split[(name, tp)] = tp_ranks(block, tp)
                for b in split[(name, tp)]:
                    tp_rank_checks(b, xx, ll, name, errs)

    # the decoder: large-v3 width, cut in depth; the unsharded steps first
    cfg = dataclasses.replace(w, encoder_layers=1, decoder_layers=TP_DECODE_LAYERS)
    whole = WhisperModel(cfg, device=dev, seed=4)
    cast_for_serving(whole, torch.bfloat16)
    whole.eval()
    enc = bf(B, T, d)
    toks = torch.from_numpy(rng.randint(0, min(w.vocab_size, 50257),
                                        (B, TP_DECODE_STEPS + 1))).to(dev)
    with torch.inference_mode():
        caches = whole.init_cache(B, enc, TP_DECODE_STEPS + 1)
        want_logits = []
        for pos in range(TP_DECODE_STEPS):
            logits, caches = whole.decode_step(toks[:, pos:pos + 1], pos, enc, caches)
            want_logits.append(logits)
        del caches
    groups = {tp: TurnGroup(tp) for tp in (2, 4)}
    dec_ranks = {tp: tp_ranks(whole, tp, groups[tp]) for tp in (2, 4)}

    def main_path():
        sums = {}
        with torch.inference_mode():
            for (name, tp), ranks in split.items():
                _, block, xx, ll, _ = next(c for c in cases if c[0] == name)
                acc_a = functools.reduce(lambda a, b: a + b,
                                         [r.attention_partial(xx, ll, True) for r in ranks])
                acc_m = functools.reduce(lambda a, b: a + b, [r.mlp_partial(xx, True)
                                                              for r in ranks])
                sums[(name, tp)] = (acc_a, acc_m)
        decoded = {tp: tp_decode(whole, dec_ranks[tp], enc, toks, groups[tp]) for tp in (2, 4)}
        return sums, decoded

    (sums, decoded), launches = drive(counters, "tp", main_path)
    logits = {tp: [out for out, _ in runs] for tp, runs in decoded.items()}
    for tp, runs in decoded.items():
        tp_decode_checks(dec_ranks[tp], [c for _, c in runs], errs)
    # the exact counts: per rank, one K5 + K6 (or one attention_core_tp), one
    # ln_fc1 and two row partials a block; per decode step and block, two K9
    # (self and cross) and three row partials (out-projections and fc2)
    want = {k: 0 for k in counters}
    for (name, tp) in split:
        core = "K2-tp" if name == "flagship" else "K5"
        want[core] += tp
        want["K6"] += 0 if name == "flagship" else tp
        want["K3-tp"] += tp
        want["row-partial"] += 2 * tp
    for tp in (2, 4):
        want["K9"] += 2 * TP_DECODE_LAYERS * TP_DECODE_STEPS * tp
        want["row-partial"] += 3 * TP_DECODE_LAYERS * TP_DECODE_STEPS * tp
    emit({"phase": "tp", "launches": {k: v for k, v in launches.items() if v},
          "want": {k: v for k, v in want.items() if v}})
    check(launches == want, f"tp launch counts {launches} != {want}")
    for (name, tp), (acc_a, acc_m) in sums.items():
        block, xx = next((c[1], c[2]) for c in cases if c[0] == name)
        finish = (attn_residual_after_sum if split[(name, tp)][0]._k2_route(xx)
                  else residual_after_sum)
        with torch.inference_mode():
            got_a = finish(xx, acc_a, block.self_attn.out_proj.weights(torch.bfloat16)[1])
            got_m = residual_after_sum(xx, acc_m, block.mlp.fc2.weights(torch.bfloat16)[1])
        for part, got, ref in (("attention", got_a, wants[name][0]),
                               ("mlp", got_m, wants[name][1])):
            ulps, elem, over1 = bf16_ulp_err(got, ref)
            rel_l2 = float((got.float() - ref.float()).norm() / ref.float().norm())
            emit({"phase": "tp", "summed": part, "case": name, "tp": tp, "ulps": ulps,
                  "bar_ulps": ULP_BAR, "elementwise_max_ulps": elem,
                  "elementwise_share_over_1ulp": over1, "rel_l2": rel_l2})
            check(ulps <= ULP_BAR, f"tp {name} x{tp} {part}: {ulps} ulps from the unsharded route")
    for tp in (2, 4):
        per_rank = logits[tp]
        for r in range(1, tp):
            check(all(torch.equal(a, b) for a, b in zip(per_rank[0], per_rank[r])),
                  f"tp {tp}: rank {r}'s joined logits differ from rank 0's")
        cover, bad, scored = [], 0, 0
        for got, ref in zip(per_rank[0], want_logits):
            clear = margins(ref.float()) > ARGMAX_MARGIN
            bad += int(((got.float().argmax(-1) != ref.float().argmax(-1)) & clear).sum())
            scored += clear.numel()
            cover.append(float(clear.float().mean()))
        ulps, _, _ = bf16_ulp_err(torch.stack(per_rank[0]), torch.stack(want_logits))
        emit({"phase": "tp", "decode": tp, "heads_a_rank": H // tp,
              "vocab_split": w.vocab_size % tp == 0, "coverage": statistics.mean(cover),
              "argmax_mismatches_over_margin": bad, "positions": scored, "logit_ulps": ulps})
        check(bad == 0, f"tp {tp} decode: {bad} clear argmaxes differ from the unsharded step")
        check(statistics.mean(cover) >= MIN_COVERAGE, f"tp {tp} decode: coverage too low")
    # the vocab-split tied logits: each rank's columns against the whole
    # product's, on one final LN output
    with torch.inference_mode():
        xd = bf(B, 1, d)
        table = whole.decoder.embed_tokens.table(torch.bfloat16)
        full = torch.matmul(xd, table.t())
        n = w.vocab_size // 2
        cols = [torch.matmul(xd, r.decoder.embed_tokens.table(torch.bfloat16).t())
                for r in dec_ranks[2]]
        joined = torch.cat(cols, -1)
        ulps, _, _ = bf16_ulp_err(joined, full)
        emit({"phase": "tp", "vocab_logits": {"ranks": 2, "columns": n, "ulps": ulps,
                                              "bitwise": bool(torch.equal(joined, full))}})
        check(ulps <= ULP_BAR, f"vocab-split logits off by {ulps} ulps")
    del dec_ranks, whole, want_logits, logits, decoded
    rows = tp_timing(split, cases)
    emit({"phase": "tp", "seconds": round(time.monotonic() - t0, 1)})
    return launches, errs, rows


def k2tp_core_readings(core) -> dict:
    """attention_core_tp's device time, its three launches queued behind a
    spin kernel (its cuda_ms, a host loop of three launches, times the
    dispatch at the smaller shapes), its attention core alone (queued)
    beside the library's masked SDPA forward on the same q, k, v (queued;
    the core's only library counterpart, context: it rounds P at another
    point), and the host microseconds of the wrapper's per-call conversions
    (weights and lengths .to(device, dtype).contiguous()), with whether any
    of them copies."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import fused_attention as fa
    from jiao_liao_speech_recognition_torch.ops import fused_mlp as fm

    x, g, bl, w_qkv, b_qkv, lens, H, eps = core
    B, T, _ = x.shape
    D = w_qkv.shape[1] // 3
    qkv = fm.ln_qkv_launch(x, g, bl, w_qkv, b_qkv, eps)
    q, k, v = (qkv[..., i * D:(i + 1) * D].view(B, T, H, D // H) for i in range(3))

    def conversions():
        return ([t.to(x.device, torch.bfloat16).contiguous() for t in (w_qkv, b_qkv)]
                + [lens.to(x.device, torch.int32).contiguous()])

    t0 = time.perf_counter()
    for _ in range(1000):
        conversions()
    conv_us = (time.perf_counter() - t0) * 1e3
    return {"core_ms": queued_ms(lambda: fa.attention_core_launch(qkv, lens, H), 20),
            "core_library_ms": _yardsticks().sdpa_forward_ms(q, k, v, lens),
            "queued_ms": queued_ms(lambda: fa.attention_core_tp(*core), 20),
            "wrapper_conversions_us": conv_us,
            "wrapper_conversions_copy": any(
                a.data_ptr() != b.data_ptr() for a, b in zip(conversions(), (w_qkv, b_qkv, lens)))}


def tp_timing(split, cases) -> dict:
    """The row-parallel GEMM, ln_fc1 and attention_core_tp on rank 0's
    operands (the large-v3 encoder's B=16 x 1500 rows at tp 2, the
    flagship's at tp 2), and K5 at the tp widths, beside their plain
    versions, bounds and cuBLAS (torch.mm with an f32 result where it
    takes one, for the row partial)."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import fused_attention as fa
    from jiao_liao_speech_recognition_torch.ops import fused_mlp as fm

    rows = {}
    block = split[("large_v3", 2)][0]
    _, _, x, lens, _ = cases[0]
    B, T, d = x.shape
    M = B * T
    m, mln = block.mlp, block.mlp_ln
    with torch.inference_mode():
        w1, b1 = m.fc1.weights(torch.bfloat16)
        w2 = m.fc2.weights(torch.bfloat16)[0]
        h = fm.ln_fc1(x, mln.scale, mln.bias, w1, b1, mln.eps, "erf")
        K, N = w2.shape

        def lib():
            try:
                return torch.mm(h.view(M, K), w2, out_dtype=torch.float32)
            except (TypeError, RuntimeError):
                return torch.mm(h.view(M, K), w2)

        ms, ms_p, ms_l = (cuda_ms(f, TP_TIMED_ITERS) for f in (
            lambda: fa.row_partial(h, w2), lambda: fa.row_partial_plain(h, w2), lib))
        b_ms, b_by = bound(M * K * 2 + K * N * 2 + M * N * 4, {"bf16": 2.0 * M * N * K})
        rows["row-partial"] = {"ms": ms, "plain_ms": ms_p, "library_ms": ms_l, "bound_ms": b_ms,
                               "bound_by": b_by, "shape": [M, K, N], "tp": 2,
                               "library": "torch.mm (f32 out where taken)",
                               "tflops": tflops(2.0 * M * N * K, ms)}
        args = (x, mln.scale, mln.bias, w1, b1, mln.eps, "erf")
        ms, ms_p = (cuda_ms(f, TP_TIMED_ITERS) for f in (lambda: fm.ln_fc1(*args),
                                                          lambda: fm.ln_fc1_plain(*args)))
        mloc = w1.shape[1]
        b_ms, b_by = bound(M * d * 2 + d * mloc * 2 + M * mloc * 2 + 8 * d,
                           {"bf16": 2.0 * M * d * mloc})
        rows["K3-tp"] = {"ms": ms, "plain_ms": ms_p, "library_ms": None, "bound_ms": b_ms,
                         "bound_by": b_by, "shape": [M, d, mloc], "tp": 2, "gelu": "erf",
                         "tflops": tflops(2.0 * M * d * mloc, ms)}
        fb = split[("flagship", 2)][0]
        _, _, xf, lf, _ = cases[2]
        w_qkv, b_qkv, _ = fb._attention_weights(torch.bfloat16)
        ln = fb.self_attn_ln
        Hl = fb.self_attn.num_heads
        core = (xf, ln.scale, ln.bias, w_qkv, b_qkv, lf, Hl, ln.eps)

        def core_plain():
            return fa.attention_core_plain(fm.qkv_gemm_plain(
                fm.ln_rows_plain(xf, ln.scale, ln.bias, ln.eps), w_qkv, b_qkv), lf, Hl)

        ms, ms_p = (cuda_ms(f, TP_TIMED_ITERS) for f in (lambda: fa.attention_core_tp(*core),
                                                          core_plain))
        Bf, Tf, df = xf.shape
        Mf, Nq = Bf * Tf, w_qkv.shape[1]
        Dl = Nq // 3
        dh = Dl // Hl
        ops = 2.0 * Mf * df * Nq + fl_flops(Bf, Tf, lf, Hl, dh)
        b_ms, b_by = bound(Mf * df * 2 + df * Nq * 2 + Mf * Dl * 2, {"bf16": ops})
        r = k2tp_core_readings(core)
        rows["K2-tp"] = {"ms": r.pop("queued_ms"), "host_loop_ms": ms, "plain_ms": ms_p,
                         "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                         "shape": [Bf, Tf, df, Hl, dh], "tp": 2, **r}
        k5 = []
        for tp in (2, 4):
            rb = split[("large_v3", tp)][0]
            w_qkv, b_qkv, _ = rb._attention_weights(torch.bfloat16)
            D = rb.self_attn.num_heads * rb.self_attn.head_dim
            la = rb.self_attn_ln
            qa = (x, la.scale, la.bias, w_qkv, b_qkv, la.eps)
            ms, ms_p = (cuda_ms(f, TP_TIMED_ITERS) for f in (
                lambda: fm.fused_ln_qkv(*qa, width=D), lambda: fm.ln_qkv_plain(*qa, width=D)))
            Nq = w_qkv.shape[1]
            b_ms, b_by = bound(M * d * 2 + d * 3 * D * 2 + M * 3 * D * 2,
                               {"bf16": 2.0 * M * d * 3 * D})
            k5.append({"tp": tp, "columns": 3 * D, "packed": Nq, "ms": ms, "plain_ms": ms_p,
                       "bound_ms": b_ms, "bound_by": b_by})
        rows["K5"] = {"tp_shapes": k5}
    emit({"phase": "tp", "timing": rows})
    return rows


def tps_split(whole_bundle, tp: int, group):
    """`tp` rank bundles of the bf16 `whole_bundle`, each a copy split as its
    rank over `group` (a TurnGroup) and quantized after the split, as
    ``cli serve --int8`` does on a model group (a row layer's scales are the
    group's max: a collective, so the ranks quantize in turns)."""
    import copy

    from jiao_liao_speech_recognition_torch.models.bundle import ModelBundle
    from jiao_liao_speech_recognition_torch.parallel.tp import TPGroup, apply_tp

    split = []
    for r in range(tp):
        model = copy.deepcopy(whole_bundle.model)
        apply_tp(model, TPGroup(r, tp, group.member(r)))
        split.append(ModelBundle(whole_bundle.config, model, whole_bundle.tokenizer))
    return group.run([lambda b=b: b.quantize() for b in split])


def tps_kernel_checks(ranks, errs: dict) -> None:
    """Rank 0's int8 decode launches at a split model's shapes against their
    plain versions, each launched twice bitwise: K10's row partial on the
    out-projections' and fc2's rows (ROW_REL_BAR), K10 on q_proj's and
    fc1's columns with their biases (ULP_BAR), K11 on the rank's vocab rows
    (its tail tile ragged: 25,933 rows at tp 2; the whole 51,866 at tp 4,
    where the table is replicated; ROW_REL_BAR of max |logit|), and
    K9-int8 on the rank's 10 or 5 heads of its engine's self and cross
    caches at ragged lengths (ULP_BAR)."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import quant

    bf = torch.bfloat16
    randn = _card_randn(21)
    model, eng = ranks[0]
    tp = model.decoder.blocks[0].mlp.fc2.tp.size
    block = model.decoder.blocks[0]
    with torch.inference_mode():
        for launch, dense in (("self out_proj", block.self_attn.out_proj),
                              ("cross out_proj", block.cross_attn.out_proj),
                              ("fc2", block.mlp.fc2)):
            q, sc = dense.kernel_q, dense.scale
            for R in TPS_ROWS:
                info = {"phase": "tp_serve", "tp": tp, "launch": launch, "rows": R,
                        "shape": list(q.shape)}
                x = randn(R, q.shape[0]).to(bf)
                got = _twice("K10-row", lambda: quant.int8_row_partial(x, q, sc), **info)
                errs["K10-row"] = max(errs.get("K10-row", 0.0), _rel_check(
                    "K10-row", got, quant.int8_row_partial_plain(x, q, sc), **info))
        for launch, dense in (("self q_proj", block.self_attn.q_proj), ("fc1", block.mlp.fc1)):
            q, sc, b = dense.kernel_q, dense.scale, dense.bias.to(bf)
            for R in TPS_ROWS:
                x = randn(R, q.shape[0]).to(bf)
                info = {"phase": "tp_serve", "tp": tp, "launch": launch, "rows": R,
                        "shape": list(q.shape)}
                got = _twice("K10", lambda: quant.int8_gemv(x, q, sc, b), **info)
                errs["K10"] = max(errs.get("K10", 0.0), _ulp_check(
                    "K10", got, quant.int8_matmul_plain(x, q, sc, b), **info))
        emb = model.decoder.embed_tokens
        for R in TPS_ROWS:
            x = randn(R, emb.embedding_q.shape[1]).to(bf)
            info = {"phase": "tp_serve", "tp": tp, "rows": R, "vocab_rows":
                    emb.embedding_q.shape[0], "split": emb.tp is not None}
            got = _twice("K11", lambda: quant.int8_logits(x, emb.embedding_q, emb.scale), **info)
            errs["K11"] = max(errs.get("K11", 0.0), _rel_check(
                "K11", got, quant.int8_tied_logits_plain(x, emb.embedding_q, emb.scale), **info))
        B = eng.slots
        for kind, horizon in (("self", TPS_MAX_LEN), ("cross", eng._enc_all.shape[1])):
            c = eng._caches["block_0"][kind]
            H, dh = c["k"].shape[1], c["k"].shape[3]
            qh = randn(B, H, 1, dh).to(bf)
            lens = torch.tensor(([horizon, horizon - 1, horizon // 2, 1] * B)[:B],
                                dtype=torch.int32, device="cuda")
            args = (qh, c["k"], c["k_scale"], c["v"], c["v_scale"], lens)
            info = {"phase": "tp_serve", "tp": tp, "cache": kind, "heads": H,
                    "Tk": c["k"].shape[2]}
            got = _twice("K9-int8", lambda: quant.int8_decode_attention(*args), **info)
            errs["K9-int8"] = max(errs.get("K9-int8", 0.0), _ulp_check(
                "K9-int8", got, quant.int8_decode_attention(*args, kernels=False), **info))


def tps_timing(ranks_by_tp) -> dict:
    """K10's row partial (fc2's rows at tp 2, the pool's 16 rows), K11 on a
    rank's vocab rows (tp 2) and K9-int8 on a rank's heads of the engine's
    cross caches (tp 2 and 4), each by device time over inputs cycled past
    twice the L2, beside its bound, its library call (device time) and its
    plain version (CUDA events: a sequence of library calls, tens to
    hundreds of us)."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import quant

    bf = torch.bfloat16
    randn = _card_randn(31)

    def cycle(fns):
        it = itertools.cycle(fns)
        return lambda: next(it)()

    def copies(nbytes):
        return max(2, math.ceil(2 * L2_BYTES / nbytes))

    rows = {}
    with torch.inference_mode():
        fc2 = ranks_by_tp[2][0][0].decoder.blocks[0].mlp.fc2
        q, sc = fc2.kernel_q, fc2.scale
        K, N = q.shape
        R = TPS_SLOTS
        x = randn(R, K).to(bf)
        sets = [(q.clone(), sc.clone()) for _ in range(copies(K * N))]
        wb = [(qq.float() * ss).to(bf) for qq, ss in sets]
        kern = cycle([lambda qq=qq, ss=ss: quant.int8_row_partial(x, qq, ss) for qq, ss in sets])
        plain = cycle([lambda qq=qq, ss=ss: quant.int8_row_partial_plain(x, qq, ss)
                       for qq, ss in sets])

        def mm_f32(a, w2):
            try:
                return torch.mm(a, w2, out_dtype=torch.float32)
            except (TypeError, RuntimeError):
                return torch.mm(a, w2)

        lib = cycle([lambda w2=w2: mm_f32(x, w2) for w2 in wb])
        b_ms, b_by = bound(K * N + 4 * N + 2 * R * K + 4 * R * N, {"bf16": 2.0 * R * K * N})
        rows["K10-row"] = {"ms": device_ms(kern, TPS_TIMED_ITERS),
                           "plain_ms": cuda_ms(plain, TPS_TIMED_ITERS),
                           "bound_ms": b_ms, "bound_by": b_by,
                           "library_ms": device_ms(lib, TPS_TIMED_ITERS),
                           "library": "torch.mm of the dequantized bf16 rows, f32 out",
                           "shape": [R, K, N], "tp": 2}
        k11 = []
        for tp in (2,):  # at tp 4 the table is whole: phase 9's K11 row
            emb = ranks_by_tp[tp][0][0].decoder.embed_tokens
            tq, ts = emb.embedding_q, emb.scale
            V, D = tq.shape
            xs = randn(R, D).to(bf)
            sets = [(tq.clone(), ts.clone()) for _ in range(copies(V * D))]
            kern = cycle([lambda qq=qq, ss=ss: quant.int8_logits(xs, qq, ss) for qq, ss in sets])
            plain = cycle([lambda qq=qq, ss=ss: quant.int8_tied_logits_plain(xs, qq, ss)
                           for qq, ss in sets])
            # the full-V row's library call (cuBLAS bf16 tied logits on the
            # dequantized table); the f32-out product read beside it
            wt = [(qq.float() * ss[:, None]).to(bf).t() for qq, ss in sets]
            lib = cycle([lambda w2=w2: torch.matmul(xs, w2) for w2 in wt])
            lib_f32 = cycle([lambda w2=w2: mm_f32(xs, w2) for w2 in wt])
            b_ms, b_by = bound(V * D + 4 * V + 2 * R * D + 4 * R * V, {"bf16": 2.0 * R * V * D})
            k11.append({"tp": tp, "vocab_rows": V, "rows": R,
                        "ms": device_ms(kern, TPS_TIMED_ITERS),
                        "plain_ms": cuda_ms(plain, TPS_TIMED_ITERS), "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": device_ms(lib, TPS_TIMED_ITERS),
                        "library": "cuBLAS bf16 tied logits on the dequantized table rows",
                        "library_f32_out_ms": device_ms(lib_f32, TPS_TIMED_ITERS)})
        rows["K11"] = k11
        k9 = []
        for tp in (2, 4):
            eng = ranks_by_tp[tp][0][1]
            c, t_enc = eng._caches["block_0"]["cross"], eng._enc_all.shape[1]
            B, H, Tk, dh = c["k"].shape
            qh = randn(B, H, 1, dh).to(bf)
            lens = torch.full((B,), t_enc, dtype=torch.int32, device="cuda")
            nbytes = 2 * B * H * Tk * (dh + 4)
            sets = [{n: t.clone() for n, t in c.items()} for _ in range(copies(nbytes))]

            def call(cc, kernels):
                return quant.int8_decode_attention(qh, cc["k"], cc["k_scale"], cc["v"],
                                                   cc["v_scale"], lens, kernels)

            kern = cycle([lambda cc=cc: call(cc, True) for cc in sets])
            plain = cycle([lambda cc=cc: call(cc, False) for cc in sets])
            b_ms, b_by = bound(2 * B * H * t_enc * (dh + 4) + 4 * B * H * dh,
                               {"bf16": 4.0 * B * H * t_enc * dh})
            k9.append({"tp": tp, "heads": H, "Tk": Tk, "rows": B,
                       "ms": device_ms(kern, TPS_TIMED_ITERS),
                       "plain_ms": cuda_ms(plain, TPS_TIMED_ITERS), "bound_ms": b_ms,
                       "bound_by": b_by})
        rows["K9-int8"] = k9
    emit({"phase": "tp_serve", "timing": rows})
    return rows


def whisper_beam_scores(model, gen, lens, enc, prompt):
    """Each beam hypothesis gen [B, K, L] (after the prompt; `lens` tokens,
    then EOT) fed through `model`'s cached steps as beam_from_enc runs them
    (init_cache(..., beams=K)) -> its summed f32 log-probs [B, K], the
    forced prompt's included, added a step at a time as the beam adds them."""
    import torch

    from jiao_liao_speech_recognition_torch.decode.whisper_generate import log_softmax_f32

    B, K, L = gen.shape
    P = len(prompt)
    toks = torch.cat([torch.tensor(prompt, device=gen.device).expand(B * K, P),
                      gen.reshape(B * K, L)], 1)
    caches = model.init_cache(B, enc, P + L, None, beams=K)
    last = (P - 1 + lens + 1).clamp(max=P + L - 2).reshape(B * K)  # the EOT's step
    acc = torch.zeros(B * K, device=gen.device)
    for pos in range(P + L - 1):
        logits, caches = model.decode_step(toks[:, pos:pos + 1], pos, enc, caches)
        lp = log_softmax_f32(logits).gather(1, toks[:, pos + 1, None])[:, 0]
        acc = acc + torch.where(pos <= last, lp, 0.0)
    return acc.view(B, K)


def tps_requests():
    """TPS_SLOTS seeded requests of 1-30 s, tones and noise."""
    rng = np.random.RandomState(21)
    out = []
    for i in range(TPS_SLOTS):
        t = np.arange(int(rng.uniform(1.0, 30.0) * SAMPLE_RATE)) / SAMPLE_RATE
        out.append((0.2 * np.sin(2 * np.pi * rng.uniform(150, 2000) * t)
                    + 0.05 * rng.randn(len(t))).astype(np.float32))
    return out


def phase_tp_serving(counters, card: str):
    """Phase 21 (main path 30; see the module docstring) -> (launches,
    errors by kernel key, timing rows)."""
    import torch

    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch, pad_or_trim
    from jiao_liao_speech_recognition_torch.models.bundle import ModelBundle
    from jiao_liao_speech_recognition_torch.models.layers import cast_for_serving
    from jiao_liao_speech_recognition_torch.models.whisper import WhisperModel
    from jiao_liao_speech_recognition_torch.serve.engine import ServingEngine

    t0 = time.monotonic()
    cfg = whisper_config()
    w = cfg.whisper = dataclasses.replace(cfg.whisper, encoder_layers=TPS_LAYERS,
                                          decoder_layers=TPS_LAYERS)
    cfg.decode.max_decode_len = TPS_MAX_LEN
    model = WhisperModel(w, device="cuda", seed=21)
    cast_for_serving(model, torch.bfloat16)
    bundle = ModelBundle(cfg, model.eval(),
                         CharTokenizer([chr(0x4E00 + i) for i in range(w.vocab_size - 2)]))
    whole = bundle.quantize()
    groups = {tp: TurnGroup(tp) for tp in (2, 4)}
    ranks = {}  # tp -> [(model, engine)] by rank
    for tp in (2, 4):
        qbs = tps_split(bundle, tp, groups[tp])
        engines = groups[tp].run([lambda b=b: ServingEngine(
            b, slots=TPS_SLOTS, steps_per_dispatch=TPS_STEPS, max_len=TPS_MAX_LEN,
            graph=False) for b in qbs])
        ranks[tp] = [(b.model, e) for b, e in zip(qbs, engines)]
    requests = tps_requests()

    def serve(eng):  # every request in one wave, then dispatches until done
        def fn():
            rids = [eng.submit(a, admit=False) for a in requests]
            done = {}
            while eng.in_flight:
                done.update((r.rid, r) for r in eng.step())
            return [done[rid] for rid in rids]
        return fn

    def main_path():
        return {tp: groups[tp].run([serve(e) for _, e in ranks[tp]]) for tp in (2, 4)}

    served, launches = drive(counters, "tp_serve", main_path)
    L = TPS_LAYERS
    want = {k: 0 for k in counters}
    for tp in (2, 4):
        eng = ranks[tp][0][1]
        for _, e in ranks[tp]:
            check(e.stats.decode_steps == eng.stats.decode_steps
                  and e.stats.waves == eng.stats.waves, f"tp {tp}: the ranks stepped apart")
        steps, waves = eng.stats.decode_steps, eng.stats.waves
        # a wave: K1, then each encoder block's K5, K6, ln_fc1 and two row
        # partials; a step: each decoder block's five column products (q, k,
        # v, cross q, fc1), three row partials (both out-projections, fc2),
        # two K9-int8 (int8 self caches at 16 lanes, and the cross caches),
        # the int8 self-cache write, then K11 once
        for key, n in (("K1", waves), ("K5", L * waves), ("K6", L * waves),
                       ("K3-tp", L * waves), ("row-partial", 2 * L * waves),
                       ("K10", 5 * L * steps), ("K10-row", 3 * L * steps),
                       ("K9-int8", 2 * L * steps), ("K11", steps), ("KVW", L * steps)):
            want[key] += n * tp
        for r in range(1, tp):
            check([(q.text, q.ids) for q in served[tp][r]] ==
                  [(q.text, q.ids) for q in served[tp][0]],
                  f"tp {tp}: rank {r}'s results differ from rank 0's")
    emit({"phase": "tp_serve", "launches": {k: v for k, v in launches.items() if v},
          "want": {k: v for k, v in want.items() if v}})
    check(launches == want, f"tp_serve launch counts {launches} != {want}")

    # the split engines' tokens against the unsplit int8 decoder's
    # teacher-forced steps (the margin rule)
    prompt, eot = wg.resolve_specials(w)
    P = len(prompt)
    with torch.inference_mode():
        wav = torch.from_numpy(np.stack([pad_or_trim(a, cfg.frontend)
                                         for a in requests])).cuda()
        enc = whole.model.encode(featurize_batch(wav, cfg.frontend))
        for tp in (2, 4):
            eng, done = ranks[tp][0][1], served[tp][0]
            toks = torch.full((len(done), TPS_MAX_LEN), eot, dtype=torch.long, device="cuda")
            toks[:, :P] = torch.tensor(prompt, device="cuda")
            for i, req in enumerate(done):
                toks[i, P:P + len(req.ids)] = torch.tensor(req.ids, device="cuda")
            lens = torch.tensor([len(r.ids) for r in done], device="cuda")
            logits = forced_logits(whole.model, toks, enc, True)
            coverage, mismatch, scored, agree = margin_check(logits, toks, lens, P)
            emit({"phase": "tp_serve", "engine": tp, "heads_a_rank": w.num_heads // tp,
                  "vocab_split": w.vocab_size % tp == 0, "requests": len(done),
                  "decode_steps": eng.stats.decode_steps, "coverage": coverage,
                  "mismatched_positions": mismatch, "positions": scored,
                  "agree_all_positions": agree})
            check(mismatch == 0, f"tp {tp} engine: {mismatch} clear argmaxes differ from the "
                  "unsplit int8 decoder's")
            check(coverage >= MIN_COVERAGE, f"tp {tp} engine: coverage {coverage} too low")

    errs = {}
    for tp in (2, 4):
        tps_kernel_checks(ranks[tp], errs)
    rows = tps_timing(ranks)
    with torch.inference_mode():
        # the AR beam and timestamps on the split int8 models against the
        # unsplit one: equal on every rank and to one card
        n, K = TPS_BEAM
        want_beam = wg.beam_from_enc(whole.model, enc[:n], None, K, TPS_MAX_LEN, prompt, eot)
        want_timed = whole.transcribe_timed(requests[:TPS_TIMED])
    for tp in (2, 4):
        def beam_and_timed(m):
            def fn():
                with torch.inference_mode():
                    e = m.encode(featurize_batch(wav[:n], cfg.frontend))
                    beam = wg.beam_from_enc(m, e, None, K, TPS_MAX_LEN, prompt, eot,
                                            graph=False)  # a stand-in group is not captured
                b = ModelBundle(cfg, m, bundle.tokenizer)
                return beam, b.transcribe_timed(requests[:TPS_TIMED], graph=False)
            return fn

        got = groups[tp].run([beam_and_timed(m) for m, _ in ranks[tp]])
        same_ranks = all(all(torch.equal(a, b) for a, b in zip(g[0], got[0][0])) and
                         g[1] == got[0][1] for g in got[1:])
        gen, lens, scores = got[0][0]
        with torch.inference_mode():
            one = whisper_beam_scores(whole.model, gen, lens, enc[:n], prompt)
        own = float(((one - scores).abs() / scores.abs()).max())
        # the split's pick against one card's best, both scored by one card
        behind = float(((want_beam[2][:, 0] - one[:, 0]) / want_beam[2][:, 0].abs()).max())
        beam_tokens = bool(torch.equal(gen, want_beam[0]))
        spans = [(a, b) for ua, ub in zip(got[0][1], want_timed) for a, b in zip(ua, ub)]
        timed_tokens = [[t["token"] for t in u] for u in got[0][1]] == [
            [t["token"] for t in u] for u in want_timed]
        shift = max((round(abs(a[k] - b[k]) / 0.02) for a, b in spans for k in ("start", "end")),
                    default=0)  # encoder frames of 20 ms
        emit({"phase": "tp_serve", "beam": tp, "utterances": n, "beams": K,
              "ranks_equal": same_ranks, "tokens_equal_one_card": beam_tokens,
              "lengths_equal_one_card": bool(torch.equal(lens, want_beam[1])),
              "scores_rel_err_one_card_steps": own, "best_rel_behind_one_card": behind,
              "bar_rel": TPS_BEAM_REL_BAR, "timed_tokens_equal_one_card": timed_tokens,
              "spans": len(spans), "spans_equal_one_card": sum(a == b for a, b in spans),
              "span_max_shift_frames": shift, "bar_shift_frames": TPS_SPAN_BAR_FRAMES})
        check(same_ranks, f"tp {tp}: the ranks' beams or timestamps differ")
        check(own <= TPS_BEAM_REL_BAR and behind <= TPS_BEAM_REL_BAR,
              f"tp {tp}: the split beam is off one card's scores ({own}, {behind})")
        check(timed_tokens and shift <= TPS_SPAN_BAR_FRAMES,
              f"tp {tp}: the split timestamps differ from one card's (shift {shift} frames)")

    # the beam bar's upper reading: the split beam again with a fault that
    # this script puts in (the package untouched); each must read above it
    def ungathered(m):
        """m.decode_step with each block's self caches put back, in place,
        as the step before left them: the beam's gather along the winning
        beams (written into the same tensors) undone."""
        real, kept = m.decode_step, {}

        def step(tok, pos, enc_, caches, *rest):
            for name, c in caches.items():
                for n, t in c["self"].items():
                    if (name, n) in kept:
                        t.copy_(kept[name, n])
            logits, caches = real(tok, pos, enc_, caches, *rest)
            kept.update(((name, n), t.clone()) for name, c in caches.items()
                        for n, t in c["self"].items())
            return logits, caches
        return step

    faults = {}
    for tp in (2, 4):
        for fault in ("self_caches_ungathered", "last_share_dropped"):
            def faulty_beam(m, fault=fault):
                def fn():
                    if fault == "self_caches_ungathered":
                        m.decode_step = ungathered(m)
                    try:
                        with torch.inference_mode():
                            e = m.encode(featurize_batch(wav[:n], cfg.frontend))
                            return wg.beam_from_enc(m, e, None, K, TPS_MAX_LEN, prompt, eot,
                                                    graph=False)
                    finally:
                        m.__dict__.pop("decode_step", None)
                return fn

            groups[tp].drop_last = fault == "last_share_dropped"
            try:
                gen, lens, scores = groups[tp].run([faulty_beam(m) for m, _ in ranks[tp]])[0]
            finally:
                groups[tp].drop_last = False
            with torch.inference_mode():
                one = whisper_beam_scores(whole.model, gen, lens, enc[:n], prompt)
            own = float(((one - scores).abs() / scores.abs()).max())
            behind = float(((want_beam[2][:, 0] - one[:, 0]) / want_beam[2][:, 0].abs()).max())
            faults[f"tp{tp} {fault}"] = max(own, behind)
    emit({"phase": "tp_serve", "beam_faults_rel": faults, "bar_rel": TPS_BEAM_REL_BAR})
    check(min(faults.values()) > TPS_BEAM_REL_BAR,
          f"the beam bar {TPS_BEAM_REL_BAR} passes a faulty split beam: {faults}")
    emit({"phase": "tp_serve", "seconds": round(time.monotonic() - t0, 1)})
    return launches, errs, rows


# phase 22: the CTC and joint paths on a split model, each rank of a model
# group a copy of the unsplit model split as its rank (TurnGroup threads,
# eager), at tp 2 and 4: the flagship (CTCModelConfig's widths: 4 heads of
# 128, mlp 2048, V 4336) with its head scaled by TPC_HEAD_SCALE (peakier
# eager: the flagship (CTCModelConfig's widths: 4 heads of 128, mlp 2048, V
# 4336) and configs/joint_ctc_attention.yaml (its WF inserts' B drawn),
# each stack cut to TPC_LAYERS blocks; the pool's TPC_SLOTS streams over
# TPC_STEPS ring steps of TPC_STREAM (window, hop, lookahead seconds); the
# device CTC beam (beam CTC_BEAM_K, top-k CTC_BEAM_TOPK, phase 15's) over
# TPC_BEAM_B chunks of TPC_BEAM_SECONDS (the beam is ~80 launches a frame
# whatever the rows, and each rank runs it); the joint greedy over
# TPC_JOINT_B 30 s chunks, TPC_JOINT_LEN tokens; spec_greedy at the
# config's 64 (teacher passes of 64 positions: the split ln_fc1); the joint
# beam over TPC_BEAM = (utterances, beams), TPC_JOINT_LEN tokens. The fault
# readings (TurnGroup.drop_last) run at TPC_FAULT_TP. The random flagship's
# posteriors are near flat (a row's best-path NLL ~1,200 nats at 250
# frames), so the beam's pick moves with the split's rounding: at 2 blocks
# (log-probs within 0.02 of one card's) no row picked one card's
# hypothesis on an H100, and the best NLLs parted by up to 1.32e-3
# relative at 10 s chunks (tp 2; 7.5e-4 at 30 s); at 1 block 6.4e-5 at
# 30 s, two rows of four the same hypothesis
TPC_LAYERS = 1
TPC_SLOTS, TPC_STEPS, TPC_STREAM = 32, 3, (10.0, 0.4, 0.64)
TPC_BEAM_B, TPC_BEAM_SECONDS = 4, 10.0
TPC_JOINT_B, TPC_JOINT_LEN, TPC_SPEC_LEN = 2, 16, 64
TPC_BEAM = (2, 4)
# a hypothesis that ends at its first step (EOS, the blank, first) scores
# one log-prob of a bf16 logit, so TPS_BEAM_REL_BAR holds the scores of
# hypotheses with tokens, and an EOS-only score is held within ULP_BAR
# bf16 ulps of its EOS logit (one card's): a logit in [2, 4) one ulp
# apart moves a -5.7 score by 2^-6, 2.7e-3 of it (an H100 read 0.0154 and
# 0.0155 at tp 2 and 4 against 2^-6 = 0.0156)
TPC_FAULT_TP = 2
TPC_TIMED_ITERS = 3
# the kernels at the split paths' rows (B, T'): the ring step's, the
# joint's 30 s chunks (training's B=16) and phase 15's beam batch
TPC_KERNEL_ROWS = {"ring": (32, 250), "joint": (16, 750), "beam": (128, 750)}


def tpc_bundles():
    """The flagship and the joint config on the card, cut to TPC_LAYERS
    blocks a stack (random init, seed 0, bf16 serving copies): (flagship
    bundle, joint bundle)."""
    import torch

    from jiao_liao_speech_recognition_torch import api
    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.models.adapters import WFAdapter
    from jiao_liao_speech_recognition_torch.utils.config import (CTCModelConfig,
                                                                 ExperimentConfig, load_yaml)

    cfg = ExperimentConfig(ctc_model=dataclasses.replace(CTCModelConfig(),
                                                         num_layers=TPC_LAYERS))
    cfg.frontend = dataclasses.replace(cfg.frontend, chunk_seconds=TPC_BEAM_SECONDS)
    check((cfg.ctc_model.d_model, cfg.ctc_model.num_heads, cfg.ctc_model.mlp_dim,
           cfg.ctc_model.vocab_size) == (512, 4, 2048, 4336), f"the flagship changed: {cfg}")
    flag = api.load(config=cfg, device="cuda")
    jcfg = load_yaml(str(Path(__file__).resolve().parent / JOINT_CONFIG))
    jcfg.joint = dataclasses.replace(jcfg.joint, num_layers=TPC_LAYERS,
                                     decoder_layers=TPC_LAYERS)
    joint = api.load(config=jcfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for m in joint.model.modules():
            if isinstance(m, WFAdapter):
                m.b.normal_(0.0, JOINT_WF_B_STD, generator=gen)
    for b in (flag, joint):
        b.tokenizer = CharTokenizer([chr(0x4E00 + i) for i in range(4334)])
    return flag, joint


def tpc_split(whole, tp: int, group):
    """`tp` rank bundles of `whole`, each a copy split as its rank over
    `group` (a TurnGroup) in bf16 serving form."""
    from jiao_liao_speech_recognition_torch.models.bundle import ModelBundle

    return [ModelBundle(whole.config, m, whole.tokenizer)
            for m in tp_ranks(whole.model, tp, group)]


def tpc_decoders():
    """(module, function name) of each decoder that tpc_paths watches, by
    the key it records under."""
    from jiao_liao_speech_recognition_torch.decode import ctc as dctc
    from jiao_liao_speech_recognition_torch.decode import joint_generate as jg
    from jiao_liao_speech_recognition_torch.decode import speculative as sp

    return {"beam_device": (dctc, "ctc_prefix_beam_search"), "greedy": (jg, "joint_greedy"),
            "spec": (sp, "joint_spec_greedy"), "beam": (jg, "beam_from_enc")}


class Watching:
    """Inside the block, each decoder of tpc_decoders() records its calls'
    results by calling thread (a model group's ranks are threads) and key:
    the held checks read what the entry points decoded."""

    def __enter__(self):
        import threading

        self.seen, self.real = {}, {}
        for key, (module, name) in tpc_decoders().items():
            real = self.real[key] = getattr(module, name)

            def wrapper(*args, key=key, real=real, **kwargs):
                out = real(*args, **kwargs)
                self.seen.setdefault(threading.get_ident(), {}).setdefault(key, []).append(
                    (args, out))
                return out

            setattr(module, name, wrapper)
        return self

    def __exit__(self, *exc):
        for key, (module, name) in tpc_decoders().items():
            setattr(module, name, self.real[key])

    def mine(self) -> dict:
        import threading

        return self.seen.get(threading.get_ident(), {})


def tpc_paths(bundle, audio, watch: Watching):
    """One rank's (or one card's) split paths through the entry points,
    inside `watch` -> {"pool": [each step's output [slots, 1 + T'], its ring
    and its mel frames], "beam_device": (ids, lens), "greedy": (tokens,
    lengths), "spec": (tokens, lengths), "beam": (hyps, lengths, scores)}
    for `bundle`, a (flagship, joint) pair."""
    import torch

    from jiao_liao_speech_recognition_torch.serve.streaming import StreamingConfig, StreamingPool
    from jiao_liao_speech_recognition_torch.utils.config import DecodeConfig

    flag, joint = bundle
    out = {"pool": []}
    pool = StreamingPool(flag, slots=TPC_SLOTS, stream_cfg=StreamingConfig(*TPC_STREAM),
                         graph=False)
    for a in audio["streams"]:
        pool.feed(pool.open(), a)
    for _ in range(TPC_STEPS):
        pool.step()
        out["pool"].append((pool._out.clone(), pool._ring.clone(), pool._ctrl[3].clone()))
    del pool
    calls = {"beam_device": (flag, audio["beam"], DecodeConfig(
                 strategy="beam_device", beam_size=CTC_BEAM_K, beam_topk=CTC_BEAM_TOPK)),
             "greedy": (joint, audio["joint"], DecodeConfig(strategy="greedy",
                                                            max_decode_len=TPC_JOINT_LEN)),
             "spec": (joint, audio["joint"], DecodeConfig(strategy="spec_greedy",
                                                          max_decode_len=TPC_SPEC_LEN)),
             "beam": (joint, audio["joint"][:TPC_BEAM[0]], DecodeConfig(
                 strategy="beam", beam_size=TPC_BEAM[1], max_decode_len=TPC_JOINT_LEN))}
    for key, (b, wavs, dc) in calls.items():
        b.transcribe(wavs, decode_cfg=dc, graph=False)  # a stand-in group is not captured
        seen = watch.mine().get(key, [])
        check(len(seen) == 1, f"tp_ctc {key}: the transcription decoded {len(seen)} times")
        args, out[key] = seen[0]
        if key == "beam_device":  # the log-probs the beam searched, and their frames
            out["beam_lp"] = args[:2]
    torch.cuda.synchronize()
    return out


def tpc_audio():
    """The paths' inputs: TPC_SLOTS streams of TPC_STEPS hops, the beam's
    chunks and the joint's 30 s chunks (tones and noise, seeded)."""
    hop = int(TPC_STREAM[1] * SAMPLE_RATE)
    return {"streams": [a[:TPC_STEPS * hop] for a in stream_audio(TPC_SLOTS, 22, 3.0)],
            "beam": stream_audio(TPC_BEAM_B, 23, TPC_BEAM_SECONDS),
            "joint": stream_audio(TPC_JOINT_B, 24, 30.0)}


def tpc_reference(flag, joint, audio, one):
    """One card's (`flag`, `joint` unsplit) readings for the split paths'
    bars beside its own paths' (`one`): the log-probs of the pool's windows
    at each step, and the joint encoder's output on its chunks."""
    import torch

    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch

    ref = {"pool_lp": []}
    with torch.inference_mode():
        for _, ring, nframes in one["pool"]:
            lp, _ = flag.model(featurize_batch(ring, flag.config.frontend), nframes,
                               head_mode="log_probs")
            ref["pool_lp"].append(lp.float())
        wavs, alens, _ = joint._prepare_audio_chunked(audio["joint"], None)
        ref["enc"], ref["el"] = joint.model.encode(*joint._features(wavs, alens))
    return ref


def tpc_readings(got, one, ref, joint_model) -> dict:
    """The split paths' readings against one card's (the bars' quantities):
    the pool's clear argmaxes apart (frames whose one-card top-2 margin
    passes ARGMAX_MARGIN) and coverage; the device beam's best NLL (each
    row's best hypothesis under the log-probs its search read) against one
    card's, worst relative gap, and beside it each split best scored by one
    card's log-probs; the joint greedy's and spec_greedy's clear argmaxes
    apart under one card's decoder steps (the margin rule) and coverage;
    the joint beam's worst relative gap of each hypothesis's score (of those
    with tokens; an EOS-only one's absolute gap apart) from one card's steps
    fed it, and of its best from one card's best."""
    import torch

    r = {"pool_mismatch": 0, "pool_clear": 0, "pool_frames": 0, "pool_rings_equal": True}
    for (out_s, ring_s, _), (out_1, ring_1, _), lp in zip(got["pool"], one["pool"],
                                                          ref["pool_lp"]):
        r["pool_rings_equal"] &= bool(torch.equal(ring_s, ring_1))
        lens = out_1[:, 0].long()
        valid = torch.arange(out_1.shape[1] - 1, device=lens.device)[None] < lens[:, None]
        clear = valid & (margins(lp[:, :valid.shape[1]]) > ARGMAX_MARGIN)
        r["pool_mismatch"] += int(((out_s[:, 1:] != out_1[:, 1:]) & clear).sum())
        r["pool_clear"] += int(clear.sum())
        r["pool_frames"] += int(valid.sum())
    r["pool_coverage"] = r["pool_clear"] / max(r["pool_frames"], 1)
    lp, olens = one["beam_lp"]
    rows = np.arange(lp.shape[0])
    best = {name: [t.cpu() for t in rec["beam_device"]] for name, rec in (("split", got),
                                                                         ("one", one))}
    n_1 = ctc_nll(lp, olens, *best["one"], rows)
    n_s = ctc_nll(*got["beam_lp"], *best["split"], rows)
    n_x = ctc_nll(lp, olens, *best["split"], rows)
    r["beam_nll_rel"] = float(np.max(np.abs(n_s - n_1) / np.abs(n_1)))
    r["beam_nll_rel_one_card_lp"] = float(np.max(np.abs(n_x - n_1) / np.abs(n_1)))
    r["beam_rows_equal_one_card"] = int(sum(
        torch.equal(a, b) for a, b in zip(best["split"][0], best["one"][0])))
    r["beam_nll_one_card"] = [round(float(x), 3) for x in n_1]
    r["beam_nll_split"] = [round(float(x), 3) for x in n_s]
    r["beam_nll_split_one_card_lp"] = [round(float(x), 3) for x in n_x]
    with torch.inference_mode():
        for key in ("greedy", "spec"):
            ids, lens = got[key][:2]
            toks = with_sos(ids)
            logits = forced_logits(joint_model, toks, ref["enc"], True)
            cov, mism, scored, agree = margin_check(logits, toks, lens, 1)
            r[f"{key}_mismatch"], r[f"{key}_coverage"] = mism, cov
            r[f"{key}_positions"], r[f"{key}_agree"] = scored, agree
        gen, lens, att = got["beam"]
        n = gen.shape[0]
        enc, el = ref["enc"][:n], ref["el"][:n]
        lp_k = beam_forced_logp(joint_model, gen, enc, el, True)
        L = gen.shape[2]
        keep = torch.arange(L, device=gen.device)[None, None] < (lens + 1).clamp(max=L)[..., None]
        mine = torch.where(keep, lp_k, 0.0).sum(2)
        best = one["beam"][2][:, 0]
        g1, l1, a1 = one["beam"]
        lp_1 = beam_forced_logp(joint_model, g1, enc, el, True)
        keep1 = torch.arange(L, device=g1.device)[None, None] < (l1 + 1).clamp(max=L)[..., None]
        r["beam_one_card_self_rel"] = float(((torch.where(keep1, lp_1, 0.0).sum(2) - a1).abs()
                                             / a1.abs()).max())
        r["beam_scores"] = [[round(float(v), 4) for v in row] for row in att]
        r["beam_scores_one_card_steps"] = [[round(float(v), 4) for v in row] for row in mine]
        r["beam_lengths"] = lens.tolist()
        tokens = lens > 0
        r["beam_score_rel"] = float(((mine - att).abs() / att.abs())[tokens].max())
        caches = joint_model.init_cache(n, enc, 2)
        eos = joint_model.decode_step(torch.zeros(n, 1, dtype=torch.long, device=gen.device), 0,
                                      enc, caches, el)[0][:, 0].float()
        ulp = torch.exp2(torch.floor(torch.log2(eos.abs())) - 7)  # bf16: 8 significant bits
        ulps = (mine - att).abs() / ulp[:, None]
        r["beam_eos_only_ulps"] = float(ulps[~tokens].max()) if (~tokens).any() else 0.0
        r["beam_behind_rel"] = float(((best - mine[:, 0]) / best.abs()).max())
        r["beam_tokens_equal_one_card"] = bool(torch.equal(gen, one["beam"][0]))
    return r


def tpc_bars_pass(r) -> dict:
    """Each path bar on readings `r` -> {bar: passed}."""
    return {"pool": r["pool_mismatch"] == 0,
            "beam_device": r["beam_nll_rel"] <= NLL_REL_BAR,
            "greedy": r["greedy_mismatch"] == 0, "spec": r["spec_mismatch"] == 0,
            "beam": (max(r["beam_score_rel"], r["beam_behind_rel"]) <= TPS_BEAM_REL_BAR
                     and r["beam_eos_only_ulps"] <= ULP_BAR)}


def tpc_want(counters, steps: int, passes: int, tp: int) -> dict:
    """The exact launches of one model group's split paths (tpc_paths),
    its ranks' decode steps and spec passes summed (`steps`, `passes`, as
    whisper_generate.STEPS counts them) -> {kernel key: launches}."""
    L = TPC_LAYERS
    want = {k: 0 for k in counters}
    # an encoder pass a rank: K1, then each block's K2-tp (attention_core_tp
    # on its heads), ln_fc1 and two row partials (out_proj, fc2)
    encodes = TPC_STEPS + 4  # the ring steps; the beam, greedy, spec, beam transcribes
    want["K1"] += encodes * tp
    want["K2-tp"] += L * encodes * tp
    want["K3-tp"] += L * encodes * tp
    want["row-partial"] += 2 * L * encodes * tp
    want["K4"] += (TPC_STEPS + 1) * tp  # the ring steps' ids, spec's CTC draft
    # a decode step a block: K9 on its self and cross caches, three row
    # partials (both out-projections, fc2); a 64-position teacher pass a
    # block: K6 (the cross-attention), ln_fc1 and three row partials
    want["K9"] += 2 * L * steps
    want["row-partial"] += 3 * L * (steps + passes)
    want["K6"] += L * passes
    want["K3-tp"] += L * passes
    want["CTC"] += tp  # the joint beam's CTC rescoring, once a rank
    return want


def tpc_kernel_checks(ranks, errs: dict) -> None:
    """Each split launch of the paths at their new shapes against its plain
    version, twice bitwise, on rank 0 of each model group (the serving
    copies: bf16 weights, as the paths read them): tp_rank_checks (K2-tp
    within ULP_BAR, the row partials within ROW_REL_BAR, ln_fc1 within
    ULP_BAR) on a flagship block at the ring's and the beam's rows and a
    joint encoder block (WF folded) at the joint's; a joint decoder block's
    ln_fc1 and fc2 row partial at the teacher pass's 64 positions; K9 on its
    self (64 positions) and cross caches (750 frames) at ragged lengths."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import decode_attention as da
    from jiao_liao_speech_recognition_torch.ops import fused_attention as fa
    from jiao_liao_speech_recognition_torch.ops import fused_mlp as fm

    randn = _card_randn(22)
    bf = torch.bfloat16
    B = TPC_JOINT_B
    with torch.inference_mode():
        for tp, pairs in ranks.items():
            flag, joint = pairs[0]
            for tag, (R, T) in TPC_KERNEL_ROWS.items():
                block = joint.model.enc_blocks[0] if tag == "joint" else flag.model.blocks[0]
                lens = torch.tensor(([T, T - 37, T // 3, 1] * R)[:R], dtype=torch.int32,
                                    device="cuda")
                tp_rank_checks(block, randn(R, T, 512).to(bf), lens, f"tp_ctc {tag}", errs)
            dec = joint.model.dec_blocks[0]
            m, mln = dec.mlp, dec.mlp_ln
            info = {"case": "tp_ctc teacher pass", "rank": 0, "tp": tp}
            (w1, w2), b1 = dec._mlp_weights(bf), m.fc1.weights(bf)[1]
            args = (randn(B, TPC_SPEC_LEN, 512).to(bf), mln.scale, mln.bias, w1, b1, mln.eps,
                    m.gelu_form)
            h = _twice("K3-tp", lambda: fm.ln_fc1(*args), **info)
            errs["K3-tp"] = max(errs.get("K3-tp", 0.0), _ulp_check(
                "K3-tp", h, fm.ln_fc1_plain(*args), mlp=w1.shape[1], **info))
            part = _twice("row-partial", lambda: fa.row_partial(h, w2), **info)
            errs["row-partial"] = max(errs.get("row-partial", 0.0), _rel_check(
                "row-partial", part, fa.row_partial_plain(h, w2), launch="fc2", **info))
            caches = joint.model.init_cache(B, randn(B, 750, 512).to(bf),
                                            TPC_SPEC_LEN)["block_0"]
            caches["self"] = {n: randn(*t.shape).to(bf) for n, t in caches["self"].items()}
            H, dh = dec.self_attn.num_heads, dec.self_attn.head_dim
            qh = randn(B, H, 1, dh).to(bf)
            for kind, full in (("self", TPC_SPEC_LEN), ("cross", 750)):
                k, v = caches[kind]["k"], caches[kind]["v"]
                kl = torch.tensor(([full, full - 1, full // 2, 1] * B)[:B], dtype=torch.int32,
                                  device="cuda")
                got = _twice("K9", lambda: da.grouped_decode_attention(qh, k, v, kl),
                             cache=kind, **info)
                errs["K9"] = max(errs.get("K9", 0.0), _ulp_check(
                    "K9", got, da.decode_attention_plain(qh, k, v, kl), cache=kind, heads=H,
                    Tk=k.shape[2], **info))


def tpc_timing(ranks, rng) -> dict:
    """K2-tp at the ring's and the beam's rows (tp 2 and 4), the row
    partials (out_proj 256 -> 512, fc2 1024 -> 512) and ln_fc1 at the
    ring's rows (tp 2), beside their plain versions, bounds and torch.mm;
    K9 on 2 and 1 heads of 128 at the joint beam's rows (joint_k9_timing);
    K6 and K8 alone at the joint's training shape on 2 and 1 heads
    (flash_train_rows, which also holds them) -> (rows, errors)."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import fused_attention as fa
    from jiao_liao_speech_recognition_torch.ops import fused_mlp as fm

    randn = _card_randn(23)
    bf = torch.bfloat16
    rows = {"K2-tp": [], "row-partial": [], "K3-tp": [], "K9": [], "K6": [], "K8": []}
    errs = {}
    with torch.inference_mode():
        for tp in (2, 4):
            blk = ranks[tp][0][0].model.blocks[0]
            ln, Hl = blk.self_attn_ln, blk.self_attn.num_heads
            w_qkv, b_qkv, wo = blk._attention_weights(bf)
            for tag in ("ring", "beam"):
                B, T = TPC_KERNEL_ROWS[tag]
                x = randn(B, T, 512).to(bf)
                lens = torch.tensor(([T, T - 37, T // 3, 1] * B)[:B], dtype=torch.int32,
                                    device="cuda")
                core = (x, ln.scale, ln.bias, w_qkv, b_qkv, lens, Hl, ln.eps)
                ms, ms_p = (cuda_ms(f, TPC_TIMED_ITERS) for f in (
                    lambda: fa.attention_core_tp(*core),
                    lambda: fa.attention_core_plain(fm.qkv_gemm_plain(
                        fm.ln_rows_plain(x, ln.scale, ln.bias, ln.eps), w_qkv, b_qkv), lens, Hl)))
                M, Nq = B * T, w_qkv.shape[1]
                Dl = Nq // 3
                ops = 2.0 * M * 512 * Nq + fl_flops(B, T, lens, Hl, Dl // Hl)
                b_ms, b_by = bound(M * 512 * 2 + 512 * Nq * 2 + M * Dl * 2, {"bf16": ops})
                r = k2tp_core_readings(core)
                rows["K2-tp"].append({"rows": tag, "shape": [B, T, 512, Hl, Dl // Hl], "tp": tp,
                                      "ms": r.pop("queued_ms"), "host_loop_ms": ms,
                                      "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": b_by,
                                      "library_ms": None, **r})
                if tp != 2 or tag != "ring":
                    continue
                mlp, mln = blk.mlp, blk.mlp_ln
                w1, b1 = mlp.fc1.weights(bf)
                w2 = mlp.fc2.weights(bf)[0]
                args = (x, mln.scale, mln.bias, w1, b1, mln.eps, mlp.gelu_form)
                ms, ms_p = (cuda_ms(f, TPC_TIMED_ITERS) for f in (
                    lambda: fm.ln_fc1(*args), lambda: fm.ln_fc1_plain(*args)))
                n1 = w1.shape[1]
                b_ms, b_by = bound(M * 512 * 2 + 512 * n1 * 2 + M * n1 * 2 + 8 * 512,
                                   {"bf16": 2.0 * M * 512 * n1})
                rows["K3-tp"].append({"rows": tag, "shape": [M, 512, n1], "tp": tp, "ms": ms,
                                      "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": b_by,
                                      "library_ms": None})
                h = fm.ln_fc1(*args)
                a = randn(B, T, wo.shape[0]).to(bf)
                for launch, inp, w in (("out_proj", a, wo), ("fc2", h, w2)):
                    K, N = w.shape

                    def lib(inp=inp, w=w, K=K):
                        try:
                            return torch.mm(inp.view(M, K), w, out_dtype=torch.float32)
                        except (TypeError, RuntimeError):
                            return torch.mm(inp.view(M, K), w)

                    ms, ms_p, ms_l = (cuda_ms(f, TPC_TIMED_ITERS) for f in (
                        lambda: fa.row_partial(inp, w), lambda: fa.row_partial_plain(inp, w),
                        lib))
                    b_ms, b_by = bound(M * K * 2 + K * N * 2 + M * N * 4,
                                       {"bf16": 2.0 * M * N * K})
                    rows["row-partial"].append({
                        "rows": tag, "launch": launch, "shape": [M, K, N], "tp": tp, "ms": ms,
                        "plain_ms": ms_p, "library_ms": ms_l, "bound_ms": b_ms,
                        "bound_by": b_by, "library": "torch.mm (f32 out where taken)"})
    for H in (2, 1):
        rows["K9"] += joint_k9_timing(rng, H)
        e, r = flash_train_rows(rng, JOINT_B, 750, H, 128, [750, 517, 129, 1],
                                f"tp_ctc_{H}_heads", f"a joint rank's {H} heads", plain_iters=2)
        for key in ("K6", "K8"):
            errs[key] = max(errs.get(key, 0.0), e[key])
            rows[key].append({"heads": H, **r[key]})
    emit({"phase": "tp_ctc", "timing": rows})
    return rows, errs


def phase_tp_ctc_joint(counters, card: str):
    """Phase 22 (main path 31; see the module docstring) -> (launches,
    errors by kernel key, timing rows)."""
    import torch

    from jiao_liao_speech_recognition_torch.decode.whisper_generate import STEPS

    t0 = time.monotonic()
    flag, joint = tpc_bundles()
    audio = tpc_audio()
    groups = {tp: TurnGroup(tp) for tp in (2, 4)}
    ranks = {tp: tuple(zip(tpc_split(flag, tp, groups[tp]), tpc_split(joint, tp, groups[tp])))
             for tp in (2, 4)}

    def main_path():
        out, counts = {}, {}
        for tp in (2, 4):
            STEPS.reset()
            with Watching() as watch:
                out[tp] = groups[tp].run([lambda pair=pair: tpc_paths(pair, audio, watch)
                                          for pair in ranks[tp]])
            counts[tp] = (STEPS.steps, STEPS.passes)
        return out, counts

    (split, counts), launches = drive(counters, "tp_ctc", main_path)
    want = {k: 0 for k in counters}
    for tp, (steps, passes) in counts.items():
        for k, n in tpc_want(counters, steps, passes, tp).items():
            want[k] += n
    emit({"phase": "tp_ctc", "launches": {k: v for k, v in launches.items() if v},
          "want": {k: v for k, v in want.items() if v},
          "decode_steps_and_passes": {str(tp): c for tp, c in counts.items()}})
    check(launches == want, f"tp_ctc launch counts {launches} != {want}")
    def tensors(rec):
        return [t for key in sorted(rec) for part in (rec[key] if key == "pool" else [rec[key]])
                for t in part]

    for tp, per_rank in split.items():
        for r in range(1, tp):
            same = all(torch.equal(a, b) for a, b in zip(tensors(per_rank[0]),
                                                         tensors(per_rank[r])))
            check(same, f"tp_ctc tp {tp}: rank {r}'s results differ from rank 0's")

    with Watching() as watch:
        one = tpc_paths((flag, joint), audio, watch)
    ref = tpc_reference(flag, joint, audio, one)
    readings = {}
    for tp in (2, 4):
        r = tpc_readings(split[tp][0], one, ref, joint.model)
        bars = tpc_bars_pass(r)
        readings[tp] = r
        emit({"phase": "tp_ctc", "tp": tp, "heads_a_rank": 4 // tp, **r, "bars_pass": bars,
              "bars": {"argmax_margin": ARGMAX_MARGIN, "nll_rel": NLL_REL_BAR,
                       "beam_rel": TPS_BEAM_REL_BAR, "eos_only_ulps": ULP_BAR,
                       "min_coverage": MIN_COVERAGE}})
        check(all(bars.values()) and r["pool_rings_equal"], f"tp_ctc tp {tp}: a bar fails "
              f"({bars}, rings equal {r['pool_rings_equal']})")
        check(min(r["pool_coverage"], r["greedy_coverage"], r["spec_coverage"]) >= MIN_COVERAGE,
              f"tp_ctc tp {tp}: coverage too low ({r})")

    # each bar's upper reading: the same split paths with the last rank's
    # share left out of every all-reduce (TurnGroup.drop_last)
    g = groups[TPC_FAULT_TP]
    g.drop_last = True
    try:
        with Watching() as watch:
            faulty = g.run([lambda pair=pair: tpc_paths(pair, audio, watch)
                            for pair in ranks[TPC_FAULT_TP]])
    finally:
        g.drop_last = False
    r = tpc_readings(faulty[0], one, ref, joint.model)
    bars = tpc_bars_pass(r)
    emit({"phase": "tp_ctc", "fault": "last_share_dropped", "tp": TPC_FAULT_TP, **r,
          "bars_pass": bars, "sound_readings": readings})
    check(not any(bars.values()), f"tp_ctc: a bar passes a faulty split path ({bars})")

    errs = {}
    tpc_kernel_checks(ranks, errs)
    del split, one, ref, faulty
    rows, t_errs = tpc_timing(ranks, np.random.RandomState(22))
    for k, e in t_errs.items():
        errs[k] = max(errs.get(k, 0.0), e)
    emit({"phase": "tp_ctc", "seconds": round(time.monotonic() - t0, 1)})
    return launches, errs, rows


# --- phase 23: the offline decode loops on captured graphs ---------------------

DG_EAGER_LEN = 40  # max_len of the captured-against-eager large-v3 greedy runs
DG_TIMED_REPLAYS = 4  # replays of a kept graph timed and profiled
# the int8 write's checks: large-v3's self caches at B=16 (20 heads of 64,
# 224 positions padded to 256) and a joint rank's beam rows (16 x 8 beams,
# 4 heads of 128, 64 positions padded to 128)
DG_KV_CASES = ((16, 20, 256, 64, (0, 223, 255)), (128, 4, 128, 128, (0, 63, 127)))
DG_KV_ITERS = (50, 10)  # timed calls of the kernel, of its plain version
DG_SAMPLE_T, DG_SAMPLE_SEED = 1.0, 26  # temperature sampling: T, the CUDA generator's seed
DG_TIMED_PAIRS = 2  # interleaved timings of the sampled and the greedy replays
# the fresh-process worker: prompt=() loops at DG_COLD_LEN, beams of DG_COLD_BEAM,
# DG_COLD_B rows, on the joint config and on a quantize()d large-v3 cut to
# DG_COLD_LAYERS + DG_COLD_LAYERS blocks (phase 21's cut)
DG_COLD_LEN, DG_COLD_BEAM, DG_COLD_B, DG_COLD_LAYERS = 24, 4, 16, 2
DG_COLD_TIMEOUT_S = 300


def captured_steps(max_len: int, prompt_len: int) -> int:
    """Decode steps of a captured loop whose rows never end: the prompt's
    steps eagerly (step 0 under an empty prompt), then whole chunks of
    STOP_CHECK_EVERY (the last one masked past max_len - 1 on the device)."""
    from jiao_liao_speech_recognition_torch.decode.whisper_generate import STOP_CHECK_EVERY

    n = max_len - 1
    first = max(min(prompt_len, n), min(1, n))
    return n if first >= n else first + STOP_CHECK_EVERY * -(-(n - first) // STOP_CHECK_EVERY)


class KeptGraphs:
    """Inside the block every graphs.CapturedStep made is kept, with its
    step (whose closure holds the state tensors the graph reads and
    writes; the decode loops drop both when they return), so a loop's
    graph can be replayed, timed and profiled after its call."""

    def __enter__(self):
        from jiao_liao_speech_recognition_torch.utils import graphs

        self.kept, self.real = [], graphs.CapturedStep
        kept = self.kept

        class Kept(graphs.CapturedStep):
            def __init__(self, step, *args, **kwargs):
                super().__init__(step, *args, **kwargs)
                self.step = step  # the graph's state, alive as long as it is
                kept.append(self)

        graphs.CapturedStep = Kept
        return self

    def __exit__(self, *exc):
        from jiao_liao_speech_recognition_torch.utils import graphs

        graphs.CapturedStep = self.real


def graph_kernels(cap) -> int:
    """Kernels of one replay of `cap` by the profiler's events: a replay as
    the lead-in, a spin kernel as the marker, then the replay counted (as
    replay_profile counts the engine's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cap.graph.replay()
        torch.cuda._sleep(1_000_000)
        cap.graph.replay()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    marks = [e.time_range.start for e in events if "spin_kernel" in e.name]
    check(bool(marks), "the profiler saw no marker kernel")
    return sum(e.time_range.start > max(marks) for e in events)


def replay_readings(cap, steps_per_replay: int, name: str) -> dict:
    """ms a step of `cap`'s replays (CUDA events over DG_TIMED_REPLAYS),
    kernels a replayed step (graph_kernels: device_profile's sums over a
    long window have dropped a few events), and the replays' idle share
    (device_profile over two replays)."""
    ms = cuda_ms(cap.graph.replay, DG_TIMED_REPLAYS)
    kernels = graph_kernels(cap)
    prof = device_profile(lambda i: cap.graph.replay(), 2, name, top=6)
    return {"ms_per_step_replayed": ms / steps_per_replay, "kernels_per_replay": kernels,
            "kernels_per_step": kernels / steps_per_replay, "capture_s": cap.capture_s,
            "replay_idle_share": prof["device_idle_share"], "replay_profile": prof}


def timed(fn):
    """-> (fn's result, wall seconds), synchronized on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def dg_kv_write_rows() -> tuple:
    """jl_int8_kv_write against its plain version (quantize_kv + four
    update_cache_rows) at DG_KV_CASES: ragged positions with 0 and the
    cache's last rows, rows of zeros, random prior cache contents; bitwise.
    Then timed alone (queued_ms) beside the plain write, with its bound.
    -> (worst difference, the kernel's row)."""
    import torch

    from jiao_liao_speech_recognition_torch.ops import quant

    randn = _card_randn(25)
    worst, cases = 0.0, []
    for B, H, T, dh, edges in DG_KV_CASES:
        k = (randn(B, H, 1, dh) * 2).to(torch.bfloat16)
        v = (randn(B, H, 1, dh) * 0.05).to(torch.bfloat16)
        k[1], v[2, 3] = 0, 0  # a row of zeros: scale 0, codes 0
        pos = torch.randint(0, T, (B,), device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(B))
        pos[:len(edges)] = torch.tensor(edges, device="cuda")
        base = {"k": torch.randint(-127, 128, (B, H, T, dh), dtype=torch.int8, device="cuda"),
                "v": torch.randint(-127, 128, (B, H, T, dh), dtype=torch.int8, device="cuda"),
                "k_scale": randn(B, H, T).abs(), "v_scale": randn(B, H, T).abs()}
        got, want = ({n: t.clone() for n, t in base.items()} for _ in range(2))
        with torch.inference_mode():
            quant.int8_kv_write(k, v, got, pos)
            quant.int8_kv_write_plain(k, v, want, pos)
            again = {n: t.clone() for n, t in base.items()}
            quant.int8_kv_write(k, v, again, pos)
        torch.cuda.synchronize()
        diff = max(float((got[n].float() - want[n].float()).abs().max()) for n in base)
        bitwise = all(torch.equal(got[n], want[n]) and torch.equal(again[n], got[n])
                      for n in base)
        worst = max(worst, diff)
        cases.append({"B": B, "H": H, "T": T, "dh": dh, "positions_edges": list(edges),
                      "bitwise_plain": bitwise, "max_abs_diff": diff})
        check(bitwise, f"jl_int8_kv_write differs from its plain version at {cases[-1]}")
        if len(cases) == 1:  # timed at large-v3's shape
            with torch.inference_mode():  # queued behind a spin kernel: a launch's few us
                ms = queued_ms(lambda: quant.int8_kv_write(k, v, got, pos), DG_KV_ITERS[0])
                plain_ms = queued_ms(lambda: quant.int8_kv_write_plain(k, v, want, pos),
                                     DG_KV_ITERS[1])
            nbytes = 2 * B * H * dh * 2 + B * 8 + 2 * B * H * (dh + 4)
            bound_ms, bound_by = bound(nbytes, {"f32": 2.0 * B * H * dh * 6})
            row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None, "shape": f"B={B}, {H} x {dh}, T={T}",
                   "bytes": nbytes}
    emit({"phase": "decode_graphs", "kernel": "KVW", "cases": cases, **row})
    return worst, {**row, "cases": cases}


def both_routes(fn, name: str, unit: str = "step") -> dict:
    """fn(graph) with graph=False, then graph=True, each after a reset of
    the step counter and the graph tally -> the two results bitwise equal
    (checked), each route's seconds and units (decode steps, or spec
    passes with unit="pass"; none for the CTC beam), and the captured
    call's capture seconds."""
    from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg
    from jiao_liao_speech_recognition_torch.utils import graphs

    runs = {}
    for graph in (False, True):
        wg.STEPS.reset()
        graphs.TALLY.reset()
        out, s = timed(lambda: fn(graph))
        n = wg.STEPS.passes if unit == "pass" else wg.STEPS.steps
        runs[graph] = (out, s, n, graphs.TALLY.capture_s, graphs.TALLY.replays)
    (a, a_s, a_n, _, _), (b, b_s, b_n, cap_s, replays) = runs[False], runs[True]
    units = {"step": "steps", "pass": "passes"}[unit]
    r = {"bitwise_eager": len(a) == len(b) and all(
            x.shape == y.shape and bool((x == y).all()) for x, y in zip(a, b)),
         "eager_s": a_s, "graph_s": b_s, "capture_s": cap_s, "replays": replays,
         f"eager_{units}": a_n, f"graph_{units}": b_n}
    if a_n and b_n:
        r.update({f"eager_ms_per_{unit}": 1e3 * a_s / a_n, f"graph_ms_per_{unit}": 1e3 * b_s / b_n,
                  f"graph_ms_per_{unit}_after_capture": 1e3 * (b_s - cap_s) / b_n})
    check(r["bitwise_eager"], f"decode_graphs {name}: the captured loop differs from eager: {r}")
    return r


def phase_decode_graphs(counters, card: str):
    """Phase 23, main path 23: the offline decode loops on captured graphs
    (utils/graphs.py) at full width, each against its eager self
    (graph=False) on the same inputs, bitwise: Whisper large-v3 greedy at
    B=16 x 30 s (random init, bf16 and quantize()d int8, one encoder
    output) over DG_EAGER_LEN, int8 also captured with the plain int8 write
    (the kernels a step it saves); the captured loops alone over
    WHISPER_MAX_LEN (the main path, exact launches by the captured
    accounting) with ms a step, tokens/s, the capture's seconds, kernels a
    replayed step and the replays' idle share; jl_int8_kv_write against
    its plain version, and timed; the Whisper AR beam at WHISPER_BEAM; the
    joint family's greedy and beam of JOINT_BEAM
    (configs/joint_ctc_attention.yaml, JOINT_B x 30 s); the device CTC
    beam (configs/ctc_batched_beam.yaml, CTC_BEAM_B x 30 s, beam
    CTC_BEAM_K) in f32 and f64. -> (launches, worst KVW difference, KVW's
    row)."""
    import torch

    from jiao_liao_speech_recognition_torch import api
    from jiao_liao_speech_recognition_torch.decode import ctc
    from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg
    from jiao_liao_speech_recognition_torch.decode.ctc import ctc_greedy_collapse
    from jiao_liao_speech_recognition_torch.decode.speculative import spec_greedy_from_enc
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch
    from jiao_liao_speech_recognition_torch.models import layers
    from jiao_liao_speech_recognition_torch.ops import quant

    t_phase = time.perf_counter()
    kv_err, kv_row = dg_kv_write_rows()
    bundle = api.load(config=whisper_config(), device="cuda")
    qb = bundle.quantize()
    w, fe = bundle.config.whisper, bundle.config.frontend
    prompt, eot = wg.resolve_specials(w)
    P, L, B = len(prompt), w.decoder_layers, WHISPER_B
    sup = dict(suppress_ids=w.suppress_ids, begin_suppress_ids=w.begin_suppress_ids)
    rng = np.random.RandomState(26)
    with torch.inference_mode():
        wav = torch.from_numpy((0.1 * rng.randn(B, 30 * SAMPLE_RATE)).astype(np.float32))
        enc = bundle.model.encode(featurize_batch(wav.cuda(), fe))
    models = {"bf16": bundle.model, "int8": qb.model}

    def greedy(model, n, graph):
        return wg.greedy_from_enc(model, enc, None, n, prompt, eot, graph=graph, **sup)

    # captured against eager (each captured graph kept for the sampled
    # step's comparison); int8 also captured with the plain write
    def keeping(outs, fn):
        """fn, its results appended to outs (both_routes runs the captured
        route last)."""
        def run(graph):
            outs.append(fn(graph))
            return outs[-1]
        return run

    greedy_caps, greedy_ids = {}, {}
    for name, model in models.items():
        outs = []
        with KeptGraphs() as kg:
            r = both_routes(keeping(outs, lambda g, model=model: greedy(model, DG_EAGER_LEN, g)),
                            f"greedy {name}")
        greedy_caps[name], greedy_ids[name] = kg.kept[0], outs[-1][0]
        del outs
        if name == "int8":
            with KeptGraphs() as kg:
                want = greedy(model, DG_EAGER_LEN, True)
                layers.int8_kv_write = quant.int8_kv_write_plain
                try:
                    got = greedy(model, DG_EAGER_LEN, True)
                finally:
                    layers.int8_kv_write = quant.int8_kv_write
            k_kern, k_plain = (graph_kernels(c) / wg.STOP_CHECK_EVERY for c in kg.kept)
            saved = k_plain - k_kern
            r.update(plain_write_bitwise=all(torch.equal(a, b) for a, b in zip(want, got)),
                     kernels_per_step_kernel_write=k_kern,
                     kernels_per_step_plain_write=k_plain,
                     plain_write_launches_per_self_attention=saved / L + 1)
            del kg
            check(r["plain_write_bitwise"] and saved > 0 and saved % L == 0,
                  f"decode_graphs int8: the capture with the plain write: {r}")
        emit({"phase": "decode_graphs", "greedy": name, "B": B, "max_len": DG_EAGER_LEN, **r})

    # temperature sampling, one seeded CUDA generator a call (registered with
    # the graph): the captured loop bitwise eager; a replayed sampled step
    # against a replayed greedy step of the same shape, interleaved
    def sampled(model, graph):
        gen = torch.Generator(device="cuda").manual_seed(DG_SAMPLE_SEED)
        return wg.greedy_from_enc(model, enc, None, DG_EAGER_LEN, prompt, eot,
                                  temperature=DG_SAMPLE_T, generator=gen, graph=graph, **sup)

    for name, model in models.items():
        outs = []
        with KeptGraphs() as kg:
            r = both_routes(keeping(outs, lambda g, model=model: sampled(model, g)),
                            f"sampled {name}")
        cap, g_cap, ids = kg.kept[0], greedy_caps.pop(name), outs[-1][0]
        del outs
        ms = {"sampled": [], "greedy": []}
        for _ in range(DG_TIMED_PAIRS):
            for key, c in (("sampled", cap), ("greedy", g_cap)):
                ms[key].append(cuda_ms(c.graph.replay, DG_TIMED_REPLAYS) / wg.STOP_CHECK_EVERY)
        r.update(replayed_ms_per_step=ms["sampled"], greedy_replayed_ms_per_step=ms["greedy"],
                 sampled_over_greedy=statistics.median(ms["sampled"])
                 / statistics.median(ms["greedy"]),
                 tokens_differing_from_greedy=int((ids != greedy_ids.pop(name)).sum()))
        del kg, cap, g_cap, ids
        emit({"phase": "decode_graphs", "sampled": name, "B": B, "max_len": DG_EAGER_LEN,
              "temperature": DG_SAMPLE_T, "seed": DG_SAMPLE_SEED, **r})
        check(r["tokens_differing_from_greedy"] > 0,
              f"decode_graphs sampled {name}: the draws gave greedy's tokens")

    # the main path: the captured loops alone over WHISPER_MAX_LEN
    kept = {}

    def main_path():
        for name, model in models.items():
            with KeptGraphs() as kg:
                wg.STEPS.reset()
                (ids, lens), s = timed(lambda: greedy(model, WHISPER_MAX_LEN, True))
            kept[name] = (kg.kept[-1], s, wg.STEPS.steps, ids, lens)

    _, launches = drive(counters, "decode_graphs", main_path)
    steps = {name: v[2] for name, v in kept.items()}
    want = {key: 0 for key in counters} | {
        "K9": 2 * L * steps["bf16"], "K9-int8": 2 * L * steps["int8"],
        "K10": 8 * L * steps["int8"], "K11": steps["int8"], "KVW": L * steps["int8"]}
    wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    check(not wrong, f"decode_graphs: launches (got, want): {wrong}")
    for name, (cap, s, n, ids, lens) in kept.items():
        r = {"steps": n, "call_s": s, "tokens_per_s": B * n / s, "launches": launches,
             "generated_incl_eot": int((lens + 1).clamp(max=ids.shape[1]).sum()),
             **replay_readings(cap, wg.STOP_CHECK_EVERY, f"decode_graphs {name}")}
        emit({"phase": "decode_graphs", "greedy_full": name, "B": B, "max_len": WHISPER_MAX_LEN,
              **r})
        check(tuple(ids.shape) == (B, WHISPER_MAX_LEN - P) and bool(
            ((ids >= 0) & (ids < w.vocab_size)).all()), f"decode_graphs {name}: ids out of range")
    del kept

    # the Whisper AR beam at phase_whisper_beam's shapes
    nb, K, max_len = WHISPER_BEAM
    wavs, _, _ = bundle._prepare_audio_chunked(make_requests()[3:3 + nb], None)
    with torch.inference_mode():
        enc_b = bundle.model.encode(featurize_batch(torch.from_numpy(wavs).cuda(), fe))
    r = both_routes(lambda g: wg.beam_from_enc(bundle.model, enc_b, None, K, max_len, prompt,
                                               eot, graph=g, **sup), "whisper beam")
    emit({"phase": "decode_graphs", "whisper_beam": {"rows": nb, "beam": K, "max_len": max_len},
          **r})
    del bundle, qb, models, enc, enc_b

    # the joint family: greedy and the beam of JOINT_BEAM
    joint = joint_bundle()
    with torch.inference_mode():
        jw, ja, _ = joint._prepare_audio_chunked(stream_audio(JOINT_B, seed=21, secs=30.0), None)
        enc_j, el = joint.model.encode(*joint._features(jw, ja))
    for name, fn in (("greedy", lambda g: wg.greedy_from_enc(joint.model, enc_j, el,
                                                             JOINT_MAX_LEN, (0,), 0, graph=g)),
                     ("beam", lambda g: wg.beam_from_enc(joint.model, enc_j, el, JOINT_BEAM,
                                                         JOINT_MAX_LEN, (0,), 0, graph=g))):
        r = both_routes(fn, f"joint {name}")
        emit({"phase": "decode_graphs", "joint": name, "config": JOINT_CONFIG, "rows": JOINT_B,
              "beam": JOINT_BEAM if name == "beam" else 1, "max_len": JOINT_MAX_LEN, **r})

    # spec_greedy over the CTC branch's draft: one captured pass a replay
    with torch.inference_mode():
        draft, dlens = ctc_greedy_collapse(joint.model.ctc_argmax_ids(enc_j), el, 0)

    def spec(graph):
        ids, lens, passes = spec_greedy_from_enc(joint.model, enc_j, el, draft, dlens,
                                                 max_len=JOINT_MAX_LEN, return_passes=True,
                                                 graph=graph)
        return ids, lens, torch.tensor(passes)

    r = both_routes(spec, "joint spec_greedy", unit="pass")
    emit({"phase": "decode_graphs", "joint": "spec_greedy", "config": JOINT_CONFIG,
          "rows": JOINT_B, "max_len": JOINT_MAX_LEN, "draft_tokens": int(dlens.sum()), **r})
    check(r["replays"] == r["graph_passes"] - 1 and r["eager_passes"] == r["graph_passes"],
          f"decode_graphs spec_greedy: a replay is not one pass: {r}")
    del joint, enc_j, el, draft, dlens

    # the device CTC beam, f32 and f64: seconds a batch both ways
    cb = ctc_beam_bundle()
    with torch.inference_mode():
        cw, ca, _ = cb._prepare_audio_chunked(stream_audio(CTC_BEAM_B, seed=31, secs=30.0), None)
        lp, olens = cb.model(*cb._features(cw, ca))
    for dt in (torch.float32, torch.float64):
        x = lp.to(dt)
        r = both_routes(lambda g: ctc.ctc_prefix_beam_search(
            x, olens, CTC_BEAM_K, 0, topk_tokens=min(CTC_BEAM_TOPK, 16), graph=g),
            f"ctc beam {dt}")
        emit({"phase": "decode_graphs", "ctc_beam": str(dt), "config": CTC_BEAM_CONFIG,
              "rows": CTC_BEAM_B, "beam": CTC_BEAM_K, "frames": int(olens.max()),
              "frames_per_replay": ctc.FRAMES_PER_REPLAY, **r})
    del cb, lp, x
    gc.collect()
    torch.cuda.empty_cache()  # the worker's process shares this card
    cold_capture_check()
    emit({"phase": "decode_graphs", "phase_s": time.perf_counter() - t_phase})
    return launches, kv_err, kv_row


def cold_models():
    """The fresh-process worker's models: the joint config's decoder
    (joint_bundle) and a quantize()d large-v3 cut to DG_COLD_LAYERS +
    DG_COLD_LAYERS blocks (phase 21's cut), each with its encoder width
    and frames -> {name: (model, d_model, encoder frames)}."""
    import torch

    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.models.bundle import ModelBundle
    from jiao_liao_speech_recognition_torch.models.layers import cast_for_serving
    from jiao_liao_speech_recognition_torch.models.whisper import WhisperModel

    joint = joint_bundle()
    cfg = whisper_config()
    w = cfg.whisper = dataclasses.replace(cfg.whisper, encoder_layers=DG_COLD_LAYERS,
                                          decoder_layers=DG_COLD_LAYERS)
    model = WhisperModel(w, device="cuda", seed=21)
    cast_for_serving(model, torch.bfloat16)
    qb = ModelBundle(cfg, model.eval(), CharTokenizer(
        [chr(0x4E00 + i) for i in range(w.vocab_size - 2)])).quantize()
    jc = joint.config.joint
    return {"joint": (joint.model, jc.d_model, 750),
            "large-v3 2+2 int8": (qb.model, w.d_model, WHISPER_T)}


def cold_capture_worker() -> int:
    """Phase 23's fresh process (`--cold-capture-worker`): the loops' first
    decode work on each model is a captured call under prompt=(), so no
    step, serving copy, position table or cuBLAS workspace of the decoder
    exists before it (the encoder output is drawn, not computed). Per
    model, two calls on new encoder outputs, each greedy and the beam of
    DG_COLD_BEAM captured first (greedy first on the joint model, the beam
    first on the int8 one), then with graph=False; every captured result
    must be bitwise its eager one. Prints one JSON line -> 0 when all are."""
    import torch

    from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg

    load_counters()  # the port beside this script on the path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    results = {}
    for m, (name, (model, d, frames)) in enumerate(cold_models().items()):
        eot = 0 if name == "joint" else wg.resolve_specials(model.cfg)[1]
        for call in range(2):
            gen = torch.Generator(device="cuda").manual_seed(100 * m + call)
            enc = torch.randn(DG_COLD_B, frames, d, device="cuda", generator=gen).to(
                getattr(torch, model.cfg.dtype))
            lens = torch.randint(1, frames + 1, (DG_COLD_B,), device="cuda", generator=gen,
                                 dtype=torch.int32) if name == "joint" else None
            loops = {"greedy": lambda g: wg.greedy_from_enc(model, enc, lens, DG_COLD_LEN, (),
                                                            eot, graph=g),
                     "beam": lambda g: wg.beam_from_enc(model, enc, lens, DG_COLD_BEAM,
                                                        DG_COLD_LEN, (), eot, graph=g)}
            order = ("greedy", "beam") if name == "joint" else ("beam", "greedy")
            captured = {k: loops[k](True) for k in order}
            for k in order:
                eager = loops[k](False)
                results[f"{name}/call {call}/{k}"] = all(
                    torch.equal(a, b) for a, b in zip(captured[k], eager))
    torch.cuda.synchronize()
    print(json.dumps({"cold_capture": results, "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if all(results.values()) else 1


def cold_capture_check() -> None:
    """Run cold_capture_worker in a process of its own; fail the run when it
    fails or a captured loop differs from its eager self."""
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    proc = subprocess.run([sys.executable, str(root / "chip_smoke.py"), "--cold-capture-worker"],
                          capture_output=True, text=True, timeout=DG_COLD_TIMEOUT_S, cwd=root)
    lines = [line for line in proc.stdout.splitlines() if line.startswith('{"cold_capture"')]
    check(proc.returncode == 0 and len(lines) == 1, f"the cold-capture worker exited "
          f"{proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    emit({"phase": "decode_graphs", **json.loads(lines[0]),
          "process_s": time.perf_counter() - t0})


def fl_flops(B, T, lens, H, dh) -> float:
    """The attention core's products (S and P.V) over each row's valid keys."""
    return 4.0 * H * dh * T * float(sum(min(int(n), T) for n in lens.tolist()))


def load_counters():
    """The launch counter of each kernel (KERNELS), the port imported from
    beside this script."""
    import importlib

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    return {key: getattr(importlib.import_module(f"{PKG}.{mod}"), attr)
            for key, _, mod, attr, _, _ in KERNELS}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke run has no CPU path", file=sys.stderr)
        return 2
    try:
        counters = load_counters()
    except ImportError as e:
        print(f"chip_smoke.py: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--multigpu-worker"]:
        return multigpu_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--cold-capture-worker"]:
        return cold_capture_worker()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_device()
    phase_build()
    errs = phase_kernels()
    errs.update(phase_flash())
    ctc_errs, ctc_rows = phase_ctc_loss()
    errs.update(ctc_errs)
    errs.update(phase_wf())
    errs.update(phase_whisper_kernels())
    by_path = {}
    by_path["serve"], bundle = phase_e2e(counters)
    with tempfile.TemporaryDirectory() as tmp:
        by_path["finetune"], ft_cfg, final, ft_losses = phase_finetune(counters, Path(tmp))
        by_path["multigpu"] = phase_multigpu(counters, Path(tmp), ft_cfg, ft_losses,
                                             by_path["finetune"], card)
        phase_finetune_vs_plain(ft_cfg)
        by_path["adapted_serve"], adapted = phase_adapted(counters, final)
        rec, greedy = phase_timing(bundle, adapted)
        phase_train_rate(ft_cfg)
    del bundle, adapted
    with tempfile.TemporaryDirectory() as tmp:
        by_path["prepare"], manifests = phase_prepare(counters, Path(tmp))
        by_path["transfer"], tr_cfg, tr_final = phase_transfer(counters, Path(tmp), manifests)
        phase_transfer_vs_plain(tr_cfg, tr_final)
        by_path["transfer_serve"], transferred = phase_transfer_serve(
            counters, tr_final, manifests, Path(tmp))
        phase_transfer_timing(tr_cfg, tr_final, transferred)
    del transferred
    by_path["whisper_serve"], whisper = phase_whisper(counters)
    with tempfile.TemporaryDirectory() as tmp:
        by_path["whisper_beam"] = phase_whisper_beam(counters, whisper, Path(tmp))
    rec.update(phase_whisper_timing(whisper))
    errs.update(phase_int8_kernels())
    int8_paths, qbundle = phase_whisper_int8(counters, whisper)
    by_path.update(int8_paths)
    phase_int8_timing(qbundle)
    with tempfile.TemporaryDirectory() as tmp:
        by_path.update(phase_engines(counters, whisper, qbundle, Path(tmp), card))
    del whisper, qbundle
    rec.update(phase_int8_kernel_timing())
    errs.update(phase_probe_kernels())
    by_path["probes"] = phase_probes(counters)
    rec.update(phase_probe_timing())
    with tempfile.TemporaryDirectory() as tmp:
        by_path["streaming"], stream_errs = phase_streaming(counters, Path(tmp), card)
    for key, err in stream_errs.items():
        errs[key] = max(errs[key], err)
    by_path["streaming_banded"] = phase_streaming_banded(counters, card)
    with tempfile.TemporaryDirectory() as tmp:
        joint_paths, joint_errs, joint_rows = phase_joint(counters, Path(tmp), card)
    by_path.update(joint_paths)
    for key, err in joint_errs.items():
        errs[key] = max(errs[key], err)
    with tempfile.TemporaryDirectory() as tmp:
        by_path.update(phase_ctc_beam(counters, Path(tmp), card))
    with tempfile.TemporaryDirectory() as tmp:
        train_paths, train_errs, train_rows = phase_joint_train(counters, Path(tmp), card)
    by_path.update(train_paths)
    for key, err in train_errs.items():
        errs[key] = max(errs[key], err)
    with tempfile.TemporaryDirectory() as tmp:
        ft_paths, ft_errs, ft_rows = phase_whisper_finetune(counters, Path(tmp), card)
    by_path.update(ft_paths)
    for key, err in ft_errs.items():
        errs[key] = max(errs[key], err)
    with tempfile.TemporaryDirectory() as tmp:
        by_path.update(phase_real_audio(counters, Path(tmp), greedy, card))
    by_path["tp"], tp_errs, tp_rows = phase_tp(counters, card)
    for key, err in tp_errs.items():
        errs[key] = max(errs.get(key, 0.0), err)
    by_path["tp_serve"], tps_errs, tps_rows = phase_tp_serving(counters, card)
    for key, err in tps_errs.items():
        errs[key] = max(errs.get(key, 0.0), err)
    by_path["tp_ctc"], tpc_errs, tpc_rows = phase_tp_ctc_joint(counters, card)
    for key, err in tpc_errs.items():
        errs[key] = max(errs.get(key, 0.0), err)
    by_path["decode_graphs"], errs["KVW"], rec["KVW"] = phase_decode_graphs(counters, card)
    rec.update(ctc_rows)
    rec["K10-row"] = tps_rows["K10-row"]
    rec["K11"] = {**rec["K11"], "tp_shapes": tps_rows["K11"]}
    rec["K9-int8"] = {**rec["K9-int8"], "tp_shapes": tps_rows["K9-int8"]}
    for key in ("K2-tp", "K3-tp", "row-partial"):
        rec[key] = {**tp_rows[key], "tp_ctc_shapes": tpc_rows[key]}
    rec["K5"] = {**rec["K5"], **tp_rows["K5"]}
    rec["K6"] = {**rec["K6"], "joint_shapes": [joint_rows["K6"], train_rows["K6"]],
                 "whisper_finetune_shapes": [ft_rows["K6"]]}
    rec["K8"] = {**rec["K8"], "joint_shapes": [train_rows["K8"]],
                 "whisper_finetune_shapes": [ft_rows["K8"]]}
    for key in ("K7-attn", "K7-mlp"):
        rec[key] = {**rec[key], "d1280_shapes": [ft_rows[key]]}
    rec["K9"] = {**rec["K9"], "joint_shapes": joint_rows["K9"], "tp_ctc_shapes": tpc_rows["K9"]}
    for key in ("K6", "K8"):
        rec[key]["tp_ctc_shapes"] = tpc_rows[key]
    table = []
    for key, name, _, _, src, replaces in KERNELS:
        table.append({"name": name, "route": "cuda", "source": f"{PKG}/{src}",
                      "replaces": replaces,
                      "launches": sum(launches[key] for launches in by_path.values()),
                      "launches_by_path": {p: launches[key] for p, launches in by_path.items()},
                      "max_abs_err": errs[key], **rec[key]})
    check(all(math.isfinite(r["ms"]) and math.isfinite(r["bound_ms"]) for r in table),
          "a timing is not finite")
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
