#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero with no
result line:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them.
2. build: every hand-written kernel, compiled by nvcc from csrc/ (one
   nvcc per source, all started together), with ptxas registers and
   spills per instantiation (K1, K4-K8 and K6's/K8's row-tile front
   must not spill, also when an earlier run built them: nvcc's output is
   kept beside each library); the SASS (cuobjdump) of the flash kernels,
   K1 (expert_tile_gemm), K4/K5 (runs_gemm, runs_gemm_s8), K6
   (dense_gemm), K7 (tiled_gemm, tiled_gemm_s8), K8 (stream_gemm) and the
   front (row_tiles) must run bf16, int8-on-bf16 K8 and K4-K7
   weight-only on HMMA.16816.F32.BF16, K4-K7 a8 on IMMA.16832.S8.S8 and
   float32 on FFMA, with no other MMA and no atomic; the front runs no
   MMA. K3's eight instantiations at the DFSMN width (D2, Dk) = (64, 64)
   must have a ptxas record, and no flash kernel may spill.
3. kernels against their plain PyTorch versions at the flagship widths
   (E=32, d=512, h=1024):
   K6's and K8's row-tile front (row_tiles, in each library) against its
   plain twin (ops/row_tiles.py) at 1, 63, 127, 511, 1020 and 2048 rows
   under every routing below: the same tile table and row order.
   K1 (float run-length, moe_runs_f): stacked L=18 at layers 0 and 17,
   fp32 and bf16, at 63/127/511/1020/1535 tokens (the 256/512/2048/
   6144-frame buckets and the 4x1000 request) under the four routings of
   K4-K6 below, and stacked L=2 at d=320, h=640
   (multiples of K1's 64-column block, d not of 128). fp32:
   allclose(rtol 1e-5, atol 1e-5); bf16: max|diff| within 1e-2 of
   max|ref|. Under the router's and the heavy routing fp32 K1 must equal
   K8 (moe_stream) bit for bit: both sum in ascending k.
   K4 (int8 run-length), K5 (int4 run-length) at 63, 511 and 1020
   tokens, K6 (int4 dense streamer) at 63 and 127, each weight-only and
   a8, random int weights stacked L=3 at layers 0 and 2, bf16
   activations, under a router's skewed routing, all tokens on one
   expert, half the experts empty, and 55% of the tokens on one expert
   (heavy); K6 also with gate -1 rows, which must come out 0; K5 also
   with 32-row int4 groups
   (a group ends inside its 64-deep slices) at 63 and 511 tokens; K4, K5
   and K6 also at d=320, h=640, where the two nibble halves of w2's
   packed columns meet inside one column block. Under the router's and
   the heavy routing at 63 tokens K5 a8 must equal K6 a8 bit for bit
   (the same quant_rows, s8 tiles, exact s32 sums and epilogue).
   Weight-only: max|diff| within 1e-2 of max|ref| (bf16 output and
   hidden, float32 sums in another order). a8: within 2e-2 (the integer
   sums are exact on both sides, but SiLU rounds differently in the two,
   which can move a hidden value to the next of its 127 levels).
   K2 (flash forward: out and LSE) and K3 (flash backward: dq2, dk2, dv)
   at B=4, T=S=255 and B=1, T=S=511, heads (H=8, Dk=64) and (H=4,
   Dk=128), fp32 and bf16, under mixed lengths (with a 7-frame and a
   zero-length row), a 16-frame static chunk window, and that window
   with mem_cols=4, at the wrapper's tile heights; then at B=4, T=255
   with the window, every tile height each kernel is built for (K2 16,
   32, 64 rows; K3 16, 32), where two K3 calls must give bit-identical
   gradients. Each output within FLASH_TOL of max|ref| (fp32 2e-6,
   float32 sums in another order; bf16 2e-2); the LSE on rows with a key
   to attend.
   K8 (dense float/int8 streamer) on fp32, bf16 and int8 weights (int8
   on bf16 activations) and K7 (tiled int4 grouped GEMM) weight-only and
   a8, at 63, 511 and 1020 tokens (K7's tile 64, 64, 128), under the
   router's routing, all tokens on one expert, half the experts empty,
   the heavy routing and (K8) rows padded with gate -1, which must
   come out 0; K7 stacked
   L=3 at layers 0 and 2, with upper_bound at layer 1, and at d=320,
   h=640, on bf16 activations, and weight-only on float32 activations
   at the same token counts under the router's and the heavy routing
   (with upper_bound at 511, d=320 at 63). fp32 within 1e-5 of
   max|ref| (float32 sums in another order), bf16, int8 and weight-only
   int4 within 1e-2, a8 within 2e-2. Under the router's and the heavy
   routing at 511 and 1020 tokens K7 a8 must equal K5 a8 bit for bit
   (the same quant_rows, s8 tiles, exact s32 sums and epilogue).
Depth: since phase 19 the flagship runs at 6 embed + 6 MoE blocks (its
YAML's 18 cut; 9 in phase 18), and since phase 18's serving loops at 6
+ 4 where the port's build makes the engines from the YAML on weights of
their own (phases 15 and 18); the DFSMN nets at 3 x 5 cFSMN layers (the reference Net's 3 x
10) and the dense conformer at 6 blocks (18; 9 before the loops), for
the script's 1200 s; widths, requests and checks are kept. Phase 17 keeps the DFSMN
nets' and the dense conformer's own depths. Counts below that name 18
MoE blocks (or 24 attention layers, 29 cFSMN MoE layers) scale with the
depth; the phases derive them from the config.

4. serve, float: the flagship hier MoE conformer (6 embed blocks, 6 MoE
   blocks, 32 experts, vocabulary 5000; random weights from a seeded
   CUDA generator, routers randomised) in an fp32 and a bf16 Engine
   (phases 4-7 run their engines eager: cuda_graphs=False) answers
   1x206, 4x1000 and 1x2048 frames. Each forward must launch K1 once per
   MoE block (18), and the logits must match the same engine
   with moe_impl="dense" on the valid region. fp32: allclose(1e-5,
   1e-3). bf16 rounding sends tokens at router near-ties to other
   experts, differently in the two runs; those flips and the
   free-running max|diff| and argmax agreement are printed. The dense
   run is repeated with its tokens sent to the kernel run's experts and
   must meet max|diff| / max|ref| <= 0.05 on every valid frame (its
   per-frame argmax agreement is printed); against the fp32 logits the
   kernel path's mean distance must be within 1.5x the dense path's and
   its argmax agreement within three standard errors of the dense
   path's. Hypotheses are CTC-greedy decoded.
5. serve, quantized: int8, w8a8, int4 and w4a8 Engines built from the
   same weights (int8 quantized once for int8 and w8a8, int4 once for
   int4 and w4a8) answer the same requests. Each forward must launch
   exactly: int4/w4a8 K6 18 times at 1x206 (63 tokens) and K5 18 times
   at 4x1000 and 1x2048 (1020 and 511 tokens); int8/w8a8 K4 18 times at
   the two long requests, and no kernel at 1x206, which takes the
   plain-PyTorch quant / quant_a8 stage. The logits must match the same
   engine with its experts on the kernels' plain versions, routing
   pinned to the kernel run's: max|diff| / max|ref| <= 0.05 on every
   valid frame. Each mode's distance and argmax agreement against the
   fp32 logits (the quantization error) are printed, not held. Each
   engine's median request latency, peak device memory and device time
   under torch.profiler are printed before it is freed.
6. serve, explicit expert stages: fp32, bf16 and int8 Engines with
   moe_impl="pallas" (K8) and int4 and w4a8 Engines with
   moe_impl="tiled" (K7) answer the three requests; each forward must
   launch its kernel once per MoE block (18) and no other expert kernel,
   and the logits must match the same engine with its experts on the
   kernels' plain versions, routing pinned: fp32 allclose(1e-5, 1e-3),
   the others max|diff| / max|ref| <= 0.05. The plain-PyTorch stages
   (fp32 tiled, ragged, ragged_padded, capacity; int8 quant_tiled,
   quant_capacity; w8a8 quant_a8_tiled) answer the 4x1000 request with
   no expert kernel, held the same way to the dense / quant / quant_a8
   engine. An int4 Engine with dense_quant and fuse_qkv answers 1x206,
   held within 0.05 of the int4 engine on the same weights dequantized
   (its distance from the unquantized dense weights' engine is
   printed). Each engine's latency, device time and peak memory are
   printed.
7. serve, flash: fp32 and bf16 Engines with attn_impl="flash" answer
   the same requests. Each forward must launch K2 once per attention
   layer (24) and K1 once per MoE block (18); the logits are held to
   phase 4's attn_impl="xla" engine with its tokens sent to the flash
   run's experts: fp32 allclose(1e-5, 1e-3), bf16 max|diff| / max|ref|
   <= 0.05 (and printed against the free-running fp32 logits).
8. serve, graphs: the auto fp32, bf16, int8, w8a8, int4 and w4a8
   Engines, fp32 and bf16 with attn_impl="flash", fp32 "pallas" (K8) and
   int4 "tiled" (K7) answer the same requests through the CUDA-graph path
   (Engine.get_fn: GRAPH_WARMUP_RUNS eager forwards on a side stream,
   then one captured). Each bucket must be captured (no stage of
   ops/moe.HOST_SYNC_STAGES on it), launch each kernel of phases 4-7's
   policy once per MoE block (K2 once per attention layer with flash) in
   every one of those forwards and in no replay, and give outputs
   bit-equal to the same engine's eager forward. Graph request latency
   (median of 5), device time and D2H time under torch.profiler, busy
   share, peak memory, and each graph's replay by CUDA events are printed,
   and the same eager for fp32 and bf16 (phases 4-7 time every mode's
   eager forward). The bf16 engine's argmax and topk (K=8) outputs at 4x1000
   are held to its logits reduced on the host in float64: argmax ids
   equal where the top two log-probs are not tied, best log-probs and
   top-K values within 1e-6, each index naming its value. The fp32
   engine's beam search (width 8) at 4x1000: its best hypothesis and
   score (1e-4 relative) equal to the host prefix beam search on the
   card's log-probs (bf16 logits hold exact ties, at which two searches
   keep different prefixes). The bytes each mode copies back, and the
   host's part of a logits copy-back, are printed. infer_long answers
   one 15000-frame request on the fp32 and int4 engines (out_len the
   subsampled length, finite logits, a second call equal to the first).
   K1's layout prep alone is captured and timed at the requests' token
   counts. The six auto engines' graph replays at 1x206, 1x2048 and the
   largest bucket (1x6144) are printed as the bucket tuner's points
   (m3asr_tpu_torch/runtime/bucket_tuner.py). Last, the fp32 engine's
   warmup() captures all 24 buckets: its seconds, launches and peak
   memory.
9. stream: the flagship's chunk streams (8 slots, chunk 16, two left
   chunks; 8 streams of 300-1200 frames, staggered, pushed in uneven
   pieces) on fp32 and bf16 engines (K1) and an int4 engine (K6), each
   mode's stage as the port's serve picks it. A StreamBatcher's chunk
   program is captured (K1/K6 launched 18 times in each of its 3
   forwards) and replayed tick by tick (no launch), its outputs bit-equal
   to the same program run eager (18 launches a tick); single-stream
   StreamingSessions run the same audio through their own graphs, and
   for four streams also eager, bit-equal chunk for chunk. Held, with the
   eager session's experts pinned to the batched run's (GateRecorder):
   batched against single, fp32 allclose(1e-5, 1e-3), bf16 and int4
   max|diff| / max|ref| <= 0.05; then, on the causal flagship
   (causal=True in both encoders), the batched streams against
   moe_conformer.forward with chunk_attention_mask, experts pinned to the
   streams', on every full chunk's frames, at the same tolerances. The
   frames whose experts differ when free-running are printed. A
   loopback m3asr_tpu_torch.serve (--warmup, port 0) on a bf16 engine
   answers a greedy and a beam request (two hotword phrases, a seeded
   ARPA bigram LM) and two concurrent beam streams; every response must
   equal the engine and the host decode called directly (the native C++
   decoder, which must have built). Two threads call infer and
   infer_long on that engine, each result equal to the serial one.
   Printed: the median tick and a stream's chunk latency, graph and
   eager; a tick's device time and busy share; each graph's pool; K1
   and K6 alone at 16 and 128 tokens.
10. recognize: the port's recognizer (m3asr_tpu_torch.recognize.main, in
   process) on the flagship read from configs/3m_asr_18l32e.yaml with
   three random AED decoders at its width (6 blocks, 8 heads, 2048
   units; aed.init from a seeded CUDA generator), from a bf16 engine dir
   saved by the port's build path with decoders.npz (checkpoint.
   save_decoders). Inputs written by the port's ArkWriter: a Kaldi ark
   of 8 utterances of 206-7000 frames (the 7000 past the top bucket, so
   infer_long), an int-vector label ark, CMVN stats and a wav scp of two
   seeded 16 kHz signals. The native decoder and ark reader must build
   first (timed apart). Modes: -d greedy, -d beam -b 10, -d rescore
   --hier_rescore, -d attention (the 7 utterances within the top
   bucket), --raw_wav -d greedy. Each mode's engine must capture every
   bucket it uses on K1 (18 launches a forward, 3 forwards a capture, no
   other kernel, no replay launch), and its transcripts must equal the
   port's functions called directly on the same engine and inputs
   (Engine.infer / infer_long, the native searches, then
   hier_attention_rescoring or attention_search_decode). The decoders
   on the card against the CPU in float32: score_hyps of each decoder on
   the 640-frame utterance's taps and n-best within allclose(1e-5,
   1e-3), the hier best hypothesis the same unless its top two totals
   are within 1e-3; attention_search_decode's best hypothesis equal on
   the 206- and 640-frame utterances. Printed per mode: wall seconds,
   RTF, the split into loader, engine, host search, AED (ms a decode
   step) and memory copies; the AED's device time under torch.profiler
   for one hier rescoring and one attention step; peak memory.
11. train: the flagship's CTC training step (make_train_step, Adam with
   warmup_noam, embed CTC weight 0.3 so that every attention layer
   trains) on 4 x 1000 frames with seeded targets. One fp32 gradient
   with attn_impl="flash" and one with "xla", routing pinned: losses
   within 1e-5 relative, gradients within TRAIN_GRAD_TOL of each
   parameter group's max|g|. Four flash steps (24 K2 and 24 launches of
   each K3 kernel per step, asserted; losses finite), two xla steps, one
   bf16-compute flash step (its loss within 2e-2 of the fp32 loss); step
   times, the busy share of one step under torch.profiler, peak memory.
   TF32 is switched on before each fp32 step is built, and
   make_train_step must switch it off again (cuBLAS and cuDNN); cuDNN's
   is switched on again before the steps, which must switch it off.
12. times: each kernel per call (CUDA events over many calls after
   warm-up, layers rotated so weights come from device memory) and its
   launches alone, at the main path's token counts (K1 at 63, 511 and
   1020 with its column block and each launch's live blocks; K6 at 63
   and 127 and K8 at 63, 511 and 1020 under the router's and the heavy
   routing, K7 at 63, 511 and 1020 under the router's (float32
   weight-only too), each beside its yardstick's launches alone on the
   same tokens: K5 for K6 and K7, K1 for K8; K2/K3 at both long
   requests' attention
   shapes, with each launch's tile rows and blocks),
   beside its bound, the plain version's time and, for K2/K3,
   scaled_dot_product_attention's; the float engines' request latency,
   peak device memory and device time of one request under
   torch.profiler with the kernels that took most of it and K1's part.
   Every device-time line names the expert kernels' (K1, K4-K8, the
   front) summed time in the request.

13. DFSMN (after phase 10; its kernel checks beside phase 3's, its
   times after phase 12's): K1's and K4-K7's ReLU instantiations (the
   hidden clamped at 1.0) against their plain versions at the DFSMN
   widths (E=32, d=512, h=1024, unstacked weights, no b2): K1 fp32/bf16
   at 512, 2048, 4096 and 24576 tokens, K4/K5 weight-only and a8 at 512
   and 4096, K6 at 63 and 127, K7 at 511, under the router's, one
   expert's, half-empty and heavy routing, phase 3's tolerances; K5 a8
   equal to K6 a8 and K7 a8 bit for bit. K2 through flash_attn_mem (q (B,
   8, T, 64), 64 memory slots prepended to k/v, lengths + 64) at B=1,
   T=2048 and 6144 and B=4, T=1000, fp32 and bf16, mixed lengths and a
   16-frame chunk window: FLASH_TOL against its plain version and
   against the plain memory-slot attention. Then the MoE DFSMN
   (dfsmn_san_fmoe_localComm_catEmbed at the reference Net's widths: 3 x
   10 cFSMN, hidden 1024, memory 512, 8 heads, 64 slots, an embed
   sub-net of the same, 32 experts, input 40, vocabulary 5000, seeded
   random weights and routers) built by the port's build in fp32, bf16,
   bf16 --attn_impl flash, int8, int4 (through an engine dir) and w4a8,
   and w8a8, int4 tiled and w4a8 tiled engines on the quantized trees,
   answers 1x512, 4x1000 and 1x6144 frames (int4/w4a8 also 1x100 in a
   1x128 bucket, K6; the tiled engines 1x512) through CUDA graphs: each
   capture launches its kernel 29 times a forward (K2 6 times with
   flash), a replay none, the graph equals its eager forward bit for
   bit, and the eager logits are held to the same engine on the kernels'
   plain versions with routing pinned (fp32 allclose(1e-5, 1e-3), else
   0.05 of max|ref|); flash is held to the bf16 xla engine with the
   flash run's experts; dfsmn_san_res serves 1x512 in fp32 with flash,
   held to its xla twin. Latency, device time, busy share and peak
   memory per request, K1's and K2's share of 1x6144's device time, and
   a bf16 engine's 24-bucket warm-up (seconds, peak memory, the graph
   pool). Each ReLU instantiation and flash_attn_mem is timed beside
   its bound, its plain version and (flash_attn_mem) SDPA on the same
   masked problem.

14. streams and the dense conformer (after phase 13; its kernel checks
   are phase 13's at 16 and 128 tokens, a stream's chunk and a tick):
   the MoE DFSMN of phase 13 (the port's build, fp32; bf16, int8, int4
   and w4a8 engines on its tree) and dfsmn_san_res (fp32, bf16) stream 8
   staggered streams through a DfsmnStreamBatcher (8 slots x chunk 16,
   cache_T 256; the expert stage serve picks: K1, plain quant, K6): in
   fp32 streams of 10-52 s (one past the 5000-row positional table, 329
   ticks), in the other modes of 5.0-9.6 s (71 ticks). The capture launches
   its kernel 29 times a forward, a replay none, and every tick equals the
   same program eager bit for bit; ticks 12-15 (every stream past the
   delay), from the eager run's state, are held to the kernel's plain
   version with routing pinned; single sessions (pushed in
   uneven pieces, finished) through their graphs equal, pinned to the
   batched run's experts, the batched streams after the delay (fp32: also
   free-running, the long stream too, and graph == eager bit for bit); a
   causal copy (look_ahead=0) of one stream's first 400 frames equals the
   offline forward under the chunk mask of its window, experts pinned. A
   loopback server streams two greedy DFSMN streams (bf16) and two beam
   dense conformer streams,
   each answer equal to the server's pool sessions driven directly. The
   dense conformer proto at the flagship encoder's widths (18 blocks)
   built in fp32, with bf16 and bf16 flash engines, answers 1x206, 4x1000
   and 1x2048 through graphs (graph == eager bit for bit; flash launches
   K2 18 times a forward and is held to xla within 0.05), and each other
   front end (conv2d6, conv2d8, linear, abs_pos, no_pos, the LayerNorm
   after the input layer) one 1x1000 request at 2 blocks. Printed: tick
   and chunk latency (graph, eager), a tick's device time and busy share,
   pools, request latency and device time. A batcher captured over the
   DFSMN positional table's first 5000 rows replays bit-equal after an
   offline 1x6144 request grew the table.

15. ExMarc, top-2 and exported programs (after phase 14): the ExMarc
   flagship (conformer_fmoeExMarc_localComm_catEmbed: the flagship YAML
   with the ExMarc proto, 6 embed + 4 MoE blocks: the YAML's 18 cut for
   the script's time since phase 18; d=512, 32 experts of hidden 1024 at
   both FFN positions, V=5000) built by the port's build
   (seeded random weights, both positions' routers redrawn normal x 0.5)
   serves 1x206, 4x1000 and 1x2048 in fp32, bf16, int8, w8a8, int4, w4a8
   and bf16 flash through CUDA graphs: each capture launches its stage's
   kernel twice a MoE block a forward (18; K2 15 times more with
   flash; none for the int8/w8a8 buckets of <= 128 tokens, which run the
   plain quant stage), a replay none; graph == eager bit for bit; the
   eager logits held to the kernels' plain versions with both positions'
   routing pinned (fp32 allclose(1e-5, 1e-3), else 0.05 of max|ref|);
   latency, device time and busy share beside phase 8's flagship.
   moe_ffn(top_k=2) at the flagship widths (1020 tokens) through K1, two
   launches, held to its plain version (fp32 1e-5, bf16 1e-2 of
   max|ref|). The custom operators' eager dispatch cost (one K1 call
   through m3asr::moe_runs_f against its CUDA implementation called
   directly). The flagship as bf16 and int4 engine dirs with exported
   programs over the three requests' buckets: export seconds per bucket,
   a fresh Engine.load runs every bucket from its program (launches
   counted at the capture from it, none at replay), answers bit-equal to
   the tracing engine's graphs, load-and-capture seconds beside that
   engine's warm-up. The exported flagship's depth is cut to 1 embed + 1
   MoE block: the export traces every operator on the host (31-41 s a
   bucket at 2 + 6 blocks on the card's host).

16. the training CLI (after phase 11): ``m3asr_tpu_torch.train.cli.main``
   in process on the flagship YAML (32 experts, d=512, V=5000, its
   collate_conf; batch 4, log_period 1, save_period 4 = an epoch,
   attn_impl flash, accum_steps 2, device SpecAugment) with the hier
   recipe (three AED decoders of 6 blocks) and the domain/accent heads,
   fp32, on a Kaldi ark of 16 utterances of 300-1000 frames with CTC,
   AED, domain and accent arks, and 4 validation utterances. The CLI's
   depth is cut to 6 embed + 2 MoE blocks: the checkpoints are written
   under TMPDIR, and the whole script keeps its disk writes under 45 GiB
   (at 18 MoE blocks a checkpoint is 9-18 GiB and the two runs write
   90-99 GiB; at 2, 24-27 GiB). Run 1 (max_epoch 1): 4 steps of 2 microbatches with
   finite losses, K2 launched 72 times (8 in each of 8 microbatch
   forwards and the validation forward) and each K3 kernel 64 (8 in each
   backward: the heads train the embed encoder), checkpoint_last,
   checkpoint_best, scalars.jsonl and an event file written. Run 2
   (--resume, max_epoch 2): starts at global step 4 from parameters equal
   bit for bit to run 1's checkpoint_last.pkl, the same launches, 4 more
   steps, checkpoint_final written. The GiB of checkpoints the runs wrote
   are printed.
   Then, on one hier batch of 4 x 1000 frames at the flagship's widths and
   depth (6 + 18 blocks):
   (i) the fp32 flash hier gradient against xla, routing pinned (loss
   within 1e-5 relative, every group within TRAIN_GRAD_TOL of its
   max|g|, the decoders' and heads' groups included); (ii) accum_steps=2
   against 1 (xla, routing pinned), the same bounds; (iii) the CTC
   step's gradient with remat against without (flash), the same bounds,
   remat's peak memory below plain's and K2 launched 42 times (the 18
   MoE blocks twice); (iv) the bf16-compute hier loss within 2e-2 of
   fp32's. Printed: step times and frames/s, checkpoint seconds and
   sizes, one hier step's device time and busy share, peak memory.

17. DFSMN and dense conformer training (after phase 16):
   (a) K3 at the DFSMN width (D2, Dk) = (64, 64) on the memory-slot
   layout (64 slots prepended, key lengths + 64) at B=1, T=2048 and 6144
   and B=4, T=1000 with mixed lengths, with and without the 16-frame chunk
   window (shifted by 64, mem_cols=64), fp32 and bf16, from K2's LSE: dq,
   dk, dv against the plain version on the valid rows within FLASH_TOL x
   sqrt(S / 512) past 512 keys in fp32 (FLASH_TOL in bf16), two calls
   bit-equal. (b) The DFSMN-MoE CTC step at the reference Net's widths
   and depth (phase 13's model) on 4 x 1000 frames, embed CTC weight 0.3:
   fp32 flash against xla with routing pinned (loss within 1e-5
   relative, every cFSMN / attention layer's gradients within
   TRAIN_GRAD_TOL of its max|g|), K2 and each K3 kernel launched once per
   attention layer (3 + 3); the bf16-compute flash gradient (routing
   pinned) finite, its loss within 2e-2 of fp32's; a CE step (alignment
   labels, no embed CTC: K3 only in the main net's 3 layers) held the same
   way; three Adam steps timed, one profiled, peak memory. (c)
   dfsmn_san_res_embed_domain_acc (same widths) with its in-model heads:
   flash against xla, the heads' leaves with non-zero gradients. (d) The
   dense conformer (the flagship encoder's widths, 18 blocks) with dynamic
   chunks (a seed drawing a chunk shorter than the utterance): flash
   against xla, 18 launches each. (e) The training CLI on the DFSMN-MoE
   cut to 1 x 4 cFSMN in the main net and the embed sub-net (widths kept:
   at 3 x 10 a checkpoint with Adam moments is about 12 GiB, and the
   script keeps its disk writes under 45 GiB), CE mode on alignment arks,
   batch 4, flash, checkpoints under TMPDIR: a run of 2 steps and its
   --resume (parameters loaded bit-equal to checkpoint_last.pkl); a
   --bmuf --sync_period 2 run of 4 steps, each sync's replicas equal to
   the block-momentum update recomputed on the host (1e-6 of max|global|)
   and the checkpoint's bmuf entry; a --smbr_cmd run on the dense
   conformer (18 blocks, SGD) with a lattice command that is a Python
   script writing the gradient of sum_t [logsumexp(l_t) - l_t[t % V]]:
   smbr_epoch0.pkl equal to autograd's update of that loss within 1e-4 of
   each leaf's largest value. The launches of K2 and K3 at (64, 64) (the
   kernels line's flash_attn_mem and flash_attn_mem_bwd rows) and of the
   dense conformer's K2/K3 are counted; K3 (64, 64) is timed at the
   training batch and both long requests beside its plain version, SDPA's
   backward and its bound.

18. parallel: expert- and tensor-parallel serving on gloo ranks sharing
   the card. The flagship (d=512, 32 experts of hidden 1024, V=5000;
   seeded random weights and routers) at 6 embed + 4 MoE blocks (its 18
   cut for the script's time) is built by
   the port's build (``build_engine`` + ``Engine.save(shards=(ep,
   tp))``, what ``build --ep/--tp`` runs) as engine dirs: fp32 at ep=4,
   tp=4 and (ep=2, tp=2), bf16 flash at ep=4, int8 at (ep=2, tp=2), int4
   at ep=4 and at tp=2 (w1 repacked, ``w1_q4c``). Two worlds run them,
   ``python -m torch.distributed.run --standalone`` with 4 and 2 ranks of
   this script (``--parallel-rank``): each rank loads the dir (its
   shard) on cuda:0 and answers 1x206 and 4x1000 eagerly, the requests
   also timed (host median of 3), one under torch.profiler on rank 0
   (the host-side all-reduces' share of it) and its peak memory read. Every rank's
   outputs must be bit-identical to rank 0's; rank 0's logits must match
   the unsharded engine of the same mode on the card: fp32 allclose(1e-5,
   1e-3) free-running, bf16 / int8 / int4 within 0.05 of max|ref| with
   the routing pinned to rank 0's (its experts' stages on their plain
   versions); the bf16 flash ranks must launch K2 once per attention
   layer a forward (6 + 4). A rank's non-zero exit or a world's timeout
   fails the phase; the engine dirs are deleted as it goes. Then, in the
   4-rank world, the serving loops: each rank calls ``recognize.main``
   (greedy, then beam 10) on an fp32 flash ep=4 dir of the fp32 mode's
   weights (buckets 256, 1024, 2048 at batch 1 and 4) over phase 10's
   utterances of 206, 1000, 1500, 2048 and 7000 frames (the last through
   ``infer_long``), rank 0 leading and the others following; then the
   server's runtime on the fp32 ep2 x tp2 dir (``serve._build_runtime``
   on every rank, rank 0 behind a loopback listener, the others in
   ``serve.follow_runtime``), two client threads at once each sending a
   stream of 8 chunks (chunk 16, left 2; greedy) and two offline
   requests (206-1500 frames: greedy, beam n-best, timestamps and
   confidence, one past the largest bucket), then one more request
   profiled on rank 0. Held: rank 0's transcripts equal, id for id, the
   unsharded engine's recognizer on the same weights and settings; rank
   0 led as many forwards as the bucket arithmetic gives, and every rank
   launched K2 exactly (embed + MoE blocks) times each (counts set to 0
   before each run); every follower ran rank 0's calls and returned on
   STOP; every answer equals a one-process server's on the unsharded
   dir; every rank's stream caches hold H/tp heads. Printed: the RTF on
   ranks and in one process, offline latency, chunk round trips, the
   all-reduces' and the control broadcasts' share of a request. The
   times are of gloo ranks on one card (all-reduces through host
   memory), not an NCCL deployment's. Before the loops, sharded export:
   while the 2-rank world runs, this process builds two fp32 dirs at the
   flagship's widths cut to 1 + 1 blocks (bucket 1x256) as ``build
   --export`` does, ``--ep 4`` with flash and ``--ep 2 --tp 2``, every
   rank's program traced here; in the 4-rank world each rank loads its
   program and the dir's twin without ``exported/`` and answers 1x206
   through both. Held: the loaded program ran (``loaded_buckets``) and
   answered bit for bit as the twin on every rank, every rank the same;
   rank 0 against the unsharded engine (fp32 allclose); K2 exactly (1 +
   1) launches a forward from the ep=4 programs; one greedy
   ``recognize.main`` on the ep=4 programs through the loops, id for id
   as one process on the unsharded dir. Printed: export seconds a
   program, load-and-first-call seconds a rank (loaded and traced), the
   eager request's ms (loaded and traced).

19. train_parallel: parallel training on phase 18's gloo ranks (its two
   worlds, after their serving cases; ``--only train_parallel`` starts
   them for this phase alone). First, in this process, K2 and K3 against
   their plain versions at the sp shape (a rank's 125 query rows against
   250 keys, fp32 and bf16, with and without an offset chunk window) and
   their device times beside the plain versions'. Then the flagship's
   widths at 6 embed + 2 MoE blocks (seeded weights, routers normal x
   0.5) on TRAIN_LENS: rank 0 takes the unsharded step's loss and
   gradients (fp32 flash, fp32 xla, bf16 flash; BMUF's replica on its own
   rows) and every rank the routing it chose. 4 ranks: dp2 x ep2 flash,
   dp2 x tp2 xla, dp2 x sp2 flash, dp2 x ep2 ZeRO-1, dp4 FSDP, pp2 x dp2
   flash (2 microbatches), BMUF dp4 (a sync after step 2); 2 ranks: ep2
   bf16 flash, the CLI (``train.cli.main`` with ``--ep 2``: 2 steps, a
   final checkpoint read back whole and deleted) and
   ``dryrun_multichip(2)``. Each step case's first step, routing pinned
   to the unsharded step's: the loss within rtol 1e-5 (bf16 0.05), every
   gathered gradient group within TRAIN_GRAD_TOL of its max|g| (bf16
   0.05), and every rank holding a block of a leaf holding the same bits
   after the update (BMUF: every leaf after the sync); K2 and each K3
   kernel launched once per attention layer a pass on every flash rank
   (6 + 2, pp's stage included), exactly. The step times (host, the
   steps after the first), the all-reduces' share of a step (rank 0,
   torch.profiler) and each rank's peak memory are printed, as gloo
   ranks sharing one card, not an NCCL deployment's.

``python3 chip_smoke.py --only NAME [NAME ...]`` runs the build and the
phases named in ``ALONE`` alone, for work on one of them; it prints no
result line and exits 1. Two of them are not in the default run:
``hier_witness`` (phase 16's check (ii) at 6 + 4 blocks against the same
gradients in float64 on the plain path: the split in float64, each
float32 run and each microbatch alone against float64) and
``dfsmn_witness`` (phase 17's DFSMN-MoE CE check at 3 x 5 layers: fp32
flash and fp32 xla against float64 xla).

The line before the last is one JSON object describing each kernel
(route, source, launches on the main path, error, times, bound); the
last line is {"ok": true, "device": {...}}.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
# Depth cuts for the script's 1200 s (since phase 18; widths kept): the
# flagship's 18 MoE blocks (configs/3m_asr_18l32e.yaml) run as 6 (9
# before phase 19 was added) and, where the port's build makes the
# engines from the YAML on weights of their own (phases 15 and 18), as 4
# since phase 18's serving loops; the DFSMN nets' 3 x 10 cFSMN layers as 3 x 5 and the
# dense conformer's 18 blocks as 6 (9 before the loops), except in phase
# 17: its flash-vs-xla gradient checks run at the models' own depths (at
# 3 x 5 the DFSMN CE check read 1.851e-3 of a group's max|g|, past
# TRAIN_GRAD_TOL, where 3 x 10 reads 6.3e-4: the flash formulation's
# float32 rounding, dfsmn_witness). Phase 16's checks keep the 6 of
# flagship_cfg: at 4 its check (ii) reads 1.921e-2 of a decoder group's
# max|g| on the H100, where 6 reads 9.3e-5 (float32 rounding of a cuDNN
# convolution at batch 2; the split is exact in float64, hier_witness)
FLAGSHIP_MOE_BLOCKS = 6
BUILT_MOE_BLOCKS = 4
DFSMN_EACH_BLOCK, DFSMN_NET_EACH = 5, 10
DC_BLOCKS, DC_NET_BLOCKS = 6, 18
PEAK_OPS_PER_S = {"float32": 67e12,  # fp32 outside the tensor cores
                  "bfloat16": 989e12, "int8": 1979e12}
E, D, H, L = 32, 512, 1024, 18
TOKENS = (63, 127, 511, 1020, 1535)
REQUESTS = ((1, 206), (4, 1000), (1, 2048))
KINDS = ("router", "one_expert", "half_empty")
# (kernel, a8) -> the name of that kernel variant in the output
QUANT_NAMES = {("K4", False): "moe_runs_q8[int8]",
               ("K4", True): "moe_runs_q8[w8a8]",
               ("K5", False): "moe_runs_q4[int4]",
               ("K5", True): "moe_runs_q4[w4a8]",
               ("K6", False): "moe_q4_dense[int4]",
               ("K6", True): "moe_q4_dense[w4a8]"}
MODES = {("int8", False): "int8", ("int8", True): "w8a8",
         ("int4", False): "int4", ("int4", True): "w4a8"}
# engine dtype -> the kernel each request's forward launches once per
# MoE block (None: the plain-PyTorch quant stage, no kernel)
QUANT_EXPECT = {"int8": (None, "K4", "K4"), "int4": ("K6", "K5", "K5")}
# K2/K3 against their plain versions: max|diff| / max|ref| per output
# (FMA kernels: at most 6.5e-7 in float32; MMA kernels 6.8e-3 in bf16)
FLASH_TOL = {"float32": 2e-6, "bfloat16": 2e-2}


def log(*a):
    print(*a, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("FAIL device: torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi


def phase_build(kernels):
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels.ALL)) as ex:
        for lib, _ in zip(kernels.ALL, ex.map(lambda k: k.load(),
                                              kernels.ALL)):
            # ptxas -v: per entry function, its name with the template
            # arguments (demangled by c++filt where the host has it), then
            # its spills, then its registers and shared memory
            mangled = [ln.split("'")[1] for ln in lib.log.splitlines()
                       if "Compiling entry function" in ln]
            names = iter(demangle(mangled))
            ptxas = []
            for ln in lib.log.splitlines():
                if "Compiling entry function" in ln:
                    ptxas.append(short_name(next(names)))
                elif not ptxas:
                    continue
                elif "spill stores" in ln and not ln.strip().startswith(
                        "0 bytes stack frame, 0 bytes spill"):
                    ptxas[-1] += " SPILLS " + ln.strip()
                elif "registers" in ln:
                    ptxas[-1] += ": " + ln.split(":", 1)[1].strip()
            if lib.build_seconds is None:     # built by an earlier run
                log(f"build {lib.source}: already in {kernels.BUILD_DIR}; "
                    "ptxas: " + " | ".join(ptxas))
            else:
                log(f"build {lib.source}: {lib.build_seconds:.2f} s, "
                    f"{' '.join(lib.command[:4])} ...; ptxas: "
                    + " | ".join(ptxas))
            for kern in BUILD_GATES.get(lib.source, ()):
                found = [ln for ln in ptxas if expert_kernel(ln) == kern]
                if not found:
                    raise SystemExit(f"FAIL build: no ptxas record of {kern}")
                spilled = [ln for ln in found if "SPILLS" in ln]
                if spilled:
                    raise SystemExit(f"FAIL build: {kern} spills: "
                                     + " | ".join(spilled))
            if lib.source == "flash_attention.cu":
                missing = [k for k in FLASH_MEM_BWD_KERNELS
                           if not any(ln.startswith(k + ":") for ln in ptxas)]
                spilled = [ln for ln in ptxas if "SPILLS" in ln]
                if missing or spilled:
                    raise SystemExit(f"FAIL build: flash kernels without a "
                                     f"ptxas record {missing}; spilling "
                                     + " | ".join(spilled))
    log(f"build: all kernels in {time.perf_counter() - t0:.2f} s")
    kernel_sass(kernels)


def demangle(names):
    """C++ names demangled by c++filt where the host has it."""
    if not names or not shutil.which("c++filt"):
        return list(names)
    return subprocess.run(["c++filt"], input="\n".join(names),
                          capture_output=True, text=True,
                          check=True).stdout.splitlines()


def expert_kernel(name):
    """Which expert kernel an instantiation's or a device event's name
    belongs to: "K1" (moe_runs.cu's expert_tile_gemm), "K4/K5"
    (runs_gemm), "K4/K5 a8" (runs_gemm_s8), "K6" / "K6 a8" (moe_q4.cu's
    dense_gemm weight-only / a8), "K7" / "K7 a8" (moe_q4_tiled.cu's
    tiled_gemm / tiled_gemm_s8), "K8" (moe_stream.cu's stream_gemm),
    "front" (row_tiles, K6's and K8's row-tile front), or None."""
    if "runs_gemm_s8" in name:
        return "K4/K5 a8"
    if "runs_gemm" in name:
        return "K4/K5"
    if "tiled_gemm_s8" in name:
        return "K7 a8"
    if "tiled_gemm" in name:
        return "K7"
    if "expert_tile_gemm" in name:
        return "K1"
    if "dense_gemm" in name:
        # a8 is the first template argument (mangled: ILb1E)
        a8 = re.search(r"dense_gemm(?:[<\[]true|ILb1E)", name)
        return "K6 a8" if a8 else "K6"
    if "stream_gemm" in name:
        return "K8"
    return "front" if "row_tiles" in name else None


KERNEL_NAMES = {"K1": "expert_tile_gemm", "K4/K5": "runs_gemm",
                "K4/K5 a8": "runs_gemm_s8", "K6": "dense_gemm",
                "K6 a8": "dense_gemm a8", "K7": "tiled_gemm",
                "K7 a8": "tiled_gemm_s8", "K8": "stream_gemm",
                "front": "row_tiles"}
# K3's instantiations at the DFSMN width, which must have a ptxas record
# (no flash kernel may spill)
FLASH_MEM_BWD_KERNELS = tuple(
    f"{kern}<{t}, 64, 64, {rows}>"
    for kern in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    for t in ("float", "__nv_bfloat16") for rows in (16, 32))
# per library, the kernels that must have a ptxas record and no spill
BUILD_GATES = {"moe_runs.cu": ("K1", "K4/K5", "K4/K5 a8"),
               "moe_q4.cu": ("K6", "K6 a8", "front"),
               "moe_q4_tiled.cu": ("K7", "K7 a8"),
               "moe_stream.cu": ("K8", "front")}


def sass_want(short):
    """The instruction a kernel instantiation must run: K4-K7 a8
    IMMA.16832.S8.S8, K4/K5 and K6 weight-only and every bf16 one
    (K1, K7, K8, flash) HMMA.16816.F32.BF16, float32 FFMA (no TF32 MMA);
    the row-tile front none (it must run no MMA either)."""
    kern = expert_kernel(short)
    if kern in ("K4/K5 a8", "K6 a8", "K7 a8"):
        return "IMMA.16832.S8.S8"
    if kern in ("K4/K5", "K6") or "bfloat16" in short:
        return "HMMA.16816.F32.BF16"
    return None if kern == "front" else "FFMA"


def kernel_sass(kernels):
    """The arithmetic instructions of every tensor-core kernel's
    instantiations, from cuobjdump -sass of the built libraries: each
    flash kernel, K1 (moe_runs.cu's expert_tile_gemm), K4/K5 (runs_gemm,
    runs_gemm_s8), K6 (moe_q4.cu's dense_gemm), K7 (moe_q4_tiled.cu's
    tiled_gemm, tiled_gemm_s8), K8 (moe_stream.cu's stream_gemm) and
    their row-tile front. Each must run on its sass_want
    instruction (or FFMA alone for float32, no TF32 MMA), no other MMA,
    and no atomic (ATOM, ATOMS, RED)."""
    cuobjdump = os.path.join(os.path.dirname(kernels.find_nvcc()),
                             "cuobjdump")
    for lib, moe in ((kernels.FLASH, False), (kernels.MOE_RUNS, True),
                     (kernels.MOE_Q4, True), (kernels.MOE_Q4_TILED, True),
                     (kernels.MOE_STREAM, True)):
        sass = subprocess.run([cuobjdump, "-sass", lib.build()],
                              capture_output=True, text=True,
                              check=True).stdout
        funcs, counts = [], []
        for ln in sass.splitlines():
            if "Function :" in ln:
                funcs.append(ln.split("Function :")[1].strip())
                counts.append({})
            elif funcs and "/*" in ln and ";" in ln:
                words = ln.split("*/", 1)[1].split()
                op = words[1] if words[0].startswith("@") else words[0]
                if op.startswith(("HMMA", "IMMA", "FFMA", "ATOM", "RED")):
                    op = op.split(".")[0] if op.startswith("FFMA") else op
                    counts[-1][op] = counts[-1].get(op, 0) + 1
        lines = []
        for name, c in zip(demangle(funcs), counts):
            short = short_name(name.replace("<", "[").replace(">", "]"))
            if moe and expert_kernel(short) is None:
                continue
            want = sass_want(short)
            lines.append(f"{short}: " + (", ".join(
                f"{k} x{v}" for k, v in sorted(c.items())) or "no MMA"))
            wrong = [k for k in c if k != want and k.startswith(
                ("HMMA", "IMMA", "ATOM", "RED"))]
            if (want is not None and not c.get(want)) or wrong:
                raise SystemExit(f"FAIL build: {short} runs {sorted(c)}, "
                                 f"not {want} alone")
        if not lines:
            raise SystemExit(f"FAIL build: no kernel in {lib.source}")
        log(f"sass {lib.source} (cuobjdump -sass): " + " | ".join(lines))


def expert_weights(torch, dtype, gen, n_layers=L, d=D, h=H):
    """Stacked (n_layers, E, d, h) / (n_layers, E, h, d) weights,
    per-layer biases."""
    def u(*shape, scale):
        return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
                * scale).to(dtype)
    return {"w1": u(n_layers, E, d, h, scale=0.5 * (6 / (d + h)) ** 0.5),
            "w2": u(n_layers, E, h, d, scale=0.5 * (6 / (d + h)) ** 0.5),
            "b1": u(E, h, scale=0.1), "b2": u(E, d, scale=0.1)}


def routing(torch, kind, n, gen):
    """Gate indices (1, n): a random router over random catEmbed
    features (skewed but spread, as a real router), all tokens on one
    expert, half the experts empty, 55% of the tokens on the router's
    busiest expert and the rest as the router sends them ("heavy": the
    engine's real routing gives one expert a median 43-56% of a block's
    tokens, PERF.md section 5), or the router result as is."""
    feats = torch.randn(n, 2 * D, generator=gen, device="cuda")
    router = torch.randn(2 * D, E, generator=gen, device="cuda") * 0.5
    logits = feats @ router
    if kind == "half_empty":
        logits[:, 1::2] = -1e30
    idx = logits.argmax(-1)
    if kind == "one_expert":
        idx = torch.full_like(idx, E - 1)
    if kind == "heavy":
        pick = torch.randperm(n, generator=gen, device="cuda")
        idx[pick[:round(0.55 * n)]] = torch.bincount(idx, minlength=E).argmax()
    return idx.to(torch.int32)[None]


def phase_kernel(torch, moe_runs):
    """K1 against its plain version: fp32 allclose(1e-5, 1e-5), bf16
    max|diff| within 1e-2 of max|ref|; fp32 K1 and K8 equal bit for bit.
    Returns the worst max_abs_err per dtype."""
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops.moe_stream import stream_kernel
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = {}
    bn = kernels.MOE_RUNS.load().moe_runs_f_col_block()

    def check(dtype, p, n, kind, layer, d=D):
        x = torch.randn(1, n, d, generator=gen, device="cuda").to(dtype)
        gate = routing(torch, kind, n, gen)
        got = moe_runs.runs_kernel.launch(p, x, gate, layer)
        torch.cuda.synchronize()
        ref = moe_runs.moe_experts_runs_reference(p, x, gate, layer)
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if dtype == torch.float32:
            ok = torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
        else:
            ok = err <= 1e-2 * scale
        log(f"kernel moe_runs_f {str(dtype)[6:]} d={d} "
            f"h={p['w1'].shape[-1]} n={n} {kind} layer={layer} "
            f"active={n_active(torch, gate)} column block {bn}: "
            f"max_abs_err={err:.3e} max|ref|={scale:.3e} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("FAIL kernel: moe_runs_f disagrees "
                             "with its plain version")
        key = str(dtype)[6:]
        max_err[key] = max(max_err.get(key, 0.0), err)
        if dtype == torch.float32 and kind in ("router", "heavy"):
            # K8 sums fp32 in K1's order: one accumulator, ascending k
            one = {k: v[layer] if k in ("w1", "w2") else v
                   for k, v in p.items()}
            if not torch.equal(got, stream_kernel.launch(one, x, gate)):
                raise SystemExit("FAIL kernel: fp32 moe_runs_f and "
                                 "moe_stream differ")

    for dtype in (torch.float32, torch.bfloat16):
        p = expert_weights(torch, dtype, gen)
        cases = [(n, kind) for n in TOKENS for kind in KINDS + ("heavy",)]
        cases.append((5, "router"))                   # N < tile
        for n, kind in cases:
            for layer in (0, L - 1):
                check(dtype, p, n, kind, layer)
        # d=320, h=640: multiples of 64, not both of 128
        p = expert_weights(torch, dtype, gen, n_layers=2, d=320, h=640)
        for n in (63, 511):
            check(dtype, p, n, "router", 1, d=320)
    log("kernel moe_runs_f float32 == moe_stream float32 (K8) bit for bit "
        "at every router and heavy case above")
    return max_err


def quant_experts(torch, bits, gen, n_layers, d=D, h=H, group=128):
    """Random quantized expert weights stacked (n_layers, E, ...): int8
    values, or random bytes (each byte holds two int4 values); float32
    scales (n_layers, E, [G,] 1, out) sized for outputs of order one,
    with `group`-row groups for int4 where the contraction allows; bf16
    biases (E, out)."""
    rms = 73.3 if bits == 8 else 4.6       # rms of uniform int8 / int4

    def ints(*shape):
        return torch.randint(-127 if bits == 8 else -128, 128, shape,
                             generator=gen, device="cuda",
                             dtype=torch.int16).to(torch.int8)

    def scales(k, out):
        groups = k // group if bits == 4 and k % group == 0 and k > group \
            else 1
        shape = (n_layers, E) + ((groups,) if bits == 4 else ()) + (1, out)
        return (torch.rand(shape, generator=gen, device="cuda") + 0.5) \
            / (rms * k ** 0.5)

    def bias(n):
        return ((torch.rand(E, n, generator=gen, device="cuda") * 2 - 1)
                * 0.1).to(torch.bfloat16)
    half = 2 if bits == 4 else 1
    k1, k2 = ("w1_q4", "w2_q4") if bits == 4 else ("w1_q", "w2_q")
    return {k1: ints(n_layers, E, d, h // half),
            k2: ints(n_layers, E, h, d // half),
            "w1_scale": scales(d, h), "w2_scale": scales(h, d),
            "b1": bias(h), "b2": bias(d)}


def at_layer(p, layer):
    """The wrappers' arguments for one layer: the stacked weights and
    this layer's scales."""
    return {k: v[layer] if k.endswith("_scale") else v for k, v in p.items()}


def n_active(torch, gate):
    return int((torch.bincount(gate.flatten().long(), minlength=E) > 0)
               .sum())


def phase_kernel_quant(torch):
    """K4, K5 and K6 against their plain versions, and K5 a8 against K6 a8
    bit for bit; returns the worst max_abs_err of each (kernel, a8)."""
    from m3asr_tpu_torch.ops import moe_q4, moe_runs
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {}
    n_layers = 3
    runs = {"K4": moe_runs.runs_q8_kernel, "K5": moe_runs.runs_q4_kernel}

    def check(key, kern, plain, p, n, kind, layer, d=D, note=""):
        kname, a8 = key
        x = torch.randn(1, n, d, generator=gen, device="cuda") \
            .to(torch.bfloat16)
        gate = stage_routing(torch, kind, n, gen)
        pl = at_layer(p, layer)
        got = kern.launch(pl, x, gate, layer, act_quant=a8)
        torch.cuda.synchronize()
        if kind == "padded" and bool((got[gate < 0] != 0).any()):
            raise SystemExit(f"FAIL kernel: {QUANT_NAMES[key]} wrote a row "
                             "of no expert")
        ref = plain(pl, x, gate, layer, act_quant=a8)
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        ok = err <= (2e-2 if a8 else 1e-2) * scale
        log(f"kernel {QUANT_NAMES[key]} ({kname}) d={d} n={n} {kind} "
            f"layer={layer}{note} active={n_active(torch, gate[gate >= 0])}: "
            f"max_abs_err={err:.3e} max|ref|={scale:.3e} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"FAIL kernel: {QUANT_NAMES[key]} disagrees "
                             "with its plain version")
        worst[key] = max(worst.get(key, 0.0), err)
        if kname == "K5" and a8 and kind in ("router", "heavy") and n == 63:
            # the same quant_rows, exact s32 sums and epilogue as K6
            k6 = moe_q4.q4_kernel.launch(pl, x, gate, layer, act_quant=True)
            if not torch.equal(got, k6):
                raise SystemExit(
                    "FAIL kernel: moe_runs_q4[w4a8] and moe_q4_dense[w4a8] "
                    "differ by up to "
                    f"{(got.float() - k6.float()).abs().max().item():.3e}")
            log(f"kernel moe_runs_q4[w4a8] (K5) == moe_q4_dense[w4a8] (K6) "
                f"bit for bit: n={n} {kind} layer={layer}{note}")

    last = n_layers - 1
    for bits, kname in ((8, "K4"), (4, "K5")):
        p = quant_experts(torch, bits, gen, n_layers)
        for a8 in (False, True):
            for n in (63, 511, 1020):
                for kind in KINDS + ("heavy",):
                    for layer in (0, last):
                        check((kname, a8), runs[kname],
                              moe_runs.moe_experts_runs_reference, p, n,
                              kind, layer)
    for a8 in (False, True):
        for n in (63, 127):
            for kind in KINDS + ("heavy", "padded"):
                for layer in (0, last):
                    check(("K6", a8), moe_q4.q4_kernel,
                          moe_q4.moe_experts_q4_reference, p, n, kind,
                          layer)
    # 32-row int4 groups, the smallest the width rule takes: a group ends
    # in the middle of each 64-deep slice of K5
    p = quant_experts(torch, 4, gen, n_layers, group=32)
    for a8 in (False, True):
        for n in (63, 511):
            for layer in (0, last):
                check(("K5", a8), runs["K5"],
                      moe_runs.moe_experts_runs_reference, p, n, "router",
                      layer, note=" groups=32 rows")
    # d=320: w2's packed columns hold columns j and j + 160, so the
    # column block [128, 192) takes low nibbles and high nibbles
    for bits, kname in ((8, "K4"), (4, "K5")):
        p = quant_experts(torch, bits, gen, 1, d=320, h=640)
        for a8 in (False, True):
            check((kname, a8), runs[kname],
                  moe_runs.moe_experts_runs_reference, p, 63, "router", 0,
                  320)
            check((kname, a8), runs[kname],
                  moe_runs.moe_experts_runs_reference, p, 511, "router", 0,
                  320)
            if bits == 4:
                check(("K6", a8), moe_q4.q4_kernel,
                      moe_q4.moe_experts_q4_reference, p, 63, "router", 0,
                      320)
    return worst


STAGE_TOKENS = (63, 511, 1020)       # the requests' token counts
# K8 variant -> (activation dtype, weight format); K7 a8 -> its name
STREAM_NAMES = {"float32": "moe_stream[float32]",
                "bfloat16": "moe_stream[bfloat16]",
                "int8": "moe_stream[int8]"}
TILED_NAMES = {False: "moe_q4_tiled[int4]", True: "moe_q4_tiled[w4a8]"}
TILED_F32 = "moe_q4_tiled[int4 float32]"   # no engine reaches it


def stream_layers(torch, wtype, gen, n_layers):
    """n_layers one-layer expert dicts for K8 (the model hands K8 one
    layer's views): float weights (E, d, h) / (E, h, d) of wtype with
    biases of that type, or (wtype "int8") int8 weights with float32
    (E, 1, out) scales and bf16 biases."""
    if wtype == "int8":
        p = quant_experts(torch, 8, gen, n_layers)
        return [{k: v[i] if k != "b1" and k != "b2" else v
                 for k, v in p.items()} for i in range(n_layers)]
    p = expert_weights(torch, getattr(torch, wtype), gen)
    return [{"w1": p["w1"][i], "w2": p["w2"][i], "b1": p["b1"],
             "b2": p["b2"]} for i in range(n_layers)]


def stage_routing(torch, kind, n, gen):
    """The routings of the K4-K8 checks: routing()'s kinds, and (K6, K8)
    "padded", the router's routing with every fifth row and the last row
    padded with gate -1, as the JAX wrapper pads rows of no expert."""
    if kind != "padded":
        return routing(torch, kind, n, gen)
    gate = routing(torch, "router", n, gen)
    gate[0, ::5] = -1
    gate[0, -1] = -1
    return gate


FRONT_TOKENS = (1, 63, 127, 511, 1020, 2048)


def phase_kernel_front(torch):
    """K6's and K8's row-tile front (row_tiles, built into each of their
    libraries, called through its custom operator
    ``m3asr::<library>_row_tiles``) against its plain twin
    (ops/row_tiles.py): the same tile
    count, rows of no expert, row order and tile table, at 1 to 2048
    rows under every routing, gate -1 padding included. Returns the
    number of cases."""
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops import row_tiles
    from m3asr_tpu_torch.ops.library import OPS
    gen = torch.Generator(device="cuda").manual_seed(12)
    cases = 0
    for lib, prefix in ((kernels.MOE_Q4.load(), "moe_q4"),
                        (kernels.MOE_STREAM.load(), "moe_stream")):
        size = getattr(lib, f"{prefix}_front_ints")
        run = OPS[f"{prefix}_row_tiles"]       # the custom operator
        for n in FRONT_TOKENS:
            if size(n, E) != row_tiles.front_ints(n, E):
                raise SystemExit(f"FAIL kernel: {prefix} front size "
                                 f"{size(n, E)} != plain "
                                 f"{row_tiles.front_ints(n, E)}")
            for kind in KINDS + ("heavy", "padded"):
                gate = stage_routing(torch, kind, n, gen).reshape(n)
                words = run(gate, E)
                torch.cuda.synchronize()
                got = row_tiles.read_front(words, n, E)
                want = row_tiles.read_front(
                    row_tiles.row_tiles_reference(gate, E), n, E)
                same = got[:2] == want[:2] and all(
                    torch.equal(a, b) for a, b in zip(got[2:], want[2:]))
                if not same:
                    raise SystemExit(f"FAIL kernel: {prefix}_row_tiles n={n} "
                                     f"{kind} differs from its plain twin: "
                                     f"tiles {got.n_tiles} / {want.n_tiles},"
                                     f" no expert {got.n_none} / "
                                     f"{want.n_none}")
                cases += 1
    log(f"kernel row_tiles (K6/K8 front) == plain twin at {cases} cases: "
        f"n in {FRONT_TOKENS}, {KINDS + ('heavy', 'padded')}, both "
        "libraries")
    return cases


def rel_check(got, ref, tol, label, name):
    """max|diff| within tol of max|ref| (both finite); logs one line and
    exits on a failure. Returns max|diff|."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = np.isfinite(err) and err <= tol * scale
    log(f"kernel {label}: max_abs_err={err:.3e} max|ref|={scale:.3e} "
        f"(held to {tol:g} of it) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"FAIL kernel: {name} disagrees with its plain "
                         "version")
    return err


def phase_kernel_stage(torch):
    """K8 (fp32, bf16, int8 weights on bf16 activations) and K7
    (weight-only on bf16 and float32 activations, a8) against their plain
    versions at the flagship widths and the requests' token counts, and
    K7 a8 against K5 a8 bit for bit. Returns the worst max_abs_err per
    variant name."""
    from m3asr_tpu_torch.ops import moe_q4, moe_runs, moe_stream
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = {}
    # K8: fp32 within 1e-5 of max|ref| (float32 sums in another order),
    # bf16 and int8 (bf16 weights, hidden and output) within 1e-2
    for wtype, name in STREAM_NAMES.items():
        p = stream_layers(torch, wtype, gen, 1)[0]
        xdt = torch.float32 if wtype == "float32" else torch.bfloat16
        tol = 1e-5 if wtype == "float32" else 1e-2
        for n in STAGE_TOKENS:
            for kind in KINDS + ("heavy", "padded"):
                x = torch.randn(1, n, D, generator=gen, device="cuda").to(xdt)
                gate = stage_routing(torch, kind, n, gen)
                got = moe_stream.stream_kernel.launch(p, x, gate)
                torch.cuda.synchronize()
                ref = moe_stream.moe_experts_dense_stream_reference(
                    p, x, gate)
                if kind == "padded" and bool((got[gate < 0] != 0).any()):
                    raise SystemExit(f"FAIL kernel: {name} wrote a row of "
                                     "no expert")
                err = rel_check(got, ref, tol, f"{name} (K8) n={n} {kind} "
                                f"active={n_active(torch, gate[gate >= 0])}",
                                name)
                worst[name] = max(worst.get(name, 0.0), err)
    # K7: stacked L=3 at layers 0 and 2; bf16 weight-only within 1e-2 of
    # max|ref|, a8 within 2e-2 (as K4-K6), float32 weight-only within 1e-5
    # (as fp32 K8: float32 sums in another order)
    n_layers = 3
    p = quant_experts(torch, 4, gen, n_layers)

    def check_tiled(p, a8, n, kind, layer, d=D, upper=None,
                    dtype=torch.bfloat16):
        x = torch.randn(1, n, d, generator=gen, device="cuda").to(dtype)
        gate = routing(torch, kind, n, gen)
        pl = at_layer(p, layer)
        got = moe_q4.q4_tiled_kernel.launch(pl, x, gate, layer=layer,
                                            act_quant=a8, upper_bound=upper)
        torch.cuda.synchronize()
        ref = moe_q4.moe_experts_q4_tiled_reference(
            pl, x, gate, layer=layer, act_quant=a8, upper_bound=upper)
        f32 = dtype == torch.float32
        name = TILED_F32 if f32 else TILED_NAMES[a8]
        err = rel_check(got, ref, 1e-5 if f32 else 2e-2 if a8 else 1e-2,
                        f"{name} (K7) d={d} n={n} tile="
                        f"{moe_q4.tiled_tile(n)} {kind} layer={layer} "
                        f"upper_bound={upper} active={n_active(torch, gate)}",
                        name)
        worst[name] = max(worst.get(name, 0.0), err)
        if a8 and kind in TIME_KINDS and n in (511, 1020) and upper is None:
            # the same quant_rows, s8 tiles, exact s32 sums and epilogue
            k5 = moe_runs.runs_q4_kernel.launch(pl, x, gate, layer,
                                                act_quant=True)
            if not torch.equal(got, k5):
                raise SystemExit(
                    "FAIL kernel: moe_q4_tiled[w4a8] and moe_runs_q4[w4a8] "
                    "differ by up to "
                    f"{(got.float() - k5.float()).abs().max().item():.3e}")
            log(f"kernel moe_q4_tiled[w4a8] (K7) == moe_runs_q4[w4a8] (K5) "
                f"bit for bit: n={n} {kind} layer={layer}")

    for a8 in (False, True):
        for n in STAGE_TOKENS:
            for kind in KINDS + ("heavy",):
                for layer in (0, n_layers - 1):
                    check_tiled(p, a8, n, kind, layer)
        check_tiled(p, a8, 511, "router", 1, upper=0.5)   # DFSMN's clamp
    for n in STAGE_TOKENS:
        for kind in TIME_KINDS:
            check_tiled(p, False, n, kind, n_layers - 1,
                        dtype=torch.float32)
    check_tiled(p, False, 511, "router", 1, upper=0.5, dtype=torch.float32)
    # d=320, h=640: w2's packed columns hold columns j and j + 160 (both
    # nibble halves inside one column block); w1 one scale group, w2 five
    p = quant_experts(torch, 4, gen, 1, d=320, h=640)
    for a8 in (False, True):
        for n in (63, 1020):
            check_tiled(p, a8, n, "router", 0, 320)
    check_tiled(p, False, 63, "router", 0, 320, dtype=torch.float32)
    return worst


def flash_inputs(torch, B, T, H, Dk, dtype, masks, gen):
    """q2 (B,H,T,2Dk), k2, v, g and the masks of one K2/K3 check case:
    ``lengths`` mixed (full, one short row, one zero-length row when
    B > 1), ``window`` a static chunk mask of 16 frames (with lengths),
    ``mem_cols`` that window plus 4 always-attended leading keys."""
    from m3asr_tpu_torch.ops import masking
    from m3asr_tpu_torch.ops.flash_attention import window_from_mask
    D2 = 2 * Dk
    q2, k2 = (torch.randn(B, H, T, D2, generator=gen, device="cuda")
              .to(dtype) for _ in range(2))
    v = torch.randn(B, H, T, Dk, generator=gen, device="cuda").to(dtype)
    g = torch.randn(B, H, T, Dk, generator=gen, device="cuda").to(dtype)
    lens = [T, 7, 0, T - 40][:B] if masks == "lengths" else \
        [T, T - 40, 100, T][:B]
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    window, mem = None, 0
    if masks != "lengths":
        m = masking.add_optional_chunk_mask(lens, T, False, False, 0, 16, -1)
        window = window_from_mask(m, T, T)
        mem = 4 if masks == "mem_cols" else 0
    return q2, k2, v, g, lens, window, mem


FLASH_SHAPES = ((4, 255), (1, 511))      # (B, T = S): the main path's
FLASH_HEADS = ((8, 64), (4, 128))        # (H, Dk): MoE, embed blocks


def phase_kernel_flash(torch):
    """K2 (out, LSE) and K3 (dq2, dk2, dv) against their plain versions at
    the flagship's shapes, head widths, types and masks, with the wrapper's
    tile heights; then every tile height each kernel is built for at B=4,
    T=255, where two K3 calls must also give bit-identical gradients.
    Returns the worst max_abs_err of each (kernel, dtype)."""
    from m3asr_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = {}

    def check(dtype, B, T, H, Dk, masks, rows=None):
        dname = str(dtype)[6:]
        tol = FLASH_TOL[dname]
        q2, k2, v, g, lens, window, mem = flash_inputs(
            torch, B, T, H, Dk, dtype, masks, gen)
        scale = Dk ** -0.5
        fwd_rows, bwd_rows = (None, None) if rows is None else (
            rows, (min(rows, 32),) * 2)
        out, lse = fa.flash_kernels.forward(
            q2, k2, v, lens, scale, window, mem, True, rows=fwd_rows)
        delta = (g.float() * out.float()).sum(-1, keepdim=True)
        grads = fa.flash_kernels.backward(q2, k2, v, g, lse, delta, lens,
                                          scale, window, mem, rows=bwd_rows)
        torch.cuda.synchronize()
        r_out, r_lse = fa.flash_attention_reference(
            q2, k2, v, lens, scale, window, mem)
        r_grads = fa.flash_attention_bwd_reference(
            q2, k2, v, g, r_lse,
            (g.float() * r_out.float()).sum(-1, keepdim=True),
            lens, scale, window, mem)
        label = (f"kernel flash {dname} B={B} T={T} H={H} Dk={Dk} {masks} "
                 f"rows={'auto' if rows is None else rows}")
        rels = []
        keep = r_lse > -1e29       # rows with a key to attend
        for kern, name, a, r in (
                ("K2", "out", out, r_out),
                ("K2", "lse", lse[keep], r_lse[keep]),
                ("K3", "dq2", grads[0], r_grads[0]),
                ("K3", "dk2", grads[1], r_grads[1]),
                ("K3", "dv", grads[2], r_grads[2])):
            err = (a.float() - r.float()).abs().max().item()
            rel = err / r.float().abs().max().item()
            rels.append(f"{name} {rel:.2e}")
            worst[(kern, dname)] = max(worst.get((kern, dname), 0.0), err)
            if not (rel <= tol and np.isfinite(err)):
                log(f"{label}: {name} max|diff|/max|ref|={rel:.3e} > {tol} "
                    "FAIL")
                raise SystemExit(f"FAIL kernel: flash {name} disagrees with "
                                 "its plain version")
        if rows is not None:     # K3 repeats bit for bit (no atomics)
            again = fa.flash_kernels.backward(
                q2, k2, v, g, lse, delta, lens, scale, window, mem,
                rows=bwd_rows)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise SystemExit(f"FAIL kernel: {label}: two K3 calls gave "
                                 "different gradients")
            rels.append("K3 bit-identical twice")
        log(f"{label} lens={lens.tolist()}: max|diff|/max|ref| "
            + ", ".join(rels) + " OK")

    for dtype in (torch.float32, torch.bfloat16):
        for B, T in FLASH_SHAPES:
            for H, Dk in FLASH_HEADS:
                for masks in ("lengths", "window", "mem_cols"):
                    check(dtype, B, T, H, Dk, masks)
        for H, Dk in FLASH_HEADS:
            for rows in fa.FWD_ROWS:
                check(dtype, 4, 255, H, Dk, "window", rows)
    return worst


def flagship_cfg(moe_blocks=FLAGSHIP_MOE_BLOCKS):
    from m3asr_tpu_torch.config import (EncoderConfig, ModelConfig,
                                        MoEConfig, MoEEncoderConfig)
    cfg = ModelConfig(input_dim=40, output_dim=5000)
    cfg.encoder_conf = MoEEncoderConfig(
        attention_dim=512, attention_heads=8, num_blocks=moe_blocks,
        embed_conf=EncoderConfig(attention_dim=512, attention_heads=4,
                                 linear_units=1024, num_blocks=6),
        moe_conf=MoEConfig(num_experts=32, hidden_units=1024))
    return cfg


def flagship_params(torch, moe_blocks=FLAGSHIP_MOE_BLOCKS):
    """The flagship's config and its random parameters from a seeded
    generator on the card (routers normal x 0.5, so that routing spreads
    over the experts)."""
    from m3asr_tpu_torch.models import moe_conformer
    cfg = flagship_cfg(moe_blocks)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = moe_conformer.init(cfg.encoder_conf, cfg.input_dim,
                                cfg.output_dim, gen, device="cuda")
    r = params["blocks"]["feed_forward"]["router"]
    r["kernel"] = torch.randn(r["kernel"].shape, generator=gen,
                              device="cuda") * 0.5
    return cfg, params


class GateRecorder:
    """Records the expert index of every token at every MoE block, to
    count tokens whose expert differs between two runs. Given an earlier
    run's record (``replay``), it sends each block's tokens to the
    experts of that run instead. The gate value stays this run's router
    maximum: where the two runs chose differently the router was at a
    near-tie, so the two experts' probabilities are nearly equal."""

    def __init__(self, moe_mod, replay=None):
        self.moe_mod, self.replay, self.inner, self.calls = (
            moe_mod, replay, None, [])

    def __enter__(self):
        self.inner = self.moe_mod.softmax_top1_gate

        def gate(p, router_inputs, lengths):
            value, idx = self.inner(p, router_inputs, lengths)
            if self.replay is not None:
                idx = self.replay[len(self.calls)]
            self.calls.append(idx.clone())
            return value, idx
        self.moe_mod.softmax_top1_gate = gate
        return self

    def __exit__(self, *exc):
        self.moe_mod.softmax_top1_gate = self.inner


def phase_serve(torch, state):
    from m3asr_tpu_torch.decode.ctc import ctc_greedy_search
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.moe_runs import runs_kernel
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg, params = flagship_params(torch)
    rng = np.random.default_rng(2)
    reqs = [(rng.standard_normal((b, t, cfg.input_dim)).astype(np.float32),
             np.full((b,), t, np.int32)) for b, t in REQUESTS]
    engines = {}
    for dtype in ("float32", "bfloat16"):
        engines[dtype] = (
            Engine(cfg, params, EngineConfig(dtype=dtype), device="cuda",
                   cuda_graphs=False),
            Engine(cfg, params, EngineConfig(dtype=dtype, moe_impl="dense"),
                   device="cuda", cuda_graphs=False))
    state["engines"], state["requests"] = engines, reqs
    state["cfg"], state["params"] = cfg, params
    n_blocks = cfg.encoder_conf.num_blocks

    runs_kernel.launches = 0           # the main path's run starts here
    per_dtype = {}
    truth = {}                         # fp32 logits, the bf16 yardstick
    for dtype, (eng, dense) in engines.items():
        before = runs_kernel.launches
        for i, (feat, lens) in enumerate(reqs):
            n0 = runs_kernel.launches
            with GateRecorder(moe_mod) as rec_k:
                out, out_len = eng.infer(feat, lens)
            got = runs_kernel.launches - n0
            if got != n_blocks:
                raise SystemExit(f"FAIL serve: {got} K1 calls in one "
                                 f"forward, want {n_blocks}")
            with GateRecorder(moe_mod) as rec_d:
                ref, ref_len = dense.infer(feat, lens)
            if not (np.array_equal(out_len, ref_len)
                    and np.isfinite(out).all()):
                raise SystemExit("FAIL serve: lengths differ or logits "
                                 "are not finite")
            B = feat.shape[0]

            def valid_rows(a):
                return np.concatenate([a[b, :out_len[b]] for b in range(B)])

            def compare(a, r):
                """(max|diff|/max|ref|, share of frames with equal argmax)"""
                return (float(np.abs(a - r).max() / np.abs(r).max()),
                        float((a.argmax(-1) == r.argmax(-1)).mean()))
            valid, rvalid = valid_rows(out), valid_rows(ref)
            rel, agree = compare(valid, rvalid)
            # (token, block) pairs whose expert differs between the runs,
            # and the frames whose token changed expert in some block
            flips = torch.stack([a != b for a, b in
                                 zip(rec_k.calls, rec_d.calls)])[:, :B]
            flipped = valid_rows(flips.any(0).cpu().numpy())
            line = (f"serve {dtype} {B}x{feat.shape[1]}: out {out.shape}, "
                    f"K1 calls {got}, vs dense: max|diff|/max|ref|="
                    f"{rel:.3e}, argmax agree={agree:.4f}; flipped (token, "
                    f"block) pairs={int(flips.sum())} in "
                    f"{int(flipped.sum())} of {len(flipped)} frames")
            if dtype == "float32":
                truth[i] = valid
                ok = np.allclose(valid, rvalid, rtol=1e-5, atol=1e-3)
            else:
                # bf16 rounding sends tokens at router near-ties to other
                # experts, differently in two runs that sum in another
                # order, and one flipped token reaches every frame of its
                # sequence through attention. So the dense run is made
                # again with its tokens sent to the kernel run's experts:
                # then the two differ by summation order alone, and are
                # held to max|diff|/max|ref| <= 0.05 on every valid
                # frame. Their argmax agreement is printed, not held:
                # random-weight logits have near-tied maxima that bf16
                # noise of that size reorders. Both free-running paths
                # are held to the fp32 logits: the kernel path's mean
                # distance from them within 1.5x the dense path's, its
                # argmax agreement with them within three standard
                # errors of the dense path's.
                with GateRecorder(moe_mod, replay=rec_k.calls):
                    pin, _ = dense.infer(feat, lens)
                rel_pin, agree_pin = compare(valid, valid_rows(pin))
                t = truth[i]
                err_k = float(np.abs(valid - t).mean())
                err_d = float(np.abs(rvalid - t).mean())
                arg_k = float((valid.argmax(-1) == t.argmax(-1)).mean())
                arg_d = float((rvalid.argmax(-1) == t.argmax(-1)).mean())
                slack = 3 * (arg_d * (1 - arg_d) / len(t)) ** 0.5
                ok = (rel_pin <= 0.05 and err_k <= 1.5 * err_d
                      and arg_k >= arg_d - slack)
                line += (f"; vs dense on the kernel run's experts: max|diff|"
                         f"/max|ref|={rel_pin:.3e}, argmax agree="
                         f"{agree_pin:.4f}; vs fp32: mean|diff| kernel "
                         f"{err_k:.4e} dense {err_d:.4e}, argmax agree "
                         f"kernel {arg_k:.4f} dense {arg_d:.4f} (slack "
                         f"{slack:.4f})")
            hyps = ctc_greedy_search(out, out_len)
            log(f"{line} {'OK' if ok else 'FAIL'}; greedy hyp lengths "
                f"{[len(h) for h in hyps]}")
            if not ok:
                raise SystemExit("FAIL serve: kernel path disagrees with "
                                 "moe_impl='dense'")
        per_dtype[dtype] = runs_kernel.launches - before
    log(f"serve: main path made {runs_kernel.launches} K1 calls "
        f"({per_dtype})")
    state["truth"] = truth
    return per_dtype


class PlainExperts:
    """Sends the expert stages that have a kernel to the kernels' plain
    versions, on the card's tensors: the reference run of phase 5."""

    def __init__(self, moe_mod):
        self.moe_mod, self.inner = moe_mod, None

    def __enter__(self):
        from m3asr_tpu_torch.ops import moe_q4, moe_runs, moe_stream
        inner = self.inner = self.moe_mod._dispatch

        def plain(p, x, gate_idx, impl, **act):
            # act: the DFSMN experts' activation and clamp, if any
            if impl == "runs_f" or impl.endswith("_runs"):
                return moe_runs.moe_experts_runs_reference(
                    p, x, gate_idx, act_quant="_a8" in impl, **act)
            if impl in ("quant4_pallas", "quant4_a8") or (
                    impl == "quant_pallas" and "w1_q4" in p):
                return moe_q4.moe_experts_q4_reference(
                    p, x, gate_idx, act_quant=impl == "quant4_a8", **act)
            if impl in ("pallas", "quant_pallas"):
                return moe_stream.moe_experts_dense_stream_reference(
                    p, x, gate_idx)
            if impl in ("quant4_tiled", "quant4_a8_tiled"):
                return moe_q4.moe_experts_q4_tiled_reference(
                    p, x, gate_idx, act_quant=impl == "quant4_a8_tiled",
                    **act)
            return inner(p, x, gate_idx, impl, **act)
        self.moe_mod._dispatch = plain
        return self

    def __exit__(self, *exc):
        self.moe_mod._dispatch = self.inner


def phase_serve_quant(torch, state, smi):
    """Serves the requests with the int8, w8a8, int4 and w4a8 engines;
    returns each mode's kernel launches on its run."""
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    wrappers = stage_wrappers()
    cfg, reqs, truth = state["cfg"], state["requests"], state["truth"]
    n_blocks = cfg.encoder_conf.num_blocks
    launches = {}
    for dtype in ("int8", "int4"):
        base = None
        for act_quant in (False, True):
            mode = MODES[(dtype, act_quant)]
            t0 = time.perf_counter()
            eng = Engine(cfg, state["params"] if base is None
                         else base.params,
                         EngineConfig(dtype=dtype, act_quant=act_quant),
                         device="cuda", cuda_graphs=False)
            log(f"serve {mode}: engine built in "
                f"{time.perf_counter() - t0:.2f} s ("
                + ("experts quantized from their bf16 values" if base is None
                   else f"sharing the {dtype} engine's weights") + ")")
            if base is None:
                base = eng
            for w in wrappers.values():
                w.launches = 0          # this mode's run starts here
            for i, (feat, lens) in enumerate(reqs):
                B, T = feat.shape[:2]
                before = {k: w.launches for k, w in wrappers.items()}
                with GateRecorder(moe_mod) as rec:
                    out, out_len = eng.infer(feat, lens)
                got = {k: w.launches - before[k]
                       for k, w in wrappers.items()
                       if w.launches != before[k]}
                kname = QUANT_EXPECT[dtype][i]
                want = {} if kname is None else {kname: n_blocks}
                with GateRecorder(moe_mod, replay=rec.calls), \
                        PlainExperts(moe_mod):
                    ref, ref_len = eng.infer(feat, lens)
                if not (np.array_equal(out_len, ref_len)
                        and np.isfinite(out).all()):
                    raise SystemExit(f"FAIL serve {mode}: lengths differ or "
                                     "logits are not finite")

                def valid_rows(a):
                    return np.concatenate([a[b, :out_len[b]]
                                           for b in range(B)])
                valid, rvalid, t = valid_rows(out), valid_rows(ref), truth[i]
                rel = float(np.abs(valid - rvalid).max()
                            / np.abs(rvalid).max())
                agree = float((valid.argmax(-1) == rvalid.argmax(-1)).mean())
                ok = rel <= 0.05 and got == want
                stage = eng.moe_impl_for(*eng.buckets.pick(B, T))
                log(f"serve {mode} {B}x{T}: stage {stage}, launches per "
                    f"forward {got or 'none (plain-PyTorch stage)'} (want "
                    f"{want or 'none'}); vs the kernels' plain versions, "
                    f"routing pinned: max|diff|/max|ref|={rel:.3e}, argmax "
                    f"agree={agree:.4f}; vs fp32 logits (information): "
                    f"mean|diff| {float(np.abs(valid - t).mean()):.4e}, "
                    f"max|diff|/max|ref| "
                    f"{float(np.abs(valid - t).max() / np.abs(t).max()):.3e},"
                    f" argmax agree "
                    f"{float((valid.argmax(-1) == t.argmax(-1)).mean()):.4f}"
                    f" {'OK' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"FAIL serve {mode}: wrong kernel "
                                     "launches or logits off the plain "
                                     "versions'")
            launches[mode] = {k: w.launches for k, w in wrappers.items()}
            log(f"serve {mode}: main path launches {launches[mode]}")
            request_times(torch, eng, mode, reqs, smi)
            eng = None
        # the quantized tree, for phase 6's engines with explicit stages
        state.setdefault("qparams", {})[dtype] = base.params
        base = None
        torch.cuda.empty_cache()
    return launches


def stage_wrappers():
    """Every expert kernel's wrapper, by kernel."""
    from m3asr_tpu_torch.ops import moe_q4, moe_runs, moe_stream
    return {"K1": moe_runs.runs_kernel, "K4": moe_runs.runs_q8_kernel,
            "K5": moe_runs.runs_q4_kernel, "K6": moe_q4.q4_kernel,
            "K7": moe_q4.q4_tiled_kernel, "K8": moe_stream.stream_kernel}


# engines with an explicit kernel stage: (label, EngineConfig settings,
# the params they start from, the kernel each forward launches once per
# MoE block, the kernel variant's name in the output)
KERNEL_STAGE_ENGINES = (
    ("float32 pallas", dict(dtype="float32", moe_impl="pallas"), "float",
     "K8", STREAM_NAMES["float32"]),
    ("bfloat16 pallas", dict(dtype="bfloat16", moe_impl="pallas"), "float",
     "K8", STREAM_NAMES["bfloat16"]),
    ("int8 pallas", dict(dtype="int8", moe_impl="pallas"), "int8", "K8",
     STREAM_NAMES["int8"]),
    ("int4 tiled", dict(dtype="int4", moe_impl="tiled"), "int4", "K7",
     TILED_NAMES[False]),
    ("w4a8 tiled", dict(dtype="int4", act_quant=True, moe_impl="tiled"),
     "int4", "K7", TILED_NAMES[True]),
)
# engines with a plain-PyTorch stage, each answering the 4x1000 request:
# (label, settings, params, the reference engine's settings)
PLAIN_STAGE_ENGINES = tuple(
    (f"float32 {impl}", dict(dtype="float32", moe_impl=impl), "float",
     dict(dtype="float32", moe_impl="dense"))
    for impl in ("tiled", "ragged", "ragged_padded", "capacity")) + (
    ("int8 quant_tiled", dict(dtype="int8", moe_impl="quant_tiled"), "int8",
     dict(dtype="int8", moe_impl="quant")),
    ("int8 quant_capacity", dict(dtype="int8", moe_impl="quant_capacity"),
     "int8", dict(dtype="int8", moe_impl="quant")),
    ("w8a8 quant_a8_tiled", dict(dtype="int8", act_quant=True,
                                 moe_impl="quant_a8_tiled"), "int8",
     dict(dtype="int8", act_quant=True, moe_impl="quant_a8")),
)


def served_valid(eng, ref_eng, moe_mod, feat, lens, plain=False):
    """One request through eng, then through ref_eng with its tokens sent
    to eng's experts (on the kernels' plain versions if ``plain``).
    Returns (valid rows of eng's logits, of ref_eng's, launches per
    kernel in eng's forward, the largest expert's share of the bucket's
    tokens in each MoE block)."""
    wrappers = stage_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    with GateRecorder(moe_mod) as rec:
        out, out_len = eng.infer(feat, lens)
    got = {k: w.launches - before[k] for k, w in wrappers.items()
           if w.launches != before[k]}
    with GateRecorder(moe_mod, replay=rec.calls):
        if plain:
            with PlainExperts(moe_mod):
                ref, ref_len = ref_eng.infer(feat, lens)
        else:
            ref, ref_len = ref_eng.infer(feat, lens)
    if not (np.array_equal(out_len, ref_len) and np.isfinite(out).all()):
        raise SystemExit("FAIL serve stages: lengths differ or logits are "
                         "not finite")
    share = [float(c.flatten().bincount().max()) / c.numel()
             for c in rec.calls]
    return valid_rows(out, out_len), valid_rows(ref, out_len), got, share


def phase_serve_stages(torch, state, smi):
    """Engines with explicit expert stages (ROADMAP item 6b). Kernel
    stages: each request's forward launches its kernel once per MoE block
    and no other expert kernel; logits held to the same engine with its
    experts on the plain versions, routing pinned (fp32 allclose(1e-5,
    1e-3), else max|diff|/max|ref| <= 0.05). Plain-PyTorch stages: one
    4x1000 request each, no expert kernel, held the same way to the
    dense / quant / quant_a8 engine. Then one int4 engine with
    dense_quant and fuse_qkv at 1x206. Returns the launches of each
    kernel variant on its engine's run."""
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.quant import dequantize_dense_params
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg, reqs, truth = state["cfg"], state["requests"], state["truth"]
    trees = {"float": state["params"], **state["qparams"]}
    n_blocks = cfg.encoder_conf.num_blocks
    wrappers = stage_wrappers()
    launches = {}

    def judge(valid, rvalid, fp32):
        rel = float(np.abs(valid - rvalid).max() / np.abs(rvalid).max())
        if fp32:
            return np.allclose(valid, rvalid, rtol=1e-5, atol=1e-3), rel, \
                "allclose(1e-5, 1e-3)"
        return rel <= 0.05, rel, "max|diff|/max|ref| <= 0.05"

    for label, settings, tree, kname, vname in KERNEL_STAGE_ENGINES:
        eng = Engine(cfg, trees[tree], EngineConfig(**settings),
                     device="cuda", cuda_graphs=False)
        for w in wrappers.values():
            w.launches = 0              # this engine's run starts here
        for i, (feat, lens) in enumerate(reqs):
            valid, rvalid, got, share = served_valid(eng, eng, moe_mod, feat,
                                                     lens, plain=True)
            ok, rel, held = judge(valid, rvalid,
                                  settings["dtype"] == "float32")
            ok = ok and got == {kname: n_blocks}
            t = truth[i]
            B, T = feat.shape[:2]
            log(f"serve {label} {B}x{T}: stage "
                f"{eng.moe_impl_for(*eng.buckets.pick(B, T))}, launches per "
                f"forward {got} (want {{{kname!r}: {n_blocks}}}); vs the "
                f"kernels' plain versions, routing pinned: max|diff|/max|ref|"
                f"={rel:.3e}, held to {held}; vs fp32 logits (information): "
                f"max|diff|/max|ref| "
                f"{float(np.abs(valid - t).max() / np.abs(t).max()):.3e}, "
                f"argmax agree "
                f"{float((valid.argmax(-1) == t.argmax(-1)).mean()):.4f}; "
                f"the largest expert's share of the tokens per MoE block: "
                f"median {np.median(share):.3f}, max {max(share):.3f} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"FAIL serve {label}: wrong kernel launches "
                                 "or logits off the plain versions'")
        launches[vname] = wrappers[kname].launches
        log(f"serve {label}: main path launches {kname} "
            f"{wrappers[kname].launches}")
        request_times(torch, eng, label, reqs, smi)
        eng = None
        torch.cuda.empty_cache()

    feat, lens = reqs[1]                               # 4x1000
    refs = {}
    for label, settings, tree, ref_settings in PLAIN_STAGE_ENGINES:
        eng = Engine(cfg, trees[tree], EngineConfig(**settings),
                     device="cuda", cuda_graphs=False)
        key = tuple(sorted(ref_settings.items()))
        if key not in refs:
            refs[key] = Engine(cfg, trees[tree], EngineConfig(**ref_settings),
                               device="cuda", cuda_graphs=False)
        valid, rvalid, got, _ = served_valid(eng, refs[key], moe_mod, feat,
                                             lens)
        ok, rel, held = judge(valid, rvalid,
                              settings["dtype"] == "float32")
        ok = ok and not got
        log(f"serve {label} 4x1000: stage {eng.moe_impl_for(4, 1000)} "
            f"(plain PyTorch), expert kernel launches {got or 'none'}; vs "
            f"moe_impl={ref_settings['moe_impl']!r}, routing pinned: "
            f"max|diff|/max|ref|={rel:.3e}, held to {held} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"FAIL serve {label}: a kernel launched or the "
                             "logits are off the reference stage's")
        request_times(torch, eng, label, [reqs[1]], smi)
        eng = None
    refs = None
    torch.cuda.empty_cache()

    # dense_quant + fuse_qkv: int8 dense kernels, one fused q/k/v product
    feat, lens = reqs[0]                               # 1x206
    eng = Engine(cfg, trees["int4"], EngineConfig(
        dtype="int4", dense_quant=True, fuse_qkv=True), device="cuda",
        cuda_graphs=False)
    sa = eng.params["blocks"]["self_attn"]
    if "linear_q" in sa or sa["linear_qkv"]["kernel_q"].dtype != torch.int8:
        raise SystemExit("FAIL serve dense_quant+fuse_qkv: params not "
                         "fused and quantized")
    deq = Engine(cfg, dequantize_dense_params(eng.params, torch.bfloat16),
                 EngineConfig(dtype="int4"), device="cuda", cuda_graphs=False)
    valid, rvalid, got, _ = served_valid(eng, deq, moe_mod, feat, lens)
    ok, rel, held = judge(valid, rvalid, False)
    ok = ok and got == {"K6": n_blocks}
    plain_eng = Engine(cfg, trees["int4"], EngineConfig(dtype="int4"),
                       device="cuda", cuda_graphs=False)
    _, pvalid, _, _ = served_valid(eng, plain_eng, moe_mod, feat, lens)
    prel = float(np.abs(valid - pvalid).max() / np.abs(pvalid).max())
    log(f"serve int4+dense_quant+fuse_qkv 1x206: launches per forward {got}"
        f"; vs the int4 engine on the same fused weights dequantized "
        f"(routing pinned): max|diff|/max|ref|={rel:.3e}, held to {held}; "
        f"vs the int4 engine on the unquantized, unfused dense weights "
        f"(routing pinned, information): max|diff|/max|ref|={prel:.3e}, "
        f"argmax agree {float((valid.argmax(-1) == pvalid.argmax(-1)).mean()):.4f}"
        f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL serve int4+dense_quant+fuse_qkv: wrong "
                         "launches or logits off the dequantized engine's")
    request_times(torch, eng, "int4+dense_quant+fuse_qkv", [reqs[0]], smi)
    eng = deq = plain_eng = None
    torch.cuda.empty_cache()
    return launches


def valid_rows(a, out_len):
    return np.concatenate([a[b, :out_len[b]] for b in range(len(out_len))])


def reset_flash(flash_kernels):
    flash_kernels.fwd_launches = flash_kernels.dq_launches = \
        flash_kernels.dkv_launches = 0


def phase_serve_flash(torch, state, smi):
    """The fp32 and bf16 engines with attn_impl="flash" answer the
    requests: each forward launches K2 once per attention layer (24) and
    K1 once per MoE block (18); the logits are held to the same engine
    with attn_impl="xla" (phase 4's), its tokens sent to the flash run's
    experts: fp32 allclose(1e-5, 1e-3), bf16 max|diff| <= 0.05 max|ref|.
    Returns K2's launches per dtype."""
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    from m3asr_tpu_torch.ops.moe_runs import runs_kernel
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg, reqs, truth = state["cfg"], state["requests"], state["truth"]
    enc = cfg.encoder_conf
    n_attn, n_moe = enc.embed_conf.num_blocks + enc.num_blocks, enc.num_blocks
    launches = {}
    for dtype in ("float32", "bfloat16"):
        eng = Engine(cfg, state["params"], EngineConfig(
            dtype=dtype, attn_impl="flash"), device="cuda", cuda_graphs=False)
        xla = state["engines"][dtype][0]
        reset_flash(flash_kernels)        # this run starts here
        runs_kernel.launches = 0
        for i, (feat, lens) in enumerate(reqs):
            f0, k0 = flash_kernels.fwd_launches, runs_kernel.launches
            with GateRecorder(moe_mod) as rec:
                out, out_len = eng.infer(feat, lens)
            got = (flash_kernels.fwd_launches - f0, runs_kernel.launches - k0)
            with GateRecorder(moe_mod, replay=rec.calls):
                ref, ref_len = xla.infer(feat, lens)
            if not (np.array_equal(out_len, ref_len)
                    and np.isfinite(out).all()):
                raise SystemExit("FAIL serve flash: lengths differ or logits "
                                 "are not finite")
            valid, rvalid = valid_rows(out, out_len), valid_rows(ref, out_len)
            rel = float(np.abs(valid - rvalid).max() / np.abs(rvalid).max())
            agree = float((valid.argmax(-1) == rvalid.argmax(-1)).mean())
            t = truth[i]
            if dtype == "float32":
                ok = np.allclose(valid, rvalid, rtol=1e-5, atol=1e-3)
                held = "allclose(1e-5, 1e-3)"
            else:
                ok = rel <= 0.05
                held = "max|diff|/max|ref| <= 0.05"
            ok = ok and got == (n_attn, n_moe)
            B, T = feat.shape[:2]
            log(f"serve {dtype}+flash {B}x{T}: K2 calls {got[0]} (want "
                f"{n_attn}), K1 calls {got[1]} (want {n_moe}); vs "
                f"attn_impl='xla' on the flash run's experts: max|diff|/"
                f"max|ref|={rel:.3e}, argmax agree={agree:.4f}, held to "
                f"{held}; vs the free-running fp32 xla logits: "
                f"max|diff|/max|ref| "
                f"{float(np.abs(valid - t).max() / np.abs(t).max()):.3e}, "
                f"argmax agree "
                f"{float((valid.argmax(-1) == t.argmax(-1)).mean()):.4f} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("FAIL serve flash: wrong launches or logits "
                                 "off the xla path's")
        launches[dtype] = flash_kernels.fwd_launches
        log(f"serve {dtype}+flash: main path launches K2 "
            f"{flash_kernels.fwd_launches}, K1 {runs_kernel.launches}")
        request_times(torch, eng, f"{dtype}+flash", reqs, smi)
        eng = None
    torch.cuda.empty_cache()
    return launches


# engines of phase "serve, graphs": (label, EngineConfig settings, the
# params they start from, the kernel each request's forward launches once
# per MoE block: phases 4-7's policy)
GRAPH_ENGINES = (
    ("float32", dict(dtype="float32"), "float", ("K1",) * 3),
    ("bfloat16", dict(dtype="bfloat16"), "float", ("K1",) * 3),
    ("int8", dict(dtype="int8"), "int8", QUANT_EXPECT["int8"]),
    ("w8a8", dict(dtype="int8", act_quant=True), "int8",
     QUANT_EXPECT["int8"]),
    ("int4", dict(dtype="int4"), "int4", QUANT_EXPECT["int4"]),
    ("w4a8", dict(dtype="int4", act_quant=True), "int4",
     QUANT_EXPECT["int4"]),
    ("float32+flash", dict(dtype="float32", attn_impl="flash"), "float",
     ("K1",) * 3),
    ("bfloat16+flash", dict(dtype="bfloat16", attn_impl="flash"), "float",
     ("K1",) * 3),
    ("float32 pallas", dict(dtype="float32", moe_impl="pallas"), "float",
     ("K8",) * 3),
    ("int4 tiled", dict(dtype="int4", moe_impl="tiled"), "int4",
     ("K7",) * 3),
)
LONG_FRAMES = 15000          # infer_long's request: 3 windows of 6144
EAGER_TIMED = ("float32", "bfloat16")    # phase 8's eager timings
# the auto engines whose graph replays give the bucket tuner's points
TUNER_MODES = ("float32", "bfloat16", "int8", "w8a8", "int4", "w4a8")
DECODE_TOPK = 8              # K of "topk", the beam width of "beam"


def kernel_counts():
    """Every expert kernel's launches and K2's, the nonzero ones."""
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    counts = {k: w.launches for k, w in stage_wrappers().items()}
    counts["K2"] = flash_kernels.fwd_launches
    return {k: v for k, v in counts.items() if v}


def reset_counts():
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    for w in stage_wrappers().values():
        w.launches = 0
    reset_flash(flash_kernels)


def serve_times(torch, eng, feat, lens, runs=5):
    """The request through eng.infer: median host latency of ``runs``
    requests, peak device memory (allocated and reserved), and under
    torch.profiler the device time of one request, its device events and
    the part of it in device-to-host copies. With a CUDA graph, also the
    median of 5 replays alone timed by CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng.infer(feat, lens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(runs):
        t0 = time.perf_counter()
        eng.infer(feat, lens)
        lat.append((time.perf_counter() - t0) * 1e3)
    r = {"lat": float(np.median(lat)), "lat_min": min(lat),
         "lat_max": max(lat),
         "alloc": torch.cuda.max_memory_allocated() / 2**30,
         "reserved": torch.cuda.max_memory_reserved() / 2**30}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.infer(feat, lens)
    dev = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    r["dev"] = sum(us for _, us in dev) / 1e3
    r["events"] = len(dev)
    r["d2h"] = sum(us for n, us in dev if "DtoH" in n) / 1e3
    prog = eng.get_fn(*eng.buckets.pick(*feat.shape[:2]))
    r["replay"] = None if prog.graph is None else replay_ms(torch, prog)
    return r


def replay_ms(torch, prog):
    """Median of 5 replays of a captured program, timed by CUDA events."""
    ms = []
    for _ in range(5):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        prog.run()
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    return float(np.median(ms))


def times_line(label, B, T, path, r, smi):
    replay = ("" if r["replay"] is None else
              f", graph replay {r['replay']:.3f} ms by CUDA events")
    return (f"graphs {label} {B}x{T} {path}: latency median {r['lat']:.3f} "
            f"ms (min {r['lat_min']:.3f}, max {r['lat_max']:.3f}, 5 runs), "
            f"device {r['dev']:.3f} ms under torch.profiler ({r['events']} "
            f"events), busy {r['dev'] / r['lat']:.3f}, D2H {r['d2h']:.3f} "
            f"ms, peak {r['alloc']:.3f} GiB allocated / {r['reserved']:.3f} "
            f"GiB reserved{replay}; {smi}")


def layout_prep_ms(torch, n_tokens, d, dtype):
    """Device time of K1's layout prep alone (runs_layout, padding the
    tokens into tiles and back) for one forward's 18 MoE blocks, captured
    in a CUDA graph on a router's routing and timed by CUDA events over
    the replays (median of 5)."""
    from m3asr_tpu_torch.ops.moe_runs import (TILE, _pad_tokens, _unpad,
                                              runs_layout)
    gen = torch.Generator(device="cuda").manual_seed(14)
    gate = routing(torch, "router", n_tokens, gen).reshape(-1)
    x = torch.randn(n_tokens, d, generator=gen, device="cuda").to(dtype)

    def prep():
        for _ in range(L):
            lay = runs_layout(gate, E, TILE)
            _unpad(_pad_tokens(x, lay, TILE), lay)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        prep()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        prep()
    ms = []
    for _ in range(5):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    return float(np.median(ms))


def phase_serve_graphs(torch, state, smi):
    """Every serving mode through the CUDA-graph path (Engine.get_fn):
    each request's bucket is captured, its kernels counted at capture
    ((GRAPH_WARMUP_RUNS + 1) forwards of 18 MoE-block launches, 24 K2
    with flash) and at no replay; no captured stage may run eager; the
    graph's outputs must be bit-equal to the same engine's eager forward.
    Graph (and for EAGER_TIMED, eager) latency, device time, busy share,
    D2H time and peak memory per request; the bf16 argmax and topk outputs held to the
    logits, the fp32 beam search to the host search; infer_long on 15000
    frames (fp32, int4); the fp32 engine's whole 24-bucket warm-up."""
    from m3asr_tpu_torch.ops.moe import HOST_SYNC_STAGES
    from m3asr_tpu_torch.ops.moe_runs import runs_kernel
    from m3asr_tpu_torch.ops.masking import subsampling4_length
    from m3asr_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                GRAPH_WARMUP_RUNS)

    cfg, reqs = state["cfg"], state["requests"]
    trees = {"float": state["params"], **state["qparams"]}
    enc = cfg.encoder_conf
    n_attn, n_moe = enc.embed_conf.num_blocks + enc.num_blocks, enc.num_blocks
    fwds = GRAPH_WARMUP_RUNS + 1
    long_feat = np.random.default_rng(3).standard_normal(
        (1, LONG_FRAMES, cfg.input_dim)).astype(np.float32)
    for label, settings, tree, expect in GRAPH_ENGINES:
        eng = Engine(cfg, trees[tree], EngineConfig(**settings),
                     device="cuda")
        flash = settings.get("attn_impl") == "flash"
        points = {}
        for i, (feat, lens) in enumerate(reqs):
            B, T = feat.shape[:2]
            bb, bt = eng.buckets.pick(B, T)
            stage = eng.moe_impl_for(bb, bt)
            want = {expect[i]: n_moe} if expect[i] else {}
            if flash:
                want["K2"] = n_attn
            reset_counts()                 # this capture starts here
            t0 = time.perf_counter()
            prog = eng.get_fn(bb, bt)
            cap_s = time.perf_counter() - t0
            at_capture = kernel_counts()
            reset_counts()
            out_g = eng.infer(feat, lens)
            at_replay = kernel_counts()
            eng.cuda_graphs = False
            reset_counts()
            out_e = eng.infer(feat, lens)
            at_eager = kernel_counts()
            eng.cuda_graphs = True
            equal = len(out_g) == len(out_e) and all(
                a.dtype == b.dtype and np.array_equal(a, b)
                for a, b in zip(out_g, out_e))
            ok = (prog.graph is not None and stage not in HOST_SYNC_STAGES
                  and at_capture == {k: v * fwds for k, v in want.items()}
                  and not at_replay and at_eager == want and equal
                  and np.isfinite(out_g[0]).all())
            log(f"graphs {label} {B}x{T}: stage {stage}, bucket {bb}x{bt} "
                f"captured in {cap_s:.2f} s with launches {at_capture} "
                f"({fwds} forwards: {GRAPH_WARMUP_RUNS} warm-up, 1 "
                f"captured; want {want} a forward), replay launches "
                f"{at_replay or 'none'}, eager launches {at_eager}; graph "
                f"logits bit-equal to the eager forward's: {equal} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"FAIL serve graphs {label} {B}x{T}: capture"
                                 ", launches or logits off the eager path")
            # eager timings for the main path's engines only (phases 4-7
            # time every mode's eager forward)
            for path in (("eager", "graph") if label in EAGER_TIMED
                         else ("graph",)):
                eng.cuda_graphs = path == "graph"
                r = serve_times(torch, eng, feat, lens)
                log(times_line(label, B, T, path, r, smi))
            eng.cuda_graphs = True
            state.setdefault("graph_times", {})[(label, (B, T))] = r
            points[(B, T)] = r["replay"]
            if label == "bfloat16" and (B, T) == (4, 1000):
                decode_outputs(torch, eng, feat, lens, out_g, smi)
            if label == "float32" and (B, T) == (4, 1000):
                decode_beam(torch, eng, feat, lens, smi)
        if label in TUNER_MODES:
            # the bucket tuner's points (runtime/bucket_tuner.py)
            top = eng.buckets.lengths[-1]
            log(f"graphs {label} tuner points: graph replay by CUDA events "
                f"(median of 5) 1x206 {points[(1, 206)]:.3f} ms, 1x2048 "
                f"{points[(1, 2048)]:.3f} ms, 1x{top} "
                f"{replay_ms(torch, eng.get_fn(1, top)):.3f} ms; {smi}")
        if label in ("float32", "int4"):
            t0 = time.perf_counter()
            first = eng.infer_long(long_feat)
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = eng.infer_long(long_feat)
            again_s = time.perf_counter() - t0
            n = int(subsampling4_length(LONG_FRAMES))
            ok = (int(res[1][0]) == n
                  and res[0].shape == (1, n, cfg.output_dim)
                  and np.isfinite(res[0]).all()
                  and all(np.array_equal(a, b) for a, b in zip(first, res)))
            log(f"graphs {label} infer_long 1x{LONG_FRAMES}: out_len "
                f"{int(res[1][0])} (want {n}), logits {res[0].shape} finite, "
                f"first call {first_s:.3f} s (captures 1x"
                f"{eng.buckets.lengths[-1]}), then {again_s * 1e3:.3f} ms; "
                f"{smi} {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"FAIL serve graphs {label} infer_long")
        if label == "float32":
            for (B, T), n in zip(REQUESTS, (63, 1020, 511)):
                prep = layout_prep_ms(torch, n, D, torch.float32)
                log(f"graphs layout prep {B}x{T} ({n} tokens, float32): "
                    f"{prep:.3f} ms of device time for 18 MoE blocks "
                    f"(runs_layout and the tile padding, in a CUDA graph, "
                    f"CUDA events); {smi}")
        eng = None
        torch.cuda.empty_cache()

    # the fp32 engine's whole bucket ladder, captured
    eng = Engine(cfg, trees["float"], EngineConfig(dtype="float32"),
                 device="cuda")
    n_buckets = len(eng.buckets.all_buckets())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs_kernel.launches = 0
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ok = runs_kernel.launches == n_buckets * fwds * n_moe and all(
        eng.get_fn(b, t).graph is not None
        for b, t in eng.buckets.all_buckets())
    log(f"graphs float32 warmup(): {n_buckets} buckets captured in "
        f"{secs:.2f} s, K1 launches {runs_kernel.launches} (want "
        f"{n_buckets * fwds * n_moe}), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB allocated / "
        f"{torch.cuda.max_memory_reserved() / 2**30:.3f} GiB reserved; {smi} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL serve graphs: the ladder's warm-up")
    eng = None
    torch.cuda.empty_cache()


def decode_outputs(torch, eng, feat, lens, logits_out, smi):
    """The bf16 engine's argmax and topk (K=8) outputs at one request (its
    4x1000), through graphs, held to its logits (logits_out, widened
    exactly from bf16) reduced on the host in float64: argmax ids equal
    wherever the top two log-probs are not tied, best log-probs and top-K
    values within 1e-6 (a float32 log-softmax on the card), every top-K
    index naming its value. Prints the bytes each mode copies back, its
    times, and the host's part of copying these logits back."""
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    logits, out_len = logits_out[0], logits_out[1]
    B, T = feat.shape[:2]
    x = logits.astype(np.float64)
    lp64 = x - x.max(-1, keepdims=True)
    lp64 -= np.log(np.exp(lp64).sum(-1, keepdims=True))
    valid = np.arange(lp64.shape[1])[None] < out_len[:, None]
    top = -np.sort(-lp64, axis=-1)[..., :DECODE_TOPK]
    tol = 1e-6
    nbytes = {"logits": logits.size * 2}
    res = {}
    for mode in ("argmax", "topk"):
        m = Engine(eng.model_cfg, eng.params, EngineConfig(
            dtype="bfloat16", decode_output=mode, decode_topk=DECODE_TOPK),
            device="cuda")
        res[mode] = m.infer(feat, lens)
        nbytes[mode] = sum(a.nbytes for j, a in enumerate(res[mode]) if j != 1)
        log(times_line(f"bfloat16 decode_output={mode}", B, T, "graph",
                       serve_times(torch, m, feat, lens), smi))
        m = None
    ids, _, best = res["argmax"]
    untied = valid & (top[..., 0] != top[..., 1])
    ok_ids = np.array_equal(ids[untied], lp64.argmax(-1)[untied])
    ok_best = (np.abs(best - top[..., 0]) <= tol)[valid].all()
    vals, _, idx = res["topk"]
    ok_vals = (np.abs(vals - top) <= tol)[valid].all()
    named = np.take_along_axis(lp64, idx.astype(np.int64), -1)
    ok_idx = (np.abs(vals - named) <= tol)[valid].all()
    err = float(np.abs(vals - top)[valid].max())
    ok = ok_ids and ok_best and ok_vals and ok_idx
    log(f"graphs bfloat16 decode outputs {B}x{T}: argmax ids equal on "
        f"{int(untied.sum())} untied of {int(valid.sum())} valid frames: "
        f"{ok_ids}, best log-prob within tolerance: {ok_best}; top-"
        f"{DECODE_TOPK} values within 1e-6: {ok_vals} "
        f"(max |diff| {err:.3e}), indices name their values: {ok_idx}; "
        "bytes copied back: " + ", ".join(f"{k} {v}" for k, v in
                                          nbytes.items())
        + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL serve graphs: argmax or topk disagrees with "
                         "the logits")
    # the host's part of infer's copy-back of these logits: widening the
    # bf16 bits in numpy and in torch (Engine.infer's way, on the host's
    # cores), and a float32 engine's copy of the same count in numpy and
    # in torch (Engine.infer's)
    bits = np.random.default_rng(15).integers(
        0, 2**15, logits.shape, dtype=np.uint16)
    f32 = np.zeros(logits.shape, np.float32)
    host = {}
    for name, fn in (
            ("numpy widen", lambda: (bits.astype(np.uint32) << 16)
             .view(np.float32)),
            ("torch widen", lambda: torch.from_numpy(bits.view(np.int16))
             .view(torch.bfloat16).float().numpy()),
            ("numpy float32 copy", lambda: f32.astype(np.float32)),
            ("torch float32 copy",
             lambda: torch.from_numpy(f32).clone().numpy())):
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        host[name] = float(np.median(ms))
    log(f"graphs host copy-back of {B}x{T}'s logits {logits.shape} "
        "(median of 5): " + ", ".join(f"{k} {v:.3f} ms"
                                      for k, v in host.items()))


def decode_beam(torch, eng, feat, lens, smi):
    """The fp32 engine's on-device beam search (width 8) at one request
    (its 4x1000), through a graph: each utterance's best hypothesis and
    score (within 1e-4 relative) equal to the host prefix beam search on
    the card's log-probs (the log_softmax mode's); the share of the host
    n-best the card's n-best holds is printed. In float32, because bf16
    logits hold exact ties, at which the two searches keep different
    equally scored prefixes."""
    from m3asr_tpu_torch.decode.ctc import ctc_prefix_beam_search
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    B, T = feat.shape[:2]
    res = {}
    for mode in ("beam", "log_softmax"):
        m = Engine(eng.model_cfg, eng.params, EngineConfig(
            dtype="float32", decode_output=mode, decode_topk=DECODE_TOPK),
            device="cuda")
        res[mode] = m.infer(feat, lens)
        if mode == "beam":
            log(times_line("float32 decode_output=beam", B, T, "graph",
                           serve_times(torch, m, feat, lens), smi))
        m = None
    hyp_ids, out_len, hyp_lens, scores = res["beam"]
    lp = res["log_softmax"][0]
    agree, total, ok = 0, 0, True
    for b in range(B):
        host = ctc_prefix_beam_search(lp[b], int(out_len[b]), DECODE_TOPK)
        dev = [(tuple(hyp_ids[b, j, :hyp_lens[b, j]].tolist()),
                float(scores[b, j])) for j in range(DECODE_TOPK)
               if np.isfinite(scores[b, j])]
        ok &= (dev[0][0] == host[0][0]
               and abs(dev[0][1] - host[0][1]) <= 1e-4 * abs(host[0][1]))
        hmap = dict(host)
        agree += sum(p in hmap and abs(s - hmap[p]) <= 1e-4 * abs(hmap[p])
                     for p, s in dev)
        total += len(host)
    nbytes = sum(a.nbytes for j, a in enumerate(res["beam"]) if j != 1)
    log(f"graphs float32 beam {DECODE_TOPK} {B}x{T}: best hypothesis and "
        f"score equal to the host search's on the card's log-probs for all "
        f"{B} utterances: {ok}; n-best agreement {agree}/{total}; bytes "
        f"copied back {nbytes} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL serve graphs: the on-device beam search "
                         "disagrees with the host search")


# phase "stream": the flagship's chunk streams (models/streaming.py, the
# sessions and batchers of runtime/) and the port's server
STREAM_SLOTS, STREAM_CHUNK, STREAM_LEFT = 8, 16, 2
STREAM_FRAMES = (1200, 1131, 1010, 917, 763, 640, 488, 300)
STREAM_PIECES = (37, 90, 13, 211, 64, 150)     # uneven pieces, cycled
SESSION_CHECKED = (0, 2, 4, 6)   # streams also run by eager sessions
# (label, EngineConfig settings, the params they start from, the kernel
# of the chunk programs' expert stage, serve's policy at 16 x 8 tokens)
STREAM_MODES = (("float32", dict(dtype="float32"), "float", "K1", "runs_f"),
                ("bfloat16", dict(dtype="bfloat16"), "float", "K1",
                 "runs_f"),
                ("int4", dict(dtype="int4"), "int4", "K6", "quant4_pallas"))
# the offline oracle's expert stage (any length): K1, or K5 on int4
ORACLE_IMPL = {"float32": "runs_f", "bfloat16": "runs_f",
               "int4": "quant4_runs"}
STREAM_TOKENS = (16, 128)     # one stream's chunk; a tick of 8 slots
SERVE_SETTINGS = dict(dtype="bfloat16", bucket_lengths=(256, 512, 1024,
                                                        2048),
                      bucket_batches=(1, 2))


def stream_windows(feat, chunk):
    """The windows a StreamingSession cuts from one (T, D) stream, however
    it is pushed: full windows of 4 * chunk + 3 frames at stride
    4 * chunk, then finish()'s zero-padded tail. [(window (1, W, D),
    output frames kept)]."""
    W, S = 4 * chunk + 3, 4 * chunk
    out, i = [], 0
    while feat.shape[0] - i >= W:
        out.append((feat[None, i:i + W], chunk))
        i += S
    rest = feat.shape[0] - i
    if rest >= 7 and (rest - 3) // 4 > 0:
        w = np.zeros((1, W, feat.shape[1]), np.float32)
        w[0, :rest] = feat[i:]
        out.append((w, (rest - 3) // 4))
    return out


def batched_ticks(b, streams, ticks=None, before_tick=None):
    """Drive StreamBatcher ``b`` tick by tick: stream i in slot i from
    tick i, one window a tick. ``ticks``: only these ticks, from the state
    the caller left in the slots (by default every tick, from zeroed
    slots); ``before_tick(t)`` runs before each tick. Returns (each
    stream's kept outputs (frames, V) of the ticks run, every tick's
    (slots, C, V) output, tick times in ms by the host clock)."""
    from m3asr_tpu_torch.runtime.graphs import DEVICE_LOCK
    W, D = streams[0][0][0].shape[1:]
    if ticks is None:
        ticks = range(max(i + len(s) for i, s in enumerate(streams)))
        with DEVICE_LOCK.shared():
            b._reset_slots(range(b.slots))
    outs = [[] for _ in streams]
    raw, ms = [], []
    for t in ticks:
        if before_tick is not None:
            before_tick(t)
        windows = np.zeros((b.slots, W, D), np.float32)
        mask = np.zeros((b.slots,), bool)
        for i, s in enumerate(streams):
            if 0 <= t - i < len(s):
                windows[i], mask[i] = s[t - i][0][0], True
        t0 = time.perf_counter()
        with DEVICE_LOCK.shared():
            out = b._tick(windows, mask)
        ms.append((time.perf_counter() - t0) * 1e3)
        raw.append(out)
        for i, s in enumerate(streams):
            if 0 <= t - i < len(s):
                outs[i].append(out[i, :s[t - i][1]])
    return [np.concatenate(o) if o else None for o in outs], raw, ms


def pieces_of(T):
    """Uneven piece sizes covering T frames."""
    out, k = [], 0
    while sum(out) < T:
        out.append(min(STREAM_PIECES[k % len(STREAM_PIECES)], T - sum(out)))
        k += 1
    return out


def session_run(sess, feat):
    """One stream through a single StreamingSession (reset first), pushed
    in uneven pieces, then finish(). Returns (outputs (frames, V), each
    chunk's outputs, ms per chunk of the pushes that emitted chunks)."""
    sess.reset()
    chunks, per_chunk, i = [], [], 0
    for n in pieces_of(feat.shape[0]):
        t0 = time.perf_counter()
        got = sess.push(feat[None, i:i + n])
        if got:
            per_chunk.append((time.perf_counter() - t0) * 1e3 / len(got))
        chunks += got
        i += n
    chunks += sess.finish()
    return np.concatenate([c[0] for c in chunks]), chunks, per_chunk


def stream_routing(rec_calls, n_blocks, tick_of, slot):
    """A stream's expert choices (n_blocks, frames) from a GateRecorder of
    a batched run: chunk c of the stream ran at tick tick_of(c) in
    ``slot``."""
    n_ticks = len(rec_calls) // n_blocks
    rows = [[] for _ in range(n_blocks)]
    for c in range(n_ticks):
        t = tick_of(c)
        if t is None:
            break
        for blk in range(n_blocks):
            rows[blk].append(rec_calls[t * n_blocks + blk][slot])
    return rows


def routing_frames(rows, n):
    """stream_routing's rows as one (n_blocks, n) array of its first n
    frames."""
    return np.stack([np.concatenate([x.reshape(-1).cpu().numpy()
                                     for x in r])[:n] for r in rows])


def held(a, ref, fp32):
    """fp32: allclose(1e-5, 1e-3); else max|diff| / max|ref| <= 0.05.
    Returns (ok, max|diff| / max|ref|)."""
    rel = float(np.abs(a - ref).max() / np.abs(ref).max())
    ok = (np.allclose(a, ref, rtol=1e-5, atol=1e-3) if fp32
          else rel <= 0.05)
    return ok, rel


def write_arpa(path, V, seed):
    """A seeded random bigram ARPA over unit ids 0..V-1."""
    rng = np.random.default_rng(seed)
    bigrams = sorted({(int(a), int(b)) for a, b in
                      rng.integers(1, V, (2000, 2))})
    with open(path, "w") as f:
        f.write(f"\\data\\\nngram 1={V + 1}\nngram 2={len(bigrams)}\n\n"
                "\\1-grams:\n")
        f.write(f"-99 <s> {rng.uniform(-1, 0):.4f}\n")
        for u in range(1, V):
            f.write(f"{rng.uniform(-5, -2):.4f} {u} "
                    f"{rng.uniform(-1, 0):.4f}\n")
        f.write(f"{rng.uniform(-3, -1):.4f} </s>\n\n\\2-grams:\n")
        for a, b in bigrams:
            f.write(f"{rng.uniform(-2, -0.1):.4f} {a} {b}\n")
        f.write("\n\\end\\\n")


def rotated_device_ms(torch, fn, iters):
    """profiled_ms of fn(i) with i counting up across calls (layers
    rotate as in cuda_time_ms): the device time of one call."""
    calls = iter(range(10 ** 9))
    return profiled_ms(torch, lambda: fn(next(calls)), iters)


def stream_kernel_check(torch, got, ref, fp32, tol, label):
    """A stream-count launch against its plain version on the same
    inputs: fp32 allclose(1e-5, 1e-5), else max|diff| within ``tol`` of
    max|ref| (phase_kernel's and phase_kernel_quant's tolerances). Logs
    one line, exits on a failure; returns max|diff|."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = np.isfinite(err) and (
        torch.allclose(got, ref, rtol=1e-5, atol=1e-5) if fp32
        else err <= tol * scale)
    log(f"kernel {label}: max_abs_err={err:.3e} max|ref|={scale:.3e} "
        f"({'allclose(1e-5, 1e-5)' if fp32 else f'held to {tol:g} of it'})"
        f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"FAIL kernel: {label} disagrees with its plain "
                         "version")
    return err


def k1_at_shapes(torch, dtype, shapes, gen, smi, what):
    """K1 at the main path's (B, T') shapes under the router's routing,
    layers rotated: at each shape held against its plain version on the
    same inputs at layers 0 and L-1 (stream_kernel_check), then the
    wrapper call (CUDA events) and its device time (torch.profiler), the
    plain version and the bound, logged as "time <what> ...". Returns
    the worst max_abs_err and {(B, T'): row}."""
    from m3asr_tpu_torch.ops import moe_runs
    dname = str(dtype)[6:]
    p = expert_weights(torch, dtype, gen, d=D, h=H)
    worst, rows = 0.0, {}
    for B, T in shapes:
        n = B * T
        x = torch.randn(B, T, D, generator=gen, device="cuda").to(dtype)
        gate = routing(torch, "router", n, gen).reshape(B, T)
        elt = x.element_size()
        t_bytes = (n_active(torch, gate) * (2 * D * H + H + D) * elt
                   + 2 * n * D * elt + n * 4) / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * n * D * H / PEAK_OPS_PER_S[dname] * 1e3
        shape = f"n={n}" if B == 1 else f"{B}x{T}={n} tok"
        for layer in (0, L - 1):
            got = moe_runs.runs_kernel.launch(p, x, gate, layer)
            torch.cuda.synchronize()
            err = stream_kernel_check(
                torch, got, moe_runs.moe_experts_runs_reference(
                    p, x, gate, layer), dtype == torch.float32, 1e-2,
                f"moe_runs_f {dname} (K1) {shape} router layer={layer}")
            worst = max(worst, err)
        ms = cuda_time_ms(torch, lambda i: moe_runs.runs_kernel.launch(
            p, x, gate, i % L), 54)
        dev = rotated_device_ms(torch, lambda i: (
            moe_runs.runs_kernel.launch(p, x, gate, i % L)), 18)
        plain = cuda_time_ms(
            torch, lambda i: moe_runs.moe_experts_runs_reference(
                p, x, gate, i % L), 18)
        rows[(B, T)] = dict(ms=ms, device_ms=dev, plain_ms=plain,
                            bound_ms=max(t_bytes, t_ops))
        log(f"time {what} moe_runs_f[{dname}] (K1) {shape} router: call "
            f"{ms:.4f} ms (device {dev:.4f} ms), plain {plain:.4f} ms, "
            f"bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f} / "
            f"ops {t_ops:.4f}), library_ms none; {smi}")
    return worst, rows


def time_stream_kernels(torch, smi):
    """K1 (fp32, bf16) and K6 (int4, w4a8) at a stream chunk's and an
    8-slot tick's token counts (16, 128) under the router's routing,
    layers rotated: each first held against its plain version on the
    same inputs (stream_kernel_check), then the wrapper call (CUDA
    events) and its device time (torch.profiler), the plain version and
    the bound. Returns the worst max_abs_err under the keys of
    phase_kernel (dtype name) and phase_kernel_quant (("K6", a8))."""
    from m3asr_tpu_torch.ops import moe_q4
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst[str(dtype)[6:]] = k1_at_shapes(
            torch, dtype, [(1, n) for n in STREAM_TOKENS], gen, smi,
            "stream")[0]
    n_layers = 6
    p = quant_experts(torch, 4, gen, n_layers, d=D, h=H)
    layers = [at_layer(p, i) for i in range(n_layers)]
    per_expert = (p["w1_q4"][0, 0].numel() + p["w2_q4"][0, 0].numel()
                  + 4 * (layers[0]["w1_scale"][0].numel()
                         + layers[0]["w2_scale"][0].numel()) + 2 * (H + D))
    for a8 in (False, True):
        for n in STREAM_TOKENS:
            x = torch.randn(1, n, D, generator=gen, device="cuda") \
                .to(torch.bfloat16)
            gate = routing(torch, "router", n, gen)
            t_bytes = (n_active(torch, gate) * per_expert + 2 * n * D * 2
                       + n * 4) / HBM_BYTES_PER_S * 1e3
            t_ops = 4 * n * D * H / PEAK_OPS_PER_S[
                "int8" if a8 else "bfloat16"] * 1e3
            for layer in (0, n_layers - 1):
                got = moe_q4.q4_kernel.launch(layers[layer], x, gate, layer,
                                              act_quant=a8)
                torch.cuda.synchronize()
                err = stream_kernel_check(
                    torch, got, moe_q4.moe_experts_q4_reference(
                        layers[layer], x, gate, layer, act_quant=a8),
                    False, 2e-2 if a8 else 1e-2,
                    f"{QUANT_NAMES[('K6', a8)]} (K6) n={n} router "
                    f"layer={layer}")
                worst[("K6", a8)] = max(worst.get(("K6", a8), 0.0), err)
            ms = cuda_time_ms(torch, lambda i: moe_q4.q4_kernel.launch(
                layers[i % n_layers], x, gate, i % n_layers, act_quant=a8),
                60)
            dev = rotated_device_ms(torch, lambda i: moe_q4.q4_kernel.launch(
                layers[i % n_layers], x, gate, i % n_layers, act_quant=a8),
                18)
            plain = cuda_time_ms(torch, lambda i: (
                moe_q4.moe_experts_q4_reference(
                    layers[i % n_layers], x, gate, i % n_layers,
                    act_quant=a8)), 6)
            log(f"time stream {QUANT_NAMES[('K6', a8)]} (K6) n={n} router: "
                f"call {ms:.4f} ms (device {dev:.4f} ms), plain "
                f"{plain:.4f} ms, bound "
                f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f} / ops "
                f"{t_ops:.4f}), library_ms none; {smi}")
    return worst


def stream_mode(torch, label, eng, cfg, cfg_c, feats, kname, want_impl, smi):
    """The checks of phase "stream" for one engine mode; returns the
    launches of its kernel."""
    import m3asr_tpu_torch.serve as serve
    from m3asr_tpu_torch.models import moe_conformer
    from m3asr_tpu_torch.models.conformer import chunk_attention_mask
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.moe import HOST_SYNC_STAGES
    from m3asr_tpu_torch.runtime.graphs import DEVICE_LOCK, GRAPH_WARMUP_RUNS
    from m3asr_tpu_torch.runtime.streaming_batch import StreamBatcher
    from m3asr_tpu_torch.runtime.streaming_session import StreamingSession

    fp32 = label == "float32"
    n_moe = cfg.encoder_conf.num_blocks
    fwds = GRAPH_WARMUP_RUNS + 1
    params = serve.stream_params(eng)
    impl = serve._stream_moe_impl(eng, STREAM_SLOTS)
    if impl != want_impl or impl in HOST_SYNC_STAGES:
        raise SystemExit(f"FAIL stream {label}: stage {impl}, want "
                         f"{want_impl}")
    streams = [stream_windows(f, STREAM_CHUNK) for f in feats]
    n_ticks = max(i + len(s) for i, s in enumerate(streams))
    kw = dict(chunk_size=STREAM_CHUNK, num_left_chunks=STREAM_LEFT,
              moe=True, moe_impl=impl)
    bkw = dict(kw, slots=STREAM_SLOTS, input_dim=cfg.input_dim)
    launched = 0

    def counted(want, what, main=False):
        """Hold the launches since the last reset to ``want``; the
        captures (the main path's programs) add to ``launched``."""
        nonlocal launched
        got = kernel_counts()
        if main:
            launched += got.get(kname, 0)
        if got != want:
            raise SystemExit(f"FAIL stream {label}: {what} launched {got}, "
                             f"want {want}")
        reset_counts()

    # the batched chunk program: captured (3 forwards counted), replayed
    # (none), against the same program eager (18 a tick), bit for bit
    reset_counts()
    b_g = StreamBatcher(params, cfg.encoder_conf, **bkw)
    if b_g.graph is None:
        raise SystemExit(f"FAIL stream {label}: no graph captured")
    counted({kname: fwds * n_moe}, "the batcher's capture", main=True)
    outs_b, raw_g, tick_g = batched_ticks(b_g, streams)
    counted({}, "the graph's replays")
    b_e = StreamBatcher(params, cfg.encoder_conf, cuda_graphs=False, **bkw)
    with GateRecorder(moe_mod) as rec_b:
        _, raw_e, tick_e = batched_ticks(b_e, streams)
    counted({kname: n_ticks * n_moe}, "the eager ticks")
    equal = all(np.array_equal(a, b) for a, b in zip(raw_g, raw_e))
    full = (np.zeros((STREAM_SLOTS,) + streams[0][0][0].shape[1:],
                     np.float32), np.ones((STREAM_SLOTS,), bool))

    def tick():
        with DEVICE_LOCK.shared():
            b_g._tick(*full)
    dev, events = profiled_events(torch, tick, 5)
    reset_counts()
    tg, te = float(np.median(tick_g)), float(np.median(tick_e))
    log(f"stream {label} batcher ({STREAM_SLOTS} slots, chunk "
        f"{STREAM_CHUNK}, left {STREAM_LEFT}, stage {impl}): {n_ticks} "
        f"ticks of {len(streams)} staggered streams; graph outputs "
        f"bit-equal to the eager step's: {equal}; median tick graph "
        f"{tg:.3f} ms, eager {te:.3f} ms (host clock); a graph tick's "
        f"device time {dev:.3f} ms under torch.profiler ({events // 5} "
        f"events), busy {dev / tg:.3f}; graph pool "
        f"{b_g.pool_bytes / 2**20:.1f} MiB reserved; {smi} "
        f"{'OK' if equal else 'FAIL'}")
    if not equal:
        raise SystemExit(f"FAIL stream {label}: graph ticks differ from "
                         "eager")
    b_g.close()
    b_e.close()

    # single-stream sessions (scalar offsets), pushed in uneven pieces:
    # graph against eager bit for bit, then the eager session pinned to
    # the batched run's experts against the batched outputs
    s_g = StreamingSession(params, cfg.encoder_conf, **kw)
    s_e = StreamingSession(params, cfg.encoder_conf, cuda_graphs=False, **kw)
    lat_g, lat_e, worst, flipped, frames = [], [], 0.0, 0, 0
    bit_equal, ok_all = True, True
    for i, f in enumerate(feats):
        out_g, chunks_g, pc = session_run(s_g, f)
        if i == 0:      # the capture at its first chunk, then replays
            counted({kname: fwds * n_moe}, "the session's capture and "
                    "replays", main=True)
        lat_g += pc
        ok_all &= out_g.shape == outs_b[i].shape
        if i not in SESSION_CHECKED:
            continue
        with GateRecorder(moe_mod) as rec_s:
            out_e, chunks_e, pc = session_run(s_e, f)
        lat_e += pc
        bit_equal &= len(chunks_g) == len(chunks_e) and all(
            np.array_equal(a, b) for a, b in zip(chunks_g, chunks_e))
        mine = stream_routing(rec_b.calls, n_moe,
                              lambda c: i + c if c < len(streams[i])
                              else None, i)
        free = stream_routing(rec_s.calls, n_moe, lambda c: c, 0)
        n = out_e.shape[0]
        flipped += int(np.any(routing_frames(mine, n)
                              != routing_frames(free, n), 0).sum())
        frames += n
        replay = [rec_b.calls[(i + c) * n_moe + blk][i:i + 1]
                  for c in range(len(streams[i])) for blk in range(n_moe)]
        with GateRecorder(moe_mod, replay=replay):
            out_p, _, _ = session_run(s_e, f)
        ok, rel = held(outs_b[i], out_p, fp32)
        worst = max(worst, rel)
        ok_all &= ok
    eager_chunks = sum(len(streams[i]) for i in SESSION_CHECKED)
    counted({kname: 2 * eager_chunks * n_moe},
            "the sessions' replays and two eager runs")
    log(f"stream {label} sessions: {len(feats)} streams of {STREAM_FRAMES} "
        f"frames in pieces of {STREAM_PIECES} through the graph, streams "
        f"{SESSION_CHECKED} also eager (free-running and pinned); graph "
        f"chunks bit-equal to eager: {bit_equal}; batched vs single session "
        f"on the batched run's experts: max|diff|/max|ref| {worst:.3e} "
        f"({'allclose(1e-5, 1e-3)' if fp32 else '<= 0.05'}); frames whose "
        f"expert differs in some block, free-running: {flipped} of "
        f"{frames}; chunk latency median graph {np.median(lat_g):.3f} ms, "
        f"eager {np.median(lat_e):.3f} ms (host clock); session graph "
        f"pool {s_g._prog.pool_bytes / 2**20:.1f} MiB reserved; {smi} "
        f"{'OK' if bit_equal and ok_all else 'FAIL'}")
    if not (bit_equal and ok_all):
        raise SystemExit(f"FAIL stream {label}: sessions")

    # the oracle: the causal flagship's streams against the offline
    # forward with the chunk attention mask, routing pinned to the
    # streams' experts, on every full chunk's frames
    b_o = StreamBatcher(params, cfg_c.encoder_conf, cuda_graphs=False, **bkw)
    with GateRecorder(moe_mod) as rec_o:
        outs_o, _, _ = batched_ticks(b_o, streams)
    b_o.close()
    T = max(STREAM_FRAMES)
    Tp = (T - 3) // 4
    feat_t = torch.zeros((len(feats), T, cfg.input_dim), device="cuda")
    for i, f in enumerate(feats):
        feat_t[i, :f.shape[0]] = torch.from_numpy(f).cuda()
    lens = torch.tensor([f.shape[0] for f in feats], dtype=torch.int32,
                        device="cuda")
    mask = chunk_attention_mask(Tp, STREAM_CHUNK, STREAM_LEFT,
                                device="cuda")
    dtype = eng.dtype
    with torch.inference_mode():
        with GateRecorder(moe_mod) as rec_f:
            moe_conformer.forward(params, cfg_c.encoder_conf,
                                  feat_t.to(dtype), lens,
                                  moe_impl=ORACLE_IMPL[label],
                                  chunk_mask=mask)
        replay = [g.clone() for g in rec_f.calls]
        for i, s in enumerate(streams):
            n = (len(s) - (s[-1][1] < STREAM_CHUNK)) * STREAM_CHUNK
            rows = stream_routing(rec_o.calls, n_moe,
                                  lambda c: i + c if c < len(s) else None, i)
            for blk in range(n_moe):
                replay[blk][i, :n] = torch.cat(rows[blk])[:n]
        with GateRecorder(moe_mod, replay=replay):
            ref = moe_conformer.forward(params, cfg_c.encoder_conf,
                                        feat_t.to(dtype), lens,
                                        moe_impl=ORACLE_IMPL[label],
                                        chunk_mask=mask)[0]
    ref = ref.float().cpu().numpy()
    worst, flipped, frames, ok_all = 0.0, 0, 0, True
    for i, s in enumerate(streams):
        n = (len(s) - (s[-1][1] < STREAM_CHUNK)) * STREAM_CHUNK
        ok, rel = held(outs_o[i][:n], ref[i, :n], fp32)
        worst = max(worst, rel)
        ok_all &= ok
        free = [rec_f.calls[blk][i, :n].cpu().numpy() for blk in range(n_moe)]
        mine = [replay[blk][i, :n].cpu().numpy() for blk in range(n_moe)]
        flipped += int(np.any(np.stack(free) != np.stack(mine), 0).sum())
        frames += n
    reset_counts()
    log(f"stream {label} oracle (causal=True in both encoders): batched "
        f"streams vs moe_conformer.forward with chunk_attention_mask("
        f"{Tp}, {STREAM_CHUNK}, {STREAM_LEFT}) ({ORACLE_IMPL[label]}, "
        f"experts pinned to the streams'), {frames} full-chunk frames: "
        f"max|diff|/max|ref| {worst:.3e} "
        f"({'allclose(1e-5, 1e-3)' if fp32 else '<= 0.05'}); frames whose "
        f"expert differs free-running: {flipped}; {smi} "
        f"{'OK' if ok_all else 'FAIL'}")
    if not ok_all:
        raise SystemExit(f"FAIL stream {label}: streams disagree with the "
                         "chunk-masked offline forward")
    return launched


def serve_client(port, reqs):
    """Send requests on one connection; their responses."""
    import socket
    with socket.create_connection(("127.0.0.1", port)) as sock:
        f = sock.makefile("rwb")
        out = []
        for r in reqs:
            f.write((json.dumps(r) + "\n").encode())
            f.flush()
            out.append(json.loads(f.readline()))
        return out


def phase_stream_serve(torch, cfg, tree, smi):
    """A loopback server (m3asr_tpu_torch.serve, --warmup, port 0) on a
    bf16 engine of the flagship: two offline requests (greedy; beam with
    a context trie and a seeded ARPA LM) and two concurrent beam streams,
    each response held equal to the engine and the host decode called
    directly; the native decoder must be the one that ran, and --warmup
    must have captured the default stream batcher before the first
    stream. Then two threads call infer and infer_long on the engine,
    each result equal to the serial one, and the mixed load
    (mixed_load). Returns the K1 launches of the server's captures."""
    import socketserver
    import tempfile
    import threading
    import m3asr_tpu_torch.serve as serve
    from m3asr_tpu_torch.decode import native
    from m3asr_tpu_torch.decode.ctc import ContextTrie
    from m3asr_tpu_torch.decode.lm import NgramLM
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    if not native.available():
        raise SystemExit(f"FAIL stream serve: the native decoder did not "
                         f"build: {native.load_error()}")
    eng = Engine(cfg, tree, EngineConfig(**SERVE_SETTINGS), device="cuda")
    tmp = tempfile.mkdtemp()
    arpa = os.path.join(tmp, "lm.arpa")
    write_arpa(arpa, cfg.output_dim, 21)
    args = serve.parser().parse_args(
        ["-p", tmp, "--warmup", "--port", "0", "--lm", arpa,
         "--stream_slots", str(STREAM_SLOTS)])
    reset_counts()
    t0 = time.perf_counter()
    state = serve._build_runtime(args, engine=eng)
    warm_s = time.perf_counter() - t0
    warm_key = serve.DEFAULT_STREAM_KEY
    warm_b = state["stream_batchers"].get(warm_key)
    if warm_key != (STREAM_CHUNK, STREAM_LEFT) or warm_b is None \
            or warm_b.graph is None:
        raise SystemExit("FAIL stream serve: --warmup did not capture the "
                         f"{warm_key} stream batcher")
    lm = serve.load_lm(args)
    srv = socketserver.ThreadingTCPServer(
        ("127.0.0.1", 0), serve.make_handler(state, args.beam_size, lm=lm))
    srv.daemon_threads = True
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]
    rng = np.random.default_rng(9)
    try:
        # offline: greedy, then beam with hotwords and the LM
        fa = rng.standard_normal((206, cfg.input_dim)).astype(np.float32)
        fb = rng.standard_normal((1000, cfg.input_dim)).astype(np.float32)
        out, out_len = eng.infer(fb[None], np.array([1000]))
        lp = out[0] - out[0].max(-1, keepdims=True)
        lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
        greedy_b = native.ctc_greedy_search(out, out_len)[0]
        ctx = [greedy_b[2:5], greedy_b[8:10]]
        ra, rb = serve_client(port, [
            {"id": "a", "feat": fa.tolist()},
            {"id": "b", "feat": fb.tolist(), "decode": "beam",
             "beam_size": 8, "context": ctx, "nbest": 3,
             "timestamps": True}])
        oa, la = eng.infer(fa[None], np.array([206]))
        want_a = native.ctc_greedy_search(oa, la)[0]
        hyps = native.ctc_prefix_beam_search_ext(
            lp, int(out_len[0]), 8, context=ContextTrie(ctx, 3.0), lm=lm,
            lm_weight=args.lm_weight)
        ok_off = (ra.get("hyp") == want_a and rb.get("hyp") ==
                  list(hyps[0].tokens) and rb.get("times") ==
                  list(hyps[0].times) and [n["hyp"] for n in rb["nbest"]]
                  == [list(h.tokens) for h in hyps[:3]] and
                  [n["score"] for n in rb["nbest"]] ==
                  [round(float(h.score), 4) for h in hyps[:3]])
        # two concurrent beam streams
        feats = [rng.standard_normal((T, cfg.input_dim)).astype(np.float32)
                 for T in (900, 611)]
        start = {"stream": "start", "chunk_size": STREAM_CHUNK,
                 "num_left_chunks": STREAM_LEFT, "decode": "beam",
                 "beam_size": 8, "timestamps": True}

        def stream_reqs(f):
            reqs, i = [start], 0
            for n in pieces_of(f.shape[0]):
                reqs.append({"stream": "chunk",
                             "feat": f[i:i + n].tolist()})
                i += n
            return reqs + [{"stream": "end"}]
        got = [None, None]
        clients = [threading.Thread(target=lambda j: got.__setitem__(
            j, serve_client(port, stream_reqs(feats[j]))), args=(j,))
            for j in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        stats = serve_client(port, [{"stats": True}])[0]
        # the same pieces through the server's own batcher and a native
        # beam state, one stream at a time
        pool = state["stream_pool"]
        want, native_used = [], True
        for f in feats:
            sess = pool.acquire((STREAM_CHUNK, STREAM_LEFT))
            beam = native.make_beam_state(8, lm=lm,
                                          lm_weight=args.lm_weight)
            native_used &= isinstance(beam, native.NativeBeamState)
            dec = serve._StreamDecode(sess, beam_state=beam)
            resp, i = [], 0
            for n in pieces_of(f.shape[0]):
                dec.update(sess.push(f[None, i:i + n]))
                toks, times = dec.result()
                resp.append((toks, dec.frames, times))
                i += n
            dec.update(sess.finish())
            toks, times = dec.result()
            resp.append((toks, dec.frames, times))
            pool.release((STREAM_CHUNK, STREAM_LEFT), sess)
            want.append(resp)
        ok_str = all(
            [(r.get("partial", r.get("hyp")), r["out_frames"], r["times"])
             for r in g[1:]] == w for g, w in zip(got, want))
        ticks = stats["stream_batchers"][str((STREAM_CHUNK, STREAM_LEFT))]
    finally:
        srv.shutdown()
        srv.server_close()
    launches = kernel_counts().get("K1", 0)
    ok = (ok_off and ok_str and native_used
          and list(state["stream_batchers"]) == [warm_key])
    log(f"stream serve (loopback 127.0.0.1:{port}, --warmup: "
        f"{len(eng.buckets.all_buckets())} buckets and the {warm_key} "
        f"stream batcher ({warm_b.pool_bytes / 2**20:.1f} MiB pool) "
        f"captured in {warm_s:.2f} s, before the first stream; batchers "
        f"after the streams: {list(state['stream_batchers'])}): offline "
        f"greedy 1x206 and beam "
        f"(width 8, 2 hotword phrases, {lm.order}-gram ARPA of "
        f"{len(lm.logp)} ngrams) 1x1000 equal to the engine and host "
        f"decode called directly: {ok_off}; 2 concurrent beam streams of "
        f"{[f.shape[0] for f in feats]} frames, "
        f"{sum(len(g) for g in got)} responses equal to the server's "
        f"batcher and a native beam state driven directly: {ok_str}; tick "
        f"batch sizes {ticks['tick_batch_sizes']}; native decoder used: "
        f"{native_used}; {smi} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL stream serve: responses differ from direct "
                         "decoding")

    # two threads on one engine: infer and infer_long, against serial
    short = [rng.standard_normal((1, 206, cfg.input_dim)).astype(np.float32)
             for _ in range(4)]
    long_f = rng.standard_normal((1, 5000, cfg.input_dim)).astype(
        np.float32)
    ref_s = [eng.infer(f, np.array([206])) for f in short]
    ref_l = eng.infer_long(long_f)
    bad = []

    def run_short():
        for k in range(40):
            r = eng.infer(short[k % 4], np.array([206]))
            bad.append(not all(np.array_equal(a, b)
                               for a, b in zip(r, ref_s[k % 4])))

    def run_long():
        for _ in range(4):
            r = eng.infer_long(long_f)
            bad.append(not all(np.array_equal(a, b)
                               for a, b in zip(r, ref_l)))
    ths = [threading.Thread(target=run_short),
           threading.Thread(target=run_long)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    ok = len(bad) == 44 and not any(bad)
    log(f"stream engine threads: 40 infer calls (1x206) and 4 infer_long "
        f"calls (1x5000) from two threads on one bf16 engine, each equal to "
        f"its serial result: {len(bad) - sum(bad)} of 44; {smi} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL stream: the engine is not re-entrant")
    mixed_load(torch, cfg, eng, warm_b, short, ref_s, smi)
    state["batcher"].close()
    for b in state["stream_batchers"].values():
        b.close()
    return launches


def mixed_load(torch, cfg, eng, b, short, ref_s, smi):
    """Offline requests (infer 1x206, each result held to its serial one)
    on one thread beside full ticks of the server's stream batcher ``b``
    on another, 40 calls each: each alone, then both with the device
    sections shared as the port runs them, against each call holding
    DEVICE_LOCK exclusively (every section serialised, host work
    included), in turns. Wall ms by the host clock."""
    import threading
    from m3asr_tpu_torch.runtime.graphs import DEVICE_LOCK
    full = (np.zeros((b.slots, 4 * b.chunk + 3, cfg.input_dim), np.float32),
            np.ones((b.slots,), bool))
    n, bad = 40, []

    def offline(side):
        for k in range(n):
            with side():
                r = eng.infer(short[k % 4], np.array([206]))
            bad.append(not all(np.array_equal(x, y)
                               for x, y in zip(r, ref_s[k % 4])))

    def ticks(side):
        for _ in range(n):
            with side(), DEVICE_LOCK.shared():
                b._tick(*full)

    def wall(fns, side):
        ths = [threading.Thread(target=f, args=(side,)) for f in fns]
        t0 = time.perf_counter()
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        return (time.perf_counter() - t0) * 1e3
    shared, alone = DEVICE_LOCK.shared, DEVICE_LOCK.exclusive
    walls = {"offline": wall([offline], shared),
             "stream": wall([ticks], shared)}
    for k in ("shared", "serialised", "shared", "serialised"):
        walls.setdefault(k, []).append(
            wall([offline, ticks], shared if k == "shared" else alone))
    ok = len(bad) == 5 * n and not any(bad)
    log(f"stream mixed load: {n} offline 1x206 requests on one thread and "
        f"{n} full {b.slots}-slot ticks on another; wall ms (host clock): "
        f"offline alone {walls['offline']:.1f}, ticks alone "
        f"{walls['stream']:.1f}, both with shared device sections "
        f"{[round(w, 1) for w in walls['shared']]}, both with every call "
        f"holding DEVICE_LOCK alone "
        f"{[round(w, 1) for w in walls['serialised']]}; offline results "
        f"equal to serial: {len(bad) - sum(bad)} of {len(bad)}; {smi} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL stream: offline results differ beside "
                         "stream ticks")


def phase_stream(torch, state, smi):
    """Phase "stream": fp32, bf16 (K1) and int4 (K6) streams of the
    flagship, 8 slots, chunk 16, left 2 (stream_mode), the loopback
    server and the threaded engine (phase_stream_serve), K1 and K6 alone
    at 16 and 128 tokens. Returns each mode's launches of its kernel on
    the phase's main path (the captures), under their report names."""
    import copy
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg = state["cfg"]
    cfg_c = copy.deepcopy(cfg)
    cfg_c.encoder_conf.causal = True
    cfg_c.encoder_conf.embed_conf.causal = True
    trees = {"float": state["params"], **state.pop("qparams")}
    rng = np.random.default_rng(8)
    feats = [rng.standard_normal((T, cfg.input_dim)).astype(np.float32)
             for T in STREAM_FRAMES]
    reset_counts()                        # the phase's run starts here
    t0 = time.perf_counter()
    launches = {}
    for label, settings, tree, kname, impl in STREAM_MODES:
        eng = Engine(cfg, trees[tree], EngineConfig(**settings),
                     device="cuda")
        launches[label] = stream_mode(torch, label, eng, cfg, cfg_c, feats,
                                      kname, impl, smi)
        eng = None
        torch.cuda.empty_cache()
    launches["bfloat16"] += phase_stream_serve(torch, cfg, trees["float"],
                                               smi)
    torch.cuda.empty_cache()
    for key, err in time_stream_kernels(torch, smi).items():
        errs = state.setdefault(
            "max_err" if isinstance(key, str) else "max_err_q", {})
        errs[key] = max(errs.get(key, 0.0), err)
    log(f"stream: phase took {time.perf_counter() - t0:.1f} s; launches on "
        f"its main path (captures) {launches}")
    if not all(launches.values()):
        raise SystemExit("FAIL stream: a kernel of the path never launched")
    return launches


# phase "recognize": the port's recognizer (python -m
# m3asr_tpu_torch.recognize) on the flagship and its three AED decoders,
# from a bf16 engine dir written by the port's build path
RECOGNIZE_FRAMES = (206, 480, 640, 1000, 1000, 1500, 2048, 7000)
RECOGNIZE_BATCH = 4               # the recognizer's default --batch_size
RECOGNIZE_BEAM = 10
WAV_SECONDS = (3.2, 5.0)          # the --raw_wav scp's two signals
DECODERS = ("decoder", "decoder_1", "decoder_2")
AED_CPU_UTTS = (0, 2)             # the 206- and 640-frame utterances
RESCORE_TIE = 1e-3                # hier totals this close count as a tie


def write_int_vectors(path, rows):
    """A binary Kaldi int-vector ark of {key: ids}."""
    import struct
    with open(path, "wb") as f:
        for key, ids in rows.items():
            f.write(key.encode() + b" \x00B\x04" + struct.pack("<i", len(ids)))
            for x in ids:
                f.write(b"\x04" + struct.pack("<i", int(x)))


def recognize_inputs(work, cfg):
    """The phase's inputs, written under ``work``: feats.ark (the 8
    utterances), short.ark (those within the top bucket, for -d
    attention), labels.ark, cmvn.txt (the features' own statistics) and
    wav.scp (two seeded 16 kHz PCM16 signals). Returns the features."""
    import wave
    from m3asr_tpu_torch.io.kaldi_io import ArkWriter
    rng = np.random.default_rng(21)
    feats = [(f"utt{i}", rng.standard_normal((T, cfg.input_dim))
              .astype(np.float32) * 2 + 1)
             for i, T in enumerate(RECOGNIZE_FRAMES)]
    with ArkWriter(os.path.join(work, "feats.ark")) as w:
        for k, f in feats:
            w.write(k, f)
    with ArkWriter(os.path.join(work, "short.ark")) as w:
        for k, f in feats:
            if f.shape[0] <= 6144:
                w.write(k, f)
    write_int_vectors(os.path.join(work, "labels.ark"), {
        k: rng.integers(1, cfg.output_dim - 1, f.shape[0] // 16)
        for k, f in feats})
    allf = np.concatenate([f for _, f in feats]).astype(np.float64)
    with open(os.path.join(work, "cmvn.txt"), "w") as fh:
        fh.write("[\n " + " ".join(map(repr, allf.sum(0).tolist()))
                 + f" {allf.shape[0]}\n "
                 + " ".join(map(repr, (allf ** 2).sum(0).tolist()))
                 + " 0 ]\n")
    with open(os.path.join(work, "wav.scp"), "w") as scp:
        for i, secs in enumerate(WAV_SECONDS):
            n = int(16000 * secs)
            t = np.arange(n) / 16000.0
            x = (5000 * np.sin(2 * np.pi * (220 + 180 * i) * t)
                 * np.sin(2 * np.pi * 1.5 * t) + 800 * rng.standard_normal(n))
            path = os.path.join(work, f"w{i}.wav")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(np.clip(x, -32768, 32767).astype(np.int16)
                              .tobytes())
            scp.write(f"wav{i} {path}\n")
    return feats


def run_recognize(torch, argv):
    """recognize.main(argv) in process: its transcripts {key: ids}, its
    stats, the engine it loaded (Engine.load recorded) and its wall
    seconds with the load."""
    import contextlib
    import io
    from m3asr_tpu_torch import recognize
    from m3asr_tpu_torch.runtime.engine import Engine
    loaded = []
    orig = Engine.load.__func__

    def load(cls, *a, **k):
        loaded.append(orig(cls, *a, **k))
        return loaded[-1]
    Engine.load = classmethod(load)
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            stats = recognize.main(argv)
    finally:
        Engine.load = classmethod(orig)
    secs = time.perf_counter() - t0
    hyps = {}
    for line in out.getvalue().splitlines():
        key, *toks = line.split()
        hyps[key] = [int(t) for t in toks]
    return hyps, stats, loaded[0], secs


def loader_batches(feats, transform=None):
    """The recognizer's batches, made directly: RECOGNIZE_BATCH
    utterances in order, zero-padded to the longest."""
    for s in range(0, len(feats), RECOGNIZE_BATCH):
        chunk = [(k, transform(f) if transform else f)
                 for k, f in feats[s:s + RECOGNIZE_BATCH]]
        lens = np.array([f.shape[0] for _, f in chunk], np.int32)
        data = np.zeros((len(chunk), int(lens.max()), chunk[0][1].shape[1]),
                        np.float32)
        for i, (_, f) in enumerate(chunk):
            data[i, :f.shape[0]] = f
        yield [k for k, _ in chunk], data, lens


def engine_outputs(eng, data, lens):
    """Engine.infer on a batch, or infer_long on each utterance of a batch
    past the top bucket with the frame-aligned outputs zero-padded to the
    batch's longest, as the engine pads them."""
    if int(lens.max()) <= eng.buckets.lengths[-1]:
        return eng.infer(data, lens)
    rs = [eng.infer_long(data[i, :n], int(n)) for i, n in enumerate(lens)]
    out_len = np.array([int(r[1][0]) for r in rs], np.int32)
    width = int(out_len.max())

    def pad(a):
        a = np.asarray(a)[0]
        return np.pad(a, [(0, width - a.shape[0])] + [(0, 0)] * (a.ndim - 1))
    res = [np.stack([pad(r[0]) for r in rs]), out_len]
    return tuple(res + [np.stack([pad(r[j]) for r in rs])
                        for j in range(2, len(rs[0]))])


def direct_hyps(torch, eng, decoders, cfg, mode, feats, transform):
    """Each utterance's hypothesis from the port's functions called
    directly: Engine.infer / infer_long, the native CTC searches, then
    hier_attention_rescoring or attention_search_decode. Also returns,
    per utterance, what phase 10's CPU checks take: (taps, out_len,
    n-best) or (hidden, out_len)."""
    from m3asr_tpu_torch.decode import native
    from m3asr_tpu_torch.models import aed
    dc = cfg.decoder_conf
    hyps, memories = {}, {}
    for keys, data, lens in loader_batches(feats, transform):
        res = engine_outputs(eng, data, lens)
        out, out_len = res[0], res[1]
        if mode == "attention":
            got = aed.attention_search_decode(
                decoders["decoder"], dc, res[2], out_len,
                beam_size=RECOGNIZE_BEAM, sos=cfg.sos, eos=cfg.eos)
            for b, k in enumerate(keys):
                hyps[k] = got[b]
                memories[k] = (res[2][b:b + 1, :out_len[b]], out_len[b])
            continue
        for b, k in enumerate(keys):
            n = int(out_len[b])
            if mode == "greedy":
                hyps[k] = native.ctc_greedy_search(out[b:b + 1], [n])[0]
                continue
            x = out[b].astype(np.float32)
            m = x.max(-1, keepdims=True)
            lp = x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))
            nbest = native.ctc_prefix_beam_search(lp, n, RECOGNIZE_BEAM)
            if mode == "beam":
                hyps[k] = list(nbest[0][0])
                continue
            taps = tuple(torch.from_numpy(h[b:b + 1]).cuda()
                         for h in res[2:5])
            hyps[k], _ = aed.hier_attention_rescoring(
                decoders, dc, nbest, taps, n, sos=cfg.sos, eos=cfg.eos,
                ignore_id=0, ctc_weight=0.5,
                reverse_weight=cfg.reverse_weight)
            memories[k] = (tuple(h[b:b + 1] for h in res[2:5]), n, nbest)
    return hyps, memories


def recognized_graphs(eng, counts, n_moe):
    """Every bucket program of the recognizer's engine captured, on K1
    (runs_f), and K1 launched exactly (GRAPH_WARMUP_RUNS + 1) x n_moe
    times per capture, no other kernel: (ok, programs, want)."""
    from m3asr_tpu_torch.runtime.engine import GRAPH_WARMUP_RUNS
    progs = eng._programs
    want = {"K1": (GRAPH_WARMUP_RUNS + 1) * n_moe * len(progs)}
    ok = bool(progs) and counts == want and all(
        p.graph is not None and eng.moe_impl_for(k[0], k[1]) == "runs_f"
        for k, p in progs.items())
    return ok, sorted((k[0], k[1], k[2]) for k in progs), want


def aed_cpu_checks(torch, cfg, decoders, memories, mode, smi):
    """The decoders on the card against the same calls on the CPU in
    float32: rescore, score_hyps of every decoder on the 640-frame
    utterance's taps and n-best within allclose(rtol 1e-5, atol 1e-3)
    and the hier best hypothesis the same unless its top two totals are
    within RESCORE_TIE; attention, the best hypothesis of
    attention_search_decode equal on the 206- and 640-frame utterances.
    Returns the largest |card - CPU| of the scores (0 for attention)."""
    from m3asr_tpu_torch.checkpoint import to_torch
    from m3asr_tpu_torch.models import aed
    dc = cfg.decoder_conf
    cpu = {n: to_torch(t, "cpu") for n, t in decoders.items()}
    worst = 0.0
    if mode == "rescore":
        taps, n, nbest = memories[f"utt{AED_CPU_UTTS[1]}"]
        hyps = [list(h) for h, _ in nbest]
        ok = True
        totals = []
        for dev, decs in (("cuda", decoders), ("cpu", cpu)):
            mem = [torch.from_numpy(np.ascontiguousarray(h)).to(dev)
                   for h in taps]
            per = {name: aed.score_hyps(decs[name], dc,
                                        mem[aed.HIER_MEMORY[name]], [n],
                                        hyps, cfg.sos, cfg.eos, 0)
                   for name in DECODERS}
            totals.append((per, np.mean([per[k] for k in DECODERS], 0)
                           + 0.5 * np.array([s for _, s in nbest])))
        for name in DECODERS:
            a, b = totals[0][0][name], totals[1][0][name]
            worst = max(worst, float(np.abs(a - b).max()))
            ok &= bool(np.allclose(a, b, rtol=1e-5, atol=1e-3))
        top = np.sort(totals[1][1])[::-1]
        tied = len(top) > 1 and top[0] - top[1] < RESCORE_TIE
        same = int(np.argmax(totals[0][1])) == int(np.argmax(totals[1][1]))
        ok &= same or tied
        log(f"recognize AED card vs CPU (float32), utt{AED_CPU_UTTS[1]}: "
            f"score_hyps of {len(hyps)} hypotheses (up to "
            f"{max(len(h) for h in hyps)} tokens) x 3 decoders max|diff| "
            f"{worst:.3e} within allclose(1e-5, 1e-3); hier best the same "
            f"{same} (top two totals {top[0]:.4f} / "
            f"{top[1] if len(top) > 1 else float('nan'):.4f}, tie "
            f"{tied}); {smi} {'OK' if ok else 'FAIL'}")
    else:
        ok = True
        for u in AED_CPU_UTTS:
            mem, n = memories[f"utt{u}"]
            got = [aed.attention_search_decode(
                decs["decoder"], dc, mem, [n], beam_size=RECOGNIZE_BEAM,
                sos=cfg.sos, eos=cfg.eos)[0] for decs in (decoders, cpu)]
            ok &= got[0] == got[1]
            log(f"recognize AED card vs CPU (float32), utt{u} "
                f"({RECOGNIZE_FRAMES[u]} frames, {n} memory frames): "
                f"attention_search_decode best hypotheses equal "
                f"{got[0] == got[1]} ({len(got[0])} tokens); {smi}")
    if not ok:
        raise SystemExit(f"FAIL recognize: the decoders on the card "
                         f"disagree with the CPU ({mode})")
    return worst


def aed_device_times(torch, cfg, decoders, memories, smi):
    """Device time under torch.profiler of one hier rescoring (the
    640-frame utterance: 3 decoders x its n-best) and the mean of one
    attention step (the 206-frame utterance's whole search over its
    steps)."""
    from m3asr_tpu_torch.models import aed
    dc = cfg.decoder_conf
    taps, n, nbest = memories["rescore"][f"utt{AED_CPU_UTTS[1]}"]
    taps = [torch.from_numpy(np.ascontiguousarray(h)).cuda() for h in taps]
    resc, ev = profiled_events(torch, lambda: aed.hier_attention_rescoring(
        decoders, dc, nbest, taps, n, cfg.sos, cfg.eos, 0), 1, warmup=1)
    mem, m = memories["attention"][f"utt{AED_CPU_UTTS[0]}"]
    stats = {}
    att, ev2 = profiled_events(torch, lambda: aed.attention_search_decode(
        decoders["decoder"], dc, mem, [m], RECOGNIZE_BEAM, cfg.sos, cfg.eos,
        stats=stats), 1, warmup=1)
    steps = stats["steps"] // 2
    log(f"recognize AED device time (torch.profiler): one hier rescoring "
        f"of utt{AED_CPU_UTTS[1]} ({len(nbest)} hypotheses x 3 decoders) "
        f"{resc:.3f} ms ({ev} events); attention on utt{AED_CPU_UTTS[0]} "
        f"{att:.3f} ms over {steps} steps, {att / steps:.3f} ms a step "
        f"({ev2 // steps} events a step); {smi}")
    return resc, att / steps


def phase_recognize(torch, state, smi):
    """Phase "recognize": a bf16 engine dir of the flagship with three
    random AED decoders at the config's width (aed.init, seeded CUDA
    generator; decoders.npz by checkpoint.save_decoders, build's writer),
    recognized through recognize.main with -d greedy, -d beam -b 10, -d
    rescore --hier_rescore and -d attention (the utterances within the
    top bucket), and --raw_wav -d greedy. Each mode's engine must run
    every bucket as a captured graph on K1 (18 launches a forward, 3
    forwards a capture, no other kernel), its transcripts must equal the
    port's functions called directly on the same engine, and the
    decoders on the card must agree with the CPU (aed_cpu_checks), and
    K1 must agree with its plain version at every captured bucket's
    token count (k1_at_shapes). Prints wall seconds, RTF and the time
    split of each mode, the AED's device time, K1's times at those
    counts and peak memory. Returns K1's launches (the captures)."""
    import shutil
    import tempfile
    import yaml
    from m3asr_tpu_torch import checkpoint as ckpt
    from m3asr_tpu_torch.config import model_config_from_dict
    from m3asr_tpu_torch.frontend import fbank
    from m3asr_tpu_torch.frontend.features import FeatureTransform
    from m3asr_tpu_torch.models import aed
    from m3asr_tpu_torch.ops.masking import SUBSAMPLED_LENGTH
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    from m3asr_tpu_torch.decode import native
    from m3asr_tpu_torch.io import native_io

    t_phase = time.perf_counter()
    # the host libraries build at first use (g++): build them here, so
    # that no mode's time holds a build and no mode falls back to Python
    if not (native.available() and native_io.available()):
        raise SystemExit(f"FAIL recognize: a native library did not build: "
                         f"{native.load_error() or native_io.load_error()}")
    log(f"recognize: native decoder and ark reader loaded in "
        f"{time.perf_counter() - t_phase:.2f} s")
    with open(os.path.join(HERE, "configs", "3m_asr_18l32e.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model_conf"]["encoder_conf"]["num_blocks"] = FLAGSHIP_MOE_BLOCKS
    cfg = model_config_from_dict(raw)
    if cfg.encoder_conf != state["cfg"].encoder_conf:
        raise SystemExit("FAIL recognize: the flagship YAML is not phase "
                         "4's configuration")
    n_moe = cfg.encoder_conf.num_blocks
    d = cfg.encoder_conf.attention_dim
    gen = torch.Generator(device="cuda").manual_seed(22)
    decoders = {name: aed.init(cfg.decoder_conf, cfg.output_dim, d, gen)
                for name in DECODERS}
    work = tempfile.mkdtemp(prefix="m3asr_recognize_")
    try:
        t0 = time.perf_counter()
        eng = Engine(cfg, state["params"], EngineConfig(dtype="bfloat16"),
                     device="cuda")
        eng.save(work, raw_yaml=raw)
        ckpt.save_decoders(work, decoders)
        eng = None
        torch.cuda.empty_cache()
        feats = recognize_inputs(work, cfg)
        gib = [os.path.getsize(os.path.join(work, f)) / 2**30
               for f in ("params.npz", ckpt.DECODERS_FILE)]
        log(f"recognize: bf16 engine dir and decoders.npz ({gib[0]:.2f} + "
            f"{gib[1]:.2f} GiB) and inputs written in "
            f"{time.perf_counter() - t0:.1f} s")
        transform = FeatureTransform(cfg.input_dim, order=0,
                                     cmvn_file=os.path.join(work, "cmvn.txt"))
        short = [kf for kf in feats if kf[1].shape[0] <= 6144]
        common = ["-p", work, "--feat_dim", str(cfg.input_dim),
                  "--batch_size", str(RECOGNIZE_BATCH)]
        ark = ["-i", os.path.join(work, "feats.ark"), "-l",
               os.path.join(work, "labels.ark"), "--cmvn",
               os.path.join(work, "cmvn.txt")]
        runs = (("greedy", ark + ["-d", "greedy"], feats),
                ("beam", ark + ["-d", "beam", "-b", str(RECOGNIZE_BEAM)],
                 feats),
                ("rescore", ark + ["-d", "rescore", "--hier_rescore", "-b",
                                   str(RECOGNIZE_BEAM)], feats),
                ("attention", ["-i", os.path.join(work, "short.ark"), "-l",
                               os.path.join(work, "labels.ark"), "--cmvn",
                               os.path.join(work, "cmvn.txt"), "-d",
                               "attention", "-b", str(RECOGNIZE_BEAM)],
                 short),
                ("raw_wav", ["-i", os.path.join(work, "wav.scp"),
                             "--raw_wav", "-d", "greedy"], None))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches, memories, captured = 0, {}, set()
        for label, argv, inputs in runs:
            reset_counts()                    # this mode's run starts here
            hyps, stats, eng, secs = run_recognize(torch, common + argv)
            counts = kernel_counts()
            ok, progs, want = recognized_graphs(eng, counts, n_moe)
            launches += counts.get("K1", 0)
            captured.update((bb, bt) for bb, bt, _ in progs)
            mode = "greedy" if label == "raw_wav" else label
            if inputs is None:
                inputs = []
                for line in open(os.path.join(work, "wav.scp")):
                    key, path = line.split()
                    wave_, sr = fbank.read_wav(path)
                    inputs.append((key, fbank.fbank(
                        wave_, num_mel_bins=cfg.input_dim, frame_length=25,
                        frame_shift=10, sample_frequency=sr)))
                tf = None
            else:
                tf = transform.transform
            direct, mems = direct_hyps(torch, eng, decoders, cfg, mode,
                                       inputs, tf)
            memories[label] = mems
            equal = direct == hyps and len(hyps) == len(inputs)
            split = stats["split_s"]
            steps = stats.get("aed_steps")
            step_ms = (f", {split['aed'] / steps * 1e3:.3f} ms a decode "
                       f"step ({steps} steps)" if steps else "")
            log(f"recognize {label}: {stats['utts']} utts, "
                f"{stats['frames']} frames, wall {stats['wall_s']} s "
                f"after the load (RTF {stats['rtf']}; {secs:.2f} s with "
                f"the engine load), CER {stats.get('cer')}; split s: "
                f"loader {split['loader']:.4f}, engine {split['engine']:.4f}"
                f", host search {split['search']:.4f}, AED "
                f"{split['aed']:.4f}{step_ms}, memory copies to the card "
                f"{split['memory_h2d']:.4f}; buckets {progs} captured, "
                f"launches {counts} (want {want}); transcripts equal to "
                f"direct calls {equal} ({sum(map(len, hyps.values()))} "
                f"tokens); {smi} {'OK' if ok and equal else 'FAIL'}")
            if not (ok and equal):
                raise SystemExit(f"FAIL recognize {label}: graphs, launches "
                                 "or transcripts off the direct path")
            if label in ("rescore", "attention"):
                aed_cpu_checks(torch, cfg, decoders, mems, label, smi)
            eng = None
            torch.cuda.empty_cache()
        aed_device_times(torch, cfg, decoders, memories, smi)
        # K1 at the token counts of every bucket the modes captured (B x
        # T' tokens: 2044 at 4x2048, 1535 at infer_long's 1x6144
        # window), against its plain version
        sub = SUBSAMPLED_LENGTH[cfg.encoder_conf.input_layer]
        shapes = sorted({(bb, int(sub(bt))) for bb, bt in captured},
                        key=lambda s: s[0] * s[1])
        err, _ = k1_at_shapes(torch, torch.bfloat16, shapes,
                              torch.Generator(device="cuda").manual_seed(23),
                              smi, "recognize")
        errs = state["max_err"]
        errs["bfloat16"] = max(errs.get("bfloat16", 0.0), err)
        log(f"recognize: peak {torch.cuda.max_memory_allocated() / 2**30:.3f}"
            f" GiB allocated / {torch.cuda.max_memory_reserved() / 2**30:.3f}"
            f" GiB reserved; phase took {time.perf_counter() - t_phase:.1f} "
            f"s; K1 launches on its main path (captures) {launches}; {smi}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


TRAIN_BATCH = (4, 1000)
TRAIN_LENS = (1000, 960, 880, 800)
TRAIN_LABELS = (40, 36, 30, 25)        # CTC targets per utterance
TRAIN_GRAD_TOL = 1e-3   # flash vs xla: max|diff| / max|g| per group
# the bf16-compute flash step's gradients against the fp32 flash step's:
# max|diff| / max|g| per group within this multiple of the bf16 xla
# step's (the first card run saw at most 1.33x, and groups from 1.5e-2 to
# 0.23 of max|g| for bf16 xla), and the global norm's relative distance
# (the first card run saw 7.1e-3 for both)
TRAIN_BF16_ENVELOPE = 2.0
TRAIN_BF16_NORM_TOL = 2e-2


def train_batch(torch, cfg):
    """Features, lengths and CTC targets of the training batch (numpy from
    a seed), on the card."""
    rng = np.random.default_rng(7)
    B, T = TRAIN_BATCH
    feat = rng.standard_normal((B, T, cfg.input_dim)).astype(np.float32)
    targets = rng.integers(1, cfg.output_dim, (B, max(TRAIN_LABELS))) \
        .astype(np.int32)
    tlens = np.array(TRAIN_LABELS, np.int32)
    return tuple(torch.from_numpy(a).cuda() for a in (
        feat, np.array(TRAIN_LENS, np.int32), targets, tlens))


def param_group(path):
    """The group of a parameter path in the gradient comparison: its
    module, down to a block's sublayer ("blocks/self_attn",
    "embed/blocks/conv_module", "after_norm", ...)."""
    parts = path.split("/")[:-1]
    return "/".join(parts[:3 if parts[0] == "embed" else 2])


def train_config(attn_impl, dtype="float32"):
    from m3asr_tpu_torch.train import step as ts
    return ts.TrainConfig(attn_impl=attn_impl, compute_dtype=dtype,
                          embed_ctc_weight=0.3, warmup_steps=1000)


def group_rel(got, ref, group=param_group):
    """max|got - ref| / max|ref| per parameter group."""
    groups = {}
    for k in ref:
        grp = groups.setdefault(group(k), [0.0, 0.0])
        grp[0] = max(grp[0], (got[k] - ref[k]).abs().max().item())
        grp[1] = max(grp[1], ref[k].abs().max().item())
    return {k: d / m if m > 0 else d for k, (d, m) in groups.items()}


def train_grads(torch, cfg, params, batch):
    """Gradients of one training batch from the same parameters, every
    run's tokens sent to the fp32 flash run's experts: fp32 flash against
    fp32 xla, and the bf16-compute flash step (K2/K3 in bf16, the casts
    back to the float32 masters) against fp32 flash, beside the bf16 xla
    step's distance from fp32 flash (what bf16 rounding alone gives)."""
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.train import step as ts
    from m3asr_tpu_torch.train.lr_scheduler import global_norm

    with GateRecorder(moe_mod) as rec:
        (loss_f, _), g_f = ts.value_and_grad(
            params, cfg, train_config("flash"), *batch)

    def pinned(attn_impl, dtype):
        with GateRecorder(moe_mod, replay=rec.calls):
            (loss, _), g = ts.value_and_grad(
                params, cfg, train_config(attn_impl, dtype), *batch)
        return loss.item(), g

    loss_x, g_x = pinned("xla", "float32")
    loss_f = loss_f.item()
    rel_loss = abs(loss_f - loss_x) / abs(loss_x)
    rels = group_rel(g_f, g_x)
    worst = max(rels, key=rels.get)
    ok = rel_loss <= 1e-5 and rels[worst] <= TRAIN_GRAD_TOL
    log(f"train fp32 flash vs xla (routing pinned): loss {loss_f:.6f}"
        f" vs {loss_x:.6f} (rel {rel_loss:.3e}, held to 1e-5); "
        f"gradients max|diff|/max|g| per group, held to {TRAIN_GRAD_TOL}: "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(rels.items()))
        + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL train: the flash step's loss or gradients "
                         "are off the xla step's")
    del g_x

    norm_f = global_norm(g_f.values()).item()
    found = {}
    for attn_impl in ("xla", "flash"):
        _, g_b = pinned(attn_impl, "bfloat16")
        norm_b = global_norm(g_b.values()).item()
        found[attn_impl] = (group_rel(g_b, g_f),
                            abs(norm_b - norm_f) / norm_f)
        del g_b
    (rels, rel_norm), (envelope, _) = found["flash"], found["xla"]
    ok = rel_norm <= TRAIN_BF16_NORM_TOL and all(
        v <= TRAIN_BF16_ENVELOPE * envelope[k] for k, v in rels.items())
    log(f"train bf16 flash vs fp32 flash gradients (routing pinned): "
        f"grad_norm {norm_f:.6f} fp32, rel {rel_norm:.3e} (bf16 xla "
        f"{found['xla'][1]:.3e}), held to {TRAIN_BF16_NORM_TOL}; "
        f"max|diff|/max|g| per group as flash (bf16 xla), held to "
        f"{TRAIN_BF16_ENVELOPE}x bf16 xla's: " + ", ".join(
            f"{k} {v:.2e} ({envelope[k]:.2e})"
            for k, v in sorted(rels.items()))
        + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL train: the bf16 step's gradients are off "
                         "the fp32 step's")
    del g_f
    torch.cuda.empty_cache()


def phase_train(torch, state, smi):
    """The flagship's CTC training step (make_train_step, embed CTC weight
    0.3 so that all 24 attention layers train). Returns K2's and K3's
    launches per dtype on the step's run."""
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    from m3asr_tpu_torch.train import step as ts

    cfg, params = state["cfg"], state["params"]
    enc = cfg.encoder_conf
    n_attn = enc.embed_conf.num_blocks + enc.num_blocks
    batch = train_batch(torch, cfg)
    train_grads(torch, cfg, params, batch)

    opt = ts.make_optimizer(train_config("flash"))
    opt_state = ts.init_opt_state(opt, params)
    launches = {}
    for label, cfg_t, n_steps in (
            ("flash", train_config("flash"), 4),
            ("xla", train_config("xla"), 2),
            ("bf16 flash", train_config("flash", "bfloat16"), 1)):
        if cfg_t.compute_dtype == "float32":
            # the step itself must turn TF32 off (cuDNN's default is on)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        step = ts.make_train_step(cfg, cfg_t, opt, device="cuda")
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        if any(flags):
            raise SystemExit(f"FAIL train {label}: make_train_step left "
                             f"TF32 on (cuBLAS, cuDNN) {flags}")
        if cfg_t.compute_dtype == "float32":   # and each step call again
            torch.backends.cudnn.allow_tf32 = True
        p, s = params, opt_state
        reset_flash(flash_kernels)        # this run starts here
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for i in range(n_steps):
            t0 = time.perf_counter()
            p, s, m = step(p, s, *batch)
            loss = m["loss"].item()       # syncs
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            per_step = (flash_kernels.fwd_launches, flash_kernels.dq_launches,
                        flash_kernels.dkv_launches)
            want = (0, 0, 0) if label == "xla" else \
                ((i + 1) * n_attn,) * 3
            if per_step != want or not np.isfinite(loss):
                raise SystemExit(f"FAIL train {label}: step {i} launches "
                                 f"(K2, K3 dq, K3 dkv) {per_step}, want "
                                 f"{want}; loss {loss}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if (cfg_t.compute_dtype == "float32"
                and torch.backends.cudnn.allow_tf32):
            raise SystemExit(f"FAIL train {label}: the step ran with TF32 "
                             "turned on after make_train_step")
        log(f"train {label}: {n_steps} steps, losses "
            f"{[round(v, 6) for v in losses]}, grad_norm "
            f"{m['grad_norm'].item():.4f}; launches (K2, K3 dq, K3 dkv) "
            f"{per_step}, {n_attn} each per step; step times ms "
            f"{[round(v, 3) for v in ms]} (median "
            f"{float(np.median(ms)):.3f}); peak memory {peak:.3f} GiB; "
            f"{smi}")
        if label == "flash":
            launches["float32"] = per_step
            loss32 = losses[0]
            dev_ms = profiled_ms(  # one step, after the four above
                torch, lambda: step(params, opt_state, *batch), 1, warmup=0)
            log(f"device time train flash: {dev_ms:.3f} ms in one step "
                f"under torch.profiler, {dev_ms / np.median(ms):.3f} of the "
                f"median step; {smi}")
        elif label == "bf16 flash":
            launches["bfloat16"] = per_step
            rel = abs(losses[0] - loss32) / abs(loss32)
            log(f"train bf16 flash: loss {losses[0]:.6f} vs fp32 "
                f"{loss32:.6f}: rel {rel:.3e}, held to 2e-2 "
                f"{'OK' if rel <= 2e-2 else 'FAIL'}")
            if rel > 2e-2:
                raise SystemExit("FAIL train: the bf16 step's loss is off "
                                 "the fp32 step's")
        p = s = None
        torch.cuda.empty_cache()
    return launches


def cuda_time_ms(torch, fn, iters):
    """Mean device time of fn(i) over iters calls, after 3 warm-up
    calls. Callers rotate the layer with i, so every call reads weights
    that the previous 17 calls did not (L2 holds 50 MB; one layer's
    experts take 64/128 MB), as the main path's layer loop does."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def profiled_ms(torch, fn, iters, warmup=3):
    """Device time of one fn() call: the summed duration of the kernels
    and copies the card ran under torch.profiler over iters calls (after
    warmup calls), over iters. Unlike cuda_time_ms it leaves out the
    host's gaps between launches."""
    return profiled_events(torch, fn, iters, warmup)[0]


def profiled_events(torch, fn, iters, warmup=3):
    """profiled_ms and the number of device events it summed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    return sum(us) / 1e3 / iters, len(us)


def paired_device_ms(torch, fa, fb, rounds=4, iters=20):
    """profiled_ms of fa and fb taken in turns (a b b a a b b a ...), so
    that the card's state drifts over both alike: the median and the
    range of each, as ((med, lo, hi), (med, lo, hi)). A round whose trace
    holds fewer device events than that function's fullest round lost
    some to the profiler (it happens on the card's machine) and is left
    out."""
    runs = ([], [])
    for i in range(rounds):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            runs[j].append(profiled_events(torch, (fa, fb)[j], iters))
    out = []
    for r in runs:
        full = max(n for _, n in r)
        t = [ms for ms, n in r if n == full]
        out.append((float(np.median(t)), min(t), max(t)))
    return tuple(out)


def short_name(kernel):
    """A device event's name without return type, namespace or
    arguments, at most 60 characters."""
    name = kernel.replace("void ", "", 1)
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].strip()[:60]


def device_time(torch, eng, feat, lens):
    """One request under torch.profiler: the summed duration of the
    kernels and copies the card ran (one stream, so they do not overlap),
    in ms, the five kernel names that took most of it, and the ms of each
    expert kernel it ran (expert_kernel: K1, K4-K8, their a8
    forms and the row-tile front)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.infer(feat, lens)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    runs = {}
    for name, us in by_name.items():
        kern = expert_kernel(name)
        if kern is not None:
            runs[kern] = runs.get(kern, 0.0) + us / 1e3
    return sum(by_name.values()) / 1e3, top, runs


def request_times(torch, eng, label, reqs, smi):
    """Median latency of 5 requests (host clock around infer, which ends
    in a device-to-host copy), peak device memory, and the device time of
    one request under torch.profiler with its largest kernels."""
    for feat, lens in reqs:
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng.infer(feat, lens)
            times.append((time.perf_counter() - t0) * 1e3)
        log(f"latency {label} {feat.shape[0]}x{feat.shape[1]}: median "
            f"{np.median(times):.3f} ms (min {min(times):.3f}, max "
            f"{max(times):.3f}, 5 runs), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; {smi}")
        dev_ms, top, runs = device_time(torch, eng, feat, lens)
        if dev_ms == 0:
            log("device time: not measured (the profiler recorded no "
                "device activity)")
            continue
        log(f"device time {label} {feat.shape[0]}x{feat.shape[1]}: "
            f"{dev_ms:.3f} ms in one request under torch.profiler, "
            f"{dev_ms / np.median(times):.3f} of the median latency; "
            "top kernels: " + "; ".join(
                f"{short_name(name)} {us / 1e3:.3f} ms" for name, us in top)
            + "".join(f"; {kern} ({KERNEL_NAMES[kern]}) {ms:.3f} ms"
                      for kern, ms in sorted(runs.items()))
            + f"; {smi}")


TIME_KINDS = ("router", "heavy")      # the routings of the kernel times


def time_quant_kernels(torch, smi):
    """K4 and K5 at the long requests' token counts (511, 1020) under the
    router's routing, and K6 at the short requests' (63, 127) under the
    router's and the heavy routing, each weight-only and a8: the wrapper
    call, its CUDA launches alone, the plain version, and the bound;
    beside each K6 row, K5's launches alone on the same tokens, gate and
    weights (its yardstick: the same tiles on the run-length layout).
    Weights are stacked over 6 layers and the layer rotates with each
    call, so a call finds its weights in device memory, not in the 50 MB
    L2, as the main path's layer loop does. Returns rows keyed by
    (kernel, a8, n, routing)."""
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops import moe_q4, moe_runs
    gen = torch.Generator(device="cuda").manual_seed(5)
    n_layers = 6
    rows = {}
    lib_r, lib_q = kernels.MOE_RUNS.load(), kernels.MOE_Q4.load()
    stream = torch.cuda.current_stream().cuda_stream
    for bits in (8, 4):
        p = quant_experts(torch, bits, gen, n_layers)
        layers = [at_layer(p, i) for i in range(n_layers)]
        k1, k2 = ("w1_q4", "w2_q4") if bits == 4 else ("w1_q", "w2_q")
        w1 = p[k1].reshape((n_layers * E,) + tuple(p[k1].shape[2:]))
        w2 = p[k2].reshape((n_layers * E,) + tuple(p[k2].shape[2:]))
        s1 = [q["w1_scale"].reshape(E, -1, H) for q in layers]
        s2 = [q["w2_scale"].reshape(E, -1, D) for q in layers]
        b1, b2 = p["b1"], p["b2"]
        per_expert = (w1[0].numel() + w2[0].numel()
                      + 4 * (s1[0][0].numel() + s2[0][0].numel())
                      + 2 * (H + D))          # bytes: weights, scales, biases
        fmt = 1 if bits == 8 else 2
        cases = [("K4" if bits == 8 else "K5", n, "router")
                 for n in (511, 1020)]
        if bits == 4:
            cases += [("K6", n, kind) for n in (63, 127) for kind in TIME_KINDS]
        for kname, n, kind in cases:
            for a8 in (False, True):
                x = torch.randn(1, n, D, generator=gen, device="cuda") \
                    .to(torch.bfloat16)
                gate = routing(torch, kind, n, gen)
                active = n_active(torch, gate)
                t_bytes = (active * per_expert + 2 * n * D * 2 + n * 4) \
                    / HBM_BYTES_PER_S * 1e3
                t_ops = 4 * n * D * H / PEAK_OPS_PER_S[
                    "int8" if a8 else "bfloat16"] * 1e3
                # the run-length layout and scratch (K4/K5, and K6's
                # yardstick K5), and K6's
                lay = moe_runs.runs_layout(gate.reshape(n), E)
                x_pad = moe_runs._pad_tokens(x.reshape(n, D), lay,
                                             moe_runs.TILE)
                rows_n = lay.n_tiles * moe_runs.TILE
                x2, g2 = x.reshape(n, D), gate.reshape(n)
                front = torch.empty(lib_q.moe_q4_front_ints(n, E),
                                    dtype=torch.int32, device="cuda")
                hdt = torch.float32 if a8 else torch.bfloat16
                hid = torch.empty(max(rows_n, n), H, device="cuda",
                                  dtype=hdt)
                xq = torch.empty(max(rows_n, n), D, dtype=torch.int8,
                                 device="cuda")
                hq = torch.empty(max(rows_n, n), H, dtype=torch.int8,
                                 device="cuda")
                xs = torch.empty(max(rows_n, n), device="cuda")
                hs = torch.empty(max(rows_n, n), device="cuda")
                y = torch.empty_like(x_pad)

                def runs_raw(i):
                    j = i % n_layers
                    if lib_r.moe_runs_q(
                            fmt, int(a8), x_pad.data_ptr(),
                            w1.data_ptr(), s1[j].data_ptr(), s1[j].shape[1],
                            b1.data_ptr(), w2.data_ptr(), s2[j].data_ptr(),
                            s2[j].shape[1], b2.data_ptr(),
                            lay.tile_e.data_ptr(), lay.starts.data_ptr(),
                            lay.n_tiles, E, j, D, H, hid.data_ptr(),
                            xq.data_ptr(), xs.data_ptr(), hq.data_ptr(),
                            hs.data_ptr(), y.data_ptr(), stream):
                        raise SystemExit("FAIL times: moe_runs_q launch "
                                         "error")

                def dense_raw(i):
                    j = i % n_layers
                    if lib_q.moe_q4_dense(
                            int(a8), x2.data_ptr(), g2.data_ptr(), n,
                            w1.data_ptr(), s1[j].data_ptr(), s1[j].shape[1],
                            b1.data_ptr(), w2.data_ptr(), s2[j].data_ptr(),
                            s2[j].shape[1], b2.data_ptr(), E, j, D, H,
                            front.data_ptr(), hid.data_ptr(), xq.data_ptr(),
                            xs.data_ptr(), hq.data_ptr(), hs.data_ptr(),
                            y.data_ptr(), stream):
                        raise SystemExit("FAIL times: moe_q4_dense launch "
                                         "error")
                if kname == "K6":
                    kern = moe_q4.q4_kernel
                    plain = moe_q4.moe_experts_q4_reference
                    raw = dense_raw
                else:
                    kern = moe_runs.runs_q8_kernel if bits == 8 else \
                        moe_runs.runs_q4_kernel
                    plain = moe_runs.moe_experts_runs_reference
                    raw = runs_raw
                ms = cuda_time_ms(torch, lambda i: kern.launch(
                    layers[i % n_layers], x, gate, i % n_layers,
                    act_quant=a8), 60)
                alone = cuda_time_ms(torch, raw, 60)
                plain_ms = cuda_time_ms(torch, lambda i: plain(
                    layers[i % n_layers], x, gate, i % n_layers,
                    act_quant=a8), 6)
                bound = max(t_bytes, t_ops)
                rows[(kname, a8, n, kind)] = dict(
                    ms=ms, alone=alone, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
                yard = ""
                if kname == "K6":
                    k5 = cuda_time_ms(torch, runs_raw, 60)
                    rows[(kname, a8, n, kind)]["k5_alone"] = k5
                    yard = f", yardstick K5 alone {k5:.4f} ms"
                log(f"time {QUANT_NAMES[(kname, a8)]} ({kname}) n={n} {kind} "
                    f"active={active}: call {ms:.4f} ms (kernels alone "
                    f"{alone:.4f} ms{yard}), plain {plain_ms:.4f} ms, bound "
                    f"{bound:.4f} ms (bytes {t_bytes:.4f} / ops "
                    f"{t_ops:.4f}), library_ms none; {smi}")
    return rows


def time_stage_kernels(torch, smi):
    """K8 (fp32, bf16, int8) at the requests' token counts (63, 511, 1020)
    under the router's and the heavy routing, and K7 (weight-only on bf16
    and float32 activations, a8) under the router's: the wrapper call,
    its CUDA launches alone, the plain version, and the bound; beside each
    K8 row, K1's launches alone on the same tokens and gate (its
    yardstick: fp32 K1 for fp32 K8, bf16 K1 for bf16 and int8 K8; float
    K8 on K1's weights), beside each bf16 K7 row K5's (the same weights
    and arithmetic on the run-length layout's 32-row tiles) and K7's own
    launches on that layout (tile 32), which part the cost of the 64/128-row
    tiles' layout from that of K7's tile arithmetic. Six layers of
    weights, the layer rotating with each call, so that a call finds its
    weights in device memory, as the main path's layer loop does. Returns
    rows keyed by (variant name, n, routing)."""
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops import moe_q4, moe_runs, moe_stream
    gen = torch.Generator(device="cuda").manual_seed(10)
    n_layers = 6
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}

    def record(name, n, kind, active, per_expert, elt_x, ops_type, ms,
               alone, plain_ms, yard=None, yard_name="K1", extra=""):
        t_bytes = (active * per_expert + 2 * n * D * elt_x + n * 4) \
            / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * n * D * H / PEAK_OPS_PER_S[ops_type] * 1e3
        bound = max(t_bytes, t_ops)
        rows[(name, n, kind)] = dict(
            ms=ms, alone=alone, plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            yard_alone=yard)
        log(f"time {name} n={n} {kind} active={active}: call {ms:.4f} ms "
            f"(kernels alone {alone:.4f} ms"
            + ("" if yard is None else
               f", yardstick {yard_name} alone {yard:.4f} ms")
            + extra + f"), plain {plain_ms:.4f} ms, bound {bound:.4f} ms (bytes "
            f"{t_bytes:.4f} / ops {t_ops:.4f}), library_ms none; {smi}")

    lib, lib_r = kernels.MOE_STREAM.load(), kernels.MOE_RUNS.load()
    for wtype, name in STREAM_NAMES.items():
        quant = wtype == "int8"
        xdt = torch.float32 if wtype == "float32" else torch.bfloat16
        code = 0 if xdt == torch.float32 else 1
        # K1's stacked weights in x's type; float K8 takes their layers
        pk = expert_weights(torch, xdt, gen, n_layers=n_layers)
        k1w1 = pk["w1"].reshape(n_layers * E, D, H)
        k1w2 = pk["w2"].reshape(n_layers * E, H, D)
        if quant:
            layers = stream_layers(torch, wtype, gen, n_layers)
        else:
            layers = [{"w1": pk["w1"][i], "w2": pk["w2"][i], "b1": pk["b1"],
                       "b2": pk["b2"]} for i in range(n_layers)]
        # the kernel's arguments per layer: float32 biases, (E, out) scales
        raw_args = []
        for p in layers:
            w1, w2 = (p["w1_q"], p["w2_q"]) if quant else (p["w1"], p["w2"])
            s1 = p["w1_scale"].reshape(E, H) if quant else None
            s2 = p["w2_scale"].reshape(E, D) if quant else None
            raw_args.append((w1, s1, p["b1"].float(), w2, s2,
                             p["b2"].float()))
        w_elt = layers[0]["w1_q" if quant else "w1"].element_size()
        # bytes per active expert: weights, scales, biases at their types
        per_expert = 2 * D * H * w_elt + (4 * (H + D) if quant else 0) \
            + layers[0]["b1"].element_size() * (H + D)
        for n in STAGE_TOKENS:
            for kind in TIME_KINDS:
                x = torch.randn(1, n, D, generator=gen,
                                device="cuda").to(xdt)
                gate = routing(torch, kind, n, gen)
                x2, g2 = x.reshape(n, D), gate.reshape(n)
                front = torch.empty(lib.moe_stream_front_ints(n, E),
                                    dtype=torch.int32, device="cuda")
                hid = torch.empty(n, H, dtype=xdt, device="cuda")
                y = torch.empty_like(x2)
                lay = moe_runs.runs_layout(g2, E)
                x_pad = moe_runs._pad_tokens(x2, lay, moe_runs.TILE)
                k1_hid = torch.empty(lay.n_tiles * moe_runs.TILE, H,
                                     dtype=xdt, device="cuda")
                y_pad = torch.empty_like(x_pad)

                def raw(i):
                    w1, s1, b1, w2, s2, b2 = raw_args[i % n_layers]
                    if lib.moe_stream(
                            code, int(quant), x2.data_ptr(), g2.data_ptr(),
                            n, w1.data_ptr(),
                            None if s1 is None else s1.data_ptr(),
                            b1.data_ptr(), w2.data_ptr(),
                            None if s2 is None else s2.data_ptr(),
                            b2.data_ptr(), E, D, H, front.data_ptr(),
                            hid.data_ptr(), y.data_ptr(), stream):
                        raise SystemExit("FAIL times: moe_stream launch "
                                         "error")

                def k1_raw(i):
                    if lib_r.moe_runs_f(
                            code, x_pad.data_ptr(), k1w1.data_ptr(),
                            pk["b1"].data_ptr(), k1w2.data_ptr(),
                            pk["b2"].data_ptr(), lay.tile_e.data_ptr(),
                            lay.starts.data_ptr(), lay.counts.data_ptr(),
                            lay.n_tiles, E, i % n_layers, D, H,
                            k1_hid.data_ptr(), y_pad.data_ptr(), stream):
                        raise SystemExit("FAIL times: moe_runs_f launch "
                                         "error")
                ms = cuda_time_ms(
                    torch, lambda i: moe_stream.stream_kernel.launch(
                        layers[i % n_layers], x, gate), 60)
                alone = cuda_time_ms(torch, raw, 60)
                yard = cuda_time_ms(torch, k1_raw, 60)
                plain_ms = cuda_time_ms(
                    torch,
                    lambda i: moe_stream.moe_experts_dense_stream_reference(
                        layers[i % n_layers], x, gate), 6)
                record(name, n, kind, n_active(torch, gate), per_expert,
                       x.element_size(),
                       "float32" if wtype == "float32" else "bfloat16", ms,
                       alone, plain_ms, yard)
        layers = raw_args = pk = k1w1 = k1w2 = None

    lib = kernels.MOE_Q4_TILED.load()
    p = quant_experts(torch, 4, gen, n_layers)
    layers = [at_layer(p, i) for i in range(n_layers)]
    w1 = p["w1_q4"].reshape(n_layers * E, D, H // 2)
    w2 = p["w2_q4"].reshape(n_layers * E, H, D // 2)
    s1 = [q["w1_scale"].reshape(E, -1, H) for q in layers]
    s2 = [q["w2_scale"].reshape(E, -1, D) for q in layers]
    b1, b2 = p["b1"].float(), p["b2"].float()
    per_expert = (w1[0].numel() + w2[0].numel()
                  + 4 * (s1[0][0].numel() + s2[0][0].numel())
                  + 2 * (H + D))              # packed weights, scales, biases
    for n in STAGE_TOKENS:
        tile = moe_q4.tiled_tile(n)
        for a8, xdt in ((False, torch.bfloat16), (True, torch.bfloat16),
                        (False, torch.float32)):
            x = torch.randn(1, n, D, generator=gen, device="cuda").to(xdt)
            gate = routing(torch, "router", n, gen)
            lay = moe_runs.runs_layout(gate.reshape(n), E, tile)
            x_pad = moe_runs._pad_tokens(x.reshape(n, D), lay, tile)
            rows_n = lay.n_tiles * tile
            # K5's run-length layout of the same tokens
            lay5 = moe_runs.runs_layout(gate.reshape(n), E)
            x_pad5 = moe_runs._pad_tokens(x.reshape(n, D), lay5,
                                          moe_runs.TILE)
            rows_n = max(rows_n, lay5.n_tiles * moe_runs.TILE)
            hid = torch.empty(rows_n, H, device="cuda", dtype=torch.float32
                              if a8 else xdt)
            xq = torch.empty(rows_n, D, dtype=torch.int8, device="cuda")
            hq = torch.empty(rows_n, H, dtype=torch.int8, device="cuda")
            xs = torch.empty(rows_n, device="cuda")
            hs = torch.empty(rows_n, device="cuda")
            y_pad = torch.empty(rows_n, D, device="cuda", dtype=xdt)
            code = 0 if xdt == torch.float32 else 1

            def raw(i):
                j = i % n_layers
                if lib.moe_q4_tiled(
                        code, int(a8), x_pad.data_ptr(), w1.data_ptr(),
                        s1[j].data_ptr(), s1[j].shape[1], b1.data_ptr(),
                        w2.data_ptr(), s2[j].data_ptr(), s2[j].shape[1],
                        b2.data_ptr(), lay.tile_e.data_ptr(),
                        lay.starts.data_ptr(), lay.counts.data_ptr(), tile,
                        lay.n_tiles, E, j, D, H, 0, 0.0, hid.data_ptr(),
                        xq.data_ptr(), xs.data_ptr(), hq.data_ptr(),
                        hs.data_ptr(), y_pad.data_ptr(), stream):
                    raise SystemExit("FAIL times: moe_q4_tiled launch error")

            def raw32(i):          # K7 on K5's layout: tile 32
                j = i % n_layers
                if lib.moe_q4_tiled(
                        code, int(a8), x_pad5.data_ptr(), w1.data_ptr(),
                        s1[j].data_ptr(), s1[j].shape[1], b1.data_ptr(),
                        w2.data_ptr(), s2[j].data_ptr(), s2[j].shape[1],
                        b2.data_ptr(), lay5.tile_e.data_ptr(),
                        lay5.starts.data_ptr(), lay5.counts.data_ptr(),
                        moe_runs.TILE, lay5.n_tiles, E, j, D, H, 0, 0.0,
                        hid.data_ptr(), xq.data_ptr(), xs.data_ptr(),
                        hq.data_ptr(), hs.data_ptr(), y_pad.data_ptr(),
                        stream):
                    raise SystemExit("FAIL times: moe_q4_tiled launch error")

            def k5_raw(i):
                j = i % n_layers
                if lib_r.moe_runs_q(
                        2, int(a8), x_pad5.data_ptr(), w1.data_ptr(),
                        s1[j].data_ptr(), s1[j].shape[1], p["b1"].data_ptr(),
                        w2.data_ptr(), s2[j].data_ptr(), s2[j].shape[1],
                        p["b2"].data_ptr(), lay5.tile_e.data_ptr(),
                        lay5.starts.data_ptr(), lay5.n_tiles, E, j, D, H,
                        hid.data_ptr(), xq.data_ptr(), xs.data_ptr(),
                        hq.data_ptr(), hs.data_ptr(), y_pad.data_ptr(),
                        stream):
                    raise SystemExit("FAIL times: moe_runs_q launch error")
            ms = cuda_time_ms(torch, lambda i: moe_q4.q4_tiled_kernel.launch(
                layers[i % n_layers], x, gate, layer=i % n_layers,
                act_quant=a8), 60)
            alone = cuda_time_ms(torch, raw, 60)
            yard = None if xdt == torch.float32 else \
                cuda_time_ms(torch, k5_raw, 60)
            at32 = cuda_time_ms(torch, raw32, 60)
            plain_ms = cuda_time_ms(
                torch, lambda i: moe_q4.moe_experts_q4_tiled_reference(
                    layers[i % n_layers], x, gate, layer=i % n_layers,
                    act_quant=a8), 6)
            record(TILED_F32 if xdt == torch.float32 else TILED_NAMES[a8],
                   n, "router", n_active(torch, gate), per_expert,
                   x.element_size(), "int8" if a8 else str(xdt)[6:], ms,
                   alone, plain_ms, yard, "K5",
                   f", K7 alone at tile 32 {at32:.4f} ms")
    return rows


FLASH_TIME_SHAPES = ((4, 255, 249), (1, 511, 511))   # (B, T = S, valid)


def time_flash_kernels(torch, smi):
    """K2 and K3 at the two attention shapes of the main path: the 4x1000
    request's (B=4, T=S=255, valid lengths 249) and the 1x2048 request's
    (B=1, T=S=511, all valid), MoE blocks (H=8, Dk=64) and embed blocks
    (H=4, Dk=128), f32 and bf16: the wrapper call, the CUDA launches alone
    (with each launch's tile rows and blocks), the plain version, one
    PyTorch call that computes the same function
    (scaled_dot_product_attention with a boolean key mask; its backward
    through autograd), and the bound; and the device time alone, under
    torch.profiler, of the wrapper call and of the PyTorch call, which
    the host's speed does not move, taken in turns (paired_device_ms).
    Returns rows keyed by (kernel, dtype, B, H)."""
    import torch.nn.functional as F
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(8)
    lib = kernels.FLASH.load()
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for B, T, n_valid in FLASH_TIME_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            code = 0 if dtype == torch.float32 else 1
            for Hh, Dk in FLASH_HEADS:
                D2, scale = 2 * Dk, Dk ** -0.5
                q2, k2, v, g, _, _, _ = flash_inputs(
                    torch, B, T, Hh, Dk, dtype, "lengths", gen)
                lens = torch.full((B,), n_valid, dtype=torch.int32,
                                  device="cuda")
                out, lse = fa.flash_kernels.forward(q2, k2, v, lens, scale,
                                                    return_lse=True)
                delta = (g.float() * out.float()).sum(-1, keepdim=True)
                out_k, dq2, dk2, dv = (torch.empty_like(t)
                                       for t in (out, q2, k2, v))
                args = (code, D2, Dk, q2.data_ptr(), k2.data_ptr(),
                        v.data_ptr())
                masks = (lens.data_ptr(), None, None, 0, B, Hh, T, T, scale)
                # the wrapper's tile heights: K2 and dQ per query, dK/dV
                # per key
                f_rows, (b_rows, _) = fa.launch_rows(q2, k2)
                grid = {"K2": f"{f_rows} rows, "
                              f"{B * Hh * -(-T // f_rows)} blocks",
                        "K3": f"{b_rows} rows, "
                              f"{B * Hh * -(-T // b_rows)} blocks each"}

                def fwd_raw(i):
                    if lib.flash_fwd(*args, *masks, f_rows, out_k.data_ptr(),
                                     None, stream):
                        raise SystemExit("FAIL times: flash_fwd launch error")

                def bwd_raw(i):
                    grads = (g.data_ptr(), lse.data_ptr(), delta.data_ptr())
                    if lib.flash_bwd_dq(*args, *grads, *masks, b_rows,
                                        dq2.data_ptr(), stream) or \
                            lib.flash_bwd_dkv(*args, *grads, *masks, b_rows,
                                              dk2.data_ptr(), dv.data_ptr(),
                                              stream):
                        raise SystemExit("FAIL times: flash_bwd launch error")

                key_mask = (torch.arange(T, device="cuda")[None, :]
                            < lens[:, None])[:, None, None, :]
                ql, kl, vl = (t.detach().requires_grad_(True)
                              for t in (q2, k2, v))
                lib_out = F.scaled_dot_product_attention(
                    ql, kl, vl, attn_mask=key_mask, scale=scale)
                elt = q2.element_size()
                # the work this run's data needs: valid query rows x valid
                # keys
                pairs = B * Hh * n_valid * n_valid
                times = {
                    "K2": dict(
                        ms=cuda_time_ms(
                            torch, lambda i: fa.flash_kernels.forward(
                                q2, k2, v, lens, scale), 50),
                        alone=cuda_time_ms(torch, fwd_raw, 50),
                        plain_ms=cuda_time_ms(
                            torch, lambda i: fa.flash_attention_reference(
                                q2, k2, v, lens, scale), 10),
                        library_ms=cuda_time_ms(
                            torch, lambda i: F.scaled_dot_product_attention(
                                q2, k2, v, attn_mask=key_mask, scale=scale),
                            50),
                        nbytes=elt * B * Hh * T * (2 * D2 + 2 * Dk) + 4 * B,
                        ops=2 * pairs * (D2 + Dk)),
                    "K3": dict(
                        ms=cuda_time_ms(
                            torch, lambda i: fa.flash_kernels.backward(
                                q2, k2, v, g, lse, delta, lens, scale), 50),
                        alone=cuda_time_ms(torch, bwd_raw, 50),
                        plain_ms=cuda_time_ms(
                            torch, lambda i: fa.flash_attention_bwd_reference(
                                q2, k2, v, g, lse, delta, lens, scale), 10),
                        library_ms=cuda_time_ms(
                            torch, lambda i: torch.autograd.grad(
                                lib_out, (ql, kl, vl), g, retain_graph=True),
                            50),
                        # read q2, k2, v, g, lse, delta; write dq2, dk2, dv
                        nbytes=(elt * B * Hh * T * (4 * D2 + 3 * Dk)
                                + 8 * B * Hh * T + 4 * B),
                        # scores again, dp, dv, dq, dk
                        ops=2 * pairs * (3 * D2 + 2 * Dk))}
                device = {
                    "K2": (lambda: fa.flash_kernels.forward(
                        q2, k2, v, lens, scale),
                           lambda: F.scaled_dot_product_attention(
                               q2, k2, v, attn_mask=key_mask, scale=scale)),
                    "K3": (lambda: fa.flash_kernels.backward(
                        q2, k2, v, g, lse, delta, lens, scale),
                           lambda: torch.autograd.grad(
                               lib_out, (ql, kl, vl), g, retain_graph=True))}
                for kname, r in times.items():
                    dev, lib_dev = (
                        "{:.4f} ms ({:.4f}-{:.4f})".format(*t)
                        for t in paired_device_ms(torch, *device[kname]))
                    t_bytes = r.pop("nbytes") / HBM_BYTES_PER_S * 1e3
                    t_ops = r.pop("ops") / PEAK_OPS_PER_S[dname] * 1e3
                    r["bound_ms"] = max(t_bytes, t_ops)
                    r["bound_by"] = ("bytes" if t_bytes >= t_ops
                                     else "operations")
                    rows[(kname, dname, B, Hh)] = r
                    log(f"time flash {kname} {dname} B={B} T={T} H={Hh} "
                        f"Dk={Dk} ({grid[kname]}): call {r['ms']:.4f} ms "
                        f"(kernels alone {r['alone']:.4f} ms, device "
                        f"{dev}), plain {r['plain_ms']:.4f} ms, "
                        f"scaled_dot_product_attention {r['library_ms']:.4f}"
                        f" ms (device {lib_dev}), bound "
                        f"{r['bound_ms']:.4f} ms (bytes {t_bytes:.4f} / ops "
                        f"{t_ops:.4f}); {smi}")
    return rows


K1_TIME_TOKENS = (63, 511, 1020)      # the requests' token counts


def time_k1(torch, smi):
    """K1 at the requests' token counts (router routing, layers rotated so
    weights come from device memory): the wrapper call, its two CUDA
    launches alone (printed with the column block, the live tiles and the
    live blocks of each launch), the plain version, and the bound.
    Returns rows keyed by (dtype, tokens)."""
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops import moe_runs
    gen = torch.Generator(device="cuda").manual_seed(3)
    lib = kernels.MOE_RUNS.load()
    bn = lib.moe_runs_f_col_block()
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        p = expert_weights(torch, dtype, gen)
        w1 = p["w1"].reshape(L * E, D, H)
        w2 = p["w2"].reshape(L * E, H, D)
        for n in K1_TIME_TOKENS:
            x = torch.randn(1, n, D, generator=gen, device="cuda").to(dtype)
            gate = routing(torch, "router", n, gen)
            active = n_active(torch, gate)
            elt = x.element_size()
            nbytes = (active * (2 * D * H + H + D) * elt   # weights+biases
                      + 2 * n * D * elt + n * 4)           # x, y, gate
            ops = 4 * n * D * H
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS_PER_S[dname] * 1e3
            ms = cuda_time_ms(torch, lambda i: moe_runs.runs_kernel.launch(
                p, x, gate, i % L), 54)
            plain = cuda_time_ms(
                torch, lambda i: moe_runs.moe_experts_runs_reference(
                    p, x, gate, i % L), 18)
            # the two CUDA launches alone, without the layout prep
            lay = moe_runs.runs_layout(gate.reshape(n), E)
            x_pad = moe_runs._pad_tokens(x.reshape(n, D), lay,
                                         moe_runs.TILE)
            hid = torch.empty(lay.n_tiles * moe_runs.TILE, H, dtype=dtype,
                              device="cuda")
            y_pad = torch.empty_like(x_pad)
            live = int(lay.starts[-1])

            def raw(i):
                if lib.moe_runs_f(
                        0 if dtype == torch.float32 else 1,
                        x_pad.data_ptr(), w1.data_ptr(), p["b1"].data_ptr(),
                        w2.data_ptr(), p["b2"].data_ptr(),
                        lay.tile_e.data_ptr(), lay.starts.data_ptr(),
                        lay.counts.data_ptr(), lay.n_tiles, E, i % L, D, H,
                        hid.data_ptr(), y_pad.data_ptr(), stream):
                    raise SystemExit("FAIL times: launch error")
            alone = cuda_time_ms(torch, raw, 54)
            bound = max(t_bytes, t_ops)
            rows[(dname, n)] = dict(
                ms=ms, alone=alone, plain_ms=plain, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            log(f"time moe_runs_f {dname} n={n} active={active}: call "
                f"{ms:.4f} ms (kernels alone {alone:.4f} ms at column "
                f"block {bn}: {live} live tiles of {lay.n_tiles}, live "
                f"blocks GEMM1 {live * H // bn}, GEMM2 {live * D // bn}), "
                f"plain {plain:.4f} ms, bound {bound:.4f} ms (bytes "
                f"{t_bytes:.4f} / ops {t_ops:.4f}), library_ms none; {smi}")
    return rows


def phase_times(torch, state, smi):
    launches = state["launches"]
    rows = time_k1(torch, smi)

    for dtype, (eng, _) in state["engines"].items():
        request_times(torch, eng, dtype, state["requests"], smi)

    report = []
    for dname in ("float32", "bfloat16"):
        r = rows[(dname, 63)]
        report.append({
            "name": f"moe_runs_f[{dname}]", "route": "cuda",
            "source": "m3asr_tpu_torch/csrc/moe_runs.cu",
            "replaces": "m3asr_tpu/ops/pallas_moe_runs.py:350",
            "launches": launches[dname] + state["launches_stream"][dname]
            + (state["launches_recognize"] if dname == "bfloat16" else 0),
            "max_abs_err": state["max_err"][dname],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    qrows = time_quant_kernels(torch, smi)
    for (kname, a8), name in QUANT_NAMES.items():
        mode = MODES[("int4" if kname != "K4" else "int8", a8)]
        r = qrows[(kname, a8, 63 if kname == "K6" else 511, "router")]
        report.append({
            "name": name, "route": "cuda",
            "source": "m3asr_tpu_torch/csrc/"
                      + ("moe_q4.cu" if kname == "K6" else "moe_runs.cu"),
            "replaces": "m3asr_tpu/ops/pallas_moe_q4.py:320"
                        if kname == "K6"
                        else "m3asr_tpu/ops/pallas_moe_runs.py:350",
            "launches": state["launches_q"][mode][kname] + (
                state["launches_stream"]["int4"]
                if (kname, a8) == ("K6", False) else 0),
            "max_abs_err": state["max_err_q"][(kname, a8)],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    frows = time_flash_kernels(torch, smi)
    for kname, fname, line in (("K2", "flash_fwd", 145),
                               ("K3", "flash_bwd", 377)):
        for dname in ("float32", "bfloat16"):
            r = frows[(kname, dname, 4, 8)]   # B=4, T=255, MoE blocks
            report.append({
                "name": f"{fname}[{dname}]", "route": "cuda",
                "source": "m3asr_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"m3asr_tpu/ops/pallas_attention.py:{line}",
                "launches": state["launches_flash"][(kname, dname)],
                # phase 3's shapes and phase 19's sp shape
                "max_abs_err": max(
                    state["max_err_flash"][(kname, dname)],
                    state.get("max_err_flash_sp", {}).get((kname, dname),
                                                          0.0)),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]})
    srows = time_stage_kernels(torch, smi)
    for name, n, source, line in (
            [(v, STAGE_TOKENS[0], "moe_stream.cu", "pallas_moe.py:147")
             for v in STREAM_NAMES.values()]
            + [(v, STAGE_TOKENS[1], "moe_q4_tiled.cu", "pallas_moe_q4.py:596")
               for v in TILED_NAMES.values()]):
        r = srows[(name, n, "router")]
        report.append({
            "name": name, "route": "cuda",
            "source": f"m3asr_tpu_torch/csrc/{source}",
            "replaces": f"m3asr_tpu/ops/{line}",
            "launches": state["launches_stage"][name],
            "max_abs_err": state["max_err_stage"][name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    return report


# ---------------------------------------------------------------------------
# 13. DFSMN: the ReLU experts, flash_attn_mem and the served model
# ---------------------------------------------------------------------------

DFSMN_MOE = "dfsmn_san_fmoe_localComm_catEmbed"
DFSMN_REQUESTS = ((1, 512), (4, 1000), (1, 6144))
DFSMN_SHORT = (1, 100)      # int4 / w4a8: the 1x128 bucket of 128 tokens
DFSMN_BUCKETS = "1x512,4x1024,1x6144"
DFSMN_SHORT_BUCKET = "1x128"
RELU_UPPER = 1.0            # the DFSMN experts' clamp
RELU = dict(activation="relu", upper_bound=RELU_UPPER)
# 16 and 128: a stream's chunk and a tick of 8 slots (phase 14)
DFSMN_K1_TOKENS = (16, 128, 512, 2048, 4096, 24576)
DFSMN_K6_TOKENS = (16, 63, 127, 128)
DFSMN_Q_TOKENS = (512, 4096)
# (kernel, variant) -> the ReLU instantiation's name in the output
RELU_NAMES = {("K1", "float32"): "moe_runs_f[float32 relu]",
              ("K1", "bfloat16"): "moe_runs_f[bfloat16 relu]",
              ("K4", False): "moe_runs_q8[int8 relu]",
              ("K4", True): "moe_runs_q8[w8a8 relu]",
              ("K5", False): "moe_runs_q4[int4 relu]",
              ("K5", True): "moe_runs_q4[w4a8 relu]",
              ("K6", False): "moe_q4_dense[int4 relu]",
              ("K6", True): "moe_q4_dense[w4a8 relu]",
              ("K7", False): "moe_q4_tiled[int4 relu]",
              ("K7", True): "moe_q4_tiled[w4a8 relu]"}
FLASH_MEM_NAMES = {"float32": "flash_attn_mem[float32]",
                   "bfloat16": "flash_attn_mem[bfloat16]"}
FLASH_MEM_SHAPES = ((1, 2048), (1, 6144), (4, 1000))
DFSMN_HEADS, DFSMN_SLOTS = 8, 64     # heads of 64, memory slots
# served engines: (label, build flags or the label of the engine whose
# quantized tree it takes and the EngineConfig settings, the requests it
# answers: "all", or "short" too (a 1x128 bucket: K6), or "one" (1x512),
# the kernel each request's forward launches once per MoE layer)
DFSMN_ENGINES = (
    ("float32", [], "all", "K1"),
    ("bfloat16", ["-f"], "all", "K1"),
    ("bfloat16+flash", ["-f", "--attn_impl", "flash"], "all", "K1"),
    ("int8", ["--int8"], "all", "K4"),
    ("w8a8", ("int8", dict(dtype="int8", act_quant=True)), "all", "K4"),
    ("int4", ["--int4"], "short", "K5"),
    ("w4a8", ["--int4", "--act_quant"], "short", "K5"),
    ("int4 tiled", ("int4", dict(dtype="int4", moe_impl="tiled")), "one",
     "K7"),
    ("w4a8 tiled", ("w4a8", dict(dtype="int4", act_quant=True,
                                 moe_impl="tiled")), "one", "K7"),
)
# the engines each engine's tree is still needed by, and when it goes
DFSMN_FREE_AFTER = {"float32": ("float32",),
                    "bfloat16+flash": ("bfloat16", "bfloat16+flash"),
                    "w8a8": ("int8", "w8a8"),
                    "w4a8 tiled": ("int4", "w4a8", "int4 tiled",
                                   "w4a8 tiled")}


def dfsmn_raw(proto=DFSMN_MOE, each=DFSMN_EACH_BLOCK):
    """The reference Net's widths (DfsmnEncoderConfig's defaults) in the
    reference YAML schema: 3 blocks x ``each`` cFSMN (the Net's 10, cut to
    DFSMN_EACH_BLOCK for time outside phase 17), hidden 1024, memory 512, 8
    heads, 64 memory slots, LN; the MoE proto with 32 experts (as the
    flagship), routers drawn at random (rand_init_router), and an embed
    sub-net of the same defaults."""
    fsmn = {"hidden_dim": 1024, "memory_dim": 512, "look_back": 4,
            "look_ahead": 1, "stride_left": 2, "stride_right": 1}
    san = {"num_head": DFSMN_HEADS, "num_memory": DFSMN_SLOTS,
           "norm_type": "LN"}
    if "fmoe" not in proto:
        return {"nnet_proto": proto, "input_dim": 40, "output_dim": 5000,
                "model_conf": {"num_block": 3,
                               "fsmn_each_block": each,
                               **fsmn, **san}}
    return {"nnet_proto": proto, "input_dim": 40, "output_dim": 5000,
            "model_conf": {
                "num_block": 3, "fsmn_each_block": each,
                "fsmn_conf": fsmn,
                "san_conf": san,
                "moe_conf": {"num_experts": E, "rand_init_router": True},
                "embed_conf": {"num_block": 3,
                               "fsmn_each_block": each,
                               **fsmn, **san}}}


def unstacked(p):
    """One layer of stacked (1, E, ...) weights and scales, as the DFSMN
    layers hold them, without b2 (the DFSMN experts' mem_proj has no
    bias)."""
    return {k: v[0] if k.startswith("w") else v for k, v in p.items()
            if k != "b2"}


def phase_kernel_dfsmn(torch):
    """K1, K4-K7's ReLU instantiations (hidden clamped at 1.0) against
    their plain versions at the DFSMN widths (E=32, d=512, h=1024,
    unstacked weights, no b2) and token counts, under the router's, one
    expert's, half-empty and heavy routing: K1 fp32/bf16 at 16-24576
    tokens (16 and 128: phase 14's stream chunk and tick; the 8x6144
    bucket is 49152 rows), K4/K5 weight-only and a8 at 512 and 4096, K6
    at 16, 63, 127 and 128, K7 at 511. x is drawn 3x larger
    than phase 3's so that about a fifth of the hidden values reach the
    clamp. Phase 3's tolerances; K5 a8 must equal K6 a8 (127 tokens) and
    K7 a8 (511) bit for bit. Returns the worst max_abs_err per name."""
    from m3asr_tpu_torch.ops import moe_q4, moe_runs
    gen = torch.Generator(device="cuda").manual_seed(13)
    worst = {}
    kinds = KINDS + ("heavy",)

    def check(key, kern, plain, p, n, kind, dtype, **kw):
        name = RELU_NAMES[key]
        x = (torch.randn(1, n, D, generator=gen, device="cuda") * 3) \
            .to(dtype)
        gate = routing(torch, kind, n, gen)
        got = kern.launch(p, x, gate, **kw, **RELU)
        torch.cuda.synchronize()
        ref = plain(p, x, gate, **kw, **RELU)
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = (None if dtype == torch.float32 else
               2e-2 if kw.get("act_quant") else 1e-2)
        ok = (torch.allclose(got, ref, rtol=1e-5, atol=1e-5) if tol is None
              else err <= tol * scale)
        log(f"kernel {name} n={n} {kind} active={n_active(torch, gate)}: "
            f"max_abs_err={err:.3e} max|ref|={scale:.3e} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"FAIL kernel: {name} disagrees with its plain "
                             "version")
        worst[name] = max(worst.get(name, 0.0), err)
        return x, gate, got

    for dtype in (torch.float32, torch.bfloat16):
        p = unstacked(expert_weights(torch, dtype, gen, n_layers=1))
        for n in DFSMN_K1_TOKENS:
            for kind in kinds:
                check(("K1", str(dtype)[6:]), moe_runs.runs_kernel,
                      moe_runs.moe_experts_runs_reference, p, n, kind, dtype)
    bf = torch.bfloat16
    for bits, kname, kern in ((8, "K4", moe_runs.runs_q8_kernel),
                              (4, "K5", moe_runs.runs_q4_kernel)):
        p = unstacked(quant_experts(torch, bits, gen, 1))
        for a8 in (False, True):
            for n in DFSMN_Q_TOKENS:
                for kind in kinds:
                    check((kname, a8), kern,
                          moe_runs.moe_experts_runs_reference, p, n, kind,
                          bf, act_quant=a8)
    p = unstacked(quant_experts(torch, 4, gen, 1))
    for a8 in (False, True):
        for n in DFSMN_K6_TOKENS:
            for kind in kinds:
                x, gate, got = check(("K6", a8), moe_q4.q4_kernel,
                                     moe_q4.moe_experts_q4_reference, p, n,
                                     kind, bf, act_quant=a8)
                if a8 and n == 127 and kind in ("router", "heavy"):
                    k5 = moe_runs.runs_q4_kernel.launch(
                        p, x, gate, act_quant=True, **RELU)
                    if not torch.equal(got, k5):
                        raise SystemExit("FAIL kernel: ReLU K6 a8 and K5 a8 "
                                         "differ")
                    log(f"kernel {RELU_NAMES[('K6', True)]} == "
                        f"{RELU_NAMES[('K5', True)]} bit for bit: n={n} "
                        f"{kind}")
        for kind in kinds:
            x, gate, got = check(("K7", a8), moe_q4.q4_tiled_kernel,
                                 moe_q4.moe_experts_q4_tiled_reference, p,
                                 511, kind, bf, act_quant=a8)
            if a8 and kind in ("router", "heavy"):
                k5 = moe_runs.runs_q4_kernel.launch(p, x, gate,
                                                    act_quant=True, **RELU)
                if not torch.equal(got, k5):
                    raise SystemExit("FAIL kernel: ReLU K7 a8 and K5 a8 "
                                     "differ")
                log(f"kernel {RELU_NAMES[('K7', True)]} == "
                    f"{RELU_NAMES[('K5', True)]} bit for bit: n=511 {kind}")
    return worst


def flash_mem_params(torch, dtype, gen):
    """The weights of one DFSMN attention layer (d=512, 8 heads of 64, 64
    memory slots), drawn as models/dfsmn.init_attn_mem draws them."""
    from m3asr_tpu_torch.models import dfsmn
    return {k: (v.to(dtype) if k.endswith("memory")
                else {"kernel": v["kernel"].to(dtype)})
            for k, v in dfsmn.init_attn_mem(gen, D, DFSMN_HEADS,
                                            DFSMN_SLOTS).items()}


def flash_mem_case(torch, B, T, masks, gen):
    """Mixed lengths (and with ``window`` a 16-frame chunk mask) of a
    flash_attn_mem check."""
    from m3asr_tpu_torch.ops import masking
    lens = [T, T - 37, T // 2, 7][:B] if B > 1 else [T - 13]
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    mask = (masking.subsequent_chunk_mask(T, 16, device="cuda")
            if masks == "window" else None)
    return lens, mask


def flash_mem_tol(dname, S):
    """The flash_attn_mem checks' bound: FLASH_TOL, which was set where
    the main path's rows sum at most 512 keys. In float32 the kernel sums
    each row's keys in order, tile after tile, and the plain version in
    cuBLAS's blocked order; the rounding of such sums grows as the square
    root of the keys summed, so a float32 row of S > 512 keys is held to
    FLASH_TOL x sqrt(S / 512) (phase 13 also prints both sides' distance
    from a float64 evaluation)."""
    scale = (S / 512) ** 0.5 if dname == "float32" and S > 512 else 1.0
    return FLASH_TOL[dname] * scale


def phase_kernel_flash_mem(torch):
    """K2 through flash_attn_mem (the DFSMN memory-slot attention: q (B,
    8, T, 64), the 64 slots prepended to k/v, lengths + 64, windows
    shifted by 64 with mem_cols=64) at B=1, T=2048 and 6144 and B=4,
    T=1000, fp32 and bf16, with mixed lengths and with a 16-frame chunk
    window: the kernel against its plain version on the same q, k, v
    (flash_mem_tol of max|ref| on the rows with a valid key; in float32
    both are also measured against the plain version in float64), and
    the whole layer against the plain memory-slot attention
    (attn_mem_layer, "xla") on the valid frames. Returns the worst
    max_abs_err per dtype."""
    from m3asr_tpu_torch.models import dfsmn
    from m3asr_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(14)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        p = flash_mem_params(torch, dtype, gen)
        for B, T in FLASH_MEM_SHAPES:
            for masks in ("lengths", "window"):
                lens, mask = flash_mem_case(torch, B, T, masks, gen)
                x = torch.randn(B, T, D, generator=gen,
                                device="cuda").to(dtype)
                q, k, v, klens, window, mem = fa.attn_mem_inputs(
                    p, x, lens, DFSMN_HEADS, DFSMN_SLOTS, mask)
                scale = (D // DFSMN_HEADS) ** -0.5
                out, _ = fa.flash_kernels.forward(q, k, v, klens, scale,
                                                  window, mem)
                torch.cuda.synchronize()
                ref, _ = fa.flash_attention_reference(q, k, v, klens, scale,
                                                      window, mem)
                rows = (torch.arange(T, device="cuda")[None]
                        < lens[:, None])[:, None, :, None]
                err = ((out.float() - ref.float()).abs() * rows).max().item()
                rel = err / ref.float().abs().max().item()
                exact = ""
                if dtype == torch.float32:
                    s64 = torch.matmul(q.double(), k.double().transpose(
                        -1, -2)) * scale
                    ok64 = fa._attend(B, T, k.shape[2], klens, window, mem,
                                      q.device)
                    s64 = s64.masked_fill(~ok64, -1e30)
                    r64 = torch.matmul(torch.softmax(s64, -1), v.double())
                    s64 = ok64 = None
                    top = r64.abs().max().item()
                    exact = "; from float64: kernel {:.3e}, plain {:.3e}" \
                        .format(*(((a.double() - r64).abs() * rows).max()
                                  .item() / top for a in (out, ref)))
                    r64 = None
                whole = fa.flash_attn_mem(p, x, lens, DFSMN_HEADS,
                                          DFSMN_SLOTS, attn_mask=mask)
                plain = dfsmn.attn_mem_layer(p, x, lens, DFSMN_HEADS,
                                             DFSMN_SLOTS, attn_mask=mask)
                valid = torch.cat([whole[b, :lens[b]] for b in range(B)])
                pvalid = torch.cat([plain[b, :lens[b]] for b in range(B)])
                lrel = ((valid.float() - pvalid.float()).abs().max()
                        / pvalid.float().abs().max()).item()
                tol = flash_mem_tol(dname, k.shape[2])
                ok = rel <= tol and lrel <= tol and np.isfinite(err)
                log(f"kernel {FLASH_MEM_NAMES[dname]} B={B} T={T} "
                    f"S={k.shape[2]} {masks} lens={lens.tolist()} rows "
                    f"{fa.launch_rows(q, k)[0]}: kernel vs plain "
                    f"max|diff|/max|ref| {rel:.3e}{exact}; layer vs "
                    f"attn_mem_layer (xla) {lrel:.3e} (held to {tol:.3e}) "
                    f"{'OK' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"FAIL kernel: {FLASH_MEM_NAMES[dname]} "
                                     "disagrees with its plain version")
                key = FLASH_MEM_NAMES[dname]
                worst[key] = max(worst.get(key, 0.0), err)
    return worst


def dfsmn_engine(torch, raw_path, flags, label, buckets=DFSMN_BUCKETS,
                 what="dfsmn"):
    """An engine built by the port's build (m3asr_tpu_torch.build: the
    config from the YAML, seeded random weights on the card, the flags'
    dtype and settings, ``buckets``, or the default ladder for None)
    without its bucket warm-up: the phase captures each bucket it serves
    itself, or times the warm-up."""
    from m3asr_tpu_torch import build as t_build
    argv = ["-c", raw_path, "-o", "unused", "--device", "cuda",
            "--skip-warmup"] + flags
    if buckets:
        argv += ["--buckets", buckets]
    t0 = time.perf_counter()
    eng, _, _ = t_build.build_engine(t_build.parse_args(argv))
    log(f"{what} {label}: built by m3asr_tpu_torch.build "
        f"{' '.join(flags) or '(float32)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    return eng


def dfsmn_profile(torch, eng, feat, lens):
    """One request's device time under torch.profiler: (total ms, the
    five kernels that took most, K1's ms, K2's ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.infer(feat, lens)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    k1 = sum(ms for n, ms in by_name.items() if expert_kernel(n) == "K1")
    k2 = sum(ms for n, ms in by_name.items() if "flash_fwd_kernel" in n)
    return sum(by_name.values()), top, k1, k2


def dfsmn_serve(torch, label, eng, reqs, kname, n_moe, n_attn, smi,
                what="dfsmn"):
    """Serves each request through eng's CUDA graphs: the bucket's capture
    launches ``kname`` (GRAPH_WARMUP_RUNS + 1) x n_moe times (and K2 x
    n_attn with flash), a replay none; the graph's logits equal the eager
    forward's bit for bit; the eager forward (kname n_moe times) is held
    to the same engine with its experts on the plain versions and its
    tokens on the eager run's experts (fp32 allclose(1e-5, 1e-3), else
    max|diff| / max|ref| <= 0.05 on the valid frames). Returns
    (launches per kernel over captures and eager runs, the eager logits
    and the gates of each request)."""
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.masking import SUBSAMPLED_LENGTH
    from m3asr_tpu_torch.ops.moe import HOST_SYNC_STAGES
    from m3asr_tpu_torch.runtime.engine import GRAPH_WARMUP_RUNS
    fwds = GRAPH_WARMUP_RUNS + 1
    sub = SUBSAMPLED_LENGTH[eng.model_cfg.encoder_conf.input_layer]
    flash = eng.cfg.attn_impl == "flash"
    fp32 = eng.cfg.dtype == "float32"
    total, outs, recs = {}, [], []
    for i, (feat, lens) in enumerate(reqs):
        B, T = feat.shape[:2]
        bb, bt = eng.buckets.pick(B, T)
        stage = eng.moe_impl_for(bb, bt)
        want = {kname: n_moe} if kname and n_moe else {}
        if flash:
            want["K2"] = n_attn
        reset_counts()
        t0 = time.perf_counter()
        prog = eng.get_fn(bb, bt)
        cap_s = time.perf_counter() - t0
        at_capture = kernel_counts()
        reset_counts()
        out_g = eng.infer(feat, lens)
        at_replay = kernel_counts()
        eng.cuda_graphs = False
        reset_counts()
        with GateRecorder(moe_mod) as rec:
            out_e = eng.infer(feat, lens)
        at_eager = kernel_counts()
        with GateRecorder(moe_mod, replay=rec.calls), PlainExperts(moe_mod):
            ref = eng.infer(feat, lens)
        eng.cuda_graphs = True
        for k, v in list(at_capture.items()) + list(at_eager.items()):
            total[k] = total.get(k, 0) + v
        out_len = out_e[1]
        g, e, r = (valid_rows(a[0], out_len) for a in (out_g, out_e, ref))
        if fp32:
            held_ok = bool(np.allclose(e, r, rtol=1e-5, atol=1e-3))
        else:
            held_ok = float(np.abs(e - r).max()) <= 0.05 * float(
                np.abs(r).max())
        rel = float(np.abs(e - r).max() / np.abs(r).max())
        equal = np.array_equal(out_g[0], out_e[0])
        ok = (prog.graph is not None and stage not in HOST_SYNC_STAGES
              and at_capture == {k: v * fwds for k, v in want.items()}
              and not at_replay and at_eager == want and equal and held_ok
              and np.array_equal(out_len, sub(lens)) and np.isfinite(g).all())
        log(f"{what} {label} {B}x{T}: stage {stage}, bucket {bb}x{bt} "
            f"captured in {cap_s:.2f} s with launches {at_capture} (want "
            f"{want} a forward x {fwds}), replay launches "
            f"{at_replay or 'none'}, eager {at_eager}; graph == eager bit "
            f"for bit: {equal}; vs the kernels' plain versions, routing "
            f"pinned: max|diff|/max|ref| {rel:.3e} "
            f"({'allclose(1e-5, 1e-3)' if fp32 else '<= 0.05'}) "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"FAIL {what} {label} {B}x{T}: capture, "
                             "launches or logits off")
        r = serve_times(torch, eng, feat, lens)
        log(times_line(f"{what} {label}", B, T, "graph", r, smi))
        if (B, T) == DFSMN_REQUESTS[-1] or (what != "dfsmn" and i == 1):
            dev, top, k1, k2 = dfsmn_profile(torch, eng, feat, lens)
            if dev <= 0:     # the profiler can lose a round's device events
                log(f"{what} {label} {B}x{T} device time not measured: "
                    f"torch.profiler recorded no device event; {smi}")
            else:
                log(f"{what} {label} {B}x{T} device time {dev:.3f} ms under "
                    f"torch.profiler: K1 {k1:.3f} ms ({k1 / dev:.3f}), K2 "
                    f"{k2:.3f} ms ({k2 / dev:.3f}); top kernels: "
                    + "; ".join(f"{short_name(n)} {ms:.3f} ms"
                                for n, ms in top) + f"; {smi}")
        outs.append((out_e, out_len))
        recs.append(rec.calls)
    return total, outs, recs


def phase_dfsmn(torch, state, smi):
    """The DFSMN families served on the card: the MoE proto at the
    reference Net's widths built by the port's build in fp32, bf16 (also
    with --attn_impl flash), int8, int4 and w4a8, and w8a8, int4 tiled and
    w4a8 tiled engines on the quantized trees, answering 1x512, 4x1000
    and 1x6144 frames (int4 and w4a8 also 1x100 in a 1x128 bucket: K6;
    the tiled engines 1x512) through their CUDA graphs (dfsmn_serve). The
    int4 engine goes through an engine dir (save, Engine.load). The flash
    engine is held to the bf16 xla engine with its tokens on the flash
    run's experts (0.05); dfsmn_san_res (no experts) serves 1x512 in fp32
    with flash, held to its xla twin (allclose(1e-5, 1e-3)). Last, a bf16
    engine's warmup() captures all 24 default buckets: seconds, peak
    memory and the graph pools. Sets state["launches_dfsmn"], the
    launches per engine over the phase's main path."""
    import tempfile

    import yaml
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig
    rng = np.random.default_rng(13)
    reqs = []
    for B, T in DFSMN_REQUESTS:
        lens = np.array([T, T - 117, T - 301, T // 2][:B], np.int32)
        reqs.append((rng.standard_normal((B, T, 40)).astype(np.float32),
                     lens))
    short = [(rng.standard_normal(DFSMN_SHORT + (40,)).astype(np.float32),
              np.array([DFSMN_SHORT[1]], np.int32))]
    conf = dfsmn_raw()["model_conf"]
    # per forward: MoE cFSMN layers (all but the first), attention layers
    n_moe = conf["num_block"] * conf["fsmn_each_block"] - 1
    n_attn = conf["num_block"] + conf["embed_conf"]["num_block"]
    work = tempfile.mkdtemp(prefix="dfsmn_")
    raw_path = os.path.join(work, "dfsmn.yaml")
    launches, engines = {}, {}
    t_phase = time.perf_counter()
    try:
        with open(raw_path, "w") as f:
            yaml.safe_dump(dfsmn_raw(), f)
        for label, how, answers, kname in DFSMN_ENGINES:
            buckets = (DFSMN_SHORT_BUCKET + "," + DFSMN_BUCKETS
                       if answers == "short" else DFSMN_BUCKETS)
            if isinstance(how, list):
                eng = dfsmn_engine(torch, raw_path, how, label, buckets)
            else:
                src, settings = how
                base = engines[src]
                eng = Engine(base.model_cfg, base.params, EngineConfig(
                    **settings, bucket_lengths=base.buckets.lengths,
                    bucket_batches=base.buckets.batches), device="cuda")
                base = None
            if label == "int4":
                t0 = time.perf_counter()
                eng.save(os.path.join(work, "int4"))
                eng = Engine.load(os.path.join(work, "int4"), device="cuda")
                log(f"dfsmn int4: engine dir saved and loaded in "
                    f"{time.perf_counter() - t0:.2f} s")
            engines[label] = eng
            mine = reqs[:1] if answers == "one" else reqs
            counts, outs, recs = dfsmn_serve(torch, label, eng, mine, kname,
                                             n_moe, n_attn, smi)
            if answers == "short":
                more, _, _ = dfsmn_serve(torch, label, eng, short, "K6",
                                         n_moe, n_attn, smi)
                for k, v in more.items():
                    counts[k] = counts.get(k, 0) + v
            launches[label] = counts
            if label == "bfloat16+flash":
                # the bf16 xla engine, its tokens on the flash run's experts
                x_eng = engines["bfloat16"]
                x_eng.cuda_graphs = False
                for (feat, lens), (out_f, out_len), rec in zip(mine, outs,
                                                               recs):
                    with GateRecorder(moe_mod, replay=rec):
                        out_x = x_eng.infer(feat, lens)
                    f_v, x_v = (valid_rows(a[0], out_len)
                                for a in (out_f, out_x))
                    rel = float(np.abs(f_v - x_v).max() / np.abs(x_v).max())
                    log(f"dfsmn bfloat16 flash vs xla {feat.shape[0]}x"
                        f"{feat.shape[1]}, routing pinned: max|diff|/max|ref|"
                        f" {rel:.3e} (held to 0.05) "
                        f"{'OK' if rel <= 0.05 else 'FAIL'}")
                    if not rel <= 0.05:
                        raise SystemExit("FAIL dfsmn: flash and xla differ")
            for done in DFSMN_FREE_AFTER.get(label, ()):
                engines.pop(done, None)
            eng = x_eng = None
            torch.cuda.empty_cache()
        # dfsmn_san_res: no experts; fp32 with flash against its xla twin
        with open(raw_path, "w") as f:
            yaml.safe_dump(dfsmn_raw("dfsmn_san_res"), f)
        label = "dfsmn_san_res float32+flash"
        eng = dfsmn_engine(torch, raw_path, ["--attn_impl", "flash"], label)
        counts, outs, _ = dfsmn_serve(torch, label, eng, reqs[:1], None, 0,
                                      conf["num_block"], smi)
        launches[label] = counts
        twin = Engine(eng.model_cfg, eng.params, EngineConfig(
            bucket_lengths=eng.buckets.lengths,
            bucket_batches=eng.buckets.batches), device="cuda",
            cuda_graphs=False)
        (out_f, out_len), (feat, lens) = outs[0], reqs[0]
        x_v = valid_rows(twin.infer(feat, lens)[0], out_len)
        f_v = valid_rows(out_f[0], out_len)
        ok = bool(np.allclose(f_v, x_v, rtol=1e-5, atol=1e-3))
        log(f"dfsmn dfsmn_san_res float32 flash vs xla {feat.shape[0]}x"
            f"{feat.shape[1]}: max|diff| "
            f"{float(np.abs(f_v - x_v).max()):.3e} (allclose(1e-5, 1e-3)) "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("FAIL dfsmn: dfsmn_san_res flash and xla differ")
        eng = twin = None
        state["launches_dfsmn"] = launches
        log(f"dfsmn: main path launches {launches}; "
            f"{time.perf_counter() - t_phase:.1f} s")
        with open(raw_path, "w") as f:
            yaml.safe_dump(dfsmn_raw(), f)
        dfsmn_ladder(torch, raw_path, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        eng = twin = x_eng = None
        engines.clear()
        torch.cuda.empty_cache()


def dfsmn_ladder(torch, raw_path, smi, buckets=None):
    """A bf16 engine of the port's build, its whole bucket ladder (the
    default 24 buckets) captured by warmup(): seconds, peak memory, and
    what the captures added to the shared graph pool."""
    eng = dfsmn_engine(torch, raw_path, ["-f"], "bfloat16 ladder", buckets)
    try:
        n_buckets = len(eng.buckets.all_buckets())
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        progs = [eng.get_fn(b, t) for b, t in eng.buckets.all_buckets()]
        pools = [p.pool_bytes / 2**30 for p in progs]
        ok = all(p.graph is not None for p in progs)
        log(f"dfsmn bfloat16 warmup(): {n_buckets} buckets captured in "
            f"{secs:.2f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB allocated "
            f"/ {torch.cuda.max_memory_reserved() / 2**30:.3f} GiB "
            f"reserved; the shared graph pool grew by {sum(pools):.3f} GiB "
            f"over the captures (at most {max(pools):.3f} GiB in one); "
            f"{smi} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("FAIL dfsmn: the ladder's warm-up")
    finally:
        eng = None
        torch.cuda.empty_cache()


def k6_relu_raw(torch, layers, x, gate, a8):
    """K6's ReLU launches alone: moe_q4_dense_act on buffers allocated
    once, the layer rotating with the call count i, without the wrapper's
    allocations and checks (as phase 12's "kernels alone"). ``layers``
    hold the weights stacked (L, E, ...) and one layer's scales each.
    Returns fn(i)."""
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops.moe_runs import kernel_act, layer_scales
    lib = kernels.MOE_Q4.load()
    nl, n = len(layers), x.shape[1]
    w1, w2 = (layers[0][k].reshape((-1,) + tuple(layers[0][k].shape[2:]))
              for k in ("w1_q4", "w2_q4"))
    scales = [layer_scales(q, E) for q in layers]
    b1 = layers[0]["b1"]
    x2 = x.reshape(n, D).contiguous()
    g2 = gate.reshape(n).to(torch.int32).contiguous()
    front = torch.empty(lib.moe_q4_front_ints(n, E), dtype=torch.int32,
                        device="cuda")
    hid = torch.empty(n, H, device="cuda",
                      dtype=torch.float32 if a8 else torch.bfloat16)
    xq, hq = (torch.empty(n, w, dtype=torch.int8, device="cuda")
              for w in (D, H))
    xs, hs = (torch.empty(n, device="cuda") for _ in range(2))
    y = torch.empty_like(x2)
    act = kernel_act(RELU["activation"], RELU["upper_bound"])
    stream = torch.cuda.current_stream().cuda_stream

    def ptr(t):
        return t.data_ptr() if a8 else None

    def raw(i):
        j = i % nl
        s1, s2 = scales[j]
        if lib.moe_q4_dense_act(
                *act, int(a8), x2.data_ptr(), g2.data_ptr(), n,
                w1.data_ptr(), s1.data_ptr(), s1.shape[1], b1.data_ptr(),
                w2.data_ptr(), s2.data_ptr(), s2.shape[1], None, E, j, D, H,
                front.data_ptr(), hid.data_ptr(), ptr(xq), ptr(xs), ptr(hq),
                ptr(hs), y.data_ptr(), stream):
            raise SystemExit("FAIL times: moe_q4_dense_act launch error")
    return raw


DFSMN_TIME_TOKENS = {"K1": 4096, "K4": 4096, "K5": 4096, "K6": 127,
                     "K7": 511}
FLASH_MEM_TIME_T = (2048, 6144)     # B=1; the report's row at the last


def time_dfsmn_kernels(torch, smi):
    """Each ReLU instantiation at a DFSMN token count (K1, K4, K5 at 4096
    tokens, the 1x4096 bucket; K6 at 127; K7 at 511) under the router's
    routing, weights stacked over 3 layers with the layer rotating, so
    weights come from device memory: the wrapper call, its plain version
    and the bound (active experts' weights, scales and biases, x, y and
    the gate once; 4 n d h operations at the type's peak: float32 FMA,
    bf16 tensor cores for weight-only int8/int4, int8 for a8). Then K2
    through flash_attn_mem at B=1, T=2048 and 6144 (S = T + 64, every key
    valid), fp32 and bf16: the kernel call, its plain version,
    scaled_dot_product_attention on the same masked problem (a boolean
    mask of the memory columns plus the key lengths) and the bound, and
    the device time of the kernel and of SDPA in turns
    (paired_device_ms). Returns rows keyed by output name (the flash rows
    at T=6144)."""
    import torch.nn.functional as F
    from m3asr_tpu_torch.ops import flash_attention as fa
    from m3asr_tpu_torch.ops import moe_q4, moe_runs
    gen = torch.Generator(device="cuda").manual_seed(15)
    nl, rows = 3, {}

    def row(name, kern, plain, layer_p, n, dtype, per_expert, peak,
            alone=None, **kw):
        x = (torch.randn(1, n, D, generator=gen, device="cuda") * 3) \
            .to(dtype)
        gate = routing(torch, "router", n, gen)
        active = n_active(torch, gate)
        t_bytes = (active * per_expert + 2 * n * D * x.element_size()
                   + 4 * n) / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * n * D * H / PEAK_OPS_PER_S[peak] * 1e3
        ms = cuda_time_ms(torch, lambda i: kern.launch(
            layer_p(i % nl), x, gate, layer=i % nl, **kw, **RELU), 30)
        turns = iter(range(10 ** 6))

        def call():                    # the layer rotates, as above
            j = next(turns) % nl
            return kern.launch(layer_p(j), x, gate, layer=j, **kw, **RELU)
        dev = profiled_ms(torch, call, 12)
        plain_ms = cuda_time_ms(torch, lambda i: plain(
            layer_p(i % nl), x, gate, layer=i % nl, **kw, **RELU), 3)
        bound = max(t_bytes, t_ops)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations", library_ms=None)
        # the launches alone by CUDA events (K6), where the profiler's
        # trace can lose the kernels' events
        extra = "" if alone is None else (
            ", its CUDA launches alone {:.4f} ms by CUDA events".format(
                cuda_time_ms(torch, alone(x, gate), 60)))
        log(f"time {name} n={n} router active={active}: call {ms:.4f} ms "
            f"(device {dev:.4f} ms under torch.profiler, the layout prep "
            f"with it{extra}), plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"(bytes {t_bytes:.4f} / ops {t_ops:.4f}), library_ms none; "
            f"{smi}")

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        p = expert_weights(torch, dtype, gen, n_layers=nl)
        p.pop("b2")
        elt = p["w1"].element_size()
        row(RELU_NAMES[("K1", dname)], moe_runs.runs_kernel,
            moe_runs.moe_experts_runs_reference, lambda j: p,
            DFSMN_TIME_TOKENS["K1"], dtype, (2 * D * H + H) * elt, dname)
    for bits in (8, 4):
        p = quant_experts(torch, bits, gen, nl)
        p.pop("b2")
        layers = [at_layer(p, j) for j in range(nl)]
        # weights, float32 scales (int4: 128-row groups), bf16 b1
        scales = H + D if bits == 8 else D // 128 * H + H // 128 * D
        per_expert = 2 * D * H * bits // 8 + 4 * scales + 2 * H
        kinds = (("K4",) if bits == 8 else ("K5", "K6", "K7"))
        for kname in kinds:
            kern, plain = {
                "K4": (moe_runs.runs_q8_kernel,
                       moe_runs.moe_experts_runs_reference),
                "K5": (moe_runs.runs_q4_kernel,
                       moe_runs.moe_experts_runs_reference),
                "K6": (moe_q4.q4_kernel, moe_q4.moe_experts_q4_reference),
                "K7": (moe_q4.q4_tiled_kernel,
                       moe_q4.moe_experts_q4_tiled_reference)}[kname]
            for a8 in (False, True):
                alone = None if kname != "K6" else (
                    lambda x, gate, a8=a8: k6_relu_raw(torch, layers, x,
                                                       gate, a8))
                row(RELU_NAMES[(kname, a8)], kern, plain,
                    lambda j: layers[j], DFSMN_TIME_TOKENS[kname],
                    torch.bfloat16, per_expert,
                    "int8" if a8 else "bfloat16", alone=alone, act_quant=a8)
    M, dk = DFSMN_SLOTS, D // DFSMN_HEADS
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        p = flash_mem_params(torch, dtype, gen)
        for T in FLASH_MEM_TIME_T:
            S = T + M
            x = torch.randn(1, T, D, generator=gen, device="cuda").to(dtype)
            lens = torch.full((1,), T, dtype=torch.int32, device="cuda")
            q, k, v, klens, _, _ = fa.attn_mem_inputs(
                p, x, lens, DFSMN_HEADS, M)
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            scale = dk ** -0.5
            key_mask = (torch.arange(S, device="cuda")[None, :]
                        < klens[:, None])[:, None, None, :]

            def kernel():
                return fa.flash_kernels.forward(q, k, v, klens, scale)

            def sdpa():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=key_mask, scale=scale)
            ms = cuda_time_ms(torch, lambda i: kernel(), 20)
            plain_ms = cuda_time_ms(torch, lambda i: (
                fa.flash_attention_reference(q, k, v, klens, scale)), 3)
            lib_ms = cuda_time_ms(torch, lambda i: sdpa(), 20)
            dev, lib_dev = ("{:.4f} ms ({:.4f}-{:.4f})".format(*t)
                            for t in paired_device_ms(torch, kernel, sdpa))
            elt = x.element_size()
            t_bytes = (elt * DFSMN_HEADS * (2 * T * dk + 2 * S * dk) + 4) \
                / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * DFSMN_HEADS * T * S * 2 * dk \
                / PEAK_OPS_PER_S[dname] * 1e3
            bound = max(t_bytes, t_ops)
            r = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     library_ms=lib_ms)
            if T == FLASH_MEM_TIME_T[-1]:
                rows[FLASH_MEM_NAMES[dname]] = r
            log(f"time {FLASH_MEM_NAMES[dname]} B=1 T={T} S={S} rows "
                f"{fa.launch_rows(q, k)[0]}: call {ms:.4f} ms (device "
                f"{dev}), plain {plain_ms:.4f} ms, "
                f"scaled_dot_product_attention {lib_ms:.4f} ms (device "
                f"{lib_dev}), bound {bound:.4f} ms (bytes {t_bytes:.4f} / "
                f"ops {t_ops:.4f}); {smi}")
    return rows


def dfsmn_report(torch, state, smi):
    """The kernels line's entries of the ReLU instantiations and
    flash_attn_mem: launches on the DFSMN path (phase_dfsmn), the worst
    error of their checks, this run's times and bounds."""
    launches = state["launches_dfsmn"]
    by_name = {
        RELU_NAMES[("K1", "float32")]: [("float32", "K1")],
        RELU_NAMES[("K1", "bfloat16")]: [("bfloat16", "K1"),
                                         ("bfloat16+flash", "K1")],
        RELU_NAMES[("K4", False)]: [("int8", "K4")],
        RELU_NAMES[("K4", True)]: [("w8a8", "K4")],
        RELU_NAMES[("K5", False)]: [("int4", "K5")],
        RELU_NAMES[("K5", True)]: [("w4a8", "K5")],
        RELU_NAMES[("K6", False)]: [("int4", "K6")],
        RELU_NAMES[("K6", True)]: [("w4a8", "K6")],
        RELU_NAMES[("K7", False)]: [("int4 tiled", "K7")],
        RELU_NAMES[("K7", True)]: [("w4a8 tiled", "K7")],
        FLASH_MEM_NAMES["float32"]: [("dfsmn_san_res float32+flash", "K2")],
        FLASH_MEM_NAMES["bfloat16"]: [("bfloat16+flash", "K2")]}
    # phase 14's captures: the DFSMN streams, the server's included
    streamed = {RELU_NAMES[("K1", "float32")]: ("float32", "K1"),
                RELU_NAMES[("K1", "bfloat16")]: ("bfloat16", "K1"),
                RELU_NAMES[("K6", False)]: ("int4", "K6"),
                RELU_NAMES[("K6", True)]: ("w4a8", "K6")}
    rows = time_dfsmn_kernels(torch, smi)
    report = []
    for name, where in by_name.items():
        n = sum(launches[eng].get(k, 0) for eng, k in where)
        if name in streamed:
            n += state["launches_dfsmn_stream"][streamed[name]]
        if n == 0:
            raise SystemExit(f"FAIL report: {name} never launched on the "
                             "DFSMN path")
        flash = name in FLASH_MEM_NAMES.values()
        src = ("flash_attention.cu" if flash else "moe_q4.cu"
               if "q4_dense" in name else "moe_q4_tiled.cu"
               if "q4_tiled" in name else "moe_runs.cu")
        replaces = ("m3asr_tpu/ops/pallas_attention.py:651" if flash
                    else "m3asr_tpu/ops/pallas_moe_q4.py:320"
                    if "q4_dense" in name
                    else "m3asr_tpu/ops/pallas_moe_q4.py:596"
                    if "q4_tiled" in name
                    else "m3asr_tpu/ops/pallas_moe_runs.py:350")
        r = rows[name]
        report.append({"name": name, "route": "cuda",
                       "source": f"m3asr_tpu_torch/csrc/{src}",
                       "replaces": replaces, "launches": n,
                       "max_abs_err": state["max_err_dfsmn"][name],
                       "ms": r["ms"], "plain_ms": r["plain_ms"],
                       "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                       "library_ms": r["library_ms"]})
    return report


# ---------------------------------------------------------------------------
# 14. DFSMN streams, the server's DFSMN and dense conformer streams, and
#     the dense conformer protos
# ---------------------------------------------------------------------------

DS_SLOTS, DS_CHUNK, DS_CACHE_T = 8, 16, 256
# frames of the 8 streams (10 ms each: 10-52 s); the first passes the
# 5000-row positional table. Its 329 ticks are run by the modes of
# DS_LONG; the others run DS_HALF, streams of 5.0-9.6 s (71 ticks): an
# eager tick costs 45-80 ms of host time, and the whole script must end
# within its 1200 s (131 ticks there took it to 1082.7-1116.0 s)
DS_FRAMES = (5200, 1000, 1130, 1260, 1390, 1520, 1650, 1780)
DS_HALF = (500, 565, 630, 695, 760, 825, 890, 955)
DS_LONG = ("float32", "dfsmn_san_res float32")
DS_CHECKED = 1                # the stream also run by single sessions
# ticks held to the kernels' plain versions, from the eager run's state at
# DS_PLAIN_FROM: there stream 7 (the last to start, at tick 7) has fed 96
# frames, past the MoE net's 59-frame delay, so every MoE layer of every
# slot sees real frames
DS_PLAIN_FROM, DS_PLAIN_TICKS = 12, 4
DS_ORACLE_FRAMES = 400        # the causal copy's frames (past the window)
# (label, proto, EngineConfig settings on the fp32 engine's tree, the
# kernel of the chunk programs' expert stage, serve's stage at 16 x 8
# tokens)
DS_MODES = (
    ("float32", DFSMN_MOE, dict(dtype="float32"), "K1", "runs_f"),
    ("bfloat16", DFSMN_MOE, dict(dtype="bfloat16"), "K1", "runs_f"),
    ("int8", DFSMN_MOE, dict(dtype="int8"), None, "quant"),
    ("int4", DFSMN_MOE, dict(dtype="int4"), "K6", "quant4_pallas"),
    ("w4a8", DFSMN_MOE, dict(dtype="int4", act_quant=True), "K6",
     "quant4_a8"),
    ("dfsmn_san_res float32", "dfsmn_san_res", dict(dtype="float32"), None,
     None),
    ("dfsmn_san_res bfloat16", "dfsmn_san_res", dict(dtype="bfloat16"),
     None, None))
# the dense conformer at the flagship encoder's widths
DC_REQUESTS = ((1, 206), (4, 1000), (1, 2048))
DC_BUCKETS = "1x256,4x1024,1x2048"
# the other front ends, one fp32 forward each at 2 blocks:
# (input_layer, pos_enc_layer_type, subsampling_feat_norm)
DC_FRONTS = (("conv2d6", "rel_pos", False), ("conv2d8", "rel_pos", False),
             ("linear", "rel_pos", False), ("conv2d", "abs_pos", False),
             ("conv2d", "no_pos", False), ("conv2d", "rel_pos", True))


def conformer_raw(blocks=DC_BLOCKS, input_layer="conv2d", pos="rel_pos",
                  feat_norm=False):
    """The dense ``conformer`` proto at the flagship encoder's widths
    (configs/3m_asr_18l32e.yaml's encoder: d=512, 8 heads, 2048 linear
    units, macaron, CNN kernel 15, batch norm), input 40, vocabulary
    5000."""
    return {"nnet_proto": "conformer", "input_dim": 40, "output_dim": 5000,
            "model_conf": {
                "attention_dim": D, "attention_heads": 8,
                "linear_units": 2048, "num_blocks": blocks,
                "macaron_style": True, "use_cnn_module": True,
                "cnn_module_kernel": 15, "cnn_module_norm": "batch_norm",
                "input_layer": input_layer, "pos_enc_layer_type": pos,
                "subsampling_feat_norm": feat_norm}}


def dfsmn_chunks(feat, delay, chunk=DS_CHUNK):
    """The chunks a DFSMN session feeds its program for one (T, D) stream
    pushed and finished: the full chunks, then the tail and ``delay``
    zero frames padded to a chunk. [(chunk (1, C, D), C)]."""
    T = feat.shape[0]
    n = -(-(T + delay) // chunk)
    x = np.zeros((n * chunk, feat.shape[1]), np.float32)
    x[:T] = feat
    return [(x[None, i * chunk:(i + 1) * chunk], chunk) for i in range(n)]


def chunk_gates(rec_calls, n_moe, i, n_chunks):
    """Stream i's expert choices in a batched run where it sat in slot i
    from tick i, in a single session's call order (per chunk, per MoE
    layer)."""
    return [rec_calls[(i + c) * n_moe + blk][i:i + 1]
            for c in range(n_chunks) for blk in range(n_moe)]


def dfsmn_stream_mode(torch, label, params, cfg, cfg_c, impl, kname, n_moe,
                      feats, smi):
    """Phase 14's checks of one DFSMN stream mode. ``params``: the
    engine's stream parameters; ``impl``: the expert stage serve picks
    (None: no experts); ``cfg_c``: the causal copy's config. Returns the
    kernel's launches in the mode's captures (its main path's
    programs)."""
    from m3asr_tpu_torch.models import dfsmn as t_dfsmn
    from m3asr_tpu_torch.models import dfsmn_streaming as ds
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.masking import subsequent_chunk_mask
    from m3asr_tpu_torch.runtime.graphs import DEVICE_LOCK, GRAPH_WARMUP_RUNS
    from m3asr_tpu_torch.runtime.streaming_batch import DfsmnStreamBatcher
    from m3asr_tpu_torch.runtime.streaming_session import (
        DfsmnMoeStreamingSession, DfsmnStreamingSession)

    moe = impl is not None
    fp32 = "float32" in label
    tol = "allclose(1e-5, 1e-3)" if fp32 else "<= 0.05"
    fwds = GRAPH_WARMUP_RUNS + 1
    delay = (ds.moe_stream_delay(cfg, DS_CHUNK) if moe
             else ds.stream_delay(cfg))
    streams = [dfsmn_chunks(f, delay) for f in feats]
    n_ticks = max(i + len(s) for i, s in enumerate(streams))
    bkw = dict(input_dim=feats[0].shape[1], chunk_size=DS_CHUNK,
               slots=DS_SLOTS, cache_T=DS_CACHE_T, moe=moe,
               moe_impl=impl or "dense", window_ms=0.0)
    skw = dict(cache_T=DS_CACHE_T, **(dict(moe_impl=impl) if moe else {}))
    cls = DfsmnMoeStreamingSession if moe else DfsmnStreamingSession
    per_fwd = {kname: n_moe} if kname else {}
    launched = 0

    def counted(want, what, main=False):
        """Hold the launches since the last reset to ``want``; the
        captures (the main path's programs) add to ``launched``."""
        nonlocal launched
        got = kernel_counts()
        if main and kname:
            launched += got.get(kname, 0)
        if got != want:
            raise SystemExit(f"FAIL dfsmn stream {label}: {what} launched "
                             f"{got}, want {want}")
        reset_counts()

    # the batched program: captured, replayed tick by tick, and the same
    # program eager, bit for bit
    reset_counts()
    t0 = t_mode = time.perf_counter()
    b_g = DfsmnStreamBatcher(params, cfg, **bkw)
    cap_s = time.perf_counter() - t0
    if b_g.graph is None:
        raise SystemExit(f"FAIL dfsmn stream {label}: no graph captured")
    counted({k: fwds * v for k, v in per_fwd.items()},
            "the batcher's capture", main=True)
    outs_b, raw_g, tick_g = batched_ticks(b_g, streams)
    counted({}, "the graph's replays")
    b_e = DfsmnStreamBatcher(params, cfg, cuda_graphs=False, **bkw)
    snap = []

    def keep_state(t):
        if t == DS_PLAIN_FROM:
            snap.extend(x.clone() for x in b_e._prog.inputs[2:])
    with GateRecorder(moe_mod) as rec_b:
        outs_e, raw_e, tick_e = batched_ticks(
            b_e, streams, before_tick=keep_state if kname else None)
    counted({k: n_ticks * v for k, v in per_fwd.items()}, "the eager ticks")
    equal = all(np.array_equal(a, b) for a, b in zip(raw_g, raw_e))
    finite = all(np.isfinite(o).all() for o in outs_b)
    full = (np.zeros((DS_SLOTS, DS_CHUNK, bkw["input_dim"]), np.float32),
            np.ones((DS_SLOTS,), bool))

    def tick():
        with DEVICE_LOCK.shared():
            b_g._tick(*full)
    dev, events = profiled_events(torch, tick, 5)
    reset_counts()
    tg, te = float(np.median(tick_g)), float(np.median(tick_e))
    ok = equal and finite
    log(f"dfsmn stream {label} batcher ({DS_SLOTS} slots, chunk {DS_CHUNK},"
        f" cache_T {DS_CACHE_T}, stage {impl}, delay {delay}): captured in "
        f"{cap_s:.2f} s; {n_ticks} ticks of {len(streams)} staggered "
        f"streams of {[f.shape[0] for f in feats]} frames; graph outputs "
        f"bit-equal to the "
        f"eager step's: {equal}; finite: {finite}; median tick graph "
        f"{tg:.3f} ms, eager {te:.3f} ms (host clock); a graph tick's "
        f"device time {dev:.3f} ms under torch.profiler ({events // 5} "
        f"events), busy {dev / tg:.3f}; graph pool "
        f"{b_g.pool_bytes / 2**20:.1f} MiB reserved; {smi} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"FAIL dfsmn stream {label}: graph ticks differ "
                         "from eager")
    b_g.close()

    # the experts on the kernel's plain version, routing pinned to the
    # eager run's, over ticks past the delay: from the eager run's state
    # at DS_PLAIN_FROM, the next DS_PLAIN_TICKS ticks, held slot by slot
    if kname:
        ticks = range(DS_PLAIN_FROM, DS_PLAIN_FROM + DS_PLAIN_TICKS)
        with DEVICE_LOCK.shared(), torch.inference_mode():
            for x, v in zip(b_e._prog.inputs[2:], snap):
                x.copy_(v)
        snap.clear()
        pinned = rec_b.calls[ticks[0] * n_moe:(ticks[-1] + 1) * n_moe]
        with GateRecorder(moe_mod, replay=pinned), PlainExperts(moe_mod):
            _, raw_p, _ = batched_ticks(b_e, streams, ticks)
        reset_counts()
        worst, ok, n_rows = 0.0, True, 0
        for t, o_p in zip(ticks, raw_p):
            live = [i for i, s in enumerate(streams) if 0 <= t - i < len(s)]
            n_rows += len(live)
            good, rel = held(raw_e[t][live], o_p[live], fp32)
            ok &= good
            worst = max(worst, rel)
        log(f"dfsmn stream {label}: ticks {ticks[0]}-{ticks[-1]} ({n_rows} "
            f"slot chunks, every stream past the {delay}-frame delay) from "
            f"the eager run's state, with the experts on {kname}'s plain "
            f"version, routing pinned: max|diff|/max|ref| {worst:.3e} "
            f"({tol}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"FAIL dfsmn stream {label}: {kname} against "
                             "its plain version")
    b_e.close()

    # single sessions (scalar offsets), pushed in uneven pieces and
    # finished, held to the batched streams after the delay: through the
    # graph (fp32 free-running, also the long stream), and eager pinned to
    # the batched run's experts; fp32 also holds the graph session to the
    # eager one bit for bit
    s_g = cls(params, cfg, DS_CHUNK, **skw)
    s_e = cls(params, cfg, DS_CHUNK, cuda_graphs=False, **skw)
    i = DS_CHECKED
    checked = [0, i] if fp32 and feats[0].shape[0] > 5000 else [i]
    worst, ok_all, bit_equal, lat_g, lat_e = 0.0, True, True, [], []
    for k in checked:
        out_g, chunks_g, pc = session_run(s_g, feats[k])
        lat_g += pc
        want = outs_b[k][delay:delay + feats[k].shape[0]]
        ok_all &= out_g.shape == want.shape and bool(np.isfinite(out_g).all())
        if fp32:
            good, rel = held(out_g, want, True)
            ok_all &= good
            worst = max(worst, rel)
    counted({k: fwds * v for k, v in per_fwd.items()},
            "the session's capture and replays", main=True)
    eager_runs = 1
    if fp32:
        out_e, chunks_e, pc = session_run(s_e, feats[i])
        lat_e += pc
        eager_runs += 1
        bit_equal = len(chunks_g) == len(chunks_e) and all(
            np.array_equal(a, b) for a, b in zip(chunks_g, chunks_e))
    with GateRecorder(moe_mod, replay=chunk_gates(rec_b.calls, n_moe, i,
                                                  len(streams[i]))):
        t0 = time.perf_counter()
        out_p, _, _ = session_run(s_e, feats[i])
        if not lat_e:
            lat_e.append((time.perf_counter() - t0) * 1e3
                         / len(streams[i]))
    good, rel = held(out_p, outs_b[i][delay:delay + feats[i].shape[0]],
                     fp32)
    ok_all &= good
    worst = max(worst, rel)
    counted({k: eager_runs * len(streams[i]) * v
             for k, v in per_fwd.items()}, "the sessions' replays and eager "
            "runs")
    log(f"dfsmn stream {label} sessions: streams {checked} of "
        f"{[feats[k].shape[0] for k in checked]} frames pushed in pieces of "
        f"{STREAM_PIECES} and finished through the graph"
        f"{' (held free-running)' if fp32 else ''}, stream {i} also eager "
        f"pinned to the batched run's experts"
        f"{' and free-running' if eager_runs > 1 else ''}; graph chunks "
        f"bit-equal to eager: {bit_equal if eager_runs > 1 else 'not run'}; "
        f"single vs batched on the frames after the delay: "
        f"max|diff|/max|ref| {worst:.3e} ({tol}); chunk latency median "
        f"graph {np.median(lat_g):.3f} ms, eager {np.median(lat_e):.3f} ms "
        f"(host clock); session graph pool "
        f"{s_g._prog.pool_bytes / 2**20:.1f} MiB reserved; {smi} "
        f"{'OK' if bit_equal and ok_all else 'FAIL'}")
    if not (bit_equal and ok_all):
        raise SystemExit(f"FAIL dfsmn stream {label}: sessions")
    s_g = s_e = None

    # the causal copy (look_ahead=0 in both nets) against the offline
    # forward under the chunk mask of its 256-frame window, experts
    # pinned to the streams'
    oracle = [dfsmn_chunks(feats[DS_CHECKED][:DS_ORACLE_FRAMES], 0)]
    b_o = DfsmnStreamBatcher(params, cfg_c, cuda_graphs=False, **bkw)
    with GateRecorder(moe_mod) as rec_o:
        outs_o, _, _ = batched_ticks(b_o, oracle)
    b_o.close()
    Tp = max(len(s) for s in oracle) * DS_CHUNK
    x = torch.zeros((len(oracle), Tp, bkw["input_dim"]), device="cuda")
    x[0, :DS_ORACLE_FRAMES] = torch.from_numpy(
        feats[DS_CHECKED][:DS_ORACLE_FRAMES]).cuda()
    x = x.to(params["out_linear_sw" if moe else "out_linear"]["kernel"]
             .dtype)
    mask = subsequent_chunk_mask(Tp, DS_CHUNK, DS_CACHE_T // DS_CHUNK,
                                 device="cuda")

    def offline():
        if moe:
            return t_dfsmn.dfsmn_san_moe_forward(params, cfg_c, x, None,
                                                 moe_impl=impl,
                                                 attn_mask=mask)[0]
        return t_dfsmn.dfsmn_san_forward(params, cfg_c, x, None,
                                         attn_mask=mask)[0]
    with torch.inference_mode():
        with GateRecorder(moe_mod) as rec_f:
            offline()
        replay = [g.clone() for g in rec_f.calls]
        for j, s in enumerate(oracle):
            for blk in range(n_moe):
                replay[blk][j, :len(s) * DS_CHUNK] = torch.cat(
                    [rec_o.calls[(j + c) * n_moe + blk][j]
                     for c in range(len(s))])
        with GateRecorder(moe_mod, replay=replay):
            ref = offline().float().cpu().numpy()
    reset_counts()
    worst, ok_all, flipped = 0.0, True, 0
    for j, s in enumerate(oracle):
        n = len(s) * DS_CHUNK
        good, rel = held(outs_o[j][:n], ref[j, :n], fp32)
        ok_all &= good
        worst = max(worst, rel)
        flipped += sum(int((rec_f.calls[b][j, :n] != replay[b][j, :n])
                           .sum().item()) for b in range(n_moe))
    log(f"dfsmn stream {label} oracle (look_ahead=0 in both nets): the "
        f"first {DS_ORACLE_FRAMES} frames of stream {DS_CHECKED} batched vs "
        f"the offline forward with "
        f"subsequent_chunk_mask({Tp}, {DS_CHUNK}, "
        f"{DS_CACHE_T // DS_CHUNK}), experts pinned to the streams': "
        f"max|diff|/max|ref| {worst:.3e} ({tol}); (frame, layer) pairs "
        f"whose expert differs free-running: {flipped}; {smi} "
        f"{'OK' if ok_all else 'FAIL'}")
    if not ok_all:
        raise SystemExit(f"FAIL dfsmn stream {label}: the causal stream "
                         "differs from the chunk-masked offline forward")
    log(f"dfsmn stream {label}: {time.perf_counter() - t_mode:.1f} s")
    return launched


def phase_table_growth(torch, state, smi, eng=None):
    """A captured stream outlives the growth of the DFSMN positional
    table. A DFSMN stream batcher is captured while the table has its
    first 5000 rows and runs 8 streams; an offline 1x6144 request then
    grows the table, NaN fills the memory the allocator hands out next at
    the old table's size, and the same streams through the same graph
    give the same outputs bit for bit. ``eng``: the fp32 MoE-DFSMN engine
    (built here when None)."""
    import tempfile
    import yaml
    import m3asr_tpu_torch.serve as serve
    from m3asr_tpu_torch.models import dfsmn as t_dfsmn
    from m3asr_tpu_torch.models import dfsmn_streaming as ds
    from m3asr_tpu_torch.models.registry import dfsmn_stream_config
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig
    from m3asr_tpu_torch.runtime.streaming_batch import DfsmnStreamBatcher
    if eng is None:
        work = tempfile.mkdtemp(prefix="dfsmn_table_")
        try:
            raw_path = os.path.join(work, "dfsmn.yaml")
            with open(raw_path, "w") as f:
                yaml.safe_dump(dfsmn_raw(), f)
            eng = dfsmn_engine(torch, raw_path, [], "table growth", "1x512")
        finally:
            shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    feat = np.random.default_rng(16).standard_normal(
        (6144, 40)).astype(np.float32)
    # start from the first tables, as a server that has served nothing
    # longer than 5000 frames (position_table keeps the tables it
    # replaces; so does this)
    for key in list(t_dfsmn._PE_TABLES):
        t_dfsmn._PE_SUPERSEDED.append(t_dfsmn._PE_TABLES.pop(key))
    cfg = dfsmn_stream_config(eng.model_cfg)
    impl = serve._stream_moe_impl(eng, DS_SLOTS)
    b = DfsmnStreamBatcher(serve.stream_params(eng), cfg, input_dim=40,
                           chunk_size=DS_CHUNK, slots=DS_SLOTS,
                           cache_T=DS_CACHE_T, moe=True, moe_impl=impl,
                           window_ms=0.0)
    delay = ds.moe_stream_delay(cfg, DS_CHUNK)
    streams = [dfsmn_chunks(feat[100 * i:100 * i + 400], delay)
               for i in range(DS_SLOTS)]
    before, _, _ = batched_ticks(b, streams)
    rows = {k: v.shape[0] for k, v in t_dfsmn._PE_TABLES.items()}
    long = Engine(eng.model_cfg, eng.params, EngineConfig(
        dtype="float32", bucket_lengths=(6144,), bucket_batches=(1,)),
        device="cuda")
    logits, _ = long.infer(feat[None], np.array([6144], np.int32))
    grown = {k: t_dfsmn._PE_TABLES[k].shape[0] for k in rows}
    fill = [torch.full((n * k[0],), float("nan"), dtype=k[1], device="cuda")
            for k, n in rows.items() for _ in range(8)]
    after, _, _ = batched_ticks(b, streams)
    b.close()
    equal = all(np.array_equal(x, y) for x, y in zip(before, after))
    ok = (equal and rows and all(grown[k] >= 6144 > n
                                    for k, n in rows.items())
          and bool(np.isfinite(logits).all()))
    log(f"dfsmn positional table growth: a batcher captured over tables of "
        f"{sorted(set(rows.values()))} rows; a 1x6144 offline request grew "
        f"them to {sorted(set(grown.values()))} rows (finite logits: "
        f"{bool(np.isfinite(logits).all())}); {len(fill)} NaN blocks at the "
        f"old tables' size taken; the same {len(streams)} streams replayed "
        f"through the graph bit-equal to before: {equal}; "
        f"{time.perf_counter() - t0:.1f} s; {smi} {'OK' if ok else 'FAIL'}")
    fill = long = None
    reset_counts()
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("FAIL dfsmn positional table growth: a captured "
                         "stream changed after the table grew")


def server_streams(torch, label, eng, key, feats, smi, decode="greedy"):
    """A loopback server (m3asr_tpu_torch.serve, --warmup, port 0) on
    ``eng``: two concurrent streams of ``feats`` (chunk 16) pushed in
    uneven pieces; every partial and the final answer must equal the
    server's own pool sessions driven directly with the same pieces (a
    batcher runs all its slots in every tick, so a slot's numbers do not
    depend on the others). Returns the launches of the server's
    captures."""
    import socketserver
    import tempfile
    import threading
    import m3asr_tpu_torch.serve as serve
    tmp = tempfile.mkdtemp()
    args = serve.parser().parse_args(["-p", tmp, "--warmup", "--port", "0",
                                      "--stream_slots", str(DS_SLOTS)])
    reset_counts()
    t0 = time.perf_counter()
    state = serve._build_runtime(args, engine=eng)
    warm_s = time.perf_counter() - t0
    launches = kernel_counts()
    reset_counts()
    warm = state["stream_batchers"].get(key)
    if warm is None or warm.graph is None:
        raise SystemExit(f"FAIL serve {label}: --warmup did not capture the "
                         f"{key} stream batcher")
    srv = socketserver.ThreadingTCPServer(
        ("127.0.0.1", 0), serve.make_handler(state, args.beam_size))
    srv.daemon_threads = True
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]
    skey = (DS_CHUNK, serve.DEFAULT_STREAM_KEY[1])
    start = {"stream": "start", "chunk_size": DS_CHUNK, "decode": decode,
             "timestamps": True}
    if decode == "beam":
        start["beam_size"] = 8

    def stream_reqs(f):
        reqs, i = [start], 0
        for n in pieces_of(f.shape[0]):
            reqs.append({"stream": "chunk", "feat": f[i:i + n].tolist()})
            i += n
        return reqs + [{"stream": "end"}]
    try:
        got = [None, None]
        clients = [threading.Thread(target=lambda j: got.__setitem__(
            j, serve_client(port, stream_reqs(feats[j]))), args=(j,))
            for j in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        stats = serve_client(port, [{"stats": True}])[0]
    finally:
        srv.shutdown()
        srv.server_close()
    pool, want = state["stream_pool"], []
    for f in feats:
        sess = pool.acquire(skey)
        beam = None
        if decode == "beam":
            from m3asr_tpu_torch.decode import native
            beam = native.make_beam_state(8)
        dec = serve._StreamDecode(sess, beam_state=beam)
        resp, i = [], 0
        for n in pieces_of(f.shape[0]):
            dec.update(sess.push(f[None, i:i + n]))
            toks, times = dec.result()
            resp.append((toks, dec.frames, times))
            i += n
        dec.update(sess.finish())
        toks, times = dec.result()
        resp.append((toks, dec.frames, times))
        pool.release(skey, sess)
        want.append(resp)
    reset_counts()
    ok = all([(r.get("partial", r.get("hyp")), r["out_frames"], r["times"])
              for r in g[1:]] == w for g, w in zip(got, want))
    ok &= all(g[-1].get("final") for g in got)
    ticks = next(iter(stats["stream_batchers"].values()))
    log(f"serve {label} (loopback 127.0.0.1:{port}; --warmup: "
        f"{len(eng.buckets.all_buckets())} bucket(s) and the {key} stream "
        f"batcher ({warm.pool_bytes / 2**20:.1f} MiB pool) captured in "
        f"{warm_s:.2f} s): 2 concurrent {decode} streams of "
        f"{[f.shape[0] for f in feats]} frames, "
        f"{sum(len(g) for g in got)} responses equal to the server's pool "
        f"sessions driven directly: {ok}; out_frames "
        f"{[g[-1].get('out_frames') for g in got]}; tick batch sizes "
        f"{ticks['tick_batch_sizes'][-12:]}; {smi} {'OK' if ok else 'FAIL'}")
    state["batcher"].close()
    for b in state["stream_batchers"].values():
        b.close()
    if not ok:
        raise SystemExit(f"FAIL serve {label}: stream answers differ")
    return launches


def phase_dfsmn_stream(torch, smi):
    """Phase 14, first part: the DFSMN streams of every mode on engines of
    the port's build (dfsmn_stream_mode), then the loopback server's
    DFSMN streams. Returns the launches of the path's captures by (mode,
    kernel)."""
    import dataclasses
    import tempfile
    import yaml
    import m3asr_tpu_torch.serve as serve
    from m3asr_tpu_torch.models.registry import dfsmn_stream_config
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig
    rng = np.random.default_rng(14)
    long_feats, half_feats = ([rng.standard_normal((T, 40))
                               .astype(np.float32) for T in frames]
                              for frames in (DS_FRAMES, DS_HALF))
    work = tempfile.mkdtemp(prefix="dfsmn_stream_")
    raw_path = os.path.join(work, "dfsmn.yaml")
    launches, base, server_eng = {}, {}, None
    conf = dfsmn_raw()["model_conf"]
    n_moe = conf["num_block"] * conf["fsmn_each_block"] - 1
    t0 = time.perf_counter()
    try:
        for label, proto, settings, kname, want in DS_MODES:
            if proto not in base:
                base.clear()
                torch.cuda.empty_cache()
                with open(raw_path, "w") as f:
                    yaml.safe_dump(dfsmn_raw(proto), f)
                base[proto] = dfsmn_engine(torch, raw_path, [],
                                           f"stream {proto}", "1x512")
            src = base[proto]
            eng = src if settings["dtype"] == "float32" else Engine(
                src.model_cfg, src.params, EngineConfig(
                    **settings, bucket_lengths=(512,), bucket_batches=(1,)),
                device="cuda")
            cfg = dfsmn_stream_config(eng.model_cfg)
            causal = dict(look_ahead=0)
            if proto == DFSMN_MOE:
                causal["embed_conf"] = dataclasses.replace(cfg.embed_conf,
                                                           look_ahead=0)
            impl = (serve._stream_moe_impl(eng, DS_SLOTS)
                    if proto == DFSMN_MOE else None)
            if impl != want:
                raise SystemExit(f"FAIL dfsmn stream {label}: serve's stage "
                                 f"{impl}, want {want}")
            mine = long_feats if label in DS_LONG else half_feats
            n = dfsmn_stream_mode(torch, label, serve.stream_params(eng),
                                  cfg, dataclasses.replace(cfg, **causal),
                                  impl, kname, n_moe if impl else 0, mine,
                                  smi)
            if kname:
                launches[(label, kname)] = n
            if label == "float32":
                phase_table_growth(torch, {}, smi, eng)
            if label == "bfloat16":
                server_eng = eng
            eng = None
            torch.cuda.empty_cache()
        base.clear()
        n = server_streams(torch, "dfsmn bfloat16", server_eng, DS_CHUNK,
                           half_feats[:2], smi)
        log(f"dfsmn streams: {time.perf_counter() - t0:.1f} s")
        launches[("bfloat16", "K1")] += n.get("K1", 0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        base.clear()
        server_eng = None
        torch.cuda.empty_cache()
    return launches


def phase_dense_conformer(torch, smi):
    """Phase 14, second part: the dense ``conformer`` proto at the
    flagship encoder's widths built by the port's build in fp32, and bf16
    and bf16 flash engines on its tree, answering 1x206, 4x1000 and
    1x2048 through CUDA graphs (dfsmn_serve: graph == eager bit for bit;
    with flash K2 18 times a forward), flash held to xla; the loopback
    server's dense conformer streams (beam); each other front end in one
    fp32 1x1000 request at 2 blocks, graph == eager. Returns K2's
    launches in the flash engine's captures and eager forwards."""
    import tempfile
    import yaml
    import m3asr_tpu_torch.serve as serve
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig
    rng = np.random.default_rng(15)
    reqs = []
    for B, T in DC_REQUESTS:
        lens = np.array([T, T - 117, T - 301, T // 2][:B], np.int32)
        reqs.append((rng.standard_normal((B, T, 40)).astype(np.float32),
                     lens))
    work = tempfile.mkdtemp(prefix="conformer_")
    raw_path = os.path.join(work, "conformer.yaml")
    engines, k2 = {}, 0
    t0 = time.perf_counter()
    try:
        with open(raw_path, "w") as f:
            yaml.safe_dump(conformer_raw(), f)
        src = dfsmn_engine(torch, raw_path, [], "float32", DC_BUCKETS,
                           what="conformer")
        engines["float32"] = src
        for label, settings in (("bfloat16", dict(dtype="bfloat16")),
                                ("bfloat16+flash", dict(
                                    dtype="bfloat16", attn_impl="flash"))):
            engines[label] = Engine(src.model_cfg, src.params, EngineConfig(
                **settings, bucket_lengths=src.buckets.lengths,
                bucket_batches=src.buckets.batches), device="cuda")
        outs = {}
        for label, eng in engines.items():
            counts, outs[label], _ = dfsmn_serve(
                torch, label, eng, reqs, None, 0, DC_BLOCKS, smi,
                what="conformer")
            k2 += counts.get("K2", 0)
        for (feat, lens), (o_f, out_len), (o_x, _) in zip(
                reqs, outs["bfloat16+flash"], outs["bfloat16"]):
            f_v, x_v = (valid_rows(a[0], out_len) for a in (o_f, o_x))
            rel = float(np.abs(f_v - x_v).max() / np.abs(x_v).max())
            log(f"conformer bfloat16 flash vs xla {feat.shape[0]}x"
                f"{feat.shape[1]}: max|diff|/max|ref| {rel:.3e} (held to "
                f"0.05) {'OK' if rel <= 0.05 else 'FAIL'}")
            if not rel <= 0.05:
                raise SystemExit("FAIL conformer: flash and xla differ")
        n = server_streams(torch, "conformer bfloat16", engines["bfloat16"],
                           (DS_CHUNK, serve.DEFAULT_STREAM_KEY[1]),
                           [reqs[1][0][0], reqs[0][0][0]], smi,
                           decode="beam")
        if n:
            raise SystemExit(f"FAIL serve conformer: kernels launched {n}")
        engines.clear()
        src = None
        torch.cuda.empty_cache()
        one = [(reqs[1][0][:1], reqs[1][1][:1])]        # 1 x 1000
        for layer, pos, norm in DC_FRONTS:
            with open(raw_path, "w") as f:
                yaml.safe_dump(conformer_raw(2, layer, pos, norm), f)
            label = f"{layer} {pos}" + (" +feat_norm" if norm else "")
            eng = dfsmn_engine(torch, raw_path, [], label, "1x1024",
                               what="conformer front")
            dfsmn_serve(torch, label, eng, one, None, 0, 2, smi,
                        what="conformer front")
            eng = None
        log(f"conformer: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        engines.clear()
        torch.cuda.empty_cache()
    return k2


def phase_streams_dense(torch, state, smi):
    """Phase 14: the DFSMN streams and the dense conformer protos. The
    counts are set to 0 before the phase's main path and read after it;
    the launches of its captures join the kernels line."""
    t0 = time.perf_counter()
    reset_counts()
    state["launches_dfsmn_stream"] = phase_dfsmn_stream(torch, smi)
    state["launches_dense_k2"] = phase_dense_conformer(torch, smi)
    log(f"streams and dense conformer: phase took "
        f"{time.perf_counter() - t0:.1f} s; launches of its captures "
        f"{state['launches_dfsmn_stream']}, K2 (bf16 flash, captures and "
        f"eager forwards) {state['launches_dense_k2']}")
    if not (all(state["launches_dfsmn_stream"].values())
            and state["launches_dense_k2"]):
        raise SystemExit("FAIL phase 14: a kernel of the path never "
                         "launched")


# ---------------------------------------------------------------------------
# 15. ExMarc, moe_ffn(top_k=2) and the exported programs
# ---------------------------------------------------------------------------

EXMARC = "conformer_fmoeExMarc_localComm_catEmbed"
# (label, EngineConfig settings, the tree it starts from, the kernel of
# each request's bucket: each forward launches it twice per MoE block)
EXMARC_ENGINES = (
    ("float32", dict(dtype="float32"), "float", ("K1",) * 3),
    ("bfloat16", dict(dtype="bfloat16"), "float", ("K1",) * 3),
    ("int8", dict(dtype="int8"), "int8", QUANT_EXPECT["int8"]),
    ("w8a8", dict(dtype="int8", act_quant=True), "int8",
     QUANT_EXPECT["int8"]),
    ("int4", dict(dtype="int4"), "int4", QUANT_EXPECT["int4"]),
    ("w4a8", dict(dtype="int4", act_quant=True), "int4",
     QUANT_EXPECT["int4"]),
    ("bfloat16+flash", dict(dtype="bfloat16", attn_impl="flash"), "float",
     ("K1",) * 3),
)
EXPORT_BUCKETS = "1x256,4x1024,1x2048"     # the requests' buckets
EXPORT_DEPTH = (1, 1)                      # embed, MoE blocks exported
TOPK_TOKENS = 1020                         # moe_ffn(top_k=2): 4 x 255


def exmarc_engine(torch, work):
    """The ExMarc flagship through the port's build: the flagship YAML
    (configs/3m_asr_18l32e.yaml, d=512, 32 experts of hidden 1024,
    V=5000; 6 embed + BUILT_MOE_BLOCKS MoE blocks) with the ExMarc
    proto, seeded random
    weights (build's seed 0), then both positions' routers redrawn
    normal x 0.5 from a seeded generator so that routing spreads."""
    import yaml
    from m3asr_tpu_torch import build
    with open(os.path.join(HERE, "configs", "3m_asr_18l32e.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["nnet_proto"] = EXMARC
    raw["model_conf"]["encoder_conf"]["num_blocks"] = BUILT_MOE_BLOCKS
    path = os.path.join(work, "exmarc.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    eng, _, _ = build.build_engine(build.parse_args(
        ["-c", path, "-o", os.path.join(work, "unused"), "--skip-warmup",
         "--device", "cuda"]))
    if not eng.model_cfg.encoder_conf.exmarc:
        raise SystemExit("FAIL exmarc: the build did not read an ExMarc "
                         "config")
    gen = torch.Generator(device="cuda").manual_seed(15)
    for pos in ("feed_forward_macaron", "feed_forward"):
        k = eng.params["blocks"][pos]["router"]["kernel"]
        k.copy_(torch.randn(k.shape, generator=gen, device="cuda") * 0.5)
    return eng


def exmarc_check(torch, label, eng, feat, lens, moe_mod):
    """The eager forward held to the same engine on the kernels' plain
    versions with both positions' routing pinned: fp32 allclose(1e-5,
    1e-3) on the valid rows, else max|diff| within 0.05 of max|ref|.
    Returns (max|diff|/max|ref|, the gate calls of one forward)."""
    eng.cuda_graphs = False
    try:
        with GateRecorder(moe_mod) as rec:
            out, out_len = eng.infer(feat, lens)[:2]
        with PlainExperts(moe_mod), GateRecorder(moe_mod, replay=rec.calls):
            ref, _ = eng.infer(feat, lens)[:2]
    finally:
        eng.cuda_graphs = True
    got, want = valid_rows(out, out_len), valid_rows(ref, out_len)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    ok = (np.allclose(got, want, rtol=1e-5, atol=1e-3)
          if label == "float32" else rel <= 0.05)
    return ok, rel, len(rec.calls)


def exmarc_serve(torch, state, smi):
    """The ExMarc flagship in every serving mode through CUDA graphs: each
    request's bucket captured with 2 launches of its kernel a MoE block
    a forward (one K2 more an attention layer with flash) and none at
    replay, the graph's
    outputs bit-equal to the eager forward's, the eager logits held to
    the kernels' plain versions with both positions' routing pinned.
    Latency, device time and busy share beside phase 8's flagship."""
    import tempfile
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.moe import HOST_SYNC_STAGES
    from m3asr_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                GRAPH_WARMUP_RUNS)
    work = tempfile.mkdtemp(prefix="exmarc_")
    t0 = time.perf_counter()
    base = exmarc_engine(torch, work)
    shutil.rmtree(work)
    cfg = base.model_cfg
    enc = cfg.encoder_conf
    n_attn = enc.embed_conf.num_blocks + enc.num_blocks
    n_moe = 2 * enc.num_blocks
    log(f"exmarc: {EXMARC} built by the port's build in "
        f"{time.perf_counter() - t0:.2f} s: {enc.embed_conf.num_blocks} "
        f"embed + {enc.num_blocks} MoE blocks, d={enc.attention_dim}, "
        f"{enc.moe_conf.num_experts} experts of hidden "
        f"{enc.moe_conf.hidden_units} at both FFN positions, V="
        f"{cfg.output_dim}")
    trees = {"float": base.params}
    base = None
    # the int8 and int4 trees, quantized on the host from the bf16 values
    # in two threads at once (numpy releases the GIL; no capture runs yet)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        futs = {bits: pool.submit(
            lambda b: Engine(cfg, trees["float"], EngineConfig(dtype=b),
                             device="cuda", cuda_graphs=False).params, bits)
            for bits in ("int8", "int4")}
        trees.update({bits: f.result() for bits, f in futs.items()})
    log(f"exmarc: int8 and int4 trees, both expert positions quantized, in "
        f"{time.perf_counter() - t0:.2f} s (two threads)")
    rng = np.random.default_rng(15)
    reqs = [(rng.standard_normal((b, t, cfg.input_dim)).astype(np.float32),
             np.array([t] + [t - 37 * i for i in range(1, b)], np.int32))
            for b, t in REQUESTS]
    fwds = GRAPH_WARMUP_RUNS + 1
    flagship = state.get("graph_times", {})
    launches = {}
    for label, settings, tree, expect in EXMARC_ENGINES:
        eng = Engine(cfg, trees[tree], EngineConfig(**settings),
                     device="cuda")
        blocks = eng.params["blocks"]
        wkey = {"int8": "w1_q", "int4": "w1_q4"}.get(tree, "w1")
        if not all(wkey in blocks[pos] for pos in ("feed_forward",
                                                   "feed_forward_macaron")):
            raise SystemExit(f"FAIL exmarc {label}: an expert position is "
                             f"not in {wkey}")
        flash = settings.get("attn_impl") == "flash"
        total = {}
        for i, (feat, lens) in enumerate(reqs):
            B, T = feat.shape[:2]
            bb, bt = eng.buckets.pick(B, T)
            stage = eng.moe_impl_for(bb, bt)
            want = {expect[i]: n_moe} if expect[i] else {}
            if flash:
                want["K2"] = n_attn
            reset_counts()
            t0 = time.perf_counter()
            prog = eng.get_fn(bb, bt)
            cap_s = time.perf_counter() - t0
            at_capture = kernel_counts()
            reset_counts()
            out_g = eng.infer(feat, lens)
            at_replay = kernel_counts()
            eng.cuda_graphs = False
            reset_counts()
            out_e = eng.infer(feat, lens)
            at_eager = kernel_counts()
            eng.cuda_graphs = True
            equal = len(out_g) == len(out_e) and all(
                a.dtype == b.dtype and np.array_equal(a, b)
                for a, b in zip(out_g, out_e))
            pinned, rel, n_gates = exmarc_check(torch, label, eng, feat,
                                                lens, moe_mod)
            ok = (prog.graph is not None and stage not in HOST_SYNC_STAGES
                  and at_capture == {k: v * fwds for k, v in want.items()}
                  and not at_replay and at_eager == want and equal
                  and np.isfinite(out_g[0]).all() and pinned
                  and n_gates == n_moe)
            for k, v in list(at_capture.items()) + list(at_eager.items()):
                total[k] = total.get(k, 0) + v
            r = serve_times(torch, eng, feat, lens)
            ref = flagship.get((label, (B, T)))
            beside = ("" if ref is None else
                      f"; the flagship (phase 8): latency {ref['lat']:.3f} "
                      f"ms, device {ref['dev']:.3f} ms, busy "
                      f"{ref['dev'] / ref['lat']:.3f}")
            log(f"exmarc {label} {B}x{T}: stage {stage}, bucket {bb}x{bt} "
                f"captured in {cap_s:.2f} s with launches {at_capture} "
                f"(want {want} a forward x {fwds}), replay launches "
                f"{at_replay or 'none'}, eager {at_eager}; graph == eager "
                f"bit for bit: {equal}; vs plain versions, {n_gates} gates "
                f"pinned: max|diff|/max|ref|={rel:.3e} "
                f"{'OK' if ok else 'FAIL'}")
            log(times_line(f"exmarc {label}", B, T, "graph", r, smi)
                + beside)
            if not ok:
                raise SystemExit(f"FAIL exmarc {label} {B}x{T}: capture, "
                                 "launches or logits off")
        launches[label] = total
        eng = prog = None
        torch.cuda.empty_cache()
    trees = None
    torch.cuda.empty_cache()
    return launches


def exmarc_topk(torch, smi):
    """moe_ffn(top_k=2) at the flagship widths (1020 tokens, d=512, 32
    experts of hidden 1024, a random router over catEmbed features)
    through K1, fp32 and bf16: K1 launches once per k, and the result is
    held to the same call on K1's plain version (fp32 1e-5, bf16 1e-2 of
    max|ref|). Returns ({dtype: launches}, {dtype: max_abs_err})."""
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.moe_runs import runs_kernel
    gen = torch.Generator(device="cuda").manual_seed(16)
    launches, errs = {}, {}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        p = {k: v[0] if k in ("w1", "w2") else v for k, v in
             expert_weights(torch, dtype, gen, n_layers=1, d=D,
                            h=H).items()}
        p["router"] = {"kernel": (torch.randn(2 * D, E, generator=gen,
                                              device="cuda") * 0.5)
                       .to(dtype)}
        x = torch.randn(4, TOPK_TOKENS // 4, D, generator=gen,
                        device="cuda").to(dtype)
        embed = torch.randn(4, TOPK_TOKENS // 4, D, generator=gen,
                            device="cuda").to(dtype)
        lens = torch.tensor([255, 240, 201, 160], device="cuda")
        runs_kernel.launches = 0
        got = moe_mod.moe_ffn(p, x, embed, lens, impl="runs_f", top_k=2)
        launches[dname] = runs_kernel.launches
        with PlainExperts(moe_mod):
            ref = moe_mod.moe_ffn(p, x, embed, lens, impl="runs_f", top_k=2)
        if launches[dname] != 2 or runs_kernel.launches != 2:
            raise SystemExit(f"FAIL exmarc top-2: K1 launched "
                             f"{runs_kernel.launches} times, want 2")
        errs[dname] = rel_check(got, ref, 1e-5 if dname == "float32"
                                else 1e-2, f"moe_ffn(top_k=2) {dname} "
                                f"{TOPK_TOKENS} tokens through K1",
                                "moe_ffn top-2")
    return launches, errs


def dispatch_cost(torch, smi):
    """Host time of one K1 call through its custom operator against the
    wrapper's CUDA implementation called directly, at 63 tokens (fp32,
    the kernel queued behind the host): the operator's eager dispatch
    cost, median of 5 rounds of 200 calls each."""
    from m3asr_tpu_torch.ops import moe_runs
    gen = torch.Generator(device="cuda").manual_seed(17)
    p = {k: v[0] if k in ("w1", "w2") else v for k, v in
         expert_weights(torch, torch.float32, gen, n_layers=1, d=D,
                        h=H).items()}
    x = torch.randn(1, 63, D, generator=gen, device="cuda")
    gate = routing(torch, "router", 63, gen)
    k = moe_runs.runs_kernel
    paths = {"operator": lambda: k(p, x, gate),
             "direct": lambda: k._launch(p, x, gate, None, False, "swish",
                                         None)}
    us = {n: [] for n in paths}
    for _ in range(5):
        for n, f in paths.items():
            f()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                f()
            us[n].append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
    op, direct = (float(np.median(us[n])) for n in ("operator", "direct"))
    log(f"exmarc dispatch: one K1 call at 63 tokens (fp32) takes "
        f"{op:.1f} us of host time through m3asr::moe_runs_f, {direct:.1f} "
        f"us through the wrapper's CUDA implementation directly: the "
        f"operator adds {op - direct:.1f} us a call in eager mode (none in "
        f"a graph replay); {smi}")


def exported_engines(torch, state, smi):
    """The flagship at its widths, its depth cut to EXPORT_DEPTH (the
    export traces every operator of the forward on the host: 31-41 s a
    bucket at 2 + 6 blocks on the card's host), seeded weights, as bf16
    and int4 engine dirs
    with exported programs over the requests' three buckets (the save of
    ``build --export``): export seconds per bucket, a fresh
    Engine.load, every bucket run from its loaded program
    (loaded_buckets) and captured from it with the kernels' launches
    counted, replays bit-equal to the graphs of the engine that traced
    the model code; load-and-capture seconds beside that engine's
    warm-up of the same buckets."""
    import tempfile
    from m3asr_tpu_torch.models import moe_conformer
    from m3asr_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                GRAPH_WARMUP_RUNS)
    cfg = flagship_cfg()
    enc = cfg.encoder_conf
    enc.embed_conf.num_blocks, enc.num_blocks = EXPORT_DEPTH
    gen = torch.Generator(device="cuda").manual_seed(19)
    params = moe_conformer.init(enc, cfg.input_dim, cfg.output_dim, gen,
                                device="cuda")
    r = params["blocks"]["feed_forward"]["router"]
    r["kernel"] = torch.randn(r["kernel"].shape, generator=gen,
                              device="cuda") * 0.5
    n_moe = enc.num_blocks
    fwds = GRAPH_WARMUP_RUNS + 1
    pairs = [tuple(map(int, b.split("x")))
             for b in EXPORT_BUCKETS.split(",")]
    rng = np.random.default_rng(18)
    reqs = [(rng.standard_normal((b, t, cfg.input_dim)).astype(np.float32),
             np.full((b,), t, np.int32)) for b, t in REQUESTS]
    launches = {}
    for label, settings, expect in (
            ("bfloat16", dict(dtype="bfloat16"), ("K1",) * 3),
            ("int4", dict(dtype="int4"), QUANT_EXPECT["int4"])):
        eng = Engine(cfg, params, EngineConfig(
            bucket_batches=tuple(sorted({b for b, _ in pairs})),
            bucket_lengths=tuple(sorted({t for _, t in pairs})),
            **settings), device="cuda")
        buckets = [eng.buckets.pick(b, t) for b, t in REQUESTS]
        work = tempfile.mkdtemp(prefix=f"export_{label}_")
        t0 = time.perf_counter()
        eng.save(work)
        save_s = time.perf_counter() - t0
        os.makedirs(os.path.join(work, "exported"))
        export_s = {}
        for b, t in buckets:
            t0 = time.perf_counter()
            torch.export.save(eng.export_bucket(b, t), os.path.join(
                work, "exported", f"{b}x{t}.{eng.device.type}.pt2"))
            export_s[f"{b}x{t}"] = round(time.perf_counter() - t0, 3)
        size = sum(os.path.getsize(os.path.join(work, "exported", f))
                   for f in os.listdir(os.path.join(work, "exported")))
        t0 = time.perf_counter()
        eng.warmup(buckets)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = Engine.load(work, device="cuda")
        load_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        loaded.warmup(buckets)
        torch.cuda.synchronize()
        cap_s = time.perf_counter() - t0
        at_capture = kernel_counts()
        want = {}
        for k in expect:
            want[k] = want.get(k, 0) + n_moe * fwds
        reset_counts()
        equal = True
        for feat, lens in reqs:
            a, b = loaded.infer(feat, lens), eng.infer(feat, lens)
            equal &= len(a) == len(b) and all(
                x.dtype == y.dtype and np.array_equal(x, y)
                for x, y in zip(a, b))
        at_replay = kernel_counts()
        ok = (loaded.loaded_buckets == set(buckets) and at_capture == want
              and not at_replay and equal and all(
                  loaded.get_fn(b, t).graph is not None
                  for b, t in buckets))
        log(f"exported {label}: engine dir saved in {save_s:.2f} s, "
            f"programs "
            f"exported in {export_s} s ({size / 2**20:.2f} MiB for "
            f"{len(buckets)} buckets, no weights), loaded in {load_s:.2f} "
            f"s; loaded buckets {sorted(loaded.loaded_buckets)}; capture "
            f"from the loaded programs {cap_s:.2f} s (the tracing engine's "
            f"warm-up of the same buckets {traced_s:.2f} s) with launches "
            f"{at_capture} (want {want}), replay launches "
            f"{at_replay or 'none'}; answers bit-equal to the tracing "
            f"engine's graphs: {equal}; {smi} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"FAIL exported {label}: programs not loaded, "
                             "launches off or answers differ")
        for k, v in at_capture.items():
            launches[(label, k)] = v
        shutil.rmtree(work)
        eng = loaded = None
        torch.cuda.empty_cache()
    return launches


def phase_exmarc(torch, state, smi):
    """Phase 15: ExMarc serving, moe_ffn(top_k=2), the custom operators'
    dispatch cost and the exported programs. Returns the launches of each
    kernel variant (the kernels line's names) on this path."""
    t0 = time.perf_counter()
    served = exmarc_serve(torch, state, smi)
    topk, errs = exmarc_topk(torch, smi)
    dispatch_cost(torch, smi)
    exported = exported_engines(torch, state, smi)
    names = {("float32", "K1"): "moe_runs_f[float32]",
             ("bfloat16", "K1"): "moe_runs_f[bfloat16]",
             ("bfloat16+flash", "K1"): "moe_runs_f[bfloat16]",
             ("bfloat16+flash", "K2"): "flash_fwd[bfloat16]",
             ("int8", "K4"): QUANT_NAMES[("K4", False)],
             ("w8a8", "K4"): QUANT_NAMES[("K4", True)],
             ("int4", "K5"): QUANT_NAMES[("K5", False)],
             ("int4", "K6"): QUANT_NAMES[("K6", False)],
             ("w4a8", "K5"): QUANT_NAMES[("K5", True)],
             ("w4a8", "K6"): QUANT_NAMES[("K6", True)]}
    by_name = {}
    for label, counts in served.items():
        for k, v in counts.items():
            name = names[(label, k)]
            by_name[name] = by_name.get(name, 0) + v
    for dname, v in topk.items():
        name = f"moe_runs_f[{dname}]"
        by_name[name] = by_name.get(name, 0) + v
    for (label, k), v in exported.items():
        name = names[(label, k)]
        by_name[name] = by_name.get(name, 0) + v
    log(f"exmarc: phase 15 took {time.perf_counter() - t0:.1f} s; launches "
        f"{by_name}; {smi}")
    state["max_err_topk"] = errs
    return by_name


TRAIN_CLI_FRAMES = (1000, 930, 870, 820, 760, 700, 655, 610, 560, 520, 480,
                    450, 410, 380, 340, 300)   # the 16 training utterances
TRAIN_CLI_CV = (990, 720, 505, 310)            # the 4 validation ones
TRAIN_CLI_STEPS = 4          # an epoch: 16 utterances in batches of 4
TRAIN_CLI_ACCUM = 2          # microbatches a step (accum_steps)
# the CLI runs' MoE blocks: a checkpoint (parameters and Adam moments, and
# their best copies where those differ) is 2.43-4.86 GiB at 2 blocks,
# 9.01-18.02 at 18, and the script keeps its disk writes under 45 GiB
TRAIN_CLI_MOE_BLOCKS = 2


def train_cli_inputs(work, cfg):
    """The CLI's inputs under ``work``: tr.ark / cv.ark (Kaldi features at
    the flagship's 40 dims) with their CTC label arks, the training
    utterances' AED label, domain and accent id arks, and cfg1.yaml /
    cfg2.yaml: the flagship YAML at TRAIN_CLI_MOE_BLOCKS MoE blocks with
    batch_size 4, log_period 1, save_period an epoch, attn_impl flash,
    accum_steps 2, device SpecAugment, and max_epoch 1 (run 1) or 2 (run
    2, the resume)."""
    import yaml
    from m3asr_tpu_torch.io.kaldi_io import ArkWriter
    rng = np.random.default_rng(16)
    V = cfg.output_dim
    for name, frames in (("tr", TRAIN_CLI_FRAMES), ("cv", TRAIN_CLI_CV)):
        keys = [f"{name}{i}" for i in range(len(frames))]
        with ArkWriter(os.path.join(work, f"{name}.ark")) as w:
            for k, T in zip(keys, frames):
                w.write(k, rng.standard_normal((T, cfg.input_dim))
                        .astype(np.float32))
        write_int_vectors(os.path.join(work, f"{name}_ctc.ark"), {
            k: rng.integers(1, V - 1, T // 40) for k, T in zip(keys, frames)})
        write_int_vectors(os.path.join(work, f"{name}_aed.ark"), {
            k: rng.integers(1, V - 1, T // 50) for k, T in zip(keys, frames)})
        write_int_vectors(os.path.join(work, f"{name}_domain.ark"),
                          {k: [rng.integers(0, 6)] for k in keys})
        write_int_vectors(os.path.join(work, f"{name}_acc.ark"),
                          {k: [rng.integers(0, 8)] for k in keys})
    with open(os.path.join(HERE, "configs", "3m_asr_18l32e.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["loader_conf"]["batch_size"] = 4
    raw["model_conf"]["encoder_conf"]["num_blocks"] = TRAIN_CLI_MOE_BLOCKS
    raw.update(log_period=1, save_period=TRAIN_CLI_STEPS, attn_impl="flash",
               accum_steps=TRAIN_CLI_ACCUM, spec_aug_device=True)
    for epochs in (1, 2):
        with open(os.path.join(work, f"cfg{epochs}.yaml"), "w") as f:
            yaml.safe_dump(dict(raw, max_epoch=epochs), f)


def train_cli_argv(work, out, epochs):
    a = lambda name: os.path.join(work, name)
    argv = ["--config", a(f"cfg{epochs}.yaml"), "--output_dir", out,
            "--tr_rspecifier", a("tr.ark"), "--tr_labels", a("tr_ctc.ark"),
            "--tr_aed_labels", a("tr_aed.ark"),
            "--tr_domain_labels", a("tr_domain.ark"),
            "--tr_acc_labels", a("tr_acc.ark"),
            "--cv_rspecifier", a("cv.ark"), "--cv_labels", a("cv_ctc.ark")]
    return argv + (["--resume"] if epochs > 1 else [])


class TrainCliSpy:
    """Times the CLI's steps and checkpoint saves (the step synced to the
    card), and keeps the parameters a resume loads (on the host). The
    steps are those of the step factory ``factory`` of train/step.py."""

    def __init__(self, torch, factory="make_hier_train_step"):
        from m3asr_tpu_torch.train import step as ts
        from m3asr_tpu_torch.train import trainer as tr
        self.torch, self.ts, self.tr, self.factory = torch, ts, tr, factory
        self.step_ms, self.frames, self.saves = [], [], []
        self.loaded = None

    def __enter__(self):
        torch, spy = self.torch, self
        self.make, self.save, self.load = (getattr(self.ts, self.factory),
                                           self.tr.Trainer.save_checkpoint,
                                           self.tr.Trainer.load_checkpoint)

        def make(*a, **k):
            step = spy.make(*a, **k)

            def timed(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*args, **kw)
                torch.cuda.synchronize()
                spy.step_ms.append((time.perf_counter() - t0) * 1e3)
                spy.frames.append(int(np.sum(args[3])))
                return out
            return timed

        def save(trainer, tag="last"):
            t0 = time.perf_counter()
            spy.save(trainer, tag)
            path = trainer._ckpt_path(tag)
            spy.saves.append((tag, time.perf_counter() - t0,
                              os.path.getsize(path) / 2 ** 30))

        def load(trainer, tag="last"):
            ok = spy.load(trainer, tag)
            from m3asr_tpu_torch.checkpoint import flatten_tree
            spy.loaded = (trainer.global_step, {
                k: v.cpu() for k, v in flatten_tree(trainer.params).items()})
            return ok
        setattr(self.ts, self.factory, make)
        self.tr.Trainer.save_checkpoint = save
        self.tr.Trainer.load_checkpoint = load
        return self

    def __exit__(self, *exc):
        setattr(self.ts, self.factory, self.make)
        self.tr.Trainer.save_checkpoint = self.save
        self.tr.Trainer.load_checkpoint = self.load


def train_cli_run(torch, work, out, epochs, want, smi):
    """One in-process run of the training CLI; holds its launches of K2
    and K3 to ``want`` and its logged losses finite. Returns the spy, the
    peak memory and the launches (K2, K3 dq, K3 dkv) counted."""
    import contextlib
    import io
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    from m3asr_tpu_torch.train import cli
    reset_flash(flash_kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TrainCliSpy(torch) as spy, contextlib.redirect_stdout(io.StringIO()):
        trainer = cli.main(train_cli_argv(work, out, epochs))
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = (flash_kernels.fwd_launches, flash_kernels.dq_launches,
           flash_kernels.dkv_launches)
    with open(os.path.join(out, "scalars", "scalars.jsonl")) as f:
        losses = [json.loads(line)["value"] for line in f
                  if '"train/loss"' in line]
    losses = losses[-TRAIN_CLI_STEPS:]
    med = float(np.median(spy.step_ms))
    rate = float(np.sum(spy.frames) / (np.sum(spy.step_ms) / 1e3))
    log(f"train_cli run {epochs}: {len(spy.step_ms)} steps of "
        f"{TRAIN_CLI_ACCUM} microbatches to global step "
        f"{trainer.global_step}, {secs:.1f} s; losses "
        f"{[round(v, 6) for v in losses]}; step ms "
        f"{[round(v, 3) for v in spy.step_ms]} (median {med:.3f}), "
        f"{rate:.0f} frames/s; checkpoints (tag, s, GiB) "
        f"{[(t, round(s, 2), round(g, 2)) for t, s, g in spy.saves]}; "
        f"launches (K2, K3 dq, K3 dkv) {got}, want {want}; peak memory "
        f"{peak:.3f} GiB; {smi}")
    if (got != want or len(losses) != TRAIN_CLI_STEPS
            or not np.all(np.isfinite(losses))
            or trainer.global_step != TRAIN_CLI_STEPS * epochs):
        raise SystemExit(f"FAIL train_cli run {epochs}: launches {got}, "
                         f"want {want}; losses {losses}; global step "
                         f"{trainer.global_step}")
    del trainer
    torch.cuda.empty_cache()
    return spy, peak, got


def hier_tree(torch, cfg, params):
    """The hier recipe's tree at the flagship's widths: the encoder,
    three AED decoders of 6 blocks (8 heads, 2048 units) and the
    domain/accent heads, from a seeded generator on the card."""
    from m3asr_tpu_torch.config import DecoderConfig
    from m3asr_tpu_torch.models import aed
    from m3asr_tpu_torch.train import step as ts
    cfg.decoder_conf = DecoderConfig(attention_heads=8, linear_units=2048,
                                     num_blocks=6)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tree = {"encoder": params}
    for name in DECODERS:
        tree[name] = aed.init(cfg.decoder_conf, cfg.output_dim,
                              cfg.encoder_conf.attention_dim, gen)
    tree.update(ts.init_domain_acc_heads(
        gen, cfg.encoder_conf.embed_conf.attention_dim, 6, 8))
    return tree


def hier_batch(torch, cfg):
    """train_batch's 4 x 1000 frames and CTC targets, with AED targets and
    domain / accent ids, on the card."""
    rng = np.random.default_rng(8)
    aed_lens = np.array([30, 27, 22, 19], np.int32)
    extra = (rng.integers(1, cfg.output_dim - 1, (4, 30)).astype(np.int32),
             aed_lens, np.array([0, 3, 5, 2], np.int32),
             np.array([7, 1, 4, 0], np.int32))
    return train_batch(torch, cfg) + tuple(torch.from_numpy(a).cuda()
                                           for a in extra)


def hier_group(path):
    """param_group of an encoder path, else the module down to a decoder
    block's sublayer ("decoder_1/decoders/src_attn", "acc_head/out")."""
    head, _, rest = path.partition("/")
    if head == "encoder":
        return "encoder/" + param_group(rest)
    return "/".join(path.split("/")[:-1][:3])


def held_grads(label, loss, ref_loss, rels, extra="", phase="train_cli"):
    """Holds a loss within 1e-5 relative and every group's gradient
    distance within TRAIN_GRAD_TOL; returns the largest distance."""
    rel = abs(loss - ref_loss) / abs(ref_loss)
    worst = max(rels.values())
    ok = rel <= 1e-5 and worst <= TRAIN_GRAD_TOL
    log(f"{phase} {label}: loss {loss:.6f} vs {ref_loss:.6f} (rel "
        f"{rel:.3e}, held to 1e-5); largest max|diff|/max|g| of a group "
        f"{worst:.3e} ({max(rels, key=rels.get)}), held to "
        f"{TRAIN_GRAD_TOL}{extra} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"FAIL {phase} {label}")
    return worst


def hier_checks(torch, cfg, tree, batch, smi):
    """(i)-(iv) on one hier batch at the flagship's widths."""
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    from m3asr_tpu_torch.train import step as ts

    def hcfg(**kw):
        return ts.HierTrainConfig(**{"attn_impl": "flash", **kw})

    def hvg(tcfg, replay=None, record=False):
        with GateRecorder(moe_mod, replay=replay) as rec:
            (loss, _), g = ts.hier_value_and_grad(
                tree, cfg, tcfg, *batch[:6], domain_targets=batch[6],
                acc_targets=batch[7])
        return loss.item(), g, rec.calls if record else None

    # (i) flash against xla, routing pinned
    loss_f, g_f, calls = hvg(hcfg(), record=True)
    loss_x, g_x, _ = hvg(hcfg(attn_impl="xla"), replay=calls)
    held_grads("(i) hier fp32 flash vs xla (routing pinned, heads and decoders "
         "in the groups)", loss_f, loss_x, group_rel(g_f, g_x, hier_group))
    del g_f
    # (ii) two microbatches against the full batch, xla, routing pinned
    half = batch[0].shape[0] // 2
    mb_calls = [c[:half] for c in calls] + [c[half:] for c in calls]
    loss_a, g_a, _ = hvg(hcfg(attn_impl="xla", accum_steps=2),
                         replay=mb_calls)
    held_grads("(ii) hier fp32 xla accum_steps=2 vs 1 (routing pinned)", loss_a,
         loss_x, group_rel(g_a, g_x, hier_group))
    del g_a, g_x
    torch.cuda.empty_cache()
    # (iii) remat against plain, the CTC step, flash
    runs = {}
    for remat in (False, True):
        reset_flash(flash_kernels)
        torch.cuda.reset_peak_memory_stats()
        (loss, _), g = ts.value_and_grad(
            tree["encoder"], cfg, ts.TrainConfig(
                attn_impl="flash", embed_ctc_weight=0.3, remat=remat),
            *batch[:4])
        torch.cuda.synchronize()
        runs[remat] = (loss.item(), g,
                       torch.cuda.max_memory_allocated() / 2 ** 30,
                       (flash_kernels.fwd_launches, flash_kernels.dq_launches,
                        flash_kernels.dkv_launches))
        del g
    (l0, g0, m0, k0), (l1, g1, m1, k1) = runs[False], runs[True]
    diff = max((g1[k] - g0[k]).abs().max().item() for k in g0)
    held_grads("(iii) CTC fp32 flash remat vs plain", l1, l0,
         group_rel(g1, g0), f"; largest |diff| {diff:.3e}; peak memory "
         f"{m1:.3f} GiB with remat, {m0:.3f} without; launches (K2, K3 dq, "
         f"K3 dkv) {k1} with remat, {k0} without; {smi}")
    n_moe = cfg.encoder_conf.num_blocks
    n_attn = n_moe + cfg.encoder_conf.embed_conf.num_blocks
    if m1 >= m0 or k1 != (n_moe + n_attn, n_attn, n_attn) or \
            k0 != (n_attn,) * 3:
        raise SystemExit(f"FAIL train_cli (iii): peak {m1:.3f} GiB with "
                         f"remat, {m0:.3f} without; launches {k1}, {k0}")
    del runs, g0, g1
    torch.cuda.empty_cache()
    # (iv) the bf16-compute hier loss against fp32's
    with torch.no_grad():
        lb = ts.hier_aed_loss_fn(tree, cfg, hcfg(compute_dtype="bfloat16"),
                                 *batch[:6], domain_targets=batch[6],
                                 acc_targets=batch[7])[0].item()
    rel = abs(lb - loss_f) / abs(loss_f)
    log(f"train_cli (iv) hier bf16-compute flash loss {lb:.6f} vs fp32 "
        f"{loss_f:.6f}: rel {rel:.3e}, held to 2e-2 "
        f"{'OK' if rel <= 2e-2 else 'FAIL'}")
    if rel > 2e-2:
        raise SystemExit("FAIL train_cli (iv): the bf16 hier loss is off")


def hier_step_profile(torch, cfg, tree, batch, smi):
    """One hier step with the CLI's settings (flash, two microbatches,
    Adam) on the 4 x 1000 batch: wall and device time, busy share."""
    from m3asr_tpu_torch.train import step as ts
    tcfg = ts.HierTrainConfig(attn_impl="flash", accum_steps=TRAIN_CLI_ACCUM)
    opt = ts.make_optimizer(tcfg)
    state = ts.init_opt_state(opt, tree)
    step = ts.make_hier_train_step(cfg, tcfg, opt, with_domain_acc=True,
                                   device="cuda")
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(tree, state, *batch)
        out[2]["loss"].item()
        ms.append((time.perf_counter() - t0) * 1e3)
        del out
    dev_ms = profiled_ms(torch, lambda: step(tree, state, *batch), 1,
                         warmup=0)
    log(f"train_cli hier step (flash, {TRAIN_CLI_ACCUM} microbatches, "
        f"4 x 1000 frames): wall ms {[round(v, 3) for v in ms]}; device "
        f"time {dev_ms:.3f} ms under torch.profiler, busy "
        f"{dev_ms / np.median(ms):.3f} of the median step; {smi}")


def phase_train_cli(torch, state, smi):
    """Phase 16: the port's training CLI on the flagship's widths at
    TRAIN_CLI_MOE_BLOCKS MoE blocks (hier recipe with the heads, flash,
    two microbatches, device SpecAugment), run and resumed; then checks
    (i)-(iv) at the flagship's widths and depth. Returns K2's and K3's
    launches counted in the two runs (K3: the dq kernel's, which the runs
    hold equal to the dkv kernel's)."""
    import pickle
    import shutil
    import tempfile
    from m3asr_tpu_torch.checkpoint import flatten_tree
    t_start = time.perf_counter()
    cfg = flagship_cfg()
    n_attn = cfg.encoder_conf.embed_conf.num_blocks + TRAIN_CLI_MOE_BLOCKS
    n_mb = TRAIN_CLI_STEPS * TRAIN_CLI_ACCUM
    # K2 in every microbatch forward and once a layer in the validation
    # forward (4 utterances, one batch); K3 in every microbatch backward
    # (the heads train the embed encoder: every attention layer)
    want = ((n_mb + 1) * n_attn, n_mb * n_attn, n_mb * n_attn)
    work = tempfile.mkdtemp(prefix="train_cli_")
    out = os.path.join(work, "exp")
    try:
        train_cli_inputs(work, cfg)
        spy1, peak, got1 = train_cli_run(torch, work, out, 1, want, smi)
        names = set(os.listdir(out))
        events = [f for f in os.listdir(os.path.join(out, "scalars"))
                  if f.startswith("events.out.tfevents")]
        need = {"checkpoint_last.pkl", "checkpoint_best.pkl", "train.log"}
        if not need <= names or not events:
            raise SystemExit(f"FAIL train_cli run 1 wrote {sorted(names)}")
        t0 = time.perf_counter()
        with open(os.path.join(out, "checkpoint_last.pkl"), "rb") as f:
            last = flatten_tree(pickle.load(f)["params"])
        read_s = time.perf_counter() - t0
        os.remove(os.path.join(out, "checkpoint_final.pkl"))  # run 2's own
        spy2, _, got2 = train_cli_run(torch, work, out, 2, want, smi)
        step0, loaded = spy2.loaded
        same = sorted(loaded) == sorted(last) and all(
            np.array_equal(loaded[k].numpy(), v) for k, v in last.items())
        log(f"train_cli resume: started at global step {step0} from "
            f"{len(loaded)} tensors {'bit-equal' if same else 'NOT equal'}"
            f" to run 1's checkpoint_last.pkl (read in {read_s:.1f} s); "
            f"checkpoint_final.pkl "
            f"{'written' if os.path.exists(os.path.join(out, 'checkpoint_final.pkl')) else 'MISSING'}")
        if step0 != TRAIN_CLI_STEPS or not same or not os.path.exists(
                os.path.join(out, "checkpoint_final.pkl")):
            raise SystemExit("FAIL train_cli resume")
        del last, loaded
        spy2.loaded = None
    finally:
        shutil.rmtree(work, ignore_errors=True)
    written = sum(g for spy in (spy1, spy2) for _, _, g in spy.saves)
    log(f"train_cli: the CLI runs (6 embed + {TRAIN_CLI_MOE_BLOCKS} MoE "
        f"blocks) took {time.perf_counter() - t_start:.1f} s and wrote "
        f"{written:.2f} GiB of checkpoints; peak memory {peak:.3f} GiB in "
        f"run 1; {smi}")
    params = state.get("params")
    if params is None:
        cfg, params = flagship_params(torch)
    tree = hier_tree(torch, cfg, params)
    batch = hier_batch(torch, cfg)
    hier_checks(torch, cfg, tree, batch, smi)
    hier_step_profile(torch, cfg, tree, batch, smi)
    del tree
    torch.cuda.empty_cache()
    log(f"train_cli: phase 16 took {time.perf_counter() - t_start:.1f} s; "
        f"{smi}")
    return {"K2": got1[0] + got2[0], "K3": got1[1] + got2[1]}


# ---------------------------------------------------------------------------
# the float64 gradient witnesses (--only hier_witness dfsmn_witness; not
# in the default run): a check of two float32 gradients against the
# same gradient computed in float64 on the plain path, with the same
# expert choices, tells a fault (the float64 runs differ too) from
# float32 rounding (they agree, and the float32 runs lie from them)
# ---------------------------------------------------------------------------

WITNESS_MOE_BLOCKS = 4        # phase 16 at 6 + 4, where check (ii) failed
WITNESS_SPLIT_TOL = 1e-9      # float64 accum_steps=2 vs 1, of max|g|
WITNESS_GROUP = "decoder_1/decoders/feed_forward"   # (ii)'s worst at 6 + 4


def f64_tree(torch, tree):
    """``tree`` with every float leaf in float64 (dicts, lists)."""
    if isinstance(tree, dict):
        return {k: f64_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [f64_tree(torch, v) for v in tree]
    return tree.double() if torch.is_tensor(tree) and \
        tree.is_floating_point() else tree


def group_max(g, group):
    """max|g| per parameter group."""
    out = {}
    for k, v in g.items():
        out[group(k)] = max(out.get(group(k), 0.0), v.abs().max().item())
    return out


def witness_line(phase, label, rels, watch=None, top=4):
    """One comparison's ``top`` largest groups (and ``watch``'s) as a log
    line; returns the largest distance."""
    order = sorted(rels, key=rels.get, reverse=True)
    extra = f"; {watch} {rels[watch]:.3e}" if watch in rels else ""
    log(f"{phase} {label}: largest max|diff|/max|g| of a group "
        + ", ".join(f"{rels[k]:.3e} ({k})" for k in order[:top]) + extra)
    return rels[order[0]]


def hier_witness(torch, state, smi):
    """Phase 16's check (ii) at 6 + WITNESS_MOE_BLOCKS blocks against a
    float64 witness: the hier recipe on hier_tree / hier_batch (xla
    attention, the dense expert stage), the routing of a float32 flash
    run replayed everywhere (split by rows for two microbatches, as (ii)
    does). Logs, per group (hier_group): float64 accum_steps=2 against
    float64 accum_steps=1 (the split in near-exact arithmetic), each
    float32 run against float64, and (ii) itself; fails if the float64
    split differs by more than WITNESS_SPLIT_TOL of a group's max|g|."""
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.train import step as ts
    t0 = time.perf_counter()
    cfg, params = flagship_params(torch, WITNESS_MOE_BLOCKS)
    tree = hier_tree(torch, cfg, params)
    batch = hier_batch(torch, cfg)
    del params

    def hvg(tree, feat, accum, attn_impl="xla", replay=None,
            rows=slice(None)):
        b = [t[rows] for t in batch]
        with GateRecorder(moe_mod, replay=replay) as rec:
            (loss, _), g = ts.hier_value_and_grad(
                tree, cfg, ts.HierTrainConfig(attn_impl=attn_impl,
                                              accum_steps=accum),
                feat, *b[1:6], domain_targets=b[6], acc_targets=b[7])
        torch.cuda.synchronize()
        return loss.item(), g, rec.calls

    _, g, calls = hvg(tree, batch[0], 1, "flash")
    del g
    half = batch[0].shape[0] // 2
    mb = [c[:half] for c in calls] + [c[half:] for c in calls]
    l32_1, g32_1, _ = hvg(tree, batch[0], 1, replay=calls)
    l32_2, g32_2, _ = hvg(tree, batch[0], 2, replay=mb)
    torch.cuda.empty_cache()
    tree32, tree64 = tree, f64_tree(torch, tree)
    del tree
    torch.cuda.reset_peak_memory_stats()
    l64_1, g64_1, _ = hvg(tree64, batch[0].double(), 1, replay=calls)
    l64_2, g64_2, _ = hvg(tree64, batch[0].double(), 2, replay=mb)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dtypes = {str(v.dtype) for g in (g64_1, g64_2) for v in g.values()}
    phase = "hier_witness"
    log(f"{phase}: 6 + {WITNESS_MOE_BLOCKS} blocks, hier recipe on 4 x "
        f"1000 frames, xla, routing of a float32 flash run pinned; losses "
        f"float64 accum 1 {l64_1:.12f}, accum 2 {l64_2:.12f}; float32 "
        f"accum 1 {l32_1:.7f}, accum 2 {l32_2:.7f}; float64 gradients "
        f"{sorted(dtypes)}; peak {peak:.3f} GiB in float64; {smi}")
    split = witness_line(phase, "float64 accum 2 vs float64 accum 1",
                         group_rel(g64_2, g64_1, hier_group), WITNESS_GROUP)
    r1 = witness_line(phase, "float32 accum 1 vs float64 accum 1",
                      group_rel(g32_1, g64_1, hier_group), WITNESS_GROUP)
    r2 = witness_line(phase, "float32 accum 2 vs float64 accum 1",
                      group_rel(g32_2, g64_1, hier_group), WITNESS_GROUP)
    ii = witness_line(phase, "check (ii): float32 accum 2 vs float32 "
                      "accum 1", group_rel(g32_2, g32_1, hier_group),
                      WITNESS_GROUP)
    # each microbatch alone (B=2, its rows of the routing): float32
    # against float64, and the group's size in each
    per_mb = []
    for i in (0, 1):
        rows = slice(i * half, (i + 1) * half)
        sub = [c[rows] for c in calls]
        _, a32, _ = hvg(tree32, batch[0][rows], 1, replay=sub,
                        rows=rows)
        _, a64, _ = hvg(tree64, batch[0][rows].double(), 1, replay=sub,
                        rows=rows)
        rel = group_rel(a32, a64, hier_group)
        per_mb.append((rel.get(WITNESS_GROUP), group_max(
            a64, hier_group).get(WITNESS_GROUP)))
        witness_line(phase, f"microbatch {i} alone (B={half}): float32 vs "
                     "float64", rel, WITNESS_GROUP)
        del a32, a64
    log(f"{phase}: {WITNESS_GROUP} in each microbatch alone: float32 "
        "from float64, max|g| in float64: " + "; ".join(
            f"{r:.3e}, {m:.6e}" for r, m in per_mb))
    # microbatch 1's rows twice (a batch of 4, its gradient the same in
    # exact arithmetic), and microbatch 1 alone with cuDNN off: the shape's
    # kernels against the data
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    convs = {}
    for label, rows in (("B=4", [half, half + 1, half, half + 1]),
                        ("B=2", slice(half, 2 * half))):
        sub = [c[rows] for c in calls]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, a32, _ = hvg(tree32, batch[0][rows], 1, replay=sub,
                            rows=rows)
        # the float32 step's device kernels (cuBLAS's and cuDNN's
        # choices by shape)
        convs[label] = sorted({e.name for e in prof.events()
                               if e.device_type == DeviceType.CUDA})
        if label == "B=4":
            _, a64, _ = hvg(tree64, batch[0][rows].double(), 1, replay=sub,
                            rows=rows)
            twice = group_rel(a32, a64, hier_group).get(WITNESS_GROUP)
            del a64
        del a32
    only2 = sorted(set(convs["B=2"]) - set(convs["B=4"]))
    log(f"{phase}: the float32 step's kernels at B=2 and not at B=4 "
        f"({len(only2)}): {[k[:100] for k in only2[:20]]}; at both "
        f"{len(set(convs['B=2']) & set(convs['B=4']))}")
    rows = slice(half, 2 * half)
    sub = [c[rows] for c in calls]
    torch.backends.cudnn.enabled = False
    try:
        _, a32, _ = hvg(tree32, batch[0][rows], 1, replay=sub, rows=rows)
        _, a64, _ = hvg(tree64, batch[0][rows].double(), 1, replay=sub,
                        rows=rows)
    finally:
        torch.backends.cudnn.enabled = True
    no_cudnn = group_rel(a32, a64, hier_group).get(WITNESS_GROUP)
    del a32, a64
    log(f"{phase}: {WITNESS_GROUP}, float32 from float64: microbatch 1's "
        f"rows twice (B=4) {twice:.3e}; microbatch 1 alone with cuDNN off "
        f"{no_cudnn:.3e}")
    mags = group_max(g64_1, hier_group)
    top = max(mags, key=mags.get)
    log(f"{phase}: max|g| in float64 of {WITNESS_GROUP} "
        f"{mags.get(WITNESS_GROUP, 0.0):.6e}, of the largest group ({top}) "
        f"{mags[top]:.6e}; took {time.perf_counter() - t0:.1f} s")
    verdict = ("a fault of the split" if split > WITNESS_SPLIT_TOL else
               "float32 rounding: the float64 split is exact")
    log(f"{phase}: float64 split {split:.3e} against {WITNESS_SPLIT_TOL}; "
        f"float32 runs {r1:.3e} / {r2:.3e} from float64, (ii) {ii:.3e}: "
        f"{verdict}")
    if split > WITNESS_SPLIT_TOL or dtypes != {"torch.float64"}:
        raise SystemExit(f"FAIL {phase}: {verdict}")
    del g32_1, g32_2, g64_1, g64_2, tree32, tree64
    torch.cuda.empty_cache()


def dfsmn_witness(torch, state, smi):
    """Phase 17's DFSMN-MoE CE check at 3 x DFSMN_EACH_BLOCK cFSMN layers
    against a float64 witness: the CE step on the alignment batch of
    dfsmn_train_checks, fp32 flash (its routing pinned everywhere), fp32
    xla and float64 xla; logs each float32 path's distance from float64
    per group (dfsmn_group) beside the check's own flash-vs-xla reading."""
    from m3asr_tpu_torch.config import model_config_from_dict
    from m3asr_tpu_torch.models.registry import get_family
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.train import step as ts
    t0 = time.perf_counter()
    cfg = model_config_from_dict(dfsmn_raw(each=DFSMN_EACH_BLOCK))
    params = get_family(DFSMN_MOE).init(
        cfg, torch.Generator(device="cuda").manual_seed(17))
    batch = train_batch(torch, cfg)
    rng = np.random.default_rng(17)
    align = torch.from_numpy(rng.integers(
        0, cfg.output_dim, (len(TRAIN_LENS), max(TRAIN_LENS)))
        .astype(np.int32)).cuda()

    def vg(params, feat, attn_impl, replay=None):
        with GateRecorder(moe_mod, replay=replay) as rec:
            (loss, _), g = ts.value_and_grad(
                params, cfg, ts.TrainConfig(attn_impl=attn_impl,
                                            loss_type="ce"),
                feat, batch[1], align, batch[1])
        torch.cuda.synchronize()
        return loss.item(), g, rec.calls

    lf, g_f, calls = vg(params, batch[0], "flash")
    lx, g_x, _ = vg(params, batch[0], "xla", calls)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    l64, g64, _ = vg(f64_tree(torch, params), batch[0].double(), "xla",
                     calls)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    phase = "dfsmn_witness"
    log(f"{phase}: {DFSMN_MOE} at 3 x {DFSMN_EACH_BLOCK} cFSMN layers, CE "
        f"on 4 x 1000 frames, routing of the fp32 flash run pinned; losses "
        f"fp32 flash {lf:.7f}, fp32 xla {lx:.7f}, float64 xla "
        f"{l64:.12f}; peak {peak:.3f} GiB in float64; {smi}")
    check = group_rel(g_f, g_x, dfsmn_group)
    watch = max(check, key=check.get)
    witness_line(phase, "phase 17's check: fp32 flash vs fp32 xla", check)
    rf = witness_line(phase, "fp32 flash vs float64 xla",
                      group_rel(g_f, g64, dfsmn_group), watch)
    rx = witness_line(phase, "fp32 xla vs float64 xla",
                      group_rel(g_x, g64, dfsmn_group), watch)
    log(f"{phase}: the larger distance from float64 is "
        f"{'flash' if rf > rx else 'xla'}'s ({max(rf, rx):.3e} against "
        f"{min(rf, rx):.3e}); took {time.perf_counter() - t0:.1f} s")
    del g_f, g_x, g64, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 17. DFSMN and dense conformer training: K3 at (64, 64), the steps, the
#     CLI with BMUF and sMBR
# ---------------------------------------------------------------------------

FLASH_MEM_BWD_NAMES = {"float32": "flash_attn_mem_bwd[float32]",
                       "bfloat16": "flash_attn_mem_bwd[bfloat16]"}
# the K3 (64, 64) timings: the training batch (the kernels line's row),
# phase 13's 2048- and 6144-frame requests
FLASH_MEM_BWD_TIME = ((4, 1000), (1, 2048), (1, 6144))
# the CLI runs' DFSMN-MoE depth, (num_block, fsmn_each_block) of the main
# net and of the embed sub-net: at the full 3 x 10 a checkpoint with Adam
# moments is about 12 GiB, and the three runs would write past the 45 GiB
# a chip call may
DT_CLI_DEPTH = (1, 4)
DT_CLI_FRAMES = (1000, 960, 880, 800, 990, 720, 505, 310)  # 2 steps of 4
DT_CLI_CV = (900, 600)
DT_CLI_SYNC = 2                 # --sync_period of the BMUF run
DT_SMBR_FRAMES = (1000, 960, 880, 800)     # one sMBR batch of 4
SMBR_TOOL = '''import sys
import numpy as np
from m3asr_tpu_torch.io.kaldi_io import ArkWriter, read_ark
# d(loss)/d(logits) of sum_t [logsumexp(l_t) - l_t[t % V]]
post, grad = sys.argv[1:3]
with ArkWriter(grad) as w:
    for key, m in read_ark(post):
        m = m.astype(np.float64)
        e = np.exp(m - m.max(-1, keepdims=True))
        g = e / e.sum(-1, keepdims=True)
        g[np.arange(len(g)), np.arange(len(g)) % g.shape[1]] -= 1.0
        w.write(key, g.astype(np.float32))
'''


def dfsmn_group(path):
    """The group of a DFSMN or dense conformer parameter path in the
    gradient comparisons: its cFSMN layer ("blocks_sw/1/fsmn_layers/3"),
    its attention layer ("embed/blocks/2/attn_layer"), its conformer
    sublayer (param_group), or its module ("out_linear")."""
    parts = path.split("/")
    for name, extra in (("fsmn_layers", 2), ("attn_layer", 1)):
        if name in parts:
            return "/".join(parts[:parts.index(name) + extra])
    return param_group(path) if "blocks" in parts else "/".join(parts[:-1])


def k3_mem_case(torch, B, T, masks, dtype, gen):
    """The backward's inputs of one flash_attn_mem check (phase 13's q, k,
    v of a DFSMN attention layer with mixed lengths and the 16-frame
    window, g random) and K2's out and LSE for them."""
    from m3asr_tpu_torch.ops import flash_attention as fa
    p = flash_mem_params(torch, dtype, gen)
    lens, mask = flash_mem_case(torch, B, T, masks, gen)
    x = torch.randn(B, T, D, generator=gen, device="cuda").to(dtype)
    q, k, v, klens, window, mem = fa.attn_mem_inputs(
        p, x, lens, DFSMN_HEADS, DFSMN_SLOTS, mask)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    scale = (D // DFSMN_HEADS) ** -0.5
    out, lse = fa.flash_kernels.forward(q, k, v, klens, scale, window, mem,
                                        return_lse=True)
    delta = (g.float() * out.float()).sum(-1, keepdim=True)
    return q, k, v, g, lse, delta, lens, klens, window, mem, scale


def phase_kernel_flash_mem_bwd(torch):
    """K3 at the DFSMN width (D2, Dk) = (64, 64) against its plain version
    on the same inputs, from K2's LSE: B=1, T=2048 and 6144 and B=4,
    T=1000 (S = T + 64), fp32 and bf16, mixed lengths and the 16-frame
    chunk window shifted by 64 with mem_cols=64, at the wrapper's tile
    heights. dq on the valid query rows, dk and dv on the valid keys,
    each max|diff| / max|ref| within flash_mem_tol; two calls bit-equal.
    Returns the worst max_abs_err per name."""
    from m3asr_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(17)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        for B, T in FLASH_MEM_SHAPES:
            for masks in ("lengths", "window"):
                q, k, v, g, lse, delta, lens, klens, window, mem, scale = \
                    k3_mem_case(torch, B, T, masks, dtype, gen)
                got = fa.flash_kernels.backward(q, k, v, g, lse, delta,
                                                klens, scale, window, mem)
                again = fa.flash_kernels.backward(q, k, v, g, lse, delta,
                                                  klens, scale, window, mem)
                torch.cuda.synchronize()
                ref = fa.flash_attention_bwd_reference(
                    q, k, v, g, lse, delta, klens, scale, window, mem)
                S = k.shape[2]
                rows = (torch.arange(T, device="cuda")[None]
                        < lens[:, None])[:, None, :, None]
                keys = (torch.arange(S, device="cuda")[None]
                        < klens[:, None])[:, None, :, None]
                errs, rels = [], []
                for a, r, valid in zip(got, ref, (rows, keys, keys)):
                    e = ((a.float() - r.float()).abs() * valid).max().item()
                    errs.append(e)
                    rels.append(e / (r.float().abs() * valid).max().item())
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                tol = flash_mem_tol(dname, S)
                ok = max(rels) <= tol and same and np.isfinite(errs).all()
                log(f"kernel {FLASH_MEM_BWD_NAMES[dname]} B={B} T={T} S={S}"
                    f" {masks} lens={lens.tolist()} rows "
                    f"{fa.launch_rows(q, k)[1]}: max|diff|/max|ref| dq "
                    f"{rels[0]:.3e}, dk {rels[1]:.3e}, dv {rels[2]:.3e} "
                    f"(held to {tol:.3e}), two calls bit-equal {same} "
                    f"{'OK' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"FAIL kernel: {FLASH_MEM_BWD_NAMES[dname]}"
                                     " disagrees with its plain version")
                key = FLASH_MEM_BWD_NAMES[dname]
                worst[key] = max(worst.get(key, 0.0), max(errs))
                del got, again, ref
        torch.cuda.empty_cache()
    return worst


def time_flash_mem_bwd(torch, smi):
    """K3 at (64, 64) on the memory-slot layout at FLASH_MEM_BWD_TIME (the
    training batch with TRAIN_LENS, the two requests with every frame
    valid), fp32 and bf16: the wrapper call, its two CUDA launches alone,
    the plain version, scaled_dot_product_attention's backward with a
    boolean key mask on the same q, k, v and g (autograd), and the bound
    (q, k, v, g, LSE, delta read once, dq, dk, dv written once; the
    scores, dp, dv, dq and dk products over the valid pairs); at the
    training batch also the device time of the call and of SDPA's
    backward in turns. Returns the rows at the training batch by name."""
    import torch.nn.functional as F
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(18)
    lib = kernels.FLASH.load()
    stream = torch.cuda.current_stream().cuda_stream
    M, dk = DFSMN_SLOTS, D // DFSMN_HEADS
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        code = 0 if dtype == torch.float32 else 1
        p = flash_mem_params(torch, dtype, gen)
        for B, T in FLASH_MEM_BWD_TIME:
            S = T + M
            valid = TRAIN_LENS if B == 4 else (T,)
            lens = torch.tensor(valid, dtype=torch.int32, device="cuda")
            x = torch.randn(B, T, D, generator=gen, device="cuda").to(dtype)
            q, k, v, klens, _, _ = fa.attn_mem_inputs(p, x, lens,
                                                      DFSMN_HEADS, M)
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            scale = dk ** -0.5
            out, lse = fa.flash_kernels.forward(q, k, v, klens, scale,
                                                return_lse=True)
            delta = (g.float() * out.float()).sum(-1, keepdim=True)
            dq, dkk, dv = (torch.empty_like(t) for t in (q, k, v))
            b_rows = fa.launch_rows(q, k)[1]
            args = (code, dk, dk, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    klens.data_ptr(), None, None, 0, B, DFSMN_HEADS, T, S,
                    scale)

            def raw(i):
                if lib.flash_bwd_dq(*args, b_rows[0], dq.data_ptr(),
                                    stream) or \
                        lib.flash_bwd_dkv(*args, b_rows[1], dkk.data_ptr(),
                                          dv.data_ptr(), stream):
                    raise SystemExit("FAIL times: flash_bwd launch error")

            def kernel():
                return fa.flash_kernels.backward(q, k, v, g, lse, delta,
                                                 klens, scale)
            key_mask = (torch.arange(S, device="cuda")[None, :]
                        < klens[:, None])[:, None, None, :]
            ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl,
                                                     attn_mask=key_mask,
                                                     scale=scale)

            def sdpa_bwd():
                return torch.autograd.grad(lib_out, (ql, kl, vl), g,
                                           retain_graph=True)
            iters = 20 if T < 6000 else 5
            ms = cuda_time_ms(torch, lambda i: kernel(), iters)
            alone = cuda_time_ms(torch, raw, iters)
            plain_ms = cuda_time_ms(torch, lambda i: (
                fa.flash_attention_bwd_reference(q, k, v, g, lse, delta,
                                                 klens, scale)), 2)
            lib_ms = cuda_time_ms(torch, lambda i: sdpa_bwd(), iters)
            elt = x.element_size()
            pairs = DFSMN_HEADS * sum(n * (n + M) for n in valid)
            t_bytes = (elt * B * DFSMN_HEADS * dk * (3 * T + 4 * S)
                       + 8 * B * DFSMN_HEADS * T + 4 * B) \
                / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * pairs * 5 * dk / PEAK_OPS_PER_S[dname] * 1e3
            bound = max(t_bytes, t_ops)
            dev = ""
            if B == 4:
                rows[FLASH_MEM_BWD_NAMES[dname]] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=lib_ms)
                dev = "; device {:.4f} ms ({:.4f}-{:.4f}), SDPA backward " \
                      "{:.4f} ms ({:.4f}-{:.4f}) in turns".format(
                          *(x for t in paired_device_ms(
                              torch, kernel, sdpa_bwd) for x in t))
            log(f"time {FLASH_MEM_BWD_NAMES[dname]} B={B} T={T} S={S} rows "
                f"{b_rows}: call {ms:.4f} ms (launches alone {alone:.4f} "
                f"ms), plain {plain_ms:.4f} ms, scaled_dot_product_attention"
                f" backward {lib_ms:.4f} ms, bound {bound:.4f} ms (bytes "
                f"{t_bytes:.4f} / ops {t_ops:.4f}){dev}; {smi}")
            del lib_out, ql, kl, vl
    torch.cuda.empty_cache()
    return rows


def count_flash(flash_kernels):
    return (flash_kernels.fwd_launches, flash_kernels.dq_launches,
            flash_kernels.dkv_launches)


def flash_vs_xla(torch, label, cfg, params, batch, want, tcfg_kw,
                 heads=None, moe=True, generator_seed=None):
    """The fp32 loss and gradients with attn_impl flash against xla on the
    same parameters and batch, the xla run's tokens sent to the flash
    run's experts (moe): the loss within 1e-5 relative, every group
    (dfsmn_group) within TRAIN_GRAD_TOL of its max|g|; the flash run's
    launches (K2, K3 dq, K3 dkv) must be ``want``. Returns (loss, flash
    gradients, the flash run's routing)."""
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    from m3asr_tpu_torch.train import step as ts
    extra = {} if heads is None else dict(domain_targets=heads[0],
                                          acc_targets=heads[1])

    def run(attn_impl, replay=None):
        gen = (None if generator_seed is None
               else torch.Generator().manual_seed(generator_seed))
        with GateRecorder(moe_mod, replay=replay) as rec:
            (loss, _), g = ts.value_and_grad(
                params, cfg, ts.TrainConfig(attn_impl=attn_impl, **tcfg_kw),
                *batch, generator=gen, **extra)
        return loss.item(), g, rec.calls

    reset_flash(flash_kernels)
    loss_f, g_f, calls = run("flash")
    torch.cuda.synchronize()
    got = count_flash(flash_kernels)
    loss_x, g_x, _ = run("xla", replay=calls if moe else None)
    finite = np.isfinite(loss_f) and all(
        bool(torch.isfinite(v).all()) for v in g_f.values())
    held_grads(f"{label} fp32 flash vs xla{' (routing pinned)' if moe else ''}"
               f"; flash launches (K2, K3 dq, K3 dkv) {got}, want {want}",
               loss_f, loss_x, group_rel(g_f, g_x, dfsmn_group),
               phase="train_dfsmn")
    if got != want or not finite:
        raise SystemExit(f"FAIL train_dfsmn {label}: launches {got}, want "
                         f"{want}; finite {finite}")
    del g_x
    return loss_f, g_f, calls


def step_times(torch, label, cfg, params, batch, n_attn, smi,
               generator_seed=None, **tcfg_kw):
    """Three CTC steps (make_train_step, fp32 flash, Adam) from the same
    parameters on the 4 x 1000 batch, and a fourth under torch.profiler:
    wall times, device time and busy share, peak memory; K2 and each K3
    kernel must launch ``n_attn`` times a step. Returns the four steps'
    launches (K2, K3)."""
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    from m3asr_tpu_torch.train import step as ts
    tcfg = ts.TrainConfig(attn_impl="flash", warmup_steps=1000, **tcfg_kw)
    opt = ts.make_optimizer(tcfg)
    state = ts.init_opt_state(opt, params)
    step = ts.make_train_step(cfg, tcfg, opt, device="cuda")

    def run():
        kw = {} if generator_seed is None else {
            "generator": torch.Generator().manual_seed(generator_seed)}
        return step(params, state, *batch, **kw)
    reset_flash(flash_kernels)
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        losses.append(out[2]["loss"].item())
        ms.append((time.perf_counter() - t0) * 1e3)
        del out
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dev_ms = profiled_ms(torch, run, 1, warmup=0)
    got = count_flash(flash_kernels)
    frames = int(batch[1].sum())
    log(f"train_dfsmn {label} step (fp32 flash, Adam, 4 x 1000 "
        f"frames): losses {[round(v, 4) for v in losses]}; wall ms "
        f"{[round(v, 3) for v in ms]} (median {float(np.median(ms)):.3f}, "
        f"{frames / np.median(ms) * 1e3:.0f} frames/s); device time "
        f"{dev_ms:.3f} ms under torch.profiler, busy "
        f"{dev_ms / np.median(ms):.3f} of the median step; peak memory "
        f"{peak:.3f} GiB; launches (K2, K3 dq, K3 dkv) {got}; {smi}")
    if not np.all(np.isfinite(losses)) or got != (4 * n_attn,) * 3:
        raise SystemExit(f"FAIL train_dfsmn {label} steps: losses {losses}"
                         f", launches {got}, want {4 * n_attn} each")
    return got[0], got[1]


def dfsmn_train_checks(torch, smi):
    """(b) the DFSMN-MoE steps at the reference Net's widths and depth,
    (c) dfsmn_san_res_embed_domain_acc with its heads. Returns the flash
    launches {(kernel, dtype): n}."""
    from m3asr_tpu_torch.config import model_config_from_dict
    from m3asr_tpu_torch.models.registry import (dfsmn_embed_config,
                                                 get_family)
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    from m3asr_tpu_torch.train import step as ts
    launches = {}

    def add(kname, dname, n):
        launches[(kname, dname)] = launches.get((kname, dname), 0) + n

    cfg = model_config_from_dict(dfsmn_raw(each=DFSMN_NET_EACH))
    params = get_family(DFSMN_MOE).init(
        cfg, torch.Generator(device="cuda").manual_seed(17))
    e = cfg.encoder_conf
    n_attn = e.num_block + dfsmn_embed_config(e).num_block
    batch = train_batch(torch, cfg)
    # (b) CTC, embed CTC weight 0.3: every attention layer trains
    want = (n_attn,) * 3
    loss32, _, calls = flash_vs_xla(
        torch, f"{DFSMN_MOE} CTC", cfg, params, batch, want,
        dict(embed_ctc_weight=0.3))
    for kname, n in (("K2", n_attn), ("K3", n_attn)):
        add(kname, "float32", n)
    reset_flash(flash_kernels)
    with GateRecorder(moe_mod, replay=calls):
        (loss_b, _), g_b = ts.value_and_grad(
            params, cfg, ts.TrainConfig(attn_impl="flash",
                                        compute_dtype="bfloat16",
                                        embed_ctc_weight=0.3), *batch)
    got = count_flash(flash_kernels)
    rel = abs(loss_b.item() - loss32) / abs(loss32)
    finite = all(bool(torch.isfinite(v).all()) for v in g_b.values())
    ok = rel <= 2e-2 and got == want and finite
    log(f"train_dfsmn {DFSMN_MOE} bf16-compute flash (routing pinned): loss "
        f"{loss_b.item():.6f} vs fp32 {loss32:.6f}: rel {rel:.3e}, held to "
        f"2e-2; gradients finite {finite}; launches (K2, K3 dq, K3 dkv) "
        f"{got}, want {want} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL train_dfsmn: the bf16 DFSMN step is off")
    del g_b
    add("K2", "bfloat16", n_attn)
    add("K3", "bfloat16", n_attn)
    # the CE step (alignment labels, no embed CTC: the embed sub-net's
    # attention runs forward only)
    rng = np.random.default_rng(17)
    align = torch.from_numpy(rng.integers(
        0, cfg.output_dim, (len(TRAIN_LENS), max(TRAIN_LENS)))
        .astype(np.int32)).cuda()
    ce_batch = batch[:2] + (align, batch[1])
    flash_vs_xla(torch, f"{DFSMN_MOE} CE", cfg, params, ce_batch,
                 (n_attn, e.num_block, e.num_block), dict(loss_type="ce"))
    add("K2", "float32", n_attn)
    add("K3", "float32", e.num_block)
    torch.cuda.empty_cache()
    k2, k3 = step_times(torch, DFSMN_MOE, cfg, params, batch, n_attn, smi,
                        embed_ctc_weight=0.3)
    add("K2", "float32", k2)
    add("K3", "float32", k3)
    del params
    torch.cuda.empty_cache()
    # (c) the in-model domain/accent heads
    proto = "dfsmn_san_res_embed_domain_acc"
    cfg = model_config_from_dict(dfsmn_raw(proto, each=DFSMN_NET_EACH))
    params = get_family(proto).init(
        cfg, torch.Generator(device="cuda").manual_seed(18))
    heads = (torch.tensor([0, 3, 5, 2], dtype=torch.int32, device="cuda"),
             torch.tensor([7, 1, 4, 0], dtype=torch.int32, device="cuda"))
    n = cfg.encoder_conf.num_block
    _, g, _ = flash_vs_xla(torch, f"{proto} heads", cfg, params, batch,
                           (n, n, n), dict(ce_weight=0.5), heads=heads,
                           moe=False)
    zero = [k for k in g if k.startswith("out_linear_") and not g[k].any()]
    log(f"train_dfsmn {proto}: heads' leaves with a zero gradient {zero}")
    if zero:
        raise SystemExit(f"FAIL train_dfsmn: {zero} get no gradient")
    add("K2", "float32", n)
    add("K3", "float32", n)
    del params, g
    torch.cuda.empty_cache()
    return launches


def dense_train_check(torch, smi):
    """(d) the dense conformer's CTC step at the flagship encoder's widths
    with dynamic chunks (the generator seeded alike for both runs; a seed
    that draws a chunk shorter than the utterance): flash against xla, and
    three steps timed. Returns the flash launches (K2, K3)."""
    from m3asr_tpu_torch.config import model_config_from_dict
    from m3asr_tpu_torch.models.registry import get_family
    from m3asr_tpu_torch.train import step as ts
    raw = conformer_raw(DC_NET_BLOCKS)
    raw["model_conf"]["use_dynamic_chunk"] = True
    cfg = model_config_from_dict(raw)
    params = get_family("conformer").init(
        cfg, torch.Generator(device="cuda").manual_seed(19))
    batch = train_batch(torch, cfg)
    T_sub = None
    for seed in range(20):
        mask = ts.train_chunk_mask(cfg.encoder_conf, batch[0], batch[1],
                                   torch.Generator().manual_seed(seed))
        chunk = int(mask[0, 0, 0].sum())   # row 0 sees its first chunk
        T_sub = mask.shape[-1]
        if chunk < T_sub:
            break
    n = DC_NET_BLOCKS
    flash_vs_xla(torch, f"conformer CTC (dynamic chunk {chunk} of {T_sub} "
                 f"frames)", cfg, params, batch, (n, n, n),
                 dict(embed_ctc_weight=0.0), moe=False, generator_seed=seed)
    k2, k3 = step_times(torch, "conformer", cfg, params, batch, n, smi,
                        generator_seed=seed)
    del params
    torch.cuda.empty_cache()
    return n + k2, n + k3


def dfsmn_cli_inputs(work, cfg):
    """The DFSMN CLI runs' inputs under ``work``: tr.ark / cv.ark (40-dim
    features), frame-level alignment arks (CE labels, one a frame), and
    dfsmn.yaml: the DFSMN-MoE YAML cut to DT_CLI_DEPTH (widths kept), CE
    mode, batch 4, log_period 1, save_period an epoch, flash attention,
    block momentum 0.5 and block LR 0.9 for BMUF."""
    import yaml
    from m3asr_tpu_torch.io.kaldi_io import ArkWriter
    rng = np.random.default_rng(20)
    for name, frames in (("tr", DT_CLI_FRAMES), ("cv", DT_CLI_CV)):
        keys = [f"{name}{i}" for i in range(len(frames))]
        with ArkWriter(os.path.join(work, f"{name}.ark")) as w:
            for k, T in zip(keys, frames):
                w.write(k, rng.standard_normal((T, cfg.input_dim))
                        .astype(np.float32))
        write_int_vectors(os.path.join(work, f"{name}_ali.ark"), {
            k: rng.integers(0, cfg.output_dim, T)
            for k, T in zip(keys, frames)})
    raw = dfsmn_raw()
    nb, each = DT_CLI_DEPTH
    raw["model_conf"].update(num_block=nb, fsmn_each_block=each)
    raw["model_conf"]["embed_conf"].update(num_block=nb, fsmn_each_block=each)
    raw.update(loader_conf={"batch_size": 4, "mode": "ce"}, log_period=1,
               save_period=len(DT_CLI_FRAMES) // 4, attn_impl="flash",
               bmuf_conf={"block_momentum": 0.5, "block_lr": 0.9})
    with open(os.path.join(work, "dfsmn.yaml"), "w") as f:
        yaml.safe_dump(raw, f)


def dfsmn_cli_argv(work, out, epochs, *extra):
    a = lambda name: os.path.join(work, name)       # noqa: E731
    return ["--config", a("dfsmn.yaml"), "--output_dir", out,
            "--tr_rspecifier", a("tr.ark"), "--tr_labels", a("tr_ali.ark"),
            "--cv_rspecifier", a("cv.ark"), "--cv_labels", a("cv_ali.ark"),
            "--max_epochs", str(epochs)] + list(extra)


class BmufSpy:
    """Recomputes each BMUF sync on the host: from the recipe's global
    parameters and block momentum buffer and the replicas' local trees
    (copied to the host before the sync), the new global parameters in
    float32 numpy; records the largest distance of the synced replicas
    from them, relative to each leaf's largest value."""

    def __init__(self):
        from m3asr_tpu_torch.train import bmuf
        self.bmuf, self.worst, self.syncs = bmuf, 0.0, 0

    def __enter__(self):
        from m3asr_tpu_torch.checkpoint import flatten_tree
        spy, real = self, self.bmuf.BmufRecipe.sync
        self.real = real

        def host(tree):
            return {k: v.detach().cpu().numpy()
                    for k, v in flatten_tree(tree).items()}

        def sync(recipe, stacked):
            glob, prev = (host(recipe.state.global_params),
                          host(recipe.state.delta_prev))
            local = host(stacked)
            new, ok = real(recipe, stacked)
            m, blr = recipe.block_momentum, recipe.block_lr
            got = host(new)
            for k, g in glob.items():
                delta = g - local[k].mean(0)
                dp = m * prev[k] + blr * (1.0 - m) * delta
                want = g - (1.0 + m) * dp
                top = max(float(np.abs(want).max()), 1e-30)
                for r in range(got[k].shape[0]):
                    spy.worst = max(spy.worst, float(
                        np.abs(got[k][r] - want).max()) / top)
            spy.syncs += 1
            return new, ok
        self.bmuf.BmufRecipe.sync = sync
        return self

    def __exit__(self, *exc):
        self.bmuf.BmufRecipe.sync = self.real


def dfsmn_cli_run(torch, argv, label, want, smi):
    """One in-process run of the training CLI on the DFSMN YAML: its
    K2/K3 launches must be ``want`` and its logged losses finite.
    Returns (trainer, spy)."""
    import contextlib
    import io
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    from m3asr_tpu_torch.train import cli
    reset_flash(flash_kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TrainCliSpy(torch, "make_train_step") as spy, \
            contextlib.redirect_stdout(io.StringIO()):
        trainer = cli.main(argv)
    secs = time.perf_counter() - t0
    got = count_flash(flash_kernels)
    out = argv[argv.index("--output_dir") + 1]
    with open(os.path.join(out, "scalars", "scalars.jsonl")) as f:
        losses = [json.loads(line)["value"] for line in f
                  if '"train/loss"' in line]
    log(f"train_dfsmn cli {label}: {len(spy.step_ms)} steps to global step "
        f"{trainer.global_step}, {secs:.1f} s; losses "
        f"{[round(v, 5) for v in losses]}; step ms "
        f"{[round(v, 3) for v in spy.step_ms]}; checkpoints (tag, s, GiB) "
        f"{[(t, round(s, 2), round(g, 3)) for t, s, g in spy.saves]}; "
        f"launches (K2, K3 dq, K3 dkv) {got}, want {want}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; {smi}")
    if got != want or not losses or not np.all(np.isfinite(losses)):
        raise SystemExit(f"FAIL train_dfsmn cli {label}: launches {got}, "
                         f"want {want}; losses {losses}")
    return trainer, spy


def smbr_cli_check(torch, work, smi):
    """The --smbr_cmd run on the dense conformer at the flagship encoder's
    widths: one batch of 4 utterances, SGD at a constant LR, the lattice
    command a Python script (SMBR_TOOL) whose gradient is that of
    sum_t [logsumexp(l_t) - l_t[t % V]] over each utterance's frames.
    smbr_epoch0.pkl must equal the update of autograd's gradient of that
    surrogate on the same batch from the same seeded init, within rtol
    1e-4 of each leaf's largest value."""
    import contextlib
    import io
    import pickle
    import sys as _sys
    import yaml
    from m3asr_tpu_torch.checkpoint import flatten_tree
    from m3asr_tpu_torch.config import model_config_from_dict
    from m3asr_tpu_torch.io.kaldi_io import ArkWriter
    from m3asr_tpu_torch.io.loader import DataLoader
    from m3asr_tpu_torch.models.registry import get_family
    from m3asr_tpu_torch.train import cli
    from m3asr_tpu_torch.train.lr_scheduler import build_optimizer
    rng = np.random.default_rng(21)
    keys = [f"s{i}" for i in range(len(DT_SMBR_FRAMES))]
    with ArkWriter(os.path.join(work, "s.ark")) as w:
        for k, T in zip(keys, DT_SMBR_FRAMES):
            w.write(k, rng.standard_normal((T, 40)).astype(np.float32))
    write_int_vectors(os.path.join(work, "s_ctc.ark"),
                      {k: rng.integers(1, 4999, T // 40)
                       for k, T in zip(keys, DT_SMBR_FRAMES)})
    with open(os.path.join(work, "s_trans.txt"), "w") as f:
        f.writelines(f"{k} word{i}\n" for i, k in enumerate(keys))
    with open(os.path.join(work, "tool.py"), "w") as f:
        f.write(SMBR_TOOL)
    raw = conformer_raw(DC_NET_BLOCKS)
    raw.update(loader_conf={"batch_size": 4}, optim="sgd",
               schedule_type="constant", lr=1e-3, max_epoch=1, log_period=1)
    with open(os.path.join(work, "smbr.yaml"), "w") as f:
        yaml.safe_dump(raw, f)
    out = os.path.join(work, "smbr")
    old_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = HERE + (os.pathsep + old_path if old_path
                                       else "")
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _, _, n = cli.main([
                "--config", os.path.join(work, "smbr.yaml"),
                "--output_dir", out,
                "--tr_rspecifier", os.path.join(work, "s.ark"),
                "--tr_labels", os.path.join(work, "s_ctc.ark"),
                "--tr_trans_file", os.path.join(work, "s_trans.txt"),
                "--smbr_cmd", f"{_sys.executable} "
                f"{os.path.join(work, 'tool.py')} {{post}} {{grad}} "
                "{trans}"])
    finally:
        if old_path is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = old_path
    secs = time.perf_counter() - t0
    with open(os.path.join(out, "smbr_epoch0.pkl"), "rb") as f:
        saved = flatten_tree(pickle.load(f))
    # the surrogate's autograd step from the CLI's seeded init
    cfg = model_config_from_dict(raw)
    fam = get_family("conformer")
    params = fam.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = next(DataLoader(os.path.join(work, "s.ark"),
                            os.path.join(work, "s_ctc.ark"), training=True,
                            loader_conf=dict(raw["loader_conf"],
                                             drop_last=True))())
    flat = flatten_tree(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()
              if v.is_floating_point()}
    from m3asr_tpu_torch.checkpoint import unflatten_tree
    logits, out_len = fam.forward(unflatten_tree({**flat, **leaves}), cfg,
                                  torch.from_numpy(batch["data"]).cuda(),
                                  torch.from_numpy(batch["lens"]).cuda())
    T, V = logits.shape[1], logits.shape[2]
    t = torch.arange(T, device="cuda")
    valid = (t[None] < out_len[:, None]).float()
    lp = torch.log_softmax(logits.float(), -1)
    pick = lp.gather(-1, (t % V)[None, :, None].expand(logits.shape[0], -1,
                                                      1))[..., 0]
    loss = -(pick * valid).sum()
    names = list(leaves)
    grads = dict(zip(names, torch.autograd.grad(
        loss, [leaves[k] for k in names])))
    opt = build_optimizer("constant", None, 1e-3, optim_type="sgd",
                          max_grad_norm=raw.get("max_grad_norm", 5.0))
    cur = {k: flat[k] for k in grads}
    upd, _ = opt.update(grads, opt.init(cur), cur)
    want = {k: v.detach().cpu().numpy()
            for k, v in opt.apply_updates(cur, upd).items()}
    worst, moved = 0.0, 0.0
    for k, v in want.items():
        top = max(float(np.abs(v).max()), 1e-3)
        worst = max(worst, float(np.abs(saved[k] - v).max()) / top)
        moved = max(moved, float(np.abs(saved[k] - flat[k].cpu().numpy())
                                 .max()))
    ok = n == 1 and worst <= 1e-4 and moved > 0
    log(f"train_dfsmn cli smbr (conformer, {DC_NET_BLOCKS} blocks, lattice "
        f"command a script): {n} batch in {secs:.1f} s; smbr_epoch0.pkl "
        f"against the surrogate's autograd step: largest max|diff| / "
        f"max|param| of a leaf {worst:.3e}, held to 1e-4; largest move "
        f"{moved:.3e} {'OK' if ok else 'FAIL'}; {smi}")
    if not ok:
        raise SystemExit("FAIL train_dfsmn cli smbr")


def dfsmn_cli_checks(torch, smi):
    """(e) the CLI: the cut DFSMN-MoE in CE mode run and resumed, a BMUF
    run, an sMBR run; checkpoints under TMPDIR. Returns the K2 and K3
    launches of the runs."""
    import pickle
    import shutil
    import tempfile
    from m3asr_tpu_torch.checkpoint import flatten_tree
    from m3asr_tpu_torch.config import model_config_from_dict
    cfg = model_config_from_dict(dfsmn_raw())
    work = tempfile.mkdtemp(prefix="train_dfsmn_")
    steps = len(DT_CLI_FRAMES) // 4
    nb = DT_CLI_DEPTH[0]
    # K2: the main net's and the embed sub-net's attention in each step
    # and validation forward; K3: the main net's (no embed CTC in CE mode)
    per_epoch = ((steps + 1) * 2 * nb, steps * nb, steps * nb)
    k2 = k3 = 0
    try:
        dfsmn_cli_inputs(work, cfg)
        out = os.path.join(work, "exp")
        t1, _ = dfsmn_cli_run(torch, dfsmn_cli_argv(work, out, 1), "CE run",
                              per_epoch, smi)
        del t1
        with open(os.path.join(out, "checkpoint_last.pkl"), "rb") as f:
            last = flatten_tree(pickle.load(f)["params"])
        _, spy = dfsmn_cli_run(torch, dfsmn_cli_argv(work, out, 2,
                                                     "--resume"),
                               "CE resume", per_epoch, smi)
        step0, loaded = spy.loaded
        same = sorted(loaded) == sorted(last) and all(
            np.array_equal(loaded[k].numpy(), v) for k, v in last.items())
        log(f"train_dfsmn cli resume: started at global step {step0} from "
            f"{len(loaded)} tensors {'bit-equal' if same else 'NOT equal'} "
            f"to run 1's checkpoint_last.pkl")
        if step0 != steps or not same:
            raise SystemExit("FAIL train_dfsmn cli resume")
        del last, loaded, spy
        k2, k3 = 2 * per_epoch[0], 2 * per_epoch[1]
        shutil.rmtree(out)
        with BmufSpy() as bspy:
            tb, _ = dfsmn_cli_run(
                torch, dfsmn_cli_argv(work, out, 2, "--bmuf",
                                      "--sync_period", str(DT_CLI_SYNC)),
                "BMUF run", (2 * per_epoch[0], 2 * per_epoch[1],
                             2 * per_epoch[2]), smi)
        with open(os.path.join(out, "checkpoint_last.pkl"), "rb") as f:
            entry = pickle.load(f)["bmuf"]
        ok = (bspy.syncs == 2 * steps // DT_CLI_SYNC and bspy.worst <= 1e-6
              and tb.bmuf.dp == 1 and entry["sync_period"] == DT_CLI_SYNC
              and entry["block_momentum"] == 0.5)
        log(f"train_dfsmn cli BMUF: {bspy.syncs} syncs, each replica after "
            f"each against the block-momentum formula recomputed on the "
            f"host: largest max|diff| / max|global| {bspy.worst:.3e}, held "
            f"to 1e-6; checkpoint bmuf entry sync_period "
            f"{entry['sync_period']}, block_momentum "
            f"{entry['block_momentum']}, block_lr {entry['block_lr']} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("FAIL train_dfsmn cli BMUF")
        del tb, entry
        k2, k3 = k2 + 2 * per_epoch[0], k3 + 2 * per_epoch[1]
        shutil.rmtree(out)
        torch.cuda.empty_cache()
        smbr_cli_check(torch, work, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return k2, k3


def flash_mem_bwd_report(torch, state, launches, smi):
    """The kernels line's entries of K3 at (64, 64): phase 17's launches,
    the worst error of its checks, this run's times and bound."""
    rows = time_flash_mem_bwd(torch, smi)
    report = []
    for dname, name in FLASH_MEM_BWD_NAMES.items():
        n = launches[("K3mem", dname)]
        if n == 0:
            raise SystemExit(f"FAIL report: {name} never launched on the "
                             "DFSMN training path")
        r = rows[name]
        report.append({"name": name, "route": "cuda",
                       "source": "m3asr_tpu_torch/csrc/flash_attention.cu",
                       "replaces": "m3asr_tpu/ops/pallas_attention.py:377",
                       "launches": n,
                       "max_abs_err": state["max_err_mem_bwd"][name],
                       "ms": r["ms"], "plain_ms": r["plain_ms"],
                       "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                       "library_ms": r["library_ms"]})
    return report


def phase_train_dfsmn(torch, state, smi):
    """Phase 17: K3 at (64, 64) against its plain version, the DFSMN and
    dense conformer training steps, the CLI with BMUF and sMBR. Returns
    the launches {(kernel, dtype): n} of K2 at (64, 64), K3 at (64, 64)
    ("K3mem") and the dense conformer's K2 / K3, and keeps the K3 (64, 64)
    checks' worst errors in state["max_err_mem_bwd"]."""
    t0 = time.perf_counter()
    state["max_err_mem_bwd"] = phase_kernel_flash_mem_bwd(torch)
    log(f"train_dfsmn: (a) K3 (64, 64) checks done at "
        f"{time.perf_counter() - t0:.1f} s")
    mem = dfsmn_train_checks(torch, smi)
    log(f"train_dfsmn: (b), (c) done at {time.perf_counter() - t0:.1f} s")
    dense = dense_train_check(torch, smi)
    cli_k2, cli_k3 = dfsmn_cli_checks(torch, smi)
    launches = {("K2mem", "float32"): mem[("K2", "float32")] + cli_k2,
                ("K2mem", "bfloat16"): mem[("K2", "bfloat16")],
                ("K3mem", "float32"): mem[("K3", "float32")] + cli_k3,
                ("K3mem", "bfloat16"): mem[("K3", "bfloat16")],
                ("K2", "float32"): dense[0], ("K3", "float32"): dense[1]}
    log(f"train_dfsmn: phase 17 took {time.perf_counter() - t0:.1f} s; "
        f"launches {launches}; {smi}")
    return launches


# phases that run on their own after the build, for work on one of them:
# ---------------------------------------------------------------------------
# 18. expert- and tensor-parallel serving on gloo ranks sharing the card
# ---------------------------------------------------------------------------

PAR_REQUESTS = ((1, 206), (4, 1000))
PAR_LENS = {1: (206,), 4: (1000, 937, 811, 650)}
PAR_BUCKETS = "1x256,4x1024"
# build flags of a mode -> its cases (label, ep, tp)
PAR_MODES = (
    ("fp32", ["--moe_impl", "dense"],
     (("fp32 ep4", 4, 1), ("fp32 tp4", 1, 4), ("fp32 ep2 tp2", 2, 2))),
    ("bf16 flash", ["-f", "--attn_impl", "flash", "--moe_impl", "dense"],
     (("bf16 flash ep4", 4, 1),)),
    ("int8", ["--int8", "--moe_impl", "quant"], (("int8 ep2 tp2", 2, 2),)),
    ("int4", ["--int4"], (("int4 ep4", 4, 1), ("int4 tp2", 1, 2))),
)
PAR_WORLD_S = 720             # a world's run, its start included
PAR_RUNS = 3                  # timed requests a case


def par_feats():
    """The phase's two requests, seeded: {(B, T): (feat, lens)}."""
    rng = np.random.default_rng(18)
    return {(B, T): (rng.standard_normal((B, T, 40)).astype(np.float32),
                     np.array(PAR_LENS[B], np.int32))
            for B, T in PAR_REQUESTS}


def par_rank(work):
    """One rank of a phase-18 world (``chip_smoke.py --parallel-rank
    WORK``, under torch.distributed.run): every case of
    ``cases_{world}.json`` loaded from its engine dir and served; writes
    ``rank_{world}_{rank}.json`` (times, memory, K2 launches, the
    all-reduces' share, a hash of each output) and, on rank 0, the
    logits and each MoE block's experts (``out_*.npz``)."""
    t_start = time.perf_counter()
    import contextlib
    import hashlib
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    from m3asr_tpu_torch.parallel import distributed
    from m3asr_tpu_torch.runtime.engine import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_imported = time.perf_counter()
    distributed.initialize(timeout_s=PAR_WORLD_S)
    n, rank = dist.get_world_size(), dist.get_rank()
    spans = {"imports_s": t_imported - t_start,
             "init_s": time.perf_counter() - t_imported}
    with open(os.path.join(work, f"cases_{n}.json")) as f:
        cases = json.load(f)
    feats = par_feats()
    if rank == 0:             # the profiler's start-up, outside the times
        with profile(activities=[ProfilerActivity.CPU]):
            pass
    res = {"backend": dist.get_backend(), "cases": {}, "spans": spans}
    for case in cases:
        t0 = time.perf_counter()
        eng = Engine.load(case["dir"], device="cuda")
        r = {"load_s": time.perf_counter() - t0, "attn": eng.cfg.attn_impl,
             "impl": eng.moe_impl_for(4, 1024), "mesh": repr(eng.mesh)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash(flash_kernels)
        saved = {}
        for (B, T), (feat, lens) in feats.items():
            key = f"{B}x{T}"
            with GateRecorder(moe_mod) as rec:
                out, out_len = eng.infer(feat, lens)
            r[key] = {"sha": hashlib.sha256(out.tobytes()
                                            + out_len.tobytes()).hexdigest()}
            if rank == 0:
                saved[f"{key}_out"] = out
                for i, g in enumerate(rec.calls):
                    saved[f"{key}_gate{i}"] = g.cpu().numpy()
        r["k2"] = flash_kernels.fwd_launches
        r["forwards"] = len(feats)
        for (B, T), (feat, lens) in feats.items():
            key = f"{B}x{T}"
            lat = []
            for _ in range(PAR_RUNS):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                eng.infer(feat, lens)
                lat.append((time.perf_counter() - t1) * 1e3)
            # the all-reduces' share of one request: host-side events
            # (gloo runs them on the host), profiled on rank 0 only
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            prof = profile(activities=[ProfilerActivity.CPU]) \
                if rank == 0 else contextlib.nullcontext()
            with prof:
                eng.infer(feat, lens)
            wall = (time.perf_counter() - t1) * 1e3
            cnt, ar_ms, name = collective_union(prof) if rank == 0 \
                else (0, 0.0, "none")
            r[key].update(lat=float(np.median(lat)), lat_min=min(lat),
                          lat_max=max(lat), prof_ms=wall,
                          ar_name=name, ar_calls=cnt, ar_ms=ar_ms)
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if rank == 0:
            np.savez(os.path.join(work, f"out_{case['label']}.npz"), **saved)
        res["cases"][case["label"]] = r
        r["case_s"] = time.perf_counter() - t0
        del eng
        torch.cuda.empty_cache()
        dist.barrier()
    if n == 4 and os.path.exists(os.path.join(work, "export.wait")):
        t0 = time.perf_counter()
        res["export"] = export_rank(torch, work, rank)  # phase 18's export
        spans["export_s"] = time.perf_counter() - t0
    if n == 4 and os.path.exists(os.path.join(work, "loops.json")):
        t0 = time.perf_counter()
        res["loops"] = loop_rank(torch, work, rank)     # phase 18's loops
        spans["loops_s"] = time.perf_counter() - t0
    if os.path.exists(os.path.join(work, f"train_cases_{n}.json")):
        res["train"] = tp_rank(torch, work, n, rank)     # phase 19
    spans["rank_s"] = time.perf_counter() - t_start
    with open(os.path.join(work, f"rank_{n}_{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def par_world(n, work):
    """Run a world of n ranks of this script on the card; fail on a
    rank's non-zero exit or after PAR_WORLD_S (the world is killed)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", os.path.abspath(__file__),
           "--parallel-rank", work]
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out = proc.communicate(timeout=PAR_WORLD_S)[0]
    except subprocess.TimeoutExpired:
        import signal
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SystemExit(f"FAIL parallel: the {n}-rank world timed out "
                         f"after {PAR_WORLD_S} s")
    if proc.returncode != 0:
        log(out[-6000:])
        raise SystemExit(f"FAIL parallel: the {n}-rank world exited "
                         f"{proc.returncode}")
    return time.perf_counter() - t0


def par_engines(torch, work):
    """Each mode's unsharded engine (the reference) through the port's
    build, routers redrawn normal x 0.5 from a seeded generator, and each
    case's dir written by build's save (the mode's weights once; a case
    whose bytes equal an earlier case's links its params.npz)."""
    import yaml
    from m3asr_tpu_torch import build
    with open(os.path.join(HERE, "configs", "3m_asr_18l32e.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model_conf"]["encoder_conf"]["num_blocks"] = BUILT_MOE_BLOCKS
    path = os.path.join(work, "flagship_cut.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    engines, cases = {}, {2: [], 4: []}
    for mode, flags, mode_cases in PAR_MODES:
        eng, _, _ = build.build_engine(build.parse_args(
            ["-c", path, "-o", "unused", "--skip-warmup", "--device", "cuda",
             "--buckets", PAR_BUCKETS] + flags))
        eng.cuda_graphs = False
        gen = torch.Generator(device="cuda").manual_seed(18)
        k = eng.params["blocks"]["feed_forward"]["router"]["kernel"]
        k.copy_(torch.randn(k.shape, generator=gen, device="cuda") * 0.5)
        engines[mode] = eng
        first = None
        for label, ep, tp in mode_cases:
            d = os.path.join(work, label.replace(" ", "_"))
            if first is not None and not (mode == "int4" and tp > 1):
                os.makedirs(d)
                for name in ("params.npz", "config.yaml"):
                    os.link(os.path.join(first, name), os.path.join(d, name))
                with open(os.path.join(first, "engine.json")) as f:
                    meta = json.load(f)
                meta.update(ep=ep, tp=tp)
                with open(os.path.join(d, "engine.json"), "w") as f:
                    json.dump(meta, f)
            else:
                eng.save(d, raw_yaml=raw, shards=(ep, tp))
                first = first or d
            cases[ep * tp].append({"label": label, "dir": d, "mode": mode})
    return engines, cases


def par_held(torch, label, mode, eng, saved, feats):
    """Rank 0's logits against the unsharded engine on the card: fp32
    free-running allclose(1e-5, 1e-3); the others with the routing
    pinned to rank 0's and the expert stages on their plain versions,
    within 0.05 of max|ref| on every valid frame. Returns the worst
    distance / max|ref|."""
    from m3asr_tpu_torch.ops import moe as moe_mod
    worst = 0.0
    for (B, T), (feat, lens) in feats.items():
        key = f"{B}x{T}"
        got = saved[f"{key}_out"]
        gates = [torch.as_tensor(saved[f"{key}_gate{i}"], device="cuda")
                 for i in range(sum(k.startswith(f"{key}_gate")
                                    for k in saved))]
        with torch.inference_mode():
            if mode == "fp32":
                ref, out_len = eng.infer(feat, lens)
            else:
                with GateRecorder(moe_mod, replay=gates), \
                        PlainExperts(moe_mod):
                    ref, out_len = eng.infer(feat, lens)
        for b, L in enumerate(out_len):
            g, w = got[b, :L], ref[b, :L]
            rel = float(np.abs(g - w).max() / np.abs(w).max())
            worst = max(worst, rel)
            if mode == "fp32":
                if not np.allclose(g, w, rtol=1e-5, atol=1e-3):
                    raise SystemExit(f"FAIL parallel {label} {key} row {b}: "
                                     f"max|diff| {np.abs(g - w).max():.3e}")
            elif rel > 0.05:
                raise SystemExit(f"FAIL parallel {label} {key} row {b}: "
                                 f"{rel:.3e} of max|ref|")
    return worst


# phase 18's sharded export (in its 4-rank world, after its serving
# cases): fp32 dirs of the flagship's widths cut to EXPORT_DEPTH, one
# bucket, each written as ``build --export --ep --tp`` writes it (every
# rank's program traced in this process); label -> (build flags, ep, tp)
PAR_EXPORTS = (("export fp32 flash ep4", ["--attn_impl", "flash"], 4, 1),
               ("export fp32 ep2 tp2", [], 2, 2))
PAR_EXPORT_BUCKET = "1x256"          # PAR_REQUESTS[0]'s bucket


def export_dirs(torch, work):
    """PAR_EXPORTS' dirs through the port's build (``build_engine``, the
    routers redrawn as par_engines does, then ``save`` with every rank's
    program for cuda, each save_program timed), each dir's twin without
    exported/, an unsharded dir of the flash case's weights and buckets
    (the one-process recognizer's), and a one-utterance ark. Writes
    ``export.json``; returns ({label: the unsharded engine}, {label:
    seconds of each program's export and save})."""
    import shutil as sh
    import yaml
    from m3asr_tpu_torch import build
    from m3asr_tpu_torch.io.kaldi_io import ArkWriter
    from m3asr_tpu_torch.runtime.engine import Engine
    with open(os.path.join(HERE, "configs", "3m_asr_18l32e.yaml")) as f:
        raw = yaml.safe_load(f)
    enc = raw["model_conf"]["encoder_conf"]
    enc["embed_conf"]["num_blocks"], enc["num_blocks"] = EXPORT_DEPTH
    path = os.path.join(work, "flagship_export.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    engines, took, cases = {}, {}, []
    orig = Engine.save_program

    def timed(self, *a, **kw):
        t0 = time.perf_counter()
        out = orig(self, *a, **kw)
        took[label].append(time.perf_counter() - t0)
        return out
    for label, flags, ep, tp in PAR_EXPORTS:
        d = os.path.join(work, label.replace(" ", "_"))
        args = build.parse_args(
            ["-c", path, "-o", d, "--device", "cuda", "--buckets",
             PAR_EXPORT_BUCKET, "--moe_impl", "dense", "--export", "--ep",
             str(ep), "--tp", str(tp)] + flags)
        eng, raw_cut, _ = build.build_engine(args)
        eng.cuda_graphs = False
        gen = torch.Generator(device="cuda").manual_seed(18)
        k = eng.params["blocks"]["feed_forward"]["router"]["kernel"]
        k.copy_(torch.randn(k.shape, generator=gen, device="cuda") * 0.5)
        took[label] = []
        Engine.save_program = timed
        try:
            eng.save(d, raw_yaml=raw_cut, export_devices=("cuda",),
                     shards=(ep, tp))
        finally:
            Engine.save_program = orig
        sh.copytree(d, d + "_plain", ignore=sh.ignore_patterns("exported"))
        engines[label] = eng
        cases.append({"label": label, "dir": d, "ep": ep, "tp": tp,
                      "flash": "flash" in flags})
    flash = next(c for c in cases if c["flash"])
    one = os.path.join(work, "export_one")
    engines[flash["label"]].save(one, raw_yaml=raw)
    feat, lens = par_feats()[PAR_REQUESTS[0]]
    ark = os.path.join(work, "export.ark")
    with ArkWriter(ark) as w:
        w.write("utt0", feat[0, :lens[0]])
    spec = {"cases": cases, "ark": ark, "one": one,
            "k2_per_forward": sum(EXPORT_DEPTH)}
    with open(os.path.join(work, "export.tmp"), "w") as f:
        json.dump(spec, f)
    os.replace(os.path.join(work, "export.tmp"),
               os.path.join(work, "export.json"))
    return engines, took


def start_export(work, torch):
    """export_dirs in a thread of its own, beside the 2-rank world (the
    parent only waits on a world meanwhile): ``export.wait`` marks the
    4-rank world's ranks to wait for ``export.json`` (``export_failed``
    if the thread raised). Returns (the thread, its result dict)."""
    import threading
    open(os.path.join(work, "export.wait"), "w").close()
    out = {}

    def run():
        t0 = time.perf_counter()
        try:
            out["result"] = export_dirs(torch, work)
        except BaseException as e:
            out["error"] = e
            open(os.path.join(work, "export_failed"), "w").close()
        out["s"] = time.perf_counter() - t0
    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th, out


def export_rank(torch, work, rank):
    """Phase 18's exported dirs on this rank: each case's dir loaded (this
    rank's program) and its twin without exported/, PAR_REQUESTS[0]
    through both (bit-equal, K2 counted around the loaded program's
    call), load-and-first-call seconds of each, then PAR_RUNS timed
    requests each; then ``recognize.main`` greedy on the flash dir
    through the leader and follower loops. Rank 0 saves its answers and
    routing (``out_{label}.npz``)."""
    import hashlib
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    from m3asr_tpu_torch.runtime.engine import Engine
    t0 = time.perf_counter()
    while not os.path.exists(os.path.join(work, "export.json")):
        if os.path.exists(os.path.join(work, "export_failed")) or \
                time.perf_counter() - t0 > PAR_WORLD_S:
            raise SystemExit("FAIL parallel export: the dirs were not built")
        time.sleep(0.5)
    res = {"waited_s": time.perf_counter() - t0}
    with open(os.path.join(work, "export.json")) as f:
        spec = json.load(f)
    key = "{}x{}".format(*PAR_REQUESTS[0])
    feat, lens = par_feats()[PAR_REQUESTS[0]]
    for case in spec["cases"]:
        r, outs, engs = {}, {}, {}
        for which, d in (("loaded", case["dir"]),
                         ("traced", case["dir"] + "_plain")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engs[which] = Engine.load(d, device="cuda")
            r[f"load_s_{which}"] = time.perf_counter() - t0
            reset_flash(flash_kernels)
            with GateRecorder(moe_mod) as rec:
                outs[which] = engs[which].infer(feat, lens)[0]
            torch.cuda.synchronize()
            r[f"first_s_{which}"] = time.perf_counter() - t0
            r[f"k2_{which}"] = flash_kernels.fwd_launches
            if rank == 0 and which == "loaded":
                np.savez(os.path.join(work, f"out_{case['label']}.npz"),
                         **{f"{key}_out": outs[which]}, **{
                             f"{key}_gate{i}": g.cpu().numpy()
                             for i, g in enumerate(rec.calls)})
        for which, eng in engs.items():
            lat = []
            for _ in range(PAR_RUNS):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                eng.infer(feat, lens)
                lat.append((time.perf_counter() - t1) * 1e3)
            r[f"ms_{which}"] = float(np.median(lat))
        r["loaded"] = sorted(map(list, engs["loaded"].loaded_buckets))
        r["traced_loaded"] = sorted(engs["traced"].loaded_buckets)
        r["equal"] = bool(np.array_equal(outs["loaded"], outs["traced"]))
        r["sha"] = hashlib.sha256(outs["loaded"].tobytes()).hexdigest()
        res[case["label"]] = r
        del engs
        torch.cuda.empty_cache()
    flash = next(c for c in spec["cases"] if c["flash"])
    reset_flash(flash_kernels)
    hyps, got, eng, secs = run_recognize(torch, [
        "-p", flash["dir"], "-i", spec["ark"], "--feat_dim", "40",
        "--batch_size", "1", "-d", "greedy"])
    res["recognize"] = {"k2": flash_kernels.fwd_launches, "secs": secs,
                        "loaded": sorted(map(list, eng.loaded_buckets)),
                        "hyps": hyps, "counts": None if rank == 0 else got}
    return res


def export_report(torch, work, ranks, engines, took, smi):
    """Phase 18's sharded export held: on every rank the loaded program
    ran the bucket and answered bit for bit as its twin without
    exported/, every rank the same bits; K2 exactly EXPORT_DEPTH's layers
    a forward from the ep=4 flash programs on every rank (none from the
    xla ones); rank 0 against the unsharded engine (par_held's fp32
    rule); the recognizer on ranks (programs loaded on every rank, K2
    counted) id for id as one process on the unsharded dir. Returns the
    K2 launches of every rank (fp32)."""
    with open(os.path.join(work, "export.json")) as f:
        spec = json.load(f)
    per = spec["k2_per_forward"]
    bucket = [list(map(int, PAR_EXPORT_BUCKET.split("x")))]
    feats = {PAR_REQUESTS[0]: par_feats()[PAR_REQUESTS[0]]}
    k2 = 0
    for case in spec["cases"]:
        label = case["label"]
        rs = [x["export"][label] for x in ranks]
        want = per if case["flash"] else 0
        bad = [i for i, x in enumerate(rs) if x["loaded"] != bucket
               or x["traced_loaded"] or not x["equal"]
               or x["sha"] != rs[0]["sha"] or x["k2_loaded"] != want
               or x["k2_traced"] != want]
        if bad:
            raise SystemExit(f"FAIL parallel {label}: ranks {bad}: "
                             f"{[rs[i] for i in bad]}; K2 want {want}")
        k2 += sum(x["k2_loaded"] for x in rs)
        with np.load(os.path.join(work, f"out_{label}.npz")) as z:
            saved = dict(z)
        worst = par_held(torch, label, "fp32", engines[label], saved, feats)
        per_prog = took[label]
        log(f"parallel {label} (1 embed + 1 MoE block at the flagship's "
            f"widths, {len(ranks)} gloo ranks sharing one card): every "
            f"rank ran its loaded program of {PAR_EXPORT_BUCKET} and "
            f"answered bit for bit as the dir without exported/ (ranks "
            f"bit-identical); rank 0 against the unsharded engine "
            f"{worst:.3e} of max|ref|; K2 {rs[0]['k2_loaded']} launches a "
            f"rank from the loaded program (held exactly, {want} a "
            f"forward); export and save s a program "
            f"{[round(v, 2) for v in per_prog]} (build's save, one "
            f"process); load and first call s a rank, loaded program "
            f"{[round(x['first_s_loaded'], 2) for x in rs]} (engine load "
            f"{[round(x['load_s_loaded'], 2) for x in rs]}), traced "
            f"{[round(x['first_s_traced'], 2) for x in rs]}; eager ms a "
            f"{PAR_REQUESTS[0][0]}x{PAR_REQUESTS[0][1]} request (rank 0, "
            f"median of {PAR_RUNS}) loaded {rs[0]['ms_loaded']:.3f}, traced "
            f"{rs[0]['ms_traced']:.3f}; {smi}")
    rs = [x["export"]["recognize"] for x in ranks]
    hyps, _, eng, secs = run_recognize(torch, [
        "-p", spec["one"], "-i", spec["ark"], "--feat_dim", "40",
        "--batch_size", "1", "-d", "greedy"])
    del eng
    if any(x["loaded"] != bucket or x["k2"] != per for x in rs) or \
            hyps != rs[0]["hyps"] or not hyps or any(
                x["counts"]["INFER"] != 1 or x["counts"]["STOP"] != 1
                for x in rs[1:]):
        raise SystemExit(f"FAIL parallel export recognize: ranks {rs}, "
                         f"one process {hyps}")
    k2 += sum(x["k2"] for x in rs)
    log(f"parallel export recognize (greedy, the ep=4 flash dir's "
        f"programs on 4 ranks through the leader and follower loops): "
        f"rank 0's transcript equals one process's on the unsharded dir "
        f"({sum(map(len, hyps.values()))} tokens); programs loaded on "
        f"every rank, K2 {per} a rank (held exactly); {rs[0]['secs']:.1f} "
        f"s on ranks with the load, {secs:.1f} s one process; {smi}")
    return k2


# the serving loops on ranks (phase 18, after its serving cases, in its
# 4-rank world): recognize on an fp32 flash ep=4 dir and serve on the
# fp32 ep2 x tp2 dir, every rank through the port's entry points, rank 0
# leading, the others following
LOOP_UTTS = (0, 3, 5, 6, 7)   # phase 10's 206, 1000, 1500, 2048, 7000 frames
LOOP_BUCKETS = {"bucket_lengths": [256, 1024, 2048], "bucket_batches": [1, 4]}
LOOP_MODES = (("greedy", ["-d", "greedy"]),
              ("beam", ["-d", "beam", "-b", str(RECOGNIZE_BEAM)]))
LOOP_OFFLINE = (206, 640, 1000, 1500)   # 1500: past the dir's 1024
LOOP_CHUNKS = 8               # a stream's chunks (chunk 16, left 2)
LOOP_SERVE = ["--stream_slots", "8", "--beam_size", "10"]


def loop_dir(work, src, name, **settings):
    """A dir of ``src``'s weights (params.npz and config.yaml linked),
    its engine.json updated with ``settings``."""
    d = os.path.join(work, name)
    os.makedirs(d)
    for f in ("params.npz", "config.yaml"):
        os.link(os.path.join(src, f), os.path.join(d, f))
    with open(os.path.join(src, "engine.json")) as f:
        meta = json.load(f)
    meta.update(settings)
    with open(os.path.join(d, "engine.json"), "w") as f:
        json.dump(meta, f)
    return d


def loop_requests():
    """The server's conversations, seeded: four offline requests (greedy,
    beam n-best, timestamps and confidence, one past the largest bucket)
    and two greedy streams of LOOP_CHUNKS chunks, a chunk a piece (a beam
    partial carries no score, so a near-tie between the ranks' and one
    process's logits could not be told from a fault)."""
    rng = np.random.default_rng(181)
    offline = []
    for i, T in enumerate(LOOP_OFFLINE):
        r = {"id": f"r{i}", "feat": (rng.standard_normal((T, 40)) * 2 + 1)
             .astype(np.float32).tolist()}
        r.update(({}, {"decode": "beam", "beam_size": 10, "nbest": 3},
                  {"timestamps": True, "confidence": True}, {})[i])
        offline.append(r)
    streams = []
    cuts = [0] + [67 + 64 * k for k in range(LOOP_CHUNKS)]
    for decode in ("greedy", "greedy"):
        f = (rng.standard_normal((cuts[-1], 40)) * 2 + 1).astype(np.float32)
        streams.append(
            [{"stream": "start", "chunk_size": 16, "num_left_chunks": 2,
              "decode": decode, "beam_size": 10, "timestamps": True}]
            + [{"stream": "chunk", "feat": f[a:b].tolist()}
               for a, b in zip(cuts[:-1], cuts[1:])]
            + [{"stream": "end"}])
    return offline, streams


def loop_inputs(work, fp32_dir):
    """The loops' dirs on the fp32 mode's weights: ``flash_ep4`` (the
    recognizer's buckets, attn_impl flash, ep=4), its unsharded twin
    ``flash_one``, and ``one``, the unsharded twin of the ep2 x tp2 dir;
    phase 10's LOOP_UTTS as an ark; the server's conversations. Writes
    ``loops.json`` and returns it."""
    import yaml
    from m3asr_tpu_torch.config import model_config_from_dict
    from m3asr_tpu_torch.io.kaldi_io import ArkWriter
    with open(os.path.join(fp32_dir, "config.yaml")) as f:
        cfg = model_config_from_dict(yaml.safe_load(f))
    rng = np.random.default_rng(21)            # phase 10's utterances
    utts = [(f"utt{i}", rng.standard_normal((T, cfg.input_dim))
             .astype(np.float32) * 2 + 1)
            for i, T in enumerate(RECOGNIZE_FRAMES)]
    ark = os.path.join(work, "loops.ark")
    with ArkWriter(ark) as w:
        for i in LOOP_UTTS:
            w.write(*utts[i])
    offline, streams = loop_requests()
    out = {"ark": ark, "requests": os.path.join(work, "loops_requests.json"),
           "flash_ep4": loop_dir(work, fp32_dir, "loops_flash_ep4",
                                 attn_impl="flash", ep=4, tp=1,
                                 **LOOP_BUCKETS),
           "flash_one": loop_dir(work, fp32_dir, "loops_flash_one",
                                 attn_impl="flash", ep=1, tp=1,
                                 **LOOP_BUCKETS),
           "ep2tp2": loop_dir(work, fp32_dir, "loops_ep2tp2", ep=2, tp=2),
           "one": loop_dir(work, fp32_dir, "loops_one", ep=1, tp=1),
           "lens": [int(utts[i][1].shape[0]) for i in LOOP_UTTS],
           "k2_per_forward": cfg.encoder_conf.embed_conf.num_blocks
           + cfg.encoder_conf.num_blocks}
    with open(out["requests"], "w") as f:
        json.dump({"offline": offline, "streams": streams}, f)
    with open(os.path.join(work, "loops.json"), "w") as f:
        json.dump(out, f)
    return out


def loop_forwards(lens, batch, buckets, f=4):
    """The engine calls the recognizer makes on these utterances, from
    the bucket arithmetic: one a batch within the largest bucket, one a
    window of Engine.infer_long (default overlap) for a batch past it."""
    W = max(buckets["bucket_lengths"])
    O = max(f, (min(64 * f, W // 4) // f) * f)
    n = 0
    for s in range(0, len(lens), batch):
        chunk = lens[s:s + batch]
        if max(chunk) <= W:
            n += 1
            continue
        for T in chunk:
            n += 1 if T <= W else 1 + -(-(T - W) // (W - 2 * O))
    return n


def loop_client(port, convs, times):
    """Each conversation in turn on a connection of its own: the answers,
    and each answer's round trip (op, ms) appended to ``times``."""
    import socket
    out = []
    for reqs in convs:
        with socket.create_connection(("127.0.0.1", port)) as sock:
            f = sock.makefile("rwb")
            got = []
            for r in reqs:
                t0 = time.perf_counter()
                f.write((json.dumps(r) + "\n").encode())
                f.flush()
                got.append(json.loads(f.readline()))
                times.append((r.get("stream", "offline"),
                              (time.perf_counter() - t0) * 1e3))
            out.append(got)
    return out


def stream_cache_heads(runtime):
    """{batcher key: (main K/V cache heads, embed K/V cache heads)}."""
    return {str(k): (b._prog.inputs[3].shape[2], b._prog.inputs[6].shape[2])
            for k, b in runtime["stream_batchers"].items()}


def loop_rank(torch, work, rank):
    """Phase 18's serving loops on this rank of the 4-rank world:
    ``recognize.main`` greedy and beam on the flash ep=4 dir (K2 counted
    from 0 around each run), then the server's runtime on the ep2 x tp2
    dir (``serve._build_runtime``; rank 0 leads it behind a loopback
    listener and two client threads, then profiles one more request; the
    others run ``serve.follow_runtime``) until rank 0's STOP."""
    import socketserver
    import threading
    from torch.profiler import ProfilerActivity, profile
    from m3asr_tpu_torch import serve
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    from m3asr_tpu_torch.parallel import follow
    with open(os.path.join(work, "loops.json")) as f:
        cfg = json.load(f)
    res = {}
    for mode, flags in LOOP_MODES:
        argv = ["-p", cfg["flash_ep4"], "-i", cfg["ark"], "--feat_dim", "40",
                "--batch_size", str(RECOGNIZE_BATCH)] + flags
        reset_flash(flash_kernels)
        hyps, got, eng, secs = run_recognize(torch, argv)
        r = {"k2": flash_kernels.fwd_launches, "secs": secs}
        if rank == 0:
            r.update(hyps=hyps, rtf=got["rtf"], wall=got["wall_s"],
                     split=got["split_s"],
                     infer=eng._lead[0].calls["INFER"])
        else:
            r.update(counts=got)
        res["recognize " + mode] = r
        del eng
    args = serve.parser().parse_args(["-p", cfg["ep2tp2"]] + LOOP_SERVE)
    t0 = time.perf_counter()
    world = follow.join_world()
    state = serve._build_runtime(args, follower=rank > 0)
    follow.check_world(world, state["engine"])
    s = {"setup_s": time.perf_counter() - t0}
    res["serve"] = s
    if rank:
        s["counts"] = serve.follow_runtime(world, state, args)
        s["heads"] = stream_cache_heads(state)
        return res
    with open(cfg["requests"]) as f:
        reqs = json.load(f)
    off, streams = reqs["offline"], reqs["streams"]
    plan = ([streams[0], [off[0]], [off[1]]],
            [streams[1], [off[2]], [off[3]]])
    leader = follow.Leader(world)
    serve.lead_runtime(state, leader)
    srv = socketserver.ThreadingTCPServer(
        ("127.0.0.1", 0), serve.make_handler(state, 10))
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    answers, times = [None, None], [[], []]

    def run(j):
        answers[j] = loop_client(srv.server_address[1], plan[j], times[j])
    try:
        t0 = time.perf_counter()
        ths = [threading.Thread(target=run, args=(j,)) for j in (0, 1)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        s["clients_s"] = time.perf_counter() - t0
        # the all-reduces' and the control broadcasts' share of one more
        # request (host-side events: gloo runs both on the host)
        feat = np.asarray(off[2]["feat"], np.float32)[None]
        lens = np.array([feat.shape[1]], np.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            state["engine"].infer(feat, lens)
        s["prof_ms"] = (time.perf_counter() - t0) * 1e3
        s["ar"] = collective_union(prof)
        s["bc"] = collective_union(prof, ("broadcast",))
        s["heads"] = stream_cache_heads(state)
    except BaseException:
        leader.stop(failed=True)
        raise
    finally:
        srv.shutdown()
        srv.server_close()
    leader.stop()
    s.update(answers=answers, times=times, calls=leader.calls,
             ticks=[b.batch_sizes for b in state["stream_batchers"]
                    .values()])
    return res


def same_answer(got, ref):
    """Two server answers equal but for latency and float32 summation
    order: the same fields and the same n-best hypotheses, scores within
    1e-5 of the largest |score| (sums of hundreds of frames' log-probs,
    the logits within 1e-6 of max|ref| of each other), in the order of
    the reference's scores but for hypotheses tied within that. One
    hypothesis may stand in for the reference's last only where both
    tie with the last place."""
    got, ref = dict(got), dict(ref)
    for r in (got, ref):
        r.pop("latency_ms", None)
    gn, rn = got.pop("nbest", []), ref.pop("nbest", [])
    if len(gn) != len(rn):
        return False
    if gn:
        tol = 1e-5 * max(abs(n["score"]) for n in gn + rn)
        gs = {tuple(n["hyp"]): n["score"] for n in gn}
        rs = {tuple(n["hyp"]): n["score"] for n in rn}
        only_g, only_r = set(gs) - set(rs), set(rs) - set(gs)
        if only_g or only_r:
            last = rn[-1]
            if len(only_g) != 1 or only_r != {tuple(last["hyp"])}:
                return False
            h, = only_g
            if abs(gs[h] - last["score"]) > tol:
                return False
            rs[h] = last["score"]
        if any(abs(gs[h] - rs[h]) > tol for h in gs):
            return False
        order = [rs[tuple(n["hyp"])] for n in gn]
        if any(a < b - tol for a, b in zip(order, order[1:])):
            return False
        if got["hyp"] != ref["hyp"] and got["hyp"] == gn[0]["hyp"] and \
                ref["hyp"] == rn[0]["hyp"] and \
                abs(gs[tuple(gn[0]["hyp"])] - rn[0]["score"]) <= tol:
            got["hyp"] = ref["hyp"]
    return got == ref


def loop_report(torch, work, ranks, smi):
    """Phase 18's serving loops held: rank 0's transcripts id for id to
    the unsharded engine's recognizer (one process, the same weights and
    settings); the forwards rank 0 led equal to the bucket arithmetic's,
    and K2 exactly (embed + MoE blocks) a forward on every rank; every
    follower's loop ended on STOP having run each of rank 0's calls; the
    server's answers equal to a one-process server's on the unsharded
    dir; the stream caches of every rank at H/tp heads. Returns the K2
    launches (fp32) of every rank."""
    import socketserver
    import threading
    import yaml
    from m3asr_tpu_torch import serve
    from m3asr_tpu_torch.config import model_config_from_dict
    with open(os.path.join(work, "loops.json")) as f:
        cfg = json.load(f)
    per = cfg["k2_per_forward"]
    want_fwd = loop_forwards(cfg["lens"], RECOGNIZE_BATCH, LOOP_BUCKETS)
    k2 = 0
    for mode, flags in LOOP_MODES:
        key = "recognize " + mode
        rs = [x["loops"][key] for x in ranks]
        r0 = rs[0]
        if r0["infer"] != want_fwd:
            raise SystemExit(f"FAIL parallel loops {mode}: rank 0 led "
                             f"{r0['infer']} forwards, want {want_fwd}")
        if any(x["k2"] != per * want_fwd for x in rs):
            raise SystemExit(f"FAIL parallel loops {mode}: K2 launches "
                             f"{[x['k2'] for x in rs]}, want {per} x "
                             f"{want_fwd} a rank")
        if any(x["counts"]["INFER"] != want_fwd or x["counts"]["STOP"] != 1
               for x in rs[1:]):
            raise SystemExit(f"FAIL parallel loops {mode}: followers "
                             f"{[x['counts'] for x in rs[1:]]}")
        k2 += sum(x["k2"] for x in rs)
        argv = ["-p", cfg["flash_one"], "-i", cfg["ark"], "--feat_dim", "40",
                "--batch_size", str(RECOGNIZE_BATCH)] + flags
        hyps, stats, eng, secs = run_recognize(torch, argv)
        del eng
        differ = sorted(k for k in hyps if hyps[k] != r0["hyps"].get(k))
        if differ or len(hyps) != len(LOOP_UTTS):
            raise SystemExit(f"FAIL parallel loops {mode}: rank 0's "
                             f"transcripts differ from one process's at "
                             f"{differ}")
        log(f"parallel loops recognize {mode} (fp32 flash ep4, 4 gloo ranks "
            f"sharing one card, frames {cfg['lens']}): rank 0's transcripts "
            f"equal the unsharded engine's id for id "
            f"({sum(map(len, hyps.values()))} tokens); RTF on ranks "
            f"{r0['rtf']} (wall {r0['wall']} s after the load; split s "
            f"{r0['split']}), one process {stats['rtf']} (wall "
            f"{stats['wall_s']} s, CUDA graphs); {want_fwd} forwards led, "
            f"K2 {per * want_fwd} launches a rank (held exactly), the "
            f"followers stopped on STOP; with the loads {r0['secs']:.1f} s "
            f"on ranks, {secs:.1f} s one process; {smi}")
    s = [x["loops"]["serve"] for x in ranks]
    s0 = s[0]
    if any(a is None for a in s0["answers"]):
        raise SystemExit("FAIL parallel loops serve: a client thread failed")
    if any(x["counts"]["STOP"] != 1 or x["counts"]["INFER"]
           != s0["calls"]["INFER"] or x["counts"]["STREAM_TICK"]
           != s0["calls"]["STREAM_TICK"] for x in s[1:]):
        raise SystemExit(f"FAIL parallel loops serve: followers "
                         f"{[x['counts'] for x in s[1:]]}, rank 0 sent "
                         f"{s0['calls']}")
    with open(os.path.join(cfg["one"], "config.yaml")) as f:
        heads = model_config_from_dict(yaml.safe_load(f)).encoder_conf
    want_heads = (heads.attention_heads // 2, heads.embed_conf
                  .attention_heads)
    if any(tuple(h) != want_heads for x in s
           for h in x["heads"].values()) or any(not x["heads"] for x in s):
        raise SystemExit(f"FAIL parallel loops serve: stream cache heads "
                         f"{[x['heads'] for x in s]}, want {want_heads}")
    # the one-process server on the unsharded dir, one conversation at a
    # time
    with open(cfg["requests"]) as f:
        reqs = json.load(f)
    off, streams = reqs["offline"], reqs["streams"]
    plan = ([streams[0], [off[0]], [off[1]]],
            [streams[1], [off[2]], [off[3]]])
    args = serve.parser().parse_args(["-p", cfg["one"]] + LOOP_SERVE)
    state = serve._build_runtime(args)
    srv = socketserver.ThreadingTCPServer(
        ("127.0.0.1", 0), serve.make_handler(state, 10))
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    one_times = [[], []]
    try:
        ref = [loop_client(srv.server_address[1], plan[j], one_times[j])
               for j in (0, 1)]
    finally:
        srv.shutdown()
        srv.server_close()
        state["batcher"].close()
        for b in state["stream_batchers"].values():
            b.close()
        state = None
        torch.cuda.empty_cache()
    n = 0
    for ga, ra in zip(s0["answers"], ref):
        for gc, rc in zip(ga, ra):
            for g, r in zip(gc, rc):
                n += 1
                if "error" in g or not same_answer(g, r):
                    raise SystemExit(f"FAIL parallel loops serve: {g} "
                                     f"against one process's {r}")

    def lat(times, op):
        v = [ms for t in times for o, ms in t if o == op]
        return f"median {np.median(v):.3f} (min {min(v):.3f}, max " \
               f"{max(v):.3f}, {len(v)})"
    offline_ms = [conv[0]["latency_ms"] for thread in s0["answers"]
                  for conv in thread[1:]]
    ar_n, ar_ms, ar_name = s0["ar"]
    bc_n, bc_ms, _ = s0["bc"]
    log(f"parallel loops serve (fp32 ep2 tp2, 4 gloo ranks sharing one "
        f"card; {LOOP_OFFLINE} offline frames and 2 streams of "
        f"{LOOP_CHUNKS} chunks of 16 from two client threads at once): "
        f"{n} answers equal the one-process server's on the unsharded dir; "
        f"rank 0 sent {s0['calls']}, every follower ran them and stopped on "
        f"STOP; stream cache heads {want_heads} (main, embed) on every rank; "
        f"offline latency ms (server) {offline_ms}; stream chunk round trip "
        f"ms on ranks {lat(s0['times'], 'chunk')}, one process "
        f"{lat(one_times, 'chunk')}; offline round trip ms on ranks "
        f"{lat(s0['times'], 'offline')}, one process "
        f"{lat(one_times, 'offline')}; tick batch sizes {s0['ticks']}; one "
        f"1x1000 request profiled on rank 0 {s0['prof_ms']:.3f} ms: "
        f"all-reduce {ar_n} x {ar_name} {ar_ms:.3f} ms = "
        f"{ar_ms / s0['prof_ms']:.3f}, control broadcasts {bc_n} "
        f"{bc_ms:.3f} ms = {bc_ms / s0['prof_ms']:.3f}; setup "
        f"{s0['setup_s']:.1f} s, clients {s0['clients_s']:.1f} s; {smi}")
    return k2


def phase_parallel(torch, state, smi, serve=True, train=True):
    """Phase 18 (``serve``: its serving cases, then the serving loops in
    the 4-rank world) and phase 19 (``train``, in the same worlds, after
    phase 18's); returns the bf16 flash ranks' K2 launches (all ranks)
    and the fp32 K2 launches of the loops and phase 19's K2/K3 launches
    by (kernel, dtype)."""
    import shutil as sh
    import tempfile
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="par18_")
    try:
        engines, cases = par_engines(torch, work) if serve else \
            ({}, {2: [], 4: []})
        exporter = None
        if serve:
            loop_inputs(work, next(c["dir"] for c in cases[4]
                                   if c["mode"] == "fp32"))
            exporter = start_export(work, torch)
        t_build = time.perf_counter() - t0
        feats = par_feats()
        if train:
            state.setdefault("max_err_flash_sp", tp_flash_sp(torch, smi))
        world_s = {}
        for n in (2, 4):      # the exported dirs build beside the 2 ranks
            with open(os.path.join(work, f"cases_{n}.json"), "w") as f:
                json.dump(cases[n], f)
            if train:
                with open(os.path.join(work, f"train_cases_{n}.json"),
                          "w") as f:
                    json.dump([c[0] for c in TP_CASES[n]], f)
            world_s[n] = par_world(n, work)
            for c in cases[n]:               # its dirs are read
                sh.rmtree(c["dir"], ignore_errors=True)
        exported, took = {}, {}
        if exporter is not None:
            exporter[0].join()
            got = exporter[1]
            if "error" in got:
                raise got["error"]
            exported, took = got["result"]
            log(f"parallel export: {len(PAR_EXPORTS)} dirs built with every "
                f"rank's program in {got['s']:.1f} s, beside the 2-rank "
                "world")
        k2, trained = 0, {}
        for n in (4, 2):
            ranks = []
            for r in range(n):
                with open(os.path.join(work, f"rank_{n}_{r}.json")) as f:
                    ranks.append(json.load(f))
            sp = ranks[0]["spans"]
            log(f"parallel: {n}-rank world {world_s[n]:.1f} s: rank 0 "
                f"imports {sp['imports_s']:.1f} s, process group "
                f"{sp['init_s']:.1f} s, " + "".join(
                    f"{c['label']} {ranks[0]['cases'][c['label']]['case_s']:.1f}"
                    " s, " for c in cases[n]) + f"in all {sp['rank_s']:.1f} s "
                f"of the rank's life")
            for c in cases[n]:
                label, mode = c["label"], c["mode"]
                rs = [x["cases"][label] for x in ranks]
                for key in (f"{B}x{T}" for B, T in PAR_REQUESTS):
                    if any(x[key]["sha"] != rs[0][key]["sha"] for x in rs):
                        raise SystemExit(f"FAIL parallel {label} {key}: the "
                                         "ranks' outputs differ")
                want_impl = {"fp32": "dense", "bf16 flash": "dense",
                             "int8": "quant", "int4": "quant"}[mode]
                if rs[0]["impl"] != want_impl:
                    raise SystemExit(f"FAIL parallel {label}: stage "
                                     f"{rs[0]['impl']}, not {want_impl}")
                if mode == "bf16 flash":
                    enc = engines[mode].model_cfg.encoder_conf
                    per = (enc.embed_conf.num_blocks + enc.num_blocks) * \
                        rs[0]["forwards"]
                    if any(x["k2"] != per for x in rs) or \
                            rs[0]["attn"] != "flash":
                        raise SystemExit(f"FAIL parallel {label}: K2 "
                                         f"launches {[x['k2'] for x in rs]},"
                                         f" want {per} a rank")
                    k2 += sum(x["k2"] for x in rs)
                elif any(x["k2"] for x in rs):
                    raise SystemExit(f"FAIL parallel {label}: K2 launched")
                with np.load(os.path.join(
                        work, f"out_{label}.npz")) as z:
                    saved = dict(z)
                worst = par_held(torch, label, mode, engines[mode], saved,
                                 feats)
                line = (f"parallel {label} ({rs[0]['mesh']}, {n} gloo ranks "
                        f"sharing one card, backend {ranks[0]['backend']}, "
                        f"stage {rs[0]['impl']}, attention {rs[0]['attn']}):"
                        f" ranks bit-identical; rank 0 against the unsharded "
                        f"engine {worst:.3e} of max|ref|"
                        + (" (routing pinned)" if mode != "fp32" else "")
                        + f"; load {rs[0]['load_s']:.1f} s")
                for key in (f"{B}x{T}" for B, T in PAR_REQUESTS):
                    x = rs[0][key]
                    line += (f"; {key} eager {x['lat']:.3f} ms (min "
                             f"{x['lat_min']:.3f}, max {x['lat_max']:.3f}, "
                             f"{PAR_RUNS} runs), all-reduce {x['ar_calls']} "
                             f"x {x['ar_name']} {x['ar_ms']:.3f} ms = "
                             f"{x['ar_ms'] / x['prof_ms']:.3f} of a profiled "
                             f"{x['prof_ms']:.3f} ms")
                line += (f"; {BUILT_MOE_BLOCKS} MoE blocks; peak per rank "
                         + " / ".join(
                    f"{x['peak_gib']:.3f}" for x in rs) + " GiB")
                if mode == "bf16 flash":
                    line += f"; K2 {rs[0]['k2']} launches a rank"
                log(line + f"; {smi}")
            if serve and n == 4:
                sp = ranks[0]["spans"]
                log(f"parallel export: {sp['export_s']:.1f} s of rank 0's "
                    f"life (waited {ranks[0]['export']['waited_s']:.1f} s "
                    f"for the dirs); loops: {sp['loops_s']:.1f} s")
                trained[("K2", "float32")] = export_report(
                    torch, work, ranks, exported, took, smi) + loop_report(
                        torch, work, ranks, smi)
            if train:
                for kn, cnt in tp_report(torch, n, ranks, smi).items():
                    trained[kn] = trained.get(kn, 0) + cnt
        engines.clear()
        exported.clear()
        torch.cuda.empty_cache()
        log(f"parallel: build and dirs {t_build:.1f} s, worlds "
            + ", ".join(f"{n} ranks {s:.1f} s" for n, s in world_s.items())
            + f", phases {time.perf_counter() - t0:.1f} s; gloo ranks on one "
            f"card, not an NCCL deployment; {smi}")
        return k2, trained
    finally:
        sh.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# 19. parallel training on phase 18's gloo ranks: dp/ep/tp/sp/pp steps,
#     ZeRO-1, FSDP and BMUF held to the unsharded step, then the CLI and
#     dryrun_multichip on ranks
# ---------------------------------------------------------------------------

TP_MOE_BLOCKS = 2             # 6 embed + 2 MoE blocks, as phase 16 cuts it
TP_STEPS = 3                  # a case's steps: the checked one, then timed;
                              # then one more, profiled (rank 0)
TP_SP_SHAPE = (2, 125, 250)   # K2/K3 under dp2 x sp2: (B, T = T'/sp, S)
TP_CLI_FRAMES = (1000, 960, 880, 800, 990, 720, 505, 310)  # 2 steps of 4
TP_BF16_TOL = 0.05            # the bf16 case: of max|ref| (and the loss)
# world size -> (label, mesh, layout, attn_impl, compute dtype)
TP_CASES = {
    4: (("dp2 ep2 flash", dict(dp=2, ep=2), {}, "flash", "float32"),
        ("dp2 tp2 xla", dict(dp=2, tp=2), {"tp": True}, "xla", "float32"),
        ("dp2 sp2 flash", dict(dp=2, sp=2), {}, "flash", "float32"),
        ("dp2 ep2 zero1", dict(dp=2, ep=2), {"zero1": True}, "flash",
         "float32"),
        ("dp4 flash", dict(dp=4), {}, "flash", "float32"),
        ("dp4 fsdp", dict(dp=4), {"fsdp": True}, "flash", "float32"),
        ("pp2 dp2 flash", dict(pp=2, dp=2),
         {"pp": True, "pp_microbatches": 2}, "flash", "float32"),
        ("bmuf dp4", dict(dp=4), {"bmuf": True}, "flash", "float32")),
    2: (("ep2 bf16 flash", dict(ep=2), {}, "flash", "bfloat16"),
        ("cli ep2", None, None, "flash", "float32"),
        ("dryrun_multichip(2)", None, None, "xla", "float32")),
}
# a split state's case -> the replicated case its peak memory is set beside
TP_MEM_BASE = {"dp2 ep2 zero1": "dp2 ep2 flash", "dp4 fsdp": "dp4 flash"}


def tp_flash_per_pass(cfg, shape, layout, attn):
    """(K2, K3 dq, K3 dkv) launches a rank makes in one forward and
    backward, from the schedule: each attention layer it runs launches K2
    once in the forward and each K3 kernel once in the backward. Every
    rank runs the embed sub-encoder's blocks on its rows and the main
    blocks it holds; a pp stage holds L/S of them and runs each once a
    microbatch. Under sp a rank's query rows take one launch a layer, as
    a dp slice does. The unsharded reference is ``shape`` None."""
    if attn != "flash":
        return (0, 0, 0)
    enc = cfg.encoder_conf
    S = (shape or {}).get("pp", 1)
    M = layout.get("pp_microbatches", 1) if S > 1 else 1
    n = enc.embed_conf.num_blocks + enc.num_blocks // S * M
    return (n, n, n)


def tp_model(torch):
    """The phase's config (the flagship's widths, TP_MOE_BLOCKS MoE
    blocks), its seeded tree on the card (routers normal x 0.5) and the
    training batch (TRAIN_LENS)."""
    from m3asr_tpu_torch.models import moe_conformer
    cfg = flagship_cfg()
    cfg.encoder_conf.num_blocks = TP_MOE_BLOCKS
    gen = torch.Generator(device="cuda").manual_seed(19)
    params = moe_conformer.init(cfg.encoder_conf, cfg.input_dim,
                                cfg.output_dim, gen, device="cuda")
    r = params["blocks"]["feed_forward"]["router"]
    r["kernel"] = torch.randn(r["kernel"].shape, generator=gen,
                              device="cuda") * 0.5
    return cfg, params, train_batch(torch, cfg)


class PinnedGates:
    """Sends each MoE call's tokens on this rank to the experts the
    unsharded reference chose for them (``gates``: one (B, T') index
    tensor a block, in block order): the rank's rows are its dp slice
    (its pipeline microbatch under pp) and its sp rows, the padded rows
    expert 0. Without pinning, a router near-tie could flip between the
    two summation orders and move a gradient group past the bound."""

    def __init__(self, torch, moe_mod, gates, mesh, microbatches=1):
        self.torch, self.moe_mod, self.gates = torch, moe_mod, gates
        self.mesh, self.M, self.n = mesh, microbatches, 0

    def __enter__(self):
        self.inner = self.moe_mod.softmax_top1_gate
        mesh, torch = self.mesh, self.torch

        def gate(p, router_inputs, lengths):
            value, idx = self.inner(p, router_inputs, lengths)
            c, self.n = self.n, self.n + 1
            B, T = idx.shape
            S, s = mesh.shape["pp"], mesh.coord("pp")
            per = len(self.gates) // S
            mb, j = divmod(c, per) if S > 1 else (0, c)
            ref = self.gates[s * per + j].to(idx.device)
            Bd = ref.shape[0] // mesh.shape["dp"]
            row = mesh.coord("dp") * Bd + mb * B
            cols = T * mesh.shape["sp"]
            full = torch.zeros((B, cols), dtype=idx.dtype,
                               device=idx.device)
            part = ref[row:row + B, :cols]
            full[:part.shape[0], :part.shape[1]] = part
            off = mesh.coord("sp") * T
            return value, full[:, off:off + T].contiguous()
        self.moe_mod.softmax_top1_gate = gate
        return self

    def __exit__(self, *exc):
        self.moe_mod.softmax_top1_gate = self.inner


def tp_digests(torch, mesh, tree, specs):
    """{leaf: [ranks]} of the leaves whose bits differ between ranks that
    hold the same block of them (collective)."""
    import hashlib
    import torch.distributed as dist
    from m3asr_tpu_torch.checkpoint import flatten_tree
    from m3asr_tpu_torch.train.parallel import split_axes
    mine = {}
    for k, v in flatten_tree(tree).items():
        block = tuple((a, mesh.coord(a)) for a in split_axes(specs[k]))
        mine[k] = (block, hashlib.sha1(
            v.detach().contiguous().cpu().numpy().tobytes()).hexdigest())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    bad = {}
    for k in mine:
        seen = {}
        for r, d in enumerate(every):
            if seen.setdefault(d[k][0], d[k][1]) != d[k][1]:
                bad.setdefault(k, []).append(r)
    return bad


def collective_union(prof, keys=("all_reduce", "allreduce")):
    """(calls, ms, names) of the collectives in a CPU profile whose event
    names hold one of ``keys`` (default: the all-reduces): the union of
    their time ranges (nested and overlapping events, the calling
    thread's and gloo's, merged); a call is its ``c10d::`` event."""
    ranges, names, ops = [], set(), 0
    for e in prof.events():
        if any(k in e.name for k in keys):
            ranges.append((e.time_range.start, e.time_range.end))
            names.add(e.name)
            ops += e.name.startswith("c10d::")
    merged = []
    for a, b in sorted(ranges):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return (ops or len(merged), sum(b - a for a, b in merged) / 1e3,
            "+".join(sorted(names)) or "none")


def tp_refs(torch, cfg, params, batch, keys, rank):
    """Rank 0's unsharded references: {(attn_impl, dtype, rows): (loss,
    grads, gates, launches (K2, K3 dq, K3 dkv))} of one pass on the whole
    batch (rows None) or on its first ``rows`` rows (BMUF's replica 0);
    every rank gets the gates."""
    import torch.distributed as dist
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    from m3asr_tpu_torch.train import step as ts
    refs = {}
    for key in keys:
        attn, dtype, rows = key
        got = None
        if rank == 0:
            b = batch if rows is None else tuple(a[:rows] for a in batch)
            reset_flash(flash_kernels)
            t0 = time.perf_counter()
            with GateRecorder(moe_mod) as rec:
                (loss, _), g = ts.value_and_grad(
                    params, cfg, train_config(attn, dtype), *b)
            loss = loss.item()
            got = (loss, [x.cpu() for x in rec.calls],
                   count_flash(flash_kernels), time.perf_counter() - t0)
        box = [None if got is None else (got[0], got[1], got[2])]
        dist.broadcast_object_list(box, src=0)
        refs[key] = (box[0][0], g if rank == 0 else None, box[0][1],
                     box[0][2])
        if rank == 0:
            log(f"train_parallel reference {attn} {dtype} rows "
                f"{rows or 'all'}: loss {loss:.6f}, one pass "
                f"{got[3]:.1f} s")
    return refs


def tp_step_case(torch, case, cfg, params, batch, refs, rank):
    """One case: the checked pass (routing pinned to the reference's),
    its gradient gathered and held to the reference's per group, the
    update, the bit check, then timed steps (rank 0 profiles one)."""
    import contextlib
    from torch.profiler import ProfilerActivity, profile
    from m3asr_tpu_torch.checkpoint import flatten_tree
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    from m3asr_tpu_torch.parallel.mesh import make_mesh
    from m3asr_tpu_torch.train import step as ts
    from m3asr_tpu_torch.train.bmuf import BmufRecipe, replica
    from m3asr_tpu_torch.train.parallel import Parallel
    label, shape, layout, attn, dtype = case
    bmuf = layout.get("bmuf", False)
    mesh = make_mesh(**shape)
    par = Parallel(mesh, params, **layout)
    tcfg = train_config(attn, dtype)
    opt = ts.make_optimizer(tcfg)
    step = ts.make_train_step(cfg, tcfg, opt, device="cuda", mesh=par)
    if bmuf:
        # a replica a dp rank, stepping on its own rows
        n = batch[0].shape[0] // mesh.shape["dp"]
        r = mesh.coord("dp")
        b = tuple(a[r * n:(r + 1) * n] for a in batch)
        local = par.shard(params, par.param_specs)
        stacked = BmufRecipe.stack(local, 1)
        recipe = BmufRecipe(stacked, 2, mesh=mesh)
        state = ts.init_opt_state(opt, local)
        ref = refs[(attn, dtype, n)]
    else:
        b = batch
        local = par.shard_params(params)
        state = par.init_opt_state(opt, local)
        ref = refs[(attn, dtype, None)]
    per_ref = tp_flash_per_pass(cfg, None, {}, attn)
    if tuple(ref[3]) != per_ref:
        raise SystemExit(f"FAIL train_parallel {label}: the unsharded "
                         f"reference pass launched (K2, K3 dq, K3 dkv) "
                         f"{tuple(ref[3])}, the schedule {per_ref}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash(flash_kernels)
    pin = PinnedGates(torch, moe_mod, ref[2], mesh,
                      layout.get("pp_microbatches", 1)) \
        if not bmuf or rank == 0 else contextlib.nullcontext()
    t0 = time.perf_counter()
    with pin:
        m, g, norm = step.value_and_grad(local, *b)
    loss = m["loss"].item()
    first_s = time.perf_counter() - t0
    res = {"loss": loss, "ref_loss": ref[0], "first_s": first_s,
           "mesh": repr(mesh)}
    whole = par.gather(g, par.param_specs)
    if rank == 0:
        got = {k: v.cuda() for k, v in flatten_tree(whole).items()}
        rels = group_rel(got, ref[1])
        rel_loss = abs(loss - ref[0]) / abs(ref[0])
        tol = TRAIN_GRAD_TOL if dtype == "float32" else TP_BF16_TOL
        worst = max(rels, key=rels.get)
        res.update(rel_loss=rel_loss, worst_group=worst,
                   worst_rel=rels[worst], tol=tol)
        loss_tol = 1e-5 if dtype == "float32" else TP_BF16_TOL
        if rel_loss > loss_tol or rels[worst] > tol:
            raise SystemExit(
                f"FAIL train_parallel {label}: loss {loss:.6f} vs "
                f"{ref[0]:.6f} (rel {rel_loss:.3e}), gradient group "
                f"{worst} at {rels[worst]:.3e} of max|g| (held to {tol})")
        del got
    del whole
    local, state, _ = step.apply(local, state, m, g, norm)
    if bmuf:
        stacked = BmufRecipe.stack(local, 1)
    del g
    launches = [count_flash(flash_kernels)]
    # steps 1 .. TP_STEPS - 1 timed; step TP_STEPS under the profiler on
    # rank 0 (every rank runs it), kept out of the times. BMUF syncs after
    # steps 1 and 3 (sync_period 2): the profiled step is a sync step
    times, syncs, prof_row = [], [], None
    for i in range(1, TP_STEPS + 1):
        profiled = i == TP_STEPS
        sync = bmuf and (i + 1) % recipe.sync_period == 0
        prof = profile(activities=[ProfilerActivity.CPU]) \
            if profiled and rank == 0 else contextlib.nullcontext()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with prof:
            if bmuf:
                p, state, m = step(replica(stacked, 0), state, *b)
                stacked = BmufRecipe.stack(p, 1)
                if sync:
                    stacked, ok = recipe.sync(stacked)
                    if not ok:
                        raise SystemExit(f"FAIL train_parallel {label}: "
                                         "BMUF STOP")
                    synced = replica(stacked, 0)
            else:
                local, state, m = step(local, state, *b)
            m["loss"].item()
        ms = (time.perf_counter() - t1) * 1e3
        if not profiled:
            times.append(ms)
            syncs.append(sync)
        elif rank == 0:
            calls, ar_ms, name = collective_union(prof)
            prof_row = {"ar_calls": calls, "ar_ms": ar_ms, "ar_name": name,
                        "prof_ms": ms, "sync": sync}
    # every rank holding a block of a leaf holds the same bits: right after
    # the BMUF sync, every leaf of every replica
    if bmuf:
        bad = tp_digests(torch, mesh, synced,
                         {k: () for k in par.param_specs})
        del synced
    else:
        bad = tp_digests(torch, mesh, local, par.param_specs)
    if bad:
        raise SystemExit(f"FAIL train_parallel {label}: ranks holding the "
                         f"same block differ in {sorted(bad)[:5]}")
    k = count_flash(flash_kernels)
    res.update(launches=k, times=times, syncs=syncs, prof=prof_row,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               case_s=time.perf_counter() - t0)
    # the checked pass, the timed steps and the profiled one
    per = tp_flash_per_pass(cfg, shape, layout, attn)
    want = tuple((TP_STEPS + 1) * x for x in per)
    res["per"] = list(per)
    if k != want or launches[0] != per:
        raise SystemExit(f"FAIL train_parallel {label}: launches (K2, K3 "
                         f"dq, K3 dkv) {launches[0]} in the checked pass "
                         f"and {k} in all, want {per} and {want}")
    del local, state
    if bmuf:
        del stacked, recipe
    torch.cuda.empty_cache()
    return res


def tp_cli_case(torch, work, rank, cfg):
    """The port's CLI in this world (``train.cli.main`` with ``--ep 2``):
    2 steps of 4 utterances, flash, a final checkpoint that rank 0 reads
    back whole and deletes."""
    import pickle
    import shutil
    import yaml
    import torch.distributed as dist
    from m3asr_tpu_torch.io.kaldi_io import ArkWriter
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    from m3asr_tpu_torch.train import cli
    d = os.path.join(work, "cli")
    if rank == 0:
        os.makedirs(d)
        rng = np.random.default_rng(19)
        keys = [f"u{i}" for i in range(len(TP_CLI_FRAMES))]
        with ArkWriter(os.path.join(d, "tr.ark")) as w:
            for k, T in zip(keys, TP_CLI_FRAMES):
                w.write(k, rng.standard_normal((T, cfg.input_dim))
                        .astype(np.float32))
        write_int_vectors(os.path.join(d, "tr_ctc.ark"), {
            k: rng.integers(1, cfg.output_dim - 1, T // 40)
            for k, T in zip(keys, TP_CLI_FRAMES)})
        with open(os.path.join(HERE, "configs", "3m_asr_18l32e.yaml")) as f:
            raw = yaml.safe_load(f)
        raw["loader_conf"]["batch_size"] = 4
        raw["model_conf"]["encoder_conf"]["num_blocks"] = TP_MOE_BLOCKS
        raw.update(log_period=1, save_period=2, attn_impl="flash",
                   max_epoch=1, embed_ctc_weight=0.3)
        with open(os.path.join(d, "cfg.yaml"), "w") as f:
            yaml.safe_dump(raw, f)
    dist.barrier()
    out = os.path.join(d, "exp")
    reset_flash(flash_kernels)
    t0 = time.perf_counter()
    trainer = cli.main(["--config", os.path.join(d, "cfg.yaml"),
                        "--output_dir", out, "--tr_rspecifier",
                        os.path.join(d, "tr.ark"), "--tr_labels",
                        os.path.join(d, "tr_ctc.ark"), "--ep", "2"])
    res = {"steps": trainer.global_step, "run_s": time.perf_counter() - t0,
           "launches": count_flash(flash_kernels),
           "mesh": repr(trainer.parallel.mesh)}
    # 2 steps, one pass each on the rank's whole batch (ep splits experts)
    want = tuple(2 * x for x in tp_flash_per_pass(cfg, {"ep": 2}, {},
                                                  "flash"))
    if tuple(res["launches"]) != want:
        raise SystemExit(f"FAIL train_parallel cli ep2: launches (K2, K3 "
                         f"dq, K3 dkv) {res['launches']} on rank {rank}, "
                         f"the schedule {want}")
    del trainer
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        path = os.path.join(out, "checkpoint_final.pkl")
        res["gib"] = os.path.getsize(path) / 2 ** 30
        t1 = time.perf_counter()
        with open(path, "rb") as f:
            state = pickle.load(f)
        res["read_s"] = time.perf_counter() - t1
        w1 = state["params"]["blocks"]["feed_forward"]["w1"]
        mu = state["opt_state"]["mu"]["blocks/feed_forward/w1"]
        res["w1"], res["mu_w1"] = list(w1.shape), list(mu.shape)
        res["global_step"] = state["global_step"]
        del state, w1, mu
        shutil.rmtree(d, ignore_errors=True)
    dist.barrier()
    return res


def tp_rank(torch, work, n, rank):
    """Phase 19's cases on this rank of a phase-18 world
    (``train_cases_{n}.json``); raises SystemExit on a failed check.
    Returns the numbers rank 0's report prints."""
    import torch.distributed as dist
    from m3asr_tpu_torch.parallel.dryrun import dryrun_multichip
    with open(os.path.join(work, f"train_cases_{n}.json")) as f:
        labels = json.load(f)
    cases = [c for c in TP_CASES[n] if c[0] in labels]
    t0 = time.perf_counter()
    cfg, params, batch = tp_model(torch)
    keys = sorted({(c[3], c[4], (batch[0].shape[0] // c[1]["dp"]
                                 if c[2].get("bmuf") else None))
                   for c in cases if c[1] is not None},
                  key=lambda k: (k[0], k[1], k[2] or 0))
    refs = tp_refs(torch, cfg, params, batch, keys, rank)
    out = {"setup_s": time.perf_counter() - t0, "cases": {}}
    for c in cases:
        if c[0] == "cli ep2":
            r = tp_cli_case(torch, work, rank, cfg)
        elif c[0].startswith("dryrun"):
            t1 = time.perf_counter()
            r = {"dryrun": dryrun_multichip(n, "cuda"),
                 "run_s": time.perf_counter() - t1}
        else:
            r = tp_step_case(torch, c, cfg, params, batch, refs, rank)
        out["cases"][c[0]] = r
        dist.barrier()
    del refs, params
    torch.cuda.empty_cache()
    return out


def tp_flash_sp(torch, smi):
    """K2 (out, LSE) and K3 against their plain versions at the sp shape
    of the dp2 x sp2 case (a rank's 125 query rows of T' = 249 padded to
    250, against all 250 keys; the dp slice's key lengths 249 and 239),
    without a mask and with a 16-frame chunk window offset to the rank's
    global rows; then each kernel's device time beside its plain
    version's (fp32). Returns the worst max_abs_err per (kernel,
    dtype)."""
    from m3asr_tpu_torch.ops import flash_attention as fa
    from m3asr_tpu_torch.ops import masking
    gen = torch.Generator(device="cuda").manual_seed(19)
    B, T, S = TP_SP_SHAPE
    H, Dk = FLASH_HEADS[0]
    scale = Dk ** -0.5
    lens = torch.tensor([249, 239], dtype=torch.int32, device="cuda")
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        q2 = torch.randn(B, H, T, 2 * Dk, generator=gen, device="cuda") \
            .to(dtype)
        k2 = torch.randn(B, H, S, 2 * Dk, generator=gen, device="cuda") \
            .to(dtype)
        v = torch.randn(B, H, S, Dk, generator=gen, device="cuda").to(dtype)
        g = torch.randn(B, H, T, Dk, generator=gen, device="cuda").to(dtype)
        m = masking.add_optional_chunk_mask(lens, S, False, False, 0, 16, -1)
        rows = fa.window_from_mask(m[:, :, S - T:], T, S)
        for masks, window in (("lengths", None), ("window", rows)):
            out, lse = fa.flash_kernels.forward(q2, k2, v, lens, scale,
                                                window, 0, True)
            delta = (g.float() * out.float()).sum(-1, keepdim=True)
            grads = fa.flash_kernels.backward(q2, k2, v, g, lse, delta, lens,
                                              scale, window, 0)
            r_out, r_lse = fa.flash_attention_reference(q2, k2, v, lens,
                                                        scale, window, 0)
            r_grads = fa.flash_attention_bwd_reference(
                q2, k2, v, g, r_lse,
                (g.float() * r_out.float()).sum(-1, keepdim=True), lens,
                scale, window, 0)
            keep = r_lse > -1e29
            rels = []
            for kern, name, a, r in (
                    ("K2", "out", out, r_out),
                    ("K2", "lse", lse[keep], r_lse[keep]),
                    ("K3", "dq2", grads[0], r_grads[0]),
                    ("K3", "dk2", grads[1], r_grads[1]),
                    ("K3", "dv", grads[2], r_grads[2])):
                err = (a.float() - r.float()).abs().max().item()
                rel = err / r.float().abs().max().item()
                worst[(kern, dname)] = max(worst.get((kern, dname), 0.0),
                                           err)
                rels.append(f"{name} {rel:.2e}")
                if not (rel <= FLASH_TOL[dname] and np.isfinite(err)):
                    raise SystemExit(f"FAIL train_parallel: K2/K3 at the sp "
                                     f"shape: {name} {rel:.3e} of max|ref| "
                                     f"({dname} {masks})")
            log(f"kernel flash sp shape {dname} B={B} T={T} S={S} H={H} "
                f"Dk={Dk} {masks}: max|diff|/max|ref| " + ", ".join(rels)
                + f" (held to {FLASH_TOL[dname]}) OK")
        if dtype == torch.float32:
            lse_d = lse
            (k2_ms, p2_ms) = paired_device_ms(
                torch, lambda: fa.flash_kernels.forward(
                    q2, k2, v, lens, scale, None, 0, True),
                lambda: fa.flash_attention_reference(q2, k2, v, lens, scale,
                                                     None, 0))
            (k3_ms, p3_ms) = paired_device_ms(
                torch, lambda: fa.flash_kernels.backward(
                    q2, k2, v, g, lse_d, delta, lens, scale, None, 0),
                lambda: fa.flash_attention_bwd_reference(
                    q2, k2, v, g, lse_d, delta, lens, scale, None, 0))
            log(f"time flash sp shape float32 B={B} T={T} S={S} H={H} "
                f"Dk={Dk}: K2 {k2_ms[0]:.4f} ms (range {k2_ms[1]:.4f}-"
                f"{k2_ms[2]:.4f}) vs plain {p2_ms[0]:.4f} ms; K3 "
                f"{k3_ms[0]:.4f} ms ({k3_ms[1]:.4f}-{k3_ms[2]:.4f}) vs "
                f"plain {p3_ms[0]:.4f} ms (device time, in turns); {smi}")
    return worst


def tp_report(torch, n, ranks, smi):
    """Rank 0's lines of a world's phase-19 cases (times, all-reduce
    share, peak memory of every rank); returns the ranks' K2/K3
    launches by dtype."""
    launches = {}
    tr = [x["train"] for x in ranks]
    log(f"train_parallel: {n}-rank world: the model and the unsharded "
        f"references {tr[0]['setup_s']:.1f} s on rank 0")
    for label, _, _, attn, dtype in TP_CASES[n]:
        if label not in tr[0]["cases"]:
            continue
        rs = [t["cases"][label] for t in tr]
        r = rs[0]
        if label == "cli ep2":
            if r["steps"] != 2 or r["global_step"] != 2 or \
                    r["w1"] != r["mu_w1"] or r["w1"][1] != 32:
                raise SystemExit(f"FAIL train_parallel {label}: {r}")
            log(f"train_parallel {label} ({r['mesh']}, {n} gloo ranks "
                f"sharing one card): 2 steps of the CLI in {r['run_s']:.1f} "
                f"s; checkpoint_final.pkl {r['gib']:.2f} GiB holds the whole "
                f"tree (w1 {r['w1']}, Adam mu the same), read in "
                f"{r['read_s']:.1f} s and deleted; launches (K2, K3 dq, K3 "
                f"dkv) per rank {[x['launches'] for x in rs]}; {smi}")
            for x in rs:
                for kname, cnt in (("K2", x["launches"][0]),
                                   ("K3", x["launches"][1])):
                    launches[(kname, "float32")] = \
                        launches.get((kname, "float32"), 0) + cnt
            continue
        if label.startswith("dryrun"):
            d = r["dryrun"]
            log(f"train_parallel {label}: losses " + ", ".join(
                f"{k} {v[0]:.4f}" for k, v in d.items()
                if k != "serving_err") + f" agree; ep2 engine vs one rank "
                f"{d['serving_err']:.2e}; {r['run_s']:.1f} s")
            continue
        for x in rs:
            for kname, cnt in (("K2", x["launches"][0]),
                               ("K3", x["launches"][1])):
                launches[(kname, dtype)] = launches.get((kname, dtype),
                                                        0) + cnt
        p = r["prof"]
        if any(r["syncs"]):
            # BMUF: the steps that sync and those that do not, apart
            sync = [t for t, y in zip(r["times"], r["syncs"]) if y]
            local = [t for t, y in zip(r["times"], r["syncs"]) if not y]
            steps = (f"sync step {float(np.median(sync)):.1f} ms, local "
                     f"step {float(np.median(local)):.1f} ms (host, "
                     f"without the profiler: {[round(t, 1) for t in sync]}"
                     f" / {[round(t, 1) for t in local]})")
        else:
            steps = (f"step {float(np.median(r['times'])):.1f} ms (host "
                     f"median of the {len(r['times'])} after the first, "
                     f"without the profiler: "
                     f"{[round(t, 1) for t in r['times']]})")
        mem = ""
        base = TP_MEM_BASE.get(label)
        if base in tr[0]["cases"]:
            bs = [t["cases"][base]["peak_gib"] for t in tr]
            mem = (f" (the replicated {base}: " + " / ".join(
                f"{x:.3f}" for x in bs) + " GiB; ratio " + " / ".join(
                f"{x['peak_gib'] / y:.3f}" for x, y in zip(rs, bs)) + ")")
        log(f"train_parallel {label} ({r['mesh']}, {n} gloo ranks sharing "
            f"one card, {dtype} {attn}): first step loss {r['loss']:.6f} "
            f"vs unsharded {r['ref_loss']:.6f} (rel {r['rel_loss']:.2e}); "
            f"gradients gathered, worst group {r['worst_group']} "
            f"{r['worst_rel']:.2e} of max|g| (held to {r['tol']}; routing "
            f"pinned to the unsharded step's); shared blocks bit-identical "
            f"on every rank after the update; {steps}; all-reduce on rank "
            f"0 {p['ar_calls']} x {p['ar_name']} {p['ar_ms']:.1f} ms = "
            f"{p['ar_ms'] / p['prof_ms']:.3f} of one more "
            f"{'sync ' if p['sync'] else ''}step, profiled, "
            f"{p['prof_ms']:.1f} ms; launches (K2, K3 dq, K3 dkv) "
            f"{r['launches']} a rank over {TP_STEPS + 1} steps (the "
            f"schedule's {r['per']} a "
            f"pass, held exactly); peak per rank " + " / ".join(
                f"{x['peak_gib']:.3f}" for x in rs) + f" GiB{mem}; {smi}")
    return launches


# ``python3 chip_smoke.py --only NAME [NAME ...]`` runs those named, in
# order. Such a run is not the smoke: it prints no result line, exits 1
ALONE = {
    "front": lambda torch, state, smi: phase_kernel_front(torch),
    "dfsmn_kernels": lambda torch, state, smi: phase_kernel_dfsmn(torch),
    "flash_mem": lambda torch, state, smi: phase_kernel_flash_mem(torch),
    "dfsmn_times": lambda torch, state, smi: time_dfsmn_kernels(torch, smi),
    "table_growth": phase_table_growth,
    "streams_dense": phase_streams_dense,
    "exmarc": phase_exmarc,
    "train_cli": phase_train_cli,
    "train_dfsmn": lambda torch, state, smi: (
        phase_train_dfsmn(torch, state, smi), time_flash_mem_bwd(torch, smi)),
    "parallel": lambda torch, state, smi: phase_parallel(
        torch, state, smi, train=False),
    "train_parallel": lambda torch, state, smi: phase_parallel(
        torch, state, smi, serve=False),
    "hier_witness": hier_witness,
    "dfsmn_witness": dfsmn_witness,
}


def main():
    if sys.argv[1:2] == ["--parallel-rank"]:
        return par_rank(sys.argv[2])
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, smi = phase_device(torch)
    import m3asr_tpu_torch
    if os.path.dirname(os.path.dirname(os.path.abspath(
            m3asr_tpu_torch.__file__))) != HERE:
        raise SystemExit("FAIL: m3asr_tpu_torch is not the checkout's own")
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops import moe_runs
    phase_build(kernels)
    if sys.argv[1:2] == ["--only"]:
        names = sys.argv[2:]
        if not names or not set(names) <= set(ALONE):
            raise SystemExit(f"--only takes names of {sorted(ALONE)}")
        state = {}
        for n in names:
            ALONE[n](torch, state, smi)
        log(f"ran {names} alone: not the smoke, no result line")
        return 1
    start = time.perf_counter()

    def stamp(name):
        log(f"time: {name} done at {time.perf_counter() - start:.1f} s")
    phase_kernel_front(torch)
    state = {"max_err": phase_kernel(torch, moe_runs),
             "max_err_q": phase_kernel_quant(torch),
             "max_err_flash": phase_kernel_flash(torch),
             "max_err_stage": phase_kernel_stage(torch),
             "max_err_dfsmn": {**phase_kernel_dfsmn(torch),
                               **phase_kernel_flash_mem(torch)}}
    stamp("phases 3 (kernel checks)")
    state["launches"] = phase_serve(torch, state)
    state["launches_q"] = phase_serve_quant(torch, state, smi)
    state["launches_stage"] = phase_serve_stages(torch, state, smi)
    served = phase_serve_flash(torch, state, smi)
    stamp("phases 4-7")
    phase_serve_graphs(torch, state, smi)
    stamp("phase 8")
    state["launches_stream"] = phase_stream(torch, state, smi)
    stamp("phase 9")
    state["launches_recognize"] = phase_recognize(torch, state, smi)
    stamp("phase 10")
    phase_dfsmn(torch, state, smi)
    stamp("phase 13")
    phase_streams_dense(torch, state, smi)
    stamp("phase 14")
    exmarc = phase_exmarc(torch, state, smi)
    stamp("phase 15")
    trained = phase_train(torch, state, smi)
    stamp("phase 11")
    trained_cli = phase_train_cli(torch, state, smi)
    stamp("phase 16")
    trained_dfsmn = phase_train_dfsmn(torch, state, smi)
    stamp("phase 17")
    parallel_k2, trained_par = phase_parallel(torch, state, smi)
    stamp("phases 18 and 19")
    # K2: serving's forwards and the training steps'; K3: the steps'
    state["launches_flash"] = {}
    for dname in ("float32", "bfloat16"):
        fwd, dq, dkv = trained[dname]
        if dq != dkv:
            raise SystemExit("FAIL: K3's two kernels launched unequally")
        state["launches_flash"][("K2", dname)] = served[dname] + fwd
        state["launches_flash"][("K3", dname)] = dq
    state["launches_flash"][("K2", "bfloat16")] += state["launches_dense_k2"]
    # phase 18: the bf16 flash ep=4 engine's ranks; phase 19: the
    # training ranks' steps and the CLI's
    state["launches_flash"][("K2", "bfloat16")] += parallel_k2
    for key, cnt in trained_par.items():
        state["launches_flash"][key] += cnt
    # phase 16: the training CLI's runs (fp32); phase 17: the dense
    # conformer's step (fp32)
    for kname in ("K2", "K3"):
        state["launches_flash"][(kname, "float32")] += \
            trained_cli[kname] + trained_dfsmn[(kname, "float32")]
    report = (phase_times(torch, state, smi) + dfsmn_report(torch, state, smi)
              + flash_mem_bwd_report(torch, state, trained_dfsmn, smi))
    stamp("phases 12, 13 and 17's times")
    # phase 17's K2 launches at (64, 64): the DFSMN training steps and CLI
    for row in report:
        for dname, mem_name in FLASH_MEM_NAMES.items():
            if row["name"] == mem_name:
                row["launches"] += trained_dfsmn[("K2mem", dname)]
    # phase 15's launches: the ExMarc engines, top-2 and the exported
    # programs' captures
    for row in report:
        row["launches"] += exmarc.pop(row["name"], 0)
    if exmarc:
        raise SystemExit(f"FAIL report: phase 15 launches of "
                         f"{sorted(exmarc)} have no entry")
    log(smi)
    log(json.dumps({"kernels": report}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
