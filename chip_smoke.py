#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (lavida_mod_tpu_torch) on one
NVIDIA GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one printed line or more each; any failure raises, so the script
exits non-zero and never prints the final line:
  1. device: a CUDA card is required (no CPU fallback); its name and power
     limit as nvidia-smi reports them; TF32 off for matmuls and cuDNN.
  2. build: nvcc compiles the port's CUDA kernels from csrc/, one compiler
     per source, in parallel (timed); ptxas's registers and spills per
     kernel, and the register count that the setmaxnreg of
     short_attention, prefix_flash, w4_matmul_grouped's prefill kernel and
     fused_vit_mlp's GEMM needs held in every instance
     (kernels.check_registers).
  3. kernels vs their plain PyTorch versions on the card, at the main
     paths' shapes plus a ragged/odd case each: max error and time of each
     (on the device alone, and back to back as the host issues the calls)
     (short_attention, gather_rows; w8a8_matmul, w4_qkv_norm,
     w4_matmul_res, w4_ffn_fused; w4_matmul; w4_matmul_grouped,
     kv8_decode_attention, fused_vit_mlp), the time of one PyTorch call that
     computes the same function where there is one, each kernel's bound
     (the larger of its bytes over 3.35 TB/s and its operations over the
     peak for their type: 989 TFLOP/s bf16, 1,979 TOP/s int8), its share
     of the bound and its ratio to the library call.  short_attention also
     at the edges of its wgmma design (S = 1, S shorter than one stage, S a
     tile multiple + 1, hd 16 / 48 / 72 / 80 / 96 / 128, G = 1, 4 and 7, rows
     whose first K/V tiles are all masked), w8a8_matmul at T = 1, K = 16,
     K = 4304 and N = 1000 / 1001 / 1 (bit-exact), and the host time per
     call of both (their wrappers pass TMA tensor maps, cached per buffer)
     beside the library call's; then both kernels summed over one mixed
     request against SDPA and torch._int_mm + epilogue, device time and
     back to back.  w4_ffn_fused at 8 / 16 / 24 / 32 / 40 rows of the 8B
     decode shape and a padded down K, each twice with new data at the
     same addresses, and 20 calls chained back to back without a sync,
     each matched to its plain version; w4_qkv_norm at [q|k|v], the head
     at 32 and 128 rows and a ragged width, and 20 chained calls of [32,
     4096] x 4096 likewise; w4_matmul_res at [32, 4096] x 4096 and a
     narrow width, and 20 chained calls, all exact.  w4_matmul, which no path
     launches, at [32, 4096] x 12288, [1056, 4096] x 12288 and [5, 4304] x
     1000, within one bf16 ulp of its plain version, beside
     torch._weight_int4pack_mm on the same codes.  w4_matmul_grouped's two
     kernels, each bit-exact: the decode kernel (T <= 256) at 32 x B rows
     for B = 1, 2, 3, 4, 5, 7, 8 of the three LLaDA linears, the B = 8 head,
     a tiny and a Dream width; the prefill kernel (T > 256) at 4608 and
     2304 rows of the three, a ragged 1153 rows of [K 12288] x 4096 and a
     Dream width at 300 rows ([300, 18944] x 3584).  kv8_decode_attention
     within 6e-3 of its plain version at the B = 4 and B = 8 kv8 batches'
     shapes, a ragged GQA case, G = 16, S = 16384 (many key chunks),
     Dream-7B's G = 7 and a batch row with every key masked; its int4
     instance (the --kv4 cache, codes packed two a byte) within 6e-3 of its
     plain version at the B = 4 and B = 8 batches, one request's cache (S =
     1088), Dream's GQA, hd 16 (8-byte rows by cp.async), 32, 64 and 256,
     S = 6401 and 16384, padded rows and a row with every key masked, each
     beside the int8 kernel's time at the same shape.  decode_attention
     (the bf16 cache read in place) within 4e-3 of its plain version (the
     unsplit softmax) at the batched serving step, bench.py's B = 1
     request and Dream-7B's GQA batched and at B = 1 (the two at B = 1
     with key splits), beside dense_attention, the route it replaced; its
     launches are counted in every request phase below.
     fused_vit_mlp within 5e-2 of its plain version at one image (M =
     3645), 20 views (M = 14580) and a ragged M 77 / D 256 / F 520, its
     error printed beside its first design's, the port's unfused chain
     timed beside it as a yardstick, and at one image the time each of
     its three launches (LN, fc1, fc2) adds.
  4. the bf16 main path at full width: LaViDaConfig() (LLaDA-8B + SigLIP
     so400m) in bf16 with random weights made on the card from seed 0,
     three requests through LaViDa.generate_fused (gen 32, 16 steps, prefix
     cache), each checked for shape, no mask token left, and exactly 26 + 32
     short_attention launches and 1 gather_rows launch.
  5. the mixed main path (bench.py's default serving layout): the same
     model through to_serving_layout("mixed", fuse=True) on the card (int8
     prefill tree + fused int4 decode tree, the bf16 linears freed), three
     requests with the same checks and, per request, 128 w8a8_matmul,
     528 w4_qkv_norm, 512 w4_matmul_res and 512 w4_ffn_fused launches;
     request walls, phase times, peak memory, weight bytes per tree and
     the device-busy share of one profiled request, and w4_qkv_norm's,
     w4_matmul_res's and w4_ffn_fused's device time in it split by their
     two, two and four kernels (528, 512 and 512 launches of each
     asserted); one decode layer at B = 1 timed through the fused plan.
     Then bench.py --kv4 at B = 1: one request through generate_fused(kv8=
     4), the decode over the int4 KV cache: wall, peak memory and every
     kernel's launches asserted (32 x 16 of #8's int4 instance).  Before
     the layout, the bf16 model of 4 serves one bench-protocol request
     without the prefix cache (LaViDa.generate, prefix_lm False: the whole
     forward over P + 32 rows each step, dense attention) and one verbose
     request over the prefix cache (16 snapshots, the mask count never
     rising, the last equal to the tokens returned); after the kv4
     request, LavidaEvalModel.loglikelihood at MMMU geometry (one 640 x 640
     image, a 300-token continuation, mc_num 16 in one round of 16 rows)
     on the int8 prefill tree, weight-only (two forward chunks of 8) and
     with loglik_act_int8 (four of 4): finite, negative, within 5 % of
     each other.  Walls, peaks and every kernel's launches asserted.
  6. output checks on a small input: a tiny model in bf16 on the card
     against the same weights in f32 on the CPU (plain path), a tiny
     mixed-layout model on the card against the same quantized weights on
     the CPU (plain versions of the fused w4 kernels), and a tiny bf16
     model's no-cache, dLLM (r < G), verbose and draft generations and
     one log-likelihood round (the same counts and ranks) on the card
     against the CPU.
  7. the checkpoint and text path at full width
     (lavida_mod_tpu_torch/rehearse_8b_load.py): a reference-layout
     LaViDa-LLaDA-8B checkpoint (32 LLaDA layers, SigLIP's 27, the
     projector and the newline, 16.9 GB of bf16 drawn on the card from seed
     0) written to disk in safetensors shards by the port's own writer with
     a config.json and a BPE tokenizer, after a check of the free disk;
     LaViDa.load with the geometry sniffed (equal to LaViDaConfig() field by
     field) and every loaded tensor bit-equal to the written one (checksums
     of its bits on the card, SigLIP's last layer dropped);
     to_serving_layout("mixed", fuse=True); the llada template and the
     tokenizer (48 text tokens and the image marker, the rendered prompt
     round-tripping); one HD request served twice through generate_fused
     and decode_output, ids below the vocab and the text cut at the stop
     id; the six kernels' launches counted over the two requests (twice a
     mixed request's); the stage walls, bytes on disk, host RSS after each
     stage and peak device memory.  The checkpoint is kept for 7b; first
     predict_fim runs on it (LaViDa.load, the weight-only int8 layout, the
     trained tokenizer, the default draft, G = 256): the drafted positions
     kept, wall, peak and launches (the prefill's 32 short_attention).
 7a. the eval CLI (lavida_mod_tpu_torch/eval, `python -m
     lavida_mod_tpu_torch.eval`) in process through its `main` on 7's
     checkpoint: --quant mixed --gen-kwargs prefix_lm=True (eval_main.sh's
     gen kwargs) --tasks pope,textvqa_val,hellaswag,videomme --limit 2
     --output --output-dir, on the documents of tools/eval_smoke_all.py
     (schema-exact jsonl, seeded PNGs, and for videomme a 32-frame
     seeded GIF each) in a temporary directory deleted after: every task's
     results finite and in range with JAX's result keys, the tracker's
     results and sample files, and per document the launches of every
     kernel (an image document 26 + 32 short_attention, 1 gather_rows, 128
     w8a8_matmul, 16 x 33 w4_qkv_norm, 16 x 32 w4_matmul_res and
     w4_ffn_fused; a hellaswag ending 2 x 32 short_attention, four per
     document; the video document 26 + 32 short_attention, no gather,
     the same w8a8 and int4 decode launches); load wall, walls per
     document and per task, peak memory and the video prefix's length.
 7b. the server (lavida_mod_tpu_torch/serve): the port's controller and a
     worker built from its CLI flags (--model-path <7's checkpoint> --mixed
     --kv4 --decode-batch 4: the mixed layout with fuse=False, the int4 KV
     cache) in threads on 127.0.0.1; the worker registers; four concurrent
     requests (base64 PNGs of four anyres sizes where PIL imports, else
     text, with the four image requests run through the worker model's
     generate_batch) dispatched through the controller merge into one
     batch of 4, each answer decoded text; an OpenAI /v1/chat/completions
     request and a single request take the batcher's B = 1 route; every
     kernel's launches asserted per call (w8a8_matmul for the prefill,
     w4_matmul_grouped's decode kernel, #8's int4 instance, fused_vit_mlp
     for the tower); walls, peak memory and the device-busy share of one
     batch.  The checkpoint is deleted afterwards.
  8. the batched int4 main path (the serve worker's --int4 --decode-batch
     N, bench.py --batch): a new LaViDaConfig() model from seed 0 through
     to_serving_layout("int4", fuse=False), then eval.adapter.
     generate_batch on B = 4 requests of four image sizes with the int8 KV
     cache off and on, and on B = 8 requests through the chunked prefill:
     walls per batch and per image, stage walls, peak memory, launches per
     kernel asserted per batch (w4_matmul_grouped's decode and prefill
     kernels apart), the profiler's device-busy share of one
     batch; one decode layer at B = 1 timed through the unfused layout.
     Then the same model at B = 1: bench.py --no-cache --no-fused (one
     request after a warm-up, and one profiled: the device-busy share),
     --dllm 64 at gen 32 (r >= G) beside the cached scan (token agreement
     printed), and the TPU rounds' --gen-len 256 --steps 32 --dllm 64
     beside the same without --dllm; each request's launches asserted
     (#4's prefill kernel for the prefill and every no-cache step's
     linears, its decode kernel for the 32-, 64- and 256-row calls, #5 as
     the head of at most 128 rows).
  9. a tiny int4 + kv8 + fused-ViT-MLP model on the card against the same
     weights on the CPU; the tiny bf16 model (hd 16) over the int4 KV
     cache likewise (one decode step from the same cache, and kv4
     generate_batch).
 10. the training attention kernels (prefix_flash_fwd, prefix_flash_dq,
     prefix_flash_dkv) against their plain versions on the card at the
     stage-1 shape (8 doubled rows x 1152 tokens, 32 heads, hd 128, prefix
     lengths near 1010, a kv_valid tail) and a ragged GQA case (28 / 4
     heads, T 200, prefix length 0 and >= T): errors, kernel (device time
     and back to back), plain and library times (SDPA forward; SDPA's
     autograd backward for dq + dkv, both also back to back) and bounds
     (4 / 6 / 8 x the visible (query, key) pairs x Hq x hd operations);
     then at the stage-1 shape the forward against SDPA's forward and dq +
     dkv against SDPA's whole backward, per launch and per step, each with
     its share of the bound and its ratio to the library call.
 11. stage-1 pretraining at full LaViDa-LLaDA-8B (LaViDaConfig(), 32 LLaDA
     and 26 SigLIP layers, random bf16 weights from seed 0 on the card):
     make_freeze_optimizer("mm_mlp_adapter", lr 1e-3, pretrain_stage1.sh's
     warmup ratio 0.03 over 100 steps), the mixed-precision step with
     whole-layer remat, ce_chunk 512 and prefix_flash attention, B = 4
     samples of one bench-shaped image, an 8-token prompt and a 40-token
     caption, T bucketed to 128 and views to 8; one warm-up step and three
     timed steps: a finite loss, the launches per step asserted (2 x 32
     prefix_flash_fwd, 32 dq, 32 dkv, 1 gather_rows, 2 x 26
     short_attention: grad_norm covers every leaf, as JAX's, so the frozen
     tower runs under autograd and its remat recomputes each layer), the
     projector and image_newline moved after the first step with a nonzero
     LR, every LLaDA and SigLIP weight bit-identical (checksums); step
     wall, data tokens per second, peak memory, the profiler's device-busy
     share of one step, device time by kernel and by kernel kind
     (lavida_mod_tpu_torch/step_times.py, which times the stage-1 step of
     any checkout the same way) and #10's device time.
 12. stage-2 finetuning at full width with the LLaDA depth cut to 4 layers
     (the only cut; SigLIP keeps 26): every part tunable, lr 2e-5, tower lr
     2e-6, grad_accum 2 (finetune_stage2.sh), B = 2, two microsteps make one
     update: every group moved after the update and not before, the
     short-attention VJP ran, nothing is NaN.
 13. a tiny LaViDa trained one stage-2 microstep on the card (bf16 compute,
     kernels) and on the CPU (plain versions) from the same f32 masters
     with the same injected mask: loss, trainable gradients and updated
     masters within stated bands.
 13b. the training CLI (lavida_mod_tpu_torch/train/cli.py, train.py's
     port), in process through `cli.main`, on 16 synthetic records of 768
     x 768 PNGs (tools/make_synthetic_data.py) under train_runs/ in the
     checkout (refused if it exists, deleted at the end): T1, stage 1 at
     full LaViDa-LLaDA-8B (--tunable mm_mlp_adapter --lr 1e-3 --ce-chunk
     512 --batch-size 4 --steps 6 --log-every 1 --save-every 2
     --adapter-only-save --prefetch 2 --decode-workers 4 --profile):
     finite losses, the launches per step of #10, #2 and #1 asserted,
     the frozen LLaDA and SigLIP bit-identical to a new init from the
     seed, the projector and newline moved, checkpoint-{2,4,6}/
     mm_projector written and the last loaded back bit-equal through
     load_adapter_into; step walls beside phase 11's, logged tokens/s,
     peak, the busy share of the profiled microsteps.  T2, every part
     tunable at --geometry 457m, --precision bf16 --remat nested
     --ce-chunk 512 --grad-accum 2: run A (one update, a full async
     save; the in-training eval hook once, --eval-tasks pope --eval-every
     1 --eval-limit 2: its eval/pope rows in metrics.jsonl, the training
     state's checksums equal before and after it, its launches asserted),
     run B restoring it bit-equal to A's final state (checksums of
     every tensor and count), run C resuming for a second update (finite
     losses, every group moved, the tower's #1 VJP run); save, commit and
     restore walls.  T3, the remat ladder at 457m (whole_layer, nested,
     dots_nobatch, dots, one_in_2, none with dense attention, whole_layer
     with blockwise and with prefix_flash): step-1 losses within 1 % of
     whole_layer's, peaks whole_layer < dots_nobatch < dots < none.  T4,
     phase 7's trained tokenizer through load_hf_or_offline
     (transformers' AutoTokenizer) and the pure loader: equal ids.
 14. the kernels of the LaViDa-Dream path against their plain versions at
     Dream-7B's shapes (P the bench request's prefix): short_attention at
     the GQA prefill (28 query / 4 KV heads) and SigLIP's, gather_rows at
     width 3584, w8a8_matmul at the prefill's four linears with the QKV
     bias in the epilogue of [q|k|v] (bit-exact), w4_qkv_norm with the
     bias at [32, 3584] x 4608 and at the head padded to 152064 columns,
     w4_matmul_res at [32, 3584] x 3584 (exact), w4_ffn_fused at D 3584, H
     18944 over 20480 padded down rows, and fused_vit_mlp at one image;
     each with its plain, library and bound times, summed over one Dream
     request's launches.
 15. LaViDa-Dream at full Dream-7B width and depth (LaViDaConfig(llada=
     dream_7b_config()): 28 layers, d 3584, H 18944, vocab 151936, the QKV
     bias; SigLIP's 26 layers), random bf16 weights from seed 0 on the
     card: one bf16 request through LaViDa.generate with a
     DreamGenerationConfig (gen 32, 16 steps, topk_margin, prefix_lm), then
     to_serving_layout("mixed", fuse=True) and the three bench-protocol
     requests as bench.py --dream serves them (multimodal_embeds, then
     dream_generate with the flash prefill through the int8 tree and its
     int8 head, the fused int4 decode with the bias in w4_qkv_norm): walls,
     peak memory, every kernel's launches per request asserted (bf16: 26
     short_attention and 26 fused_vit_mlp; mixed: 26 + 28 short_attention,
     1 gather_rows, 112 w8a8_matmul, 16 x 29 w4_qkv_norm, 16 x 28
     w4_matmul_res and w4_ffn_fused), the device-busy share of one mixed
     request.
 16. a tiny mixed LaViDa-Dream (widths multiples of 512: the fused plan
     with the bias, a 1000-row head padded to 1024) on the card against the
     same weights on the CPU: decode logits and the tokens.
SHIRG (models/shirg.py, train/lora.py, train_shirg_lora.py), in the phases
above: phase 3 also times #1 at SHIRG's [2, 1024, 16, 72] in bf16 beside
SDPA, and #1's f32 instance (3xTF32 on the tensor cores) at the harness
tower's [4, 1024, 16, 72] and a ragged GQA shape with rows that see no
key, within 2e-5 of its plain version, beside SDPA in f32, its bound the
3xTF32 floor (3 x its operations at 495 TFLOP/s) with the FFMA figure (at
the f32 rate of 67 TFLOP/s) printed beside it; after phase 4, its bf16 8B model serves a seeded 1024 x 768
image through process_shirg_2view and shirg_encode (`base`, then `full`
with the similarity merge) into LaViDa.generate(image_features=...):
a [980, 4096] block, no mask left, 26 + 32 #1 launches and nothing else
per request, the encode split into tower / scores + top-k / merge; after
phase 5, bench.py --shirg's composition on the mixed model
(shirg_encode, splice_embeddings, generate_cached_fused with its own
control table): phase 5's #3 and #5-#7 launches, no #2, and with the
fused ViT MLP 26 launches of #9; after phase 6, a tiny SHIRG encode in
f32 (#1's f32 instance) and a tiny SHIRG-LoRA microstep on the card
against the CPU; after 13b, the SHIRG-LoRA harness
(train_shirg_lora.main) at full LaViDa-LLaDA-8B in f32, B = 2, three
steps, --warmup-steps 1: finite losses and grad norms, 26 #1 (f32)
launches per step, the active SigLIP factors moved, every frozen leaf
bit-unchanged, the inert factors (SigLIP's gated ones and the projector's,
which the projector never reads) with B still zero and A decayed by
weight decay alone, the adapter save reloaded bit-equal, the step walls
and the peak beside the reckoned one and the card's memory.
After the Dream phases, the rest of training and sharding (phases 16-18):
one stage-1 step of LaViDa-Dream at full Dream-7B width through
make_freeze_optimizer("mm_mlp_adapter") and make_multimodal_train_step
(B = 4 bench-shaped samples, as phase 11): the launches per step (#10 2 x
28 forward with the remat recompute, 28 dq, 28 dkv; #1 2 x 26; #2 1), a
finite loss, the projector moved, every LLaDA and SigLIP weight
bit-unchanged, the step wall and peak; three diffusion DPO steps at full
LaViDa-LLaDA-8B (LoRA rank 64 on the LM's seven linears,
make_lora_optimizer, the reference the frozen base with the factors off;
one pair of a bench-shaped image, a 48-token prompt and 32-token answers
embedded on the card through the tower and the splice): the first loss
log 2, finite losses and grad norms, #10's launches per step (the
policy's passes forward + remat + dq + dkv, the reference's forward) and
#1 / #2 per built pair, every base weight bit-unchanged, the B factors
moved, the wall and peak beside the reckoned memory; then, on a
one-rank NCCL process group, the same 8B model (its factors dropped)
under LaViDa.shard serving one bench request -- tokens bit-equal to the
unsharded request's, #1 and #2 launches equal, and its encode_prompt
bit-equal with #9's 26 launches in both -- and one stage-1 step at the
457m geometry under the one-rank mesh whose loss and grad_norm equal the
unsharded step's bit for bit (two unsharded steps first show the step
itself repeats; where it does not, both must lie within their spread).  Phase 10 also holds #10 at the Dream step's shape
([8, 1152, 28 / 4 heads, 128]) against its plain versions and SDPA.
The other towers, resamplers and projector kinds (models/clip.py,
open_clip.py, mlcd.py, eva_clip.py, qformer.py, resampler.py,
projector.py): phase 3 also checks and times #1 at each tower's layer
shape (TOWER_SHAPES: [4, 577, 16, 64] CLIP-L and MLCD-L, [2, 730, 16, 80]
ViT-H-14-378, [4, 257, 16, 80] ImageBind, [2, 257, 32, 128] EVA-CLIP-8B)
beside SDPA, weighed 0 in the bench request's sums; after phase 4, its
bf16 8B model serves the first bench request once with a "linear" and
once with an "mlp2x_res2x_gelu" projector of seeded weights in place of
its own (phase 4's checks and launches), which it gets back after; and
last, after the sharded phase has freed the card,
 19. every other tower at its published width through build_vision_tower
     in bf16 (TOWER_RUNS: CLIP ViT-L/14-336 on 4 images, the same with S2
     at 336 / 672 / 1008 on 2 images of 1008^2, open_clip ViT-H-14-378 on
     4, imagebind_huge on 4 of 224^2, MLCD ViT-L-336 on 4, EVA-CLIP-8B on
     2 of 224^2; 23, 69, 31, 32, 23 and 31 #1 launches a forward,
     asserted): shape, finite, within TOWER_LIMIT of the forward through
     the plain attention, each #1 call within ATTN_CALL_LIMIT x max|v| of
     the plain version on its own q, k and v (two wrong attentions, heads
     rolled and q / k swapped, shown outside it), wall per image, peak
     memory and weight bytes; then masked_drop on the card in its fixed and range
     modes, equal to its CPU run of the same draws, the Q-Former
     (BERT-base, 32 queries) over the CLIP-L features and the perceiver
     (dim 1152) over SigLIP-shaped features, each within RESAMPLER_LIMIT
     of its CPU run of the same weights.
The AR baselines and the int8 tower (models/ar_models.py, models/moe.py,
generation/ar_sampler.py, SigLIP.quantize_tower): before phase 5's model
is freed,
 23. its 5-view request's tower in bf16, then the int8 tower
     (quantize_tower) with int8 activations: 156 w8a8_matmul launches (6
     linears x 26 layers at T = 3645) and 26 short_attention asserted, the
     first and last layers' six #3 calls bit-exact to the plain version on
     the inputs they had (the three shapes timed beside torch._int_mm +
     epilogue, weighed 0 in the request's sums), the features within
     TOWER_INT8_LIMIT of the bf16 tower's; then one default mixed request
     with that tower (multimodal_embeds(vision_act_int8=True) and the
     mixed cached generation), every launch asserted.
And after phase 19:
 20. bench.py --ar's layout: Vicuna-7B (MHA, FF 11008, vocab 32000) in
     grouped int4, fused [q|k|v] / [up|gate], with SigLIP so400m, seed 0:
     one HD request (base + 4 tiles, 48 text tokens) encoded with the
     fused ViT MLP and decoded 32 tokens by ar_generate_fused at B = 1;
     launches reckoned before the run and asserted (26 #1, 26 #9, 1 #2,
     #4's prefill kernel 128, its decode kernel 31 x 129 + 1); #4 at each
     new shape (one row and P rows of the four linears, the padded head)
     bit-exact and timed, weighed 0 in the sums; the tokens held to a
     full causal recompute (AR_RECOMPUTE_LIMIT: within twice the
     recompute's distance from a shorter one, near-ties counted).
 21. Llama-3-8B (GQA 32 / 8, vocab 128256) at full width and depth in
     bf16: a 128-token prompt, 32 greedy tokens, held to a recompute.
 22. Mixtral-8x7B at full width cut to MIXTRAL_LAYERS layers: one block's
     moe_ff within MOE_LOOP_LIMIT of a loop over its experts, then a
     64-token prompt decoded 16 tokens and held to a recompute, in bf16
     and on an f32 copy (AR_F32_LIMIT, every token the recompute's).
Then the card's name and power limit, one JSON line of per-kernel results
(each entry with `launches_dream_path`, and `dream_path`, its sums at the
Dream shapes, where phase 14 measured it; #1, #2 and #10 with
`launches_train_cli`, T1's, and `launches_dream_train_step` /
`launches_dpo_step`, per step of phases 16 / 17; the SHIRG paths'
launches; #1 and #2's per projector kind request, and #1's per forward of
each tower of phase 19 (`launches_towers`); #1's f32 instance
as `short_attention_f32`, its launches the harness run's; the AR and
int8-tower launches as `launches_ar_vicuna`, `launches_int8_tower` and
`launches_int8_tower_request`), and as the
last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import time

import numpy as np

from lavida_mod_tpu_torch.kernel_times import (KV8_CASES, SHORT_F32_CASES,
                                                added_times, cuda_ms, host_us,
                                                kernel_split, kv8_case_inputs,
                                                short_f32_bounds_ms,
                                                short_f32_inputs)
from lavida_mod_tpu_torch.step_times import print_by_kind

SIGLIP_LAYERS = 26   # so400m's 27 layers less the dropped last one
# phase 19: each tower of models/tower_builder.py at its published width,
# in bf16 through build_vision_tower: (label, name, build kwargs, images,
# side, #1 launches of one forward, the output's shape).  The launches are
# the layers each forward runs (clip.py:111, :221 of eva_clip.py): CLIP-L
# and MLCD-L select -2 of 24 layers, S2 runs CLIP-L at three scales,
# ViT-H -2 of 32, ImageBind -1 of 32, EVA-CLIP-8B all but the last of 32
TOWER_RUNS = [
    ("clip", "clip", {}, 4, 336, 23, (4, 576, 1024)),
    ("clip_s2", "clip", {"s2": True}, 2, 1008, 69, (2, 576, 3072)),
    ("open_clip", "open_clip", {}, 4, 378, 31, (4, 729, 1280)),
    ("imagebind", "imagebind", {}, 4, 224, 32, (4, 256, 1280)),
    ("mlcd", "mlcd", {}, 4, 336, 23, (4, 576, 1024)),
    ("eva", "eva", {}, 2, 224, 31, (2, 256, 4096)),
]
# #1's shape in each tower's layer: [images, tokens, heads, head dim]
TOWER_SHAPES = {"tower_clip_mlcd": (4, 577, 16, 64),
                "tower_vit_h": (2, 730, 16, 80),
                "tower_imagebind": (4, 257, 16, 80),
                "tower_eva_8b": (2, 257, 32, 128)}
# a tower through #1 against the same tower through the plain attention
# (phase 19): 23 - 32 bf16 layers, the eval block's limit for SigLIP's 26
TOWER_LIMIT = 5e-2
# each #1 call inside a tower forward against short_attention_reference on
# the same q, k and v: max|diff| over max|v| (phase 3's limit).  The output
# is a convex combination of v's rows, so its rounding scales with |v|;
# with seeded weights of std 0.02 the softmax is nearly flat and the
# output is some 20 times smaller than v, where one bf16 ulp of max|out|
# already reads 2^-7 of it.  The whole-tower check alone is weak for the
# same reason (each layer's attention adds little to the residual), so
# phase 19 takes this reading too and shows that it fails for two wrong
# attentions
ATTN_CALL_LIMIT = 8e-3
# the resamplers on the card against their CPU run of the same weights,
# both f32 (TF32 off)
RESAMPLER_LIMIT = 1e-4
LLADA_LAYERS = 32
LLADA_LINEARS = 7    # q, k, v, attn_out, ff_proj, up_proj, ff_out
# fused_vit_mlp's largest error against its plain version at phase 3's
# cases (by M), as its first design (mma.sync on a cp.async ring) read it
# on an NVIDIA H100 80GB HBM3
VIT_FIRST_DESIGN_ERR = {3645: 3.125e-2, 14580: 3.125e-2, 77: 3.906e-3}
# H100 SXM published peaks (dense): HBM bytes/s, bf16 flop/s, int8 op/s,
# TF32 flop/s
HBM_BPS, BF16_FLOPS, INT8_OPS, TF32_FLOPS = 3.35e12, 989e12, 1979e12, 495e12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bound_ms(ops: float, nbytes: float, int8: bool = False,
             f32: bool = False):
    """(least time in ms, "bytes" or "operations") of one launch; `f32`:
    products in f32 through 3xTF32, three times the operations at the
    dense TF32 rate."""
    t_ops = (3 * ops / TF32_FLOPS if f32 else
             ops / (INT8_OPS if int8 else BF16_FLOPS)) * 1e3
    t_bytes = nbytes / HBM_BPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


class Results:
    """Per-kernel sums over one main-path run's launches: the kernel's,
    the plain version's and the library call's time, and the bound."""

    def __init__(self):
        self.k = {}

    def add(self, name, shape, per, err, kernel, plain_ms, library_ms, ops,
            nbytes, int8=False, note="", weight=None, library_b2b=None,
            f32=False, per_video=0):
        """`kernel` calls the kernel's wrapper: timed on the device alone
        (`ms`) and back to back as the host issues it (`ms_back_to_back`,
        the larger of the host's and the card's time per call; the library
        call's, `library_b2b`, where it is given).  `per` is
        the launches of one main-path run at this shape; the sums weigh
        the shape by `weight` (default `per`); `per_video`, its launches
        per video document of the eval phase (7a)."""
        ms, b2b = cuda_ms(kernel), cuda_ms(kernel, hold=False)
        b, by = bound_ms(ops, nbytes, int8, f32)
        lib = "none" if library_ms is None else (
            f"{library_ms:.4f} ms (kernel {ms / library_ms:.2f}x its time)")
        if per_video:
            note += f"; {per_video} launches per eval video document"
        print(f"[kernels] {name} {shape}: err {err:.3e}{note}, kernel "
              f"{ms:.4f} ms (back to back {b2b:.4f} ms), plain "
              f"{plain_ms:.4f} ms, library {lib}, bound {b:.4f} ms ({by}; "
              f"kernel at {100 * b / ms:.1f} % of it)")
        w = per if weight is None else weight
        r = self.k.setdefault(name, {
            "max_abs_err": 0.0, "ms": 0.0, "ms_back_to_back": 0.0,
            "plain_ms": 0.0,
            "library_ms": None if library_ms is None else 0.0,
            "bound_ms": 0.0, "bound_by": by, "per_shape": [], "_by": {}})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += w * ms
        r["ms_back_to_back"] += w * b2b
        if library_b2b is not None:
            r["library_ms_back_to_back"] = (r.get("library_ms_back_to_back", 0.0)
                                            + w * library_b2b)
        r["plain_ms"] += w * plain_ms
        if library_ms is not None and r["library_ms"] is not None:
            r["library_ms"] += w * library_ms
        r["bound_ms"] += w * b
        r["_by"][by] = r["_by"].get(by, 0.0) + w * b
        r["bound_by"] = max(r["_by"], key=r["_by"].get)
        r["per_shape"].append({"shape": shape, "per_run": per, "ms": ms,
                               "ms_back_to_back": b2b, "plain_ms": plain_ms,
                               "library_ms": library_ms,
                               "bound_ms": b, "err": err,
                               **({"per_video_doc": per_video} if per_video
                                  else {})})

    def get(self, name):
        r = dict(self.k[name])
        r.pop("_by")
        return r

    def summary(self, name, what, card):
        """One line of the sums: kernel against library call and bound."""
        r = self.k[name]
        lib = r["library_ms"]
        vs = "" if not lib else f" (kernel {r['ms'] / lib:.2f}x its time)"
        if "library_ms_back_to_back" in r:
            vs += (f", back to back {r['library_ms_back_to_back']:.4f} ms "
                   f"(kernel {r['ms_back_to_back'] / r['library_ms_back_to_back']:.2f}"
                   f"x its time)")
        print(f"[kernels] {name} summed over {what}: kernel {r['ms']:.4f} "
              f"ms (back to back {r['ms_back_to_back']:.4f} ms), library "
              f"{lib if lib is None else f'{lib:.4f} ms'}{vs}, "
              f"bound {r['bound_ms']:.4f} ms (kernel at "
              f"{100 * r['bound_ms'] / r['ms']:.1f} % of it) ({card})")


def bench_request(n_text: int, image_size, rng):
    """(input_ids, views, image_size) of one request: a seeded prompt with
    the image marker after 8 text tokens (the bench.py protocol) and
    seeded preprocessed views for the image's anyres tiling."""
    from lavida_mod_tpu_torch.config import LaViDaConfig
    from lavida_mod_tpu_torch.data.anyres import anyres_grid_shape

    vcfg = LaViDaConfig().vision
    nw, nh = anyres_grid_shape(image_size, vcfg.grid_pinpoints,
                               vcfg.siglip.image_size)
    S = vcfg.siglip.image_size
    views = rng.uniform(-1, 1, (1 + nw * nh, 3, S, S)).astype(np.float32)
    text = rng.integers(3, 30000, size=n_text)
    ids = np.concatenate([text[:8], [-200], text[8:]])
    return ids, views, image_size


def phase_kernels(torch, device, res):
    """short_attention and gather_rows against their plain versions and
    the library calls at the bf16 path's shapes."""
    import torch.nn.functional as F

    from lavida_mod_tpu_torch import kernels
    from lavida_mod_tpu_torch.config import LaViDaConfig
    from lavida_mod_tpu_torch.models.multimodal import build_gather_plan
    from lavida_mod_tpu_torch.ops.gather import (gather_rows,
                                                 gather_rows_reference)
    from lavida_mod_tpu_torch.ops.short_attention import (
        short_attention, short_attention_reference)

    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=gen).to(
            torch.bfloat16)

    def segments(kind, B, T, S):
        """None; "valid": keys valid up to min(T, S - 3) (the prefill's
        padded tail); "pad": that, and the last 5 query rows match no key
        (a finite average over the S keys); "late": every query's first 260
        keys (two whole 128-key tiles and more) are masked, and every 5th
        query sees only those; "front": a bucketed prefill's ids
        (diffusion._prefill_into): the T - VIDEO_PREFIX front-pad rows 0,
        the prefix and the S - T answer rows of the cache 1."""
        if kind is None:
            return None, None
        if kind == "front":
            sq = (torch.arange(T, device=device) >= T - VIDEO_PREFIX).to(
                torch.int32)[None].expand(B, T).contiguous()
            kv = torch.cat([sq, sq.new_ones(B, S - T)], dim=1)
            return sq, kv
        sq = torch.ones(B, T, dtype=torch.int32, device=device)
        if kind == "late":
            kv = torch.arange(S, device=device) >= 260
            sq[:, ::5] = 0
        else:
            kv = torch.arange(S, device=device) < min(T, S - 3)
            if kind == "pad":
                sq[:, -5:] = 2
        return sq, kv.to(torch.int32)[None].expand(B, S).contiguous()

    # (name, q shape, kv shape, segments, launches per request[, launches
    # per video document of phase 7a]); after the two main shapes the edges
    # of the wgmma design: S = 1, S shorter than one 128-key stage, S one
    # past a tile multiple, hd 16 / 48 / 72 / 80 / 96 / 128 (16, 80 and 96
    # end in a narrow box, 72 and 48 are padded in shared memory), G = 1, 4
    # and 7, rows whose first K/V tiles are all masked; last the eval
    # phase's video document, weighed 0 in the bench request's sums
    cases = [
        ("siglip", (5, 729, 16, 72), (5, 729, 16, 72), None, SIGLIP_LAYERS),
        ("prefill", (1, 1056, 32, 128), (1, 1088, 32, 128), "valid",
         LLADA_LAYERS),
        ("gqa_odd", (2, 77, 8, 128), (2, 131, 2, 128), "pad", 0),
        ("gqa_odd_hd72", (1, 65, 4, 72), (1, 63, 2, 72), "pad", 0),
        ("s1", (1, 37, 4, 64), (1, 1, 4, 64), None, 0),
        ("s1_g4", (1, 37, 4, 128), (1, 1, 1, 128), "pad", 0),
        ("short_hd16", (2, 50, 4, 16), (2, 50, 4, 16), None, 0),
        ("tile_plus1_g7_hd48", (2, 65, 14, 48), (2, 129, 2, 48), None, 0),
        ("g7_hd80", (1, 200, 7, 80), (1, 257, 1, 80), "pad", 0),
        ("g4_hd96", (2, 300, 8, 96), (2, 333, 2, 96), "pad", 0),
        ("late_g4_hd72", (1, 130, 8, 72), (1, 300, 2, 72), "late", 0),
        ("late_g1_hd128", (1, 129, 4, 128), (1, 300, 4, 128), "late", 0),
        # SHIRG's two 448^2 views (32 x 32 patches), timed beside SDPA but
        # weighed 0 in the bench request's sums
        ("shirg_views", (2, 1024, 16, 72), (2, 1024, 16, 72), None, 0),
        ("video_tower", (EVAL_FRAMES, 729, 16, 72),
         (EVAL_FRAMES, 729, 16, 72), None, 0, SIGLIP_LAYERS),
        ("video_prefill", (1, VIDEO_PREFIX_ROWS, 32, 128),
         (1, VIDEO_PREFIX_ROWS + EVAL_G, 32, 128), "front", 0, LLADA_LAYERS),
    ] + [(name, shape, shape, None, 0)   # phase 19's towers, timed beside
         for name, shape in TOWER_SHAPES.items()]     # SDPA, weighed 0
    for name, qs, ks, kind, per_request, *per_video in cases:
        per_video = per_video[0] if per_video else 0
        q, k, v = randn(*qs), randn(*ks), randn(*ks)
        sq, skv = segments(kind, qs[0], qs[1], ks[1])
        out = short_attention(q, k, v, sq, skv)
        torch.cuda.synchronize()
        ref = short_attention_reference(q, k, v, sq, skv)
        # p is rounded to bf16 per streamed tile (the plain version rounds
        # its single-pass p) and the online rescaling reorders the sums.
        # Read on an H100: 1.95e-3 - 3.9e-3 (one bf16 ulp of |o| < 1); the
        # limit is 2-3x that, plus two ulps of a large |o|
        torch.testing.assert_close(out.float(), ref.float(), atol=8e-3,
                                   rtol=8e-3)
        err = (out.float() - ref.float()).abs().max().item()
        o_abs = ref.float().abs()
        note = (f" (limit 8e-3 + 8e-3 |o|; |o| mean {o_abs.mean().item():.3f}"
                f", max {o_abs.max().item():.3f})")
        plain_ms = cuda_ms(
            lambda: short_attention_reference(q, k, v, sq, skv))
        lib_ms = lib_b2b = None
        if per_request or per_video or name == "shirg_views" \
                or name in TOWER_SHAPES:
            # one library call of the same function on the same inputs:
            # SDPA with the segment mask as a boolean attention mask
            mask = None if sq is None else (
                sq[:, None, :, None] == skv[:, None, None, :])
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)

            lib_ms = cuda_ms(sdpa)
            # the wrapper passes three to six TMA tensor maps per call
            host = host_us(lambda: short_attention(q, k, v, sq, skv))
            lib_b2b = cuda_ms(sdpa, hold=False)
            note += (f"; host per call {host:.1f} us, SDPA's "
                     f"{host_us(sdpa):.1f} us; SDPA back to back "
                     f"{lib_b2b:.4f} ms")
        B, T, H, hd = qs
        keys = ks[1] if skv is None else int(skv[0].sum())
        res.add("short_attention", f"{name} q{qs} kv{ks}", per_request, err,
                lambda: short_attention(q, k, v, sq, skv), plain_ms, lib_ms,
                4 * B * H * T * keys * hd,
                2 * (q.numel() + k.numel() + v.numel() + q.numel()),
                note=note, library_b2b=lib_b2b, per_video=per_video)
    _short_attention_f32(torch, device, res)

    ids, views, size = bench_request(48, (640, 640),
                                     np.random.default_rng(0))
    idx, text_ids, _, _ = build_gather_plan(LaViDaConfig(), [ids],
                                            [[views.shape[0]]], [[size]])
    # the splice table: 980 vision tokens, newline, text slots, zero row
    table = randn(views.shape[0] * 196 + 1 + text_ids.shape[1] + 1, 4096)
    out = gather_rows(table, idx[0])
    torch.cuda.synchronize()
    ref = gather_rows_reference(table, torch.as_tensor(idx[0], device=device))
    if not torch.equal(out, ref):
        raise AssertionError("gather_rows differs from table[idx]")
    odd = randn(50, 13)                   # 26-byte rows: the narrow path
    odd_idx = np.arange(49, -1, -3)
    if not torch.equal(gather_rows(odd, odd_idx),
                       odd[torch.as_tensor(odd_idx, device=device)]):
        raise AssertionError("gather_rows differs on 13-wide bf16 rows")
    # both timed from the host plan: range check / upload included
    g_plain = cuda_ms(lambda: gather_rows_reference(
        table, torch.as_tensor(idx[0]).to(device)))
    # the kernel alone, and the library call, on an index on the card
    idx_dev = torch.as_tensor(idx[0], device=device)
    out = torch.empty_like(ref)
    lib = kernels.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    g_kernel = cuda_ms(lambda: kernels.check(lib.lavida_gather_rows(
        table.data_ptr(), idx_dev.data_ptr(), 8, out.data_ptr(),
        idx.shape[1], table.shape[1] * 2, stream), "gather_rows"))
    g_lib = cuda_ms(lambda: torch.index_select(table, 0, idx_dev))
    T = idx.shape[1]
    res.add("gather_rows", f"splice table{tuple(table.shape)} idx[{T}]", 1,
            0.0, lambda: gather_rows(table, idx[0]), g_plain, g_lib, 0, 2 * T * 4096 * 2 + 8 * T,
            note=f" (exact; kernel alone {g_kernel:.4f} ms)")


def _short_attention_f32(torch, device, res):
    """#1's f32 instance (3xTF32 on the tensor cores) against its plain
    version in f32 (TF32 off) at kernel_times.py's SHORT_F32_CASES: the
    SHIRG-LoRA harness's tower shape (B = 2: four 448^2 views, 26 launches
    per step) and a ragged GQA case with rows that see no key; SDPA in f32
    as the library call.  The bound is the 3xTF32 floor; the FFMA figure
    (the operations once at the f32 rate of 67 TFLOP/s, the bound of the
    first, FFMA design) is printed beside it."""
    import torch.nn.functional as F

    from lavida_mod_tpu_torch.ops.short_attention import (
        short_attention, short_attention_reference)

    gen = torch.Generator(device=device).manual_seed(5)
    for name, qs, ks, kind, per_step in SHORT_F32_CASES:
        q, k, v, sq, skv = short_f32_inputs(torch, device, gen, qs, ks, kind)
        out = short_attention(q, k, v, sq, skv)
        torch.cuda.synchronize()
        ref = short_attention_reference(q, k, v, sq, skv)
        # 3xTF32 products (f32's accuracy), summed in another order than the
        # plain version's matmuls: the JAX f32 tolerance of the kernel tests
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
        err = (out - ref).abs().max().item()
        plain_ms = cuda_ms(lambda: short_attention_reference(q, k, v, sq,
                                                             skv))
        mask = None if sq is None else (sq[:, None, :, None]
                                        == skv[:, None, None, :])
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        G = qs[2] // ks[2]
        if G > 1:
            kt, vt = (t.repeat_interleave(G, 1) for t in (kt, vt))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        lib_ms = cuda_ms(sdpa)
        B, T, H, hd = qs
        keys = ks[1] if skv is None else int(skv[0].sum())
        ops = 4 * B * H * T * keys * hd
        nbytes = 4 * (q.numel() + k.numel() + v.numel() + q.numel())
        ffma = short_f32_bounds_ms(ops, nbytes)[1]
        res.add("short_attention_f32", f"{name} q{qs} kv{ks} f32", per_step,
                err, lambda: short_attention(q, k, v, sq, skv), plain_ms,
                lib_ms, ops, nbytes, f32=True,
                note=f" (limit 2e-5 + 2e-5 |o|; bound: the 3xTF32 floor, "
                     f"the FFMA figure {ffma:.4f} ms)")

def bench_requests(rng):
    """The three bench-protocol requests of the main paths."""
    first = bench_request(48, (640, 640), rng)
    return [first, bench_request(48, (1100, 380), rng),
            (np.concatenate([first[0][:9], first[0][9:30]]), first[1],
             first[2])]


GEN = dict(max_new_tokens=32, block_length=32, step_per_block=16,
           prefix_lm=True, remasking="low_confidence")
STEPS = GEN["step_per_block"]


def phase_main_path(torch, device, card):
    """Three full-width requests through generate_fused, bf16 layout."""
    from lavida_mod_tpu_torch.config import GenerationConfig, LaViDaConfig
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.models.multimodal import build_gather_plan
    from lavida_mod_tpu_torch.ops.decode_attention import decode_attention
    from lavida_mod_tpu_torch.ops.gather import gather_rows
    from lavida_mod_tpu_torch.ops.short_attention import short_attention

    cfg = LaViDaConfig()
    t0 = time.perf_counter()
    model = LaViDa.random_init(cfg, 0, torch.bfloat16, device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[main] LaViDaConfig() bf16 random init on {card}: "
          f"{n_params / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.2f} s")
    gen = GenerationConfig(**GEN)
    requests = bench_requests(np.random.default_rng(0))
    first = requests[0]
    model.generate_fused(first[0], [first[1]], [first[2]], gen)  # warm-up
    torch.cuda.synchronize()

    short_attention.launches = 0
    gather_rows.launches = 0
    decode_attention.launches = 0
    walls = []
    for i, (ids, views, size) in enumerate(requests):
        a0, g0 = short_attention.launches, gather_rows.launches
        d0 = decode_attention.launches
        idx, _, _, _ = build_gather_plan(cfg, [ids], [[views.shape[0]]],
                                         [[size]])
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate_fused(ids, [views], [size], gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls.append(wall)
        peak = torch.cuda.max_memory_allocated() / 2**30
        da = short_attention.launches - a0
        dg = gather_rows.launches - g0
        dd = decode_attention.launches - d0
        print(f"[main] request {i}: image {size} -> {views.shape[0]} views, "
              f"{len(ids) - 1} text tokens, P={idx.shape[1]}, G=32: "
              f"wall {wall * 1e3:.1f} ms, peak {peak:.2f} GiB, "
              f"launches short_attention {da} gather_rows {dg} "
              f"decode_attention {dd} ({card}); tokens {out.tolist()}")
        if out.shape != (32,):
            raise AssertionError(f"output shape {out.shape}")
        if (out == cfg.llada.mask_token_id).any():
            raise AssertionError("mask tokens left in the output")
        if da != SIGLIP_LAYERS + LLADA_LAYERS or dg != 1 \
                or dd != LLADA_LAYERS * STEPS:
            raise AssertionError(f"launches short_attention {da} "
                                 f"gather_rows {dg} decode_attention {dd}, "
                                 f"want 58, 1 and 512")
    counts = {"short_attention": short_attention.launches,
              "gather_rows": gather_rows.launches,
              "decode_attention": decode_attention.launches}
    return model, requests, counts, walls


PROJECTOR_KINDS = ("linear", "mlp2x_res2x_gelu")


def phase_projector_kinds(torch, model, requests, card):
    """Phase 4's bf16 8B model with its projector replaced by each other
    kind that keeps the token count (models/projector.py), seeded random
    weights drawn on the card, phase 4's LLaDA and SigLIP kept: the first
    bench request through generate_fused, checked as phase 4 checks it
    (no mask token left, 26 + 32 short_attention, 1 gather_rows and
    32 x 16 decode_attention, no other launch); the model's own projector
    restored after."""
    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.models.projector import Projector
    from lavida_mod_tpu_torch.models.siglip import LayerNorm

    cfg0, proj0 = model.cfg, model.projector
    D, mm = cfg0.llada.d_model, cfg0.vision.mm_hidden_size
    gen = GenerationConfig(**GEN)
    ids, views, size = requests[0]
    out = {}
    try:
        for i, kind in enumerate(PROJECTOR_KINDS):
            g = torch.Generator(device=model.device).manual_seed(100 + i)
            proj = Projector(kind, mm, D, model.device, torch.bfloat16)
            with torch.no_grad():
                for m in proj.modules():
                    if isinstance(m, torch.nn.Linear):
                        m.weight.normal_(0.0, 0.02, generator=g)
                        m.bias.zero_()
                    elif isinstance(m, LayerNorm):
                        m.weight.fill_(1.0)
                        m.bias.zero_()
            model.projector = proj
            model.cfg = cfg0.replace(vision=cfg0.vision.replace(
                projector_type=kind))
            toks, wall, peak, counts = _counted(
                torch, lambda: model.generate_fused(ids, [views], [size],
                                                    gen))
            _check(f"projector {kind}", counts, _want(
                short_attention=SIGLIP_LAYERS + LLADA_LAYERS,
                gather_rows=1, decode_attention=LLADA_LAYERS * STEPS), toks,
                mask_id=cfg0.llada.mask_token_id)
            n = sum(p.numel() for p in proj.parameters())
            print(f"[projector] {kind} ({n / 1e6:.1f} M params, "
                  f"{len(proj.res_blocks)} residual blocks) on phase 4's "
                  f"bf16 8B: request 0 wall {wall * 1e3:.1f} ms, peak "
                  f"{peak:.2f} GiB, launches {_nonzero(counts)} ({card}); "
                  f"tokens {toks.tolist()}")
            out[kind] = {"wall": wall, "peak": peak,
                         "counts": _nonzero(counts)}
    finally:
        model.projector, model.cfg = proj0, cfg0
    return out


def phase_small_reference(torch, device):
    """A tiny model in bf16 on the card against the same weights in f32 on
    the CPU, which runs the plain versions the CPU tests hold to the JAX
    package."""
    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.models.multimodal import (build_gather_plan,
                                                        multimodal_embeds)
    from lavida_mod_tpu_torch.predict import tiny_config

    cfg = tiny_config()
    cpu = LaViDa.random_init(cfg, 0, torch.float32, "cpu")
    with torch.no_grad():
        for p in cpu.parameters():       # diverse tokens, as in the tests
            if p.dim() >= 2:
                p.mul_(10.0)
    gpu = LaViDa(cfg, device=device, dtype=torch.bfloat16)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(3)
    views = rng.standard_normal((5, 3, 56, 56)).astype(np.float32)
    ids = np.array([5, 6, -200, 7, 8, 9])
    idx, text_ids, _, _ = build_gather_plan(cfg, [ids], [[5]], [[(100, 60)]])
    with torch.no_grad():
        outs = []
        for m in (cpu, gpu):
            pix = torch.as_tensor(views, device=m.device)
            prefix = multimodal_embeds(m, pix, text_ids, idx)
            logits, _ = m.llada(prefix, use_flash=True)
            outs.append(logits.float().cpu())
    rel = ((outs[1] - outs[0]).abs().max() / outs[0].abs().max()).item()
    gen = GenerationConfig(max_new_tokens=16, block_length=8)
    a = cpu.generate_fused(ids, [views], [(100, 60)], gen)
    b = gpu.generate_fused(ids, [views], [(100, 60)], gen)
    agree = float((a == b).mean())
    print(f"[check] tiny model, bf16 on the card vs f32 on the CPU: "
          f"prefix-forward logits max|diff|/max|ref| {rel:.3e} (limit "
          f"5e-2), generated tokens agree {agree:.2f}")
    if not np.isfinite(rel) or rel > 5e-2:
        raise AssertionError(f"tiny-model logits differ: {rel}")


def _w4_weights(torch, tq, randn, K, N):
    packed, scales, _ = tq.quantize_linear4(randn(N, K, scale=0.02))
    return packed[:N // 8].contiguous(), scales[:, :N].contiguous()


def _w4_bytes(K, N):
    """Bytes of a grouped int4 weight: codes and f32 group scales."""
    return K * N // 2 + (K // 128) * N * 4


def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def phase_quant_kernels(torch, device, res):
    """The four kernels of the mixed layout against their plain versions
    at every shape of its main path (summed over one request's launches),
    plus a ragged/odd case each; w4_qkv_norm also at the batched path's
    fused head ([128, 4096] x 126464, once per decode step)."""
    from lavida_mod_tpu_torch.ops import quant as tq
    from lavida_mod_tpu_torch.ops import w4_fused as tw
    from lavida_mod_tpu_torch.ops import w8a8 as t8

    gen = torch.Generator(device=device).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=device, generator=gen) * scale

    # w8a8: the prefill's four linears at T = 1056, 32 layers; bit-exact;
    # then the wgmma tiles' edges: one row, one 16-byte K slice, ragged K
    # (4304 = 33 slices + 80 bytes), ragged and odd N; last the four at the
    # eval phase's video prefill (T = VIDEO_PREFIX_ROWS, 32 launches each
    # per video document), weighed 0 in the request's sums
    video = [(VIDEO_PREFIX_ROWS, K, N, 0, LLADA_LAYERS)
             for K, N in ((4096, 12288), (4096, 4096), (4096, 24576),
                          (12288, 4096))]
    for T, K, N, per, *per_video in [
            (1056, 4096, 12288, LLADA_LAYERS),
            (1056, 4096, 4096, LLADA_LAYERS),
            (1056, 4096, 24576, LLADA_LAYERS),
            (1056, 12288, 4096, LLADA_LAYERS),
            (77, 4304, 1000, 0), (1, 4096, 4096, 0),
            (7, 16, 24, 0), (33, 4304, 1001, 0), (1, 16, 1, 0), *video]:
        per_video = per_video[0] if per_video else 0
        x = randn(T, K).bfloat16()
        q, sc = tq.quantize_linear(randn(N, K, scale=0.02))
        x8, sx = t8.act_quant(x, t8.ACT_FORMULA_W8)
        out = t8.w8a8_matmul(x8, sx, q, sc)
        torch.cuda.synchronize()
        ref = t8.w8a8_matmul_reference(x8, sx, q, sc)
        if not torch.equal(out, ref):
            raise AssertionError(f"w8a8_matmul differs at {(T, K, N)}")
        lib_ms, lib_b2b, note = None, None, " (exact)"
        if per or per_video:
            # the int8 product in one library call (cuBLASLt through
            # torch._int_mm), then the f32 scale epilogue as a second op
            qt = q.t()
            try:
                torch._int_mm(x8, qt)
            except RuntimeError:      # a build that takes row-major only
                qt = qt.contiguous()

            def library():
                return (torch._int_mm(x8, qt).float() * sx * sc).bfloat16()

            lib_ms = cuda_ms(library)
            # the wrapper passes two TMA tensor maps per call
            host = host_us(lambda: t8.w8a8_matmul(x8, sx, q, sc))
            lib_b2b = cuda_ms(library, hold=False)
            note += (f"; host per call {host:.1f} us, the library's "
                     f"{host_us(library):.1f} us; library back to back "
                     f"{lib_b2b:.4f} ms")
        res.add("w8a8_matmul", f"[{T},{K}]x[{K},{N}]", per, 0.0,
                lambda: t8.w8a8_matmul(x8, sx, q, sc),
                cuda_ms(lambda: t8.w8a8_matmul_reference(x8, sx, q, sc), 5),
                lib_ms, 2 * T * K * N, T * K + N * K + 4 * (T + N) + 2 * T * N,
                int8=True, note=note, library_b2b=lib_b2b,
                per_video=per_video)

    # w4_qkv_norm: [q|k|v] per layer per step and the head per step
    # (mixed path, 32 rows), the batched path's fused head (128 rows)
    for T, D, N, per in [(32, 4096, 12288, LLADA_LAYERS * STEPS),
                         (32, 4096, 126464, STEPS),
                         (128, 4096, 126464, 0), (40, 384, 160, 0)]:
        x = randn(T, D).bfloat16()
        nw = (1 + randn(D, scale=0.1)).bfloat16()
        packed, scales = _w4_weights(torch, tq, randn, D, N)
        out = tw.w4_qkv_norm(x, nw, packed, scales, 1e-5)
        torch.cuda.synchronize()
        ref = tw.w4_qkv_norm_reference(x, nw, packed, scales, 1e-5)
        err = _rel(out, ref)
        # the norm's sum of squares reduces in another order: an int8
        # code on a rounding boundary may move by one
        if not err < 1e-2:
            raise AssertionError(f"w4_qkv_norm {(T, D, N)}: {err}")
        res.add("w4_qkv_norm", f"[{T},{D}]x[{D},{N}]", per, err,
                lambda: tw.w4_qkv_norm(x, nw, packed, scales, 1e-5),
                cuda_ms(lambda: tw.w4_qkv_norm_reference(
                    x, nw, packed, scales, 1e-5), 3), None, 2 * T * D * N,
                2 * T * D + 2 * D + _w4_bytes(D, N) + 2 * T * N, int8=True,
                note=" (relative, limit 1e-2)")
    # 20 calls back to back, each on the output of the one before ([32,
    # 4096] x 4096), no sync between them: each matched to its plain version
    nw = (1 + randn(4096, scale=0.1)).bfloat16()
    w = _w4_weights(torch, tq, randn, 4096, 4096)
    chain = [randn(32, 4096).bfloat16()]
    for _ in range(20):
        chain.append(tw.w4_qkv_norm(chain[-1], nw, *w, 1e-5))
    torch.cuda.synchronize()
    err = max(_rel(out, tw.w4_qkv_norm_reference(x, nw, *w, 1e-5))
              for x, out in zip(chain[:-1], chain[1:]))
    if not err < 1e-2:
        raise AssertionError(f"w4_qkv_norm back to back: {err}")
    print(f"[kernels] w4_qkv_norm 20 chained calls without a sync: max "
          f"err {err:.3e} (relative, limit 1e-2)")

    for T, K, N, per in [(32, 4096, 4096, LLADA_LAYERS * STEPS),
                         (5, 384, 96, 0)]:
        a, r = randn(T, K).bfloat16(), randn(T, N).bfloat16()
        packed, scales = _w4_weights(torch, tq, randn, K, N)
        out = tw.w4_matmul_res(a, r, packed, scales)
        torch.cuda.synchronize()
        ref = tw.w4_matmul_res_reference(a, r, packed, scales)
        if not torch.equal(out, ref):
            raise AssertionError(f"w4_matmul_res differs at {(T, K, N)}")
        res.add("w4_matmul_res", f"[{T},{K}]x[{K},{N}]", per, 0.0,
                lambda: tw.w4_matmul_res(a, r, packed, scales),
                cuda_ms(lambda: tw.w4_matmul_res_reference(
                    a, r, packed, scales), 5), None, 2 * T * K * N,
                2 * T * K + _w4_bytes(K, N) + 4 * T * N, int8=True,
                note=" (exact)")
    # 20 calls back to back, each output the next one's `a` ([32, 4096] x
    # 4096), no sync between them: each equal to its plain version
    w = _w4_weights(torch, tq, randn, 4096, 4096)
    r = randn(32, 4096).bfloat16()
    chain = [randn(32, 4096).bfloat16()]
    for _ in range(20):
        chain.append(tw.w4_matmul_res(chain[-1], r, *w))
    torch.cuda.synchronize()
    if not all(torch.equal(out, tw.w4_matmul_res_reference(a, r, *w))
               for a, out in zip(chain[:-1], chain[1:])):
        raise AssertionError("w4_matmul_res back to back differs")
    print("[kernels] w4_matmul_res 20 chained calls without a sync: exact")

    # w4_ffn_fused: the decode FFN at 8 / 16 / 24 / 32 rows (32 on the
    # main path, once per layer per step), 40 (two 32-row slices) and a
    # padded down K; each case twice with new data at the same addresses
    weights = {}
    for T, D, H, Hd, per in [(8, 4096, 12288, 12288, 0),
                             (16, 4096, 12288, 12288, 0),
                             (24, 4096, 12288, 12288, 0),
                             (32, 4096, 12288, 12288, LLADA_LAYERS * STEPS),
                             (40, 4096, 12288, 12288, 0),
                             (24, 256, 384, 512, 0)]:
        if (D, H, Hd) not in weights:
            up_p, up_s = _w4_weights(torch, tq, randn, D, 2 * H)
            dn_p, dn_s, _ = tq.quantize_linear4(torch.nn.functional.pad(
                randn(D, H, scale=0.02), (0, Hd - H)))
            weights[D, H, Hd] = ((1 + randn(D, scale=0.1)).bfloat16(),
                                 up_p, up_s, dn_p[:D // 8].contiguous(),
                                 dn_s[:, :D].contiguous())
        x = torch.empty(T, D, dtype=torch.bfloat16, device=device)
        args = (x, *weights[D, H, Hd], 1e-5)
        err = 0.0
        for _ in range(2):
            x.copy_(randn(T, D))
            out = tw.w4_ffn_fused(*args)
            torch.cuda.synchronize()
            err = max(err, _rel(out, tw.w4_ffn_fused_reference(*args)))
            if not err < 2e-2:
                raise AssertionError(f"w4_ffn_fused {(T, D, H, Hd)}: {err}")
        res.add("w4_ffn_fused", f"[{T},{D}] H {H} Hd {Hd}", per, err,
                lambda: tw.w4_ffn_fused(*args),
                cuda_ms(lambda: tw.w4_ffn_fused_reference(*args), 5), None,
                2 * T * D * 2 * H + 2 * T * Hd * D,
                4 * T * D + 2 * D + _w4_bytes(D, 2 * H) + _w4_bytes(Hd, D),
                int8=True, note=" (relative, limit 2e-2)")
    # 20 calls back to back, each on the output of the one before, no sync
    # between them: each matched to its plain version afterwards
    chain = [randn(32, 4096).bfloat16()]
    for _ in range(20):
        chain.append(tw.w4_ffn_fused(chain[-1], *weights[4096, 12288, 12288],
                                     1e-5))
    torch.cuda.synchronize()
    err = max(_rel(out, tw.w4_ffn_fused_reference(
        x, *weights[4096, 12288, 12288], 1e-5))
        for x, out in zip(chain[:-1], chain[1:]))
    if not err < 2e-2:
        raise AssertionError(f"w4_ffn_fused back to back: {err}")
    print(f"[kernels] w4_ffn_fused 20 chained calls without a sync: max "
          f"err {err:.3e} (relative, limit 2e-2)")


# #11's cases checked beside the timed ones (kernel_times.W4MM_CASES): the
# plans' edges (64 rows, the decode plan's last; 65, the prefill plan's
# first), a split decode at a width TMA refuses (N % 16 = 8), a prefill of
# ragged row blocks with splits, and K/2 and N odd (2-byte x loads, byte
# weight loads)
W4MM_EDGES = [(64, 4096, 12288), (65, 4096, 12288), (32, 4096, 1000),
              (300, 4096, 1000), (3, 38, 37)]


def _w4mm_inputs(torch, device, gen, T, K, N):
    x = torch.randn(T, K, device=device, generator=gen).bfloat16()
    codes = torch.randint(-8, 8, (K, N), device=device, generator=gen)
    packed = ((codes[1::2] & 0xF) << 4 | (codes[0::2] & 0xF)).to(
        torch.uint8).view(torch.int8).contiguous()
    scale = torch.rand(N, device=device, generator=gen) * 0.01 + 0.005
    return x, codes, packed, scale


def _w4mm_check(torch, t4, out, x2, packed, scale):
    """The largest error of #11's `out` against its plain version; raises
    beyond one bf16 ulp of the larger side plus the bound on two f32 orders
    of the same dot (2 K 2^-24 sum|x w| scale, for near-cancelling
    outputs: the kernel sums the lo and hi products, split by split, in one
    accumulator).  Returns (error, the plain output)."""
    ref = t4.w4_matmul_reference(x2, packed, scale)
    lo, hi = t4.unpack_nibbles(packed)
    sabs = (x2[0].float().abs() @ lo.abs().float()
            + x2[1].float().abs() @ hi.abs().float()) * scale
    big = torch.maximum(out.float().abs(), ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8)
    diff = (out.float() - ref.float()).abs()
    K = 2 * x2.shape[2]
    if (diff > ulp + 2 * K * 2.0 ** -24 * sabs).any():
        raise AssertionError(f"w4_matmul beyond 1 bf16 ulp at "
                             f"{(x2.shape[1], K, packed.shape[1])}")
    return diff.max().item(), ref


def phase_w4_matmul(torch, device, res):
    """Kernel #11 against its plain version at the TPU status note's decode
    shape, the prefill's rows and a ragged case (timed; the decode shape
    also with its weights cold in L2), and at W4MM_EDGES.  No path launches
    it, so its sums are one call at each of the first two shapes.  Returns
    the decode shape's cold time."""
    from lavida_mod_tpu_torch.kernel_times import (W4MM_CASES,
                                                    W4MM_COLD_BYTES,
                                                    int4pack_library)
    from lavida_mod_tpu_torch.ops import w4_matmul as t4

    gen = torch.Generator(device=device).manual_seed(3)
    cold = None
    for name, T, K, N in W4MM_CASES:
        x, codes, packed, scale = _w4mm_inputs(torch, device, gen, T, K, N)
        x2 = t4.split_even_odd(x)
        out = t4.w4_matmul(x2, packed, scale)
        torch.cuda.synchronize()
        err, ref = _w4mm_check(torch, t4, out, x2, packed, scale)
        p = t4.plan(T, K // 2, N, torch.cuda.get_device_properties(
            device).multi_processor_count)
        note = (f" (within 1 bf16 ulp; plan {p.regime}, {p.bt} rows x "
                f"{p.row_blocks}, {p.splits} K splits, {p.ctas} CTAs)")
        lib_ms = None
        fn, got, _ = int4pack_library(torch, x, codes, scale)
        if fn is None:
            note += f"; library none: {got}"
        else:
            lib_err = _rel(got, ref)
            if lib_err < 2e-2:   # its bf16 scale rounds: not exact
                lib_ms = cuda_ms(fn)
                note += f"; library relative err {lib_err:.2e}"
            else:
                note += (f"; library none: tinygemm's layout gave "
                         f"relative err {lib_err:.2e}")
        del got
        if name == "decode":   # weight copies cycled past the 50 MB L2
            n = max(3, -(-int(W4MM_COLD_BYTES) // (packed.numel() + 4 * N)))
            ws = [(packed, scale)] + [(packed.clone(), scale.clone())
                                      for _ in range(n - 1)]
            it = iter(range(1 << 62))
            cold = cuda_ms(lambda: t4.w4_matmul(x2, *ws[next(it) % n]))
            note += f"; cold in L2 ({n} weight copies) {cold:.4f} ms"
            del ws
        res.add("w4_matmul", f"[{T},{K}]x[{K},{N}]", 0, err,
                lambda: t4.w4_matmul(x2, packed, scale),
                cuda_ms(lambda: t4.w4_matmul_reference(x2, packed, scale), 5),
                lib_ms, 2 * T * K * N, 2 * T * K + K * N // 2 + 4 * N + 2 * T * N,
                note=note, weight=int(name != "ragged"))
        del codes, ref
    for T, K, N in W4MM_EDGES:
        x, codes, packed, scale = _w4mm_inputs(torch, device, gen, T, K, N)
        x2 = t4.split_even_odd(x)
        out = t4.w4_matmul(x2, packed, scale)
        torch.cuda.synchronize()
        err, _ = _w4mm_check(torch, t4, out, x2, packed, scale)
        p = t4.plan(T, K // 2, N, torch.cuda.get_device_properties(
            device).multi_processor_count)
        print(f"[kernels] w4_matmul [{T},{K}]x[{K},{N}]: err {err:.3e} "
              f"(within 1 bf16 ulp; plan {p.regime}, {p.bt} rows x "
              f"{p.row_blocks}, {p.splits} K splits, {p.ctas} CTAs)")
    return cold


# the decode attention over the bf16 cache: (B, T, H, Hkv, hd, S), launches
# per main-path run (one bf16 request: 32 layers x 16 steps over about
# 1088 keys).  The batched serving step (no key split), bench.py's B = 1
# request (its keys split, then merged), Dream-7B's GQA batched and at
# B = 1 (split)
DECODE_CASES = [((32, 32, 32, 32, 128, 1184), 0),
                ((1, 32, 32, 32, 128, 1088), LLADA_LAYERS * STEPS),
                ((32, 32, 28, 4, 128, 1184), 0),
                ((1, 32, 28, 4, 128, 1184), 0)]
# its limit against the plain version: about one bf16 ulp of an output
# near 1 (the kernel rounds p against its running max)
DECODE_LIMIT = 4e-3

# #8's int4 instance: (B, T, H, Hkv, hd, S, row 0's pad), launches per run
# (one B = 4 worker batch: 32 layers x 16 steps)
KV4_CASES = [((4, 32, 32, 32, 128, 1184, None), LLADA_LAYERS * STEPS),
             ((8, 32, 32, 32, 128, 1184, None), 0),
             ((1, 32, 32, 32, 128, 1088, None), 0),
             ((4, 32, 28, 4, 128, 1184, None), 0),
             ((2, 32, 16, 1, 128, 300, None), 0),
             ((2, 32, 8, 8, 16, 300, 5), 0),
             ((2, 16, 8, 4, 32, 200, 3), 0),
             ((2, 32, 4, 4, 64, 6401, None), 0),
             ((1, 32, 8, 8, 128, 16384, 700), 0),
             ((2, 32, 8, 8, 256, 500, 9), 0),
             ((2, 32, 32, 32, 128, 1184, -1), 0)]


def phase_batch_kernels(torch, device, res):
    """The three kernels of the batched int4 path against their plain
    versions at its shapes (summed over one B = 4 batch's launches; the
    B = 8 shapes and a ragged case checked too), and the decode attention
    over the bf16 cache at DECODE_CASES."""
    from lavida_mod_tpu_torch.ops import decode_attention as tda
    from lavida_mod_tpu_torch.ops import kv8_attention as tk
    from lavida_mod_tpu_torch.ops.attention import dense_attention, make_bias
    from lavida_mod_tpu_torch.ops import quant as tq
    from lavida_mod_tpu_torch.ops import vit_mlp as tv
    from lavida_mod_tpu_torch.ops import w4_grouped as tg

    gen = torch.Generator(device=device).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=device, generator=gen) * scale

    # w4_matmul_grouped at B = 4: the prefill (T = 4 x 1152 rows, the
    # bench image's bucket) and the decode steps (T = 4 x 32); at B = 8 the
    # chunk-2 prefill (2304 rows), the decode (256) and its unfused head;
    # the decode kernel also at every other multiple of 32 rows it serves
    # (B = 1, 2, 3, 5, 7), a tiny width (3 k-blocks of 2 groups) and a Dream
    # width (K = 18944: 37 k-blocks of 4 groups, the codes without the K
    # pad); the prefill kernel also at a ragged 1153 rows of the down
    # projection and at the Dream width (300 rows).  Summed per regime:
    # T <= 256 rows the decode kernel, more the prefill kernel.
    lin = [(4096, 4096, 4), (4096, 12288, 2), (12288, 4096, 1)]
    cases = [(T, K, N, per * (1 if T > 256 else STEPS))
             for T in (4608, 128) for K, N, per in lin]
    cases += [(T, K, N, 0) for T in (2304, 256, 32, 64, 96, 160, 224)
              for K, N, _ in lin]
    cases += [(256, 4096, 126464, 0), (77, 768, 576, 0), (64, 18944, 3584, 0),
              (1153, 12288, 4096, 0), (300, 18944, 3584, 0)]
    weights = {}
    for T, K, N, per in cases:
        if (K, N) not in weights:
            if K % 4096 and K > 8192:     # no K pad: codes drawn directly
                codes = torch.randint(-8, 8, (K, N), device=device,
                                      generator=gen, dtype=torch.int8)
                weights[(K, N)] = (tq.pack_w4_frag(codes), torch.rand(
                    K // 128, N, device=device, generator=gen) * 0.01 + 1e-4)
            else:
                weights[(K, N)] = _w4_weights(torch, tq, randn, K, N)
        packed, scales = weights[(K, N)]
        x = randn(T, K).bfloat16()
        regime = tg.regime(T)
        before = getattr(tg.w4_matmul_grouped, f"{regime}_launches")
        out = tg.w4_matmul_grouped(x, packed, scales)
        torch.cuda.synchronize()
        if getattr(tg.w4_matmul_grouped, f"{regime}_launches") != before + 1:
            raise AssertionError(f"w4_matmul_grouped at {T} rows did not "
                                 f"take the {regime} kernel")
        ref = tg.w4_matmul_grouped_reference(x, packed, scales)
        if not torch.equal(out, ref):
            raise AssertionError(f"w4_matmul_grouped differs at {(T, K, N)}")
        res.add(f"w4_matmul_grouped_{regime}", f"[{T},{K}]x[{K},{N}]",
                per * LLADA_LAYERS,
                0.0, lambda: tg.w4_matmul_grouped(x, packed, scales),
                cuda_ms(lambda: tg.w4_matmul_grouped_reference(
                    x, packed, scales), 2 if T > 1000 else 3), None,
                2 * T * K * N, 2 * T * K + _w4_bytes(K, N) + 2 * T * N,
                int8=True, note=" (exact)")
    del weights

    # kv8_decode_attention: q [B, 32, 32, 128] over S = 1152 + 32 keys,
    # each batch row front-padded by its own amount; GQA and ragged cases,
    # a long cache (many key chunks), Dream-7B's GQA (28 / 4 heads: row
    # blocks and chunks) and a batch row with every key masked (-1: it
    # averages over all S, as the TPU kernel's row does); KV8_CASES
    for (B, T, H, Hkv, hd, S, pad0), per in zip(KV8_CASES,
                                                (1, 0, 0, 0, 0, 0, 0)):
        q, k8, ks, v8, vs, valid = kv8_case_inputs(torch, randn, B, T, H,
                                                   Hkv, hd, S, pad0)
        out = tk.kv8_decode_attention(q, k8, ks, v8, vs, valid)
        torch.cuda.synchronize()
        ref = tk.kv8_decode_attention_reference(q, k8, ks, v8, vs, valid)
        torch.testing.assert_close(out.float(), ref.float(), atol=6e-3,
                                   rtol=6e-3)
        err = (out.float() - ref.float()).abs().max().item()
        keys = int(valid.sum())
        res.add("kv8_decode_attention", f"q[{B},{T},{H},{hd}] Hkv {Hkv} S {S}"
                + ("" if pad0 is None else f" row 0 masked {pad0}"),
                per * LLADA_LAYERS * STEPS, err,
                lambda: tk.kv8_decode_attention(q, k8, ks, v8, vs, valid),
                cuda_ms(lambda: tk.kv8_decode_attention_reference(
                    q, k8, ks, v8, vs, valid), 5 if S < 8192 else 2), None,
                4 * H * T * keys * hd,
                2 * B * Hkv * S * (hd + 4) + 4 * q.numel() + B * S,
                note=" (limit 6e-3)")

    # kv8_decode_attention over the int4 cache (--kv4, the int4 instance):
    # the worker's B = 4 batch (its sums weigh this shape by one batch's
    # 32 x 16 launches), B = 8, one request's cache (S = 1088), Dream-7B's
    # GQA, G = 16, hd 16 (8-byte rows by cp.async), 32, 64 and 256, S = 6401 and
    # 16384 (key chunks), front-padded rows and a row with every key
    # masked; beside each, the int8 kernel at the same shape
    for (B, T, H, Hkv, hd, S, pad0), per in KV4_CASES:
        q, k4, ks, v4, vs, valid = kv8_case_inputs(
            torch, randn, B, T, H, Hkv, hd, S, pad0, bits=4)
        before = tk.kv8_decode_attention.int4_launches
        out = tk.kv8_decode_attention(q, k4, ks, v4, vs, valid)
        torch.cuda.synchronize()
        if tk.kv8_decode_attention.int4_launches != before + 1:
            raise AssertionError("the int4 cache did not take the int4 "
                                 "kernel")
        ref = tk.kv8_decode_attention_reference(q, k4, ks, v4, vs, valid)
        torch.testing.assert_close(out.float(), ref.float(), atol=6e-3,
                                   rtol=6e-3)
        err = (out.float() - ref.float()).abs().max().item()
        c8 = kv8_case_inputs(torch, randn, B, T, H, Hkv, hd, S, pad0)
        int8_ms = cuda_ms(lambda: tk.kv8_decode_attention(*c8))
        keys = int(valid.sum())
        name = "kv8_decode_attention_int4"
        res.add(name, f"q[{B},{T},{H},{hd}] Hkv {Hkv} S {S}"
                + ("" if pad0 is None else f" row 0 masked {pad0}"),
                per, err,
                lambda: tk.kv8_decode_attention(q, k4, ks, v4, vs, valid),
                cuda_ms(lambda: tk.kv8_decode_attention_reference(
                    q, k4, ks, v4, vs, valid), 5 if S < 8192 else 2), None,
                4 * H * T * keys * hd,
                2 * B * Hkv * S * (hd // 2 + 4) + 4 * q.numel() + B * S,
                note=f" (limit 6e-3; the int8 kernel at this shape "
                     f"{int8_ms:.4f} ms)")
        r = res.k[name]
        r["int8_kernel_ms"] = r.get("int8_kernel_ms", 0.0) + per * int8_ms
        r["per_shape"][-1]["int8_kernel_ms"] = int8_ms
        del q, k4, v4, c8

    # decode_attention against its plain version (the unsplit softmax) at
    # DECODE_CASES, each batch row front-padded by its own amount; beside
    # it the route it replaced, dense_attention with make_bias's mask (its
    # copies of the cache included), as the library call
    for (B, T, H, Hkv, hd, S), per in DECODE_CASES:
        q = randn(B, T, H, hd).bfloat16()
        k, v = randn(B, S, Hkv, hd).bfloat16(), randn(B, S, Hkv, hd).bfloat16()
        valid = torch.ones(B, S, dtype=torch.bool, device=device)
        for b in range(B):
            valid[b, :(37 * b) % (S // 4)] = False
        bias = make_bias(kv_valid=valid)
        before = tda.decode_attention.launches
        out = tda.decode_attention(q, k, v, valid)
        torch.cuda.synchronize()
        if tda.decode_attention.launches != before + 1:
            raise AssertionError("decode_attention did not launch")
        ref = tda.decode_attention_reference(q, k, v, valid)
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=DECODE_LIMIT, rtol=DECODE_LIMIT)
        err = (out.float() - ref.float()).abs().max().item()
        plan = tda.decode_plan(B, T, H, Hkv, S, hd, tda._sms(device.index))
        res.add("decode_attention", f"q[{B},{T},{H},{hd}] Hkv {Hkv} S {S}",
                per, err, lambda: tda.decode_attention(q, k, v, valid),
                cuda_ms(lambda: tda.decode_attention_reference(
                    q, k, v, valid), 3),
                cuda_ms(lambda: dense_attention(q, k, v, bias=bias)),
                4 * H * T * S * hd * B,
                4 * q.numel() + 4 * B * S * Hkv * hd + B * S,
                note=f" (limit {DECODE_LIMIT:g}; {plan.splits} key splits; "
                     f"library: dense_attention, the route it replaced)")
        del q, k, v, valid, bias, out, ref

    # fused_vit_mlp: one image (5 views x 729 tokens) per call in the
    # adapter path, 26 layers x 4 images per batch; 20 views at once is
    # bench's batched encode; a ragged case.  Beside each: its error next to
    # the first (mma.sync) design's on the same inputs, and the port's
    # unfused chain as a yardstick that the path never calls; at one image
    # the time each of the three launches adds
    import torch.nn.functional as tF
    from lavida_mod_tpu_torch.ops.activations import gelu_tanh
    from lavida_mod_tpu_torch.ops.norms import layer_norm

    D, F = 1152, 4304
    w = [randn(F, D, scale=0.03).bfloat16(), randn(F, scale=0.1).bfloat16(),
         randn(D, F, scale=0.03).bfloat16(), randn(D, scale=0.1).bfloat16()]
    for M, per in [(3645, 4 * SIGLIP_LAYERS), (14580, 0), (77, 0)]:
        x = randn(M, D).bfloat16()
        ln = ((1 + randn(D, scale=0.1)).bfloat16(),
              randn(D, scale=0.1).bfloat16())
        Dm, Fm = (256, 520) if M == 77 else (D, F)
        if M == 77:
            x = x[:, :Dm].contiguous()
            args = (x, ln[0][:Dm], ln[1][:Dm], w[0][:Fm, :Dm].contiguous(),
                    w[1][:Fm], w[2][:Dm, :Fm].contiguous(), w[3][:Dm])
        else:
            args = (x, *ln, *w)
        out = tv.fused_vit_mlp(*args)
        torch.cuda.synchronize()
        ref = tv.fused_vit_mlp_reference(*args)
        torch.testing.assert_close(out.float(), ref.float(), atol=5e-2,
                                   rtol=5e-2)
        err = (out.float() - ref.float()).abs().max().item()
        res.add("fused_vit_mlp", f"M {M} D {Dm} F {Fm}", per, err,
                lambda: tv.fused_vit_mlp(*args),
                cuda_ms(lambda: tv.fused_vit_mlp_reference(*args), 3), None,
                4 * M * Dm * Fm, 4 * M * Dm + 4 * Dm * Fm + 2 * (Fm + 3 * Dm),
                note=" (limit 5e-2)")
        xa, g, b, w1, b1, w2, b2 = args
        chain_ms = cuda_ms(lambda: xa + tF.linear(gelu_tanh(tF.linear(
            layer_norm(xa, g, b, 1e-6), w1, b1)), w2, b2))
        print(f"[kernels] fused_vit_mlp M {M} D {Dm} F {Fm}: max error "
              f"{err:.3e} against the plain version, the first (mma.sync) "
              f"design's {VIT_FIRST_DESIGN_ERR[M]:.3e} on these inputs; "
              f"yardstick, never called by the path: the unfused chain "
              f"(cuBLAS GEMMs, eager elementwise) {chain_ms:.4f} ms")
        if per:
            for name, (added, ms) in sorted(
                    kernel_split(torch, lambda: tv.fused_vit_mlp(*args)).items(),
                    key=lambda kv: -kv[1][0]):
                print(f"[kernels] fused_vit_mlp M {M} split by launch: adds "
                      f"{added:.4f} ms, runs {ms:.4f} ms  {name[:90]}")


def _tree_bytes(modules) -> int:
    seen, n = set(), 0
    for m in modules:
        for t in list(m.parameters()) + list(m.buffers()):
            if t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                n += t.numel() * t.element_size()
    return n


def _phase_times(torch, model, request, gen):
    """(vision + splice, prefill, [decode step]) of one request in ms, host
    clock with a sync after each phase."""
    from lavida_mod_tpu_torch.generation.diffusion import (
        build_control_table, denoise_cached)
    from lavida_mod_tpu_torch.models import multimodal

    ids, views, size = request
    cfg, device = model.cfg, model.device
    G, mask_id = gen.max_new_tokens, cfg.llada.mask_token_id
    k_table, block_end = build_control_table(
        np.full((1, G), mask_id, np.int64), 0, G, gen, mask_id)
    k_table = torch.as_tensor(k_table, device=device)
    block_end = torch.as_tensor(block_end, device=device)
    times = []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx, text_ids, _, _ = multimodal.build_gather_plan(
            cfg, [ids], [[views.shape[0]]], [[size]])
        prefix = multimodal.multimodal_embeds(
            model, torch.as_tensor(views, device=device), text_ids, idx)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        P, lc = prefix.shape[1], cfg.llada
        shape = (1, P + G, lc.effective_n_kv_heads, lc.head_dim)
        cache = [(prefix.new_zeros(shape), prefix.new_zeros(shape))
                 for _ in model.llada.blocks]
        model.llada(prefix, kv_cache=cache, kv_write_index=0,
                    use_cache=True, return_logits=False, use_flash=True,
                    act_int8=model.mixed)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        x = torch.full((1, G), mask_id, dtype=torch.long, device=device)
        gen_rng = torch.Generator(device=device).manual_seed(0)
        steps = []
        for i in range(k_table.shape[0]):
            t0 = time.perf_counter()
            x = denoise_cached(model.llada, x, cache, k_table[i:i + 1],
                               block_end[i:i + 1], None, gen_rng,
                               gen.temperature, gen.remasking)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
    return [t * 1e3 for t in times], [t * 1e3 for t in steps]


def _profile_busy(torch, run):
    """Device time of run() from torch.profiler and its wall: (busy ms,
    wall ms, top kernels, every kernel as (name, ms, count), every kernel's
    added time as kernel_times.added_times gives it) or None when the
    trace shows no device time.  Busy is the union of the kernels'
    intervals: kernels launched with programmatic dependent launch
    overlap the one before them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    added = added_times(torch, prof)
    busy = sum(r[0] for r in added.values())
    if busy <= 0:
        return None
    rows.sort(key=lambda r: -r[1])
    return busy, wall, rows[:12], rows, added


def _print_profile(tag, prof, what, card):
    if prof is None:
        print(f"[{tag}] torch.profiler: no device time in the trace; "
              f"device-busy share not measured")
        return None
    busy, wall, top = prof[:3]
    print(f"[{tag}] torch.profiler over {what}: device busy {busy:.1f} ms "
          f"of a {wall:.1f} ms wall ({100 * busy / wall:.1f} %, profiler "
          f"on) ({card})")
    for key, ms, n in top:
        print(f"[{tag}]   {ms:9.3f} ms  {n:6d} x  {key[:90]}")
    return busy / wall


def _decode_layer_ms(torch, llada, P: int = 1088):
    """One decode layer at B = 1 (32 rows over a [1, P + 32] bf16 cache),
    block 0's forward as the decode loop calls it (attention through the
    decode kernel under the cache's valid bytes): (CUDA-event time per
    call over back-to-back calls, which the host's enqueue sets when it is
    slower than the card; device time per call, the profiler's sum over
    the kernels of 20 calls; launches per call)."""
    cfg, device = llada.cfg, llada.wte.weight.device
    G, S = 32, P + 32
    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.randn(1, G, cfg.d_model, generator=gen,
                    device=device).bfloat16()
    shape = (1, S, cfg.effective_n_kv_heads, cfg.head_dim)
    past = (torch.randn(*shape, generator=gen, device=device).bfloat16(),
            torch.randn(*shape, generator=gen, device=device).bfloat16())
    sin, cos = llada._rope_tables(max(cfg.max_sequence_length, S), device)
    positions = torch.arange(P, S, device=device)
    valid = torch.ones(1, S, dtype=torch.bool, device=device)
    block = llada.blocks[0]

    def run():
        block(x, sin=sin, cos=cos, positions=positions, bias=None,
              layer_past=past, kv_write_index=P, use_flash=False, q_seg=None,
              kv_seg=None, cache_mask=valid)

    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        event_ms = cuda_ms(run, hold=False)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                run()
            torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3 / 20
    launches = sum(e.count for e in rows) / 20
    return event_ms, device_ms, launches


# the kernels of w4_qkv_norm, w4_matmul_res and w4_ffn_fused
# (csrc/w4_fused.cu), one launch each per call of 32 rows
SPLIT_KERNELS = {"w4_qkv_norm": ("qkv_norm_kernel", "qkv_kernel"),
                 "w4_matmul_res": ("res_quant_kernel", "res_kernel"),
                 "w4_ffn_fused": ("ffn_norm_kernel", "ffn_up_kernel",
                                  "ffn_quant_kernel", "ffn_down_kernel")}


def phase_mixed_path(torch, model, requests, card):
    """The bf16 model of phase 4 through to_serving_layout("mixed", fuse=
    True) on the card, then three requests through generate_fused."""
    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.models.multimodal import build_gather_plan
    from lavida_mod_tpu_torch.ops import w4_fused as tw
    from lavida_mod_tpu_torch.ops import w8a8 as t8
    from lavida_mod_tpu_torch.ops.decode_attention import decode_attention
    from lavida_mod_tpu_torch.ops.gather import gather_rows
    from lavida_mod_tpu_torch.ops.short_attention import short_attention

    bf16_bytes = _tree_bytes([model.llada])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.to_serving_layout("mixed", fuse=True)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    llada = model.llada
    prefill_bytes = _tree_bytes([b.prefill for b in llada.blocks])
    decode_bytes = _tree_bytes([getattr(b, n) for b in llada.blocks
                                for n in b.linear_names] + [llada.ff_out])
    shared_bytes = _tree_bytes([llada.wte, llada.ln_f] + [
        m for b in llada.blocks for m in (b.attn_norm, b.ff_norm)])
    print(f"[mixed] to_serving_layout('mixed', fuse=True) on the card in "
          f"{quant_s:.2f} s (peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB); LM weights: bf16 {bf16_bytes / 1e9:.3f} GB -> int8 prefill "
          f"tree {prefill_bytes / 1e9:.3f} GB + int4 decode tree "
          f"{decode_bytes / 1e9:.3f} GB + shared embedding/norms "
          f"{shared_bytes / 1e9:.3f} GB ({card})")
    if not all(b.fused_plan(32, False) for b in llada.blocks) \
            or not llada.head_fusable(32):
        raise AssertionError("the fused decode plan does not engage")

    gen = GenerationConfig(**GEN)
    first = requests[0]
    model.generate_fused(first[0], [first[1]], [first[2]], gen)  # warm-up
    torch.cuda.synchronize()
    ops = {"short_attention": short_attention, "gather_rows": gather_rows,
           "w8a8_matmul": t8.w8a8_matmul, "w4_qkv_norm": tw.w4_qkv_norm,
           "w4_matmul_res": tw.w4_matmul_res,
           "w4_ffn_fused": tw.w4_ffn_fused,
           "decode_attention": decode_attention}
    want = {"short_attention": SIGLIP_LAYERS + LLADA_LAYERS,
            "gather_rows": 1, "w8a8_matmul": 4 * LLADA_LAYERS,
            "w4_qkv_norm": (LLADA_LAYERS + 1) * STEPS,
            "w4_matmul_res": LLADA_LAYERS * STEPS,
            "w4_ffn_fused": LLADA_LAYERS * STEPS,
            "decode_attention": LLADA_LAYERS * STEPS}
    for op in ops.values():
        op.launches = 0
    walls, peaks = [], []
    for i, (ids, views, size) in enumerate(requests):
        before = {k: op.launches for k, op in ops.items()}
        idx, _, _, _ = build_gather_plan(model.cfg, [ids],
                                         [[views.shape[0]]], [[size]])
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate_fused(ids, [views], [size], gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls.append(wall)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        got = {k: op.launches - before[k] for k, op in ops.items()}
        print(f"[mixed] request {i}: image {size} -> {views.shape[0]} "
              f"views, P={idx.shape[1]}, G=32: wall {wall * 1e3:.1f} ms, "
              f"peak {peaks[-1]:.2f} GiB, launches {got} ({card}); tokens "
              f"{out.tolist()}")
        if out.shape != (32,):
            raise AssertionError(f"output shape {out.shape}")
        if (out == model.cfg.llada.mask_token_id).any():
            raise AssertionError("mask tokens left in the output")
        if got != want:
            raise AssertionError(f"launches {got}, want {want}")
    counts = {k: op.launches for k, op in ops.items()}

    phases, steps = _phase_times(torch, model, first, gen)
    print(f"[mixed] phases of request 0, host clock with a sync after "
          f"each: vision + splice {phases[0]:.2f} ms, prefill "
          f"{phases[1]:.2f} ms, decode steps {len(steps)} x "
          f"{np.mean(steps):.2f} ms (min {min(steps):.2f}, max "
          f"{max(steps):.2f}) ({card})")
    prof = _profile_busy(
        torch, lambda: model.generate_fused(first[0], [first[1]], [first[2]],
                                            gen))
    _print_profile("mixed", prof, "request 0", card)
    # #5's, #6's and #7's device time, split by their own kernels
    for op, names in SPLIT_KERNELS.items() if prof is not None else ():
        parts = {k: [0.0, 0.0, 0] for k in names}
        for key, (added, ms, n) in prof[4].items():
            for k in names:
                if k in key:
                    parts[k] = [a + b for a, b in zip(parts[k], (added, ms, n))]
        print(f"[mixed] {op} device time of request 0: "
              f"{sum(v[0] for v in parts.values()):.3f} ms = " + ", ".join(
                  f"{k} {added:.3f} ms ({n} launches; {ms:.3f} ms from "
                  f"launch to end)" for k, (added, ms, n) in parts.items())
              + f" ({card})")
        if any(n != want[op] for _, _, n in parts.values()):
            raise AssertionError(f"{op} kernels launched {parts}")
    layer_ms = _decode_layer_ms(torch, llada)
    print(f"[mixed] one decode layer at B = 1 (32 rows, fused plan: "
          f"w4_qkv_norm + w4_matmul_res + w4_ffn_fused, decode_attention): "
          f"{layer_ms[0]:.4f} "
          f"ms per call back to back, device {layer_ms[1]:.4f} ms in "
          f"{layer_ms[2]:.0f} kernels ({card})")
    return counts, walls, peaks, layer_ms


def phase_small_mixed(torch, device):
    """A tiny mixed-layout model (fused plan and head engaged) on the card
    against the same quantized weights on the CPU, where the fused w4 ops
    run their plain versions."""
    import copy

    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.predict import tiny_mixed_config

    cfg = tiny_mixed_config()
    cpu = LaViDa.random_init(cfg, 0, torch.bfloat16, "cpu")
    with torch.no_grad():
        for p in cpu.llada.parameters():  # diverse tokens, as in the tests
            if p.dim() >= 2:
                p.mul_(10.0)
    cpu.to_serving_layout("mixed", fuse=True)
    gpu = copy.deepcopy(cpu).to(device)
    mask = cfg.llada.mask_token_id
    x = torch.full((1, 32), mask, dtype=torch.long)
    with torch.no_grad():
        outs = [m.llada(m.llada.embed_tokens(x.to(m.device)))[0].float().cpu()
                for m in (cpu, gpu)]
    rel = ((outs[1] - outs[0]).abs().max() / outs[0].abs().max()).item()
    rng = np.random.default_rng(3)
    views = rng.standard_normal((5, 3, 56, 56)).astype(np.float32)
    ids = np.array([5, 6, -200, 7, 8, 9])
    gen = GenerationConfig(max_new_tokens=32, block_length=32,
                           step_per_block=16)
    a = cpu.generate_fused(ids, [views], [(100, 60)], gen)
    b = gpu.generate_fused(ids, [views], [(100, 60)], gen)
    agree = float((a == b).mean())
    print(f"[check] tiny mixed model (fused plan), kernels on the card vs "
          f"plain versions on the CPU: decode logits max|diff|/max|ref| "
          f"{rel:.3e} (limit 5e-2), generated tokens agree {agree:.2f}")
    if not np.isfinite(rel) or rel > 5e-2:
        raise AssertionError(f"tiny mixed-model logits differ: {rel}")


def phase_checkpoint(torch, device, card):
    """The checkpoint and text path at full width (rehearse_8b_load): a
    reference-layout LaViDa-LLaDA-8B checkpoint written to disk and loaded
    back (and kept for the server phase), the mixed layout, the llada
    template and the BPE tokenizer, one request served twice and
    decoded.  The counts are set to 0 before and
    read after; writing, loading and quantizing launch none of the seven
    kernels, so each must have launched exactly twice a mixed request's
    count."""
    from lavida_mod_tpu_torch import rehearse_8b_load
    from lavida_mod_tpu_torch.ops import w4_fused as tw
    from lavida_mod_tpu_torch.ops import w8a8 as t8
    from lavida_mod_tpu_torch.ops.decode_attention import decode_attention
    from lavida_mod_tpu_torch.ops.gather import gather_rows
    from lavida_mod_tpu_torch.ops.short_attention import short_attention

    ops = {"short_attention": short_attention, "gather_rows": gather_rows,
           "w8a8_matmul": t8.w8a8_matmul, "w4_qkv_norm": tw.w4_qkv_norm,
           "w4_matmul_res": tw.w4_matmul_res,
           "w4_ffn_fused": tw.w4_ffn_fused,
           "decode_attention": decode_attention}
    want = {"short_attention": SIGLIP_LAYERS + LLADA_LAYERS,
            "gather_rows": 1, "w8a8_matmul": 4 * LLADA_LAYERS,
            "w4_qkv_norm": (LLADA_LAYERS + 1) * STEPS,
            "w4_matmul_res": LLADA_LAYERS * STEPS,
            "w4_ffn_fused": LLADA_LAYERS * STEPS,
            "decode_attention": LLADA_LAYERS * STEPS}
    for op in ops.values():
        op.launches = 0
    out = rehearse_8b_load.rehearse(torch, device, keep=True)
    counts = {k: op.launches for k, op in ops.items()}
    if counts != {k: 2 * n for k, n in want.items()}:
        raise AssertionError(f"checkpoint path launches {counts}, want twice"
                             f" {want}")
    print(f"[ckpt] LLaDA layers written and loaded: {out['layers']} (of "
          f"32; {out['disk_free_gb']:.1f} GB free before writing); walls: "
          f"write {out['write_s']:.2f} s, load {out['load_s']:.2f} s, "
          f"mixed layout {out['layout_s']:.2f} s, first request "
          f"{out['first_request_s'] * 1e3:.1f} ms, warm request "
          f"{out['warm_request_s'] * 1e3:.1f} ms; {out['bytes_on_disk'] / 1e9:.3f}"
          f" GB on disk; host RSS (now, the process's peak ru_maxrss) GiB at the start "
          f"and after each stage: "
          + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f}"
                      for k, v in out["rss_gib"].items()) + "; "
          f"peak device memory {out['peak_device_gib_load']:.2f} GiB to "
          f"the load, {out['peak_device_gib']:.2f} GiB in all; launches "
          f"over the two requests {counts} ({card})")
    return counts, out


# the batched path: image sizes of B = 4 and of B = 8
BATCH_SIZES = [(640, 640), (800, 600), (1024, 512), (448, 896)]
BATCH8_SIZES = BATCH_SIZES + [(1100, 380), (512, 1024), (384, 384),
                              (900, 700)]


class _RegimeCount:
    """The launches of one of w4_matmul_grouped's two kernels (or of #8's
    int4 instance), read and reset as `.launches` like a wrapper's
    count."""

    def __init__(self, fn, regime):
        self.fn, self.attr = fn, f"{regime}_launches"

    @property
    def launches(self):
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n):
        setattr(self.fn, self.attr, n)


def _batch_ops():
    from lavida_mod_tpu_torch.ops import kv8_attention as tk
    from lavida_mod_tpu_torch.ops import vit_mlp as tv
    from lavida_mod_tpu_torch.ops import w4_fused as tw
    from lavida_mod_tpu_torch.ops import w4_grouped as tg
    from lavida_mod_tpu_torch.ops import w8a8 as t8
    from lavida_mod_tpu_torch.ops.decode_attention import decode_attention
    from lavida_mod_tpu_torch.ops.gather import gather_rows
    from lavida_mod_tpu_torch.ops.short_attention import short_attention

    return {"short_attention": short_attention, "gather_rows": gather_rows,
            "w8a8_matmul": t8.w8a8_matmul, "w4_qkv_norm": tw.w4_qkv_norm,
            "w4_matmul_res": tw.w4_matmul_res,
            "w4_ffn_fused": tw.w4_ffn_fused,
            "w4_matmul_grouped": tg.w4_matmul_grouped,
            "w4_matmul_grouped_decode": _RegimeCount(tg.w4_matmul_grouped,
                                                     "decode"),
            "w4_matmul_grouped_prefill": _RegimeCount(tg.w4_matmul_grouped,
                                                      "prefill"),
            "kv8_decode_attention": tk.kv8_decode_attention,
            "kv8_decode_attention_int4": _RegimeCount(
                tk.kv8_decode_attention, "int4"),
            "decode_attention": decode_attention,
            "fused_vit_mlp": tv.fused_vit_mlp,
            "short_attention_f32": _RegimeCount(short_attention, "f32")}


def _want_batch(B, kv8, chunk):
    """Launches of one batch: 7 linears x 32 layers per prefill call and
    per decode step; the head fused into w4_qkv_norm up to 128 decode rows
    (B = 4), else one more grouped matmul per step; 26 SigLIP layers of
    attention and MLP per image; one prefill attention per layer and
    chunk.  The grouped matmuls of the decode (32 B <= 256 rows) take its
    decode kernel, the prefill's (over 1000 rows a chunk) its prefill
    kernel.  The steps attend over the bf16 cache through the decode
    attention kernel, over the int8 one through #8."""
    calls = -(-B // chunk)
    head_fused = B * 32 <= 128
    want = {k: 0 for k in _batch_ops()}
    want["w4_matmul_grouped_decode"] = (LLADA_LINEARS * LLADA_LAYERS * STEPS
                                        + (0 if head_fused else STEPS))
    want["w4_matmul_grouped_prefill"] = LLADA_LINEARS * LLADA_LAYERS * calls
    want["w4_matmul_grouped"] = (want["w4_matmul_grouped_decode"]
                                 + want["w4_matmul_grouped_prefill"])
    want["w4_qkv_norm"] = STEPS if head_fused else 0
    want["short_attention"] = SIGLIP_LAYERS * B + LLADA_LAYERS * calls
    want["fused_vit_mlp"] = SIGLIP_LAYERS * B
    want["kv8_decode_attention"] = LLADA_LAYERS * STEPS if kv8 else 0
    want["decode_attention"] = 0 if kv8 else LLADA_LAYERS * STEPS
    return want


def phase_batched_path(torch, device, card):
    """LaViDaConfig() from seed 0 through to_serving_layout("int4",
    fuse=False), then generate_batch at B = 4 (kv8 off and on) and B = 8
    (chunked prefill)."""
    from lavida_mod_tpu_torch.config import GenerationConfig, LaViDaConfig
    from lavida_mod_tpu_torch.eval.adapter import generate_batch
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.ops.quant import Int4Linear

    cfg = LaViDaConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LaViDa.random_init(cfg, 0, torch.bfloat16, device)
    model.to_serving_layout("int4", fuse=False)
    torch.cuda.synchronize()
    llada = model.llada
    blk = llada.blocks[0]
    if not (all(isinstance(getattr(b, n), Int4Linear) for b in llada.blocks
                for n in b.linear_names) and blk.cfg.block_type == "llama"
            and not blk.fused_plan(32, False) and llada.head_fusable(128)
            and not llada.head_fusable(256)
            and model._vision_fused_mlp()):
        raise AssertionError("the batched int4 layout is not as expected")
    print(f"[batch] LaViDaConfig() bf16 random init + to_serving_layout("
          f"'int4', fuse=False) on the card in {time.perf_counter() - t0:.2f}"
          f" s (peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB); "
          f"LM weights {_tree_bytes([llada]) / 1e9:.3f} GB ({card})")

    gen = GenerationConfig(**GEN)
    rng = np.random.default_rng(4)
    req8 = [bench_request(48, s, rng) for s in BATCH8_SIZES]
    reqs8 = [(ids, [views], [size]) for ids, views, size in req8]
    reqs4 = reqs8[:4]
    ops = _batch_ops()
    generate_batch(model, reqs4, gen)                      # warm-up
    torch.cuda.synchronize()
    counts, walls = {}, {}
    for name, reqs, kv8, chunk in [("b4", reqs4, False, 4),
                                   ("b4_kv8", reqs4, True, 4),
                                   ("b8_chunked", reqs8, False, 2)]:
        B = len(reqs)
        for op in ops.values():
            op.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, stage = generate_batch(model, reqs, gen, kv8=kv8)
        wall = time.perf_counter() - t0
        got = {k: op.launches for k, op in ops.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = _want_batch(B, kv8, chunk)
        views = sum(r[1][0].shape[0] for r in reqs)
        print(f"[batch] {name}: B={B}, {views} views, G=32: wall "
              f"{wall * 1e3:.1f} ms ({wall * 1e3 / B:.1f} ms per image), "
              f"stages encode {stage['encode'] * 1e3:.1f} ms generate "
              f"{stage['generate'] * 1e3:.1f} ms, peak {peak:.2f} GiB "
              f"({card}); launches {got}")
        print(f"[batch] {name} tokens of request 0: {out[0].tolist()}")
        if out.shape != (B, 32):
            raise AssertionError(f"output shape {out.shape}")
        if (out == cfg.llada.mask_token_id).any():
            raise AssertionError("mask tokens left in the output")
        if got != want:
            raise AssertionError(f"launches {got}, want {want}")
        counts[name], walls[name] = got, (wall, B, peak)

    share = _print_profile("batch", _profile_busy(
        torch, lambda: generate_batch(model, reqs4, gen, kv8=True)),
        "one B = 4 kv8 batch", card)
    layer_ms = _decode_layer_ms(torch, llada)
    print(f"[batch] one decode layer at B = 1 (32 rows, unfused int4: seven "
          f"w4_matmul_grouped + norms, SwiGLU, decode_attention): "
          f"{layer_ms[0]:.4f} ms per call back to back, device "
          f"{layer_ms[1]:.4f} ms in {layer_ms[2]:.0f} kernels ({card})")
    return model, counts, walls, share, layer_ms


def phase_small_batch(torch, device):
    """A tiny int4 (unfused) + kv8 + fused-ViT-MLP model on the card
    against the same weights on the CPU, where every op runs its plain
    version."""
    import copy

    from lavida_mod_tpu_torch.config import (GenerationConfig,
                                             tiny_siglip_config)
    from lavida_mod_tpu_torch.data.anyres import anyres_grid_shape
    from lavida_mod_tpu_torch.eval.adapter import generate_batch
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.predict import tiny_mixed_config

    cfg = tiny_mixed_config()
    sig = tiny_siglip_config(hidden_size=128, intermediate_size=200)
    cfg = cfg.replace(vision=cfg.vision.replace(siglip=sig,
                                                mm_hidden_size=128))
    cpu = LaViDa.random_init(cfg, 0, torch.bfloat16, "cpu")
    with torch.no_grad():
        for p in cpu.llada.parameters():  # diverse tokens, as in the tests
            if p.dim() >= 2:
                p.mul_(4.0)
    cpu.to_serving_layout("int4", fuse=False)
    gpu = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(5)
    reqs = []
    for size in ((100, 60), (60, 100), (112, 112)):
        nw, nh = anyres_grid_shape(size, cfg.vision.grid_pinpoints, 56)
        views = rng.standard_normal((1 + nw * nh, 3, 56, 56)).astype(
            np.float32)
        ids = np.concatenate([[5, 6, -200], rng.integers(3, 400, 4)])
        reqs.append((ids, [views], [size]))
    x = torch.full((3, 32), cfg.llada.mask_token_id, dtype=torch.long)
    with torch.no_grad():
        outs = [m.llada(m.llada.embed_tokens(x.to(m.device)))[0].float().cpu()
                for m in (cpu, gpu)]
    rel = ((outs[1] - outs[0]).abs().max() / outs[0].abs().max()).item()
    gen = GenerationConfig(max_new_tokens=32, block_length=32,
                           step_per_block=16)
    a, _ = generate_batch(cpu, reqs, gen, kv8=True)
    b, _ = generate_batch(gpu, reqs, gen, kv8=True)
    agree = float((a == b).mean())
    print(f"[check] tiny int4 + kv8 + fused-ViT-MLP model, kernels on the "
          f"card vs plain versions on the CPU: decode logits max|diff|/"
          f"max|ref| {rel:.3e} (limit 5e-2), B=3 kv8 generate_batch tokens "
          f"agree {agree:.2f}")
    if not np.isfinite(rel) or rel > 5e-2:
        raise AssertionError(f"tiny int4 model logits differ: {rel}")
    if (b == cfg.llada.mask_token_id).any():
        raise AssertionError("mask tokens left in the tiny batch output")

    # the int4 KV cache at hd 16 (8-byte rows: #8's cp.async route): the
    # tiny bf16 model on the card and on the CPU, one decode step over the
    # same int4 cache (built on the CPU), then kv8=4 generate_batch
    from lavida_mod_tpu_torch.generation import diffusion as td
    from lavida_mod_tpu_torch.ops import kv8_attention as tk
    from lavida_mod_tpu_torch.predict import tiny_config

    tcfg = tiny_config()
    cpu = LaViDa.random_init(tcfg, 0, torch.bfloat16, "cpu")
    gpu = copy.deepcopy(cpu).to(device)
    if tcfg.llada.head_dim != 16:
        raise AssertionError("the tiny model's head dim is not 16")
    treqs = []
    for size in ((100, 60), (60, 100), (112, 112)):
        nw, nh = anyres_grid_shape(size, tcfg.vision.grid_pinpoints, 56)
        views = rng.standard_normal((1 + nw * nh, 3, 56, 56)).astype(
            np.float32)
        ids = np.concatenate([[5, 6, -200], rng.integers(3, 400, 4)])
        treqs.append((ids, [views], [size]))
    embeds = [cpu.encode_prompt(*r)[0] for r in treqs]
    P = min(e.shape[0] for e in embeds)
    prefix = torch.stack([e[:P] for e in embeds])
    G = 32
    x = torch.full((3, G), tcfg.llada.mask_token_id, dtype=torch.long)
    with torch.no_grad():
        cache = td.prefill_cache(cpu.llada, prefix, G, kv8=4)
        step = []
        for m in (cpu, gpu):
            c = [tuple(t.to(m.device).clone() for t in layer)
                 for layer in cache]
            logits, _ = m.llada(m.llada.embed_tokens(x.to(m.device)),
                                positions=torch.arange(P, P + G,
                                                       device=m.device),
                                kv_cache=c, kv_write_index=P,
                                use_cache=True)
            step.append(logits.float().cpu())
    n4 = tk.kv8_decode_attention.int4_launches
    rel4 = ((step[1] - step[0]).abs().max() / step[0].abs().max()).item()
    a4, _ = generate_batch(cpu, treqs, gen, kv8=4)
    b4, _ = generate_batch(gpu, treqs, gen, kv8=4)
    launched = tk.kv8_decode_attention.int4_launches - n4
    print(f"[check] tiny bf16 model (hd 16) over the int4 KV cache, #8's "
          f"int4 instance on the card vs the plain version on the CPU: one "
          f"decode step from the same cache, logits max|diff|/max|ref| "
          f"{rel4:.3e} (limit 5e-2); B=3 kv4 generate_batch tokens agree "
          f"{float((a4 == b4).mean()):.2f}, {launched} int4 launches on the "
          f"card")
    if not np.isfinite(rel4) or rel4 > 5e-2:
        raise AssertionError(f"tiny kv4 decode logits differ: {rel4}")
    if launched != tcfg.llada.n_layers * 16 or \
            (b4 == tcfg.llada.mask_token_id).any():
        raise AssertionError(f"tiny kv4 batch: {launched} int4 launches")


def phase_kv4_request(torch, model, requests, card):
    """bench.py --kv4 at B = 1: the mixed fused model of phase 5, one
    request through generate_fused(kv8=4), the decode over the int4 KV
    cache.  The counts are set to 0 before it and read after."""
    from lavida_mod_tpu_torch.config import GenerationConfig

    gen = GenerationConfig(**GEN)
    ids, views, size = requests[0]
    model.generate_fused(ids, [views], [size], gen, kv8=4)   # warm-up
    ops = _batch_ops()
    want = {k: 0 for k in ops}
    want.update({"short_attention": SIGLIP_LAYERS + LLADA_LAYERS,
                 "gather_rows": 1, "w8a8_matmul": 4 * LLADA_LAYERS,
                 "w4_qkv_norm": (LLADA_LAYERS + 1) * STEPS,
                 "w4_matmul_res": LLADA_LAYERS * STEPS,
                 "w4_ffn_fused": LLADA_LAYERS * STEPS,
                 "kv8_decode_attention": LLADA_LAYERS * STEPS,
                 "kv8_decode_attention_int4": LLADA_LAYERS * STEPS})
    for op in ops.values():
        op.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate_fused(ids, [views], [size], gen, kv8=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: op.launches for k, op in ops.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[kv4] bench --kv4 at B = 1 (mixed fused layout, generate_fused("
          f"kv8=4)): image {size}, G=32: wall {wall * 1e3:.1f} ms, peak "
          f"{peak:.2f} GiB ({card}); launches {got}; tokens {out.tolist()}")
    if out.shape != (32,) or (out == model.cfg.llada.mask_token_id).any():
        raise AssertionError(f"kv4 request output {out}")
    if got != want:   # every #8 launch the int4 instance's
        raise AssertionError(f"kv4 request launches {got}, want {want}")
    return got, wall, peak


# ---------------------------------------------------------------------------
# generation without the prefix cache, the dLLM cache, verbose, FIM and the
# MC log-likelihood
# ---------------------------------------------------------------------------

def _counted(torch, run):
    """run() with every kernel count set to 0 just before it and read just
    after: (its result, wall s, peak GiB, launches by kernel)."""
    ops = _batch_ops()
    for op in ops.values():
        op.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, wall, torch.cuda.max_memory_allocated() / 2**30,
            {k: op.launches for k, op in ops.items()})


def _want(**kw):
    want = {k: 0 for k in _batch_ops()}
    want.update(kw)
    if "w4_matmul_grouped_decode" in kw or "w4_matmul_grouped_prefill" in kw:
        want["w4_matmul_grouped"] = (want["w4_matmul_grouped_decode"]
                                     + want["w4_matmul_grouped_prefill"])
    return want


def _check(tag, got, want, out=None, G=32, mask_id=None):
    if got != want:
        raise AssertionError(f"{tag} launches {got}, want {want}")
    if out is not None and (out.shape[-1] != G or (out == mask_id).any()):
        raise AssertionError(f"{tag} output {out}")


def phase_branches_bf16(torch, model, requests, card):
    """The bf16 model of phase 4: one bench-protocol request without the
    prefix cache (LaViDa.generate, gen.prefix_lm False: every step the
    whole forward over P + 32 rows, dense attention), and one verbose
    request over the prefix cache (16 snapshots, the mask count never
    rising, the last equal to the returned tokens)."""
    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.generation import diffusion

    ids, views, size = requests[0]
    mask_id = model.cfg.llada.mask_token_id
    nc = GenerationConfig(**{**GEN, "prefix_lm": False})
    out, wall, peak, got = _counted(
        torch, lambda: model.generate(ids, [views], [size], nc))
    _check("bf16 no-cache request", got, _want(
        short_attention=SIGLIP_LAYERS, fused_vit_mlp=SIGLIP_LAYERS), out,
        mask_id=mask_id)
    print(f"[nocache] bf16 request without the prefix cache (LaViDa."
          f"generate, prefix_lm False; P + 32 rows a step, 16 steps): wall "
          f"{wall * 1e3:.1f} ms, peak {peak:.2f} GiB, launches "
          f"{ {k: v for k, v in got.items() if v} } ({card}); tokens "
          f"{out.tolist()}")

    def verbose():
        prefix = model.encode_prompt(ids, [views], [size])
        return diffusion.generate(model.llada, prefix,
                                  GenerationConfig(**GEN), verbose=True)

    (x, history), vwall, vpeak, vgot = _counted(torch, verbose)
    masks = [int((h == mask_id).sum()) for h in history]
    if len(history) != STEPS or masks != sorted(masks, reverse=True) or \
            masks[-1] != 0 or not (history[-1] == x.cpu().numpy()).all():
        raise AssertionError(f"verbose history: {len(history)} snapshots, "
                             f"masks {masks}")
    _check("verbose request", vgot, _want(
        short_attention=SIGLIP_LAYERS + LLADA_LAYERS,
        fused_vit_mlp=SIGLIP_LAYERS))
    print(f"[verbose] bf16 verbose request over the prefix cache "
          f"(diffusion.generate(verbose=True), a host copy per step): "
          f"{len(history)} snapshots, masks left {masks}, wall "
          f"{vwall * 1e3:.1f} ms, peak {vpeak:.2f} GiB ({card})")
    return {"nocache": (got, wall, peak), "verbose": (vgot, vwall, vpeak)}


def phase_branches_int4(torch, model, card):
    """The int4 unfused model of phase 8 at B = 1: bench.py --no-cache
    --no-fused (warm-up, then one request, then one profiled), the dLLM
    cache at gen 32 with --dllm 64 (r >= G: every row each step) beside
    the cached scan, and the TPU rounds' protocol --gen-len 256 --steps 32
    --dllm 64 beside the same without --dllm.  Each request's launches are
    asserted against counts made here: #4's prefill kernel takes the
    prefill's and the no-cache forward's rows (over 256), its decode
    kernel the 32-, 64- and 256-row calls; the head is #5 where it takes
    at most 128 rows (the init pass of gen 32 and the 64-row steps)."""
    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.generation import diffusion

    ids, views, size = bench_request(48, (640, 640),
                                     np.random.default_rng(0))
    mask_id = model.cfg.llada.mask_token_id
    lin = LLADA_LINEARS * LLADA_LAYERS
    vision = dict(short_attention=SIGLIP_LAYERS,
                  fused_vit_mlp=SIGLIP_LAYERS)
    res = {}

    nc = GenerationConfig(**{**GEN, "prefix_lm": False})
    model.generate(ids, [views], [size], nc)                # warm-up
    out, wall, peak, got = _counted(
        torch, lambda: model.generate(ids, [views], [size], nc))
    # a step: 7 x 32 linears over P + 32 rows, the head on the 32 answer
    # rows (unfused: the forward has over 128 rows)
    _check("int4 no-cache request", got, _want(
        **vision, w4_matmul_grouped_prefill=lin * STEPS,
        w4_matmul_grouped_decode=STEPS), out, mask_id=mask_id)
    res["nocache"] = (got, wall, peak)
    print(f"[nocache] int4 unfused request without the prefix cache "
          f"(bench.py --no-cache --no-fused, B = 1): wall {wall * 1e3:.1f} "
          f"ms, peak {peak:.2f} GiB, launches "
          f"{ {k: v for k, v in got.items() if v} } ({card}); tokens "
          f"{out.tolist()}")
    res["nocache_busy"] = _print_profile("nocache", _profile_busy(
        torch, lambda: model.generate(ids, [views], [size], nc)),
        "one int4 no-cache request", card)

    def dllm(gen, r):
        prefix = model.encode_prompt(ids, [views], [size])
        return diffusion.generate(model.llada, prefix, gen,
                                  dllm_cache=r)[0].cpu().numpy()

    gen32 = GenerationConfig(**GEN)
    dllm(gen32, 64)                                         # warm-up
    out, wall, peak, got = _counted(torch, lambda: dllm(gen32, 64))
    pre = dict(short_attention=SIGLIP_LAYERS + LLADA_LAYERS,
               fused_vit_mlp=SIGLIP_LAYERS, w4_matmul_grouped_prefill=lin)
    # init pass and 16 steps of 32 rows, each with the fused head (#5); the
    # init pass attends at its write index through the decode kernel, the
    # steps' scatter mode densely
    _check("dLLM gen 32", got, _want(
        **pre, w4_matmul_grouped_decode=lin * (STEPS + 1),
        w4_qkv_norm=STEPS + 1, decode_attention=LLADA_LAYERS), out,
        mask_id=mask_id)
    cached, cwall, cpeak, cgot = _counted(
        torch, lambda: model.generate(ids, [views], [size], gen32))
    agree = float((out == cached).mean())
    res["dllm32"] = (got, wall, peak)
    print(f"[dllm] --dllm 64 at gen 32 (r >= G: every row re-forwarded each "
          f"step, the logits cache in bf16): wall {wall * 1e3:.1f} ms, peak "
          f"{peak:.2f} GiB, launches { {k: v for k, v in got.items() if v} }; "
          f"the cached scan on the same model {cwall * 1e3:.1f} ms; tokens "
          f"agree {agree:.3f} (exact in exact arithmetic; the bf16 logits "
          f"cache can reorder near-ties) ({card})")

    steps = 32
    g256 = GenerationConfig(max_new_tokens=256, block_length=256,
                            step_per_block=steps, prefix_lm=True,
                            remasking="low_confidence")
    dllm(g256, 64)                                          # warm-up
    out, wall, peak, got = _counted(torch, lambda: dllm(g256, 64))
    # init pass over 256 rows (head unfused), 32 steps of 64 rows (#5 head)
    _check("dLLM gen 256", got, _want(
        **pre, w4_matmul_grouped_decode=lin * (steps + 1) + 1,
        w4_qkv_norm=steps, decode_attention=LLADA_LAYERS), out, G=256,
        mask_id=mask_id)
    res["dllm256"] = (got, wall, peak)
    model.generate(ids, [views], [size], g256)              # warm-up
    cout, cwall, cpeak, cgot = _counted(
        torch, lambda: model.generate(ids, [views], [size], g256))
    _check("gen 256 cached", cgot, _want(
        **pre, w4_matmul_grouped_decode=(lin + 1) * steps,
        decode_attention=LLADA_LAYERS * steps), cout, G=256,
        mask_id=mask_id)
    res["cached256"] = (cgot, cwall, cpeak)
    print(f"[dllm] --gen-len 256 --steps 32 --dllm 64: wall {wall * 1e3:.1f}"
          f" ms, peak {peak:.2f} GiB; the same without --dllm (the cached "
          f"scan, 256 rows a step): wall {cwall * 1e3:.1f} ms, peak "
          f"{cpeak:.2f} GiB; tokens agree {float((out == cout).mean()):.3f}"
          f" ({card})")
    return res


def phase_fim(torch, card, path):
    """predict_fim with phase 7's checkpoint at full width: LaViDa.load,
    the weight-only int8 layout, the trained tokenizer, the llada template
    and the default draft; G = 256 in one block, the drafted positions
    kept (predict_fim asserts it)."""
    from lavida_mod_tpu_torch import predict_fim

    res, wall, peak, got = _counted(torch, lambda: predict_fim.main(
        ["--model-path", str(path), "--device", "cuda"]))
    # no image: the prefill's attention, then G = 256 steps in one block
    # (step ratio 1) over the bf16 cache; weight-only int8 launches no W8A8
    # kernel
    _check("FIM request", got, _want(short_attention=LLADA_LAYERS,
                                     decode_attention=LLADA_LAYERS * 256))
    ids, draft = res["ids"], res["draft"]
    holes = int((draft == 126336).sum())
    if len(ids) != 256 or not (ids[:len(draft)][draft != 126336]
                               == draft[draft != 126336]).all():
        raise AssertionError(f"FIM output {ids}")
    print(f"[fim] predict_fim --model-path <7's checkpoint> (load, the "
          f"weight-only int8 layout, the llada template, the default "
          f"draft: {len(draft)} tokens, {holes} holes, G = {len(ids)}): "
          f"wall {wall:.2f} s ("
          + ", ".join(f"{k} {v:.2f} s" for k, v in res["walls"].items())
          + f"), peak {peak:.2f} GiB, launches "
          f"{ {k: v for k, v in got.items() if v} }, drafted positions kept "
          f"({card})")
    return got, wall, peak


# the eval phase (7a): tasks of an image, a log-likelihood and a video
# family, and the result keys of JAX's evaluate for each
EVAL_TASKS = ("pope", "textvqa_val", "hellaswag", "videomme")
EVAL_KEYS = {
    "pope": ["accuracy", "precision", "recall", "f1", "yes_ratio",
             "avg_latency_s", "wall_s", "n_docs"],
    "textvqa_val": ["exact_match", "avg_latency_s", "wall_s", "n_docs"],
    "hellaswag": ["acc", "avg_latency_s", "wall_s", "n_docs"],
    "videomme": ["acc", "avg_latency_s", "wall_s", "n_docs"]}
EVAL_LIMIT = 2
EVAL_FRAMES = 32
EVAL_G = 16          # the four tasks' max_new_tokens: 16 steps of 1 token
FRAME_TOKENS = 196   # a frame's pooled 14 x 14 grid
# the videomme documents' prefix (32 x 196 + 1 video rows and the prompt's
# text; phase 7a asserts it) and the rows it prefills at, bucketed to 128
VIDEO_PREFIX = 6646
VIDEO_PREFIX_ROWS = -(-VIDEO_PREFIX // 128) * 128
IMAGE_TOKEN = -200
# the video block through #1 against the plain tower, max|diff| / max|ref|
EVAL_BLOCK_LIMIT = 5e-2


def _eval_want(kind):
    """Launches of one eval request on the mixed 8B (fused layout): an
    image document through generate_fused, a video document through
    encode_video + generate (no splice gather), one log-likelihood
    ending (mc_num 16 in two forward chunks of 8 rows on the int8 tree,
    weight-only).  The steps attend over the bf16 cache through the decode
    kernel."""
    if kind == "loglik":
        return _want(short_attention=2 * LLADA_LAYERS)
    return _want(short_attention=SIGLIP_LAYERS + LLADA_LAYERS,
                 gather_rows=1 if kind == "image" else 0,
                 w8a8_matmul=4 * LLADA_LAYERS,
                 decode_attention=LLADA_LAYERS * EVAL_G,
                 w4_qkv_norm=(LLADA_LAYERS + 1) * EVAL_G,
                 w4_matmul_res=LLADA_LAYERS * EVAL_G,
                 w4_ffn_fused=LLADA_LAYERS * EVAL_G)


def eval_documents(root, tasks=EVAL_TASKS, video_frames=EVAL_FRAMES):
    """tools/eval_smoke_all.py's documents of each task under root: jsonl
    with seeded PNGs, and a seeded GIF per video document.  Returns the
    --data-path value."""
    from lavida_mod_tpu_torch.tools import eval_smoke_all as smoke

    os.makedirs(root, exist_ok=True)
    imgs = smoke.write_images(root)
    return ",".join(f"{t}=" + smoke.write_docs(
        t, root, imgs, video_frames if t == "videomme" else 0)
        for t in tasks)


def phase_eval(torch, card, path):
    """python -m lavida_mod_tpu_torch.eval on phase 7's 8B checkpoint in
    process: the mixed layout, eval_main.sh's gen kwargs, two documents
    of an image, a second image, the log-likelihood and the video family;
    every request's launches asserted, the results, the --output keys
    and the tracker's files checked; then the route's outputs
    (_check_eval_route)."""
    import tempfile

    from lavida_mod_tpu_torch.eval import __main__ as eval_cli
    from lavida_mod_tpu_torch.eval.adapter import LavidaEvalModel

    t_phase = time.perf_counter()
    ops = _batch_ops()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    # (kind, wall, launches, adapter, args, kwargs, answer) per request
    reqs = []
    orig = {n: getattr(LavidaEvalModel, n)
            for n in ("generate_until", "loglikelihood")}

    def counted(name):
        def run(self, *a, **kw):
            torch.cuda.synchronize()
            before = {k: op.launches for k, op in ops.items()}
            t0 = time.perf_counter()
            out = orig[name](self, *a, **kw)
            torch.cuda.synchronize()
            kind = ("loglik" if name == "loglikelihood" else "video"
                    if kw.get("video") or (len(a) > 3 and a[3]) else "image")
            reqs.append((kind, time.perf_counter() - t0,
                         {k: op.launches - before[k]
                          for k, op in ops.items()}, self, a, kw, out))
            return out
        return run

    try:
        data = eval_documents(tmp)
        for name in orig:
            setattr(LavidaEvalModel, name, counted(name))
        argv = ["--model-path", str(path), "--quant", "mixed",
                "--gen-kwargs", "prefix_lm=True",
                "--tasks", ",".join(EVAL_TASKS), "--data-path", data,
                "--limit", str(EVAL_LIMIT),
                "--output", os.path.join(tmp, "results.json"),
                "--output-dir", os.path.join(tmp, "tracker")]
        for op in ops.values():
            op.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eval_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: op.launches for k, op in ops.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        for name, fn in orig.items():
            setattr(LavidaEvalModel, name, fn)
        out = json.load(open(os.path.join(tmp, "results.json")))
        trk = os.path.join(tmp, "tracker", str(path).replace("/", "__")
                           .replace(" ", "_"))
        files = sorted(os.listdir(trk))
    finally:
        for name, fn in orig.items():
            setattr(LavidaEvalModel, name, fn)
        shutil.rmtree(tmp, ignore_errors=True)
    if list(out) != list(EVAL_TASKS):
        raise AssertionError(f"--output tasks {list(out)}")
    for t in EVAL_TASKS:
        r = out[t]["results"]
        if set(out[t]) != {"task", "results", "samples"} \
                or list(r) != EVAL_KEYS[t] or r["n_docs"] != EVAL_LIMIT \
                or len(out[t]["samples"]) != EVAL_LIMIT:
            raise AssertionError(f"{t}: --output {out[t]}")
        for k, v in r.items():
            hi = float("inf") if k in ("avg_latency_s", "wall_s",
                                       "n_docs") else 1.0
            if not (isinstance(v, (int, float)) and np.isfinite(v)
                    and 0 <= v <= hi):
                raise AssertionError(f"{t}: {k} = {v}")
        if res[t]["results"]["n_docs"] != EVAL_LIMIT:
            raise AssertionError(f"{t}: {res[t]['results']}")
    want_files = ["results"] + [f"samples_{t}" for t in sorted(EVAL_TASKS)]
    if [f.rsplit("_", 1)[0] for f in files] != want_files:
        raise AssertionError(f"tracker files {files}")
    kinds = [r[0] for r in reqs]
    want_kinds = (["image"] * 4 + ["loglik"] * 4 * EVAL_LIMIT
                  + ["video"] * EVAL_LIMIT)
    if kinds != want_kinds:
        raise AssertionError(f"requests {kinds}, want {want_kinds}")
    for i, (kind, _, got, *_) in enumerate(reqs):
        _check(f"eval request {i} ({kind})", got, _eval_want(kind))
    total = {k: sum(r[2][k] for r in reqs) for k in ops}
    if counts != total:
        raise AssertionError(f"eval launches {counts} are not the "
                             f"requests' {total}")
    route = _check_eval_route(torch, reqs)
    docs = {"pope": reqs[0:2], "textvqa_val": reqs[2:4],
            "hellaswag": [reqs[4 + 4 * i:8 + 4 * i] for i in range(2)],
            "videomme": reqs[12:14]}
    per_doc = {t: [round(sum(x[1] for x in d) if t == "hellaswag"
                         else d[1], 3) for d in v] for t, v in docs.items()}
    task_wall = {t: round(out[t]["results"]["wall_s"], 3)
                 for t in EVAL_TASKS}
    # the CLI's wall less its tasks': the checkpoint's load, the mixed
    # layout and the tokenizer
    setup = wall - sum(out[t]["results"]["wall_s"] for t in EVAL_TASKS)
    print(f"[eval] python -m lavida_mod_tpu_torch.eval --model-path <7's "
          f"checkpoint> --quant mixed --gen-kwargs prefix_lm=True --tasks "
          f"{','.join(EVAL_TASKS)} --limit {EVAL_LIMIT} (videomme: "
          f"{EVAL_FRAMES}-frame GIFs): wall {wall:.2f} s, of it set-up "
          f"(load, mixed layout, tokenizer) {setup:.2f} s, peak "
          f"{peak:.2f} GiB; walls per document (s) {per_doc}, per task "
          f"(evaluate's wall_s) {task_wall}; video prefix "
          f"{route['video_prefix']} rows ({EVAL_FRAMES} x {FRAME_TOKENS} + 1 "
          f"video tokens + text, bucketed to {VIDEO_PREFIX_ROWS} in "
          f"generate); scores "
          + "; ".join(f"{t} " + ", ".join(
              f"{k} {v:.3f}" for k, v in out[t]["results"].items()
              if k not in ("avg_latency_s", "wall_s", "n_docs"))
              for t in EVAL_TASKS)
          + f"; launches {_nonzero(counts)} ({card})")
    print(f"[eval] launches per request: image "
          f"{_nonzero(_eval_want('image'))}, log-likelihood ending "
          f"{_nonzero(_eval_want('loglik'))}, video "
          f"{_nonzero(_eval_want('video'))}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts, {"wall": wall, "setup": setup, "peak": peak,
                    "per_doc": per_doc, "task_wall": task_wall, **route}


def _check_eval_route(torch, reqs):
    """The eval route's outputs on the card, beyond their ranges: the
    first image document's request generated twice more gives the same
    tokens, which decode to the eval's answer; the first
    video document's block (encode_video: the 32 frames in one tower
    batch through #1) against the frames one at a time through the plain
    tower (short_attention_reference), concatenated in order, and the
    newline row; that block spliced at the <image> marker of the prompt
    the route prefills, between the text's embeddings; and every video
    prefix VIDEO_PREFIX rows, the shape phase_kernels checks #1 and #3
    at."""
    from lavida_mod_tpu_torch.eval.adapter import gen_kwargs_to_config
    from lavida_mod_tpu_torch.models import multimodal, siglip
    from lavida_mod_tpu_torch.ops.short_attention import \
        short_attention_reference

    # generate_until's image route (generate_fused), its tokens kept
    _, _, _, adapter, (text, images, gen_kwargs), _, answer = reqs[0]
    ids, views, sizes, model = adapter._build_inputs(text, images)
    gen = gen_kwargs_to_config(gen_kwargs, model.lm_family)
    toks = [model.generate_fused(ids, views, sizes, gen,
                                 prefix_bucket=adapter.prefix_bucket,
                                 kv8=adapter.kv8) for _ in range(2)]
    said = model.decode_output(toks[0], adapter.tokenizer,
                               adapter._stop_ids())
    if not np.array_equal(*toks) or said != answer:
        raise AssertionError(f"image document 0: tokens {toks[0].tolist()}"
                             f", then {toks[1].tolist()}, decoded {said!r};"
                             f" the eval answered {answer!r}")
    videos = [r for r in reqs if r[0] == "video"]
    adapter, model = videos[0][3], videos[0][3].model
    lens = []
    for _, _, _, _, (text, frames, *_), _, _ in videos:
        ids, _ = adapter.video_inputs(text, frames)
        lens.append(len(ids) - 1 + len(frames) * FRAME_TOKENS + 1)
    if lens != [VIDEO_PREFIX] * len(videos):
        raise AssertionError(f"video prefixes {lens} rows: phase_kernels "
                             f"checks #1 and #3 at {VIDEO_PREFIX}")
    text, frames = videos[0][4][:2]
    ids, views = adapter.video_inputs(text, frames)
    ids = np.asarray(ids)
    v = torch.as_tensor(views, device=model.device)
    with torch.no_grad():
        block = multimodal.encode_video(model, v)
        kernel_attention = siglip.vision_attention
        siglip.vision_attention = short_attention_reference
        try:
            ref = torch.cat([multimodal.encode_views(model, v[i:i + 1])[0]
                             for i in range(len(v))])
        finally:
            siglip.vision_attention = kernel_attention
        prefix = model.encode_prompt(ids, image_features=[block])[0]
        m = int(np.where(ids == IMAGE_TOKEN)[0][0])
        text_rows = model.llada.embed_tokens(torch.as_tensor(
            np.delete(ids, m), dtype=torch.long, device=model.device))
    newline = torch.equal(block[-1], model.image_newline.to(block.dtype))
    if block.shape != (EVAL_FRAMES * FRAME_TOKENS + 1, ref.shape[-1]) \
            or not newline:
        raise AssertionError(f"video block {tuple(block.shape)}, its last "
                             f"row the newline: {newline}")
    err = _rel(block[:-1], ref)
    # 26 layers of bf16 rounding, in other orders (the kernel's streamed
    # softmax; one tower batch of 32 frames against 32 of one)
    if not err < EVAL_BLOCK_LIMIT:
        raise AssertionError(f"video block vs the plain tower: {err:.3e}")
    R = block.shape[0]
    if prefix.shape[0] != len(ids) - 1 + R \
            or not torch.equal(prefix[m:m + R], block) \
            or not torch.equal(torch.cat([prefix[:m], prefix[m + R:]]),
                               text_rows):
        raise AssertionError(f"video prefix {tuple(prefix.shape)} is not "
                             f"the text with the block at row {m}")
    print(f"[eval] route checks: image document 0 generated twice more, "
          f"the same tokens {toks[0].tolist()} decoding to the eval's "
          f"answer {answer!r}; video document 0: block {tuple(block.shape)} "
          f"through #1 (one batch of {len(v)} frames) vs the plain tower "
          f"frame by frame max|diff|/max|ref| {err:.3e} (limit "
          f"{EVAL_BLOCK_LIMIT}), newline row last, spliced at row {m} "
          f"between the text's embeddings (bit-equal); video prefixes "
          f"{lens} rows")
    return {"video_prefix": lens, "block_err": err}


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


class _CharTokenizer:
    """One id per character (3 + its code point mod 400)."""

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text):
        return self._Out([3 + ord(c) % 400 for c in text])


def phase_loglik(torch, model, card):
    """LavidaEvalModel.loglikelihood on the mixed model of phase 5 at MMMU
    geometry: one 640 x 640 image (5 views) and its question, a 300-token
    continuation, mc_num 16 in one round of b = 16 rows: weight-only on
    the int8 prefill tree (two forward chunks of 8 rows), then with
    loglik_act_int8 (W8A8, four chunks of 4)."""
    from PIL import Image

    from lavida_mod_tpu_torch.eval.adapter import LavidaEvalModel

    rng = np.random.default_rng(6)
    img = Image.fromarray(rng.integers(0, 255, (640, 640, 3),
                                       dtype=np.uint8))
    question = ("Question: which of the options best describes the scene "
                "in the image? Options: (A) a street (B) a kitchen (C) a "
                "field (D) a river. Answer with the option's letter.")
    cont = "".join(chr(97 + i) for i in rng.integers(0, 26, 300))
    ev = LavidaEvalModel(model, _CharTokenizer())
    out = {}
    for act in (False, True):
        ev.loglik_act_int8 = act
        ll, wall, peak, got = _counted(
            torch, lambda: ev.loglikelihood(question, [img], cont))
        chunks = 4 if act else 2
        _check(f"loglik act_int8={act}", got, _want(
            short_attention=SIGLIP_LAYERS + LLADA_LAYERS * chunks,
            fused_vit_mlp=SIGLIP_LAYERS,
            w8a8_matmul=4 * LLADA_LAYERS * chunks if act else 0))
        if not (np.isfinite(ll) and ll < 0):
            raise AssertionError(f"log-likelihood {ll}")
        out[act] = (ll, wall, peak, got)
        print(f"[loglik] LavidaEvalModel.loglikelihood (mixed model, the "
              f"int8 prefill tree, act_int8 {act}; 16 rows of P + 300, "
              f"{chunks} forward chunks): {ll:.4f}, wall {wall * 1e3:.1f} "
              f"ms, peak {peak:.2f} GiB, launches "
              f"{ {k: v for k, v in got.items() if v} } ({card})")
    a, b = out[False][0], out[True][0]
    if abs(a - b) / abs(a) > 0.05:
        raise AssertionError(f"weight-only {a} and act_int8 {b} differ by "
                             f"more than 5 %")
    return out


TINY_ROUTES = ("no cache", "dLLM r=8", "verbose", "draft")


def _tiny_commit_ok(torch, x, got, want, ref, logits, k, b_end, mask):
    """Whether a step's commits on the card (got [1, G]) are the CPU's
    (want) from the same buffer x, but for a near-tie at the CPU's logits
    ref: the k-th and (k+1)-th log-confidences of the masked rows before
    b_end within 4 * delta (delta = max |logits - ref|), or a committed
    token's top two logits within 2 * delta (the rule of the repo's
    teacher-forced tests).  Returns 0 (equal), 1 (a near-tie) or raises."""
    if torch.equal(got, want):
        return 0
    delta = (logits - ref).abs().max().item()
    G = x.shape[1]
    got_set, want_set = got[0] != x[0], want[0] != x[0]
    if not torch.equal(got_set, want_set):
        masked = (x[0] == mask) & (torch.arange(G) < b_end)
        conf = torch.softmax(ref[0], -1).amax(-1)[masked]
        top = torch.sort(conf.log(), descending=True).values
        gap = (top[k - 1] - top[k]).item() if k < len(top) else 0.0
        if gap > 4 * delta:
            raise AssertionError(f"commit set differs, gap {gap} > "
                                 f"4 * {delta}")
        return 1
    for t in torch.nonzero(got_set & (got[0] != want[0]))[:, 0]:
        top2 = torch.topk(ref[0, t], 2).values
        if (top2[0] - top2[1]).item() > 2 * delta:
            raise AssertionError(f"token at {int(t)} differs")
    return 1


def tiny_route_steps(torch, cpu, gpu, prefix, route):
    """Every step of one `generate` route of a tiny model (G 32, 16 steps,
    B = 1), run on the card from the CPU's state before it: the no-cache
    step (`denoise_full`), the dLLM step (`dllm_step`, r = 8 < G: the
    scatter mode writing the K/V of the chosen rows in place), the
    verbose route's read-only cached step (`denoise_readonly`, the concat
    mode) and the write-index step from a drafted buffer
    (`denoise_cached`).  At each step the logits on the card (for dLLM
    the whole logits cache and the K/V cache after the write) are within
    5e-2 of max |CPU value|, and its commits are the CPU's but for
    near-ties (`_tiny_commit_ok`).  Returns (steps, worst relative
    difference, near-ties)."""
    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.generation import diffusion as td

    mask = cpu.cfg.mask_token_id
    P, G = prefix.shape[1], 32
    gen = GenerationConfig(max_new_tokens=G, block_length=G, steps=16,
                           prefix_lm=route != "no cache")
    x = torch.full((1, G), mask)
    if route == "draft":
        x[0, :6] = torch.tensor([5, mask, 7, 8, mask, 9])
    off = 0 if gen.prefix_lm else P
    kt, be = td.build_control_table(
        np.concatenate([np.zeros((1, off), np.int64), x.numpy()], 1), off,
        G, gen, mask)
    kt, be = torch.as_tensor(kt), torch.as_tensor(be)
    sample = (None, 0.0, "low_confidence")
    dev = gpu.wte.weight.device
    pos = torch.arange(P, P + G)

    def run(m, st, x, i):
        """(logits [1, G, V] f32, x after the step, state after it)."""
        d = m.wte.weight.device
        pre, ki, bi = prefix.to(d), kt[i:i + 1].to(d), be[i:i + 1].to(d)
        if route == "no cache":
            lg = m(torch.cat([pre, m.embed_tokens(x)], 1), logits_from=P)[0]
            return lg, td.denoise_full(m, x, pre, ki, bi, None, *sample), st
        if route == "verbose":
            lg = m(m.embed_tokens(x), positions=pos.to(d), kv_cache=st)[0]
            return lg, td.denoise_readonly(m, x, st, ki, bi, None,
                                           *sample), st
        if route == "draft":
            lg = m(m.embed_tokens(x), positions=pos.to(d), kv_cache=st,
                   kv_write_index=P, use_cache=True)[0]
            return lg, td.denoise_cached(m, x, st, ki, bi, None,
                                         *sample), st
        (lc, ch, stale), cache = st
        xn, lc, ch, stale = td.dllm_step(m, x, lc, ch, stale, cache, None,
                                         ki[0], bi[0], 8, *sample)
        return lc.float(), xn, ((lc, ch, stale), cache)

    def rel(a, b):
        return ((a.float().cpu() - b.float()).abs().max()
                / b.float().abs().max()).item()

    with torch.no_grad():
        if route == "dLLM r=8":
            (_, *carry), cache, _ = td.dllm_init(cpu, x, prefix)
            st_c = (tuple(carry), cache)
        else:
            make = td.prefill if route == "verbose" else (
                lambda m, p: td.prefill_cache(m, p, G))
            st_c = None if route == "no cache" else make(cpu, prefix)
            st_g = None if route == "no cache" else make(gpu, prefix.to(dev))
        worst, near = 0.0, 0
        for i in range(kt.shape[0]):
            if route == "dLLM r=8":     # the card starts from the CPU's state
                (lc, ch, stale), cache = st_c
                st_g = tuple(
                    [t.to(dev, copy=True) for t in ts]
                    for ts in ((lc, ch, stale), *cache))
                st_g = (st_g[0], st_g[1:])
            lg_g, x_g, st_g = run(gpu, st_g, x.to(dev), i)
            lg_c, x_c, st_c = run(cpu, st_c, x, i)
            diffs = [rel(lg_g, lg_c)]
            if route == "dLLM r=8":
                diffs += [rel(a, b) for kv_g, kv_c in zip(st_g[1], st_c[1])
                          for a, b in zip(kv_g, kv_c)]
            worst = max(worst, *diffs)
            if not max(diffs) < 5e-2:
                raise AssertionError(f"tiny {route} step {i}: {diffs}")
            near += _tiny_commit_ok(torch, x, x_g.cpu(), x_c, lg_c,
                                    lg_g.float().cpu(), int(kt[i, 0]),
                                    int(be[i]) - off, mask)
            x = x_c
    if (x == mask).any():
        raise AssertionError(f"tiny {route}: mask tokens left")
    return kt.shape[0], worst, near


def phase_small_branches(torch, device):
    """The tiny bf16 model on the card against the same weights on the
    CPU: every step of the no-cache, dLLM (r < G), verbose and draft
    routes from the CPU's state (`tiny_route_steps`), each route's whole
    generation on the card (no mask left), and one log-likelihood round
    with the same counts and ranks."""
    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.generation import diffusion
    from lavida_mod_tpu_torch.generation import log_likelihood as tll
    from lavida_mod_tpu_torch.models.llada import LLaDA
    from lavida_mod_tpu_torch.predict import tiny_config

    lcfg = tiny_config().llada
    cpu = LLaDA(lcfg, "cpu", torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    gpu = LLaDA(lcfg, device, torch.bfloat16)
    gpu.load_state_dict(cpu.state_dict())
    prefix = torch.randn(1, 40, lcfg.d_model, generator=g).bfloat16()
    mask = lcfg.mask_token_id
    draft = np.array([[5, mask, 7, 8, mask, 9]])
    line = []
    for route, gkw, kw in zip(TINY_ROUTES, (dict(prefix_lm=False), {}, {}, {}),
                              ({}, dict(dllm_cache=8), dict(verbose=True),
                               dict(draft_tokens=draft))):
        n, worst, near = tiny_route_steps(torch, cpu, gpu, prefix, route)
        gen = GenerationConfig(max_new_tokens=32, block_length=32, steps=16,
                               **gkw)
        out = diffusion.generate(gpu, prefix.to(device), gen, **kw)
        if route == "verbose":
            out, hist = out
            if len(hist) != 16 or not (hist[-1] == out.cpu().numpy()).all():
                raise AssertionError("verbose history")
        if (out == mask).any():
            raise AssertionError(f"tiny {route}: mask tokens left")
        line.append(f"{route}: {n} steps, worst {worst:.3e}, near-ties "
                    f"{near}")
    with torch.no_grad():
        answer = torch.randint(3, 400, (70,), generator=g)
        counts, ranks = tll.draw_round(g, 70, 16, "cpu")
        lref = float(tll.mc_round(cpu, prefix, answer, counts, ranks))
        lgot = float(tll.mc_round(gpu, prefix.to(device), answer.to(device),
                                  counts.to(device), ranks.to(device),
                                  use_flash=True))
    lrel = abs(lgot - lref) / abs(lref)
    print(f"[check] tiny bf16 model, each step on the card from the CPU's "
          f"state (logits and the dLLM K/V within 5e-2 of max |CPU value|, "
          f"commits equal but for near-ties): {'; '.join(line)}; one "
          f"log-likelihood round with the same draws {lgot:.4f} vs "
          f"{lref:.4f} ({lrel:.3e}, limit 2e-2)")
    if not lrel < 2e-2:
        raise AssertionError(f"tiny log-likelihood round differs: {lrel}")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, payload, timeout=900):
    import urllib.request

    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _want_worker(B, images, single, steps=STEPS):
    """Launches of one worker call in the mixed layout with fuse=False and
    the int4 KV cache: a B-row batch (generate_batch: one prefill call
    through the int8 tree, the vision MLP fused) or a single request
    (generate_fused: the one-gather splice).  The prefill runs the seven
    int8 linears of each unfused block, every int4 decode linear #4's
    decode kernel; the head is fused into w4_qkv_norm up to 128 rows.
    `steps`: the denoise steps of the request's gen_kwargs."""
    want = {k: 0 for k in _batch_ops()}
    want["short_attention"] = SIGLIP_LAYERS * images + LLADA_LAYERS
    want["fused_vit_mlp"] = 0 if single else SIGLIP_LAYERS * images
    want["gather_rows"] = 1 if single else 0
    want["w8a8_matmul"] = LLADA_LINEARS * LLADA_LAYERS   # unfused blocks
    want["w4_matmul_grouped_decode"] = LLADA_LINEARS * LLADA_LAYERS * steps
    want["w4_matmul_grouped"] = want["w4_matmul_grouped_decode"]
    want["w4_qkv_norm"] = steps if B * 32 <= 128 else 0
    want["kv8_decode_attention"] = LLADA_LAYERS * steps
    want["kv8_decode_attention_int4"] = LLADA_LAYERS * steps
    return want


def phase_server(torch, device, card, path):
    """The port's controller and a worker (`serve.worker` with --model-path
    <phase 7's checkpoint> --mixed --kv4 --decode-batch 4) in threads on
    127.0.0.1: the worker registers, four concurrent requests dispatched
    through the controller merge into one batch of 4, one OpenAI chat
    request and one single request take the batcher's B = 1 route.  The
    counts are set to 0 before each and read after.  The checkpoint is
    deleted at the end."""
    import shutil
    import threading

    from lavida_mod_tpu_torch.eval.adapter import gen_kwargs_to_config
    from lavida_mod_tpu_torch.ops.schedules import resolve_steps
    from lavida_mod_tpu_torch.serve import worker as sw
    from lavida_mod_tpu_torch.serve.controller import Controller

    try:
        import PIL  # noqa: F401
        has_pil = True
    except ImportError:
        has_pil = False
    servers = []
    worker = None
    try:
        controller = Controller()
        cs = controller.server("127.0.0.1", 0)
        servers.append(cs)
        threading.Thread(target=cs.serve_forever, daemon=True).start()
        curl = f"http://127.0.0.1:{cs.server_address[1]}"
        wport = _free_port()
        wurl = f"http://127.0.0.1:{wport}"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        args = sw.parse_args([
            "--model-path", str(path), "--mixed", "--kv4",
            "--decode-batch", "4", "--batch-window-ms", "500",
            "--controller-address", curl, "--worker-address", wurl,
            "--host", "127.0.0.1", "--port", str(wport)])
        worker = sw.build_worker(args)
        ws = worker.server(args.host, args.port)
        servers.append(ws)
        threading.Thread(target=ws.serve_forever, daemon=True).start()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        em = worker.eval_model
        llada = em.model.llada
        blk = llada.blocks[0]
        if not (em.kv8 == 4 and em.model.mixed and not blk.fused_plan(32, False)
                and blk.cfg.block_type == "llama"):
            raise AssertionError("the worker's layout is not mixed, unfused, "
                                 "kv4")
        if list(controller.worker_info) != [wurl]:
            raise AssertionError(f"registry {controller.worker_info}")
        print(f"[server] controller {curl}, worker {wurl} registered; "
              f"checkpoint loaded and laid out (mixed, fuse=False: "
              f"--decode-batch 4) in {load_s:.2f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; PIL "
              f"{'present' if has_pil else 'absent'} ({card})")

        rng = np.random.default_rng(7)
        texts = [f"Describe image {i}: what is in it and where?"
                 for i in range(4)]
        gen_kw = {"max_new_tokens": 32, "block_length": 32,
                  "step_per_block": STEPS}
        images = []
        if has_pil:
            import base64
            import io

            from PIL import Image

            for i, (w, h) in enumerate(BATCH_SIZES):
                img = Image.fromarray(rng.integers(0, 255, (h, w, 3),
                                                   dtype=np.uint8))
                buf = io.BytesIO()
                img.save(buf, "PNG")
                images.append([base64.b64encode(buf.getvalue()).decode()])
        else:
            images = [[] for _ in texts]
            print("[server] PIL is absent on this machine: the HTTP requests "
                  "carry text only, and the four image requests run through "
                  "the worker model's generate_batch (generate_until_batch's "
                  "inner call) with seeded views")
        ops = _batch_ops()
        # every answer's ids, as the worker's model decodes them
        decoded = []
        decode = em.model.decode_output

        def recording(ids, tokenizer, stop_ids=None):
            text = decode(ids, tokenizer, stop_ids)
            decoded.append((np.asarray(ids), text))
            return text

        em.model.decode_output = recording
        vocab = em.model.cfg.llada.vocab_size
        mask = em.model.cfg.llada.mask_token_id

        def check_answers(texts_got, n):
            rows = decoded[-n:]
            if len(decoded) < n or any(
                    ids.shape != (32,) or (ids == mask).any()
                    or ids.max() >= vocab for ids, _ in rows):
                raise AssertionError(f"answer ids {rows}")
            if sorted(texts_got) != sorted(t for _, t in rows):
                raise AssertionError(f"answers {texts_got} are not the "
                                     f"decodes {[t for _, t in rows]}")

        def batch_of_4(tag):
            answers = [None] * 4

            def call(i):
                answers[i] = _post(curl + "/worker_generate_stream", {
                    "model": args.model_name, "prompt": texts[i],
                    "images": images[i], "gen_kwargs": gen_kw})

            ts = [threading.Thread(target=call, args=(i,)) for i in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            return answers

        batch_of_4("warm-up")
        walls, counts = {}, {}
        for op in ops.values():
            op.launches = 0
        sizes0 = len(worker.batcher.served_sizes)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        answers = batch_of_4("timed")
        walls["batch4"] = time.perf_counter() - t0
        counts["batch4"] = {k: op.launches for k, op in ops.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        served = worker.batcher.served_sizes[sizes0:]
        n_img = 4 if has_pil else 0
        want = _want_worker(4, n_img, False)
        print(f"[server] four concurrent /worker_generate_stream requests "
              f"through the controller ({'images ' + str(BATCH_SIZES) if has_pil else 'text only'}): "
              f"served as {served}, wall {walls['batch4'] * 1e3:.1f} ms, "
              f"peak {peak:.2f} GiB ({card}); launches {counts['batch4']}")
        for i, a in enumerate(answers):
            print(f"[server] answer {i}: error_code {a.get('error_code')}, "
                  f"latency {a.get('latency_s', 0) * 1e3:.1f} ms, text "
                  f"{a.get('text')!r}")
        if served != [(4, 4)]:
            raise AssertionError(f"the four requests were served as {served}")
        if any(a.get("error_code") != 0 for a in answers):
            raise AssertionError(f"answers {answers}")
        check_answers([a["text"] for a in answers], 4)
        print(f"[server] the batch's ids (32 each, no mask, below the vocab "
              f"{vocab}) decode to the answers; request 0's ids "
              f"{decoded[-4][0].tolist()} (ids outside the checkpoint's "
              f"trained BPE vocabulary decode to nothing)")
        if counts["batch4"] != want:
            raise AssertionError(f"batch launches {counts['batch4']}, want "
                                 f"{want}")

        if not has_pil:
            # the four image requests: generate_until_batch's inner call,
            # with the seeded views of four anyres sizes
            from lavida_mod_tpu_torch.config import GenerationConfig
            from lavida_mod_tpu_torch.eval.adapter import generate_batch

            reqs = []
            for size in BATCH_SIZES:
                ids, views, _ = bench_request(48, size, rng)
                reqs.append((ids, [views], [size]))
            gen = GenerationConfig(**GEN)
            for op in ops.values():
                op.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _ = generate_batch(em.model, reqs, gen, kv8=em.kv8)
            walls["batch4_images"] = time.perf_counter() - t0
            counts["batch4_images"] = {k: op.launches for k, op in ops.items()}
            text = [em.model.decode_output(row, em.tokenizer) for row in out]
            print(f"[server] the four image requests {BATCH_SIZES} through "
                  f"the worker model's generate_batch(kv8=4): wall "
                  f"{walls['batch4_images'] * 1e3:.1f} ms ({card}); launches "
                  f"{counts['batch4_images']}; texts {text}")
            if counts["batch4_images"] != _want_worker(4, 4, False):
                raise AssertionError(f"image batch launches "
                                     f"{counts['batch4_images']}")
            if (out == em.model.cfg.llada.mask_token_id).any():
                raise AssertionError("mask tokens left in the image batch")

        # one OpenAI chat request and one single request: the B = 1 route
        for op in ops.values():
            op.launches = 0
        t0 = time.perf_counter()
        chat = _post(wurl + "/v1/chat/completions", {
            "model": args.model_name, "max_tokens": 32,
            "messages": [{"role": "user", "content": texts[0]}]})
        walls["chat"] = time.perf_counter() - t0
        counts["chat"] = {k: op.launches for k, op in ops.items()}
        for op in ops.values():
            op.launches = 0
        t0 = time.perf_counter()
        single = _post(curl + "/worker_generate_stream", {
            "model": args.model_name, "prompt": texts[1],
            "images": images[1], "gen_kwargs": gen_kw})
        walls["single"] = time.perf_counter() - t0
        counts["single"] = {k: op.launches for k, op in ops.items()}
        print(f"[server] /v1/chat/completions: wall {walls['chat'] * 1e3:.1f}"
              f" ms, launches {counts['chat']}, answer "
              f"{chat['choices'][0]['message']['content']!r}; single request"
              f" through the controller: wall {walls['single'] * 1e3:.1f} ms, "
              f"launches {counts['single']}, answer {single.get('text')!r}; "
              f"served sizes {worker.batcher.served_sizes} ({card})")
        if chat.get("object") != "chat.completion" \
                or single.get("error_code") != 0:
            raise AssertionError(f"chat {chat}, single {single}")
        check_answers([single["text"]], 1)
        # the chat request's gen_kwargs are {max_new_tokens: 32}: the
        # adapter's defaults give it one block of 32 steps
        gen = gen_kwargs_to_config({"max_new_tokens": 32})
        chat_steps = resolve_steps(gen.max_new_tokens, gen.block_length,
                                   gen.steps, gen.step_per_block)[1]
        if counts["chat"] != _want_worker(1, 0, True, chat_steps):
            raise AssertionError(f"chat launches {counts['chat']}")
        if counts["single"] != _want_worker(1, n_img // 4, True):
            raise AssertionError(f"single launches {counts['single']}")
        if worker.batcher.served_sizes[-2:] != [(1, 1), (1, 1)]:
            raise AssertionError("the lone requests were not served alone")

        # the device-busy share of one batch of the worker's model
        share = _print_profile("server", _profile_busy(
            torch, lambda: em.generate_until_batch(
                texts, [[] for _ in texts], gen_kw)),
            "one B = 4 text batch of the worker", card)
        return counts, walls, peak, share
    finally:
        if worker is not None:
            worker.close()
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        shutil.rmtree(path, ignore_errors=True)


def phase_train_kernels(torch, device, res):
    """The three prefix-LM flash attention kernels against their plain
    versions, SDPA and their bounds at the stage-1 shape (per step: 2 x 32
    forward launches, with the checkpoint's recompute, 32 dq, 32 dkv) and
    a ragged GQA case."""
    import torch.nn.functional as F

    from lavida_mod_tpu_torch.ops import prefix_flash as tpf

    gen = torch.Generator(device=device).manual_seed(9)
    # (name, B, T, Hq, Hkv, prefix lengths, valid keys, per-step launches)
    plen1 = [1010 - 9 * i for i in range(4)] * 2
    cases = [("stage1", 8, 1152, 32, 32, plen1, [p + 48 for p in plen1],
              (2 * LLADA_LAYERS, LLADA_LAYERS, LLADA_LAYERS)),
             # the Dream-7B stage-1 step (phase 16): B = 4 doubled, GQA
             # 28 / 4; weighed 0 in the stage-1 sums
             ("dream_step", 8, 1152, DREAM_LAYERS, 4, plen1,
              [p + 48 for p in plen1], (0, 0, 0)),
             ("gqa_ragged", 2, 200, 28, 4, [0, 250], [193, 200], (0, 0, 0))]
    hd = 128
    for name, B, T, Hq, Hkv, plen, nvalid, per in cases:
        q = torch.randn(B, T, Hq, hd, generator=gen, device=device).bfloat16()
        k, v = (torch.randn(B, T, Hkv, hd, generator=gen,
                            device=device).bfloat16() for _ in range(2))
        dout = torch.randn(B, T, Hq, hd, generator=gen,
                           device=device).bfloat16()
        pl = torch.tensor(plen, dtype=torch.int32, device=device)
        valid = (torch.arange(T, device=device)[None]
                 < torch.tensor(nvalid, device=device)[:, None]).int()
        o, lse = tpf.prefix_flash_fwd(q, k, v, pl, valid)
        torch.cuda.synchronize()
        o_ref, lse_ref = tpf.prefix_flash_fwd_reference(q, k, v, pl, valid)
        # p is rounded to bf16 per 128-key tile against the running max (the
        # plain version once against the row max); sums run in another order.
        # Read on an H100: o within 2.0e-3 (stage1) and 3.9e-3 (gqa_ragged,
        # one bf16 ulp at |o| >= 0.5); dq, dk, dv within 1.3e-3 - 2.9e-3 of
        # the tensor's max.
        torch.testing.assert_close(o.float(), o_ref.float(), atol=8e-3,
                                   rtol=0)
        torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-4)
        delta = tpf.attention_delta(dout, o_ref)
        args = (q, k, v, pl, valid, dout, lse_ref, delta)
        dq = tpf.prefix_flash_dq(*args)
        dk, dv = tpf.prefix_flash_dkv(*args)
        torch.cuda.synchronize()
        dq_ref = tpf.prefix_flash_dq_reference(*args)
        dk_ref, dv_ref = tpf.prefix_flash_dkv_reference(*args)
        errs = {"o": (o.float() - o_ref.float()).abs().max().item(),
                "dq": _rel(dq, dq_ref), "dk": _rel(dk, dk_ref),
                "dv": _rel(dv, dv_ref)}
        for n in ("dq", "dk", "dv"):
            if not errs[n] < 8e-3:
                raise AssertionError(f"prefix_flash {n} at {name}: "
                                     f"{errs[n]} (limit 8e-3 of max)")
        del o_ref, dq_ref, dk_ref, dv_ref
        # the library: SDPA with the same boolean mask, and its autograd
        # backward (dq, dk and dv in one call)
        qpos = torch.arange(T, device=device)
        see = ((qpos[None, None, :] < pl[:, None, None])
               | (qpos[None, :, None] >= pl[:, None, None])) \
            & valid.bool()[:, None, :]
        mask = see[:, None]
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        gqa = dict(enable_gqa=True) if Hq != Hkv else {}
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, **gqa)
        lib_fwd, lib_fwd_b2b = cuda_ms(sdpa, 10), cuda_ms(sdpa, 10,
                                                          hold=False)
        with torch.enable_grad():
            out = sdpa()
        dot = dout.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        lib_bwd, lib_bwd_b2b = cuda_ms(sdpa_bwd, 10), cuda_ms(sdpa_bwd, 10,
                                                              hold=False)
        # the bound counts the (query, key) pairs this run's masks leave
        # visible: keys past the valid tail and, for a query inside the
        # prefix, keys past the prefix need no work
        flops = int(see.sum()) * Hq * hd
        del out, qt, kt, vt, mask, see
        io = 2 * (q.numel() + k.numel() + v.numel()) + 4 * B * T
        rows = 4 * B * Hq * T
        shape = f"{name} q[{B},{T},{Hq},{hd}] kv heads {Hkv}"
        res.add("prefix_flash_fwd", shape, per[0], max(errs["o"], 0.0),
                lambda: tpf.prefix_flash_fwd(q, k, v, pl, valid),
                cuda_ms(lambda: tpf.prefix_flash_fwd_reference(
                    q, k, v, pl, valid), 3), lib_fwd, 4 * flops,
                io + 2 * q.numel() + rows, note=" (o abs, limit 8e-3)",
                library_b2b=lib_fwd_b2b)
        res.add("prefix_flash_dq", shape, per[1], errs["dq"],
                lambda: tpf.prefix_flash_dq(*args),
                cuda_ms(lambda: tpf.prefix_flash_dq_reference(*args), 3),
                lib_bwd, 6 * flops, io + 4 * q.numel() + 2 * rows,
                note=" (relative, limit 8e-3; library = SDPA's whole "
                     "backward)", library_b2b=lib_bwd_b2b)
        res.add("prefix_flash_dkv", shape, per[2],
                max(errs["dk"], errs["dv"]),
                lambda: tpf.prefix_flash_dkv(*args),
                cuda_ms(lambda: tpf.prefix_flash_dkv_reference(*args), 3),
                lib_bwd, 8 * flops,
                io + 2 * q.numel() + 2 * rows + 2 * (k.numel() + v.numel()),
                note=" (relative, limit 8e-3; library = SDPA's whole "
                     "backward)", library_b2b=lib_bwd_b2b)
        del q, k, v, dout, dq, dk, dv, o, args
        torch.cuda.empty_cache()


def prefix_flash_summary(res, card):
    """#10 at the stage-1 shape, per launch and per step: the forward
    against SDPA's forward, dq + dkv against SDPA's whole backward, each
    beside its bound, device time and back to back."""
    fwd, dq, dkv = (res.get(n)["per_shape"][0] for n in (
        "prefix_flash_fwd", "prefix_flash_dq", "prefix_flash_dkv"))
    bwd = {k: dq[k] + dkv[k] for k in ("ms", "ms_back_to_back", "bound_ms")}
    for what, r, lib_name in (("forward", fwd, "SDPA's forward"),
                              ("dq + dkv", bwd, "SDPA's whole backward")):
        lib = fwd["library_ms"] if r is fwd else dq["library_ms"]
        print(f"[kernels] prefix_flash {what} at the stage-1 shape, per "
              f"launch: {r['ms']:.4f} ms (back to back "
              f"{r['ms_back_to_back']:.4f} ms), {lib_name} {lib:.4f} ms "
              f"(kernel {r['ms'] / lib:.2f}x its time), bound "
              f"{r['bound_ms']:.4f} ms (kernel at "
              f"{100 * r['bound_ms'] / r['ms']:.1f} % of it) ({card})")
    for name in ("prefix_flash_fwd", "prefix_flash_dq", "prefix_flash_dkv"):
        res.summary(name, "one stage-1 step (64 fwd with the remat "
                    "recompute, 32 dq, 32 dkv)", card)
    dfwd, ddq, ddkv = (next(r for r in res.get(n)["per_shape"]
                            if r["shape"].startswith("dream_step"))
                       for n in ("prefix_flash_fwd", "prefix_flash_dq",
                                 "prefix_flash_dkv"))
    step = (2 * DREAM_LAYERS * dfwd["ms"]
            + DREAM_LAYERS * (ddq["ms"] + ddkv["ms"]))
    bound = (2 * DREAM_LAYERS * dfwd["bound_ms"]
             + DREAM_LAYERS * (ddq["bound_ms"] + ddkv["bound_ms"]))
    lib = (2 * DREAM_LAYERS * dfwd["library_ms"]
           + DREAM_LAYERS * ddq["library_ms"])
    print(f"[kernels] prefix_flash at the Dream step's shape [8,1152,28/4,"
          f"128]: fwd {dfwd['ms']:.4f} ms (SDPA {dfwd['library_ms']:.4f}, "
          f"bound {dfwd['bound_ms']:.4f}), dq + dkv "
          f"{ddq['ms'] + ddkv['ms']:.4f} ms (SDPA's backward "
          f"{ddq['library_ms']:.4f}, bound "
          f"{ddq['bound_ms'] + ddkv['bound_ms']:.4f}); per Dream step (56 "
          f"fwd, 28 dq, 28 dkv) {step:.2f} ms against SDPA's {lib:.2f} ms "
          f"and the bound {bound:.2f} ms ({100 * bound / step:.1f} %) "
          f"({card})")


TRAIN_TEXT, TRAIN_CAPTION = 8, 40


def train_batch(cfg, sizes, rng, seq_bucket=128, view_bucket=8):
    """A stage-1/2 batch as train.py's make_batch builds it (train.py:
    319-357): one image per sample between an 8-token prompt and a 40-token
    caption that carries the labels, the plan padded to a multiple of
    seq_bucket and the views to a multiple of view_bucket (zero views)."""
    from lavida_mod_tpu_torch.data.anyres import anyres_grid_shape
    from lavida_mod_tpu_torch.models.multimodal import build_gather_plan

    S = cfg.vision.siglip.image_size
    ids, labels, views, n_views = [], [], [], []
    for size in sizes:
        nw, nh = anyres_grid_shape(size, cfg.vision.grid_pinpoints, S)
        views.append(rng.uniform(-1, 1, (1 + nw * nh, 3, S, S)).astype(
            np.float32))
        n_views.append([views[-1].shape[0]])
        text = rng.integers(3, min(30000, cfg.llada.mask_token_id),
                            TRAIN_TEXT + TRAIN_CAPTION)
        row = np.concatenate([text[:TRAIN_TEXT], [-200], text[TRAIN_TEXT:]])
        lab = row.copy()
        lab[:TRAIN_TEXT + 1] = -100
        ids.append(row)
        labels.append(lab)
    plan = (cfg, ids, n_views, [[s] for s in sizes], labels)
    T = build_gather_plan(*plan)[0].shape[1]
    gather_idx, text_ids, _, labels = build_gather_plan(
        *plan, pad_to=-(-T // seq_bucket) * seq_bucket)
    pix = np.concatenate(views)
    NV = -(-pix.shape[0] // view_bucket) * view_bucket
    pix = np.concatenate([pix, np.zeros((NV - pix.shape[0],) + pix.shape[1:],
                                        np.float32)])
    return {"pixel_values": pix, "text_ids": text_ids,
            "gather_idx": gather_idx, "labels": labels}


def _train_ops():
    from lavida_mod_tpu_torch.ops import prefix_flash as tpf
    from lavida_mod_tpu_torch.ops.gather import gather_rows
    from lavida_mod_tpu_torch.ops.short_attention import short_attention

    return {"prefix_flash_fwd": tpf.prefix_flash_fwd,
            "prefix_flash_dq": tpf.prefix_flash_dq,
            "prefix_flash_dkv": tpf.prefix_flash_dkv,
            "gather_rows": gather_rows, "short_attention": short_attention}


def _checksums(torch, modules):
    """Per parameter: the sum of its bf16 bit patterns, the f64 sum of its
    squares and the bit sum of a strided subset (a change of any weight
    moves them)."""
    out = []
    with torch.no_grad():
        for m in modules:
            for p in m.parameters():
                bits = p.detach().reshape(-1).view(torch.int16)
                out.append(torch.stack([
                    bits.sum(dtype=torch.int64).double(),
                    p.detach().double().square().sum(),
                    bits[::97].sum(dtype=torch.int64).double()]))
    return torch.stack(out).cpu()


STAGE1_STEPS = 100


def phase_stage1(torch, device, card):
    """Stage-1 pretraining steps at full LaViDa-LLaDA-8B."""
    from lavida_mod_tpu_torch.config import LaViDaConfig
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.train.step import (init_train_state,
                                                 make_freeze_optimizer,
                                                 make_multimodal_train_step)

    cfg = LaViDaConfig()
    t0 = time.perf_counter()
    model = LaViDa.random_init(cfg, 0, torch.bfloat16, device)
    opt = make_freeze_optimizer(
        "mm_mlp_adapter", lr=1e-3,
        warmup_steps=int(0.03 * STAGE1_STEPS), total_steps=STAGE1_STEPS)
    state = init_train_state(model, opt, torch.bfloat16)
    step = make_multimodal_train_step(
        cfg, opt, remat="whole_layer", ce_chunk=512,
        attention_impl="prefix_flash")
    torch.cuda.synchronize()
    n_train = sum(m.numel() for m in state.masters.values())
    print(f"[stage1] LaViDaConfig() bf16 random init + train state on the "
          f"card in {time.perf_counter() - t0:.2f} s: "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params,"
          f" {n_train / 1e6:.3f} M trainable (projector + image_newline, "
          f"f32 masters) ({card})")
    rng = np.random.default_rng(10)
    batch = train_batch(cfg, BATCH_SIZES, rng)
    B, T = batch["labels"].shape
    gen = torch.Generator(device=device).manual_seed(0)
    frozen = [model.llada, model.siglip]
    sums0 = _checksums(torch, frozen)
    tunable = {n: m.clone() for n, m in state.masters.items()}
    ops = _train_ops()
    # the frozen tower runs under autograd (grad_norm covers every leaf):
    # its layers' remat recompute launches short_attention again
    want = {"prefix_flash_fwd": 2 * LLADA_LAYERS,
            "prefix_flash_dq": LLADA_LAYERS,
            "prefix_flash_dkv": LLADA_LAYERS, "gather_rows": 1,
            "short_attention": 2 * SIGLIP_LAYERS}

    m = step(state, batch, gen)                 # warm-up: the LR is 0 here
    torch.cuda.synchronize()
    if not all(torch.equal(state.masters[n], t) for n, t in tunable.items()):
        raise AssertionError("a master moved at LR 0")
    for op in ops.values():
        op.launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], [m["loss"].item()]
    for i in range(3):
        before = {k: op.launches for k, op in ops.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, batch, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = {k: op.launches - before[k] for k, op in ops.items()}
        losses.append(m["loss"].item())
        nv = batch["pixel_values"].shape[0]
        print(f"[stage1] step {i + 1}: B={B} T={T} ({nv} views): wall "
              f"{walls[-1] * 1e3:.1f} ms, loss "
              f"{losses[-1]:.4f}, acc_mask {m['acc_mask'].item():.4f}, "
              f"grad_norm {m['grad_norm'].item():.4e}, launches {got} "
              f"({card})")
        if got != want:
            raise AssertionError(f"launches {got}, want {want}")
        if i == 0:
            moved = {n.split(".")[0] for n, t in tunable.items()
                     if not torch.equal(state.masters[n], t)}
            if moved != {"projector", "image_newline"}:
                raise AssertionError(f"after the first step with a nonzero "
                                     f"LR only {moved} moved")
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = {k: op.launches for k, op in ops.items()}
    if not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    if not torch.equal(_checksums(torch, frozen), sums0):
        raise AssertionError("a frozen LLaDA or SigLIP weight changed")
    wall = float(np.mean(walls))
    print(f"[stage1] 3 steps: wall {wall * 1e3:.1f} ms per step (min "
          f"{min(walls) * 1e3:.1f}), {B * T / wall:.0f} data tokens/s (B x T"
          f" = {B * T}), peak {peak:.2f} GiB; frozen LLaDA + SigLIP weights "
          f"bit-identical, projector + image_newline moved ({card})")
    prof = _profile_busy(torch, lambda: step(state, batch, gen))
    share = _print_profile("stage1", prof, "one step", card)
    attn = None
    if prof is not None:
        print_by_kind("stage1", prof[3], "the profiled step")
        attn = {k: sum(ms for key, ms, _ in prof[3] if f"prefix_flash_{k}_"
                       in key) for k in ("fwd", "dq", "dkv")}
        print(f"[stage1] #10 device time in the profiled step: fwd "
              f"{attn['fwd']:.2f} ms, dq {attn['dq']:.2f} ms, dkv "
              f"{attn['dkv']:.2f} ms, total {sum(attn.values()):.2f} ms; "
              f"step wall {wall * 1e3:.1f} ms, peak {peak:.2f} GiB ({card})")
    del state, model, step
    torch.cuda.empty_cache()
    return counts, {"wall_ms": wall * 1e3, "tokens_per_s": B * T / wall,
                    "peak_gib": peak, "busy": share, "B": B, "T": T,
                    "prefix_flash_ms": attn}


def phase_stage2(torch, device, card):
    """Stage-2 finetuning at full width, LLaDA depth cut to 4 layers."""
    from lavida_mod_tpu_torch.config import LaViDaConfig
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.ops.short_attention import short_attention
    from lavida_mod_tpu_torch.train.step import (init_train_state,
                                                 make_freeze_optimizer,
                                                 make_multimodal_train_step)

    full = LaViDaConfig()
    cfg = full.replace(llada=full.llada.replace(n_layers=4))
    torch.cuda.reset_peak_memory_stats()
    model = LaViDa.random_init(cfg, 1, torch.bfloat16, device)
    total = 10          # finetune_stage2.sh's warmup ratio 0.03 -> 0 steps
    opt = make_freeze_optimizer(
        "mm_mlp_adapter,mm_vision_tower,mm_language_model", lr=2e-5,
        vision_tower_lr=2e-6, grad_accum=2,
        warmup_steps=int(0.03 * total), total_steps=total)
    state = init_train_state(model, opt, torch.bfloat16)
    step = make_multimodal_train_step(
        cfg, opt, remat="whole_layer", ce_chunk=512,
        attention_impl="prefix_flash")
    n_train = sum(m.numel() for m in state.masters.values())
    print(f"[stage2] cut: LLaDA depth {full.llada.n_layers} -> "
          f"{cfg.llada.n_layers} layers (the only cut; widths, vocabulary "
          f"and the 26 SigLIP layers as LaViDaConfig()): {n_train / 1e9:.3f}"
          f" B trainable params, f32 masters + Adam moments + f32 "
          f"accumulator ({card})")

    def group_sums():
        out = {}
        with torch.no_grad():
            for n, m in state.masters.items():
                g = opt.label(n)
                out[g] = out.get(g, 0.0) + m.double().sum().item()
        return out

    rng = np.random.default_rng(11)
    gen = torch.Generator(device=device).manual_seed(1)
    sums0 = group_sums()
    vjp0 = short_attention.backward_calls
    metrics = []
    for i, sizes in enumerate((BATCH_SIZES[:2], BATCH_SIZES[2:])):
        batch = train_batch(cfg, sizes, rng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append({k: v.item() for k, v in
                        step(state, batch, gen).items()})
        torch.cuda.synchronize()
        sums = group_sums()
        moved = {g for g in sums if sums[g] != sums0[g]}
        print(f"[stage2] microstep {i + 1}: B=2 T={batch['labels'].shape[1]}"
              f" wall {(time.perf_counter() - t0) * 1e3:.1f} ms, {metrics[-1]}"
              f", groups moved {sorted(moved)} ({card})")
        if i == 0 and moved:
            raise AssertionError(f"{moved} moved before the update")
    if moved != {"base", "projector", "vision_tower"}:
        raise AssertionError(f"after the update only {moved} moved")
    vjp = short_attention.backward_calls - vjp0
    if vjp != 2 * SIGLIP_LAYERS:
        raise AssertionError(f"short_attention VJP ran {vjp} times")
    finite = all(np.isfinite(v) for m in metrics for v in m.values()) and all(
        bool(torch.isfinite(m).all()) for m in state.masters.values())
    if not finite:
        raise AssertionError("NaN or inf in the stage-2 step")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[stage2] one update (2 microsteps): every group moved, the "
          f"short-attention VJP ran {vjp} times, no NaN; peak {peak:.2f} GiB"
          f" ({card})")
    del state, model, step
    torch.cuda.empty_cache()
    return peak


def phase_small_train(torch, device):
    """One stage-2 microstep of a tiny LaViDa on the card (bf16 compute,
    kernels) and on the CPU (plain versions), same masters, same mask."""
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.models.multimodal import multimodal_embeds
    from lavida_mod_tpu_torch.predict import tiny_config
    from lavida_mod_tpu_torch.train.loss import diffusion_loss
    from lavida_mod_tpu_torch.train.step import (init_train_state,
                                                 make_freeze_optimizer,
                                                 make_multimodal_train_step)

    cfg = tiny_config()
    lr = 1e-3
    ref = LaViDa.random_init(cfg, 0, torch.float32, "cpu").state_dict()
    batch = train_batch(cfg, [(100, 60), (112, 112)],
                        np.random.default_rng(12), view_bucket=1)
    mask = torch.from_numpy(np.random.default_rng(13).random(
        batch["labels"].shape) < 0.5)
    out = {}
    for dev in ("cpu", device):
        model = LaViDa(cfg, "cpu", torch.float32)
        model.load_state_dict(ref)
        model.to(dev)
        opt = make_freeze_optimizer(
            "mm_mlp_adapter,mm_vision_tower,mm_language_model", lr=lr,
            warmup_steps=0, total_steps=10)
        state = init_train_state(model, opt, torch.bfloat16)
        pix = torch.as_tensor(batch["pixel_values"], device=dev)
        emb = multimodal_embeds(model, pix, batch["text_ids"],
                                batch["gather_idx"], remat=True)
        loss, _ = diffusion_loss(model.llada, emb,
                                 torch.as_tensor(batch["labels"]),
                                 masked_indices=mask,
                                 attention_impl="prefix_flash")
        loss.backward()
        params = dict(model.named_parameters())
        grads = {n: params[n].grad.float().cpu() for n in state.masters}
        model.zero_grad(set_to_none=True)
        step = make_multimodal_train_step(cfg, opt, remat=True,
                                          attention_impl="prefix_flash")
        m = step(state, batch, masked_indices=mask)
        out[str(dev)] = (m["loss"].item(), grads,
                         {n: t.cpu() for n, t in state.masters.items()})
    (l_cpu, g_cpu, m_cpu), (l_gpu, g_gpu, m_gpu) = out["cpu"], out[str(device)]
    worst = max((_rel(g_gpu[n], g_cpu[n]), n) for n in g_cpu
                if not n.endswith("k_proj.bias"))
    far = sum(int(((m_gpu[n] - m_cpu[n]).abs() > lr / 100).sum())
              for n in m_cpu)
    total = sum(t.numel() for t in m_cpu.values())
    dmax = max((m_gpu[n] - m_cpu[n]).abs().max().item() for n in m_cpu)
    # A first Adam update moves each element by about lr * sign(g), so an
    # element whose tiny gradient takes the other sign on the card lands
    # 2 lr away: dmax cannot be held below 2 lr, the count beyond lr / 100
    # bounds how many do.  Read on an H100: loss 1e-5 relative, worst
    # gradient 8.5e-3, 0.63 % of elements beyond lr / 100.
    print(f"[check] tiny LaViDa stage-2 microstep, kernels on the card vs "
          f"plain versions on the CPU (bf16 compute, f32 masters, same "
          f"mask): loss {l_gpu:.5f} vs {l_cpu:.5f} (limit 1e-4 relative); "
          f"worst gradient {worst[0]:.3e} of max ({worst[1]}, limit 3e-2); "
          f"masters max |diff| {dmax:.3e} (limit 2 lr), {far} of {total} "
          f"beyond lr / 100 (limit 2 %)")
    if not abs(l_gpu - l_cpu) < 1e-4 * abs(l_cpu) or not worst[0] < 3e-2 \
            or not dmax <= 2.002 * lr or far > 0.02 * total:
        raise AssertionError("the tiny training step differs on the card")


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------

TRAIN_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "train_runs")
T1_STEPS = 6
TUNABLE_ALL = "mm_mlp_adapter,mm_vision_tower,mm_language_model"


def _cli(torch, argv):
    """train.cli.main in process, its host wall (a sync each side) added."""
    from lavida_mod_tpu_torch.train import cli

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cli.main(argv)
    torch.cuda.synchronize()
    res["wall_s"] = time.perf_counter() - t0
    return res


def _state_sums(torch, state):
    """{payload path: [the sum of the bit patterns, the f64 sum of
    squares]} over every tensor of a full checkpoint's payload (model,
    masters, optimizer state), and the scalars as they are."""
    from lavida_mod_tpu_torch.train.cli import train_payload

    params, opt_state = train_payload(state)
    views = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            elif isinstance(v, torch.Tensor):
                t = v.detach().reshape(-1)
                out[prefix + k] = torch.stack([
                    t.view(views[t.element_size()]).sum(
                        dtype=torch.int64).double(),
                    t.double().square().sum()]).cpu()
            else:
                out[prefix + k] = v

    with torch.no_grad():
        walk({"params": params, "opt_state": opt_state}, "")
    return out


def _same_sums(a, b) -> bool:
    import torch

    return set(a) == set(b) and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else a[k] == b[k] for k in a)


def _dir_gb(path) -> float:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs) / 1e9


def _walls(res):
    """Per logged optimizer step: (wall ms, data tokens/s)."""
    return [(1e3 / r["steps_per_s"], r["tokens_per_s"]) for r in res["logged"]]


def phase_train_cli_stage1(torch, device, card, stage1):
    """Stage 1 at full LaViDa-LLaDA-8B through train.cli.main (T1)."""
    from lavida_mod_tpu_torch.config import LaViDaConfig
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.tools.make_synthetic_data import make
    from lavida_mod_tpu_torch.utils.checkpoint import (ADAPTER,
                                                       load_adapter_into)

    t0 = t_phase = time.perf_counter()
    data = make(os.path.join(TRAIN_ROOT, "data"), n=16, size=768)
    images = os.path.join(TRAIN_ROOT, "data", "images")
    print(f"[train_cli] 16 synthetic records of 768 x 768 PNGs (each the HD "
          f"anyres input, base + 4 tiles) in {time.perf_counter() - t0:.2f}"
          f" s (tools/make_synthetic_data.py)")
    out = os.path.join(TRAIN_ROOT, "stage1")
    ops = _train_ops()
    for op in ops.values():
        op.launches = 0
    res = _cli(torch, [
        "--data-path", data, "--image-folder", images, "--output-dir", out,
        "--tunable", "mm_mlp_adapter", "--lr", "1e-3", "--ce-chunk", "512",
        "--batch-size", "4", "--steps", str(T1_STEPS), "--log-every", "1",
        "--save-every", "2", "--adapter-only-save", "--prefetch", "2",
        "--decode-workers", "4", "--profile",
        os.path.join(TRAIN_ROOT, "profile")])
    counts = {k: op.launches for k, op in ops.items()}
    per_step = {"prefix_flash_fwd": 2 * LLADA_LAYERS,
                "prefix_flash_dq": LLADA_LAYERS,
                "prefix_flash_dkv": LLADA_LAYERS, "gather_rows": 1,
                "short_attention": 2 * SIGLIP_LAYERS}
    if counts != {k: T1_STEPS * n for k, n in per_step.items()}:
        raise AssertionError(f"launches over {T1_STEPS} steps {counts}, "
                             f"want {per_step} per step")
    losses = res["losses"]
    if len(losses) != T1_STEPS or not np.isfinite(losses).all() or not all(
            np.isfinite(r["loss"]) for r in res["logged"]):
        raise AssertionError(f"losses {losses}")
    state = res["state"]
    masters = {n: m.detach().clone() for n, m in state.masters.items()}
    if {n.split(".")[0] for n in masters} != {"projector", "image_newline"}:
        raise AssertionError(f"trainable {sorted(masters)[:4]}")
    for n in (2, 4, 6):
        if not os.path.isdir(os.path.join(out, f"checkpoint-{n}", ADAPTER)):
            raise AssertionError(f"no checkpoint-{n}/{ADAPTER}")
    merged = load_adapter_into(dict(state.model.state_dict()),
                               os.path.join(out, f"checkpoint-{T1_STEPS}",
                                            ADAPTER))
    if not all(torch.equal(merged[n], m) for n, m in masters.items()):
        raise AssertionError("the last adapter checkpoint is not the final "
                             "f32 projector and newline")
    sums = _checksums(torch, [state.model.llada, state.model.siglip])
    walls = _walls(res)
    prof, peak = res["profile"], res["peak_gib"]
    saves = [round(w, 3) for _, w in res["saves"]]
    del res, state, merged
    torch.cuda.empty_cache()
    # the frozen parts against a new init from the same seed, cast as the
    # mixed policy casts it
    ref = LaViDa.random_init(LaViDaConfig(), 0, torch.float32, device)
    with torch.no_grad():
        for m in (ref.llada, ref.siglip):
            for p in m.parameters():
                p.data = p.data.to(torch.bfloat16)
    if not torch.equal(_checksums(torch, [ref.llada, ref.siglip]), sums):
        raise AssertionError("a frozen LLaDA or SigLIP weight changed")
    init = dict(ref.named_parameters())
    moved = {n.split(".")[0] for n, m in masters.items()
             if not torch.equal(init[n].detach(), m)}
    if moved != {"projector", "image_newline"}:
        raise AssertionError(f"moved: {moved}")
    del ref, init
    torch.cuda.empty_cache()
    ms = [w for w, _ in walls]
    med = float(np.median(ms[1:]))
    tok = float(np.median([t for _, t in walls[1:]]))
    busy = prof.busy_share if prof is not None else None
    busy_s = ("not measured" if busy is None else
              f"{100 * busy:.1f} % ({prof.busy_ms:.1f} of {prof.wall_ms:.1f}"
              f" ms, profiler on)")
    print(f"[train_cli] stage 1 at full LaViDa-LLaDA-8B through train.cli."
          f"main (--tunable mm_mlp_adapter --batch-size 4 --steps "
          f"{T1_STEPS} --prefetch 2 --decode-workers 4, mixed precision, "
          f"prefix_flash, whole_layer remat, ce_chunk 512): losses "
          f"{[round(x, 4) for x in losses]}; step walls "
          f"{[round(w, 1) for w in ms]} ms (2-4 profiled, 4 with the "
          f"trace's export), median of steps 2-{T1_STEPS} "
          f"{med:.1f} ms against phase 11's {stage1['wall_ms']:.1f} ms in "
          f"this run; logged data tokens/s (median) {tok:.0f} against "
          f"phase 11's {stage1['tokens_per_s']:.0f}; peak {peak:.2f} GiB; "
          f"device busy over the profiled microsteps 2-4 {busy_s}; "
          f"adapter saves "
          f"{saves} s; launches per step {per_step}; frozen LLaDA + SigLIP "
          f"bit-identical to the seed's init, projector + image_newline "
          f"moved, checkpoint-{T1_STEPS}/{ADAPTER} loads back bit-equal; "
          f"phase wall {time.perf_counter() - t_phase:.1f} s ({card})")
    return counts, {"median_ms": med, "tokens_per_s": tok, "peak_gib": peak,
                    "busy": busy, "walls_ms": ms}


def phase_train_cli_457m(torch, device, card):
    """Every tunable part at --geometry 457m with a full save and a
    bit-equal resume (T2)."""
    from lavida_mod_tpu_torch.ops.short_attention import short_attention

    t_phase = time.perf_counter()
    data = os.path.join(TRAIN_ROOT, "data", "data.json")
    out = os.path.join(TRAIN_ROOT, "457m")
    argv = ["--data-path", data, "--image-folder",
            os.path.join(TRAIN_ROOT, "data", "images"), "--output-dir", out,
            "--geometry", "457m", "--precision", "bf16", "--tunable",
            TUNABLE_ALL, "--remat", "nested", "--ce-chunk", "512",
            "--grad-accum", "2", "--log-every", "1", "--seed", "1"]
    # the in-training eval hook once, after run A's one update
    from lavida_mod_tpu_torch.train import cli

    pope = eval_documents(os.path.join(TRAIN_ROOT, "eval"), ("pope",), 0)
    hook = []
    run_eval = cli.run_eval

    def checked_eval(args, cfg, state, tokenizer):
        ops = _batch_ops()
        torch.cuda.synchronize()
        before = _state_sums(torch, state)
        n0 = {k: op.launches for k, op in ops.items()}
        t0 = time.perf_counter()
        scores = run_eval(args, cfg, state, tokenizer)
        torch.cuda.synchronize()
        hook.append((time.perf_counter() - t0,
                     {k: op.launches - n0[k] for k, op in ops.items()},
                     _same_sums(_state_sums(torch, state), before), scores))
        return scores

    cli.run_eval = checked_eval
    try:
        a = _cli(torch, argv + ["--steps", "1", "--eval-tasks", "pope",
                                "--eval-every", "1", "--eval-limit", "2",
                                "--eval-data-path", pope])
    finally:
        cli.run_eval = run_eval
    rows = [json.loads(line) for line in open(os.path.join(
        out, "metrics.jsonl"))]
    evals = [r for r in rows if "eval/pope/n_docs" in r]
    if len(hook) != 1 or not hook[0][2]:
        raise AssertionError(f"the eval hook ran {len(hook)} times; state "
                             f"unchanged across it: "
                             f"{[h[2] for h in hook]}")
    if len(evals) != 1 or evals[0]["step"] != 1 \
            or evals[0]["eval/pope/n_docs"] != 2.0 \
            or {k: v for k, v in evals[0].items()
                if k.startswith("eval/")} != hook[0][3]:
        raise AssertionError(f"eval rows {evals}, hook {hook[0][3]}")
    # two pope documents through generate_fused on the bf16 457m: the
    # tower's 26 and the LM's 6 layers of #1, one splice gather and 16
    # steps of the decode kernel in 6 layers each
    _check("T2 eval hook", hook[0][1], _want(
        short_attention=2 * (SIGLIP_LAYERS + 6), gather_rows=2,
        decode_attention=2 * 6 * EVAL_G))
    final = _state_sums(torch, a["state"])
    gb = _dir_gb(os.path.join(out, "checkpoint-2"))
    # run A's wall less the eval call's, as in the runs without the hook
    info = {"a_wall": a["wall_s"] - hook[0][0], "a_peak": a["peak_gib"],
            "eval_wall": hook[0][0], "eval_launches": hook[0][1],
            "eval_rows": hook[0][3],
            "staged": a["saves"][-1][1], "commit": a["commit_s"],
            "a_losses": a["losses"], "init": a["init_s"]}
    masters = list(a["state"].masters)
    del a
    torch.cuda.empty_cache()
    b = _cli(torch, argv + ["--steps", "1"])
    if not (b["restored_from"] or "").endswith("checkpoint-2") \
            or b["losses"]:
        raise AssertionError(f"run B restored {b['restored_from']}, took "
                             f"{len(b['losses'])} microsteps")
    if not _same_sums(_state_sums(torch, b["state"]), final):
        raise AssertionError("the restored state is not run A's final state")
    info["restore"] = b["restore_s"]
    del b
    torch.cuda.empty_cache()
    vjp0 = short_attention.backward_calls
    c = _cli(torch, argv + ["--steps", "2"])
    vjp = short_attention.backward_calls - vjp0
    if c["start_step"] != 2 or len(c["losses"]) != 2 \
            or not np.isfinite(c["losses"]).all():
        raise AssertionError(f"run C: start {c['start_step']}, losses "
                             f"{c['losses']}")
    if vjp != 2 * SIGLIP_LAYERS:
        raise AssertionError(f"short_attention VJP ran {vjp} times")
    after = _state_sums(torch, c["state"])

    def group(n):
        top = n.split(".")[0]
        return {"llada": "base", "siglip": "vision_tower"}.get(top,
                                                               "projector")

    moved = {group(n) for n in masters
             if not torch.equal(after[f"params/model/{n}"],
                                final[f"params/model/{n}"])}
    if moved != {"base", "vision_tower", "projector"}:
        raise AssertionError(f"after run C's update only {moved} moved")
    info.update(c_wall=c["wall_s"], c_peak=c["peak_gib"],
                c_losses=c["losses"], c_restore=c["restore_s"],
                c_commit=c["commit_s"])
    n_params = sum(p.numel() for p in c["state"].model.parameters())
    del c
    torch.cuda.empty_cache()
    shutil.rmtree(out)
    print(f"[train_cli] --geometry 457m (6 llama layers d 2048, tied head, "
          f"square so400m views; {n_params / 1e9:.3f} B params), --precision "
          f"bf16, every part tunable, --remat nested --ce-chunk 512 "
          f"--grad-accum 2: run A (2 microsteps, init {info['init']:.2f} s, "
          f"the eval hook after its update: --eval-tasks pope --eval-limit 2 "
          f"in {info['eval_wall']:.2f} s, launches "
          f"{_nonzero(info['eval_launches'])}, the state's checksums equal "
          f"before and after it, rows "
          f"{ {k: round(v, 4) for k, v in info['eval_rows'].items()} }) "
          f"wall {info['a_wall']:.2f} s without the eval call, losses "
          f"{[round(x, 4) for x in info['a_losses']]}, peak "
          f"{info['a_peak']:.2f} GiB (the eval call's included), full "
          f"async save of checkpoint-2 "
          f"({gb:.3f} GB) staged in {info['staged']:.2f} s and committed "
          f"{info['commit']:.2f} s later; run B restored it in "
          f"{info['restore']:.2f} s, every tensor and count bit-equal to run "
          f"A's final state (checksums); run C resumed (restore "
          f"{info['c_restore']:.2f} s), microsteps 3-4 wall "
          f"{info['c_wall']:.2f} s, losses "
          f"{[round(x, 4) for x in info['c_losses']]}, peak "
          f"{info['c_peak']:.2f} GiB, every group moved, short_attention's "
          f"VJP ran {vjp} times; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return info


LADDER = [("whole_layer", "dense"), ("nested", "dense"),
          ("dots_nobatch", "dense"), ("dots", "dense"), ("one_in_2", "dense"),
          ("none", "dense"), ("whole_layer", "blockwise"),
          ("whole_layer", "prefix_flash")]


def phase_remat_ladder(torch, device, card):
    """One step per remat strategy at 457m, same seed and batch (T3)."""
    t_phase = time.perf_counter()
    data = os.path.join(TRAIN_ROOT, "data", "data.json")
    rows = {}
    for remat, impl in LADDER:
        out = os.path.join(TRAIN_ROOT, f"ladder-{remat}-{impl}")
        res = _cli(torch, [
            "--data-path", data, "--image-folder",
            os.path.join(TRAIN_ROOT, "data", "images"), "--output-dir", out,
            "--geometry", "457m", "--precision", "bf16", "--tunable",
            TUNABLE_ALL, "--ce-chunk", "512", "--steps", "2",
            "--log-every", "1", "--adapter-only-save", "--seed", "2",
            "--remat", remat, "--attn-impl", impl])
        rows[(remat, impl)] = (res["losses"][0], res["peak_gib"],
                               _walls(res)[1][0])
        del res
        torch.cuda.empty_cache()
        shutil.rmtree(out)
    base = rows[("whole_layer", "dense")][0]
    for key, (loss, peak, wall) in rows.items():
        print(f"[ladder] --remat {key[0]:12s} --attn-impl {key[1]:12s} step-1 "
              f"loss {loss:.5f}, peak {peak:.3f} GiB, step-2 wall "
              f"{wall:.1f} ms ({card})")
        if not abs(loss - base) < 0.01 * abs(base):
            raise AssertionError(f"{key}: loss {loss} against {base} (limit "
                                 f"1 %)")
    peaks = [rows[(r, "dense")][1] for r in ("whole_layer", "dots_nobatch",
                                             "dots", "none")]
    if not peaks[0] < peaks[1] < peaks[2] < peaks[3]:
        raise AssertionError(f"peaks whole_layer, dots_nobatch, dots, none: "
                             f"{peaks}")
    print(f"[ladder] 457m, bf16, every part tunable, B 4, one step each: "
          f"losses within 1 % of whole_layer's; peak order whole_layer < "
          f"dots_nobatch < dots < none holds; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return rows


def phase_tokenizer_gap(card):
    """Phase 7's trained tokenizer through load_hf_or_offline (transformers'
    AutoTokenizer when it imports) and the pure loader (T4)."""
    import json as _json

    from lavida_mod_tpu_torch.data.tokenizer import (load_hf_or_offline,
                                                     load_tokenizer)
    from lavida_mod_tpu_torch.rehearse_8b_load import (build_prompt,
                                                       write_tokenizer)

    path = os.path.join(TRAIN_ROOT, "tokenizer")
    os.makedirs(path)
    write_tokenizer(path)
    cfg_path = os.path.join(path, "tokenizer_config.json")
    with open(cfg_path) as f:
        tcfg = _json.load(f)
    # as the published LLaDA tokenizer_config.json names it
    tcfg["tokenizer_class"] = "PreTrainedTokenizerFast"
    with open(cfg_path, "w") as f:
        _json.dump(tcfg, f)
    try:
        import transformers
        tv = transformers.__version__
        # the trained vocab's ids skip to the specials at 126081..: newer
        # transformers warn about those holes, listing every missing id
        transformers.logging.set_verbosity_error()
    except ImportError:
        tv = None
    hf = load_hf_or_offline(path)
    pure = load_tokenizer(path, prefer_pure=True)
    kind = type(hf).__module__ + "." + type(hf).__name__
    if tv is not None and not type(hf).__module__.startswith("transformers"):
        raise AssertionError(f"transformers {tv} imports but "
                             f"load_hf_or_offline gave {kind}")
    text = build_prompt(pure)[0]
    rng = np.random.default_rng(14)
    texts = [text] + [pure.decode(rng.integers(0, len(pure.vocab),
                                               48).tolist(),
                                  skip_special_tokens=False)
                      for _ in range(300)]
    bad = [t for t in texts
           if hf.encode(t, add_special_tokens=False) != pure.encode(t)]
    shutil.rmtree(path)
    if bad:
        raise AssertionError(f"{len(bad)} of {len(texts)} strings tokenize "
                             f"differently, e.g. {bad[0]!r}")
    print(f"[tokenizer] phase 7's BPE through load_hf_or_offline ({kind}, "
          f"transformers {tv or 'absent'}) and the pure loader (native merge "
          f"engine {'on' if pure._native is not None else 'off'}): equal ids "
          f"on the prompt and 300 decoded strings ({card})")


# ---------------------------------------------------------------------------
# LaViDa-Dream at full Dream-7B width
# ---------------------------------------------------------------------------

DREAM_LAYERS = 28
DREAM_GEN = dict(max_new_tokens=32, steps=16, alg="topk_margin",
                 prefix_lm=True)       # run_dream.sh:13, bench.py:367-371
DREAM_STEPS = DREAM_GEN["steps"]


def dream_serve(model, ids, views, size, gen):
    """bench.py --dream's serving composition (bench.py:359-376): the
    one-gather splice (`multimodal_embeds`), then `dream_generate` with
    the prefill through the short-attention kernel and, in the mixed
    layout, the int8 prefill tree.  Returns the [G] ids."""
    import torch

    from lavida_mod_tpu_torch.generation.dream_sampler import dream_generate
    from lavida_mod_tpu_torch.models.multimodal import (build_gather_plan,
                                                        multimodal_embeds)

    idx, text_ids, _, _ = build_gather_plan(model.cfg, [ids],
                                            [[views.shape[0]]], [[size]])
    with torch.no_grad():
        prefix = multimodal_embeds(
            model, torch.as_tensor(views, device=model.device), text_ids,
            idx)
        out = dream_generate(model.llada, prefix, gen, use_flash_prefill=True,
                             act_int8_prefill=model.mixed)
    return out[0].cpu().numpy()


def phase_dream_kernels(torch, device, dres, P):
    """The kernels of the Dream path against their plain versions at
    Dream-7B's shapes (P the bench request's prefix): #1 at the GQA
    prefill, #3 with the QKV bias in its epilogue at the four prefill
    linears, #5 with the bias at [q|k|v] and at the head padded to 152064
    columns, #6 and #7 at D 3584 (28 groups; #7's down GEMM over 20480
    padded rows), SigLIP's #1, the splice gather and one image's #9 as on
    the LLaDA path.  Summed over one Dream request's launches (the mixed
    path's, and the bf16 path's #9)."""
    import torch.nn.functional as F

    from lavida_mod_tpu_torch.ops import quant as tq
    from lavida_mod_tpu_torch.ops import vit_mlp as tv
    from lavida_mod_tpu_torch.ops import w4_fused as tw
    from lavida_mod_tpu_torch.ops import w8a8 as t8
    from lavida_mod_tpu_torch.ops.gather import (gather_rows,
                                                 gather_rows_reference)
    from lavida_mod_tpu_torch.ops.short_attention import (
        short_attention, short_attention_reference)

    gen = torch.Generator(device=device).manual_seed(16)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=device, generator=gen) * scale

    D, H, Hd, V, G = 3584, 18944, 20480, 152064, 32
    for name, qs, ks, per in [
            ("siglip", (5, 729, 16, 72), (5, 729, 16, 72), SIGLIP_LAYERS),
            ("dream_prefill", (1, P, 28, 128), (1, P + G, 4, 128),
             DREAM_LAYERS)]:
        q, k, v = (randn(*s).bfloat16() for s in (qs, ks, ks))
        sq = skv = None
        if name == "dream_prefill":    # the G unwritten rows masked
            sq = torch.ones(1, P, dtype=torch.int32, device=device)
            skv = (torch.arange(P + G, device=device) < P).to(
                torch.int32)[None].contiguous()
        out = short_attention(q, k, v, sq, skv)
        torch.cuda.synchronize()
        ref = short_attention_reference(q, k, v, sq, skv)
        torch.testing.assert_close(out.float(), ref.float(), atol=8e-3,
                                   rtol=8e-3)
        mask = None if sq is None else (sq[:, None, :, None]
                                        == skv[:, None, None, :])
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rep = qs[2] // ks[2]
        kt, vt = kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        keys = ks[1] if skv is None else P
        dres.add("short_attention", f"{name} q{qs} kv{ks}", per,
                 (out.float() - ref.float()).abs().max().item(),
                 lambda: short_attention(q, k, v, sq, skv),
                 cuda_ms(lambda: short_attention_reference(q, k, v, sq, skv)),
                 lib, 4 * qs[0] * qs[2] * qs[1] * keys * qs[3],
                 2 * (2 * q.numel() + k.numel() + v.numel()),
                 note=" (limit 8e-3 + 8e-3 |o|; library: SDPA over the "
                      "repeated KV heads)")

    table = randn(5 * 196 + 1 + 50 + 1, D).bfloat16()
    idx = torch.randint(0, table.shape[0], (P,), generator=gen,
                        device=device)
    out = gather_rows(table, idx.cpu().numpy())
    if not torch.equal(out, gather_rows_reference(table, idx)):
        raise AssertionError("gather_rows differs at Dream's width")
    dres.add("gather_rows", f"splice table{tuple(table.shape)} idx[{P}]", 1,
             0.0, lambda: gather_rows(table, idx.cpu().numpy()),
             cuda_ms(lambda: gather_rows_reference(table, idx)),
             cuda_ms(lambda: torch.index_select(table, 0, idx)), 0,
             2 * P * D * 2 + 8 * P, note=" (exact)")

    # #3: [q|k|v] with the bias, o, up|gate, down (K 18944) at the prefill
    for K, N, bias in [(D, D + 2 * 512, True), (D, D, False),
                       (D, 2 * H, False), (H, D, False)]:
        x = randn(P, K).bfloat16()
        q, sc = tq.quantize_linear(randn(N, K, scale=0.02))
        b = randn(N).bfloat16() if bias else None
        x8, sx = t8.act_quant(x, t8.ACT_FORMULA_W8)
        out = t8.w8a8_matmul(x8, sx, q, sc, b)
        torch.cuda.synchronize()
        if not torch.equal(out, t8.w8a8_matmul_reference(x8, sx, q, sc, b)):
            raise AssertionError(f"w8a8_matmul differs at {(P, K, N)}")
        qt = q.t()
        try:
            torch._int_mm(x8, qt)
        except RuntimeError:
            qt = qt.contiguous()

        def library(x8=x8, qt=qt, sx=sx, sc=sc, b=b):
            y = torch._int_mm(x8, qt).float() * sx * sc
            return (y if b is None else y + b.float()).bfloat16()

        dres.add("w8a8_matmul", f"[{P},{K}]x[{K},{N}]" + (" + bias" if bias
                                                           else ""),
                 DREAM_LAYERS, 0.0,
                 lambda: t8.w8a8_matmul(x8, sx, q, sc, b),
                 cuda_ms(lambda: t8.w8a8_matmul_reference(x8, sx, q, sc, b),
                         3), cuda_ms(library), 2 * P * K * N,
                 P * K + N * K + 4 * (P + N) + 2 * P * N + 2 * N * bias,
                 int8=True, note=" (exact)")

    # #5 with the bias at [q|k|v] per layer per step; the head, per step
    for N, bias, per in [(D + 2 * 512, True, DREAM_LAYERS * DREAM_STEPS),
                         (V, False, DREAM_STEPS)]:
        x = randn(G, D).bfloat16()
        nw = (1 + randn(D, scale=0.1)).bfloat16()
        packed, scales = _w4_weights(torch, tq, randn, D, N)
        b = randn(N).bfloat16() if bias else None
        out = tw.w4_qkv_norm(x, nw, packed, scales, 1e-6, b)
        torch.cuda.synchronize()
        err = _rel(out, tw.w4_qkv_norm_reference(x, nw, packed, scales, 1e-6,
                                                 b))
        if not err < 1e-2:
            raise AssertionError(f"w4_qkv_norm {(G, D, N, bias)}: {err}")
        dres.add("w4_qkv_norm", f"[{G},{D}]x[{D},{N}]" + (" + bias" if bias
                                                           else ""),
                 per, err, lambda: tw.w4_qkv_norm(x, nw, packed, scales, 1e-6,
                                                  b),
                 cuda_ms(lambda: tw.w4_qkv_norm_reference(
                     x, nw, packed, scales, 1e-6, b), 3), None,
                 2 * G * D * N,
                 2 * G * D + 2 * D + _w4_bytes(D, N) + 2 * G * N
                 + 2 * N * bias, int8=True, note=" (relative, limit 1e-2)")

    a, r = randn(G, D).bfloat16(), randn(G, D).bfloat16()
    w = _w4_weights(torch, tq, randn, D, D)
    out = tw.w4_matmul_res(a, r, *w)
    torch.cuda.synchronize()
    if not torch.equal(out, tw.w4_matmul_res_reference(a, r, *w)):
        raise AssertionError("w4_matmul_res differs at Dream's width")
    dres.add("w4_matmul_res", f"[{G},{D}]x[{D},{D}]",
             DREAM_LAYERS * DREAM_STEPS, 0.0,
             lambda: tw.w4_matmul_res(a, r, *w),
             cuda_ms(lambda: tw.w4_matmul_res_reference(a, r, *w), 5), None,
             2 * G * D * D, 2 * G * D + _w4_bytes(D, D) + 4 * G * D,
             int8=True, note=" (exact)")

    up = _w4_weights(torch, tq, randn, D, 2 * H)
    dn_p, dn_s, _ = tq.quantize_linear4(F.pad(randn(D, H, scale=0.02),
                                              (0, Hd - H)))
    fw = ((1 + randn(D, scale=0.1)).bfloat16(), *up,
          dn_p[:D // 8].contiguous(), dn_s[:, :D].contiguous())
    x = torch.empty(G, D, dtype=torch.bfloat16, device=device)
    err = 0.0
    for _ in range(2):              # new data at the same addresses
        x.copy_(randn(G, D))
        out = tw.w4_ffn_fused(x, *fw, 1e-6)
        torch.cuda.synchronize()
        err = max(err, _rel(out, tw.w4_ffn_fused_reference(x, *fw, 1e-6)))
    if not err < 2e-2:
        raise AssertionError(f"w4_ffn_fused at Dream's width: {err}")
    dres.add("w4_ffn_fused", f"[{G},{D}] H {H} Hd {Hd}",
             DREAM_LAYERS * DREAM_STEPS, err,
             lambda: tw.w4_ffn_fused(x, *fw, 1e-6),
             cuda_ms(lambda: tw.w4_ffn_fused_reference(x, *fw, 1e-6), 3),
             None, 2 * G * D * 2 * H + 2 * G * Hd * D,
             4 * G * D + 2 * D + _w4_bytes(D, 2 * H) + _w4_bytes(Hd, D),
             int8=True, note=" (relative, limit 2e-2)")

    Dv, Fv, M = 1152, 4304, 3645
    vw = tuple(t.bfloat16() for t in (
        randn(M, Dv), 1 + randn(Dv, scale=0.1), randn(Dv, scale=0.1),
        randn(Fv, Dv, scale=0.03), randn(Fv, scale=0.1),
        randn(Dv, Fv, scale=0.03), randn(Dv, scale=0.1)))
    out = tv.fused_vit_mlp(*vw)
    torch.cuda.synchronize()
    ref = tv.fused_vit_mlp_reference(*vw)
    torch.testing.assert_close(out.float(), ref.float(), atol=5e-2,
                               rtol=5e-2)
    dres.add("fused_vit_mlp", f"M {M} D {Dv} F {Fv}", SIGLIP_LAYERS,
             (out.float() - ref.float()).abs().max().item(),
             lambda: tv.fused_vit_mlp(*vw),
             cuda_ms(lambda: tv.fused_vit_mlp_reference(*vw), 3), None,
             4 * M * Dv * Fv, 4 * M * Dv + 4 * Dv * Fv + 2 * (Fv + 3 * Dv),
             note=" (limit 5e-2; the bf16 request's encode)")


def _dream_ops():
    from lavida_mod_tpu_torch.ops import vit_mlp as tv
    from lavida_mod_tpu_torch.ops import w4_fused as tw
    from lavida_mod_tpu_torch.ops import w8a8 as t8
    from lavida_mod_tpu_torch.ops.decode_attention import decode_attention
    from lavida_mod_tpu_torch.ops.gather import gather_rows
    from lavida_mod_tpu_torch.ops.short_attention import short_attention

    return {"short_attention": short_attention, "gather_rows": gather_rows,
            "fused_vit_mlp": tv.fused_vit_mlp,
            "decode_attention": decode_attention,
            "w8a8_matmul": t8.w8a8_matmul, "w4_qkv_norm": tw.w4_qkv_norm,
            "w4_matmul_res": tw.w4_matmul_res,
            "w4_ffn_fused": tw.w4_ffn_fused}


def phase_dream_path(torch, device, card):
    """LaViDa-Dream at full Dream-7B width and depth (28 layers, d 3584,
    28 query / 4 KV heads, H 18944, vocab 151936, the QKV bias) with
    SigLIP's 26 layers, random bf16 weights from seed 0 on the card: one
    bf16 request through LaViDa.generate (the Dream sampler, dense
    attention, the tower's MLP through #9), then to_serving_layout("mixed",
    fuse=True) and three bench-protocol requests (bench.py --dream:
    the one-gather splice, flash prefill through the int8 tree with its
    head, the fused int4 decode with the bias in #5's epilogue), every
    kernel's launches counted per request and asserted."""
    from lavida_mod_tpu_torch.config import (DreamGenerationConfig,
                                             LaViDaConfig, dream_7b_config)
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.models.multimodal import build_gather_plan

    cfg = LaViDaConfig(llada=dream_7b_config())
    lc = cfg.llada
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LaViDa.random_init(cfg, 0, torch.bfloat16, device,
                               lm_family="dream")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[dream] LaViDaConfig(llada=dream_7b_config()) bf16 random init "
          f"on {card}: {n_params / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.2f} s")
    gen = DreamGenerationConfig(**DREAM_GEN)
    requests = bench_requests(np.random.default_rng(0))
    ops = _dream_ops()

    def run(i, req, serve, want, tag):
        ids, views, size = req
        before = {k: op.launches for k, op in ops.items()}
        idx, _, _, _ = build_gather_plan(cfg, [ids], [[views.shape[0]]],
                                         [[size]])
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve(ids, views, size)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = {k: op.launches - before[k] for k, op in ops.items()}
        print(f"[dream] {tag} request {i}: image {size} -> {views.shape[0]} "
              f"views, P={idx.shape[1]}, G=32, {DREAM_STEPS} steps "
              f"topk_margin: wall {wall * 1e3:.1f} ms, peak {peak:.2f} GiB, "
              f"launches {got} ({card}); tokens {out.tolist()}")
        if out.shape != (32,) or (out >= lc.vocab_size).any() \
                or (out < 0).any():
            raise AssertionError(f"Dream output {out}")
        if (out == lc.mask_token_id).any():
            raise AssertionError("mask tokens left in the Dream output")
        if got != want:
            raise AssertionError(f"Dream {tag} launches {got}, want {want}")
        return wall, peak, idx.shape[1]

    def bf16_serve(ids, views, size):
        return model.generate(ids, [views], [size], gen)

    first = requests[0]
    bf16_serve(*first)                                       # warm-up
    want = {k: 0 for k in ops}
    # the sampler's prefill (no flash kernel) and its steps attend through
    # the decode kernel
    want.update(short_attention=SIGLIP_LAYERS, fused_vit_mlp=SIGLIP_LAYERS,
                decode_attention=DREAM_LAYERS * (DREAM_STEPS + 1))
    for op in ops.values():
        op.launches = 0
    bf16_wall, bf16_peak, P = run(0, first, bf16_serve, want, "bf16")
    bf16_counts = {k: op.launches for k, op in ops.items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.to_serving_layout("mixed", fuse=True)
    torch.cuda.synchronize()
    llada = model.llada
    prefill_gb = _tree_bytes([b.prefill for b in llada.blocks]) / 1e9
    head_gb = _tree_bytes([llada.prefill_head]) / 1e9
    decode_gb = _tree_bytes([getattr(b, n) for b in llada.blocks
                             for n in b.linear_names] + [llada.ff_out]) / 1e9
    print(f"[dream] to_serving_layout('mixed', fuse=True) in "
          f"{time.perf_counter() - t0:.2f} s (peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB); int8 "
          f"prefill tree {prefill_gb:.3f} GB + its head {head_gb:.3f} GB, "
          f"int4 decode tree {decode_gb:.3f} GB ({card})")
    if not all(b.fused_plan(32, False) and b.att_proj.bias is not None
               for b in llada.blocks) or not llada.head_fusable(32) \
            or llada.ff_out.out_features != lc.vocab_size:
        raise AssertionError("Dream's fused decode plan does not engage")

    def mixed_serve(ids, views, size):
        return dream_serve(model, ids, views, size, gen)

    mixed_serve(*first)                                      # warm-up
    want = {"short_attention": SIGLIP_LAYERS + DREAM_LAYERS,
            "gather_rows": 1, "fused_vit_mlp": 0,
            "decode_attention": DREAM_LAYERS * DREAM_STEPS,
            "w8a8_matmul": 4 * DREAM_LAYERS,
            "w4_qkv_norm": (DREAM_LAYERS + 1) * DREAM_STEPS,
            "w4_matmul_res": DREAM_LAYERS * DREAM_STEPS,
            "w4_ffn_fused": DREAM_LAYERS * DREAM_STEPS}
    for op in ops.values():
        op.launches = 0
    walls, peaks = [], []
    for i, req in enumerate(requests):
        wall, peak, _ = run(i, req, mixed_serve, want, "mixed")
        walls.append(wall)
        peaks.append(peak)
    mixed_counts = {k: op.launches for k, op in ops.items()}
    prof = _profile_busy(torch, lambda: mixed_serve(*first))
    _print_profile("dream", prof, "mixed request 0", card)
    del model, llada
    counts = {k: bf16_counts[k] + mixed_counts[k] for k in ops}
    return counts, dict(bf16_wall=bf16_wall, bf16_peak=bf16_peak,
                        walls=walls, peaks=peaks, P=P)


def phase_small_dream(torch, device):
    """A tiny LaViDa-Dream in the mixed layout (every width a multiple of
    512, so the fused plan with the QKV bias in #5 and the padded head
    engage) on the card against the same weights on the CPU (the plain
    versions): decode logits and the bench composition's tokens."""
    import copy

    from lavida_mod_tpu_torch.config import DreamGenerationConfig
    from lavida_mod_tpu_torch.models.dream import tiny_dream_config
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.predict import tiny_config

    cfg = tiny_config().replace(llada=tiny_dream_config(
        d_model=512, n_heads=4, n_kv_heads=2, mlp_hidden_size=1536,
        vocab_size=1000, embedding_size=1000, mask_token_id=990,
        eos_token_id=991, pad_token_id=991))
    cpu = LaViDa.random_init(cfg, 0, torch.bfloat16, "cpu",
                             lm_family="dream")
    gen_rng = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in cpu.llada.named_parameters():
            if p.dim() >= 2:
                p.mul_(4.0)        # diverse tokens, as in the tests
            elif name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen_rng) * 0.5)
    cpu.to_serving_layout("mixed", fuse=True)
    if not cpu.llada.blocks[0].fused_plan(32, False):
        raise AssertionError("tiny Dream: no fused plan")
    gpu = copy.deepcopy(cpu).to(device)
    x = torch.full((1, 32), cfg.llada.mask_token_id, dtype=torch.long)
    x[0, ::3] = torch.arange(11) + 5
    with torch.no_grad():
        outs = [m.llada(m.llada.embed_tokens(x.to(m.device)))[0].float().cpu()
                for m in (cpu, gpu)]
    rel = ((outs[1] - outs[0]).abs().max() / outs[0].abs().max()).item()
    rng = np.random.default_rng(3)
    views = rng.standard_normal((5, 3, 56, 56)).astype(np.float32)
    ids = np.array([5, 6, -200, 7, 8, 9])
    gen = DreamGenerationConfig(**DREAM_GEN)
    a = dream_serve(cpu, ids, views, (100, 60), gen)
    b = dream_serve(gpu, ids, views, (100, 60), gen)
    agree = float((a == b).mean())
    print(f"[check] tiny mixed LaViDa-Dream (fused plan, QKV bias in #5), "
          f"kernels on the card vs plain versions on the CPU: decode logits "
          f"max|diff|/max|ref| {rel:.3e} (limit 5e-2), generated tokens "
          f"agree {agree:.2f}")
    if not np.isfinite(rel) or rel > 5e-2:
        raise AssertionError(f"tiny Dream logits differ: {rel}")
    # (the tiny vocabulary's mask id is a token the sampler may predict)
    if b.shape != (32,) or (b < 0).any() or (b >= 1000).any():
        raise AssertionError(f"tiny Dream output {b}")

# ---------------------------------------------------------------------------
# SHIRG: served at full LaViDa-LLaDA-8B, and its Extra-LoRA harness
# ---------------------------------------------------------------------------

SHIRG_SIZE = (1024, 768)
SHIRG_MERGE = {"merge_similar": True, "merge_threshold": 0.9}


def shirg_request(rng):
    """(ids, [2, 3, 448, 448] views, image size) of a SHIRG request: a
    seeded 1024 x 768 image through process_shirg_2view, the bench
    protocol's prompt (the image marker after 8 of 48 text tokens)."""
    from PIL import Image

    from lavida_mod_tpu_torch.data import SigLIPImageProcessor
    from lavida_mod_tpu_torch.models.shirg import process_shirg_2view

    w, h = SHIRG_SIZE
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    views = process_shirg_2view(img, SigLIPImageProcessor(size=384))
    text = rng.integers(3, 30000, size=48)
    return np.concatenate([text[:8], [-200], text[8:]]), views, img.size


def _shirg_splits(t):
    return (f"tower {t['tower_s'] * 1e3:.1f} ms, scores + top-k "
            f"{t['select_s'] * 1e3:.1f} ms, merge {t['merge_s'] * 1e3:.1f} ms")


def phase_shirg_bf16(torch, model, card):
    """Phase 4's bf16 model serves two SHIRG requests: `base`, then `full`
    with the similarity merge, each shirg_encode (timed in its tower /
    scores + top-k / merge parts) then LaViDa.generate(image_features=...)
    at gen 32, 16 steps."""
    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.models.shirg import shirg_encode

    gen = GenerationConfig(**GEN)
    ids, views, size = shirg_request(np.random.default_rng(20))
    mask_id = model.cfg.llada.mask_token_id

    def serve(method, sp, timings):
        block = shirg_encode(model, views, method=method,
                             selection_params=sp, timings=timings)
        if block.shape != (980, model.cfg.llada.d_model) \
                or block.dtype != torch.bfloat16:
            raise AssertionError(f"SHIRG block {tuple(block.shape)} "
                                 f"{block.dtype}")
        return model.generate(ids, gen=gen, image_features=[block])

    serve("base", None, None)                                # warm-up
    shirg_encode(model, views, method="full", selection_params=SHIRG_MERGE)
    want = _want(short_attention=SIGLIP_LAYERS + LLADA_LAYERS,
                 decode_attention=LLADA_LAYERS * STEPS)
    out = {}
    for method, sp in (("base", None), ("full", SHIRG_MERGE)):
        t = {}
        toks, wall, peak, got = _counted(torch, lambda: serve(method, sp, t))
        tag = method + (" + merge" if sp else "")
        print(f"[shirg] bf16 8B, {tag}: image {size} -> 2 views of 448^2 -> "
              f"980 tokens, P = {len(ids) - 1 + 980}, G = 32: wall "
              f"{wall * 1e3:.1f} ms (encode: {_shirg_splits(t)}), peak "
              f"{peak:.2f} GiB, launches {got} ({card}); tokens "
              f"{toks.tolist()}")
        _check(f"shirg bf16 {tag}", got, want, toks, mask_id=mask_id)
        out[tag] = (got, wall, peak, t)
    return out


def phase_shirg_mixed(torch, model, card):
    """bench.py --shirg's composition (bench.py:399-430) on phase 5's mixed
    model: shirg_encode, splice_embeddings, then generate_cached_fused with
    the request's own control table (the int8 tree prefills through the
    flash kernel, the fused int4 decode); once more with the fused ViT MLP
    (#9) in the tower, as bench.py --shirg --fused-vit runs it."""
    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.generation.diffusion import (
        build_control_table, generate_cached_fused)
    from lavida_mod_tpu_torch.models.multimodal import splice_embeddings
    from lavida_mod_tpu_torch.models.shirg import shirg_encode

    gen = GenerationConfig(**GEN)
    ids, views, size = shirg_request(np.random.default_rng(21))
    cfg, device = model.cfg, model.device
    G, mask_id = gen.max_new_tokens, cfg.llada.mask_token_id
    k_table, block_end = build_control_table(
        np.full((1, G), mask_id, np.int64), 0, G, gen, mask_id)
    k_table = torch.as_tensor(k_table, device=device)
    block_end = torch.as_tensor(block_end, device=device)

    def serve(fused_vit, timings=None):
        with torch.no_grad():
            block = shirg_encode(model, views, fused_mlp=fused_vit,
                                 timings=timings)
            prefix = splice_embeddings(model, ids, [block.to(
                torch.bfloat16)])[None]
            x = torch.full((1, G), mask_id, dtype=torch.long, device=device)
            gen_rng = torch.Generator(device=device).manual_seed(0)
            out = generate_cached_fused(
                model.llada, x, prefix, k_table, block_end, None, gen_rng,
                gen.temperature, gen.remasking, act_int8_prefill=True)
        return out[0].cpu().numpy()

    base = dict(short_attention=SIGLIP_LAYERS + LLADA_LAYERS,
                w8a8_matmul=4 * LLADA_LAYERS,
                decode_attention=LLADA_LAYERS * STEPS,
                w4_qkv_norm=(LLADA_LAYERS + 1) * STEPS,
                w4_matmul_res=LLADA_LAYERS * STEPS,
                w4_ffn_fused=LLADA_LAYERS * STEPS)
    res = {}
    for fused_vit in (False, True):
        serve(fused_vit)                                      # warm-up
        t = {}
        toks, wall, peak, got = _counted(torch, lambda: serve(fused_vit, t))
        want = _want(**base, fused_vit_mlp=SIGLIP_LAYERS if fused_vit else 0)
        tag = "--fused-vit" if fused_vit else "plain tower"
        print(f"[shirg] mixed 8B (bench.py --shirg, {tag}): image {size}, "
              f"980 tokens, G = 32: wall {wall * 1e3:.1f} ms (encode: "
              f"{_shirg_splits(t)}), peak {peak:.2f} GiB, launches {got} "
              f"({card}); tokens {toks.tolist()}")
        _check(f"shirg mixed {tag}", got, want, toks, mask_id=mask_id)
        res[tag] = (got, wall, peak, t)
    return res


def _lora_step_pair(torch, device):
    """The tiny SHIRG-LoRA microstep in f32 on the CPU and on the card from
    the same weights, factors and mask: (loss, grad_norm, factors) each."""
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.models.shirg import shirg_token_count
    from lavida_mod_tpu_torch.predict import tiny_config
    from lavida_mod_tpu_torch.train import lora as tl
    from lavida_mod_tpu_torch.train.step import init_train_state

    cfg = tiny_config()
    ref = LaViDa.random_init(cfg, 0, torch.float32, "cpu")
    tl.add_shirg_lora(ref, 1, rank=8, alpha=16.0)
    with torch.no_grad():
        for n, p in ref.named_parameters():     # factors that act
            if n.endswith("lora_b"):
                p.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(
                    len(n)))
    rng = np.random.default_rng(22)
    B, T = 2, 16
    n_img = shirg_token_count(1024)
    batch = {"pixel_values": torch.from_numpy(rng.standard_normal(
                 (B, 2, 3, 448, 448)).astype(np.float32)),
             "text_ids": torch.from_numpy(rng.integers(3, 400, (B, T))),
             "labels": torch.from_numpy(np.concatenate(
                 [np.full((B, n_img + 4), -100),
                  rng.integers(3, 400, (B, T - 4))], axis=1))}
    mask = torch.from_numpy(rng.random((B, n_img + T)) < 0.5)
    out = {}
    for dev in ("cpu", device):
        import copy

        model = copy.deepcopy(ref).to(dev)
        opt = tl.make_lora_optimizer(lr=1e-3, weight_decay=0.01,
                                     warmup_steps=0, total_steps=10)
        state = init_train_state(model, opt)
        m = tl.make_shirg_lora_train_step(cfg, opt)(state, batch,
                                                    masked_indices=mask)
        out[str(dev)] = (m["loss"].item(), m["grad_norm"].item(),
                         {k: {n: t.cpu() for n, t in f.items()} for k, f in
                          tl.split_lora_state(model).items()})
    return out["cpu"], out[str(device)]


def phase_small_shirg(torch, device):
    """A tiny SHIRG encode in f32 on the card (#1's f32 instance in the
    tower) against the CPU's plain versions from the same weights, and one
    tiny SHIRG-LoRA microstep likewise (f32, the same mask)."""
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.models.shirg import shirg_encode
    from lavida_mod_tpu_torch.ops.short_attention import short_attention
    from lavida_mod_tpu_torch.predict import tiny_config

    cpu = LaViDa.random_init(tiny_config(), 0, torch.float32, "cpu")
    gpu = LaViDa(tiny_config(), device=device, dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    views = np.random.default_rng(23).standard_normal(
        (2, 3, 448, 448)).astype(np.float32)
    f0 = short_attention.f32_launches
    with torch.no_grad():
        feats = [m.siglip(torch.from_numpy(views).to(m.device)).cpu()
                 for m in (cpu, gpu)]
        blocks = [shirg_encode(m, views, method="full").cpu()
                  for m in (cpu, gpu)]
    n_f32 = short_attention.f32_launches - f0
    rel = ((feats[1] - feats[0]).abs().max() / feats[0].abs().max()).item()
    diff = (blocks[1] - blocks[0]).abs().amax(dim=-1)
    swapped = int((diff > 1e-4 * blocks[0].abs().max()).sum())
    (l0, g0, f_cpu), (l1, g1, f_gpu) = _lora_step_pair(torch, device)
    worst = max(((f_gpu[k][n] - f_cpu[k][n]).abs().max().item(), k, n)
                for k in f_cpu for n in ("lora_a", "lora_b"))
    print(f"[check] tiny SHIRG in f32, card (#1 f32 instance, {n_f32} "
          f"launches) vs CPU: tower max|diff|/max|ref| {rel:.3e} (limit "
          f"1e-4), 980-token blocks differ beyond 1e-4 of max in {swapped} "
          f"rows (limit 8: near-tie swaps of the selection); tiny SHIRG-LoRA "
          f"microstep: loss {l1:.6f} vs {l0:.6f} (limit 1e-4 relative), "
          f"grad_norm {g1:.6f} vs {g0:.6f} (limit 1e-3 relative), factors "
          f"max|diff| {worst[0]:.3e} at {worst[1]}/{worst[2]} (limit 2 lr)")
    if n_f32 != 2 * len(gpu.siglip.layers) or not rel < 1e-4 \
            or swapped > 8:
        raise AssertionError("the tiny SHIRG encode differs on the card")
    if not abs(l1 - l0) < 1e-4 * abs(l0) or not abs(g1 - g0) < 1e-3 * g0 \
            or not worst[0] <= 2.002e-3:
        raise AssertionError("the tiny SHIRG-LoRA step differs on the card")


def _bit_sums(torch, tensors):
    """Per tensor: the int64 sum of its bit patterns and of a strided
    subset of them (no f64 copy of 34 GB of weights)."""
    out = []
    with torch.no_grad():
        for t in tensors:
            flat = t.detach().reshape(-1)
            bits = flat.view(torch.int32 if flat.element_size() == 4
                             else torch.int16)
            out.append(torch.stack([bits.sum(dtype=torch.int64),
                                    bits[::97].sum(dtype=torch.int64)]))
    return torch.stack(out).cpu()


SHIRG_LORA_STEPS = 3


def phase_shirg_lora_harness(torch, device, card):
    """The SHIRG-LoRA harness (train_shirg_lora.py) at full
    LaViDa-LLaDA-8B in f32, as the JAX script runs it: B = 2, three steps
    on synthetic records, --warmup-steps 1 (the first update's lr is 0),
    the adapter save at the end."""
    from lavida_mod_tpu_torch import train_shirg_lora as h
    from lavida_mod_tpu_torch.ops.short_attention import short_attention
    from lavida_mod_tpu_torch.tools.make_synthetic_data import make
    from lavida_mod_tpu_torch.train import lora as tl

    data = make(os.path.join(TRAIN_ROOT, "shirg_data"), n=8, size=768)
    out_dir = os.path.join(TRAIN_ROOT, "shirg_lora")
    before = {}

    def snapshot(model):
        before["frozen"] = _bit_sums(torch, [
            p for n, p in model.named_parameters()
            if not n.endswith((".lora_a", ".lora_b"))])
        before["factors"] = {k: {n: t.clone() for n, t in f.items()}
                             for k, f in tl.split_lora_state(model).items()}
        ops = _batch_ops()
        for op in ops.values():           # the counts of the run alone
            op.launches = 0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = h.main(["--data-path", data, "--image-folder",
                  os.path.join(TRAIN_ROOT, "shirg_data", "images"),
                  "--output-dir", out_dir, "--steps", str(SHIRG_LORA_STEPS),
                  "--batch-size", "2", "--warmup-steps", "1",
                  "--save-every", str(SHIRG_LORA_STEPS), "--device",
                  str(device)], on_ready=snapshot)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: op.launches for k, op in _batch_ops().items()}
    per_step = _want(short_attention=SIGLIP_LAYERS,
                     short_attention_f32=SIGLIP_LAYERS)
    want = {k: SHIRG_LORA_STEPS * n for k, n in per_step.items()}
    if counts != want:
        raise AssertionError(f"harness launches {counts}, want {want}")
    model, opt = run["state"].model, run["optimizer"]
    losses, norms = run["losses"], run["grad_norms"]
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"losses {losses}, grad norms {norms}")
    # the targeted SigLIP factors moved, every frozen leaf is
    # bit-unchanged, the inert factors (SigLIP q / k past block 5, v past
    # block 3, and the projector's, which JAX's projector never reads)
    # kept B at zero and decayed A by (1 - lr_t wd) per update, and the
    # adapter save reloads bit-equal through load_lora_state
    frozen = [p for n, p in model.named_parameters()
              if not n.endswith((".lora_a", ".lora_b"))]
    if not torch.equal(_bit_sums(torch, frozen), before["frozen"]):
        raise AssertionError("a frozen leaf moved")
    factors_before = before["factors"]
    after = tl.split_lora_state(model)
    wd, count = 0.01, run["state"].opt_state["groups"]["lora"]["count"]
    moved = inert = 0
    for k, f in after.items():
        a0 = factors_before[k]["lora_a"]
        scale = f["lora_scale"].reshape(-1)
        active = (scale != 0) & torch.tensor(k.startswith("siglip"))
        for i in range(scale.numel()):
            a = f["lora_a"].reshape(-1, *a0.shape[-2:])[i]
            b = f["lora_b"].reshape(-1, *f["lora_b"].shape[-2:])[i]
            ai = a0.reshape(-1, *a0.shape[-2:])[i].to(a.device)
            if active[i]:
                if not b.any() or torch.equal(a, ai):
                    raise AssertionError(f"{k}[{i}] did not move")
                moved += 1
                continue
            want = ai
            for c in range(count):
                lr_t = float(np.float32(opt.groups["lora"].lr(c)))
                want = want + (-lr_t) * (wd * want)
            if b.any() or not torch.allclose(a, want, rtol=1e-6, atol=0):
                raise AssertionError(f"inert {k}[{i}] moved otherwise")
            inert += 1
    saved = h.load_adapters(run["saved"][-1])
    with torch.no_grad():
        for _, m in tl.iter_linears(model):
            if getattr(m, "lora_a", None) is not None:
                m.lora_a.zero_()
                m.lora_b.zero_()
    tl.load_lora_state(model, saved)
    again = tl.split_lora_state(model)
    if any(not torch.equal(again[k][n], after[k][n])
           for k in after for n in after[k]):
        raise AssertionError("the adapter save does not reload bit-equal")
    plan = run["peak_plan"]
    peak = max(run["peaks"])
    total = torch.cuda.get_device_properties(0).total_memory
    walls = [round(w, 3) for w in run["walls"]]
    print(f"[shirg_lora] harness at full LaViDa-LLaDA-8B in f32 "
          f"({run['n_lora'] / 1e6:.2f} M LoRA params, rank 64, B = 2, "
          f"{SHIRG_LORA_STEPS} steps, warmup 1): losses "
          f"{[round(x, 4) for x in run['losses']]}, grad norms "
          f"{[round(x, 4) for x in run['grad_norms']]}, step walls {walls} "
          f"s, whole run {wall:.1f} s (model init {run['init_s']:.1f} s), "
          f"peak {peak / 1e9:.2f} GB (reckoned {plan['total'] / 1e9:.2f} GB; "
          f"card {total / 1e9:.2f} GB); {moved} active factor pairs moved, "
          f"{inert} inert pairs kept B = 0 and decayed A as weight decay "
          f"says, frozen leaves bit-unchanged, adapters reloaded bit-equal "
          f"({card})")
    if peak >= total:
        raise AssertionError(f"peak {peak} over the card's {total}")
    return {"walls": run["walls"], "peak": peak, "plan": plan["total"],
            "wall": wall, "losses": run["losses"], "counts": counts}

# ---------------------------------------------------------------------------
# the rest of training and sharding: Dream-geometry training, diffusion DPO,
# LaViDa.shard on a one-rank NCCL mesh (phases 16-18)
# ---------------------------------------------------------------------------

def _step_launches(torch, ops, run):
    """run() with every count of `ops` set to 0 just before it; (its
    result, the launches by kernel)."""
    for op in ops.values():
        op.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k: op.launches for k, op in ops.items()}


def phase_dream_train(torch, device, card):
    """One stage-1 step of LaViDa-Dream at full Dream-7B width (28 layers,
    d 3584, 28 / 4 heads, the QKV bias; SigLIP's 26), B = 4 bench-shaped
    samples as phase 11, after a warm-up step at LR 0."""
    from lavida_mod_tpu_torch.config import LaViDaConfig, dream_7b_config
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.train.step import (init_train_state,
                                                 make_freeze_optimizer,
                                                 make_multimodal_train_step)

    cfg = LaViDaConfig(llada=dream_7b_config())
    t0 = time.perf_counter()
    model = LaViDa.random_init(cfg, 0, torch.bfloat16, device,
                               lm_family="dream")
    opt = make_freeze_optimizer("mm_mlp_adapter", lr=1e-3, warmup_steps=3,
                                total_steps=STAGE1_STEPS)
    state = init_train_state(model, opt, torch.bfloat16)
    step = make_multimodal_train_step(
        cfg, opt, remat="whole_layer", ce_chunk=512,
        attention_impl="prefix_flash")
    torch.cuda.synchronize()
    print(f"[dream-train] Dream-7B LaViDa bf16 random init + train state in "
          f"{time.perf_counter() - t0:.2f} s: "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params "
          f"({card})")
    batch = train_batch(cfg, BATCH_SIZES, np.random.default_rng(10))
    B, T = batch["labels"].shape
    gen = torch.Generator(device=device).manual_seed(0)
    frozen = [model.llada, model.siglip]
    sums0 = _checksums(torch, frozen)
    tunable = {n: m.clone() for n, m in state.masters.items()}
    ops = _train_ops()
    want = {"prefix_flash_fwd": 2 * DREAM_LAYERS,
            "prefix_flash_dq": DREAM_LAYERS,
            "prefix_flash_dkv": DREAM_LAYERS, "gather_rows": 1,
            "short_attention": 2 * SIGLIP_LAYERS}
    step(state, batch, gen)                     # warm-up: the LR is 0 here
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m, got = _step_launches(torch, ops, lambda: step(state, batch, gen))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = m["loss"].item()
    print(f"[dream-train] one step, B={B} T={T}: wall {wall * 1e3:.1f} ms, "
          f"{B * T / wall:.0f} data tokens/s, peak {peak:.2f} GiB, loss "
          f"{loss:.4f}, grad_norm {m['grad_norm'].item():.4e}, launches "
          f"{got} ({card})")
    if got != want:
        raise AssertionError(f"Dream step launches {got}, want {want}")
    if not np.isfinite([loss, m["grad_norm"].item()]).all():
        raise AssertionError(f"Dream step loss {loss}")
    moved = {n.split(".")[0] for n, t in tunable.items()
             if not torch.equal(state.masters[n], t)}
    if moved != {"projector", "image_newline"}:
        raise AssertionError(f"only {moved} moved")
    if not torch.equal(_checksums(torch, frozen), sums0):
        raise AssertionError("a frozen LLaDA or SigLIP weight changed")
    if model.llada.blocks[0].k_proj.bias is None:
        raise AssertionError("the Dream LM has no QKV bias")
    del state, model, step
    torch.cuda.empty_cache()
    return got, {"wall_ms": wall * 1e3, "peak_gib": peak, "B": B, "T": T,
                 "loss": loss}


DPO_STEPS = 3
DPO_TARGETS = (r"llada/blocks/(q_proj|k_proj|v_proj|attn_out|ff_proj|"
               r"up_proj|ff_out)")


def dpo_pair(torch, model, cfg, rng):
    """A chosen / rejected pair of one bench-shaped image, a 48-token
    prompt and 32-token answers, embedded on the card through the tower
    and the splice (#1 x 26, #2 x 1): the DPO batch and the launches."""
    from lavida_mod_tpu_torch.models.multimodal import (build_gather_plan,
                                                        multimodal_embeds)

    ids, views, size = bench_request(48, (640, 640), rng)
    rows, labels = [], []
    for _ in range(2):
        answer = rng.integers(3, min(30000, cfg.llada.mask_token_id), 32)
        row = np.concatenate([ids, answer])
        lab = np.concatenate([np.full(len(ids), -100), answer])
        rows.append(row)
        labels.append(lab)
    T = build_gather_plan(cfg, rows, [[views.shape[0]]] * 2,
                          [[size]] * 2)[0].shape[1]
    gather_idx, text_ids, _, labs = build_gather_plan(
        cfg, rows, [[views.shape[0]]] * 2, [[size]] * 2, labels,
        pad_to=-(-T // 128) * 128)
    pix = torch.from_numpy(np.concatenate([views, views])).to(
        device=model.device, dtype=torch.bfloat16)
    ops = _train_ops()
    with torch.no_grad():
        emb, got = _step_launches(torch, ops, lambda: multimodal_embeds(
            model, pix, text_ids, gather_idx))
    labs = torch.from_numpy(labs).to(model.device)
    return ({"chosen_embeds": emb[:1], "chosen_labels": labs[:1],
             "rejected_embeds": emb[1:], "rejected_labels": labs[1:]},
            got)


def phase_dpo(torch, device, card):
    """Three diffusion DPO steps at full LaViDa-LLaDA-8B: LoRA rank 64 on
    the LM's seven linears trained by make_lora_optimizer, the reference
    the policy with its factors off (one frozen base for both).  Returns
    (the launches of a step, of the pair's build, the results, the model
    with its factors dropped: phase 18's)."""
    from lavida_mod_tpu_torch.config import LaViDaConfig
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.ops.quant import detach_lora, has_lora
    from lavida_mod_tpu_torch.train.dpo import make_dpo_train_step
    from lavida_mod_tpu_torch.train.lora import add_lora, make_lora_optimizer
    from lavida_mod_tpu_torch.train.step import init_train_state

    cfg = LaViDaConfig()
    model = LaViDa.random_init(cfg, 0, torch.bfloat16, device)
    base = _checksums(torch, [model.llada, model.siglip])
    batch, build = dpo_pair(torch, model, cfg, np.random.default_rng(24))
    want_build = {"prefix_flash_fwd": 0, "prefix_flash_dq": 0,
                  "prefix_flash_dkv": 0, "gather_rows": 1,
                  "short_attention": SIGLIP_LAYERS}
    if build != want_build:
        raise AssertionError(f"pair build launches {build}, want "
                             f"{want_build}")
    add_lora(model, seed=1, rank=64, target_re=DPO_TARGETS)
    lm = model.llada
    opt = make_lora_optimizer(lr=1e-4, warmup_steps=0, total_steps=10)
    state = init_train_state(lm, opt)
    n_lora = sum(t.numel() for t in state.masters.values())
    step = make_dpo_train_step(None, opt, None, beta=0.1,
                               remat="whole_layer",
                               attention_impl="prefix_flash")
    L = LLADA_LAYERS
    # the policy's two passes: forward + the remat recompute, dq, dkv;
    # the reference's two: forward only
    want = {"prefix_flash_fwd": 2 * 2 * L + 2 * L,
            "prefix_flash_dq": 2 * L, "prefix_flash_dkv": 2 * L,
            "gather_rows": 0, "short_attention": 0}
    weights = sum(p.numel() * p.element_size() for p in model.parameters()
                  if p.dtype == torch.bfloat16)
    T = batch["chosen_labels"].shape[1]
    V = cfg.llada.vocab_size
    # reckoned: the bf16 weights, the f32 factors with their gradients and
    # two Adam moments, two passes' f32 logits and log-softmax, and the
    # largest frozen gradient (the head's) alive at once
    reckoned = (weights + 16 * n_lora + 2 * 2 * 4 * T * V
                + 2 * V * cfg.llada.d_model)
    gen = torch.Generator(device=device).manual_seed(0)
    ops = _train_ops()
    torch.cuda.reset_peak_memory_stats()
    walls, losses, norms, launches = [], [], [], []
    for i in range(DPO_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, got = _step_launches(torch, ops, lambda: step(state, batch, gen))
        walls.append(time.perf_counter() - t0)
        losses.append(m["dpo_loss"].item())
        norms.append(m["grad_norm"].item())
        launches.append(got)
        print(f"[dpo] step {i + 1}: T={T}: wall {walls[-1] * 1e3:.1f} ms, "
              f"loss {losses[-1]:.6f}, margin "
              f"{m['reward_margin'].item():.3e}, grad_norm {norms[-1]:.4e},"
              f" launches {got} ({card})")
        if got != want:
            raise AssertionError(f"DPO step launches {got}, want {want}")
    peak = torch.cuda.max_memory_allocated()
    if abs(losses[0] - float(np.log(2.0))) > 1e-6:
        raise AssertionError(f"first DPO loss {losses[0]}, want log 2 "
                             f"(policy == reference at init)")
    if not np.isfinite(losses + norms).all():
        raise AssertionError(f"losses {losses}, norms {norms}")
    params = dict(lm.named_parameters())
    if not all(params[n].abs().max().item() > 0 for n in state.masters
               if n.endswith("lora_b")):
        raise AssertionError("a LoRA B factor did not move")
    for m_ in model.modules():
        if has_lora(m_):
            detach_lora(m_)
    if not torch.equal(_checksums(torch, [model.llada, model.siglip]), base):
        raise AssertionError("a base weight changed")
    print(f"[dpo] {DPO_STEPS} steps at 8B (LoRA rank 64 on "
          f"{sum(1 for n in state.masters if n.endswith('lora_a'))} linears, "
          f"{n_lora / 1e6:.1f} M factors): walls "
          f"{[round(w * 1e3, 1) for w in walls]} ms, first loss "
          f"{losses[0]:.7f} (log 2 = {np.log(2.0):.7f}), peak "
          f"{peak / 1e9:.2f} GB against {reckoned / 1e9:.2f} GB reckoned "
          f"(bf16 weights {weights / 1e9:.2f} GB); base weights "
          f"bit-unchanged, every B factor moved ({card})")
    del state, step, batch
    model.eval()
    torch.cuda.empty_cache()
    return launches[0], build, {"walls": walls, "losses": losses,
                                "peak": peak, "reckoned": reckoned}, model


def _train_457m(torch, device, cfg, batch, mesh):
    """One stage-1 microstep of the 457m geometry from seed 0 (mixed
    precision, #10, whole-layer remat), on `mesh` when given: its
    metrics and the launches."""
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.train.step import (init_train_state,
                                                 make_freeze_optimizer,
                                                 make_multimodal_train_step)

    model = LaViDa.random_init(cfg, 0, torch.float32, device)
    if mesh is not None:
        model.shard(mesh=mesh)
    opt = make_freeze_optimizer("mm_mlp_adapter", lr=1e-3, warmup_steps=0,
                                total_steps=10)
    state = init_train_state(model, opt, torch.bfloat16)
    step = make_multimodal_train_step(cfg, opt, remat="whole_layer",
                                      attention_impl="prefix_flash",
                                      mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(5)
    m, got = _step_launches(torch, _train_ops(),
                            lambda: step(state, batch, gen))
    del state, model, step
    torch.cuda.empty_cache()
    return m, got


def phase_sharded(torch, device, card, model):
    """LaViDa.shard on a one-rank NCCL process group: phase 17's 8B bf16
    model serves one bench request before and after it is sharded, and a
    457m stage-1 step runs without and with the mesh."""
    import torch.distributed as dist

    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.ops import vit_mlp as tv
    from lavida_mod_tpu_torch.parallel import make_mesh
    from lavida_mod_tpu_torch.parallel.sharding import is_dtensor
    from lavida_mod_tpu_torch.train.cli import geometry_config

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0,
                            device_id=device)
    try:
        mesh = make_mesh(1, 1, 1)
        gen = GenerationConfig(**GEN)
        ids, views, size = bench_requests(np.random.default_rng(0))[0]
        serve = (lambda: model.generate_fused(ids, [views], [size], gen))
        # encode_prompt (the bf16 `generate`'s prefix) runs the tower's MLP
        # through #9, with whole fc1 / fc2 weights under a mesh
        encode = (lambda: model.encode_prompt(ids, [views], [size]))
        ops = dict(_train_ops(), fused_vit_mlp=tv.fused_vit_mlp)
        outs, counts, walls, prefixes = [], [], [], []
        for sharded in (False, True):
            if sharded:
                model.shard(mesh=mesh)
            serve()                                 # warm-up
            # three timed requests a side: one wall alone moved 1.04x-1.30x
            # between two runs of this phase
            walls.append([])
            for _ in range(SHARD_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, got = _step_launches(torch, ops, serve)
                walls[-1].append(time.perf_counter() - t0)
            outs.append(out)
            prefix, vit = _step_launches(torch, ops, encode)
            prefixes.append(prefix)
            counts.append({"short_attention": got["short_attention"],
                           "gather_rows": got["gather_rows"],
                           "fused_vit_mlp": got["fused_vit_mlp"],
                           "fused_vit_mlp_prompt": vit["fused_vit_mlp"]})
        n_dt = sum(is_dtensor(p) for p in model.parameters())
        host = _sharded_host_cost(torch, model, serve)
        print(f"[shard] 8B bf16 bench request, unsharded then under "
              f"LaViDa.shard on a one-rank NCCL mesh ({n_dt} DTensor "
              f"parameters): walls "
              f"{[[round(w * 1e3, 1) for w in ws] for ws in walls]} ms; "
              f"{host['calls']} sharded weight reads per request at "
              f"{host['us_dtensor']:.2f} us each on the host against "
              f"{host['us_plain']:.2f} us for a plain weight ("
              f"{host['calls'] * (host['us_dtensor'] - host['us_plain']) / 1e3:.1f}"
              f" ms a request), "
              f"launches {counts}, tokens equal "
              f"{bool(np.array_equal(outs[0], outs[1]))}, encode_prompt "
              f"bit-equal {bool(torch.equal(prefixes[0], prefixes[1]))} "
              f"({card})")
        if not np.array_equal(outs[0], outs[1]):
            raise AssertionError(f"sharded tokens {outs[1]} vs {outs[0]}")
        if not torch.equal(prefixes[0], prefixes[1]):
            raise AssertionError("the sharded encode_prompt differs")
        if counts[0] != counts[1] or counts[0] != {
                "short_attention": SIGLIP_LAYERS + LLADA_LAYERS,
                "gather_rows": 1, "fused_vit_mlp": 0,
                "fused_vit_mlp_prompt": SIGLIP_LAYERS}:
            raise AssertionError(f"launches {counts}")
        del model
        torch.cuda.empty_cache()
        cfg = geometry_config("457m")
        batch = train_batch(cfg, BATCH_SIZES, np.random.default_rng(18))
        runs = [_train_457m(torch, device, cfg, batch, m)
                for m in (None, None, mesh)]
        vals = [(r[0]["loss"].item(), r[0]["grad_norm"].item())
                for r in runs]
        repeat = (torch.equal(runs[0][0]["loss"], runs[1][0]["loss"])
                  and torch.equal(runs[0][0]["grad_norm"],
                                  runs[1][0]["grad_norm"]))
        equal = (torch.equal(runs[0][0]["loss"], runs[2][0]["loss"])
                 and torch.equal(runs[0][0]["grad_norm"],
                                 runs[2][0]["grad_norm"]))
        print(f"[shard] 457m stage-1 step (loss, grad_norm): unsharded "
              f"{vals[0]}, again {vals[1]} (repeats bit for bit: {repeat}),"
              f" one-rank mesh {vals[2]} (bit-equal: {equal}); launches "
              f"{runs[0][1]} / {runs[2][1]} ({card})")
        if repeat and not equal:
            raise AssertionError("the sharded 457m step differs")
        # where the unsharded step does not repeat bit for bit, the
        # sharded one's loss and grad_norm must both lie within the
        # spread of its two runs
        if not repeat and not all(abs(vals[2][i] - vals[0][i])
                                  <= abs(vals[1][i] - vals[0][i])
                                  for i in (0, 1)):
            raise AssertionError("the sharded 457m step is outside the "
                                 "unsharded step's repeat spread")
        if runs[0][1] != runs[2][1]:
            raise AssertionError(f"457m launches {runs[0][1]} vs "
                                 f"{runs[2][1]}")
    finally:
        dist.destroy_process_group()
    return {"walls": walls, "counts": counts[1], "train": vals,
            "repeat": repeat, "equal": equal, "host": host}


SHARD_REPEATS = 3


def _sharded_host_cost(torch, model, serve):
    """The host's side of a sharded linear: how many weight reads
    (`compute_weight`) one request makes, and the host time of one read
    with its tp lookup on a DTensor weight against a plain one."""
    from lavida_mod_tpu_torch.parallel import sharding as shd

    calls = [0]
    orig = shd.compute_weight

    def counting(p, whole=False):
        calls[0] += 1
        return orig(p, whole)

    shd.compute_weight = counting
    try:
        serve()
    finally:
        shd.compute_weight = orig
    w = model.llada.blocks[0].q_proj.weight
    n = 2000
    us = []
    for t in (w, w.to_local()):
        t0 = time.perf_counter()
        for _ in range(n):
            shd.compute_weight(t)
            shd.tp_split(t)
        us.append((time.perf_counter() - t0) / n * 1e6)
    return {"calls": calls[0], "us_dtensor": us[0], "us_plain": us[1]}



def phase_towers(torch, device, card):
    """Phase 19: every other vision tower at its published width, built by
    build_vision_tower in bf16 with seeded weights drawn on the card
    (TOWER_RUNS), on seeded pixels: a warm-up forward, then three timed
    ones, each with the counts set to 0 just before and #1's launches read
    just after (the layers the forward runs, asserted); the output's shape,
    finite, and within TOWER_LIMIT of the same forward with the module's
    `vision_attention` swapped for short_attention_reference; every #1 call
    of a forward within ATTN_CALL_LIMIT x max|v| of the plain version on
    the same q, k and v, and two wrong attentions (a control: #1's output with its
    heads rolled by one, and #1 with q and k swapped) outside it, their
    whole-tower errors printed; the wall per image (median of the three),
    peak memory and weight bytes.  Then, over the CLIP-L run's features on
    the card, masked_drop through build_resampler in its fixed and range
    modes, equal to its CPU run of the same draws; and the resamplers at
    real widths in f32: the Q-Former (BERT-base, 32 queries,
    build_resampler's defaults) over the CLIP-L features and the perceiver
    (dim 1152, its defaults) over SigLIP-shaped features [4, 729, 1152],
    each against its CPU run of the same weights."""
    from lavida_mod_tpu_torch.models import clip, eva_clip, mlcd
    from lavida_mod_tpu_torch.models.resampler import (build_resampler,
                                                       masked_drop)
    from lavida_mod_tpu_torch.models.tower_builder import build_vision_tower
    from lavida_mod_tpu_torch.ops.short_attention import (
        short_attention, short_attention_reference)

    swapped = (clip, mlcd, eva_clip)    # the modules whose attention runs
    controls = {
        "heads_rolled": lambda q, k, v: short_attention(q, k, v).roll(
            1, dims=2),
        "q_k_swapped": lambda q, k, v: short_attention(k, q, v)}

    def forward_with(tower, pix, attn):
        """tower(pix) with every module's vision_attention = attn, and the
        largest error of attn's calls against the plain version on the
        same q, k and v (max|diff| / max|v|)."""
        errs = [0.0]

        def checked(q, k, v):
            o = attn(q, k, v)
            if attn is not short_attention_reference:
                r = short_attention_reference(q, k, v)
                errs.append(((o.float() - r.float()).abs().max()
                             / v.float().abs().max()).item())
            return o

        kernel_attention = [m.vision_attention for m in swapped]
        for m in swapped:
            m.vision_attention = checked
        try:
            return tower(pix), max(errs)
        finally:
            for m, f in zip(swapped, kernel_attention):
                m.vision_attention = f

    out, clip_feats = {}, None
    for label, name, kw, n, side, want, shape in TOWER_RUNS:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg, tower = build_vision_tower(
            name, device=device, dtype=torch.bfloat16,
            generator=torch.Generator(device=device).manual_seed(0), **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        wbytes = _tree_bytes([tower])
        pix = torch.randn(n, 3, side, side, device=device,
                          generator=torch.Generator(device=device)
                          .manual_seed(1))
        walls = []
        with torch.no_grad():
            tower(pix)
            torch.cuda.reset_peak_memory_stats()
            for _ in range(3):
                short_attention.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                feats = tower(pix)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                launches = short_attention.launches
                if launches != want:
                    raise AssertionError(
                        f"tower {label}: {launches} short_attention "
                        f"launches, want {want}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            ref, _ = forward_with(tower, pix, short_attention_reference)
            _, call_err = forward_with(tower, pix, short_attention)
            control_call, control_tower = {}, {}
            for c, attn in controls.items():
                y, control_call[c] = forward_with(tower, pix, attn)
                control_tower[c] = _rel(y, ref)
        err = _rel(feats, ref)
        if tuple(feats.shape) != shape or not torch.isfinite(feats).all() \
                or not err < TOWER_LIMIT or not call_err < ATTN_CALL_LIMIT:
            raise AssertionError(f"tower {label}: output {tuple(feats.shape)}"
                                 f" (want {shape}), finite "
                                 f"{bool(torch.isfinite(feats).all())}, vs "
                                 f"the plain attention {err:.3e}, its "
                                 f"calls {call_err:.3e}")
        blind = [c for c, e in control_call.items()
                 if not e > ATTN_CALL_LIMIT]
        if blind:
            raise AssertionError(f"tower {label}: the per-call check passes "
                                 f"the wrong attentions {blind} "
                                 f"({control_call})")
        wall = sorted(walls)[1]
        print(f"[towers] {label} ({type(tower).__name__}, "
              f"{n} x {side}^2 images): wall {wall * 1e3:.2f} ms "
              f"({wall * 1e3 / n:.2f} ms per image; three runs "
              f"{[round(w * 1e3, 2) for w in walls]} ms), peak {peak:.2f} "
              f"GiB, weights {wbytes / 1e9:.3f} GB bf16 (built in "
              f"{build_s:.2f} s), {launches} short_attention launches, "
              f"output {tuple(feats.shape)} {str(feats.dtype)[6:]}, vs the "
              f"plain attention max|diff|/max|ref| {err:.3e} (limit "
              f"{TOWER_LIMIT}), #1's calls against the plain version on "
              f"their q, k, v at most {call_err:.3e} of max|v| (limit "
              f"{ATTN_CALL_LIMIT}) ({card})")
        for c in controls:
            print(f"[towers] {label} control {c}: its calls "
                  f"{control_call[c]:.3e} (fails {ATTN_CALL_LIMIT}), the "
                  f"whole tower {control_tower[c]:.3e} ("
                  f"{'fails' if not control_tower[c] < TOWER_LIMIT else 'passes'}"
                  f" TOWER_LIMIT {TOWER_LIMIT})")
        out[label] = {"wall_ms": wall * 1e3, "ms_per_image": wall * 1e3 / n,
                      "peak_gib": peak, "weight_gb": wbytes / 1e9,
                      "launches": launches, "err": err, "call_err": call_err,
                      "control_call_err": control_call,
                      "control_tower_err": control_tower}
        if label == "clip":
            clip_feats = feats.float()
        del tower, feats, ref, y
    torch.cuda.empty_cache()

    for mode in ("fixed", "range"):
        g = torch.Generator(device=device).manual_seed(3)
        state = g.get_state()
        y = build_resampler("masked_drop", mode=mode)(clip_feats, g,
                                                      training=True)
        # the same draws again, in masked_drop's order, on the CPU
        g.set_state(state)
        draws = {}
        if mode == "range":
            draws["ratio"] = 0.25 + (0.75 - 0.25) * torch.rand(
                (), generator=g, device=device)
        draws["noise"] = torch.rand(clip_feats.shape[:2], generator=g,
                                    device=device)
        want = masked_drop(clip_feats.cpu(), mode=mode,
                           draws={k: v.cpu() for k, v in draws.items()})
        if y.device != clip_feats.device or not torch.equal(y.cpu(), want):
            raise AssertionError(f"masked_drop {mode} on the card: "
                                 f"{tuple(y.shape)} on {y.device}, not its "
                                 f"CPU run of the same draws "
                                 f"{tuple(want.shape)}")
        print(f"[towers] resampler masked_drop {mode} over "
              f"{tuple(clip_feats.shape)} on the card -> {tuple(y.shape)}, "
              f"equal to its CPU run of the same draws")
        out[f"masked_drop_{mode}"] = {"kept": y.shape[1]}

    gen = torch.Generator(device=device).manual_seed(2)
    siglip_feats = torch.randn(4, 729, 1152, device=device, generator=gen)
    for name, dim, x in (("qformer", clip_feats.shape[-1], clip_feats),
                         ("perceiver", 1152, siglip_feats)):
        m = build_resampler(name, dim=dim, generator=gen, device=device)
        cpu = type(m)(m.cfg, "cpu") if name == "qformer" else type(m)(
            dim, device="cpu")
        cpu.load_state_dict(m.state_dict())
        with torch.no_grad():
            m(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = m(x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            y_cpu = cpu(x.cpu())
            cpu_s = time.perf_counter() - t0
        err = _rel(y.cpu(), y_cpu)
        if not torch.isfinite(y).all() or not err < RESAMPLER_LIMIT:
            raise AssertionError(f"resampler {name}: {tuple(y.shape)} vs "
                                 f"its CPU run {err:.3e}")
        n = sum(p.numel() for p in m.parameters())
        print(f"[towers] resampler {name} ({n / 1e6:.1f} M params f32) over "
              f"{tuple(x.shape)} -> {tuple(y.shape)}: wall "
              f"{wall * 1e3:.2f} ms ({card}), vs its CPU run of the same "
              f"weights ({cpu_s:.2f} s) max|diff|/max|ref| {err:.3e} "
              f"(limit {RESAMPLER_LIMIT})")
        out[name] = {"wall_ms": wall * 1e3, "err": err}
    return out


# ---------------------------------------------------------------------------
# the AR baselines and the int8 tower (phases 20-23)
# ---------------------------------------------------------------------------

AR_G = 32            # bench.py --ar's --gen-len
# the cached decode against a full causal recompute on the card: each
# token the recompute's argmax but where its top two are within 2 x the
# step's largest logit difference, and the logits within twice the
# recompute's own distance from a recompute 8 rows shorter on their
# common rows (max |diff| over max |logit|; cuBLAS's products of other
# shapes sum in other orders, and 32 seeded layers carry the difference
# to 2.9e-2 in bf16 and 7.5e-2 in int4 on an NVIDIA H100 80GB HBM3), or
# within AR_RECOMPUTE_LIMIT where that distance is smaller
AR_RECOMPUTE_LIMIT = 2e-2
# the same check in f32 (TF32 off): Mixtral's top-2 routing turns a bf16
# rounding into another expert, so its cached decode is also held to the
# recompute on an f32 copy of the 4 layers, where no rounding moves a
# choice: logits within AR_F32_LIMIT, tokens equal
AR_F32_LIMIT = 1e-3
# the int8 tower (int8 weights and activations, #3) against the bf16 tower
# on the same request: max |diff| over max |bf16 feature|, the eval
# block's limit for SigLIP's 26 layers (TOWER_LIMIT)
TOWER_INT8_LIMIT = 5e-2
# moe_ff's batched experts against a loop over the experts on the same
# operands, bf16: max |diff| over max |loop output|
MOE_LOOP_LIMIT = 2e-2
MIXTRAL_LAYERS = 4   # Mixtral-8x7B cut to 4 of its 32 layers (93 GB bf16)


def vicuna_config():
    """bench.py --ar's LM: the Vicuna-7B geometry (LLaVA-1.6-7B's
    backbone, bench.py:194-199): MHA 32 / 32 heads, FF 11008, vocab 32000,
    the other fields LLaDAConfig's defaults but the embedding: bench.py
    leaves embedding_size at LLaDAConfig's 126464 (a head 3.95x
    Vicuna's); this phase gives it Vicuna's 32000 rows."""
    from lavida_mod_tpu_torch.config import LLaDAConfig

    return LLaDAConfig(vocab_size=32000, embedding_size=32000, d_model=4096,
                       n_layers=32, n_heads=32, n_kv_heads=32,
                       mlp_hidden_size=11008, block_type="llama",
                       activation="silu", max_sequence_length=4096)


def _ar_recompute(torch, lm, prefix, out, logits, tag, limit=None):
    """Hold a cached AR decode (tokens out [1, G], the logits each was
    drawn from [1, G, V]) to one full causal forward over [prefix, out[:-1]]
    on the card (see AR_RECOMPUTE_LIMIT; `limit`: a fixed limit instead):
    returns (max relative logit difference, the recompute's own distance
    from a shorter one, near-ties)."""
    G = out.shape[1]
    P = prefix.shape[1]
    seq = torch.cat([prefix, lm.embed_tokens(out[:, :-1])], dim=1)
    full, _ = lm(seq, causal=True, logits_from=P - 1)
    short, _ = lm(seq[:, :-8], causal=True, logits_from=P - 1)
    scale = full.abs().max()
    rel = ((full - logits).abs().max() / scale).item()
    floor = ((full[:, :short.shape[1]] - short).abs().max() / scale).item()
    bound = limit if limit is not None else max(AR_RECOMPUTE_LIMIT,
                                                2 * floor)
    if not rel < bound:
        raise AssertionError(f"{tag}: cached decode vs recompute {rel:.3e}"
                             f" (limit {bound:.3e}; the recompute against "
                             f"a shorter one {floor:.3e})")
    ties = 0
    for t in range(G):
        if int(full[0, t].argmax()) == int(out[0, t]):
            continue
        delta = (full[0, t] - logits[0, t]).abs().max().item()
        top2 = torch.topk(full[0, t], 2).values
        if (top2[0] - top2[1]).item() > 2 * delta:
            raise AssertionError(f"{tag}: token {t} is not the recompute's")
        ties += 1
    return rel, floor, ties


def _ar_run(torch, lm, prefix, G):
    from lavida_mod_tpu_torch.generation.ar_sampler import ar_generate_fused

    return ar_generate_fused(lm, prefix, G, return_logits=True)


def phase_ar_vicuna(torch, device, card, res):
    """Phase 20, bench.py --ar's layout: LaViDaConfig(llada=Vicuna-7B) from
    seed 0, the LM through to_serving_layout("int4", fuse=True) (the fused
    [q|k|v] / [up|gate] layout in grouped int4), one HD request at B = 1
    (640 x 640: base + 4 tiles of 384^2, a 48-token prompt) encoded with
    the fused ViT MLP, spliced, and decoded 32 tokens by ar_generate_fused
    (a causal prefill, then one row a step).  Launches reckoned before the
    run: 26 #1 and 26 #9 (the tower), 1 #2, #4's prefill kernel 4 linears
    x 32 layers over the P > 256 prefill rows, its decode kernel the 128
    linears and the head for each of the 31 one-row steps plus the
    prefill's last-row head (4000).  #4 at each new shape bit-exact to its
    plain version; the tokens held to a full causal recompute."""
    from lavida_mod_tpu_torch.config import LaViDaConfig
    from lavida_mod_tpu_torch.models import multimodal
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.ops import w4_grouped as tg

    t_phase = time.perf_counter()
    cfg = LaViDaConfig(llada=vicuna_config())
    model = LaViDa.random_init(cfg, 0, torch.bfloat16, device)
    model.to_serving_layout("int4", fuse=True)
    lm = model.llada
    ids, views, size = bench_request(48, (640, 640),
                                     np.random.default_rng(20))
    idx, text_ids, _, _ = multimodal.build_gather_plan(
        model.cfg, [ids], [[views.shape[0]]], [[size]])
    P = idx.shape[1]
    pix = torch.as_tensor(views, device=device)

    def request():
        prefix = multimodal.multimodal_embeds(model, pix, text_ids, idx,
                                              fused_mlp=True)
        return prefix, _ar_run(torch, lm, prefix, AR_G)

    request()                                       # warm-up
    want = _want(short_attention=SIGLIP_LAYERS, fused_vit_mlp=SIGLIP_LAYERS,
                 gather_rows=1,
                 w4_matmul_grouped_prefill=4 * LLADA_LAYERS,
                 w4_matmul_grouped_decode=(AR_G - 1) * (4 * LLADA_LAYERS + 1)
                 + 1)
    (prefix, (out, logits)), wall, peak, got = _counted(torch, request)
    _check("AR Vicuna int4", got, want)
    if out.shape != (1, AR_G) or int(out.max()) >= cfg.llada.vocab_size:
        raise AssertionError(f"AR Vicuna tokens {out}")
    rel, floor, ties = _ar_recompute(torch, lm, prefix, out, logits,
                                     "AR Vicuna")

    # #4 at the path's new shapes, each bit-exact: the one-row decode and
    # the P-row prefill of the four fused linears (ff_out's K 11008 padded
    # to 12288), the head's 32000 columns padded to 32256
    gen = torch.Generator(device=device).manual_seed(20)
    blk = lm.blocks[0]
    shapes = [(n, getattr(blk, n)) for n in ("att_proj", "attn_out",
                                              "ff_proj", "ff_out")]
    shapes.append(("head", lm.ff_out))
    for T in (1, P):
        for name, lin in shapes:
            if name == "head" and T > 1:
                continue
            K = lin.packed.shape[1] * 128
            N = lin.scales.shape[1]
            x = (torch.randn(T, K, device=device, generator=gen)
                 .bfloat16())
            if K != lin.in_features:
                x[:, lin.in_features:] = 0
            outk = tg.w4_matmul_grouped(x, lin.packed, lin.scales)
            torch.cuda.synchronize()
            ref = tg.w4_matmul_grouped_reference(x, lin.packed, lin.scales)
            if not torch.equal(outk, ref):
                raise AssertionError(f"w4_matmul_grouped differs at AR "
                                     f"{name} [{T},{K}]x{N}")
            per = (AR_G - 1 if T == 1 else 1) * (
                1 if name == "head" else LLADA_LAYERS) + (
                1 if name == "head" else 0)
            res.add(f"w4_matmul_grouped_{tg.regime(T)}",
                    f"AR Vicuna {name} [{T},{K}]x[{K},{N}]", per, 0.0,
                    lambda: tg.w4_matmul_grouped(x, lin.packed, lin.scales),
                    cuda_ms(lambda: tg.w4_matmul_grouped_reference(
                        x, lin.packed, lin.scales), 3), None,
                    2 * T * K * N, 2 * T * K + _w4_bytes(K, N) + 2 * T * N,
                    int8=True, note=" (exact)", weight=0)
    weights = _tree_bytes([lm]) / 1e9
    del model, lm, prefix, logits
    torch.cuda.empty_cache()
    r = {"wall": wall, "peak": peak, "P": P, "ties": ties, "rel": rel,
         "floor": floor, "weight_gb": weights, "tokens": out[0].tolist(),
         "phase_s": time.perf_counter() - t_phase}
    print(f"[ar] bench --ar layout (Vicuna-7B int4 fused, B = 1, P = {P}, "
          f"G = {AR_G}): request wall {wall * 1e3:.1f} ms, peak {peak:.2f} "
          f"GiB, LM weights {weights:.2f} GB; launches {got} (reckoned "
          f"{want}); cached decode vs full causal recompute: logits within "
          f"{rel:.3e} of max |logit| (the recompute vs one 8 rows shorter "
          f"{floor:.3e}), {ties} near-tie tokens; tokens "
          f"{r['tokens']}; phase {r['phase_s']:.1f} s ({card})")
    return got, r


def phase_ar_llama3(torch, device, card):
    """Phase 21: Llama-3-8B (GQA 32 / 8, vocab 128256) at full width and
    depth in bf16 from seed 0, a 128-token text prompt, 32 greedy tokens
    by ar_generate_fused, held to a full causal recompute.  No kernel of
    the port runs (bf16 linears and the causal attention are dense)."""
    from lavida_mod_tpu_torch.models.ar_models import (llama3_8b_config,
                                                       random_ar_model)

    t_phase = time.perf_counter()
    cfg = llama3_8b_config()
    lm = random_ar_model(cfg, 0, torch.bfloat16, device)
    ids = torch.as_tensor(np.random.default_rng(21).integers(
        3, cfg.vocab_size, size=(1, 128)), device=device)

    def request():
        prefix = lm.embed_tokens(ids)
        return prefix, _ar_run(torch, lm, prefix, AR_G)

    request()
    (prefix, (out, logits)), wall, peak, got = _counted(torch, request)
    _check("AR Llama-3 bf16", got, _want())
    if out.shape != (1, AR_G) or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"AR Llama-3 tokens {out}")
    rel, floor, ties = _ar_recompute(torch, lm, prefix, out, logits,
                                     "AR Llama-3")
    weights = _tree_bytes([lm]) / 1e9
    del lm, prefix, logits
    torch.cuda.empty_cache()
    r = {"wall": wall, "peak": peak, "ties": ties, "rel": rel,
         "floor": floor, "weight_gb": weights,
         "phase_s": time.perf_counter() - t_phase}
    print(f"[ar] Llama-3-8B bf16 (P = 128, G = {AR_G}): request wall "
          f"{wall * 1e3:.1f} ms, peak {peak:.2f} GiB, weights {weights:.2f} "
          f"GB; recompute: logits within {rel:.3e} (its own distance from a "
          f"shorter one {floor:.3e}), {ties} near-tie tokens; "
          f"tokens {out[0].tolist()}; phase {r['phase_s']:.1f} s ({card})")
    return got, r


def phase_ar_mixtral(torch, device, card):
    """Phase 22: Mixtral-8x7B at full width (8 experts of 14336, top-2)
    cut to MIXTRAL_LAYERS layers (its 32 hold ~93 GB of bf16, over the
    card's 80), seed 0: one block's moe_ff held to a loop over the experts
    on the same operands, then a 64-token prompt decoded 16 tokens, held
    to a full causal recompute, in bf16 and on an f32 copy (AR_F32_LIMIT:
    there no rounding moves a top-2 choice)."""
    from lavida_mod_tpu_torch.models.ar_models import (mixtral_8x7b_config,
                                                       random_ar_model)
    from lavida_mod_tpu_torch.models.moe import top_k_gate
    from lavida_mod_tpu_torch.ops.activations import silu

    t_phase = time.perf_counter()
    cfg = mixtral_8x7b_config(n_layers=MIXTRAL_LAYERS)
    lm = random_ar_model(cfg, 0, torch.bfloat16, device,
                         moe=(8, cfg.hidden_size))
    ids = torch.as_tensor(np.random.default_rng(22).integers(
        3, cfg.vocab_size, size=(1, 64)), device=device)
    moe = lm.blocks[0].moe
    x = lm.blocks[0].ff_norm(lm.embed_tokens(ids))
    got_ff, load = moe(x)
    probs = torch.softmax((x @ moe.router).float(), dim=-1)
    gate = top_k_gate(probs, 2).to(x.dtype)
    loop = torch.zeros_like(x)
    for e in range(moe.n_experts):
        y = (silu(x @ moe.ff_proj[e]) * (x @ moe.up_proj[e])) @ moe.ff_out[e]
        loop = loop + y * gate[..., e:e + 1]
    moe_rel = ((got_ff.float() - loop.float()).abs().max()
               / loop.float().abs().max()).item()
    if not moe_rel < MOE_LOOP_LIMIT:
        raise AssertionError(f"moe_ff vs the expert loop: {moe_rel:.3e}")
    G = 16

    def request():
        prefix = lm.embed_tokens(ids)
        return prefix, _ar_run(torch, lm, prefix, G)

    request()
    (prefix, (out, logits)), wall, peak, got = _counted(torch, request)
    _check("AR Mixtral", got, _want())
    rel, floor, ties = _ar_recompute(torch, lm, prefix, out, logits,
                                     "AR Mixtral")
    weights = _tree_bytes([lm]) / 1e9
    del moe, prefix, logits, x
    # the f32 copy: the cached decode against the recompute where no
    # rounding moves a routing choice
    lm.float()
    prefix = lm.embed_tokens(ids)
    out32, logits32 = _ar_run(torch, lm, prefix, G)
    rel32, floor32, ties32 = _ar_recompute(torch, lm, prefix, out32,
                                           logits32, "AR Mixtral f32",
                                           limit=AR_F32_LIMIT)
    if ties32:
        raise AssertionError(f"AR Mixtral f32: {ties32} tokens differ")
    del lm, prefix, logits32
    torch.cuda.empty_cache()
    r = {"wall": wall, "peak": peak, "ties": ties, "rel": rel,
         "floor": floor, "rel32": rel32, "moe_rel": moe_rel,
         "weight_gb": weights, "load_max": float(load.max()),
         "phase_s": time.perf_counter() - t_phase}
    print(f"[ar] Mixtral-8x7B at {MIXTRAL_LAYERS} of 32 layers bf16 (P = 64, "
          f"G = {G}): moe_ff vs the expert loop {moe_rel:.3e} (limit "
          f"{MOE_LOOP_LIMIT}); request wall {wall * 1e3:.1f} ms, peak "
          f"{peak:.2f} GiB, weights {weights:.2f} GB; recompute: logits "
          f"within {rel:.3e} (its own distance from a shorter one "
          f"{floor:.3e}), {ties} near-tie tokens, in f32 {rel32:.3e} with "
          f"every token the recompute's; tokens "
          f"{out[0].tolist()}; phase {r['phase_s']:.1f} s ({card})")
    return got, r


def phase_int8_tower(torch, model, requests, card, res):
    """Phase 23, on phase 5's mixed model: the first request's 5-view
    tower in bf16 (plain MLP), then SigLIP.quantize_tower and the same
    views with vision_act_int8 (156 #3 launches: 6 linears x 26 layers at
    T = 3645), the first and last layers' six #3 calls held bit-exact to
    the plain version and timed per shape, the features held to the bf16
    tower's (TOWER_INT8_LIMIT); then one default mixed request through
    that tower (its splice by multimodal_embeds(vision_act_int8=True), the
    mixed cached generation).  The tower stays int8 afterwards."""
    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.generation.diffusion import (
        build_control_table, generate_cached_fused)
    from lavida_mod_tpu_torch.models import multimodal
    from lavida_mod_tpu_torch.ops import w8a8 as t8

    t_phase = time.perf_counter()
    device = model.device
    ids, views, size = requests[0]
    pix = torch.as_tensor(views, device=device)
    ref = model.siglip(pix)
    model.siglip.quantize_tower()
    torch.cuda.empty_cache()
    names = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
    layers = model.siglip.layers
    inputs = {}
    hooks = [getattr(layers[i], n).register_forward_hook(
        lambda m, args, out, key=(i, n): inputs.__setitem__(key, args[0]))
        for i in (0, len(layers) - 1) for n in names]
    try:
        feats, wall, peak, got = _counted(
            torch, lambda: model.siglip(pix, act_int8=True))
    finally:
        for h in hooks:
            h.remove()
    _check("int8 tower", got, _want(short_attention=SIGLIP_LAYERS,
                                    w8a8_matmul=6 * SIGLIP_LAYERS))
    rel = ((feats.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    if not rel < TOWER_INT8_LIMIT:
        raise AssertionError(f"int8 tower vs bf16 tower: {rel:.3e}")
    # the first and the last layer's six calls, on the inputs they had
    for (i, n), x in inputs.items():
        lin = getattr(layers[i], n)
        x8, sx = t8.act_quant(x.reshape(-1, x.shape[-1]).contiguous(),
                              t8.ACT_FORMULA_W8)
        w8, scale, bias = lin.weight_q, lin.scale, lin.bias
        out = t8.w8a8_matmul(x8, sx, w8, scale, bias)
        torch.cuda.synchronize()
        if not torch.equal(out, t8.w8a8_matmul_reference(x8, sx, w8, scale,
                                                         bias)):
            raise AssertionError(f"w8a8_matmul differs at the tower's {n}, "
                                 f"layer {i}")
        if i or n in ("k_proj", "v_proj", "out_proj"):
            continue        # q's shape is timed once for the four
        T, K = x8.shape
        N = w8.shape[0]
        qt = w8.t()
        try:
            torch._int_mm(x8, qt)
        except RuntimeError:
            qt = qt.contiguous()
        res.add("w8a8_matmul", f"int8 tower {n} [{T},{K}]x[{K},{N}] + bias",
                (4 if n == "q_proj" else 1) * SIGLIP_LAYERS, 0.0,
                lambda: t8.w8a8_matmul(x8, sx, w8, scale, bias),
                cuda_ms(lambda: t8.w8a8_matmul_reference(
                    x8, sx, w8, scale, bias), 3),
                cuda_ms(lambda: (torch._int_mm(x8, qt).float() * sx * scale
                                 + bias.float()).bfloat16()),
                2 * T * K * N, T * K + N * K + 4 * (T + N) + 2 * T * N
                + 2 * N, int8=True, note=" (exact)", weight=0)
    del inputs, ref, feats

    gen = GenerationConfig(**GEN)
    idx, text_ids, _, _ = multimodal.build_gather_plan(
        model.cfg, [ids], [[views.shape[0]]], [[size]])
    G, mask_id = gen.max_new_tokens, model.cfg.llada.mask_token_id
    k_table, block_end = build_control_table(
        np.full((1, G), mask_id, np.int64), 0, G, gen, mask_id)
    k_table = torch.as_tensor(k_table, device=device)
    block_end = torch.as_tensor(block_end, device=device)

    def request():
        prefix = multimodal.multimodal_embeds(model, pix, text_ids, idx,
                                              vision_act_int8=True)
        x = torch.full((1, G), mask_id, dtype=torch.long, device=device)
        return generate_cached_fused(
            model.llada, x, prefix, k_table, block_end, None,
            torch.Generator(device=device).manual_seed(0), gen.temperature,
            gen.remasking, act_int8_prefill=True)

    request()
    out, req_wall, req_peak, req_got = _counted(torch, request)
    _check("mixed request with the int8 tower", req_got, _want(
        short_attention=SIGLIP_LAYERS + LLADA_LAYERS, gather_rows=1,
        w8a8_matmul=6 * SIGLIP_LAYERS + 4 * LLADA_LAYERS,
        decode_attention=LLADA_LAYERS * STEPS,
        w4_qkv_norm=(LLADA_LAYERS + 1) * STEPS,
        w4_matmul_res=LLADA_LAYERS * STEPS,
        w4_ffn_fused=LLADA_LAYERS * STEPS), out[0], G, mask_id)
    r = {"tower_wall": wall, "tower_peak": peak, "rel": rel,
         "request_wall": req_wall, "request_peak": req_peak,
         "phase_s": time.perf_counter() - t_phase}
    print(f"[int8 tower] SigLIP so400m int8 (weights and activations, #3) "
          f"on {views.shape[0]} views: tower wall {wall * 1e3:.1f} ms, peak "
          f"{peak:.2f} GiB, features within {rel:.3e} of the bf16 tower's "
          f"(limit {TOWER_INT8_LIMIT}); tower launches {got}; mixed 8B "
          f"request with it: wall {req_wall * 1e3:.1f} ms, peak "
          f"{req_peak:.2f} GiB, launches {req_got}, tokens "
          f"{out[0].tolist()}; phase {r['phase_s']:.1f} s ({card})")
    return got, req_got, r


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_start = time.perf_counter()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    from lavida_mod_tpu_torch import kernels

    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()       # raises if a register count is off
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.2f} s; "
          f"registers at entry as the designs need: "
          f"{kernels.REGISTERS_AT_ENTRY}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        # "== <source>" heads each source's kernels
        if line.startswith("== ") or "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    res = Results()
    with torch.no_grad():
        phase_kernels(torch, device, res)
        phase_quant_kernels(torch, device, res)
        w4mm_cold = phase_w4_matmul(torch, device, res)
        phase_batch_kernels(torch, device, res)
        phase_train_kernels(torch, device, res)
    res.summary("short_attention", "one mixed request (26 SigLIP + 32 "
                "prefill launches)", card)
    res.summary("w8a8_matmul", "one mixed request (128 launches)", card)
    res.summary("decode_attention", "one bf16 request (32 layers x 16 "
                "steps)", card)
    res.summary("short_attention_f32", "one SHIRG-LoRA harness step (26 "
                "launches in the tower's forward)", card)
    prefix_flash_summary(res, card)
    torch.cuda.empty_cache()
    model, requests, counts, walls = phase_main_path(torch, device, card)
    proj_kinds = phase_projector_kinds(torch, model, requests, card)
    br16 = phase_branches_bf16(torch, model, requests, card)
    shirg16 = phase_shirg_bf16(torch, model, card)
    mixed_counts, mixed_walls, peaks, fused_layer_ms = phase_mixed_path(
        torch, model, requests, card)
    kv4_counts, kv4_wall, kv4_peak = phase_kv4_request(torch, model,
                                                       requests, card)
    loglik = phase_loglik(torch, model, card)
    shirg_mx = phase_shirg_mixed(torch, model, card)
    int8_tower = phase_int8_tower(torch, model, requests, card, res)
    del model
    torch.cuda.empty_cache()
    phase_small_reference(torch, device)
    phase_small_mixed(torch, device)
    phase_small_branches(torch, device)
    phase_small_shirg(torch, device)
    torch.cuda.empty_cache()
    ckpt_counts, ckpt = phase_checkpoint(torch, device, card)
    torch.cuda.empty_cache()
    from lavida_mod_tpu_torch.rehearse_8b_load import DEFAULT_PATH

    fim_counts, fim_wall, fim_peak = phase_fim(torch, card, DEFAULT_PATH)
    torch.cuda.empty_cache()
    eval_counts, ev = phase_eval(torch, card, DEFAULT_PATH)
    torch.cuda.empty_cache()
    server_counts, server_walls, server_peak, server_share = phase_server(
        torch, device, card, DEFAULT_PATH)
    torch.cuda.empty_cache()
    model, batch_counts, batch_walls, share, unfused_layer_ms = \
        phase_batched_path(torch, device, card)
    br4 = phase_branches_int4(torch, model, card)
    del model
    torch.cuda.empty_cache()
    phase_small_batch(torch, device)
    train_counts, stage1 = phase_stage1(torch, device, card)
    stage2_peak = phase_stage2(torch, device, card)
    phase_small_train(torch, device)
    torch.cuda.empty_cache()
    if os.path.exists(TRAIN_ROOT):
        raise RuntimeError(f"{TRAIN_ROOT} exists: delete it first (the "
                           f"training CLI phases write there)")
    try:
        cli_counts, t1 = phase_train_cli_stage1(torch, device, card, stage1)
        t2 = phase_train_cli_457m(torch, device, card)
        ladder = phase_remat_ladder(torch, device, card)
        phase_tokenizer_gap(card)
        torch.cuda.empty_cache()
        shirg_lora = phase_shirg_lora_harness(torch, device, card)
    finally:
        shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    torch.cuda.empty_cache()
    from lavida_mod_tpu_torch.config import LaViDaConfig, dream_7b_config
    from lavida_mod_tpu_torch.models.multimodal import build_gather_plan

    ids, views, size = bench_requests(np.random.default_rng(0))[0]
    P_dream = build_gather_plan(
        LaViDaConfig(llada=dream_7b_config()), [ids], [[views.shape[0]]],
        [[size]])[0].shape[1]
    dres = Results()
    with torch.no_grad():
        phase_dream_kernels(torch, device, dres, P_dream)
    for name in dres.k:
        dres.summary(name, "one LaViDa-Dream request (Dream-7B shapes)",
                     card)
    torch.cuda.empty_cache()
    dream_counts, dream = phase_dream_path(torch, device, card)
    torch.cuda.empty_cache()
    phase_small_dream(torch, device)
    dream_train_counts, dream_train = phase_dream_train(torch, device, card)
    dpo_counts, dpo_build, dpo, dpo_model = phase_dpo(torch, device, card)
    shard = phase_sharded(torch, device, card, dpo_model)
    del dpo_model
    torch.cuda.empty_cache()
    t_towers = time.perf_counter()
    towers = phase_towers(torch, device, card)
    t_towers = time.perf_counter() - t_towers
    torch.cuda.empty_cache()
    with torch.no_grad():
        ar_counts, ar_vicuna = phase_ar_vicuna(torch, device, card, res)
        _, ar_llama = phase_ar_llama3(torch, device, card)
        _, ar_mixtral = phase_ar_mixtral(torch, device, card)
    torch.cuda.empty_cache()
    print(f"[batch] #4 design point, one decode layer at B = 1, device "
          f"time: fused plan {fused_layer_ms[1]:.4f} ms vs unfused grouped "
          f"int4 {unfused_layer_ms[1]:.4f} ms; back to back "
          f"{fused_layer_ms[0]:.4f} vs {unfused_layer_ms[0]:.4f} ms ({card})")

    def entry(name, source, replaces, launches, **extra):
        return {"name": name, "route": "cuda",
                "source": f"lavida_mod_tpu_torch/csrc/{source}",
                "replaces": f"lavida_mod_tpu/ops/{replaces}",
                "launches": launches, **res.get(name), **extra}

    b4, b4k, b8 = (batch_counts[k] for k in ("b4", "b4_kv8", "b8_chunked"))
    sh16 = {k: sum(c[0][k] for c in shirg16.values())
            for k in shirg16["base"][0]}
    shmx, shfv = shirg_mx["plain tower"][0], shirg_mx["--fused-vit"][0]
    shl = shirg_lora["counts"]
    nc16, vb = br16["nocache"][0], br16["verbose"][0]
    nc4, d32, d256, c256 = (br4[k][0] for k in ("nocache", "dllm32",
                                                 "dllm256", "cached256"))
    ll_w, ll_a = loglik[False][3], loglik[True][3]
    entries = [
        entry("short_attention", "short_attention.cu",
              "short_attention.py:78", counts["short_attention"],
              launches_mixed_path=mixed_counts["short_attention"],
              launches_batch_b4=b4["short_attention"],
              launches_checkpoint_path=ckpt_counts["short_attention"],
              launches_nocache_bf16=nc16["short_attention"],
              launches_nocache_int4=nc4["short_attention"],
              launches_verbose=vb["short_attention"],
              launches_dllm_gen32=d32["short_attention"],
              launches_dllm_gen256=d256["short_attention"],
              launches_fim=fim_counts["short_attention"],
              launches_loglik=ll_w["short_attention"],
              launches_loglik_act_int8=ll_a["short_attention"],
              launches_train_cli=cli_counts["short_attention"],
              launches_shirg_bf16=sh16["short_attention"],
              launches_shirg_mixed=shmx["short_attention"],
              launches_shirg_lora=shl["short_attention"],
              launches_eval=eval_counts["short_attention"],
              launches_dream_train_step=dream_train_counts["short_attention"],
              launches_dpo_step=dpo_counts["short_attention"],
              launches_dpo_pair_build=dpo_build["short_attention"],
              launches_sharded_request=shard["counts"]["short_attention"],
              launches_projector_kinds={k: v["counts"]["short_attention"]
                                        for k, v in proj_kinds.items()},
              launches_towers={k: v["launches"] for k, v in towers.items()
                               if "launches" in v},
              launches_ar_vicuna=ar_counts["short_attention"],
              launches_int8_tower=int8_tower[0]["short_attention"],
              launches_int8_tower_request=int8_tower[1]["short_attention"]),
        entry("short_attention_f32", "short_attention.cu",
              "short_attention.py:78", shl["short_attention_f32"],
              launches_per_harness_step=SIGLIP_LAYERS),
        entry("gather_rows", "gather_rows.cu", "pallas_gather.py:26",
              counts["gather_rows"],
              launches_mixed_path=mixed_counts["gather_rows"],
              launches_checkpoint_path=ckpt_counts["gather_rows"],
              launches_train_cli=cli_counts["gather_rows"],
              launches_eval=eval_counts["gather_rows"],
              launches_dream_train_step=dream_train_counts["gather_rows"],
              launches_dpo_step=dpo_counts["gather_rows"],
              launches_dpo_pair_build=dpo_build["gather_rows"],
              launches_sharded_request=shard["counts"]["gather_rows"],
              launches_projector_kinds={k: v["counts"]["gather_rows"]
                                        for k, v in proj_kinds.items()},
              launches_ar_vicuna=ar_counts["gather_rows"],
              launches_int8_tower_request=int8_tower[1]["gather_rows"]),
        entry("w8a8_matmul", "w8a8_matmul.cu", "pallas_w8.py:53",
              mixed_counts["w8a8_matmul"],
              launches_checkpoint_path=ckpt_counts["w8a8_matmul"],
              launches_server_b4=server_counts["batch4"]["w8a8_matmul"],
              launches_loglik=ll_w["w8a8_matmul"],
              launches_loglik_act_int8=ll_a["w8a8_matmul"],
              launches_shirg_mixed=shmx["w8a8_matmul"],
              launches_eval=eval_counts["w8a8_matmul"],
              launches_int8_tower=int8_tower[0]["w8a8_matmul"],
              launches_int8_tower_request=int8_tower[1]["w8a8_matmul"]),
        entry("w4_qkv_norm", "w4_fused.cu", "w4_fused.py:80",
              mixed_counts["w4_qkv_norm"],
              launches_batch_b4=b4["w4_qkv_norm"],
              launches_checkpoint_path=ckpt_counts["w4_qkv_norm"],
              launches_dllm_gen32=d32["w4_qkv_norm"],
              launches_dllm_gen256=d256["w4_qkv_norm"],
              launches_shirg_mixed=shmx["w4_qkv_norm"],
              launches_eval=eval_counts["w4_qkv_norm"]),
        entry("w4_matmul_res", "w4_fused.cu", "w4_fused.py:250",
              mixed_counts["w4_matmul_res"],
              launches_checkpoint_path=ckpt_counts["w4_matmul_res"],
              launches_shirg_mixed=shmx["w4_matmul_res"],
              launches_eval=eval_counts["w4_matmul_res"]),
        entry("w4_ffn_fused", "w4_fused.cu", "w4_fused.py:322",
              mixed_counts["w4_ffn_fused"],
              launches_checkpoint_path=ckpt_counts["w4_ffn_fused"],
              launches_shirg_mixed=shmx["w4_ffn_fused"],
              launches_eval=eval_counts["w4_ffn_fused"]),
        entry("w4_matmul_grouped_decode", "w4_grouped.cu",
              "pallas_w4.py:129", b4["w4_matmul_grouped_decode"],
              launches_batch_b8=b8["w4_matmul_grouped_decode"],
              launches_server_b4=server_counts["batch4"][
                  "w4_matmul_grouped_decode"],
              launches_nocache_int4=nc4["w4_matmul_grouped_decode"],
              launches_dllm_gen32=d32["w4_matmul_grouped_decode"],
              launches_dllm_gen256=d256["w4_matmul_grouped_decode"],
              launches_cached_gen256=c256["w4_matmul_grouped_decode"],
              launches_ar_vicuna=ar_counts["w4_matmul_grouped_decode"]),
        entry("w4_matmul_grouped_prefill", "w4_grouped.cu",
              "pallas_w4.py:129", b4["w4_matmul_grouped_prefill"],
              launches_batch_b8=b8["w4_matmul_grouped_prefill"],
              launches_nocache_int4=nc4["w4_matmul_grouped_prefill"],
              launches_dllm_gen32=d32["w4_matmul_grouped_prefill"],
              launches_dllm_gen256=d256["w4_matmul_grouped_prefill"],
              launches_cached_gen256=c256["w4_matmul_grouped_prefill"],
              launches_ar_vicuna=ar_counts["w4_matmul_grouped_prefill"]),
        entry("kv8_decode_attention", "kv8_attention.cu",
              "kv8_attention.py:98", b4k["kv8_decode_attention"]),
        entry("decode_attention", "decode_attention.cu", "attention.py:28",
              counts["decode_attention"],
              launches_mixed_path=mixed_counts["decode_attention"],
              launches_batch_b4=b4["decode_attention"],
              launches_batch_b8=b8["decode_attention"],
              launches_checkpoint_path=ckpt_counts["decode_attention"],
              launches_dllm_gen32=d32["decode_attention"],
              launches_cached_gen256=c256["decode_attention"],
              launches_fim=fim_counts["decode_attention"],
              launches_eval=eval_counts["decode_attention"],
              launches_shirg_bf16=sh16["decode_attention"],
              launches_shirg_mixed=shmx["decode_attention"],
              launches_int8_tower_request=int8_tower[1]["decode_attention"]),
        entry("kv8_decode_attention_int4", "kv8_attention.cu",
              "kv8_attention.py:98",
              server_counts["batch4"]["kv8_decode_attention_int4"],
              launches_kv4_b1=kv4_counts["kv8_decode_attention_int4"],
              launches_server_single=server_counts["single"][
                  "kv8_decode_attention_int4"]),
        entry("fused_vit_mlp", "vit_mlp.cu", "vit_mlp.py:63",
              b4["fused_vit_mlp"], launches_batch_b8=b8["fused_vit_mlp"],
              launches_server_b4=server_counts["batch4"]["fused_vit_mlp"],
              launches_nocache_int4=nc4["fused_vit_mlp"],
              launches_loglik=ll_w["fused_vit_mlp"],
              launches_shirg_mixed_fused_vit=shfv["fused_vit_mlp"],
              launches_sharded_prompt=shard["counts"][
                  "fused_vit_mlp_prompt"],
              launches_ar_vicuna=ar_counts["fused_vit_mlp"]),
        entry("prefix_flash_fwd", "prefix_flash.cu", "prefix_flash.py:53",
              train_counts["prefix_flash_fwd"],
              launches_train_cli=cli_counts["prefix_flash_fwd"],
              launches_dream_train_step=dream_train_counts[
                  "prefix_flash_fwd"],
              launches_dpo_step=dpo_counts["prefix_flash_fwd"]),
        entry("prefix_flash_dq", "prefix_flash.cu", "prefix_flash.py:143",
              train_counts["prefix_flash_dq"],
              launches_train_cli=cli_counts["prefix_flash_dq"],
              launches_dream_train_step=dream_train_counts[
                  "prefix_flash_dq"],
              launches_dpo_step=dpo_counts["prefix_flash_dq"]),
        entry("prefix_flash_dkv", "prefix_flash.cu", "prefix_flash.py:179",
              train_counts["prefix_flash_dkv"],
              launches_train_cli=cli_counts["prefix_flash_dkv"],
              launches_dream_train_step=dream_train_counts[
                  "prefix_flash_dkv"],
              launches_dpo_step=dpo_counts["prefix_flash_dkv"]),
        entry("w4_matmul", "w4_matmul.cu", "pallas_w4.py:49", 0,
              ms_decode_cold=w4mm_cold),
    ]
    for e in entries:
        e["launches_dream_path"] = dream_counts.get(e["name"], 0)
        if e["name"] in dres.k:
            e["dream_path"] = dres.get(e["name"])
    bw = {k: (round(w * 1e3, 1), round(w * 1e3 / B, 1), round(p, 2))
          for k, (w, B, p) in batch_walls.items()}
    nc_busy = ("not measured" if br4["nocache_busy"] is None
               else f"{100 * br4['nocache_busy']:.1f} %")
    busy1 = ("not measured" if stage1["busy"] is None
             else f"{100 * stage1['busy']:.1f} %")
    busy_cli = ("not measured" if t1["busy"] is None
                else f"{100 * t1['busy']:.1f} %")
    ladder_s = {f"{r}/{a}": (round(v[0], 4), round(v[1], 3), round(v[2], 1))
                for (r, a), v in ladder.items()}
    attn1 = ("not measured" if stage1["prefix_flash_ms"] is None
             else f"{sum(stage1['prefix_flash_ms'].values()):.2f} ms")
    print("[result] kernel ms / plain_ms / library_ms / bound_ms: summed "
          "over one run's launches (bf16 path: 26 SigLIP + 32 prefill "
          "short_attention, 1 gather_rows per request; mixed path: 128 "
          "w8a8_matmul, 16 x 33 w4_qkv_norm, 16 x 32 w4_matmul_res and "
          "w4_ffn_fused per request; batched path, one B = 4 batch: 7 x 32 "
          "x 16 w4_matmul_grouped decode (128 rows) and 7 x 32 prefill "
          "(4608 rows), 32 x 16 kv8_decode_attention, 4 x 26 "
          "fused_vit_mlp; w4_matmul, which no path launches: one call at "
          "the decode and one at the prefill shape); launches: each path's "
          "run; request walls bf16 "
          f"{[round(w * 1e3, 1) for w in walls]} ms, mixed "
          f"{[round(w * 1e3, 1) for w in mixed_walls]} ms, mixed peak "
          f"{[round(p, 2) for p in peaks]} GiB; batches (wall ms, ms per "
          f"image, peak GiB) {bw}; device busy of a B = 4 kv8 batch "
          f"{'not measured' if share is None else f'{100 * share:.1f} %'}; "
          f"training (prefix_flash ms summed over one stage-1 step: 2 x 32 "
          f"fwd, 32 dq, 32 dkv; launches over 3 steps): stage-1 step "
          f"{stage1['wall_ms']:.1f} ms, {stage1['tokens_per_s']:.0f} data "
          f"tokens/s, peak {stage1['peak_gib']:.2f} GiB, device busy "
          f"{busy1}, #10 device time {attn1}; the training CLI at 8B stage 1 "
          f"({T1_STEPS} steps, launches {cli_counts}): median step "
          f"{t1['median_ms']:.1f} ms, {t1['tokens_per_s']:.0f} data "
          f"tokens/s, peak {t1['peak_gib']:.2f} GiB, busy "
          f"{busy_cli}; 457m every part tunable: save staged {t2['staged']:.2f} s + "
          f"commit {t2['commit']:.2f} s, restore {t2['restore']:.2f} s, peak "
          f"{t2['c_peak']:.2f} GiB; remat ladder (loss, peak GiB, step ms) "
          f"{ladder_s}; "
          f"stage-2 (4 LLaDA layers) peak "
          f"{stage2_peak:.2f} GiB; checkpoint path (8B written, loaded, "
          f"mixed, one request twice in text): write {ckpt['write_s']:.2f} "
          f"s, load {ckpt['load_s']:.2f} s, layout {ckpt['layout_s']:.2f} s, "
          f"requests {ckpt['first_request_s'] * 1e3:.1f} / "
          f"{ckpt['warm_request_s'] * 1e3:.1f} ms, peak device "
          f"{ckpt['peak_device_gib']:.2f} GiB; LaViDa-Dream (Dream-7B, "
          f"P={dream['P']}, G=32, 16 steps): bf16 request "
          f"{dream['bf16_wall'] * 1e3:.1f} ms (peak {dream['bf16_peak']:.2f} "
          f"GiB), mixed requests "
          f"{[round(w * 1e3, 1) for w in dream['walls']]} ms (peak "
          f"{[round(p, 2) for p in dream['peaks']]} GiB), launches on the "
          f"Dream path (bf16 request + three mixed) {dream_counts}; bench "
          f"--kv4 at B = 1 (mixed fused, int4 KV cache): wall "
          f"{kv4_wall * 1e3:.1f} ms, peak {kv4_peak:.2f} GiB; worker (8B "
          f"checkpoint, --mixed --kv4 --decode-batch 4) walls "
          f"{ {k: round(w * 1e3, 1) for k, w in server_walls.items()} } ms, "
          f"peak {server_peak:.2f} GiB, device busy of a B = 4 batch "
          f"{'not measured' if server_share is None else f'{100 * server_share:.1f} %'}; "
          f"no cache (one request, wall ms / peak GiB): bf16 "
          f"{br16['nocache'][1] * 1e3:.1f} / {br16['nocache'][2]:.2f}, int4 "
          f"{br4['nocache'][1] * 1e3:.1f} / {br4['nocache'][2]:.2f}, its "
          f"device busy {nc_busy}; "
          f"verbose bf16 {br16['verbose'][1] * 1e3:.1f} / "
          f"{br16['verbose'][2]:.2f}; dLLM (int4 unfused): --dllm 64 gen 32 "
          f"{br4['dllm32'][1] * 1e3:.1f} / {br4['dllm32'][2]:.2f}, gen 256 "
          f"steps 32 --dllm 64 {br4['dllm256'][1] * 1e3:.1f} / "
          f"{br4['dllm256'][2]:.2f} vs without --dllm "
          f"{br4['cached256'][1] * 1e3:.1f} / {br4['cached256'][2]:.2f}; "
          f"eval CLI (8B checkpoint, mixed, {len(EVAL_TASKS)} tasks x "
          f"{EVAL_LIMIT} documents) {ev['wall']:.2f} s (set-up "
          f"{ev['setup']:.2f} s), peak "
          f"{ev['peak']:.2f} GiB, per document {ev['per_doc']} s, video "
          f"prefix {ev['video_prefix']}; "
          f"FIM (8B checkpoint, weight-only int8, G 256) {fim_wall:.2f} s "
          f"with the load / {fim_peak:.2f}; log-likelihood (mixed, MMMU "
          f"geometry) weight-only {loglik[False][1] * 1e3:.1f} / "
          f"{loglik[False][2]:.2f}, act_int8 {loglik[True][1] * 1e3:.1f} / "
          f"{loglik[True][2]:.2f}; "
          f"SHIRG (one request each, wall ms / peak GiB): bf16 base "
          f"{shirg16['base'][1] * 1e3:.1f} / {shirg16['base'][2]:.2f}, bf16 "
          f"full + merge {shirg16['full + merge'][1] * 1e3:.1f} / "
          f"{shirg16['full + merge'][2]:.2f}, mixed "
          f"{shirg_mx['plain tower'][1] * 1e3:.1f} / "
          f"{shirg_mx['plain tower'][2]:.2f}, mixed --fused-vit "
          f"{shirg_mx['--fused-vit'][1] * 1e3:.1f} / "
          f"{shirg_mx['--fused-vit'][2]:.2f}; SHIRG-LoRA harness (8B f32, "
          f"B = 2) step walls {[round(w, 3) for w in shirg_lora['walls']]} "
          f"s, peak {shirg_lora['peak'] / 1e9:.2f} GB (reckoned "
          f"{shirg_lora['plan'] / 1e9:.2f} GB); "
          f"Dream-7B stage-1 step (B = {dream_train['B']}, T = "
          f"{dream_train['T']}) {dream_train['wall_ms']:.1f} ms, peak "
          f"{dream_train['peak_gib']:.2f} GiB; DPO at 8B (LoRA rank 64) step "
          f"walls {[round(w * 1e3, 1) for w in dpo['walls']]} ms, peak "
          f"{dpo['peak'] / 1e9:.2f} GB (reckoned {dpo['reckoned'] / 1e9:.2f}"
          f" GB); one-rank LaViDa.shard request walls unsharded / sharded "
          f"{[[round(w * 1e3, 1) for w in ws] for ws in shard['walls']]} "
          f"ms, {shard['host']['calls']} sharded weight reads a request at "
          f"{shard['host']['us_dtensor']:.2f} us (plain "
          f"{shard['host']['us_plain']:.2f}), 457m step "
          f"(loss, grad_norm) {shard['train']} (bit-equal "
          f"{shard['equal']}); "
          f"projector kinds on the bf16 8B (wall ms / peak GiB) "
          f"{ {k: (round(v['wall'] * 1e3, 1), round(v['peak'], 2)) for k, v in proj_kinds.items()} }; "
          f"towers (ms per image, peak GiB, weight GB) "
          f"{ {k: (round(v['ms_per_image'], 3), round(v['peak_gib'], 2), round(v['weight_gb'], 3)) for k, v in towers.items() if 'ms_per_image' in v} }, "
          f"resamplers (ms) { {k: round(towers[k]['wall_ms'], 3) for k in ('qformer', 'perceiver')} }, "
          f"tower phase {t_towers:.1f} s; "
          f"AR (request wall ms / peak GiB / phase s): bench --ar Vicuna-7B "
          f"int4 {ar_vicuna['wall'] * 1e3:.1f} / {ar_vicuna['peak']:.2f} / "
          f"{ar_vicuna['phase_s']:.1f}, Llama-3-8B bf16 "
          f"{ar_llama['wall'] * 1e3:.1f} / {ar_llama['peak']:.2f} / "
          f"{ar_llama['phase_s']:.1f}, Mixtral-8x7B {MIXTRAL_LAYERS} layers "
          f"{ar_mixtral['wall'] * 1e3:.1f} / {ar_mixtral['peak']:.2f} / "
          f"{ar_mixtral['phase_s']:.1f}; int8 tower {int8_tower[2]['tower_wall'] * 1e3:.1f} "
          f"ms (features within {int8_tower[2]['rel']:.3e} of bf16), its "
          f"mixed request {int8_tower[2]['request_wall'] * 1e3:.1f} ms / "
          f"{int8_tower[2]['request_peak']:.2f} GiB, phase "
          f"{int8_tower[2]['phase_s']:.1f} s; "
          f"whole script {time.perf_counter() - t_start:.1f} s on {card}")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
