#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Each phase prints one line, and any failure
raises (exit code 1):

1. device   -- a CUDA card is required; prints its name and power limit.
2. build    -- compiles ``medical_image_analysis_tpu_torch/csrc/mamba_fused.cu``,
               ``csrc/scan_n1.cu``, ``csrc/vit_block.cu``,
               ``csrc/swin_block.cu``, ``csrc/selective_scan.cu`` and
               ``csrc/attention.cu`` with nvcc for sm_90a into
               ``build/kernels/``, one nvcc per source, all at once.
3. kernels  -- both fused-Mamba forward wrappers (``xdbl_fwd``, and
               ``scan_fwd``: a chunked scan, three kernels, one launch count
               a call) against their plain PyTorch versions on the card, at
               the ARM-B layer shapes of the ``r2gengpt_mimic`` preset (K=4,
               L=197, D=768, N=16, R=48), batch 1 and 6, fp32 and bf16
               sources; the device time of each beside its plain version's,
               and the chunk ``scan_fwd`` took.
   kernels_fwd_vssm -- ``scan_fwd`` at vssm_tiny's four stage shapes
               (K=4, no conv, N=16; ``vssm_classify``'s SS2D blocks),
               held against ``scan_plain`` at B=8 and timed alone at B=128
               beside its bound, with its chunk and each kernel's grid
               blocks and resident blocks an SM; before it
               (``kernels_xdbl_vssm``) ``xdbl_fwd`` held against
               ``xdbl_plain`` at B=8 and B=128 and timed at B=128, with its
               tile, grid blocks and resident blocks an SM.
   kernels_bwd -- the backward (``scan_bwd``: three kernels, chunk
               summaries, carries, gradients; one launch count a call)
               against ``scan_bwd_plain`` at the same shapes: the max error
               of each output, the device times, and each kernel's grid
               blocks, resident blocks an SM and shared memory a block;
               then at vssm_tiny's four stage shapes (K=4, no conv, N=16;
               ``vssm_classify``'s SS2D blocks), held against the plain
               version at B=8 and timed alone at B=128.
4. serve    -- the preset at full width (ARM-B 768x12 + qwen1_5_1_8b with
               Qwen1.5's vocabulary of 151,936; random weights from a seed)
               behind ``cli.demo.make_server``: synthetic 224x224 PNGs are
               POSTed, beam 3, 120 new tokens. Each reply is checked, and
               each kernel must have launched once per ARM layer per request.
5. tower    -- ``encode_img`` of one image through the kernels and through
               the plain versions; the relative gap is held to a bound.
6. train    -- the preset at full width through ``cli.train.main``
               in-process: frozen LLM with LoRA r16 on q/v, trainable
               tower, accumulation 2, remat, batch 6 x 2 views x 224^2, on
               the synthetic dataset (32 samples: 5 steps), then one
               validation (beam 3, 120 tokens). Every loss is finite, every
               trainable tensor moved and no frozen one did, the delta file
               exists, and each kernel launched as often as the design says
               (printed). Step and validation seconds, peak device memory.
7. train_grads -- one micro-batch at full width: the tower's and the
               projector's gradients through the kernels against those
               through the plain versions, from one cotangent at the
               projector's output, within a relative bound.
7a. Real checkpoint files (checkpoint loading, tokenizer, preprocessing):
   hf_ckpt  -- an HF directory of Qwen/Qwen1.5-1.8B's public shape
               (``QWEN_1_8B``: Qwen2, 2048 x 24, 16 heads and KV heads,
               5504, vocabulary 151,936, untied, q/k/v biases) written in a
               temporary directory by ``write_hf_checkpoint``: bf16 tensors
               random from ``SEED``, two safetensors shards with
               ``model.safetensors.index.json``, ``config.json`` and the
               report tokenizer (``tests/data/report_bpe_tokenizer.json``);
               about 3.7 GB. The free disk is read first and the phase
               refuses to write where it is short. Bytes, seconds, free GiB.
   serve_hf -- ``r2gengpt_mimic`` with ``model.llm_weights_dir`` and
               ``data.tokenizer_dir`` set to it, through
               ``cli.demo.build_pipeline`` and ``make_server``: every LLM
               tensor on the card equal to the file's, 3 POSTs (beam 3, 120
               tokens), each reply equal to its ids decoded by the
               checkpoint's ``tokenizer.json`` read anew (which also
               round-trips the synthetic reports), the ARM kernels once per
               layer per request. Load and request
               seconds, the LLM's tensor bytes, the head's transient bytes,
               peak memory.
   serve_hf_int8 -- the same with ``model.llm_int8: true``: ``kernel_q``
               and ``scale`` of q/k/v/o and gate/up/down at layers 0, 11
               and 23 and of ``lm_head`` equal ``_quantize`` of the file's
               tensor on the host; the LLM's tensor bytes at least 1.4 GiB
               below ``serve_hf``'s; with ``serve_hf``'s tower and
               projector copied in (so both feed the LLM the same image
               tokens), the first decode step's largest logit gap to
               ``serve_hf``'s on the same request (printed, not bounded).
   train_hf -- ``fit_mrg`` of the preset on the checkpoint and its
               tokenizer through ``cli.train.main``: LoRA r16 on the frozen
               LLM, 3 steps of 10 studies, one validation at the preset's
               decode length; the checks of ``train``, every frozen LLM
               tensor still equal to the file's, launches reckoned.
   prep_dev -- ``device_preprocess`` of 16 uint8 images of 1024^2 (the
               first a JPEG-Lossless DICOM through ``decode_scaled``) and
               of 16 of 128^2 to 224^2 on the card against the CPU, fp32,
               within ``PREP_ATOL``; its time in bf16 beside its bytes
               bound.
7b. MambaXray-VL's pipeline, stage 1 -> stage 2 -> the SFT of 6:
   kernels_ar -- the fused layer's three kernels (``xdbl_fwd``,
               ``scan_fwd``, ``scan_bwd``) against their plain versions at
               AR pretraining's shape (K=1, B=12, L=128: 8 clusters of 16
               tokens at 192^2) and CLIP alignment's (K=4, B=32, L=197),
               D=768, N=16, R=48, fp32: max errors within XDBL_RTOL,
               Y_RTOL and BWD_RTOL; ms, plain ms and bound of each, x_dbl's
               tile, and each kernel's grid blocks and blocks an SM.
   train_ar -- the ``ar_pretrain`` preset (``VisionMambaAR`` at its class
               defaults, ARM-B's widths with one scan direction, 4 cross-
               attention decoder blocks of 512, B=12, 192^2, fp32) through
               ``cli.train.main`` on the synthetic data for 2 epochs (4
               steps): finite losses, every parameter moved, each fused
               kernel launched 12 layers x 4 steps times (no remat, no
               validation); step and set-up seconds, peak memory.
   train_ar_grads -- one batch of 12 images: the loss and every gradient
               through the kernels against ``scan_backend="plain"``.
   train_clip -- the ``clip_align`` preset (ARM-B + the scratch text tower
               of depth 2, B=32, max_len 128) with ``model.vision_init`` set
               to ``train_ar``'s train state: the grafted ``visual_encoder``
               checked bit for bit against the AR encoder (mixers tiled to
               four directions) before the first step, then 3 steps, each
               fused kernel launched 12 x 3 times.
   stage_chain -- ``r2gengpt_mimic`` at full width with
               ``model.vision_init`` set to ``train_clip``'s state, at 12
               studies a step: the graft checked the same way, then 2
               steps, launches reckoned as ``train``'s (no validation).
8. kernels_n1 -- the d_state=1 scan's forward (``scan_n1_fwd``: one pass
               of its scan kernel, or piece summaries, carries and the
               scan in chunks, as ``fwd_chunk`` picks; one launch count a
               call) against ``scan_n1_fwd_plain`` at the four stage
               shapes of vssm1_base at every batch the main path gives it
               (B=12 tower images, 36 context images, 4 images of
               validation's last batch; fp32), stage 2 in bf16 and stage 0
               at B=1; max error, device times and the bound of every
               case, the chunk, and each kernel's grid blocks, resident
               blocks an SM and shared memory a block.
   kernels_n1_bwd -- its backward (three kernels: piece summaries,
               carries, gradients; one launch count a call) against
               ``scan_n1_bwd_plain`` at the four stages at the training
               batch (B=12), stage 2 in bf16 and stage 0 at B=1, every
               output; each case's device times and bound, and each
               kernel's grid blocks, resident blocks an SM and shared
               memory a block.
9. train_csr -- the ``r2gencsr_iu`` preset with ``model.vision=vssm``,
               ``vision_size=base`` and the vssm1 ``vision_kwargs``
               (vssm1_base + qwen1_5_0_5b at full width, 3 + 3 context
               images per study, LoRA r16, trainable tower) through
               ``cli.train.main``: 5 steps and one validation (beam 3, 100
               tokens). The same checks as ``train``; each scan kernel
               launched as often as the design says.
10. train_csr_grads -- one batch: the vssm1 tower's and the projector's
               gradients through the kernels against the plain versions,
               from one cotangent at ``encode_img``'s outputs, and the
               context residuals (36 context images) likewise.
11. kernels_vit -- the ViT block's two forward kernels (``vit_attn_fwd``,
               ``vit_mlp_fwd``) against their plain versions at the shapes
               of ``mae_hd_1280``'s main path, B=16 as it trains: the
               encoder (L=1401, d=768, 12 heads) and the decoder (L=6401,
               d=512, 16 heads) in fp32; the 224^2 MAE's encoder (L=50) and
               decoder (L=197), and bench.py's encode in bf16 (B=64, L=145).
               The plain versions walk the heads one at a time, so the
               decoder's holds one head's (16, 6401, 6401) fp32 scores,
               2.6 GB, a few at a time. Each line: max error against its
               bound, the kernel's ms, the plain version's, and
               ``library_ms``, the sub-layer composed of ``F.layer_norm``,
               ``F.linear`` and ``F.scaled_dot_product_attention`` (a
               yardstick the port never calls).
    kernels_vit_bwd -- the two backward kernels against the plain
               backwards (``attn_block_bwd_plain``, ``mlp_block_bwd_plain``,
               per head as above; the CPU tests hold them to ``jax.vjp``
               of the TPU kernels) at the same fp32 shapes, every output;
               ms of the kernel, of the plain backward, and of the library
               composition's forward + backward. All four kernels' rows at
               the encoder and the decoder go into the kernels line (with
               a ``case`` key). ``vit_attn_bwd``'s device time at both is
               split by kernel (``kernels_vit_bwd_parts``: the tensor-core
               GEMM, the forward core's recompute, the dK/dV and dQ passes,
               the LayerNorm kernels and sums, the rest) from
               ``torch.profiler``.
    kernels_vit_parts -- ``vit_attn_fwd``, ``vit_mlp_fwd`` and
               ``vit_mlp_bwd`` split the same way at the encoder and the
               decoder, and both forwards at bench.py's bf16 encode, with
               the tensor-core GEMM's TFLOP/s (its products over its time);
               the phase fails if any launches a kernel named
               ``gemm_kernel`` or ``attn_fwd_kernel`` (the CUDA-core GEMM
               and attention core, both deleted): all four ViT kernels run
               every product on the tensor cores (fp32 in 3xTF32, bf16 as
               it is). Each split must add up to within 20% of the call's
               time by CUDA events (a profile that lost kernels is taken
               again, at most three times, and printed as
               ``profile_lost_kernels``).
    kernels_swin_parts -- ``swin_attn_fwd`` at swin_large's stage 2
               (B=64, shifted, fp32; the kernels line's row) split the same
               way: the tensor-core GEMM with its TFLOP/s, the window core,
               the LayerNorm kernels, the rest; it fails as
               ``kernels_vit_parts`` does.
12. train_mae -- the ``mae_hd_1280`` preset (MAE ViT-B/16 + 512x8 decoder,
               1280^2 images, region masking: encoder L=1401, decoder
               L=6401, batch 16, fp32) through ``cli.train.main`` on the
               synthetic dataset for 3 epochs (6 steps), no train state
               written: every loss finite, every parameter moved, each of
               the four ViT kernels launched 20 sub-layers x 6 steps times;
               step and set-up seconds, peak device memory.
13. train_mae_grads -- one batch of the preset (16 images) with the first
               step's masking noise: the loss and every parameter's
               gradient through the kernels against the plain versions
               (``set_fused(model, False)``), within a relative bound.
14. kernels_swin -- the Swin window-attention sub-layer (``swin_attn_fwd``)
               against ``swin_attn_block_plain`` at the four stage shapes of
               swin_large at B=64 (shifted and unshifted where the stage has
               both) and of swin_base at B=12, fp32, and swin_large's stage 0
               in bf16: max error against its bound, ms of the kernel, the
               plain version and ``library_ms`` (``F.layer_norm``,
               ``F.linear``, ``F.scaled_dot_product_attention`` with the
               bias and mask as ``attn_mask``), the bound and TFLOP/s.
15. train_cls -- the ``swinchex`` preset (swin_large, 14 two-way heads,
               B=64, 224^2, mixup 0.8 / cutmix 1.0, fp32) through
               ``cli.train.main`` on ``synthetic_learnable`` data (256 train
               samples: 4 steps; one validation of the 64 val samples):
               finite losses, every parameter moved, the Swin kernel
               launched 24 times (one per block) per validation batch and
               never in a training step; acc_mean, auc_mean, step and
               validation seconds, peak device memory.
16. tower_cls -- one validation batch of 64 through the trained SwinCheX:
               logits through the kernel against ``set_fused(model,
               False)`` within a relative bound, and a forward + backward
               with a gradient that launches it no time.
17. train_cls_vssm, train_cls_dp -- ``vssm_classify`` (vssm_tiny, B=128,
               EMA; the fused-Mamba kernels, d_state 16 without a conv) and
               ``dp_finetune`` (ViT-B/16, B=64, EMA; the four ViT kernels) at
               full width on the same data: 2 steps and one validation each,
               launches reckoned and printed, step seconds.
18. train_csr_swin -- the ``r2gencsr_iu`` preset as it stands (swin_base +
               qwen1_5_0_5b, 3 + 3 context images, LoRA r16, trainable
               tower) on the synthetic dataset: 5 steps and one validation
               (beam 3, 100 tokens), the checks of ``train_csr``; the Swin
               kernel launches for the context images of each step and for
               both towers of each validation batch, and the context
               residuals through the kernel match the plain versions'.
19. kernels_ss, kernels_ss_bwd -- the general selective scan's forward and
               backward kernels (``ops/selective_scan_pallas.py``) against
               their plain versions, every output, at ARM-B's layer shapes
               (K=4, L=197, D=768, N=16; B=1 and 6 forward, B=6 backward;
               fp32 and bf16) and vssm_tiny's four stage shapes at B=128
               (fp32, stage 0 also bf16): max errors, ms of the kernel and
               of the plain version, the bound; the kernel's resident
               blocks an SM and shared memory a block, for the forward
               also its grid and waves, for the backward failing under
               SS_BWD_MIN_BLOCKS (5).
20. train_cls_vssm_pallas -- ``vssm_classify`` with ``--set
               model.vision_kwargs={scan_backend: pallas}`` (vssm_tiny at
               full width, 11 SS2D blocks, d_state 16, B=128, EMA,
               mixup/cutmix, fp32) through ``cli.train.main`` on the data of
               ``train_cls_vssm``: 2 steps and one validation, the scan
               kernels' launches reckoned, the fused layer's 0; step and
               validation seconds and peak memory beside ``train_cls_vssm``'s.
21. tower_arm_pallas -- ``r2gengpt_mimic``'s ARM-B tower on the same
               ``--set``, remat, one micro-batch of 6 images: the tower's and
               projector's gradients through the kernels against
               ``pallas_plain`` within TOWER_RTOL; the gap to the fused
               layer printed.
22. kernels_attn -- ``fused_attention``'s kernel against its plain version
               at ViT-B's widths (B=64, L=197, 12 heads of 64), fp32 and
               bf16, with and without a causal mask; ``library_ms`` is
               ``F.scaled_dot_product_attention``; then the kernel's wrapper
               at every head width (16, 32, 64, 128) and at L = 50 and
               1,401 beside 197, fp32 and bf16, with and without the mask,
               checked against the plain version; ViT-B at 384^2 (L=577)
               takes the einsum route and launches nothing.
23. attn     -- ``models/vit.py:Attention(768, 12)`` on (64, 197, 768):
               the kernel against ``set_fused(model, False)``, then 0
               launches under a gradient.
24. kernels_am -- the fused layer's three kernels against their plain
               versions at AM-MRG's ARM-L shapes (K=4, L=197, D=1024,
               N=16, dt rank 64, so C=96): the training step's 12 images
               and one image, fp32, as ``kernels_ar`` prints them (its
               12-image rows join the kernels line with a ``case`` key).
25. train_am_mrg -- the ``am_mrg_mimic`` preset at full width (ARM-L,
               ``qformer_proj`` to 1408, the 12-layer Q-Former of 14
               queries, two Hopfield memories, the frozen 1.8B LLM with
               LoRA r16, remat, 6 studies x 2 views) through
               ``cli.train.main``: the memory banks built on the card
               (GradCAM over a small SwinCheX, 14 labels x 2 blocks = 28
               Swin launches), 5 steps and one validation (beam 3, 40
               tokens: ``MRG_GEN``); the checks of ``train``, the banks'
               shapes and build seconds, launches reckoned.
26. train_am_mrg_grads -- one batch at full width: every trainable
               tensor before the LLM through the kernels, from one
               cotangent at ``encode_img``'s output, held against a
               float64 pass of the plain path (the same modules in fp64):
               within TOWER_RTOL of each tensor's largest, or no farther
               from fp64 than twice the fp32 plain path is (a nearly
               cancelling gradient, where fp32 itself misses); the worst
               tensor's two gaps and its kernel-to-plain gap printed.
27. train_r2genkg -- the ``r2genkg_mimic`` preset at full width (Swin-B,
               the 2-layer Q-Former, the disease-bank lookup, 5 R-GCNs,
               the fusion, the cross blocks, the frozen 1.8B LLM with LoRA
               r16) likewise: the graph built on the card, 5 steps (no
               Swin launch: the tower trains) and one validation (24
               launches a batch).
   ``kernels_swin`` (14) also holds the bank chain's SwinCheX stages:
               heads of 8 and of 16 over windows of 16 tokens.
28. kernels_emrrg -- the fused layer's three kernels against their plain
               versions at EMRRG's training shape (ARM-B: K=4, L=197, D=768,
               N=16, R=48; 12 images, fp32), as ``kernels_ar`` prints them
               (its rows join the kernels line with a ``case`` key).
29. train_emrrg -- the ``emrrg_iu`` preset at full width (ARM-B, the
               hybrid gated cross-attention decoder on ``qwen1_5_0_5b``:
               frozen but for its six hybrid layers, whose tensors train as
               fp32 masters; no LoRA, no remat; 6 studies x 2 views, the
               LLM at Qwen1.5's vocabulary) through ``cli.train.main``: 5
               steps and one validation at the preset's beam 3, 60 to 100
               tokens; the checks of ``train``, the masters' and the frozen
               kernels' dtypes, launches reckoned.
30. train_emrrg_grads -- one batch: every trainable tensor's gradient
               (the tower, ``proj``, ``fast_proj``, the hybrid layers)
               through the kernels against ``scan_backend="plain"``, the
               LLM computing in fp32 for the check.
31. kernels_r2gen -- the four ViT kernels against their plain versions at
               R2Gen's training shape (ViT-B/16: B=32, L=197, 12 heads,
               fp32), every output, with the bound and the library
               compositions' times (rows in the kernels line).
32. train_r2gen -- the ``r2gen_iu`` preset at full width (ViT-B/16 at
               224^2 and R2Gen of d_model 512, 3 layers, 8 heads, 3 memory
               slots, 16 studies x 2 views) through ``cli.train.main``: 2
               steps and one validation at beam 3, 60 tokens (each step
               re-decodes the prefix); launches reckoned. Then
               ``train_r2gen_grads``: one batch's tokens, loss and ViT
               gradients (one cotangent at the tokens) through the ViT
               kernels against ``set_fused(model, False)``.
33. kernels_lm -- the fused layer's three kernels against their plain
               versions at the Mamba LM's training shape (K=1, B=16, L=128,
               D=1536, N=16, R=48, taps 4, fp32), as ``kernels_ar`` prints
               them (rows in the kernels line with a ``case`` key).
34. train_lm_sft -- the ``mamba_lm_sft`` preset at full width (d_model
               768, 12 blocks) through ``cli.train.main``: 2 epochs (4
               steps) and one validation; losses, ``val_loss`` and
               ``val_ppl`` finite, every tensor moved, launches reckoned
               (12 of each kernel a step, 12 forwards a val batch). Then
               ``train_lm_sft_grads`` (one batch: every gradient through
               the kernels against ``scan_backend="plain"``) and
               ``lm_decode`` (32 positions of a val batch token by token
               through ``init_states``/``step`` against the full forward
               through the kernels; seconds a token).
34a. The weight-space MambaPEFT family at d_state 17 (``additional_scan``'s
               default width on 16, an exact instantiation of the scan
               kernels):
   kernels_peft17 -- the fused layer's three kernels at the LM's training
               shape with N=17 (K=1, B=16, L=128, D=1536, R=48, so C=82),
               as ``kernels_lm`` (rows ``_peft17`` in the kernels line).
   peft_lm  -- ``train_lm_sft``'s trained LM as the base, with
               ``additional_scan`` (16 -> 17), ``lora_X``, ``lora_dt`` and
               ``learnable_D_v2`` merged (``peft.mamba_peft``) into a model
               built at d_state 17: 3 AdamW steps of the adapter tree alone
               on the preset's synthetic batches (16 x 128), each through
               the kernels (12 launches of each a step); the first step's
               adapter gradients against ``scan_backend="plain"``; losses
               finite, every adapter moved, the base unchanged.
   peft_arm -- ``r2gengpt_mimic``'s ARM-B tower (12 layers, K=4) with
               ``additional_scan``, ``lora_patch_embed`` and
               ``learnable_cls_token_v2`` merged, at the training step's
               12 images: the tokens and every adapter's gradient (one
               random cotangent) through the kernels against the plain
               path.
35. train_mac_rrg -- the ``mac_rrg_mimic`` preset at full width (Swin-B,
               the frozen 1.8B LLM at Qwen1.5's vocabulary with LoRA r16,
               the agents' rows 768 wide, 32 chunks and 32 entities)
               through ``cli.train.main``: 5 steps and one validation at
               ``MRG_GEN``; the checks of ``train``, the agent context's
               sizes and seconds, 24 Swin launches a val batch, none in a
               step. Then ``tower_mac_rrg`` (``encode_img`` with the agents'
               arrays through the Swin kernel against the unfused route;
               the agents' seconds for a batch) and ``refine_mac_rrg``
               (``cli.mac_refine.main`` on the run's delta: every tensor as
               trained, 48 Swin launches; again at the tokenizer's
               vocabulary, where the refined round's agent arrays are not
               all zero).
36. ref_ckpt -- each layout of the reference's released checkpoints,
               written from ``SEED`` (``tests/ref_ckpt_files.py``): ARM-B
               (four directions; and a one-direction stage-1 file through
               ``replicate_dir_weights``), vssm1_base, HF ``SwinModel``
               Swin-B, timm ViT-B/16 (inside MAE's ``{"model", "args",
               ...}`` wrapper), CheXbert (``module.``-prefixed, inside
               ``model_state_dict``), AM-MRG's BLIP-2 Q-Former (LAVIS
               names) and Hopfield memory, R2GenKG's cross block and
               R2Gen at 512 x 3; each read with ``weights_only``, mapped by
               ``ckpt/torch_import.py`` and loaded strictly onto the card,
               every tensor equal to the mapped file's; each tower at its
               preset's batch through its kernels against its plain
               version (``TOWER_RTOL``), each head once; bytes, write and
               load seconds.
37. chexbert -- the 48 synthetic reports labelled by that CheXbert on the
               card and on the CPU, one a call: labels equal, logit gap
               within ``CHEXBERT_ATOL``; seconds a report, and the P/R/F1
               of ``clinical_efficacy`` with the learned labeler.
38. resume_jax -- ``dp_finetune`` (ViT-B/16, B=64) for 2 steps; its state
               written in the JAX package's msgpack layout
               (``tests/jax_state_files.py``) and read back equal; the run
               resumed from the ``.pt`` and from the ``.msgpack`` through
               the CLI: every tensor, count and step equal after the load,
               the next epoch's losses equal.
   vision_init_jax (after ``stage_chain``) -- ``clip_align``'s state as a
               JAX ``.msgpack``: the same ARM overlay as from the ``.pt``,
               and ``r2gengpt_mimic``'s initialisation grafts every tensor
               that ``stage_chain`` grafted (``grafted=``).
39. throughput -- ``cli.train --throughput`` on swinchex (swin_large,
               B=64), vssm_classify (vssm_tiny, B=128), r2gencsr_iu on
               vssm1_base and r2gengpt_mimic (ARM-B): each JSON, and the
               tower's kernels launched.
40. debug_nans -- ``train``'s run again with ``train.debug_nans=true``
               (its validation's greedy decoding included): the same
               losses and scores, bit for bit; then with a
               NaN put into the ARM's final norm: ``FloatingPointError``
               naming ``vision.arm.norm_f``.
41. ss_widths (after ``kernels_ss_bwd``) -- the general scan's wrappers at
               d_state 2, 5, 12, 17, 32, 40 and 64 (built for 1, 4, 8, 16,
               32: padded up, or 32-state groups past 32) against the plain
               versions in fp32 and bf16, forward and backward; ptxas's
               registers and spills of the N = 32 kernels; both timed at
               vssm_tiny stage 0, B=128, N=32 (the kernels line's ``_n32``
               rows); the fused Mamba layer at N=40 and at 5 taps, forward
               and gradients, against its plain version.
42. hf_tp_load (after ``hf_ckpt``) -- ``load_llm_params(mesh=)`` of that
               checkpoint at model=2 in bf16 and int8: each rank's tensors
               equal its slices of the full load's; the bytes each read.
43. multi_gpu -- the preset at full width (ARM-B + the Qwen1.5-1.8B-shaped
               LLM in fp32, ``model.llm_kwargs.dtype``) through
               ``cli.train.main`` in 4 processes on a (data 2, model 2)
               grid, ZeRO on, accumulation 2, 2 steps, against one
               process's same steps: the losses and the post-step norm of
               the trained tensors within 1e-5 relative, every tensor
               within 1e-5 of its largest plus 5e-2 of lr. Per rank: the
               fused kernels' launches, step seconds (gloo on one card:
               the processes share the H100, not a multi-GPU speed), the
               bytes all-reduced and gathered a step.
44. multi_gpu_nccl1 -- the same steps through the sharded step over an
               NCCL group of world size 1: the one process's losses and
               tensors.
45. tp_serve -- ``cli.demo``'s pipeline (LLM in fp32, 40 new tokens,
               beam 3) on 2 processes at model=2: rank 0's tokens for 2
               images equal one process's.
46. sp_scan  -- ``selective_scan_sp`` over 2 and 4 processes (softplus on
               and off) against the CUDA selective-scan kernel on the whole
               sequence (B=2, L=2048, D=256, N=16).

Bounds: the largest of the bytes at the HBM rate, the matrix products at
the tensor-core rate of their operand type (fp32 in 3xTF32, 165 TFLOP/s;
bf16 989) and the other operations at the CUDA cores' 67 TFLOP/s.

Then one JSON line of the kernels, and the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

TF32 is off for matmuls and for cuDNN throughout, since the comparisons
are made in fp32.
"""

from __future__ import annotations

import argparse
import base64
import copy
import dataclasses
import gc
import io
import itertools
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

SEED = 0
VOCAB = 151936  # Qwen1.5's published vocabulary, used as a size only
REQUESTS = 3
TRAIN_SAMPLES = 32  # data.dataset=synthetic's train split
VAL_SAMPLES = 8  # and its val split
PRESET = (Path(__file__).resolve().parent / "medical_image_analysis_tpu_torch"
          / "configs" / "presets" / "r2gengpt_mimic.yaml")
CSR_PRESET = PRESET.parent / "r2gencsr_iu.yaml"
# vssm1_base through the JAX package's own entry point (vision=vssm, size
# base, and the d_state=1 family's kwargs)
VSSM1_OVERRIDES = (
    "model.vision=vssm", "model.vision_size=base",
    "model.vision_kwargs={d_state: 1, disable_z: true, conv_bias: false, "
    "patch_embed_version: v2}",
)
REPLACES = {
    "mamba_xdbl": "medical_image_analysis_tpu/ops/mamba_fused.py:111",
    "mamba_scan": "medical_image_analysis_tpu/ops/mamba_fused.py:145",
    "mamba_scan_bwd": "medical_image_analysis_tpu/ops/mamba_fused.py:197",
    "scan_n1_fwd": "medical_image_analysis_tpu/ops/scan_n1.py:89",
    "scan_n1_bwd": "medical_image_analysis_tpu/ops/scan_n1.py:150",
    "vit_attn_fwd": "medical_image_analysis_tpu/ops/vit_block.py:81",
    "vit_mlp_fwd": "medical_image_analysis_tpu/ops/vit_block.py:126",
    "vit_attn_bwd": "medical_image_analysis_tpu/ops/vit_block.py:298",
    "vit_mlp_bwd": "medical_image_analysis_tpu/ops/vit_block.py:235",
    "swin_attn_fwd": "medical_image_analysis_tpu/ops/swin_block.py:43",
    "selective_scan_fwd":
        "medical_image_analysis_tpu/ops/selective_scan_pallas.py:108",
    "selective_scan_bwd":
        "medical_image_analysis_tpu/ops/selective_scan_pallas.py:164",
    "fused_attention": "medical_image_analysis_tpu/ops/attention.py:28",
}
# vssm1_base's stages at 224^2: (H = W, model dim); d_inner = 2 dim, R = dim/16
N1_STAGES = ((56, 128), (28, 256), (14, 512), (7, 1024))
N1_BATCH = 12  # 6 studies x 2 views, the tower images of a training step
# The forward's other batches on the main path: the context tower's 6
# studies x (3 + 3) images, and validation's last batch (8 val samples in
# batches of 6), whose 2 studies give 4 images and 12 context images.
N1_FWD_BATCHES = (N1_BATCH, 36, 4)
N1_OUTPUTS = ("du", "dxdbl", "dA", "dD", "ddt_bias", "ddt_proj_w")
BWD_OUTPUTS = ("du", "u", "dsilu", "dxdbl", "dA", "dD", "ddt_bias",
               "ddt_proj_w")

# Tolerances, relative to max(1, max |plain|):
# x_dbl is fp32 from identical inputs; only the order of the sum over D
# differs.
XDBL_RTOL = 1e-4
# y: fp32 as x_dbl. From bf16 sources both sides compute in fp32 and
# round to bf16 (the d_state=1 scan: each direction, then the pair's sum),
# where they may land one bf16 step apart: 2^-7 of the largest value.
Y_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-7}
# The backward's outputs are fp32 on both sides from the same inputs, for
# either source dtype; the sums over D and over L run in another order.
BWD_RTOL = 1e-4
# The tower through 12 layers, fp32: reordered sums, compounded per layer
# and rescaled by the final LayerNorm and projector. The same bound holds
# the tower's and projector's gradients, relative to each tensor's largest.
TOWER_RTOL = 1e-3
MAE_PRESET = PRESET.parent / "mae_hd_1280.yaml"
MAE_EPOCHS = 3  # 2 steps an epoch of the synthetic train split at batch 16
# (B, L, d, heads, dtype): the ViT sub-layers on the main path of
# mae_hd_1280 (encoder 1 + 1100 + 300 tokens, decoder 1 + 6400), the 224^2
# MAE's (1 + 49, 1 + 196) and bench.py's encode at 384^2 in bf16.
VIT_CASES = (
    (16, 1401, 768, 12, torch.float32),
    (16, 6401, 512, 16, torch.float32),
    (16, 50, 768, 12, torch.float32),
    (16, 197, 512, 16, torch.float32),
    (64, 145, 768, 12, torch.bfloat16),
)
# fp32: reordered sums, 1e-4 of max(1, max |plain|). bf16: both sides round
# at the TPU kernel's points, but the kernel rounds exp(s - m) before the
# softmax's division and the plain version after it, so two bf16 steps.
VIT_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-6}
# The kernels line's rows of the four ViT kernels, (B, L): (suffix of the
# measured row's key, the row's "case"): the mae_hd_1280 encoder and its
# decoder (16 heads of 32).
VIT_ROWS = {(16, 1401): ("", "mae_hd_1280 encoder B=16 L=1401"),
            (16, 6401): ("_decoder", "mae_hd_1280 decoder B=16 L=6401")}
VIT_GRADS = {"attn": ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dg", "db"),
             "mlp": ("dx", "dw1", "db1", "dw2", "db2", "dg", "db")}
# Classification on synthetic_learnable data: its val split has 64 samples;
# the train split is sized so that each preset takes the steps named above.
CLS_PRESET = PRESET.parent / "swinchex.yaml"
LEARNABLE_VAL = 64
CLS_TRAIN = {"swinchex.yaml": 256, "vssm_classify.yaml": 256,
             "dp_finetune.yaml": 128}
# (name, embed dim, heads per stage, images): the Swin towers on this
# slice's paths at 224^2 (patch 4, window 7: a 56^2 map at stage 0, 7^2 at
# stage 3): swinchex's swin_large at its batch of 64, and r2gencsr_iu's
# swin_base at the training step's 6 studies x 2 views.
SWIN_TOWERS = (("swin_large", 192, (6, 12, 24, 48), 64),
               ("swin_base", 128, (4, 8, 16, 32), 12))
# The kernel's fp32 result against the plain version's: reordered sums,
# 1e-4 of max(1, max |plain|); bf16 as the ViT kernels (VIT_RTOL).
SWIN_RTOL = VIT_RTOL
# The general selective scan on this slice's paths (scan_backend=pallas):
# ARM-B's layers (K=4 directions, L = 196 patches + cls, d_inner 768,
# d_state 16) at the serving batch (forward) and the training micro-batch
# of 3 samples x 2 views (forward and backward), and vssm_tiny's four
# stages at 224^2 (L = 56^2 .. 7^2, d_inner 192 .. 1536, d_state 16) at
# vssm_classify's batch of 128.
SS_ARM = (4, 197, 768, 16)  # K, L, d_inner, N
SS_ARM_BATCH = {"fwd": (1, 6), "bwd": (6,)}
SS_VSSM_STAGES = ((3136, 192), (784, 384), (196, 768), (49, 1536))
SS_VSSM_BATCH = 128
# The backward's resident blocks of 64 threads an SM at the least: more
# warps to hide the latency of its sequential walks.
SS_BWD_MIN_BLOCKS = 5
# The fused backward's check at vssm_tiny's stages against scan_bwd_plain,
# whose per-row state lists hold B*4*L*D*16 floats: B=8 fits them (1.2 GB at
# stage 0). The kernels' indexing depends on B only through the grid.
MAMBA_VSSM_CHECK_BATCH = 8
VSSM_PALLAS = "model.vision_kwargs={scan_backend: pallas}"
# The fused attention at dp_finetune's ViT-B widths (B=64, L=197, 12
# heads of 64), and ViT-B at 384^2 (L=577), where the JAX dispatch takes
# the einsum route (8 x 577^2 x 4 bytes > 8 MiB).
ATTN_VIT_B = (64, 197, 12, 64)
ATTN_EINSUM = (8, 577, 12, 64)
# Every head width and a ragged L beside 197 through the kernel's wrapper
# (``attention_fwd``; L = 1,401 is past the JAX dispatch's 8 MiB tile at
# any batch, so ``fused_attention`` would take the einsum route): (B, L,
# heads, hd). Checked against the plain version, not timed.
ATTN_CHECKS = ((64, 50, 12, 64), (4, 1401, 12, 64), (16, 197, 24, 32),
               (16, 197, 48, 16), (16, 197, 6, 128), (2, 1401, 16, 32),
               (8, 50, 4, 128))
# The kernel's fp32 result against the plain version's: reordered sums,
# 1e-4 of max(1, max |plain|); bf16 as the ViT kernels (VIT_RTOL): p is
# rounded before the product and the output after it.
ATTN_RTOL = VIT_RTOL
# The published H100 SXM peaks (NVIDIA's H100 datasheet) that bound_ms
# divides by: HBM bytes per second; matrix products on the tensor cores at
# the rate of their operand type (fp32 at fp32 accuracy in 3xTF32, a third
# of the 495 TFLOP/s TF32 rate; bf16 at 989); every other operation at the
# 67 TFLOP/s fp32 rate of the CUDA cores.
HBM_BYTES_S = 3.35e12
PRODUCT_OPS_S = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
OTHER_OPS_S = 67e12


def _phase(phase: str, /, **fields) -> None:
    """Print a phase's line. On the card it ends with the device memory
    still allocated (``alloc_gib``) and what a garbage collection leaves of
    it (``alloc_gc_gib``): tensors held by reference cycles of an earlier
    phase count toward a later phase's peak until collected, so each line
    collects them."""
    if torch.cuda.is_available():
        held = torch.cuda.memory_allocated()
        gc.collect()
        fields = dict(fields, alloc_gib=f"{held / 2**30:.3f}",
                      alloc_gc_gib=f"{torch.cuda.memory_allocated() / 2**30:.3f}")
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def device_ms(fn, iters: int) -> float:
    """Device milliseconds per call of ``fn``, from CUDA events.

    A spin kernel queued first keeps the card busy while the host queues
    the calls, so the events time the device's work and not the host's
    launch overhead (unless queueing takes longer than the spin).
    """
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(tensors, work, dtype=torch.float32) -> tuple[float, str, str]:
    """The least time (ms) the card could take for a call, the largest of
    three: its inputs read once and its outputs written once at the HBM
    rate; its matrix products at the tensor-core rate of ``dtype``; its
    other operations at the CUDA cores' fp32 rate. ``work`` is an
    operation count with no products (the scans) or a ``(products,
    other)`` pair (``ops/*.py:work``). Returns the time, "bytes" or
    "operations" (the ``kernels`` line's ``bound_by``), and which of the
    three it is ("bytes", "products" or "other")."""
    products, other = work if isinstance(work, tuple) else (0.0, work)
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    ms, on = max((nbytes / HBM_BYTES_S * 1e3, "bytes"),
                 (products / PRODUCT_OPS_S[dtype] * 1e3, "products"),
                 (other / OTHER_OPS_S * 1e3, "other"))
    return ms, "bytes" if on == "bytes" else "operations", on


# Operations of the scan kernels per (image, direction, row, channel),
# counted from the algorithm (a multiply-add is two, an exp or a softplus
# one each): the causal conv and SiLU 13, dt_proj 2R, softplus 4, the
# N-state update and readout 7N, the D skip 2; the backward recomputes the
# forward and runs the adjoint (2R + 10N). The d_state=1 scan: dt_proj 2R,
# softplus, decay, update, readout and skip 13; its backward as above.
def _mamba_ops(rank, n, use_conv=True):
    return (13 if use_conv else 0) + 2 * rank + 4 + 7 * n + 2


def _max_err(got, want):
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    return err, scale


def phase_device() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _phase("device", name=repr(torch.cuda.get_device_name(0)),
           count=torch.cuda.device_count(), torch=torch.__version__,
           cuda=torch.version.cuda)


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    modules = _kernel_modules()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(modules)) as pool:  # one nvcc each
        logs = list(pool.map(lambda m: m.build()[1], modules))
    secs = time.perf_counter() - t0
    for log in logs:  # ptxas: registers, shared memory, spills
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(line.strip(), file=sys.stderr)
    _phase("build", seconds=f"{secs:.2f}",
           sources=",".join(m.KERNEL_SOURCE for m in modules))


def preset_layer(cfg, dev, gen):
    """One initialised ARM layer of the preset's tower, and its sequence
    length and cls position."""
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.mamba import ARM
    from medical_image_analysis_tpu_torch.train.loop import vision_preset

    vk = vision_preset(cfg.model.vision, cfg.model.vision_size,
                       cfg.model.vision_kwargs)
    arm = ARM(**dict(vk, depth=1), img_size=cfg.data.input_size, device=dev)
    init_params(arm, gen)
    seq_len = arm.pos_embed.shape[1]
    return arm.layers[0].mixer, seq_len, (seq_len - 1) // 2


def _layer_weights(mixer) -> dict:
    with torch.no_grad():
        w = dict(conv_w=mixer.conv_w, conv_b=mixer.conv_b,
                 x_proj_w=mixer.x_proj_w, dt_proj_w=mixer.dt_proj_w,
                 dt_bias=mixer.dt_bias, A=-torch.exp(mixer.A_log), D=mixer.D)
        return {k: v.detach().float().contiguous() for k, v in w.items()}


def phase_kernels(cfg, dev, gen, batches=(1, 6)) -> dict:
    """Kernels against plain versions; returns the serving-shape row
    (batch 1, fp32) for the kernels' JSON line."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    mixer, seq_len, cls_pos = preset_layer(cfg, dev, gen)
    w = _layer_weights(mixer)
    serving = {}
    for b in batches:
        x = torch.randn(b, seq_len, mixer.d_inner, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            xr = x.to(dtype)
            xc = mixer._col_major(xr, cls_pos).contiguous()
            xargs = (xr, xc, w["conv_w"], w["conv_b"], w["x_proj_w"])
            want_x = mf.xdbl_plain(*xargs)
            got_x = mf.xdbl_fwd(*xargs)
            sargs = (xr, xc, want_x, w["conv_w"], w["conv_b"],
                     w["dt_proj_w"], w["dt_bias"], w["A"], w["D"])
            want_y = mf.scan_plain(*sargs)
            got_y = mf.scan_fwd(*sargs)
            _sync(dev)
            _check(got_x.shape == want_x.shape and got_y.shape == want_y.shape
                   and got_y.dtype == dtype, "kernel output shape or dtype")
            err_x, scale_x = _max_err(got_x, want_x)
            err_y, scale_y = _max_err(got_y, want_y)
            _check(err_x <= XDBL_RTOL * scale_x,
                   f"mamba_xdbl B={b} {dtype}: max abs err {err_x:.3e} > "
                   f"{XDBL_RTOL} x {scale_x:.3f}")
            _check(err_y <= Y_RTOL[dtype] * scale_y,
                   f"mamba_scan B={b} {dtype}: max abs err {err_y:.3e} > "
                   f"{Y_RTOL[dtype]} x {scale_y:.3f}")
            # in turns: plain, kernel, kernel, plain
            t = {}
            for name, fn, iters in (
                ("xdbl_plain", lambda: mf.xdbl_plain(*xargs), 20),
                ("xdbl", lambda: mf.xdbl_fwd(*xargs), 50),
                ("xdbl", lambda: mf.xdbl_fwd(*xargs), 50),
                ("xdbl_plain", lambda: mf.xdbl_plain(*xargs), 20),
                ("scan_plain", lambda: mf.scan_plain(*sargs), 3),
                ("scan", lambda: mf.scan_fwd(*sargs), 50),
                ("scan", lambda: mf.scan_fwd(*sargs), 50),
                ("scan_plain", lambda: mf.scan_plain(*sargs), 3),
            ):
                t[name] = t.get(name, 0.0) + device_ms(fn, iters) / 2
            dt_name = "fp32" if dtype == torch.float32 else "bf16"
            _phase(
                "kernels", B=b, K=mixer.k, L=seq_len, D=mixer.d_inner,
                N=mixer.n, R=mixer.rank, src=dt_name,
                xdbl_err=f"{err_x:.3e}", scan_err=f"{err_y:.3e}",
                xdbl_ms=f"{t['xdbl']:.4f}",
                xdbl_plain_ms=f"{t['xdbl_plain']:.4f}",
                scan_ms=f"{t['scan']:.4f}",
                scan_plain_ms=f"{t['scan_plain']:.4f}",
                **_mamba_fwd_blocks(b, mixer.k, seq_len, mixer.d_inner,
                                    mixer.n, mixer.rank, dtype),
                **_xdbl_blocks(b, mixer.k, seq_len, mixer.d_inner,
                               got_x.shape[-1], dtype, True,
                               w["conv_w"].shape[1]),
            )
            if b == 1 and dtype == torch.float32:
                elems = b * mixer.k * seq_len * mixer.d_inner
                serving = {
                    "mamba_xdbl": (err_x, t["xdbl"], t["xdbl_plain"],
                                   *_bound([*xargs, got_x],
                                           _xdbl_work(elems, got_x.shape[-1],
                                                      True))[:2]),
                    "mamba_scan": (err_y, t["scan"], t["scan_plain"],
                                   *_bound([*sargs, got_y], elems * _mamba_ops(
                                       mixer.rank, mixer.n))[:2]),
                }
    return serving


def _mamba_fwd_blocks(b, k_dirs, seq_len, d_in, n, rank, dtype) -> dict:
    """The fused forward's chunk for (B, K, L, D) on this card, and its
    kernels' grid blocks, resident blocks an SM and shared memory a block,
    for a phase line."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk = mf.fwd_chunk(b, k_dirs, seq_len, d_in, sms)
    occupancy = mf.fwd_occupancy(n, rank, dtype)
    return dict(
        chunk=chunk,
        grid_blocks=_compact(mf.fwd_grid_blocks(b, k_dirs, seq_len, d_in, n,
                                                chunk)),
        blocks_per_sm=_compact({k: v[0] for k, v in occupancy.items()}),
        smem_bytes=_compact({k: v[1] for k, v in occupancy.items()}))


def _xdbl_work(elems: int, c: int, use_conv: bool) -> tuple:
    """x_dbl's (products, other) for ``_bound`` over ``elems`` = B K L D
    source elements: the 2 C products an element on the tensor cores, the
    conv and SiLU's 13 operations an element on the CUDA cores."""
    return 2.0 * elems * c, 13.0 * elems if use_conv else 0.0


def _xdbl_blocks(b, k_dirs, seq_len, d_in, c, dtype, use_conv,
                 taps) -> dict:
    """x_dbl's tile on this card (rows x directions a block x ranges of D),
    its grid's blocks, resident blocks an SM and shared memory a block, for
    a phase line."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile = mf.xdbl_tile(b, k_dirs, seq_len, d_in, c, sms)
    blocks, smem = mf.xdbl_occupancy(*tile[:2], dtype, use_conv, taps, c)
    return dict(xdbl_tile="x".join(map(str, tile)),
                xdbl_grid_blocks=mf.xdbl_grid_blocks(b, k_dirs, seq_len, c,
                                                     *tile),
                xdbl_blocks_per_sm=blocks, xdbl_smem_bytes=smem)


def phase_kernels_fwd_vssm(dev, gen) -> None:
    """``xdbl_fwd`` and ``scan_fwd`` at vssm_tiny's four stage shapes
    (``vssm_xdbl_case``'s and ``vssm_bwd_case``'s arguments: K=4, no conv,
    N=16, softplus). ``xdbl_fwd`` is held against ``xdbl_plain`` within
    XDBL_RTOL at B=MAMBA_VSSM_CHECK_BATCH and at ``vssm_classify``'s
    B=SS_VSSM_BATCH, whose output is the one timed (``xdbl_tile`` picks
    its tile from B, so the small batch may run another one);
    ``scan_fwd`` against ``scan_plain`` within Y_RTOL at
    B=MAMBA_VSSM_CHECK_BATCH (its per-row plain loop holds B=8 easily; the
    scan's indexing depends on B only through the grid). Each is then
    timed alone at B=SS_VSSM_BATCH beside its bound: the median of three
    timings of 10 calls, all three printed (sorted) beside it."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    for stage, (seq_len, d_in) in enumerate(SS_VSSM_STAGES):
        errs = {}
        for batch in (MAMBA_VSSM_CHECK_BATCH, SS_VSSM_BATCH):
            xargs, w, _ = vssm_xdbl_case(dev, gen, stage, batch)
            xargs = (*xargs[:4], w[0], xargs[4])
            del w
            got = mf.xdbl_fwd(*xargs)
            want = mf.xdbl_plain(*xargs)
            _sync(dev)
            _check(got.shape == want.shape
                   and bool(torch.isfinite(got).all()),
                   f"mamba_xdbl vssm_tiny stage {stage} B={batch}: shape "
                   f"or finiteness")
            err, scale = _max_err(got, want)
            _check(err <= XDBL_RTOL * scale,
                   f"mamba_xdbl vssm_tiny stage {stage} B={batch}: max "
                   f"abs err {err:.3e} > {XDBL_RTOL} x {scale:.3f}")
            errs[batch] = err
            del want
        runs = sorted(device_ms(lambda: mf.xdbl_fwd(*xargs), 10)
                      for _ in range(3))
        c = got.shape[-1]
        bound = _bound([*xargs[:5], got], _xdbl_work(
            SS_VSSM_BATCH * 4 * seq_len * d_in, c, False))
        _phase("kernels_xdbl_vssm", stage=stage, B=SS_VSSM_BATCH, K=4,
               L=seq_len, D=d_in, C=c, src="fp32",
               check_B=f"{MAMBA_VSSM_CHECK_BATCH},{SS_VSSM_BATCH}",
               err="/".join(f"{e:.3e}" for e in errs.values()),
               ms=f"{runs[1]:.4f}",
               ms_runs="/".join(f"{t:.4f}" for t in runs),
               bound_ms=f"{bound[0]:.4f}", bound_by=bound[2],
               **_xdbl_blocks(SS_VSSM_BATCH, 4, seq_len, d_in, c,
                              torch.float32, False, xargs[2].shape[1]))
        del xargs, got
        args, rank = vssm_bwd_case(dev, gen, stage, MAMBA_VSSM_CHECK_BATCH)
        fargs = (*args[:9], True, False)
        del args
        want = mf.scan_plain(*fargs)
        got = mf.scan_fwd(*fargs)
        _sync(dev)
        _check(got.shape == want.shape and got.dtype == want.dtype
               and bool(torch.isfinite(got).all()),
               f"mamba_scan vssm_tiny stage {stage}: shape, dtype or "
               f"finiteness")
        err, scale = _max_err(got, want)
        _check(err <= Y_RTOL[torch.float32] * scale,
               f"mamba_scan vssm_tiny stage {stage} B="
               f"{MAMBA_VSSM_CHECK_BATCH}: max abs err {err:.3e} > "
               f"{Y_RTOL[torch.float32]} x {scale:.3f}")
        del fargs, want, got
        args, rank = vssm_bwd_case(dev, gen, stage, SS_VSSM_BATCH)
        fargs = (*args[:9], True, False)
        del args
        runs = sorted(device_ms(lambda: mf.scan_fwd(*fargs), 10)
                      for _ in range(3))
        ms = runs[1]
        bound = _bound([*fargs[:9], mf.scan_fwd(*fargs)],
                       SS_VSSM_BATCH * 4 * seq_len * d_in
                       * _mamba_ops(rank, 16, use_conv=False))
        _phase("kernels_fwd_vssm", stage=stage, B=SS_VSSM_BATCH, K=4,
               L=seq_len, D=d_in, N=16, R=rank, src="fp32",
               check_B=MAMBA_VSSM_CHECK_BATCH, err=f"{err:.3e}",
               ms=f"{ms:.4f}", ms_runs="/".join(f"{t:.4f}" for t in runs),
               bound_ms=f"{bound[0]:.4f}", bound_by=bound[1],
               **_mamba_fwd_blocks(
                   SS_VSSM_BATCH, 4, seq_len, d_in, 16, rank,
                   torch.float32))
        del fargs
        torch.cuda.empty_cache()


def phase_kernels_bwd(cfg, dev, gen, batches=(1, 6)) -> tuple:
    """The backward kernel against its plain version; returns the
    training-shape row (batch 6 = 3 samples x 2 views, fp32 sources, as
    the tower trains): (max abs err over the outputs, ms, plain ms)."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    mixer, seq_len, cls_pos = preset_layer(cfg, dev, gen)
    w = _layer_weights(mixer)
    training = None
    for b in batches:
        x = torch.randn(b, seq_len, mixer.d_inner, device=dev, generator=gen)
        dy = torch.randn(b, mixer.k, seq_len, mixer.d_inner, device=dev,
                         generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            xr = x.to(dtype)
            xc = mixer._col_major(xr, cls_pos).contiguous()
            x_dbl = mf.xdbl_plain(xr, xc, w["conv_w"], w["conv_b"],
                                  w["x_proj_w"])
            args = (xr, xc, x_dbl, w["conv_w"], w["conv_b"], w["dt_proj_w"],
                    w["dt_bias"], w["A"], w["D"], dy.to(dtype))
            want = mf.scan_bwd_plain(*args)
            got = mf.scan_bwd(*args)
            _sync(dev)
            errs = _bwd_errs(got, want, f"B={b} {dtype}")
            t = {}
            for name, fn, iters in (  # in turns: plain, kernel, kernel, plain
                ("plain", lambda: mf.scan_bwd_plain(*args), 2),
                ("kernel", lambda: mf.scan_bwd(*args), 20),
                ("kernel", lambda: mf.scan_bwd(*args), 20),
                ("plain", lambda: mf.scan_bwd_plain(*args), 2),
            ):
                t[name] = t.get(name, 0.0) + device_ms(fn, iters) / 2
            _phase(
                "kernels_bwd", B=b, K=mixer.k, L=seq_len, D=mixer.d_inner,
                N=mixer.n, R=mixer.rank,
                src="fp32" if dtype == torch.float32 else "bf16",
                errs=json.dumps({k: f"{v:.3e}" for k, v in errs.items()},
                                separators=(",", ":")),
                bwd_ms=f"{t['kernel']:.4f}", bwd_plain_ms=f"{t['plain']:.4f}",
                **_mamba_bwd_blocks(b, mixer.k, seq_len, mixer.d_inner,
                                    mixer.n, mixer.rank, dtype),
            )
            if b == 6 and dtype == torch.float32:
                training = (max(errs.values()), t["kernel"], t["plain"],
                            *_bound([*args, *got], _mamba_bwd_ops(
                                b, mixer.k, seq_len, mixer.d_inner,
                                mixer.n, mixer.rank))[:2])
    for stage, (seq_len, d_in) in enumerate(SS_VSSM_STAGES):
        args, rank = vssm_bwd_case(dev, gen, stage, MAMBA_VSSM_CHECK_BATCH)
        want = mf.scan_bwd_plain(*args)
        got = mf.scan_bwd(*args)
        _sync(dev)
        errs = _bwd_errs(got, want, f"vssm_tiny stage {stage} "
                         f"B={MAMBA_VSSM_CHECK_BATCH}")
        del args, want, got
        args, rank = vssm_bwd_case(dev, gen, stage, SS_VSSM_BATCH)
        ms = device_ms(lambda: mf.scan_bwd(*args), 5)
        bound = _bound([*args[:10], *mf.scan_bwd(*args)], _mamba_bwd_ops(
            SS_VSSM_BATCH, 4, seq_len, d_in, 16, rank))
        _phase("kernels_bwd_vssm", stage=stage, B=SS_VSSM_BATCH, K=4,
               L=seq_len, D=d_in, N=16, R=rank, src="fp32",
               check_B=MAMBA_VSSM_CHECK_BATCH, errs=_compact(
                   {k: f"{v:.3e}" for k, v in errs.items()}),
               ms=f"{ms:.4f}", bound_ms=f"{bound[0]:.4f}",
               bound_by=bound[1], **_mamba_bwd_blocks(
                   SS_VSSM_BATCH, 4, seq_len, d_in, 16, rank,
                   torch.float32))
        del args
        torch.cuda.empty_cache()
    return training


def _bwd_errs(got, want, what: str) -> dict:
    """Each fused-backward output's max abs error against the plain
    version's, held to BWD_RTOL."""
    errs = {}
    for name, g, wv in zip(BWD_OUTPUTS, got, want):
        _check(g.shape == wv.shape and g.dtype == torch.float32,
               f"mamba_scan_bwd {name}: shape or dtype")
        err, scale = _max_err(g, wv)
        _check(err <= BWD_RTOL * scale,
               f"mamba_scan_bwd {what} {name}: max abs err {err:.3e} > "
               f"{BWD_RTOL} x {scale:.3f}")
        errs[name] = err
    return errs


def _mamba_bwd_ops(b, k, seq_len, d_in, n, rank):
    """The fused backward's operations: it recomputes the forward and runs
    the adjoint (``_mamba_ops``' comment)."""
    return b * k * seq_len * d_in * (2 * _mamba_ops(rank, n) + 2 * rank
                                     + 10 * n)


def _mamba_bwd_blocks(b, k_dirs, seq_len, d_in, n, rank, dtype) -> dict:
    """The fused backward's kernels: grid blocks, resident blocks an SM and
    shared memory a block, for a phase line."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    occupancy = mf.bwd_occupancy(n, rank, dtype)
    return dict(
        grid_blocks=_compact(mf.bwd_grid_blocks(b, k_dirs, seq_len, d_in, n)),
        blocks_per_sm=_compact({k: v[0] for k, v in occupancy.items()}),
        smem_bytes=_compact({k: v[1] for k, v in occupancy.items()}))


def vssm_xdbl_case(dev, gen, stage: int, batch: int):
    """``xdbl_fwd``'s fp32 arguments at a vssm_tiny stage (``SS_VSSM_STAGES``)
    as ``vssm_classify`` gives them: an initialised SS2D's fused-layer
    weights (d_state 16, no conv; its directions in the fused layer's
    order) and sources silu(N(0, 1)) as SS2D feeds the scan. Returns
    (xr, xc, conv_w, conv_b, use_conv), the SS2D's (x_proj_w, dt_proj_w,
    dt_bias, A, D) and its R."""
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.vmamba import SS2D

    seq_len, d_in = SS_VSSM_STAGES[stage]
    m = SS2D(d_in // 2, d_state=16, device=dev)
    init_params(m, gen)
    hw = int(round(seq_len**0.5))
    x = torch.nn.functional.silu(
        torch.randn(batch, hw, hw, d_in, device=dev, generator=gen))
    xr = x.reshape(batch, seq_len, d_in)
    xc = x.transpose(1, 2).reshape(batch, seq_len, d_in).contiguous()
    perm = [0, 2, 1, 3]  # SS2D's directions in the fused layer's order
    with torch.no_grad():
        w = [t.detach()[perm].float().contiguous() for t in (
            m.x_proj_w, m.dt_proj_w, m.dt_bias, -torch.exp(m.A_log), m.D)]
    conv_w = torch.zeros(4, 4, d_in, device=dev)
    conv_b = torch.zeros(4, d_in, device=dev)
    return (xr, xc, conv_w, conv_b, False), w, m.rank


def vssm_bwd_case(dev, gen, stage: int, batch: int):
    """``scan_bwd``'s fp32 arguments at a vssm_tiny stage
    (``vssm_xdbl_case``'s layer and sources), x_dbl as ``xdbl_plain``
    gives it and a N(0, 1) cotangent. Returns (args, R)."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    (xr, xc, conv_w, conv_b, _), w, rank = vssm_xdbl_case(dev, gen, stage,
                                                          batch)
    seq_len, d_in = SS_VSSM_STAGES[stage]
    with torch.no_grad():
        x_dbl = mf.xdbl_plain(xr, xc, conv_w, conv_b, w[0], False)
    dy = torch.randn(batch, 4, seq_len, d_in, device=dev, generator=gen)
    return (xr, xc, x_dbl, conv_w, conv_b, *w[1:], dy, True, False), rank


def _png(rng, size: int) -> bytes:
    import PIL.Image

    # a smooth radial field plus noise, 8-bit grey in three channels
    yy, xx = np.mgrid[0:size, 0:size] / size
    field = 160 * np.exp(-((xx - 0.5) ** 2 + (yy - 0.45) ** 2) * 4)
    img = np.clip(field + rng.normal(0, 20, (size, size)), 0, 255)
    img = np.repeat(img.astype(np.uint8)[..., None], 3, axis=2)
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _post(port: int, png: bytes) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"image": base64.b64encode(png).decode()}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def phase_serve(config: str, vocab: int, device: str, requests: int):
    """Build the pipeline, serve ``requests`` POSTs; returns (pipeline,
    first PNG, launch counts of the run)."""
    from medical_image_analysis_tpu_torch.cli.demo import (
        build_pipeline,
        make_server,
    )
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    t0 = time.perf_counter()
    pipe = build_pipeline(argparse.Namespace(
        config=config, vocab=None, vocab_size=vocab, delta=None,
        device=device, seed=SEED,
    ))
    _sync(pipe.device)
    build_s = time.perf_counter() - t0
    model, gcfg = pipe.model, pipe.gcfg
    depth = len(model.vision.arm.layers)
    n_params = sum(p.numel() for p in model.parameters())

    rng = np.random.default_rng(SEED)
    pngs = [_png(rng, 224) for _ in range(requests)]
    server = make_server(pipe, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    secs = []
    try:
        mf.reset_launches()
        for png in pngs:
            t = time.perf_counter()
            status, out = _post(server.server_address[1], png)
            secs.append(time.perf_counter() - t)
            ids = out["ids"]
            _check(status == 200, f"HTTP status {status}")
            _check(len(ids) == gcfg.max_new_tokens,
                   f"{len(ids)} ids, expected {gcfg.max_new_tokens}")
            _check(all(0 <= i < vocab for i in ids), "token id out of range")
        launches = dict(mf.launches)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    _check(not thread.is_alive(), "server thread did not stop")
    _phase(
        "serve", preset=Path(config).name, params=n_params,
        arm_layers=depth, llm=f"{model.llm_cfg.dim}x{model.llm_cfg.n_layers}",
        vocab=model.llm_cfg.vocab_size, beams=gcfg.num_beams,
        new_tokens=gcfg.max_new_tokens, build_s=f"{build_s:.2f}",
        request_s=",".join(f"{s:.3f}" for s in secs),
        launches=json.dumps(launches, separators=(",", ":")),
    )
    return pipe, pngs[0], launches, depth


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def phase_tower(pipe, png: bytes, reps: int = 3):
    """encode_img through the kernels and through the plain versions, with
    the wall-clock time of each (host launches included, as served)."""
    import PIL.Image

    from medical_image_analysis_tpu_torch.models.mamba import set_scan_backend

    with PIL.Image.open(io.BytesIO(png)) as pil:
        img = np.asarray(pil.convert("RGB"), np.uint8)
    x = pipe.preprocess(img)
    model = pipe.model
    out, ms = {}, {}
    with torch.no_grad():
        for backend in ("plain", "auto", "auto", "plain"):  # in turns
            set_scan_backend(model, backend)
            out[backend] = model.encode_img(x)
            _sync(x.device)
            t0 = time.perf_counter()
            for _ in range(reps):
                model.encode_img(x)
            _sync(x.device)
            ms[backend] = ms.get(backend, 0.0) + (
                (time.perf_counter() - t0) * 1e3 / reps / 2)
        set_scan_backend(model, "auto")
    got, want = out["auto"], out["plain"]
    tokens = model.vision.arm.pos_embed.shape[1]
    _check(bool(torch.isfinite(got).all()), "non-finite tower output")
    _check(got.shape == want.shape
           and tuple(got.shape) == (1, tokens, model.llm_cfg.dim),
           f"tower output shape {tuple(got.shape)}")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    _check(rel <= TOWER_RTOL, f"tower max rel err {rel:.3e} > {TOWER_RTOL}")
    _phase("tower", shape=tuple(got.shape), max_rel_err=f"{rel:.3e}",
           bound=TOWER_RTOL, kernel_ms=f"{ms['auto']:.3f}",
           plain_ms=f"{ms['plain']:.3f}")


def _fingerprint(t: torch.Tensor) -> tuple:
    with torch.no_grad():
        return (t.sum(dtype=torch.float64).item(),
                t.abs().sum(dtype=torch.float64).item())


def _train_through_cli(argv: list[str], save_dir: Path, device: str,
                       epochs: int = 1, validated: bool = True,
                       check_start=None) -> dict:
    """``cli.train.main(argv)`` for ``epochs``, with the kernels' counts at
    0 just before and read just after. Checks what every training run must
    show: the steps of the epochs, each finite; finite scores; every
    trainable tensor moved and no frozen one; when ``validated``, one
    validation and, for report generation, the delta written. Returns the
    model, the state, the run's config and counts, and the fields that the
    phases print (set-up seconds: from the call to the first step).
    ``check_start(model, state)``, when given, runs before the first step
    and its result joins the printed fields."""
    from medical_image_analysis_tpu_torch.cli import train as cli_train

    seen = {}

    def on_start(model, state):
        seen["model"], seen["state"] = model, state
        seen["trainable"] = {n: p.detach().clone()
                             for n, p in state.params.items()}
        seen["frozen"] = {n: _fingerprint(p) for n, p in state.frozen.items()}
        _sync(torch.device(device))
        seen["setup_s"] = time.perf_counter() - t0
        seen["start"] = check_start(model, state) if check_start else {}

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    scores = cli_train.main([*argv, "--device", device], on_start=on_start)
    _sync(torch.device(device))
    total_s = time.perf_counter() - t0
    launches = _all_launches()
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    model, state = seen["model"], seen["state"]
    import yaml

    with open(save_dir / "config.yaml") as f:
        cfg = yaml.safe_load(f)
    batch = cfg["data"]["batch_size"]
    classify = cfg["model"]["task"] in ("swinchex", "dp")
    if cfg["data"]["dataset"] == "synthetic_learnable":
        train_samples = cfg["data"]["synthetic_train_size"] or 512
        val_samples = LEARNABLE_VAL
    else:
        train_samples, val_samples = TRAIN_SAMPLES, VAL_SAMPLES
    with open(save_dir / "log.txt") as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "step" in r]
    vals = [r for r in records if "val_s" in r]
    n_steps = epochs * (train_samples // batch)
    _check(len(steps) == n_steps, f"{len(steps)} steps, expected {n_steps}")
    _check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in steps), "a non-finite loss or grad norm")
    _check(all(np.isfinite(np.asarray(v, np.float64)).all()
               for v in scores.values()), "non-finite scores")
    if validated:
        _check(len(vals) == 1, "validation missing")
    if validated and not classify and cfg["model"]["task"] != "mamba_lm_sft":
        # fit_r2gen, as the JAX recipe, keeps no best copy; fit_lm_sft
        # writes no delta
        deltas = sorted(save_dir.glob("checkpoint_epoch0_*.pt"))
        _check(len(deltas) == 1
               and (cfg["model"]["task"] == "r2gen"
                    or (save_dir / "checkpoint_best.pt").exists()),
               "delta checkpoint not written")
    moved = sum(not torch.equal(p, seen["trainable"][n])
                for n, p in state.params.items())
    _check(moved == len(state.params),
           f"{len(state.params) - moved} trainable tensors did not move")
    still = sum(_fingerprint(p) == seen["frozen"][n]
                for n, p in state.frozen.items())
    _check(still == len(state.frozen),
           f"{len(state.frozen) - still} frozen tensors moved")
    fields = dict(
        steps=n_steps, batch=batch, trainable=len(state.params),
        frozen=len(state.frozen),
        trainable_params=sum(p.numel() for p in state.params.values()),
        losses=",".join(f"{r['loss']:.4f}" for r in steps),
        grad_norms=",".join(f"{r['grad_norm']:.4f}" for r in steps),
        step_s=",".join(f"{r['step_s']:.3f}" for r in steps),
        setup_s=f"{seen['setup_s']:.2f}", total_s=f"{total_s:.2f}",
        peak_mem_gib=f"{peak / 2**30:.3f}",
        launches=json.dumps(launches, separators=(",", ":")),
    )
    fields.update(seen["start"])
    if validated:
        fields.update(val_s=f"{vals[0]['val_s']:.3f}")
        fields.update({k: f"{scores[k]:.4f}" for k in (
            "acc_mean", "auc_mean", "instance_f1", "Bleu_4") if k in scores})
    val_bs = cfg["data"]["val_batch_size"] or batch
    val_batches = -(-val_samples // val_bs)
    if not classify:  # fit_mrg scores at most val_max_batches batches
        val_batches = min(val_batches,
                          cfg["train"]["val_max_batches"] or val_batches)
    return {"model": model, "state": state, "cfg": cfg, "cuda": cuda,
            "n_steps": n_steps, "val_batches": val_batches,
            "launches": launches, "fields": fields, "scores": scores,
            "losses": [r["loss"] for r in steps]}


def _check_launches(run: dict, reckoned: dict, phase: str, how: str) -> None:
    """The run's counts against the design's reckoning (every kernel not
    named there at 0); a CPU rehearsal launches none."""
    want = {name: reckoned.get(name, 0) for name in run["launches"]}
    print(f"{phase}: launches reckoned: {how} -> "
          f"{json.dumps(want, separators=(',', ':'))}", flush=True)
    if not run["cuda"]:  # CPU tensors take the plain versions
        want = dict.fromkeys(want, 0)
    _check(run["launches"] == want,
           f"{phase}: launches {run['launches']}, expected {want}")


def phase_train(config: str, vocab: int, save_dir: Path,
                device: str = "cuda") -> dict:
    """Train the preset for one epoch through the CLI; returns the model,
    the batch size and accumulation, and the launch counts of the run."""
    argv = ["--config", config]
    for item in ("data.dataset=synthetic", f"model.llm_kwargs.vocab_size={vocab}",
                 "train.epochs=1", "train.save_state_every_epochs=2",
                 "train.log_every=1", f"train.save_dir={save_dir}"):
        argv += ["--set", item]
    run = _train_through_cli(argv, save_dir, device)
    model, n_steps = run["model"], run["n_steps"]
    accum = run["cfg"]["train"]["accum_steps"]

    # What the design implies: with remat, each ARM layer runs both forward
    # kernels twice per micro-batch (the checkpointed forward and its
    # recompute in the backward) and the backward kernel once; validation
    # encodes each val batch once (no gradient, no recompute).
    depth = len(model.vision.arm.layers)
    val_batches = run["val_batches"]
    fwd_step, bwd_step = depth * accum * 2, depth * accum
    fwd = n_steps * fwd_step + val_batches * depth
    _check_launches(
        run, {"mamba_xdbl": fwd, "mamba_scan": fwd,
              "mamba_scan_bwd": n_steps * bwd_step}, "train",
        f"per step {depth} layers x {accum} micro-batches x 2 forwards = "
        f"{fwd_step} of each forward kernel and {depth} x {accum} = "
        f"{bwd_step} backward; {n_steps} steps + {val_batches} val batches "
        f"x {depth} layers")
    _phase("train", preset=Path(config).name, accum=accum, **run["fields"])
    return {"model": model, "state": run["state"],
            "batch": run["cfg"]["data"]["batch_size"], "accum": accum,
            "launches": run["launches"], "losses": run["losses"],
            "scores": run["scores"]}


def _worst_rel(names, got, want) -> tuple[float, str]:
    """The largest max |got - want| / max |want| over the named gradients,
    and its name; every gradient must be finite."""
    out = (0.0, "")
    for n, g, gp in zip(names, got, want):
        _check(bool(torch.isfinite(g).all()), f"non-finite grad of {n}")
        rel = ((g - gp).abs().max() / gp.abs().max().clamp_min(1e-30)).item()
        out = max(out, (rel, n))
    return out


def phase_train_grads(model, state, config: str, batch: int, accum: int):
    """One micro-batch of the preset's data: the tower's and projector's
    gradients through the kernels against those through the plain
    versions, both driven by one cotangent at the projector's output.

    That cotangent is the loss's gradient w.r.t. the image tokens, taken
    once (plain path). Taken through the whole model instead, the two
    paths' gradients differ by a few percent: the bf16 LLM rounds the
    image tokens, and a 1e-6 gap in them flips some roundings by one bf16
    step, which the LLM's backward carries into every gradient. That gap
    is printed (``e2e_``), not bounded.
    """
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.mamba import set_scan_backend
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf
    from medical_image_analysis_tpu_torch.train.loop import (
        _device_batch,
        build_data,
    )

    cfg = load_config(config, ["data.dataset=synthetic", "data.num_workers=1"])
    _, _, batcher, _ = build_data(cfg)
    train_b = batcher("train")
    try:
        host = next(train_b.batches(shuffle=False))
    finally:
        train_b.close()
    dev = next(model.parameters()).device
    micro = {k: v[: batch // accum]
             for k, v in _device_batch(host, dev).items()}
    names = [n for n in state.params if n.startswith(("base/vision/",
                                                      "base/proj"))]
    tensors = [state.params[n] for n in names]

    def loss_of(tokens):
        prompt = model._wrap(tokens, micro["before_ids"], micro["after_ids"])
        return model._loss(prompt, micro["target_ids"], micro["target_mask"])

    set_scan_backend(model, "plain")
    tokens = model.encode_img(micro["images"]).detach().requires_grad_()
    (cotangent,) = torch.autograd.grad(loss_of(tokens), tokens)
    grads, e2e, secs = {}, {}, {}
    for backend in ("auto", "plain"):
        set_scan_backend(model, backend)
        mf.reset_launches()
        t0 = time.perf_counter()
        out = model.encode_img(micro["images"])
        grads[backend] = torch.autograd.grad(out, tensors, cotangent)
        _sync(dev)
        secs[backend] = time.perf_counter() - t0
        if backend == "auto" and dev.type == "cuda":
            depth = len(model.vision.arm.layers)
            _check(mf.launches == {"mamba_xdbl": 2 * depth,
                                   "mamba_scan": 2 * depth,
                                   "mamba_scan_bwd": depth},
                   f"train_grads launches {mf.launches}")
        e2e[backend] = torch.autograd.grad(
            loss_of(model.encode_img(micro["images"])), tensors)
    set_scan_backend(model, "auto")

    rel, at = _worst_rel(names, grads["auto"], grads["plain"])
    e2e_rel, e2e_at = _worst_rel(names, e2e["auto"], e2e["plain"])
    _check(rel <= TOWER_RTOL,
           f"grad of {at}: max rel err {rel:.3e} > {TOWER_RTOL}")
    _phase("train_grads", tensors=len(names), micro_batch=batch // accum,
           max_rel_err=f"{rel:.3e}", at=at, bound=TOWER_RTOL,
           e2e_max_rel_err=f"{e2e_rel:.3e}", e2e_at=e2e_at,
           kernel_s=f"{secs['auto']:.3f}", plain_s=f"{secs['plain']:.3f}")


def _n1_case(dev, gen, hw: int, dim: int, batch: int, dtype):
    """An initialised vssm1_base SS2D's scan weights at one stage, and
    random sources of its shape: (args of scan_n1_fwd, D, R)."""
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.vmamba import SS2D
    from medical_image_analysis_tpu_torch.ops import scan_n1 as sn

    m = SS2D(dim, d_state=1, disable_z=True, conv_bias=False, device=dev)
    init_params(m, gen)
    d_in = m.d_inner
    x = torch.randn(batch, hw, hw, d_in, device=dev, generator=gen)
    x = torch.nn.functional.silu(x).to(dtype)  # as SS2D feeds the scan
    xr = x.reshape(batch, hw * hw, d_in)
    xc = x.transpose(1, 2).reshape(batch, hw * hw, d_in).contiguous()
    with torch.no_grad():
        a = -torch.exp(m.A_log.float())
        x_dbl = sn._x_dbl(xr, xc, m.x_proj_w)
        w = sn._weights(m.dt_proj_w, m.dt_bias, a, m.D)
    return (xr, xc, x_dbl, *w), d_in, m.rank


def _n1_cases(batches=None):
    """(stage, batch, dtype): the four stages at each of ``batches`` (by
    default the training batch) in fp32, stage 2 at the training batch in
    bf16, stage 0 at batch 1."""
    cases = [(i, b, torch.float32) for b in batches or (N1_BATCH,)
             for i in range(len(N1_STAGES))]
    return cases + [(2, N1_BATCH, torch.bfloat16), (0, 1, torch.float32)]


def _in_turns(plain_fn, kernel_fn, plain_iters, kernel_iters):
    """Device ms of each, timed in turns: plain, kernel, kernel, plain."""
    t = {}
    for name, fn, iters in (("plain", plain_fn, plain_iters),
                            ("kernel", kernel_fn, kernel_iters),
                            ("kernel", kernel_fn, kernel_iters),
                            ("plain", plain_fn, plain_iters)):
        t[name] = t.get(name, 0.0) + device_ms(fn, iters) / 2
    return t


def phase_kernels_n1(dev, gen) -> tuple:
    """The forward against its plain version at every batch the main path
    gives it; each line also names the chunk ``fwd_chunk`` picks (L: one
    pass) and each forward kernel's grid blocks, resident blocks an SM and
    shared memory a block. Returns the JSON row (max abs error over the
    fp32 cases, and stage 0's times at the training batch, the longest
    chain of the main path)."""
    from medical_image_analysis_tpu_torch.ops import scan_n1 as sn

    worst, row = 0.0, None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for stage, b, dtype in _n1_cases(N1_FWD_BATCHES):
        hw, dim = N1_STAGES[stage]
        args, d_in, rank = _n1_case(dev, gen, hw, dim, b, dtype)
        chunk = sn.fwd_chunk(b, hw * hw, d_in, sms)
        occupancy = sn.fwd_occupancy(rank, dtype, chunk < hw * hw)
        want = sn.scan_n1_fwd_plain(*args)
        got = sn.scan_n1_fwd(*args)
        _sync(dev)
        _check(got.shape == want.shape and got.dtype == dtype,
               "scan_n1_fwd output shape or dtype")
        err, scale = _max_err(got, want)
        _check(err <= Y_RTOL[dtype] * scale,
               f"scan_n1_fwd stage {stage} B={b} {dtype}: max abs err "
               f"{err:.3e} > {Y_RTOL[dtype]} x {scale:.3f}")
        t = _in_turns(lambda: sn.scan_n1_fwd_plain(*args),
                      lambda: sn.scan_n1_fwd(*args), 2, 20)
        bound = _bound([*args, got], 4 * b * hw * hw * d_in * (2 * rank + 13))
        _phase("kernels_n1", stage=stage, B=b, L=hw * hw, D=d_in, R=rank,
               src="fp32" if dtype == torch.float32 else "bf16",
               err=f"{err:.3e}", ms=f"{t['kernel']:.4f}",
               plain_ms=f"{t['plain']:.4f}", bound_ms=f"{bound[0]:.4f}",
               bound_by=bound[1], chunk=chunk,
               regime="one_pass" if chunk >= hw * hw else "chunks",
               grid_blocks=_compact(sn.fwd_grid_blocks(b, hw * hw, d_in,
                                                       chunk)),
               blocks_per_sm=_compact(
                   {k: v[0] for k, v in occupancy.items()}),
               smem_bytes=_compact({k: v[1] for k, v in occupancy.items()}))
        if dtype == torch.float32:
            worst = max(worst, err)
            if stage == 0 and b == N1_BATCH:
                row = (t["kernel"], t["plain"], *bound[:2])
    return (worst, *row)


def phase_kernels_n1_bwd(dev, gen) -> tuple:
    """The backward's kernels against their plain version, every output,
    at every stage; each line also names the three kernels' grid blocks,
    resident blocks an SM and shared memory a block. The JSON row as
    ``phase_kernels_n1``'s."""
    from medical_image_analysis_tpu_torch.ops import scan_n1 as sn

    worst, row = 0.0, None
    for stage, b, dtype in _n1_cases():
        hw, dim = N1_STAGES[stage]
        args, d_in, rank = _n1_case(dev, gen, hw, dim, b, dtype)
        dy = torch.randn(2, b, hw * hw, d_in, device=dev,
                         generator=gen).to(dtype)
        want = sn.scan_n1_bwd_plain(*args, dy)
        got = sn.scan_n1_bwd(*args, dy)
        _sync(dev)
        errs = {}
        for name, g, wv in zip(N1_OUTPUTS, got, want):
            _check(g.shape == wv.shape and g.dtype == torch.float32,
                   f"scan_n1_bwd {name}: shape or dtype")
            err, scale = _max_err(g, wv)
            _check(err <= BWD_RTOL * scale,
                   f"scan_n1_bwd stage {stage} B={b} {dtype} {name}: max abs "
                   f"err {err:.3e} > {BWD_RTOL} x {scale:.3f}")
            errs[name] = err
        t = _in_turns(lambda: sn.scan_n1_bwd_plain(*args, dy),
                      lambda: sn.scan_n1_bwd(*args, dy), 1, 10)
        ops = 4 * b * hw * hw * d_in * (2 * (2 * rank + 13) + 2 * rank + 10)
        bound = _bound([*args, dy, *got], ops)
        occupancy = sn.bwd_occupancy(rank, dtype)
        _phase("kernels_n1_bwd", stage=stage, B=b, L=hw * hw, D=d_in, R=rank,
               src=_dtype_name(dtype), errs=_compact(
                   {k: f"{v:.3e}" for k, v in errs.items()}),
               ms=f"{t['kernel']:.4f}", plain_ms=f"{t['plain']:.4f}",
               bound_ms=f"{bound[0]:.4f}", bound_by=bound[1],
               grid_blocks=_compact(sn.bwd_grid_blocks(b, hw * hw, d_in)),
               blocks_per_sm=_compact(
                   {k: v[0] for k, v in occupancy.items()}),
               smem_bytes=_compact({k: v[1] for k, v in occupancy.items()}))
        if dtype == torch.float32:
            worst = max(worst, max(errs.values()))
            if stage == 0 and b == N1_BATCH:
                row = (t["kernel"], t["plain"], *bound[:2])
    return (worst, *row)


def _compact(d: dict) -> str:
    return json.dumps(d, separators=(",", ":"))


def _kernel_modules():
    from medical_image_analysis_tpu_torch.utils.profiling import (
        kernel_modules,
    )

    return kernel_modules()


def _all_launches() -> dict:
    from medical_image_analysis_tpu_torch.utils.profiling import (
        kernel_launches,
    )

    return kernel_launches()


def _reset_launches() -> None:
    from medical_image_analysis_tpu_torch.utils.profiling import (
        reset_kernel_launches,
    )

    reset_kernel_launches()


def phase_train_csr(vocab: int, save_dir: Path, device: str = "cuda",
                    overrides=()) -> dict:
    """R2GenCSR on vssm1_base for one epoch through the CLI; returns the
    model, the state, the overrides and the launch counts of the run.

    ``overrides`` come after the slice's own (a CPU rehearsal shrinks the
    widths with them)."""
    sets = (*VSSM1_OVERRIDES, *overrides)
    run = _csr_through_cli(vocab, save_dir, device, sets)
    model, n_steps = run["model"], run["n_steps"]

    # What the design implies: every SS2D launches the forward kernel once
    # for the study's images (with a gradient) and once for the context
    # images (without), and the backward kernel once; validation runs both
    # forwards per val batch. No remat for the VSSM, as in the JAX package.
    blocks = sum(model.vision.vssm.depths)
    val_batches = run["val_batches"]
    n_ctx = run["cfg"]["data"]["n_context"]
    _check_launches(
        run, {"scan_n1_fwd": (n_steps + val_batches) * 2 * blocks,
              "scan_n1_bwd": n_steps * blocks}, "train_csr",
        f"{blocks} SS2D blocks x 2 towers (study images with grad, "
        f"{2 * n_ctx} context images per study without) x ({n_steps} steps "
        f"+ {val_batches} val batches) forward, {blocks} x {n_steps} backward")
    _phase("train_csr", preset=CSR_PRESET.name, n_context=n_ctx,
           blocks=blocks, llm=f"{model.llm_cfg.dim}x{model.llm_cfg.n_layers}",
           params=sum(p.numel() for p in model.parameters()), **run["fields"])
    return {"model": model, "state": run["state"], "launches": run["launches"],
            "overrides": run["sets"]}


def _csr_through_cli(vocab: int, save_dir: Path, device: str, overrides):
    """The r2gencsr_iu preset for one epoch on the synthetic dataset
    through the CLI, ``overrides`` after the phase's own; checks, beyond
    ``_train_through_cli``'s, that every trainable group of the recipe is
    there. Returns that function's result and the ``--set`` items."""
    sets = ("data.dataset=synthetic", f"model.llm_kwargs.vocab_size={vocab}",
            "train.epochs=1", "train.save_state_every_epochs=2",
            "train.log_every=1", f"train.save_dir={save_dir}", *overrides)
    argv = ["--config", str(CSR_PRESET)]
    for item in sets:
        argv += ["--set", item]
    run = _train_through_cli(argv, save_dir, device)
    kinds = {k: any(n.startswith(k) for n in run["state"].params)
             for k in ("base/vision/", "base/proj/", "base/ctx_proj/",
                       "base/pos_marker", "base/neg_marker", "lora/")}
    _check(all(kinds.values()), f"trainable groups {kinds}")
    return {**run, "sets": sets}


def phase_train_csr_grads(model, state, overrides) -> None:
    """One batch of the slice's data: the vssm1 tower's and the
    projector's gradients through the kernels against those through the
    plain versions, both driven by one cotangent at ``encode_img``'s two
    outputs (the projected tokens and the global feature that the context
    residuals subtract from), taken once from the loss (plain path).
    Through the whole loss the two paths differ by the bf16 LLM's
    roundings (see ``phase_train_grads``): printed (``e2e_``), not bounded.
    The context residuals (the tower without a gradient, on the batch's
    context images) are held to the same bound.
    """
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.mamba import set_scan_backend
    from medical_image_analysis_tpu_torch.ops import scan_n1 as sn
    from medical_image_analysis_tpu_torch.train.loop import (
        _device_batch,
        build_data,
    )

    cfg = load_config(str(CSR_PRESET),
                      [*overrides, "data.num_workers=1"])
    _, _, batcher, _ = build_data(cfg)
    train_b = batcher("train", n_context=cfg.data.n_context)
    try:
        host = next(train_b.batches(shuffle=False))
    finally:
        train_b.close()
    dev = next(model.parameters()).device
    b = _device_batch(host, dev)
    names = [n for n in state.params if n.startswith(("base/vision/",
                                                      "base/proj"))]
    tensors = [state.params[n] for n in names]
    blocks = sum(model.vision.vssm.depths)

    def loss_of(img, global_feat):
        prompt = model.context_prompt(img, global_feat, b["context_images"],
                                      b["before_ids"], b["after_ids"])
        return model._loss(prompt, b["target_ids"], b["target_mask"])

    set_scan_backend(model, "plain")
    outs = [o.detach().requires_grad_() for o in model.encode_img(b["images"])]
    cotangents = torch.autograd.grad(loss_of(*outs), outs)
    ctx = {}
    with torch.no_grad():
        for backend in ("auto", "plain"):
            set_scan_backend(model, backend)
            sn.reset_launches()
            ctx[backend] = model.context_residuals(outs[1],
                                                   b["context_images"])
            if backend == "auto" and dev.type == "cuda":
                _check(sn.launches == {"scan_n1_fwd": blocks,
                                       "scan_n1_bwd": 0},
                       f"context_residuals launches {sn.launches}")
    grads, e2e, secs = {}, {}, {}
    for backend in ("auto", "plain"):
        set_scan_backend(model, backend)
        sn.reset_launches()
        t0 = time.perf_counter()
        outs = model.encode_img(b["images"])
        grads[backend] = torch.autograd.grad(outs, tensors, cotangents)
        _sync(dev)
        secs[backend] = time.perf_counter() - t0
        if backend == "auto" and dev.type == "cuda":
            _check(sn.launches == {"scan_n1_fwd": blocks,
                                   "scan_n1_bwd": blocks},
                   f"train_csr_grads launches {sn.launches}")
        e2e[backend] = torch.autograd.grad(
            loss_of(*model.encode_img(b["images"])), tensors)
    set_scan_backend(model, "auto")

    rel, at = _worst_rel(names, grads["auto"], grads["plain"])
    e2e_rel, e2e_at = _worst_rel(names, e2e["auto"], e2e["plain"])
    ctx_rel, _ = _worst_rel(["context residuals"], [ctx["auto"]],
                            [ctx["plain"]])
    _check(rel <= TOWER_RTOL,
           f"grad of {at}: max rel err {rel:.3e} > {TOWER_RTOL}")
    _check(ctx_rel <= TOWER_RTOL,
           f"context residuals: max rel err {ctx_rel:.3e} > {TOWER_RTOL}")
    _phase("train_csr_grads", tensors=len(names), batch=cfg.data.batch_size,
           context_images=b["context_images"].shape[0]
           * b["context_images"].shape[1],
           ctx_max_rel_err=f"{ctx_rel:.3e}",
           max_rel_err=f"{rel:.3e}", at=at, bound=TOWER_RTOL,
           e2e_max_rel_err=f"{e2e_rel:.3e}", e2e_at=e2e_at,
           kernel_s=f"{secs['auto']:.3f}", plain_s=f"{secs['plain']:.3f}")


def _vit_weights(d: int, heads: int, dtype, dev, gen):
    """An initialised ``TransformerBlock``'s attention and MLP weights in
    ``dtype``, with biases and LayerNorm affines moved off their zero and
    one initial values, as training moves them."""
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.vit import TransformerBlock

    blk = TransformerBlock(d, heads, device=dev)
    init_params(blk, gen)
    with torch.no_grad():
        for p in (blk.qkv_bias, blk.proj_bias, blk.fc1_bias, blk.fc2_bias,
                  blk.ln1_bias, blk.ln2_bias):
            p.normal_(0.0, 0.02, generator=gen)
        for p in (blk.ln1_scale, blk.ln2_scale):
            p.normal_(1.0, 0.02, generator=gen)

    def w(*ps):
        return tuple(p.detach().to(dtype).contiguous() for p in ps)

    return {"attn": w(blk.qkv_kernel, blk.qkv_bias, blk.proj_kernel,
                      blk.proj_bias, blk.ln1_scale, blk.ln1_bias),
            "mlp": w(blk.fc1_kernel, blk.fc1_bias, blk.fc2_kernel,
                     blk.fc2_bias, blk.ln2_scale, blk.ln2_bias)}


def attn_library(x, wqkv, bqkv, wo, bo, g, b, heads):
    """The attention sub-layer as a composition of PyTorch calls
    (``F.layer_norm``, ``F.linear``, ``F.scaled_dot_product_attention``):
    the yardstick timed beside the kernels (``library_ms``). The port never
    calls it."""
    F = torch.nn.functional
    bsz, seq, d = x.shape
    h = F.layer_norm(x, (d,), g, b, 1e-6)
    qkv = F.linear(h, wqkv.t(), bqkv).view(bsz, seq, 3, heads, d // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2)
    return x + F.linear(o.reshape(bsz, seq, d), wo.t(), bo)


def mlp_library(x, w1, b1, w2, b2, g, b):
    """The MLP sub-layer as a composition of PyTorch calls; a yardstick as
    :func:`attn_library`."""
    F = torch.nn.functional
    h = F.layer_norm(x, (x.shape[-1],), g, b, 1e-6)
    hidden = F.gelu(F.linear(h, w1.t(), b1), approximate="tanh")
    return x + F.linear(hidden, w2.t(), b2)


def _vit_fns(kind: str, heads: int):
    """(kernel, plain, library, kernel bwd, plain bwd) of one sub-layer, each
    taking (x, *weights[, dy])."""
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    if kind == "mlp":
        return (vb.mlp_block_fwd, vb.mlp_block_plain, mlp_library,
                vb.mlp_block_bwd, vb.mlp_block_bwd_plain)

    def bind(fn):
        return lambda x, *a: fn(x, *a[:6], heads, *a[6:])

    return tuple(bind(f) for f in (
        vb.attn_block_fwd, vb.attn_block_plain, attn_library,
        vb.attn_block_bwd, vb.attn_block_bwd_plain))


def _iters(ops: float) -> int:
    """Calls to time: about 0.5 TFLOP of work, 2 to 20 calls."""
    return max(2, min(20, int(5e11 / ops)))


def _dtype_name(dtype) -> str:
    return "fp32" if dtype == torch.float32 else "bf16"


def phase_kernels_vit(dev, gen, cases=VIT_CASES, row_keys=VIT_ROWS,
                      phase: str = "kernels_vit") -> dict:
    """Both forward kernels against their plain versions at ``cases``;
    returns the JSON rows of ``row_keys`` (by default ``VIT_ROWS``:
    mae_hd_1280's encoder and decoder, B=16, fp32)."""
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    rows = {}
    for b, l, d, heads, dtype in cases:
        weights = _vit_weights(d, heads, dtype, dev, gen)
        x = torch.randn(b, l, d, device=dev, generator=gen).to(dtype)
        for kind in ("attn", "mlp"):
            kernel, plain, library, _, _ = _vit_fns(kind, heads)
            args = (x, *weights[kind])
            work = vb.work(f"{kind}_fwd", b, l, d, heads, 4 * d)
            ops = sum(work)
            iters = _iters(ops)
            got = kernel(*args)
            _sync(dev)
            _check(got.shape == x.shape and got.dtype == dtype
                   and bool(torch.isfinite(got).all()),
                   f"vit_{kind}_fwd output shape, dtype or finiteness")
            err, scale = _max_err(got, plain(*args))
            _check(err <= VIT_RTOL[dtype] * scale,
                   f"vit_{kind}_fwd B={b} L={l} {dtype}: max abs err "
                   f"{err:.3e} > {VIT_RTOL[dtype]} x {scale:.3f}")
            t = _in_turns(lambda: plain(*args), lambda: kernel(*args),
                          iters, iters)
            lib_ms = device_ms(lambda: library(*args), iters)
            bound = _bound([*args, got], work, dtype)
            _phase(phase, kernel=f"vit_{kind}_fwd", B=b, L=l, d=d,
                   heads=heads, dtype=_dtype_name(dtype), err=f"{err:.3e}",
                   ms=f"{t['kernel']:.4f}", plain_ms=f"{t['plain']:.4f}",
                   library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound[0]:.4f}",
                   bound_by=bound[1], bound_on=bound[2],
                   tflops=f"{ops / t['kernel'] / 1e9:.2f}")
            if dtype == torch.float32 and (b, l) in row_keys:
                rows[f"vit_{kind}_fwd{row_keys[b, l][0]}"] = (
                    err, t["kernel"], t["plain"], *bound[:2], lib_ms)
            del got
    return rows


# The kernels of a ViT sub-layer call by part, as torch.profiler names them:
# the tensor-core GEMM, the attention core, the backward's dK/dV and dQ
# passes, the LayerNorm kernels and column sums; PyTorch's own kernels (the
# split-K partials' sums, copies) under "other". The Swin sub-layer's parts
# put its window core in the attention core's place. The CUDA-core GEMM
# and attention core are gone and must not run in any of them.
VIT_PARTS = (("gemm_tc", ("gemm_tc_kernel",)),
             ("core", ("attn_tc_fwd_kernel",)),
             ("dkv", ("attn_dkv_tc_kernel",)), ("dq", ("attn_dq_tc_kernel",)),
             ("ln_sums", ("ln_stats_kernel", "ln_apply_kernel",
                          "ln_bwd_kernel", "colsum_kernel")))
SWIN_PARTS = (VIT_PARTS[0], ("swin_core", ("swin_attn_core_kernel",)),
              ("ln", ("ln_stats_kernel", "ln_apply_kernel")))
SIMT_KERNELS = ("gemm_kernel", "attn_fwd_kernel")
# A split's profiles: at most this many, each with a spin kernel of this
# many cycles (about 25 ms on an H100) before and after the call.
PROFILE_ATTEMPTS = 3
PROFILE_SPIN = 50_000_000


def _named(key: str, names) -> bool:
    """Whether a kernel's profiler key holds one of ``names`` as a whole
    identifier (``gemm_kernel`` is not ``gemm_tc_kernel``)."""
    return any(re.search(rf"(?<!\w){n}(?!\w)", key) for n in names)


def _vit_parts(fn, what: str, names=VIT_PARTS) -> dict:
    """Device ms of one call of ``fn`` by part (``names``: ``VIT_PARTS``,
    or ``SWIN_PARTS``; the rest under "other"), from ``torch.profiler``;
    fails if a kernel of ``SIMT_KERNELS`` ran, or if no profile of
    ``PROFILE_ATTEMPTS`` adds up to within 20% of the call's time by CUDA
    events.

    The profiler can drop the first kernels it sees (a split of
    ``vit_attn_fwd`` once lost its 1.6 ms qkv GEMM), so each profile puts
    a spin kernel (``PROFILE_SPIN`` cycles, left out of the parts) on each
    side of the call, and a profile that still lost kernels is taken
    again."""
    from torch.profiler import ProfilerActivity, profile

    ms = device_ms(fn, 3)
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(PROFILE_SPIN)
            fn()
            torch.cuda._sleep(PROFILE_SPIN)
            torch.cuda.synchronize()
        parts = dict.fromkeys([name for name, _ in names] + ["other"], 0.0)
        for e in prof.key_averages():
            us = e.self_device_time_total
            if us <= 0 or _named(e.key, ("spin_kernel",)):
                continue
            _check(not _named(e.key, SIMT_KERNELS),
                   f"{what} launched the CUDA-core kernel {e.key}")
            name = next((n for n, k in names if _named(e.key, k)), "other")
            parts[name] += us / 1e3
        total = sum(parts.values())
        if abs(total - ms) <= 0.2 * ms:
            return parts
        _phase("profile_lost_kernels", call=what, attempt=attempt,
               parts_ms=f"{total:.4f}", events_ms=f"{ms:.4f}")
    _check(False, f"{what}'s kernels by part add up to {total:.4f} ms, not "
           f"the {ms:.4f} ms of its CUDA events, in {PROFILE_ATTEMPTS} "
           f"profiles")


def phase_kernels_vit_bwd(dev, gen, cases=VIT_CASES, row_keys=VIT_ROWS,
                          phase: str = "kernels_vit_bwd") -> dict:
    """Both backward kernels against the plain backwards at the fp32
    ``cases``, every output; ms of the kernel, of the plain backward and of
    the library composition's forward + backward. Returns the JSON rows of
    ``row_keys``."""
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    rows = {}
    for b, l, d, heads, dtype in cases:
        if dtype != torch.float32:
            continue
        weights = _vit_weights(d, heads, dtype, dev, gen)
        x = torch.randn(b, l, d, device=dev, generator=gen)
        dy = torch.randn(b, l, d, device=dev, generator=gen)
        for kind in ("attn", "mlp"):
            _, _, library, kernel, plain_bwd = _vit_fns(kind, heads)
            args = (x, *weights[kind])
            work = vb.work(f"{kind}_bwd", b, l, d, heads, 4 * d)
            ops = sum(work)
            iters = _iters(ops)
            got = kernel(*args, dy)
            want = plain_bwd(*args, dy)
            _sync(dev)
            errs = {}
            for name, g, wv in zip(VIT_GRADS[kind], got, want):
                _check(g.shape == wv.shape and g.dtype == torch.float32
                       and bool(torch.isfinite(g).all()),
                       f"vit_{kind}_bwd {name}: shape, dtype or finiteness")
                err, scale = _max_err(g, wv)
                _check(err <= BWD_RTOL * scale,
                       f"vit_{kind}_bwd B={b} L={l} {name}: max abs err "
                       f"{err:.3e} > {BWD_RTOL} x {scale:.3f}")
                errs[name] = err
            del want
            t = _in_turns(lambda: plain_bwd(*args, dy),
                          lambda: kernel(*args, dy), iters, iters)
            lib_leaves = [a.detach().clone().requires_grad_() for a in args]
            lib_ms = device_ms(lambda: torch.autograd.grad(
                library(*lib_leaves), lib_leaves, dy), iters)
            bound = _bound([*args, dy, *got], work)
            _phase(phase, kernel=f"vit_{kind}_bwd", B=b, L=l,
                   d=d, heads=heads,
                   errs=json.dumps({k: f"{v:.3e}" for k, v in errs.items()},
                                   separators=(",", ":")),
                   ms=f"{t['kernel']:.4f}", plain_ms=f"{t['plain']:.4f}",
                   library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound[0]:.4f}",
                   bound_by=bound[1], bound_on=bound[2],
                   tflops=f"{ops / t['kernel'] / 1e9:.2f}")
            row = (max(errs.values()), t["kernel"], t["plain"], *bound[:2],
                   lib_ms)
            if (b, l) in row_keys:
                rows[f"vit_{kind}_bwd{row_keys[b, l][0]}"] = row
            if kind == "attn" and b * l * d > 10**7 and dev.type == "cuda":
                parts = _vit_parts(lambda: kernel(*args, dy), "vit_attn_bwd")
                _phase("kernels_vit_bwd_parts", kernel="vit_attn_bwd", B=b,
                       L=l, d=d, heads=heads,
                       **{f"{k}_ms": f"{v:.4f}" for k, v in parts.items()})
            del got, lib_leaves
    return rows


def phase_kernels_vit_parts(dev, gen) -> None:
    """``vit_attn_fwd``, ``vit_mlp_fwd`` and ``vit_mlp_bwd`` split by kernel
    (``VIT_PARTS``) at the fp32 shapes of ``VIT_ROWS``, and both forwards
    at the bf16 case of ``VIT_CASES``, from ``torch.profiler``: one call
    each, after one to warm up, with the tensor-core GEMM's rate (its
    products over its time). None may launch a kernel of
    ``SIMT_KERNELS``."""
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    for b, l, d, heads, dtype in VIT_CASES:
        bf16 = dtype == torch.bfloat16
        if not bf16 and (b, l) not in VIT_ROWS:
            continue
        weights = _vit_weights(d, heads, dtype, dev, gen)
        x = torch.randn(b, l, d, device=dev, generator=gen).to(dtype)
        dy = torch.randn(b, l, d, device=dev, generator=gen)
        rows = b * l
        calls = [("vit_attn_fwd", 8 * rows * d * d,
                  lambda: vb.attn_block_fwd(x, *weights["attn"], heads)),
                 ("vit_mlp_fwd", 4 * rows * d * 4 * d,
                  lambda: vb.mlp_block_fwd(x, *weights["mlp"]))]
        if not bf16:  # the backward is fp32 only
            calls.append(("vit_mlp_bwd", 10 * rows * d * 4 * d,
                          lambda: vb.mlp_block_bwd(x, *weights["mlp"], dy)))
        for kernel, gemm_ops, fn in calls:
            parts = _vit_parts(fn, kernel)
            _phase("kernels_vit_parts", kernel=kernel, B=b, L=l, d=d,
                   heads=heads, dtype=_dtype_name(dtype),
                   total_ms=f"{sum(parts.values()):.4f}",
                   **{f"{k}_ms": f"{v:.4f}" for k, v in parts.items()},
                   gemm_tflops=f"{gemm_ops / parts['gemm_tc'] / 1e9:.2f}")
        del x, dy, weights


def phase_kernels_swin_parts(dev, gen) -> None:
    """``swin_attn_fwd`` at the kernels line's row (swin_large stage 2,
    B=64, shifted, fp32) split by kernel (``SWIN_PARTS``), with the
    tensor-core GEMM's rate. It runs beside ``kernels_vit_parts``, early in
    the process: after the training phases, the profiler lost the first
    kernels of this call in every attempt."""
    from medical_image_analysis_tpu_torch.ops import swin_block as sb

    name, embed, heads, images = SWIN_TOWERS[0]
    bn, d, nw = images * 4, embed << 2, 4
    x, w, bias, mask = _swin_inputs(bn, d, heads[2], nw, torch.float32, dev,
                                    gen)
    parts = _vit_parts(lambda: sb.swin_attn_fwd(x, *w, bias, mask, heads[2]),
                       "swin_attn_fwd", SWIN_PARTS)
    gemm_ops = 8 * bn * 49 * d * d  # q, k, v and the projection
    _phase("kernels_swin_parts", tower=name, stage=2, windows=bn, C=d,
           heads=heads[2], nW=nw, dtype="fp32",
           total_ms=f"{sum(parts.values()):.4f}",
           **{f"{k}_ms": f"{v:.4f}" for k, v in parts.items()},
           gemm_tflops=f"{gemm_ops / parts['gemm_tc'] / 1e9:.2f}")


def phase_train_mae(save_dir: Path, device: str = "cuda",
                    overrides=()) -> dict:
    """The mae_hd_1280 preset through the CLI for ``MAE_EPOCHS`` epochs;
    returns the model, the state, the overrides and the launch counts.
    ``overrides`` come after the phase's own (a CPU rehearsal shrinks the
    widths and the images with them)."""
    from medical_image_analysis_tpu_torch.models.vit import region_split

    sets = ("data.dataset=synthetic", f"train.epochs={MAE_EPOCHS}",
            f"train.save_state_every_epochs={MAE_EPOCHS + 1}",
            "train.log_every=1", f"train.save_dir={save_dir}", *overrides)
    argv = ["--config", str(MAE_PRESET)]
    for item in sets:
        argv += ["--set", item]
    run = _train_through_cli(argv, save_dir, device, epochs=MAE_EPOCHS,
                             validated=False)
    model, n_steps, cfg = run["model"], run["n_steps"], run["cfg"]
    l = model.num_patches(torch.empty(1, cfg["data"]["input_size"],
                                      cfg["data"]["input_size"], 1))
    idx_out, idx_in = region_split(l)
    keep = (int(len(idx_out) * (1 - cfg["model"]["mask_ratio"]))
            + int(len(idx_in) * (1 - cfg["model"]["mask_ratio_inner"])))

    # What the design implies: every TransformerBlock runs its attention and
    # MLP sub-layers through one forward and one backward wrapper call a
    # step (no remat, no validation).
    blocks = len(model.blocks) + len(model.decoder_blocks)
    _check_launches(
        run, dict.fromkeys(("vit_attn_fwd", "vit_mlp_fwd", "vit_attn_bwd",
                            "vit_mlp_bwd"), blocks * n_steps), "train_mae",
        f"{len(model.blocks)} encoder + {len(model.decoder_blocks)} decoder "
        f"blocks, each one attention and one MLP sub-layer forward and "
        f"backward, x {n_steps} steps")
    _phase("train_mae", preset=MAE_PRESET.name,
           params=sum(p.numel() for p in model.parameters()),
           encoder_tokens=1 + keep, decoder_tokens=1 + l, **run["fields"])
    return {"model": model, "state": run["state"],
            "launches": run["launches"], "overrides": sets}


def phase_train_mae_grads(model, overrides) -> None:
    """One batch of the preset's data with the first step's masking noise:
    the loss and every parameter's gradient through the kernels against
    the plain versions, forward and backward (``set_fused(model,
    False)``)."""
    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        flax_named_parameters,
    )
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.common import set_fused
    from medical_image_analysis_tpu_torch.ops import vit_block as vb
    from medical_image_analysis_tpu_torch.train.loop import (
        build_data,
        mae_loss_fn,
        mae_mask_noise,
    )

    cfg = load_config(str(MAE_PRESET), [*overrides, "data.num_workers=1"])
    _, _, batcher, _ = build_data(cfg)
    train_b = batcher("train")
    try:
        host = next(train_b.batches(shuffle=False))
    finally:
        train_b.close()
    dev = next(model.parameters()).device
    batch = cfg.data.batch_size
    imgs = torch.from_numpy(host["images"][:, 0]).to(dev)
    _check(imgs.shape[0] == batch, f"a batch of {imgs.shape[0]} images")
    noise = mae_mask_noise(cfg.train.seed, 0, batch, model.num_patches(imgs),
                           dev)
    loss_fn = mae_loss_fn(model, cfg.model)
    named = flax_named_parameters(model)
    names, tensors = list(named), list(named.values())
    blocks = len(model.blocks) + len(model.decoder_blocks)
    losses, grads, secs = {}, {}, {}
    for fused in (True, False):
        set_fused(model, fused)
        vb.reset_launches()
        t0 = time.perf_counter()
        loss = loss_fn({"images": imgs, "mask_noise": noise})
        grads[fused] = torch.autograd.grad(loss, tensors)
        _sync(dev)
        secs[fused] = time.perf_counter() - t0
        losses[fused] = loss.item()
        del loss
        if fused and dev.type == "cuda":
            _check(vb.launches == dict.fromkeys(vb.launches, blocks),
                   f"train_mae_grads launches {vb.launches}")
    set_fused(model, True)
    loss_rel = abs(losses[True] - losses[False]) / abs(losses[False])
    rel, at = _worst_rel(names, grads[True], grads[False])
    _check(loss_rel <= TOWER_RTOL,
           f"loss: rel err {loss_rel:.3e} > {TOWER_RTOL}")
    _check(rel <= TOWER_RTOL,
           f"grad of {at}: max rel err {rel:.3e} > {TOWER_RTOL}")
    _phase("train_mae_grads", tensors=len(names), batch=batch,
           loss=f"{losses[True]:.6f}", loss_rel_err=f"{loss_rel:.3e}",
           max_rel_err=f"{rel:.3e}", at=at, bound=TOWER_RTOL,
           kernel_s=f"{secs[True]:.3f}", plain_s=f"{secs[False]:.3f}")


# AM-MRG's bank chain: the small SwinCheX (embed 16, heads (2, 2), window
# 4, one unshifted block a stage) over its 8 images at 224^2: stage 0 with
# heads of 8 (196 windows of 16 tokens an image), stage 1 with heads of 16.
BANK_SWIN_CASES = (("bank_swinchex", 0, 8 * 196, 16, 2, 1, torch.float32, 4),
                   ("bank_swinchex", 1, 8 * 49, 32, 2, 1, torch.float32, 4))


def _swin_cases():
    """(tower, stage, windows, C, heads, nW, dtype, window): every stage of
    ``SWIN_TOWERS`` in fp32 (swin_large's shifted and unshifted where the
    stage has both, swin_base's shifted where it has one), and swin_large's
    stage 0, shifted, in bf16, all with 7 x 7 windows; then the bank
    chain's (``BANK_SWIN_CASES``). At stage 3 the window covers the 7 x 7
    map, so its blocks are unshifted."""
    cases = []
    for name, embed, heads, images in SWIN_TOWERS:
        for stage, h in enumerate(heads):
            per_image = (56 >> stage) ** 2 // 49
            shifts = [per_image] if per_image > 1 else []
            if per_image == 1 or name == "swin_large":
                shifts.append(1)  # the mask of an unshifted block: zeros
            cases += [(name, stage, images * per_image, embed << stage, h, nw,
                       torch.float32, 7) for nw in shifts]
    name, embed, heads, images = SWIN_TOWERS[0]
    return cases + [(name, 0, images * 64, embed, heads[0], 64,
                     torch.bfloat16, 7), *BANK_SWIN_CASES]


def _swin_inputs(windows, d, heads, nw, dtype, dev, gen, ws=7):
    """Windows (windows, ws^2, d) in ``dtype``, an initialised
    ``WindowAttention``'s weights with its biases, norm affine and bias
    table moved off their initial values, the (heads, L, L) bias and the
    (nW, L, L) shift mask of a map of sqrt(nW) windows a side (zeros (1, L,
    L) unshifted)."""
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.swin import (
        WindowAttention,
        _shift_attn_mask,
    )

    attn = WindowAttention(d, heads, ws, device=dev)
    init_params(attn, gen)
    with torch.no_grad():
        attn.relative_position_bias_table.normal_(0.0, 0.5, generator=gen)
        for p in (attn.qkv.bias, attn.proj.bias):
            p.normal_(0.0, 0.02, generator=gen)
        g = torch.randn(d, device=dev, generator=gen) * 0.02 + 1.0
        b = torch.randn(d, device=dev, generator=gen) * 0.02
        w = tuple(t.to(dtype).contiguous() for t in (
            attn.qkv.weight.t(), attn.qkv.bias, attn.proj.weight.t(),
            attn.proj.bias, g, b))
        bias = attn.rel_bias().contiguous()
    side = ws * int(round(nw**0.5))
    mask = (torch.from_numpy(_shift_attn_mask(side, side, ws, ws // 2)).to(
        dev) if nw > 1 else torch.zeros(1, ws * ws, ws * ws, device=dev))
    x = torch.randn(windows, ws * ws, d, device=dev, generator=gen).to(dtype)
    return x, w, bias, mask


def swin_attn_library(x, wqkv, bqkv, wo, bo, g, b, bias, mask, heads):
    """The Swin window-attention sub-layer as a composition of PyTorch
    calls, the bias and shift mask summed into SDPA's ``attn_mask``: the
    yardstick timed beside the kernel (``library_ms``). The port never
    calls it."""
    F = torch.nn.functional
    bn, l, d = x.shape
    nw = mask.shape[0]
    h = F.layer_norm(x, (d,), g, b, 1e-5)
    qkv = F.linear(h, wqkv.t(), bqkv).view(bn, l, 3, heads, d // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    am = (bias[None] + mask[:, None]).to(x.dtype)  # (nW, heads, L, L)
    am = am.expand(bn // nw, nw, heads, l, l).reshape(bn, heads, l, l)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=am).transpose(1, 2)
    return x + F.linear(o.reshape(bn, l, d), wo.t(), bo)


def phase_kernels_swin(dev, gen) -> dict:
    """The Swin kernel against its plain version at ``_swin_cases``;
    returns the JSON rows: swin_large's stage 2 (18 of its 24 blocks) at
    B=64, shifted, fp32 (``""``), and swin_base's stage 2 at 12 images,
    shifted, fp32 (``"_swin_b"``: r2gencsr_iu's, r2genkg_mimic's and
    mac_rrg_mimic's 6 studies x 2 views)."""
    from medical_image_analysis_tpu_torch.ops import swin_block as sb

    rows = {}
    for name, stage, bn, d, heads, nw, dtype, ws in _swin_cases():
        x, w, bias, mask = _swin_inputs(bn, d, heads, nw, dtype, dev, gen, ws)
        args = (x, *w, bias, mask, heads)
        work = sb.work(bn, ws * ws, d, heads)
        ops = sum(work)
        iters = _iters(ops)
        got = sb.swin_attn_fwd(*args)
        _sync(dev)
        _check(got.shape == x.shape and got.dtype == dtype
               and bool(torch.isfinite(got).all()),
               "swin_attn_fwd output shape, dtype or finiteness")
        err, scale = _max_err(got, sb.swin_attn_block_plain(*args))
        _check(err <= SWIN_RTOL[dtype] * scale,
               f"swin_attn_fwd {name} stage {stage} nW={nw} {dtype}: max abs "
               f"err {err:.3e} > {SWIN_RTOL[dtype]} x {scale:.3f}")
        t = _in_turns(lambda: sb.swin_attn_block_plain(*args),
                      lambda: sb.swin_attn_fwd(*args), iters, iters)
        lib_ms = device_ms(lambda: swin_attn_library(*args), iters)
        bound = _bound([x, *w, bias, mask, got], work, dtype)
        _phase("kernels_swin", tower=name, stage=stage, windows=bn,
               L=ws * ws, C=d, heads=heads, head_width=d // heads, nW=nw,
               dtype=_dtype_name(dtype),
               err=f"{err:.3e}", ms=f"{t['kernel']:.4f}",
               plain_ms=f"{t['plain']:.4f}", library_ms=f"{lib_ms:.4f}",
               bound_ms=f"{bound[0]:.4f}", bound_by=bound[1],
               bound_on=bound[2],
               tflops=f"{ops / t['kernel'] / 1e9:.2f}")
        if (stage, nw, dtype) == (2, 4, torch.float32):
            key = "" if name == "swin_large" else "_swin_b"
            rows[key] = (err, t["kernel"], t["plain"], *bound[:2], lib_ms)
        del got
    return rows


def _cls_through_cli(preset: str, save_dir: Path, device: str, overrides=()):
    """A classification preset for one epoch on ``synthetic_learnable``
    data through the CLI (``CLS_TRAIN`` train samples, the 64 val samples),
    ``overrides`` after the phase's own; returns ``_train_through_cli``'s
    result and the ``--set`` items."""
    sets = ("data.dataset=synthetic_learnable",
            f"data.synthetic_train_size={CLS_TRAIN[preset]}",
            "train.epochs=1", "train.save_state_every_epochs=2",
            "train.log_every=1", f"train.save_dir={save_dir}", *overrides)
    argv = ["--config", str(PRESET.parent / preset)]
    for item in sets:
        argv += ["--set", item]
    return {**_train_through_cli(argv, save_dir, device), "sets": sets}


def phase_train_cls(save_dir: Path, device: str = "cuda",
                    overrides=()) -> dict:
    """SwinCheX (the swinchex preset) for one epoch through the CLI; returns
    the run (model, state, launches, ``--set`` items)."""
    run = _cls_through_cli(CLS_PRESET.name, save_dir, device, overrides)
    model, n_steps, cfg = run["model"], run["n_steps"], run["cfg"]
    _check((cfg["train"]["mixup"], cfg["train"]["cutmix"]) == (0.8, 1.0),
           "swinchex without its mixup 0.8 / cutmix 1.0")
    # What the design implies: a training step needs a gradient through
    # every block, so it takes the unfused route (no launch); validation
    # runs under no_grad, one launch per block and val batch.
    blocks = sum(model.backbone.depths)
    val_batches = run["val_batches"]
    _check_launches(
        run, {"swin_attn_fwd": blocks * val_batches}, "train_cls",
        f"0 in {n_steps} training steps (unfused route); {blocks} blocks x "
        f"{val_batches} val batch(es) under no_grad")
    _phase("train_cls", preset=CLS_PRESET.name,
           params=sum(p.numel() for p in model.parameters()),
           images=cfg["data"]["input_size"], **run["fields"])
    return run


def _val_batch(preset: str, sets, dev) -> torch.Tensor:
    """The first validation batch's images (B, H, W, 3) of a classification
    preset's data, on ``dev``."""
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.train.loop import build_data

    cfg = load_config(str(PRESET.parent / preset), [*sets, "data.num_workers=1"])
    _, _, batcher, _ = build_data(cfg)
    vb = batcher("val")
    try:
        host = next(vb.batches(shuffle=False, drop_last=False))
    finally:
        vb.close()
    return torch.from_numpy(host["images"][:, 0]).to(dev)


def phase_tower_cls(model, sets) -> None:
    """One validation batch through the trained SwinCheX: logits through
    the kernel against the plain versions (``set_fused(model, False)``),
    in turns, wall seconds of each; then a forward and backward with a
    gradient, which must launch the kernel no time."""
    from medical_image_analysis_tpu_torch.models.common import set_fused
    from medical_image_analysis_tpu_torch.ops import swin_block as sb

    dev = next(model.parameters()).device
    imgs = _val_batch(CLS_PRESET.name, sets, dev)
    blocks = sum(model.backbone.depths)
    out, secs = {}, {}
    with torch.no_grad():
        for fused in (False, True, True, False):
            set_fused(model, fused)
            sb.reset_launches()
            _sync(dev)
            t0 = time.perf_counter()
            out[fused] = model(imgs)
            _sync(dev)
            secs[fused] = secs.get(fused, 0.0) + (time.perf_counter() - t0) / 2
            if fused and dev.type == "cuda":
                _check(sb.launches["swin_attn_fwd"] == blocks,
                       f"tower_cls launches {sb.launches}, expected {blocks}")
    set_fused(model, True)
    got, want = out[True], out[False]
    _check(bool(torch.isfinite(got).all()) and got.shape == want.shape
           == (imgs.shape[0], 14, 2), f"logits {tuple(got.shape)}")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    _check(rel <= TOWER_RTOL, f"tower_cls max rel err {rel:.3e} > "
           f"{TOWER_RTOL}")
    sb.reset_launches()
    model(imgs[:8]).float().sum().backward()
    model.zero_grad(set_to_none=True)
    _check(sb.launches["swin_attn_fwd"] == 0,
           f"{sb.launches['swin_attn_fwd']} launches with a gradient")
    _phase("tower_cls", batch=imgs.shape[0], shape=tuple(got.shape),
           max_rel_err=f"{rel:.3e}", bound=TOWER_RTOL, launches=blocks,
           grad_launches=0, kernel_s=f"{secs[True]:.3f}",
           plain_s=f"{secs[False]:.3f}")


def phase_train_cls_other(preset: str, save_dir: Path, device: str = "cuda",
                          overrides=()) -> dict:
    """``vssm_classify`` (phase ``train_cls_vssm``; ``train_cls_vssm_pallas``
    when ``overrides`` set ``scan_backend: pallas``) or ``dp_finetune``
    (``train_cls_dp``) for one epoch through the CLI, launches reckoned;
    returns the run."""
    run = _cls_through_cli(preset, save_dir, device, overrides)
    model, n_steps, val_b = run["model"], run["n_steps"], run["val_batches"]
    if preset == "vssm_classify.yaml" and VSSM_PALLAS in overrides:
        # every SS2D launches the general scan's forward kernel once per
        # forward and its backward once per step, the fused layer never;
        # no remat
        phase, blocks = "train_cls_vssm_pallas", sum(model.backbone.depths)
        _check(model.backbone.stage0_block0.op.scan_backend == "pallas",
               "vssm_classify not on scan_backend=pallas")
        reckoned = {"selective_scan_fwd": (n_steps + val_b) * blocks,
                    "selective_scan_bwd": n_steps * blocks}
        how = (f"{blocks} SS2D blocks x ({n_steps} steps + {val_b} val "
               f"batches) forward, x {n_steps} steps backward; 0 of the "
               f"fused layer")
    elif preset == "vssm_classify.yaml":
        # every SS2D (d_state 16, no conv in the fused layer) launches both
        # forward kernels once per forward and the backward once per step;
        # no remat
        phase, blocks = "train_cls_vssm", sum(model.backbone.depths)
        fwd = (n_steps + val_b) * blocks
        reckoned = {"mamba_xdbl": fwd, "mamba_scan": fwd,
                    "mamba_scan_bwd": n_steps * blocks}
        how = (f"{blocks} SS2D blocks x ({n_steps} steps + {val_b} val "
               f"batches) forward, x {n_steps} steps backward")
    else:
        # every TransformerBlock: one call of each forward wrapper per
        # forward, one of each backward wrapper per step
        phase, blocks = "train_cls_dp", len(model.encoder.blocks)
        reckoned = {
            **dict.fromkeys(("vit_attn_fwd", "vit_mlp_fwd"),
                            (n_steps + val_b) * blocks),
            **dict.fromkeys(("vit_attn_bwd", "vit_mlp_bwd"),
                            n_steps * blocks)}
        how = (f"{blocks} ViT blocks x ({n_steps} steps + {val_b} val "
               f"batches) forward, x {n_steps} steps backward")
    _check_launches(run, reckoned, phase, how)
    _phase(phase, preset=preset,
           params=sum(p.numel() for p in model.parameters()),
           ema=run["cfg"]["train"]["ema_decay"], **run["fields"])
    return run


def phase_train_csr_swin(vocab: int, save_dir: Path, device: str = "cuda",
                         overrides=()) -> dict:
    """R2GenCSR on its own Swin tower (the preset as it stands) for one
    epoch through the CLI; then, on the first training batch, both towers
    under no_grad (``encode_img`` and the context residuals, as validation
    runs them) through the kernel against the plain versions. Returns the
    run."""
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.common import set_fused
    from medical_image_analysis_tpu_torch.ops import swin_block as sb
    from medical_image_analysis_tpu_torch.train.loop import (
        _device_batch,
        build_data,
    )

    run = _csr_through_cli(vocab, save_dir, device, overrides)
    model, n_steps, val_b = run["model"], run["n_steps"], run["val_batches"]
    _check(run["cfg"]["model"]["vision"] == "swin", "not the Swin tower")
    # What the design implies: the study images need a gradient (the tower
    # trains), so they take the unfused route; the context images run
    # under no_grad, one launch per block a step; validation runs both
    # towers under no_grad.
    blocks = sum(model.vision.swin.depths)
    n_ctx = run["cfg"]["data"]["n_context"]
    _check_launches(
        run, {"swin_attn_fwd": blocks * (n_steps + 2 * val_b)},
        "train_csr_swin",
        f"{blocks} blocks x {n_steps} steps for the {2 * n_ctx} context "
        f"images per study (none for the study images: a gradient), + "
        f"{blocks} x 2 towers x {val_b} val batches")
    _phase("train_csr_swin", preset=CSR_PRESET.name, n_context=n_ctx,
           blocks=blocks, llm=f"{model.llm_cfg.dim}x{model.llm_cfg.n_layers}",
           params=sum(p.numel() for p in model.parameters()), **run["fields"])

    cfg = load_config(str(CSR_PRESET), [*run["sets"], "data.num_workers=1"])
    _, _, batcher, _ = build_data(cfg)
    train_b = batcher("train", n_context=cfg.data.n_context)
    try:
        host = next(train_b.batches(shuffle=False))
    finally:
        train_b.close()
    dev = next(model.parameters()).device
    b = _device_batch(host, dev)
    outs = {}
    with torch.no_grad():
        for fused in (True, False):
            set_fused(model, fused)
            sb.reset_launches()
            tok, glob = model.encode_img(b["images"])
            outs[fused] = (tok, glob, model.context_residuals(
                glob, b["context_images"]))
            if fused and dev.type == "cuda":
                _check(sb.launches["swin_attn_fwd"] == 2 * blocks,
                       f"train_csr_swin towers: launches {sb.launches}")
    set_fused(model, True)
    rel, at = _worst_rel(("image tokens", "global feature",
                          "context residuals"), outs[True], outs[False])
    _check(rel <= TOWER_RTOL, f"{at}: max rel err {rel:.3e} > {TOWER_RTOL}")
    _phase("train_csr_swin_towers", images=b["images"].shape[0]
           * b["images"].shape[1], context_images=b["context_images"].shape[0]
           * b["context_images"].shape[1], max_rel_err=f"{rel:.3e}", at=at,
           bound=TOWER_RTOL)
    return run


def _ss_case(dev, gen, batch: int, k: int, l: int, d: int, n: int, dtype):
    """The folded inputs of one general-scan call at a main-path shape: an
    initialised SS2D's A, D and delta bias (its 4 directions of d
    channels), u = silu(N(0, 1)) and delta ~ N(0, 0.5) in ``dtype``, and B
    and C read in place from a random (batch * k, L, R + 2N) x_dbl, as the
    models hand them over."""
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.vmamba import SS2D

    m = SS2D(d // 2, d_state=n, device=dev)
    init_params(m, gen)
    rows, r = batch * k, m.rank
    with torch.no_grad():
        a = -torch.exp(m.A_log.float())[:k].contiguous()
        dv, db = (p.detach()[:k].contiguous() for p in (m.D, m.dt_bias))
    u = torch.nn.functional.silu(
        torch.randn(rows, l, d, device=dev, generator=gen)).to(dtype)
    delta = (torch.randn(rows, l, d, device=dev, generator=gen)
             * 0.5).to(dtype)
    x_dbl = torch.randn(rows, l, r + 2 * n, device=dev, generator=gen)
    x_dbl = x_dbl.to(dtype)
    return u, delta, a, x_dbl[..., r : r + n], x_dbl[..., r + n :], dv, db


def _ss_cases(kind: str):
    """(case, batch, K, L, D, N, dtype): ARM-B at the phase's batches in
    fp32 and bf16, vssm_tiny's four stages at B=128 in fp32, stage 0 in
    bf16."""
    k, l, d, n = SS_ARM
    cases = [("arm_b", b, k, l, d, n, dtype) for b in SS_ARM_BATCH[kind]
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(f"vssm_tiny_s{i}", SS_VSSM_BATCH, 4, l, d, 16, torch.float32)
              for i, (l, d) in enumerate(SS_VSSM_STAGES)]
    return cases + [("vssm_tiny_s0", SS_VSSM_BATCH, 4, *SS_VSSM_STAGES[0],
                     16, torch.bfloat16)]


def phase_kernels_ss(dev, gen, kind: str) -> tuple:
    """The general scan's forward (``kind="fwd"``, phase ``kernels_ss``) or
    backward kernel (``"bwd"``, ``kernels_ss_bwd``) against its plain
    version at ``_ss_cases``, every output: fp32 outputs within BWD_RTOL
    (1e-4) of max(1, max |plain|), outputs rounded to bf16 on both sides
    within one bf16 step (Y_RTOL). Each line also gives the kernel's
    resident blocks an SM and shared memory a block on this card; the
    forward's also its grid and the waves it makes. The plain versions
    hold B=128, so every case compares and times at the batch it prints.
    Returns the JSON row: vssm_tiny's stage 0 at B=128, fp32, the longest
    chain of the main path (no library call computes the scan:
    ``library_ms`` null)."""
    from medical_image_analysis_tpu_torch.ops import selective_scan_pallas as ssp

    row = None
    occupancy = {}
    names = (("y",) if kind == "fwd" else
             ("du", "ddelta", "dA", "dB", "dC", "dD", "ddelta_bias"))
    for case, b, k, l, d, n, dtype in _ss_cases(kind):
        args = _ss_case(dev, gen, b, k, l, d, n, dtype)
        if kind == "fwd":
            def plain():
                return (ssp.selective_scan_fwd_plain(*args, True),)

            def kernel():
                return (ssp.selective_scan_fwd(*args, True),)
            extra = []
        else:
            dy = torch.randn(b * k, l, d, device=dev, generator=gen).to(dtype)

            def plain():
                return ssp.selective_scan_bwd_plain(*args, dy, True)

            def kernel():
                return ssp.selective_scan_bwd(*args, dy, True)
            extra = [dy]
        want, got = plain(), kernel()
        _sync(dev)
        errs = {}
        for name, g, w in zip(names, got, want):
            _check(g.shape == w.shape and g.dtype == w.dtype
                   and bool(torch.isfinite(g).all()),
                   f"selective_scan_{kind} {name}: shape, dtype or finiteness")
            err, scale = _max_err(g, w)
            tol = Y_RTOL[g.dtype] if g.dtype == torch.bfloat16 else BWD_RTOL
            _check(err <= tol * scale,
                   f"selective_scan_{kind} {case} B={b} {dtype} {name}: max "
                   f"abs err {err:.3e} > {tol} x {scale:.3f}")
            errs[name] = err
        del want
        t = _in_turns(plain, kernel, 1, 20 if case == "arm_b" else 3)
        bound = _bound([*args, *extra, *got],
                       ssp.flops(kind, b * k, l, d, n))
        if kind == "bwd":  # resident blocks an SM, shared memory a block
            blocks, smem = ssp.bwd_occupancy(n, dtype)
            _check(blocks >= SS_BWD_MIN_BLOCKS,
                   f"selective_scan_bwd N={n} {dtype}: {blocks} blocks an SM "
                   f"(at least {SS_BWD_MIN_BLOCKS}), {smem} bytes of shared "
                   f"memory a block")
            occupancy = dict(blocks_per_sm=blocks, smem_bytes=smem)
        elif dev.type == "cuda":
            blocks, smem = ssp.fwd_occupancy(n, dtype)
            grid = ssp.fwd_grid_blocks(b * k, d)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            occupancy = dict(blocks_per_sm=blocks, smem_bytes=smem,
                             grid_blocks=grid,
                             waves=f"{grid / (blocks * sms):.2f}")
        _phase("kernels_ss" if kind == "fwd" else "kernels_ss_bwd",
               case=case, B=b, K=k, L=l, D=d, N=n, src=_dtype_name(dtype),
               errs=json.dumps({k_: f"{v:.3e}" for k_, v in errs.items()},
                               separators=(",", ":")),
               ms=f"{t['kernel']:.4f}", plain_ms=f"{t['plain']:.4f}",
               bound_ms=f"{bound[0]:.4f}", bound_by=bound[1], **occupancy)
        if (case, b, dtype) == ("vssm_tiny_s0", SS_VSSM_BATCH, torch.float32):
            row = (max(errs.values()), t["kernel"], t["plain"], *bound[:2])
        del args, got, extra
        torch.cuda.empty_cache()
    return row


def phase_tower_arm_pallas(dev, gen) -> dict:
    """``r2gengpt_mimic``'s ARM-B tower on ``scan_backend=pallas``
    (``build_mrg_model`` with that ``--set``; random weights from the seed;
    the LLM, which this phase does not run, cut to one layer and a
    1,000-token vocabulary) on one micro-batch of 3 samples x 2 views at
    224^2, remat on as the preset trains: ``encode_img`` forward and a
    backward from one cotangent at the projector's output, through the
    kernels and through ``pallas_plain``. The tower's and projector's
    gradients must agree within TOWER_RTOL (``train_grads``'s bound); the
    gap to the fused layer (``auto``, whose x_dbl is fp32 by design) is
    printed, not bounded. Returns the kernel run's launch counts."""
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.mamba import set_scan_backend
    from medical_image_analysis_tpu_torch.train.loop import build_mrg_model

    cfg = load_config(str(PRESET), [VSSM_PALLAS,
                                    "model.llm_kwargs={n_layers: 1}"])
    model = build_mrg_model(cfg, 1000, device=dev)
    init_params(model, gen)
    arm = model.vision.arm
    depth = len(arm.layers)
    _check(arm.remat and arm.layers[0].mixer.scan_backend == "pallas",
           "the ARM tower is not on remat + scan_backend=pallas")
    micro = cfg.data.batch_size // cfg.train.accum_steps
    size = cfg.data.input_size
    images = torch.randn(micro, cfg.data.num_views, size, size, 3,
                         device=dev, generator=gen)
    named = [(n, p) for n, p in model.named_parameters()
             if n.startswith(("vision.", "proj"))]
    names, tensors = [n for n, _ in named], [p for _, p in named]
    cot = None
    for backend in ("pallas", "pallas_plain", "auto"):
        # warm-up: each route's first forward and backward, with their
        # one-time set-up, kept out of the timed runs below
        set_scan_backend(model, backend)
        out = model.encode_img(images)
        if cot is None:
            cot = torch.randn(out.shape, device=dev, generator=gen)
        torch.autograd.grad(out, tensors, cot)
        del out
    grads, secs, launches = {}, {}, None
    for backend in ("pallas", "pallas_plain", "auto"):
        set_scan_backend(model, backend)
        _reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        out = model.encode_img(images)
        grads[backend] = torch.autograd.grad(out, tensors, cot)
        _sync(dev)
        secs[backend] = time.perf_counter() - t0
        if backend == "pallas":
            launches = _all_launches()
            want = {k: 0 for k in launches}
            want.update(selective_scan_fwd=2 * depth,
                        selective_scan_bwd=depth)
            print(f"tower_arm_pallas: launches reckoned: {depth} layers x 2 "
                  f"forwards (remat) and {depth} backwards -> "
                  f"{json.dumps(want, separators=(',', ':'))}", flush=True)
            if dev.type != "cuda":  # CPU tensors take the plain versions
                want = dict.fromkeys(want, 0)
            _check(launches == want, f"tower_arm_pallas launches {launches}")
        del out
    rel, at = _worst_rel(names, grads["pallas"], grads["pallas_plain"])
    fused_rel, fused_at = _worst_rel(names, grads["pallas"], grads["auto"])
    _check(rel <= TOWER_RTOL,
           f"tower_arm_pallas grad of {at}: max rel err {rel:.3e} > "
           f"{TOWER_RTOL}")
    _phase("tower_arm_pallas", images=micro * cfg.data.num_views,
           layers=depth, tensors=len(names), max_rel_err=f"{rel:.3e}", at=at,
           bound=TOWER_RTOL, fused_gap=f"{fused_rel:.3e}", fused_at=fused_at,
           kernel_s=f"{secs['pallas']:.3f}",
           plain_s=f"{secs['pallas_plain']:.3f}",
           fused_s=f"{secs['auto']:.3f}")
    return launches


def phase_kernels_attn(dev, gen) -> tuple:
    """``fused_attention`` (its kernel route) against ``attention_plain`` at
    ViT-B's widths (B=64, L=197, 12 heads of 64), fp32 and bf16, without a
    mask and with a causal one, q, k and v read in place from one (B, L, 3,
    H, hd) product: max error against ATTN_RTOL, ms of the kernel, the
    plain version and ``library_ms`` (``F.scaled_dot_product_attention``
    with the mask as ``attn_mask``), the bound and TFLOP/s. Then ViT-B at
    384^2 (L=577), where the dispatch takes the einsum route: 0 launches.
    Then the kernel's wrapper at ``ATTN_CHECKS`` (every head width, L = 50
    and 1,401), fp32 and bf16, with and without the mask, against the plain
    version. Returns the JSON row (fp32, no mask)."""
    from medical_image_analysis_tpu_torch.ops import attention as att

    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, l, h, hd = ATTN_VIT_B
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        for masked in (False, True):
            qkv = torch.randn(b, l, 3, h, hd, device=dev, generator=gen)
            q, k, v = qkv.to(dtype).unbind(2)
            mask = (torch.full((l, l), float("-inf"), device=dev).triu(1)
                    if masked else None)
            before = att.launches["fused_attention"]
            got = att.fused_attention(q, k, v, mask)
            _sync(dev)
            _check(att.launches["fused_attention"]
                   == before + (dev.type == "cuda"),
                   "fused_attention did not take its kernel route")
            _check(got.shape == q.shape and got.dtype == dtype
                   and bool(torch.isfinite(got).all()),
                   "fused_attention output shape, dtype or finiteness")
            err, scale = _max_err(got, att.attention_plain(q, k, v, mask))
            _check(err <= ATTN_RTOL[dtype] * scale,
                   f"fused_attention {dtype} mask={masked}: max abs err "
                   f"{err:.3e} > {ATTN_RTOL[dtype]} x {scale:.3f}")
            work = att.work(b, l, h, hd)
            ops = sum(work)
            iters = _iters(ops)
            t = _in_turns(lambda: att.attention_plain(q, k, v, mask),
                          lambda: att.fused_attention(q, k, v, mask),
                          iters, iters)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            am = None if mask is None else mask.to(dtype)
            lib_ms = device_ms(lambda: sdpa(qt, kt, vt, attn_mask=am), iters)
            bound = _bound([q, k, v, mask, got], work, dtype)
            _phase("kernels_attn", B=b, L=l, heads=h, hd=hd,
                   dtype=_dtype_name(dtype),
                   mask="causal" if masked else "none", err=f"{err:.3e}",
                   ms=f"{t['kernel']:.4f}", plain_ms=f"{t['plain']:.4f}",
                   library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound[0]:.4f}",
                   bound_by=bound[1], bound_on=bound[2],
                   tflops=f"{ops / t['kernel'] / 1e9:.2f}")
            if dtype == torch.float32 and not masked:
                row = (err, t["kernel"], t["plain"], *bound[:2], lib_ms)
    for (b, l, h, hd), dtype, masked in itertools.product(
            ATTN_CHECKS, (torch.float32, torch.bfloat16), (False, True)):
        qkv = torch.randn(b, l, 3, h, hd, device=dev, generator=gen)
        q, k, v = qkv.to(dtype).unbind(2)
        mask = (torch.full((l, l), float("-inf"), device=dev).triu(1)
                if masked else None)
        got = att.attention_fwd(q, k, v, mask)
        _sync(dev)
        _check(got.shape == q.shape and got.dtype == dtype
               and bool(torch.isfinite(got).all()),
               "attention_fwd output shape, dtype or finiteness")
        err, scale = _max_err(got, att.attention_plain(q, k, v, mask))
        _check(err <= ATTN_RTOL[dtype] * scale,
               f"attention_fwd B={b} L={l} hd={hd} {dtype} mask={masked}: "
               f"max abs err {err:.3e} > {ATTN_RTOL[dtype]} x {scale:.3f}")
        _phase("kernels_attn", B=b, L=l, heads=h, hd=hd,
               dtype=_dtype_name(dtype), mask="causal" if masked else "none",
               err=f"{err:.3e}", checked=True)
        del qkv, q, k, v, got
    b, l, h, hd = ATTN_EINSUM
    q, k, v = torch.randn(3, b, l, h, hd, device=dev, generator=gen).unbind(0)
    before = att.launches["fused_attention"]
    out = att.fused_attention(q, k, v)
    _sync(dev)
    _check(att.launches["fused_attention"] == before,
           "the einsum route launched the kernel")
    _check(out.shape == q.shape and bool(torch.isfinite(out).all()),
           "einsum route output shape or finiteness")
    _phase("kernels_attn", B=b, L=l, heads=h, hd=hd, dtype="fp32",
           route="einsum", tile_bytes=8 * l * l * 4, launches=0)
    return row


def phase_attn(dev, gen) -> dict:
    """``models/vit.py:Attention(768, 12)`` on (64, 197, 768) with seeded
    weights (biases moved off zero): the module through the kernel against
    ``set_fused(model, False)`` within ATTN_RTOL, then a forward and
    backward with a gradient, which must launch the kernel no time. Returns
    the kernel run's launch counts (the counts at 0 just before it)."""
    from medical_image_analysis_tpu_torch.models.common import (
        init_params,
        set_fused,
    )
    from medical_image_analysis_tpu_torch.models.vit import Attention
    from medical_image_analysis_tpu_torch.ops import attention as att

    b, l, h, hd = ATTN_VIT_B
    m = Attention(h * hd, h, device=dev)
    init_params(m, gen)
    with torch.no_grad():
        for p in (m.qkv.bias, m.proj.bias):
            p.normal_(0.0, 0.02, generator=gen)
    x = torch.randn(b, l, h * hd, device=dev, generator=gen)
    out, secs = {}, {}
    for fused in (True, False):
        set_fused(m, fused)
        _reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            out[fused] = m(x)
        _sync(dev)
        secs[fused] = time.perf_counter() - t0
        if fused:
            launches = _all_launches()
            want = dict.fromkeys(launches, 0)
            want["fused_attention"] = int(dev.type == "cuda")
            _check(launches == want, f"attn launches {launches}")
    set_fused(m, True)
    err, scale = _max_err(out[True], out[False])
    _check(err <= ATTN_RTOL[torch.float32] * scale,
           f"attn: max abs err {err:.3e} > {ATTN_RTOL[torch.float32]} x "
           f"{scale:.3f}")
    att.reset_launches()
    m(x).sum().backward()
    _sync(dev)
    _check(att.launches["fused_attention"] == 0,
           f"{att.launches['fused_attention']} launches with a gradient")
    _phase("attn", shape=tuple(x.shape), heads=h, max_abs_err=f"{err:.3e}",
           bound=ATTN_RTOL[torch.float32], launches=1, grad_launches=0,
           kernel_s=f"{secs[True]:.4f}", plain_s=f"{secs[False]:.4f}")
    return launches


# MambaXray-VL's pretraining stages. The fused layer's shapes there: AR
# pretraining's one scan direction over 8 clusters of 16 tokens (192^2
# images, patch 16: a 12 x 12 grid, 3 x 3 clusters, the last one left out)
# at ar_pretrain's batch of 12, and CLIP alignment's ARM-B (4 directions,
# 196 patches + cls) at clip_align's contrastive batch of 32; D=768, N=16,
# R=48 in both. (name, K, B, L).
AR_PRESET = PRESET.parent / "ar_pretrain.yaml"
CLIP_PRESET = PRESET.parent / "clip_align.yaml"
PRETRAIN_SHAPES = (("ar_pretrain", 1, 12, 128), ("clip_align", 4, 32, 197))
AR_EPOCHS = 2  # 2 steps an epoch of the synthetic train split at batch 12
CLIP_EPOCHS = 3  # 1 step an epoch at batch 32
# r2gengpt_mimic grafted from the CLIP stage at 12 studies a step (its two
# micro-batches of 6 studies x 2 views), so that the 32 synthetic samples
# give 2 steps
CHAIN_BATCH = 12


def _pretrain_layer(dev, gen, k_dirs: int, b: int, seq_len: int,
                    dim: int = 768, expand: int = 1, d_state: int = 16):
    """An initialised one- or four-direction mixer of width ``dim`` (ARM-B's
    D=768, N=16, R=48, expand 1; ARM-L's D=1024, R=64; the Mamba LM's
    d_model 768 at expand 2, so d_inner 1536) and ``d_state``, and N(0, 1)
    sources and cotangent of its shape: (xdbl args, scan args, backward
    args, the mixer)."""
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.mamba import MambaMixer
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    mixer = MambaMixer(dim, d_state=d_state, expand=expand,
                       bimamba_type="none" if k_dirs == 1 else "v3",
                       device=dev)
    init_params(mixer, gen)
    w = _layer_weights(mixer)
    x = torch.randn(b, seq_len, mixer.d_inner, device=dev, generator=gen)
    xc = (mixer._col_major(x, (seq_len - 1) // 2).contiguous()
          if k_dirs == 4 else None)
    dy = torch.randn(b, k_dirs, seq_len, mixer.d_inner, device=dev,
                     generator=gen)
    xargs = (x, xc, w["conv_w"], w["conv_b"], w["x_proj_w"])
    with torch.no_grad():
        x_dbl = mf.xdbl_plain(*xargs)
    sargs = (x, xc, x_dbl, w["conv_w"], w["conv_b"], w["dt_proj_w"],
             w["dt_bias"], w["A"], w["D"])
    return xargs, sargs, (*sargs, dy), mixer


def phase_kernels_ar(dev, gen) -> None:
    """The fused layer's three kernels against their plain versions at the
    AR pretraining shape (K=1) and the CLIP shape (K=4, B=32), fp32 as
    both train (``_fused_cases``)."""
    _fused_cases(dev, gen, "kernels_ar", PRETRAIN_SHAPES)


def phase_kernels_am(dev, gen) -> dict:
    """The fused layer's three kernels at AM-MRG's ARM-L shapes (K=4,
    L=197, D=1024, N=16, R=64, so C=96): the training step's 12 images,
    timed, and one image (``fwd_chunk`` cuts L there); returns the 12-image
    rows for the kernels line."""
    rows = _fused_cases(dev, gen, "kernels_am", AM_SHAPES, ARM_L_DIM)
    return {f"{k}_arm_l": v for k, v in rows[AM_SHAPES[0][0]].items()}


def _fused_cases(dev, gen, phase: str, shapes, dim: int = 768,
                 expand: int = 1, d_state: int = 16) -> dict:
    """The fused layer's three kernels against their plain versions at
    each ``(name, K, B, L)`` of ``shapes`` (a mixer of width ``dim``,
    ``expand`` and ``d_state``, fp32): max errors within XDBL_RTOL, Y_RTOL
    and BWD_RTOL;
    the device ms of each beside its plain version's (in turns) and its
    bound; x_dbl's tile, and each kernel's grid blocks and resident blocks
    an SM. Returns
    ``{name: {kernel: (err, ms, plain_ms, bound_ms, bound_by)}}``."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    rows = {}
    for name, k_dirs, b, seq_len in shapes:
        xargs, sargs, bargs, mixer = _pretrain_layer(
            dev, gen, k_dirs, b, seq_len, dim, expand, d_state)
        n, rank, d_in = mixer.n, mixer.rank, mixer.d_inner
        got_x, want_x = mf.xdbl_fwd(*xargs), sargs[2]
        got_y, want_y = mf.scan_fwd(*sargs), mf.scan_plain(*sargs)
        got_b, want_b = mf.scan_bwd(*bargs), mf.scan_bwd_plain(*bargs)
        _sync(dev)
        err_x, scale_x = _max_err(got_x, want_x)
        err_y, scale_y = _max_err(got_y, want_y)
        _check(err_x <= XDBL_RTOL * scale_x,
               f"mamba_xdbl {name}: max abs err {err_x:.3e} > {XDBL_RTOL} "
               f"x {scale_x:.3f}")
        _check(err_y <= Y_RTOL[torch.float32] * scale_y,
               f"mamba_scan {name}: max abs err {err_y:.3e} > "
               f"{Y_RTOL[torch.float32]} x {scale_y:.3f}")
        errs = _bwd_errs(got_b, want_b, name)
        del want_y, want_b
        t = {
            "xdbl": _in_turns(lambda: mf.xdbl_plain(*xargs),
                              lambda: mf.xdbl_fwd(*xargs), 5, 50),
            "scan": _in_turns(lambda: mf.scan_plain(*sargs),
                              lambda: mf.scan_fwd(*sargs), 1, 20),
            "bwd": _in_turns(lambda: mf.scan_bwd_plain(*bargs),
                             lambda: mf.scan_bwd(*bargs), 1, 10)}
        elems = b * k_dirs * seq_len * d_in
        c = got_x.shape[-1]
        bounds = {
            "xdbl": _bound([*xargs, got_x], _xdbl_work(elems, c, True)),
            "scan": _bound([*sargs, got_y], elems * _mamba_ops(rank, n)),
            "bwd": _bound([*bargs, *got_b], _mamba_bwd_ops(
                b, k_dirs, seq_len, d_in, n, rank))}
        fields = {}
        for kernel in ("xdbl", "scan", "bwd"):
            fields.update({
                f"{kernel}_ms": f"{t[kernel]['kernel']:.4f}",
                f"{kernel}_plain_ms": f"{t[kernel]['plain']:.4f}",
                f"{kernel}_bound_ms": f"{bounds[kernel][0]:.4f}",
                f"{kernel}_bound_by": bounds[kernel][1]})
        bwd_blocks = _mamba_bwd_blocks(b, k_dirs, seq_len, d_in, n, rank,
                                       torch.float32)
        rows[name] = {
            f"mamba_{kernel}": (err, t[key]["kernel"], t[key]["plain"],
                                *bounds[key][:2])
            for kernel, key, err in (("xdbl", "xdbl", err_x),
                                     ("scan", "scan", err_y),
                                     ("scan_bwd", "bwd", max(errs.values())))}
        _phase(phase, shape=name, B=b, K=k_dirs, L=seq_len, D=d_in,
               N=n, R=rank, src="fp32", xdbl_err=f"{err_x:.3e}",
               scan_err=f"{err_y:.3e}", bwd_errs=_compact(
                   {k: f"{v:.3e}" for k, v in errs.items()}), **fields,
               **_xdbl_blocks(b, k_dirs, seq_len, d_in, c, torch.float32,
                              True, xargs[2].shape[1]),
               **_mamba_fwd_blocks(b, k_dirs, seq_len, d_in, n, rank,
                                   torch.float32),
               bwd_grid_blocks=bwd_blocks["grid_blocks"],
               bwd_blocks_per_sm=bwd_blocks["blocks_per_sm"],
               bwd_smem_bytes=bwd_blocks["smem_bytes"])
        del xargs, sargs, bargs, got_x, got_y, got_b
        torch.cuda.empty_cache()
    return rows


def _pretrain_through_cli(preset: Path, epochs: int, save_dir: Path,
                          device: str, sets=(), check_start=None) -> dict:
    """A pretraining preset on the synthetic data for ``epochs`` through the
    CLI, its train state written once at the end; returns
    ``_train_through_cli``'s result with the state's path and the ``--set``
    items."""
    sets = ("data.dataset=synthetic", f"train.epochs={epochs}",
            f"train.save_state_every_epochs={epochs}", "train.log_every=1",
            f"train.save_dir={save_dir}", *sets)
    argv = ["--config", str(preset)]
    for item in sets:
        argv += ["--set", item]
    run = _train_through_cli(argv, save_dir, device, epochs=epochs,
                             validated=False, check_start=check_start)
    artifact = save_dir / f"state_epoch{epochs - 1:05d}.pt"
    _check(artifact.exists(), f"{preset.name}: no train state written")
    return {**run, "artifact": artifact, "sets": sets}


def _fused_reckoning(run: dict, phase: str, layers: int, forwards: int,
                     backwards: int, how: str) -> None:
    _check_launches(run, {"mamba_xdbl": layers * forwards,
                          "mamba_scan": layers * forwards,
                          "mamba_scan_bwd": layers * backwards}, phase, how)


def phase_train_ar(save_dir: Path, device: str = "cuda",
                   overrides=()) -> dict:
    """The ar_pretrain preset (``VisionMambaAR`` at its class defaults:
    ARM-B's widths, one scan direction, 192^2 images, B=12, fp32) through
    the CLI for ``AR_EPOCHS`` epochs; every loss finite, every parameter
    moved, each fused kernel launched once a layer a step (no remat, no
    validation). Returns the run."""
    run = _pretrain_through_cli(AR_PRESET, AR_EPOCHS, save_dir, device,
                                overrides)
    model, n_steps = run["model"], run["n_steps"]
    depth = len(model.layers)
    _check(all(layer.mixer.k == 1 for layer in model.layers),
           "the AR encoder's mixers are not one-direction")
    _fused_reckoning(run, "train_ar", depth, n_steps, n_steps,
                     f"{depth} layers x {n_steps} steps, one forward and "
                     f"one backward each")
    _phase("train_ar", preset=AR_PRESET.name,
           params=sum(p.numel() for p in model.parameters()),
           images=run["cfg"]["data"]["input_size"],
           tokens=_ar_tokens(run["cfg"]),
           **run["fields"])
    return run


def _ar_tokens(cfg: dict) -> int:
    """The AR encoder's sequence: every 4x4 cluster of patches but the
    last."""
    grid = cfg["data"]["input_size"] // (cfg["model"]["vision_kwargs"] or {}
                                         ).get("patch_size", 16)
    return ((grid // 4) ** 2 - 1) * 16


def phase_train_ar_grads(model, sets) -> None:
    """One batch of the preset's data (12 images) at full width: the loss
    and every parameter's gradient through the kernels against
    ``scan_backend="plain"``, within TOWER_RTOL of each tensor's largest.
    The decoder's key biases have a gradient of 0 in exact arithmetic (a
    softmax is unchanged by a shift along its keys): their rounding noise
    is held to TOWER_RTOL of the largest gradient of any tensor
    instead."""
    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        flax_named_parameters,
    )
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.mamba import set_scan_backend
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf
    from medical_image_analysis_tpu_torch.train.loop import build_data

    cfg = load_config(str(AR_PRESET), [*sets, "data.num_workers=1"])
    _, _, batcher, _ = build_data(cfg)
    train_b = batcher("train")
    try:
        host = next(train_b.batches(shuffle=False))
    finally:
        train_b.close()
    dev = next(model.parameters()).device
    imgs = torch.from_numpy(host["images"][:, 0]).to(dev)
    named = flax_named_parameters(model)
    names, tensors = list(named), list(named.values())
    depth = len(model.layers)
    losses, grads, secs = {}, {}, {}
    for backend in ("auto", "plain"):
        set_scan_backend(model, backend)
        mf.reset_launches()
        t0 = time.perf_counter()
        loss = model(imgs)
        grads[backend] = torch.autograd.grad(loss, tensors)
        _sync(dev)
        secs[backend] = time.perf_counter() - t0
        losses[backend] = loss.item()
        if backend == "auto" and dev.type == "cuda":
            _check(mf.launches == dict.fromkeys(mf.launches, depth),
                   f"train_ar_grads launches {mf.launches}")
    set_scan_backend(model, "auto")
    keys = [i for i, n in enumerate(names) if n.endswith("/k/bias")]
    rest = [i for i in range(len(names)) if i not in keys]
    loss_rel = abs(losses["auto"] - losses["plain"]) / abs(losses["plain"])
    rel, at = _worst_rel([names[i] for i in rest],
                         [grads["auto"][i] for i in rest],
                         [grads["plain"][i] for i in rest])
    largest = max(g.abs().max().item() for g in grads["plain"])
    key_noise = max(grads[b][i].abs().max().item() for b in grads
                    for i in keys) / largest
    _check(loss_rel <= TOWER_RTOL,
           f"loss: rel err {loss_rel:.3e} > {TOWER_RTOL}")
    _check(rel <= TOWER_RTOL,
           f"grad of {at}: max rel err {rel:.3e} > {TOWER_RTOL}")
    _check(key_noise <= TOWER_RTOL,
           f"key biases' gradients {key_noise:.3e} of the largest")
    _phase("train_ar_grads", tensors=len(names), batch=imgs.shape[0],
           loss=f"{losses['auto']:.6f}", loss_rel_err=f"{loss_rel:.3e}",
           max_rel_err=f"{rel:.3e}", at=at, bound=TOWER_RTOL,
           key_bias_grad_rel=f"{key_noise:.3e}",
           kernel_s=f"{secs['auto']:.3f}", plain_s=f"{secs['plain']:.3f}")


def _flat_state(path: Path) -> dict:
    state = torch.load(path, map_location="cpu", weights_only=True)["state"]
    return {**state["frozen"], **state["params"]}


def _grafted_check(prefix: str, source: dict, tile: int):
    """``check_start`` of a grafted run: every tensor of ``source`` (an
    earlier stage's tower by flax path; a mixer's direction-leading
    tensors tiled to ``tile`` directions) sits at ``prefix``/name in the
    model, bit for bit. Computed here from the artifact, not through
    ``ckpt/bridge.py``."""
    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        flax_named_parameters,
    )

    leading = ("A_log", "D", "conv_b", "conv_w", "dt_bias", "dt_proj_w",
               "x_proj_w")

    def check(model, state):
        named = flax_named_parameters(model)
        for name, want in source.items():
            if tile > 1 and "/mixer/" in name and name.endswith(leading):
                want = want.repeat(tile, *([1] * (want.dim() - 1)))
            got = named[f"{prefix}/{name}"].detach()
            _check(torch.equal(got.cpu(), want.to(got.dtype)),
                   f"{prefix}/{name} is not the grafted tensor")
        return {"grafted": len(source)}

    return check


def phase_train_clip(ar_artifact: Path, save_dir: Path, device: str = "cuda",
                     overrides=()) -> dict:
    """The clip_align preset (ARM-B at 224^2 beside the scratch text tower,
    B=32 studies, max_len 128, fp32) with ``model.vision_init`` set to the
    AR stage's train state, through the CLI for ``CLIP_EPOCHS`` epochs (1
    step each: the batch is the 32 training samples). Before the first
    step every AR encoder tensor (patch embed, each layer's norm and mixer)
    must sit in ``visual_encoder``, the mixers tiled to four directions;
    then every parameter moves and each fused kernel launches once a layer
    a step. Returns the run."""
    ar = _flat_state(ar_artifact)
    encoder = {n: t for n, t in ar.items()
               if n.startswith(("patch_embed/", "layers_"))}
    run = _pretrain_through_cli(
        CLIP_PRESET, CLIP_EPOCHS, save_dir, device,
        (f"model.vision_init={ar_artifact}", *overrides),
        _grafted_check("visual_encoder", encoder, 4))
    model, n_steps = run["model"], run["n_steps"]
    depth = len(model.visual_encoder.layers)
    _fused_reckoning(run, "train_clip", depth, n_steps, n_steps,
                     f"{depth} ARM layers x {n_steps} steps, one forward "
                     f"and one backward each (no remat)")
    _phase("train_clip", preset=CLIP_PRESET.name,
           params=sum(p.numel() for p in model.parameters()),
           text_tokens=run["cfg"]["data"]["max_len"], **run["fields"])
    return run


def phase_stage_chain(vocab: int, clip_artifact: Path, save_dir: Path,
                      device: str = "cuda", overrides=()) -> dict:
    """Stage 3: the r2gengpt_mimic preset at full width (ARM-B + the
    1.8B-parameter LLM, LoRA r16, accumulation 2, remat) with
    ``model.vision_init`` set to the CLIP stage's train state, at
    CHAIN_BATCH studies a step for 2 steps, no validation. Before the
    first step every ``visual_encoder`` tensor of the CLIP state must sit
    in ``vision/arm``; launches are reckoned as ``train``'s."""
    clip = _flat_state(clip_artifact)
    tower = {n.split("/", 1)[1]: t for n, t in clip.items()
             if n.startswith("visual_encoder/")}
    sets = ("data.dataset=synthetic", f"data.batch_size={CHAIN_BATCH}",
            f"model.llm_kwargs.vocab_size={vocab}",
            f"model.vision_init={clip_artifact}", "train.epochs=1",
            "train.val_every_epochs=2", "train.save_state_every_epochs=2",
            "train.log_every=1", f"train.save_dir={save_dir}", *overrides)
    argv = ["--config", str(PRESET)]
    for item in sets:
        argv += ["--set", item]
    run = _train_through_cli(
        argv, save_dir, device, validated=False,
        check_start=_grafted_check("vision/arm", tower, 1))
    model, n_steps = run["model"], run["n_steps"]
    accum = run["cfg"]["train"]["accum_steps"]
    depth = len(model.vision.arm.layers)
    _fused_reckoning(run, "stage_chain", depth, n_steps * accum * 2,
                     n_steps * accum,
                     f"{depth} layers x {n_steps} steps x {accum} "
                     f"micro-batches x 2 forwards (remat) and 1 backward")
    _phase("stage_chain", preset=PRESET.name, accum=accum, **run["fields"])
    return run


# AM-MRG and R2GenKG at their presets' full widths. ARM-L's fused layer:
# (name, K, B, L) at D=1024 (R=64, C=96): the training step's 6 studies x
# 2 views, and one image.
AM_PRESET = PRESET.parent / "am_mrg_mimic.yaml"
KG_PRESET = PRESET.parent / "r2genkg_mimic.yaml"
ARM_L_DIM = 1024
AM_SHAPES = (("am_mrg", 4, 12, 197), ("am_mrg_b1", 4, 1, 197))
ARM_L_CASE = "am_mrg ARM-L B=12 L=197"
# Validation's generated length in the two phases (the presets ask for 80
# to 120 tokens of beam 3; the LLM and its beam are those of ``train``)
MRG_GEN = ("generate.max_new_tokens=40", "generate.min_new_tokens=20")
# The key biases (R2Gen's memory's ``attn_k`` too), and the Hopfield
# memories' stored-pattern norm biases: gradients of 0 in exact arithmetic
# (no update step reads the keys)
ZERO_GRAD = re.compile(r"(/|^)(key|k|k_proj|attn_k|norm_stored)/bias$")


def _side_record(save_dir: Path) -> dict | None:
    """The side inputs' shapes and build seconds that ``fit_mrg`` logs, if
    the task has side inputs."""
    with open(save_dir / "log.txt") as f:
        return next((r for r in map(json.loads, f) if "side_inputs" in r),
                    None)


def _mrg_through_cli(preset: Path, vocab: int, save_dir: Path, device: str,
                     overrides=(), gen=MRG_GEN) -> dict:
    """A report-generation preset on the synthetic data for one epoch and
    one validation through the CLI, at the LLM vocabulary ``vocab`` (None:
    the preset has no LLM) and the generation settings ``gen`` (the
    preset's own where empty); returns ``_train_through_cli``'s result with
    the ``--set`` items and the side-input record."""
    llm = () if vocab is None else (f"model.llm_kwargs.vocab_size={vocab}",)
    sets = ("data.dataset=synthetic", *llm, "train.epochs=1",
            "train.save_state_every_epochs=2", "train.log_every=1",
            f"train.save_dir={save_dir}", *gen, *overrides)
    argv = ["--config", str(preset)]
    for item in sets:
        argv += ["--set", item]
    run = _train_through_cli(argv, save_dir, device)
    return {**run, "sets": sets, "side": _side_record(save_dir)}


def phase_train_am_mrg(vocab: int, save_dir: Path, device: str = "cuda",
                       overrides=()) -> dict:
    """The am_mrg_mimic preset at full width (ARM-L, qformer_proj to 1408,
    the 12-layer Q-Former of 14 queries, two Hopfield memories of 6 heads,
    the 1.8B-parameter LLM frozen with LoRA r16, remat, 6 studies x 2
    views) through the CLI: 5 steps and one validation, the memory banks
    built on the card first (GradCAM over the small SwinCheX for each of
    the 14 labels). Launches: each ARM-L layer's forward kernels twice a
    step (remat) and its backward once, once a validation batch; the
    Swin kernel once a SwinCheX block a GradCAM."""
    from medical_image_analysis_tpu_torch.data.side_inputs import (
        CAM_CLASSES,
        CAM_SWIN,
    )

    run = _mrg_through_cli(AM_PRESET, vocab, save_dir, device, overrides)
    model, n_steps, val_b = run["model"], run["n_steps"], run["val_batches"]
    accum = run["cfg"]["train"]["accum_steps"]
    depth = len(model.vision.layers)
    cam = CAM_CLASSES * sum(CAM_SWIN["depths"])
    fwd = n_steps * depth * accum * 2 + val_b * depth
    _check_launches(
        run, {"mamba_xdbl": fwd, "mamba_scan": fwd,
              "mamba_scan_bwd": n_steps * depth * accum,
              "swin_attn_fwd": cam},
        "train_am_mrg",
        f"{n_steps} steps x {depth} layers x {accum} micro-batches x 2 "
        f"forwards (remat) and 1 backward, + {val_b} val batches x {depth}; "
        f"the bank chain's {CAM_CLASSES} GradCAMs x "
        f"{sum(CAM_SWIN['depths'])} SwinCheX blocks")
    _phase("train_am_mrg", preset=AM_PRESET.name,
           arm=f"{model.vision.norm_f.normalized_shape[0]}x{depth}",
           rank=model.vision.layers[0].mixer.rank,
           llm=f"{model.llm_cfg.dim}x{model.llm_cfg.n_layers}",
           params=sum(p.numel() for p in model.parameters()),
           banks=_compact(run["side"]["side_inputs"]),
           side_s=f"{run['side']['side_s']:.2f}", **run["fields"])
    return run


# The modules AMMRG.encode_img reads, copied to float64 for the yardstick
# of train_am_mrg_grads
AM_ENCODE = ("vision", "qformer_proj", "qformer", "visual_memory",
             "report_memory", "visual_proj", "query_proj", "dmem_proj",
             "rmem_proj")


def phase_train_am_mrg_grads(model, state, sets) -> None:
    """One batch of AM-MRG's data at full width (6 studies x 2 views): the
    gradients of every trainable tensor before the LLM (ARM-L, the
    Q-Former and its projection, both memories, the four projections)
    through the kernels, through ``scan_backend="plain"`` and through the
    plain path in float64 (``AM_ENCODE`` copied to fp64, the batch, banks
    and cotangent cast), from one cotangent at ``encode_img``'s output (as
    ``train_grads``). Each tensor is held to fp64 (``_grads_vs_plain``):
    the kernel path within TOWER_RTOL of each tensor's largest, or no
    farther than twice the fp32 plain path. The plain path's own gap to
    fp64 passes 1e-3 on nearly cancelling gradients (PERF.md §6: at
    ``PYTHONHASHSEED=98``, 1.079e-3 on
    ``visual_memory/assoc/norm_state/bias``, the kernel path 6.48e-4); the
    data follow Python's salted ``hash``, so each process reads other
    images. The tensors of 0 gradient in exact
    arithmetic (``ZERO_GRAD``) within TOWER_RTOL of the largest gradient.
    The banks are built again from the run's seed."""
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.mamba import set_scan_backend
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf
    from medical_image_analysis_tpu_torch.train.loop import (
        _device_batch,
        build_data,
        make_task_adapter,
    )

    dev = next(model.parameters()).device
    cfg = load_config(str(AM_PRESET), [*sets, "data.num_workers=1"])
    ann, tok, batcher, loader = build_data(cfg)
    banks = make_task_adapter(cfg, ann, tok, loader, dev).side
    train_b = batcher("train")
    try:
        host = next(train_b.batches(shuffle=False))
    finally:
        train_b.close()
    b = _device_batch(host, dev)
    names = [n for n in state.params
             if n.startswith("base/") and not n.startswith("base/llm/")]
    tensors = [state.params[n] for n in names]

    def encode():
        return model.encode_img(b["images"], banks["visual_bank"],
                                banks["report_bank"])

    def loss_of(img):
        prompt = model._wrap(img, b["before_ids"], b["after_ids"])
        return model._loss(prompt, b["target_ids"], b["target_mask"])

    set_scan_backend(model, "plain")
    img = encode().detach().requires_grad_()
    (cotangent,) = torch.autograd.grad(loss_of(img), img)
    grads, secs = {}, {}
    for path, backend in (("kernel", "auto"), ("plain", "plain")):
        set_scan_backend(model, backend)
        mf.reset_launches()
        t0 = time.perf_counter()
        grads[path] = torch.autograd.grad(encode(), tensors, cotangent)
        _sync(dev)
        secs[path] = time.perf_counter() - t0
        if path == "kernel" and dev.type == "cuda":
            depth = len(model.vision.layers)
            _check(mf.launches == {"mamba_xdbl": 2 * depth,
                                   "mamba_scan": 2 * depth,
                                   "mamba_scan_bwd": depth},
                   f"train_am_mrg_grads launches {mf.launches}")
    set_scan_backend(model, "auto")
    # the yardstick: the plain path in float64 on the same batch
    m64 = copy.copy(model)
    m64._modules = dict(model._modules)
    for name in AM_ENCODE:
        m64._modules[name] = copy.deepcopy(model._modules[name]).double()
    set_scan_backend(m64.vision, "plain")
    by_name = dict(m64.named_parameters())
    torch_name = {id(p): n for n, p in model.named_parameters()}
    t0 = time.perf_counter()
    grads["fp64"] = torch.autograd.grad(
        m64.encode_img(b["images"].double(), banks["visual_bank"].double(),
                       banks["report_bank"].double()),
        [by_name[torch_name[id(t)]] for t in tensors], cotangent.double())
    _sync(dev)
    secs["fp64"] = time.perf_counter() - t0
    del m64, by_name
    _phase("train_am_mrg_grads",
           **_grads_vs_plain(names, grads, "train_am_mrg_grads"),
           images=b["images"].shape[0] * b["images"].shape[1],
           kernel_s=f"{secs['kernel']:.3f}", plain_s=f"{secs['plain']:.3f}",
           fp64_s=f"{secs['fp64']:.3f}")


def phase_train_r2genkg(vocab: int, save_dir: Path, device: str = "cuda",
                        overrides=()) -> dict:
    """The r2genkg_mimic preset at full width (Swin-B, the 2-layer Q-Former
    of 14 queries, the lookup into the disease bank, 5 R-GCNs, the fusion,
    the cross blocks, the 1.8B-parameter LLM frozen with LoRA r16, 6
    studies x 2 views) through the CLI: 5 steps and one validation, the
    graph tensors built on the card first. The Swin kernel launches once a
    block a validation batch and never in a training step (the tower
    trains, so its blocks take the unfused route)."""
    run = _mrg_through_cli(KG_PRESET, vocab, save_dir, device, overrides)
    model, val_b = run["model"], run["val_batches"]
    blocks = sum(model.vision.swin.depths)
    _check_launches(run, {"swin_attn_fwd": blocks * val_b}, "train_r2genkg",
                    f"{blocks} Swin blocks x {val_b} val batches, none in "
                    f"the {run['n_steps']} steps (a gradient)")
    _phase("train_r2genkg", preset=KG_PRESET.name,
           swin=f"{model.vision.out_dim}x{blocks}",
           llm=f"{model.llm_cfg.dim}x{model.llm_cfg.n_layers}",
           params=sum(p.numel() for p in model.parameters()),
           graph=_compact(run["side"]["side_inputs"]),
           side_s=f"{run['side']['side_s']:.2f}", **run["fields"])
    return run


EMRRG_PRESET = PRESET.parent / "emrrg_iu.yaml"
R2GEN_PRESET = PRESET.parent / "r2gen_iu.yaml"
# EMRRG trains ARM-B at 6 studies x 2 views a step, without remat: the fused
# layer's (name, K, B, L) there
EMRRG_SHAPES = (("emrrg", 4, 12, 197),)
EMRRG_CASE = "emrrg_iu ARM-B B=12 L=197"
# R2Gen trains ViT-B/16 at 16 studies x 2 views of 224^2 (196 patches + cls)
R2GEN_VIT_CASES = ((32, 197, 768, 12, torch.float32),)
R2GEN_ROWS = {(32, 197): ("_r2gen", "r2gen_iu ViT-B/16 B=32 L=197")}


def phase_kernels_emrrg(dev, gen) -> dict:
    """The fused layer's three kernels at EMRRG's training shape (ARM-B,
    K=4, L=197, D=768, N=16, R=48, 12 images, fp32) against their plain
    versions, timed in turns (``_fused_cases``); returns the rows for the
    kernels line."""
    rows = _fused_cases(dev, gen, "kernels_emrrg", EMRRG_SHAPES)
    return {f"{k}_emrrg": v for k, v in rows[EMRRG_SHAPES[0][0]].items()}


def phase_kernels_r2gen(dev, gen) -> dict:
    """The four ViT kernels against their plain versions at R2Gen's
    training shape (ViT-B/16: B=32, L=197, d=768, 12 heads, fp32), every
    output, with the bound and the ``attn_library``/``mlp_library``
    compositions' times; returns the rows for the kernels line."""
    rows = phase_kernels_vit(dev, gen, R2GEN_VIT_CASES, R2GEN_ROWS,
                             "kernels_r2gen")
    rows.update(phase_kernels_vit_bwd(dev, gen, R2GEN_VIT_CASES, R2GEN_ROWS,
                                      "kernels_r2gen_bwd"))
    return rows


def phase_train_emrrg(vocab: int, save_dir: Path, device: str = "cuda",
                      overrides=()) -> dict:
    """The emrrg_iu preset at full width (ARM-B; qwen1_5_0_5b frozen but for
    its hybrid layers 0, 4, ..., 20; no LoRA, no remat; 6 studies x 2
    views) through the CLI: 5 steps and one validation at the preset's
    beam 3 and 100 new tokens (at least 60). The trainable LLM tensors are
    fp32 masters, the frozen ones in the LLM's dtype. Launches: each ARM-B
    layer's two forward kernels once a step and once a validation batch,
    its backward once a step."""
    run = _mrg_through_cli(EMRRG_PRESET, vocab, save_dir, device, overrides,
                           gen=())
    model, state = run["model"], run["state"]
    n_steps, val_b = run["n_steps"], run["val_batches"]
    depth = len(model.vision.layers)
    lm = model.llm_cfg
    hybrid = sorted({int(n.split("/")[1].split("_")[1])
                     for n in state.params if n.startswith("llm/")})
    _check(hybrid == list(range(0, lm.n_layers, model.cross_every)),
           f"trainable LLM layers {hybrid}")
    _check(all(p.dtype == torch.float32 for n, p in state.params.items()
               if n.startswith("llm/")), "a trainable LLM tensor is not fp32")
    _check(all(p.dtype == lm.dtype for n, p in state.frozen.items()
               if n.startswith("llm/layers_") and n.endswith("/kernel")),
           f"a frozen LLM kernel is not {lm.dtype}")
    _fused_reckoning(run, "train_emrrg", depth, n_steps + val_b, n_steps,
                     f"{depth} layers x ({n_steps} steps + {val_b} val "
                     f"batches) forward, x {n_steps} steps backward (no "
                     f"remat)")
    g = run["cfg"]["generate"]
    _phase("train_emrrg", preset=EMRRG_PRESET.name,
           arm=f"{model.vision.norm_f.normalized_shape[0]}x{depth}",
           llm=f"{lm.dim}x{lm.n_layers}", hybrid_layers=_compact(hybrid),
           params=sum(p.numel() for p in model.parameters()),
           gen=f"beam{g['num_beams']}_{g['min_new_tokens']}to"
               f"{g['max_new_tokens']}", **run["fields"])
    return run


@contextmanager
def _llm_compute(lm, dtype):
    """The LM computing in ``dtype`` for the block (every ``Dense``'s
    compute dtype and every config's ``dtype``), then as before."""
    from medical_image_analysis_tpu_torch.models.llm import Dense

    dense = [(m, m.compute_dtype) for m in lm.modules()
             if isinstance(m, Dense)]
    cfgs = [(m, m.cfg) for m in lm.modules() if hasattr(m, "cfg")]
    try:
        for m, _ in dense:
            m.compute_dtype = dtype
        for m, c in cfgs:
            m.cfg = dataclasses.replace(c, dtype=dtype)
        yield
    finally:
        for m, dt in dense:
            m.compute_dtype = dt
        for m, c in cfgs:
            m.cfg = c


def _grads_vs_plain(names, grads, phase: str) -> dict:
    """The kernel path's gradients against the plain path's: the largest
    relative error over ``names`` within TOWER_RTOL of each tensor's
    largest, and those of 0 in exact arithmetic (``ZERO_GRAD``) within
    TOWER_RTOL of the largest gradient. With ``grads["fp64"]``, the plain
    path's gradients in float64, each tensor but the ``ZERO_GRAD`` ones is
    held to fp64 instead: the kernel path within TOWER_RTOL of fp64
    (relative to fp64's largest of the tensor), or no farther from fp64
    than twice the fp32 plain path is (``_fp64_gaps``). Returns the fields
    to print."""
    zero = [i for i, n in enumerate(names) if ZERO_GRAD.search(n)]
    rest = [i for i in range(len(names)) if i not in zero]
    rel, at = _worst_rel([names[i] for i in rest],
                         [grads["kernel"][i] for i in rest],
                         [grads["plain"][i] for i in rest])
    largest = max(g.abs().max().item() for g in grads["plain"])
    noise = max((grads[k][i].abs().max().item() for k in ("kernel", "plain")
                 for i in zero), default=0.0) / largest
    fields = dict(tensors=len(names), zero_grad=len(zero),
                  max_rel_err=f"{rel:.3e}", at=at, bound=TOWER_RTOL)
    if "fp64" in grads:
        fields.update(_fp64_gaps(names, grads, rest, phase))
    else:
        _check(rel <= TOWER_RTOL,
               f"{phase}: grad of {at}: max rel err {rel:.3e} > {TOWER_RTOL}")
    _check(noise <= TOWER_RTOL,
           f"{phase}: zero-gradient tensors at {noise:.3e} of the largest")
    return dict(fields, zero_grad_rel=f"{noise:.3e}")


def _fp64_gaps(names, grads, rest, phase: str) -> dict:
    """Each tensor of ``rest`` held to the float64 plain path: its kernel
    gap max |g_kernel - g_fp64| / max |g_fp64| within the larger of
    TOWER_RTOL and twice its plain gap (the same for the fp32 plain path).
    A nearly cancelling gradient is one that fp32 itself cannot give to
    TOWER_RTOL; there the kernel path passes when it is as near fp64 as
    fp32 can be. Returns the worst tensor (by kernel gap over its bound)
    with both gaps."""
    worst = (-1.0, "", 0.0, 0.0)
    for i in rest:
        want = grads["fp64"][i]
        scale = want.abs().max().clamp_min(1e-300)
        _check(bool(torch.isfinite(want).all()),
               f"non-finite fp64 grad of {names[i]}")
        k_gap, p_gap = (((grads[k][i].double() - want).abs().max()
                         / scale).item() for k in ("kernel", "plain"))
        margin = k_gap / max(TOWER_RTOL, 2.0 * p_gap)
        worst = max(worst, (margin, names[i], k_gap, p_gap))
    margin, at, k_gap, p_gap = worst
    _check(margin <= 1.0,
           f"{phase}: grad of {at}: the kernel path {k_gap:.3e} from fp64, "
           f"past {TOWER_RTOL} and twice the fp32 plain path's {p_gap:.3e}")
    return dict(fp64_at=at, kernel_vs_fp64=f"{k_gap:.3e}",
                plain_vs_fp64=f"{p_gap:.3e}", fp64_margin=f"{margin:.3f}")


def _first_batch(preset: Path, sets, dev) -> dict:
    """The first training batch of the preset's synthetic data, on
    ``dev``."""
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.train.loop import (
        _device_batch,
        build_data,
    )

    cfg = load_config(str(preset), [*sets, "data.num_workers=1"])
    _, _, batcher, _ = build_data(cfg)
    train_b = batcher("train")
    try:
        return _device_batch(next(train_b.batches(shuffle=False)), dev)
    finally:
        train_b.close()


def phase_train_emrrg_grads(model, state, sets) -> None:
    """One batch of EMRRG's data at full width (6 studies x 2 views): the
    loss's gradient of every trainable tensor (ARM-B, ``proj_norm``,
    ``proj``, ``fast_proj``, the hybrid layers) through the kernels against
    ``scan_backend="plain"`` (``_grads_vs_plain``). For the check the LLM
    computes in fp32: in bf16 it would round the two paths' 1e-6 gap in
    the vision tokens into a few percent of every gradient."""
    from medical_image_analysis_tpu_torch.models.mamba import set_scan_backend
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    dev = next(model.parameters()).device
    b = _first_batch(EMRRG_PRESET, sets, dev)
    names = list(state.params)
    tensors = [state.params[n] for n in names]
    depth = len(model.vision.layers)
    grads, secs = {}, {}
    with _llm_compute(model.llm, torch.float32):
        for path, backend in (("kernel", "auto"), ("plain", "plain")):
            set_scan_backend(model, backend)
            mf.reset_launches()
            t0 = time.perf_counter()
            loss = model(b["images"], b["before_ids"], b["after_ids"],
                         b["target_ids"], b["target_mask"])
            grads[path] = torch.autograd.grad(loss, tensors)
            _sync(dev)
            secs[path] = time.perf_counter() - t0
            del loss
            if path == "kernel" and dev.type == "cuda":
                _check(mf.launches == dict.fromkeys(mf.launches, depth),
                       f"train_emrrg_grads launches {mf.launches}")
    set_scan_backend(model, "auto")
    fields = _grads_vs_plain(names, grads, "train_emrrg_grads")
    _phase("train_emrrg_grads", **fields,
           hybrid=sum(n.startswith("llm/") for n in names),
           images=b["images"].shape[0] * b["images"].shape[1],
           kernel_s=f"{secs['kernel']:.3f}", plain_s=f"{secs['plain']:.3f}")


def phase_train_r2gen(save_dir: Path, device: str = "cuda",
                      overrides=()) -> dict:
    """The r2gen_iu preset at full width (ViT-B/16 at 224^2; R2Gen of
    d_model 512, 3 layers, 8 heads, a relational memory of 3 slots; 16
    studies x 2 views, fp32) through the CLI: 2 steps and one validation
    at the preset's beam 3 and 60 new tokens, each step of which re-decodes
    the prefix. Launches: each ViT block's two forward kernels once a step
    and once a validation batch, its two backward kernels once a step."""
    run = _mrg_through_cli(R2GEN_PRESET, None, save_dir, device, overrides,
                           gen=())
    model, n_steps, val_b = run["model"], run["n_steps"], run["val_batches"]
    blocks = len(model.vision.vit.blocks)
    _check_launches(
        run, {**dict.fromkeys(("vit_attn_fwd", "vit_mlp_fwd"),
                              (n_steps + val_b) * blocks),
              **dict.fromkeys(("vit_attn_bwd", "vit_mlp_bwd"),
                              n_steps * blocks)}, "train_r2gen",
        f"{blocks} ViT blocks x ({n_steps} steps + {val_b} val batches) "
        f"forward, x {n_steps} steps backward")
    r, g = model.r2gen, run["cfg"]["generate"]
    _phase("train_r2gen", preset=R2GEN_PRESET.name,
           vit=f"{model.vision.out_dim}x{blocks}",
           r2gen=f"{r.d_model}x{r.num_layers}", slots=r.rm.num_slots,
           params=sum(p.numel() for p in model.parameters()),
           gen=f"beam{g['num_beams']}_{g['max_new_tokens']}",
           **run["fields"])
    return run


def phase_train_r2gen_grads(model, sets) -> None:
    """One batch of R2Gen's data at full width (16 studies x 2 views): the
    ViT's gradients through its kernels against the plain versions
    (``set_fused(model, False)``), both driven by one cotangent at the
    averaged patch tokens (``_grads_vs_plain``); the two paths' tokens and
    losses within TOWER_RTOL as well.

    That cotangent is the loss's gradient w.r.t. the tokens, taken once
    (plain path), as ``train_grads`` takes it. Taken through the whole
    model instead, the two paths' gradients differ by up to a few 1e-3 of
    a tensor's largest: a ReLU of R2Gen (``enc_ff<i>a``, ``dec_ff<i>a``)
    switches where its input lies within the tokens' 1e-6 gap of 0, and
    each switch moves that layer's gradient by one token's share. A 1e-6
    perturbation of the tokens does the same with no kernel in the way.
    R2Gen is plain PyTorch on both paths; its whole-model gap is printed
    (``e2e_``), not bounded."""
    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        flax_named_parameters,
    )
    from medical_image_analysis_tpu_torch.models.common import set_fused
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    dev = next(model.parameters()).device
    b = _first_batch(R2GEN_PRESET, sets, dev)
    named = flax_named_parameters(model)
    names = [n for n in named if n.startswith("vision/")]
    tensors = [named[n] for n in names]
    everything = [n for n in named if not ZERO_GRAD.search(n)]
    blocks = len(model.vision.vit.blocks)

    def loss_of(att):
        return model.report_loss(att, b["target_ids"], b["target_mask"])

    set_fused(model, False)
    att = model.att_feats(b["images"]).detach().requires_grad_()
    (cotangent,) = torch.autograd.grad(loss_of(att), att)
    del att
    grads, feats, losses, e2e, secs = {}, {}, {}, {}, {}
    for path, fused in (("kernel", True), ("plain", False)):
        set_fused(model, fused)
        vb.reset_launches()
        t0 = time.perf_counter()
        out = model.att_feats(b["images"])
        grads[path] = torch.autograd.grad(out, tensors, cotangent)
        _sync(dev)
        secs[path] = time.perf_counter() - t0
        if fused and dev.type == "cuda":
            _check(vb.launches == dict.fromkeys(vb.launches, blocks),
                   f"train_r2gen_grads launches {vb.launches}")
        feats[path] = out.detach()
        del out
        loss = model(b["images"], b["target_ids"], b["target_mask"])
        e2e[path] = torch.autograd.grad(loss, [named[n] for n in everything])
        losses[path] = loss.item()
        del loss
    set_fused(model, True)
    feat_rel = ((feats["kernel"] - feats["plain"]).abs().max()
                / feats["plain"].abs().max()).item()
    _check(feat_rel <= TOWER_RTOL,
           f"train_r2gen_grads: tokens rel err {feat_rel:.3e} > {TOWER_RTOL}")
    loss_rel = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    _check(loss_rel <= TOWER_RTOL,
           f"train_r2gen_grads: loss rel err {loss_rel:.3e} > {TOWER_RTOL}")
    fields = _grads_vs_plain(names, grads, "train_r2gen_grads")
    e2e_rel, e2e_at = _worst_rel(everything, e2e["kernel"], e2e["plain"])
    _phase("train_r2gen_grads", **fields,
           images=b["images"].shape[0] * b["images"].shape[1],
           tokens_rel_err=f"{feat_rel:.3e}",
           loss=f"{losses['kernel']:.6f}", loss_rel_err=f"{loss_rel:.3e}",
           e2e_max_rel_err=f"{e2e_rel:.3e}", e2e_at=e2e_at,
           kernel_s=f"{secs['kernel']:.3f}", plain_s=f"{secs['plain']:.3f}")


LM_PRESET = PRESET.parent / "mamba_lm_sft.yaml"
MAC_PRESET = PRESET.parent / "mac_rrg_mimic.yaml"
# The Mamba LM's fused layer: one direction, d_model 768 at expand 2
# (d_inner 1536, R=48, C=80), 16 reports of 128 tokens a training step
LM_SHAPES = (("mamba_lm_sft", 1, 16, 128),)
LM_CASE = "mamba_lm_sft d_inner 1536 B=16 L=128"
SWIN_B_CASE = "swin_base stage 2 B=12 (mac_rrg_mimic, r2genkg, r2gencsr)"
LM_EPOCHS = 2  # 2 steps an epoch of the synthetic train split at batch 16
LM_DECODE = 32  # positions of a val batch decoded one token at a time
# The decode step (plain fp32 PyTorch) against the full forward through the
# kernels: 1e-3 of the largest logit
DECODE_RTOL = 1e-3


def phase_kernels_lm(dev, gen) -> dict:
    """The fused layer's three kernels at the Mamba LM's training shape
    (K=1, B=16, L=128, D=1536, N=16, R=48, taps 4, fp32) against their plain
    versions, timed in turns (``_fused_cases``, which prints the tile, the
    chunk, the grid blocks and the resident blocks an SM); returns the rows
    for the kernels line."""
    rows = _fused_cases(dev, gen, "kernels_lm", LM_SHAPES, dim=768, expand=2)
    return {f"{k}_lm": v for k, v in rows[LM_SHAPES[0][0]].items()}


def phase_train_lm_sft(save_dir: Path, device: str = "cuda",
                       overrides=()) -> dict:
    """The mamba_lm_sft preset at full width (d_model 768, 12 one-direction
    blocks, d_state 16, the synthetic vocabulary; 16 reports of 128 tokens,
    fp32) through the CLI: ``LM_EPOCHS`` epochs (4 steps) and one
    validation (the 8 val reports, one batch). Launches: each block's two
    forward kernels once a step and once a validation batch, its backward
    once a step (no remat)."""
    sets = ("data.dataset=synthetic", f"train.epochs={LM_EPOCHS}",
            f"train.val_every_epochs={LM_EPOCHS}",
            f"train.save_state_every_epochs={LM_EPOCHS + 1}",
            "train.log_every=1", f"train.save_dir={save_dir}", *overrides)
    argv = ["--config", str(LM_PRESET)]
    for item in sets:
        argv += ["--set", item]
    run = _train_through_cli(argv, save_dir, device, epochs=LM_EPOCHS)
    model, n_steps = run["model"], run["n_steps"]
    depth = len(model.layers)
    val_b = -(-VAL_SAMPLES // run["cfg"]["data"]["batch_size"])
    _check(all(layer.mixer.k == 1 for layer in model.layers),
           "the LM's mixers are not one-direction")
    _fused_reckoning(run, "train_lm_sft", depth, n_steps + val_b, n_steps,
                     f"{depth} blocks x ({n_steps} steps + {val_b} val "
                     f"batch) forward, x {n_steps} steps backward (no remat)")
    with open(save_dir / "log.txt") as f:
        val = next(r for r in map(json.loads, f) if "val_loss" in r)
    _check(np.isfinite(val["val_loss"]) and np.isfinite(val["val_ppl"]),
           "non-finite val_loss or val_ppl")
    _phase("train_lm_sft", preset=LM_PRESET.name,
           lm=f"{model.d_model}x{depth}", d_inner=model.d_inner,
           vocab=model.embed_tokens.num_embeddings,
           params=sum(p.numel() for p in model.parameters()),
           val_loss=f"{val['val_loss']:.4f}", val_ppl=f"{val['val_ppl']:.2f}",
           **run["fields"])
    return {**run, "sets": sets}


def _lm_batch(sets, split: str, dev) -> dict:
    """The first ``split`` batch of the LM recipe's data (``lm_ids``,
    ``lm_mask``) on ``dev``."""
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.train.loop import (
        _device_batch,
        build_data,
        lm_sft_extra,
    )

    cfg = load_config(str(LM_PRESET), [*sets, "data.num_workers=1"])
    _, tok, batcher, _ = build_data(cfg)
    b = batcher(split, extra_fn=lm_sft_extra(tok, cfg.data.max_len))
    try:
        host = next(b.batches(shuffle=False, drop_last=False))
    finally:
        b.close()
    return _device_batch({k: host[k] for k in ("lm_ids", "lm_mask")}, dev)


def phase_train_lm_sft_grads(model, sets) -> None:
    """One batch of the LM's data at full width (16 reports of 128 tokens):
    the loss's gradient of every tensor through the kernels against
    ``scan_backend="plain"`` (``_grads_vs_plain``: within TOWER_RTOL of
    each tensor's largest)."""
    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        flax_named_parameters,
    )
    from medical_image_analysis_tpu_torch.models.mamba import set_scan_backend
    from medical_image_analysis_tpu_torch.models.mamba_lm import lm_loss
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    dev = next(model.parameters()).device
    b = _lm_batch(sets, "train", dev)
    named = flax_named_parameters(model)
    names = list(named)
    tensors = [named[n] for n in names]
    depth = len(model.layers)
    grads, secs, losses = {}, {}, {}
    for path, backend in (("kernel", "auto"), ("plain", "plain")):
        set_scan_backend(model, backend)
        mf.reset_launches()
        t0 = time.perf_counter()
        loss = lm_loss(model(b["lm_ids"]), b["lm_ids"], b["lm_mask"])
        grads[path] = torch.autograd.grad(loss, tensors)
        _sync(dev)
        secs[path] = time.perf_counter() - t0
        losses[path] = loss.item()
        del loss
        if path == "kernel" and dev.type == "cuda":
            _check(mf.launches == dict.fromkeys(mf.launches, depth),
                   f"train_lm_sft_grads launches {mf.launches}")
    set_scan_backend(model, "auto")
    loss_rel = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    _check(loss_rel <= TOWER_RTOL,
           f"train_lm_sft_grads: loss rel err {loss_rel:.3e}")
    _phase("train_lm_sft_grads", **_grads_vs_plain(names, grads,
                                                   "train_lm_sft_grads"),
           rows=b["lm_ids"].shape[0], tokens=b["lm_ids"].shape[1],
           loss=f"{losses['kernel']:.6f}", loss_rel_err=f"{loss_rel:.3e}",
           kernel_s=f"{secs['kernel']:.3f}", plain_s=f"{secs['plain']:.3f}")


def phase_lm_decode(model, sets) -> None:
    """The first ``LM_DECODE`` positions of the first val batch (its 8 real
    rows) fed token by token through ``init_states``/``step`` (plain fp32
    PyTorch, no kernel), against the full forward over those positions
    through the kernels: the logits within DECODE_RTOL of the largest.
    Prints the step's seconds a token (synchronised each token)."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    dev = next(model.parameters()).device
    ids = _lm_batch(sets, "val", dev)["lm_ids"][:VAL_SAMPLES, :LM_DECODE]
    depth = len(model.layers)
    with torch.no_grad():
        mf.reset_launches()
        full = model(ids)
        _sync(dev)
        if dev.type == "cuda":
            _check(mf.launches == {"mamba_xdbl": depth, "mamba_scan": depth,
                                   "mamba_scan_bwd": 0},
                   f"lm_decode: the full forward's launches {mf.launches}")
        states = model.init_states(ids.shape[0])
        steps, secs = [], []
        for t in range(ids.shape[1]):
            t0 = time.perf_counter()
            logits, states = model.step(ids[:, t], states)
            _sync(dev)
            secs.append(time.perf_counter() - t0)
            steps.append(logits)
        inc = torch.stack(steps, dim=1)
    _check(bool(torch.isfinite(inc).all()), "lm_decode: non-finite logits")
    err, scale = ((inc - full).abs().max().item(),
                  full.abs().max().item())
    _check(err <= DECODE_RTOL * scale,
           f"lm_decode: max abs err {err:.3e} > {DECODE_RTOL} x {scale:.3f}")
    _phase("lm_decode", rows=ids.shape[0], positions=ids.shape[1],
           max_abs_err=f"{err:.3e}", rel_err=f"{err / scale:.3e}",
           bound=DECODE_RTOL, first_token_s=f"{secs[0]:.4f}",
           s_per_token=f"{sum(secs[1:]) / (len(secs) - 1):.5f}")


# The weight-space MambaPEFT family: additional_scan widens d_state 16 to
# 17 (its default scan_addition_num of 1), the scan kernels' exact
# instantiation; the LM at its training shape, and the adapters of each run
PEFT17_SHAPES = (("mamba_lm_sft_n17", 1, 16, 128),)
PEFT17_CASE = "mamba_lm_sft d_inner 1536 B=16 L=128 d_state 17 (C=82)"
PEFT_LM = dict(additional_scan=True, lora_X=True, lora_dt=True,
               learnable_D_v2=True)
PEFT_ARM = dict(additional_scan=True, lora_patch_embed=True,
                learnable_cls_token_v2=True)
PEFT_STEPS = 3
# A LoRA's B factor starts at 0 (so its A gets no gradient): the runs start
# the adapters at B ~ N(0, PEFT_B_STD^2) from the seed, so that every
# adapter tensor has a gradient to hold against the plain path
PEFT_B_STD = 0.01


def phase_kernels_peft17(dev, gen) -> dict:
    """The fused layer's three kernels at the Mamba LM's training shape with
    d_state 17 (``_fused_cases``): returns the rows for the kernels
    line."""
    rows = _fused_cases(dev, gen, "kernels_peft17", PEFT17_SHAPES, dim=768,
                        expand=2, d_state=17)
    return {f"{k}_peft17": v for k, v in rows[PEFT17_SHAPES[0][0]].items()}


def _peft_tree(base: dict, fields: dict, dev):
    """The adapter tree of ``fields`` over the flat base parameters, drawn
    from ``SEED`` on ``dev`` (LoRA B factors at N(0, PEFT_B_STD^2)), and its
    leaves by ``'<key>/<part>'``."""
    from medical_image_analysis_tpu_torch.peft import mamba_peft

    gen = torch.Generator(dev).manual_seed(SEED)
    cfg = mamba_peft.MambaPEFTConfig(**fields)
    tree = mamba_peft.init_mamba_peft(gen, base, cfg)
    leaves = {}
    for key, val in tree.items():
        for part, t in (val.items() if isinstance(val, dict)
                        else [("", val)]):
            if part == "b":
                with torch.no_grad():
                    t.normal_(0.0, PEFT_B_STD, generator=gen)
            leaves[f"{key}/{part}" if part else key] = t
    return cfg, tree, leaves


def _wide_launches(phase: str, depth: int, backward: bool = True) -> dict:
    """The fused kernels' counts of one pass through ``depth`` mixers
    (forward and, with ``backward``, backward) checked and returned."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    want = {"mamba_xdbl": depth, "mamba_scan": depth,
            "mamba_scan_bwd": depth if backward else 0}
    _check(mf.launches == want, f"{phase} launches {mf.launches}, "
           f"expected {want}")
    return dict(mf.launches)


def phase_peft_lm(model, sets) -> dict:
    """``train_lm_sft``'s LM (full width) as the frozen base of
    ``PEFT_LM``'s adapters, merged into a model built at
    ``effective_d_state`` (17): ``PEFT_STEPS`` AdamW steps (the preset's
    learning rate, constant) of the adapter tree alone on the preset's
    synthetic batches through the kernels, the first step's adapter
    gradients held against ``scan_backend="plain"`` (``_grads_vs_plain``).
    Returns the kernel steps' launches."""
    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        flax_named_parameters,
    )
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.mamba import set_scan_backend
    from medical_image_analysis_tpu_torch.models.mamba_lm import (
        MambaLM,
        lm_loss,
    )
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf
    from medical_image_analysis_tpu_torch.peft import mamba_peft
    from medical_image_analysis_tpu_torch.train.loop import (
        _device_batch,
        build_data,
        lm_sft_extra,
    )
    from medical_image_analysis_tpu_torch.train.optim import make_adamw

    dev = next(model.parameters()).device
    base = {k: v.detach() for k, v in flax_named_parameters(model).items()}
    before = {k: v.clone() for k, v in base.items()}
    cfg, tree, leaves = _peft_tree(base, PEFT_LM, dev)
    start = {k: v.detach().clone() for k, v in leaves.items()}
    n = mamba_peft.effective_d_state(cfg, model.d_state)
    _check(n == 17 and mf.state_width(n) == n,
           f"peft_lm: d_state {n} is not the exact instantiation 17")
    wide = MambaLM(model.embed_tokens.num_embeddings, d_model=model.d_model,
                   depth=model.depth, d_state=n,
                   expand=model.d_inner // model.d_model, device="meta")
    lcfg = load_config(str(LM_PRESET), [*sets, "data.num_workers=1"])
    _, tok, batcher, _ = build_data(lcfg)
    train_b = batcher("train", extra_fn=lm_sft_extra(tok, lcfg.data.max_len))
    try:
        batches = [_device_batch({k: h[k] for k in ("lm_ids", "lm_mask")},
                                 dev)
                   for epoch in range(PEFT_STEPS)
                   for h in train_b.batches(epoch=epoch)][:PEFT_STEPS]
    finally:
        train_b.close()
    opt = make_adamw(leaves, lambda _: lcfg.train.lr,
                     weight_decay=lcfg.train.weight_decay,
                     grad_clip=lcfg.train.grad_clip)
    names = list(leaves)

    def grads_of(b):
        logits = mamba_peft.apply_merged(
            wide, mamba_peft.merge_mamba_peft(base, tree, cfg), b["lm_ids"])
        loss = lm_loss(logits, b["lm_ids"], b["lm_mask"])
        return loss, torch.autograd.grad(loss, [leaves[k] for k in names])

    launches, losses, step_s, check = [], [], [], {}
    for step, b in enumerate(batches):
        mf.reset_launches()
        t0 = time.perf_counter()
        loss, grads = grads_of(b)
        _sync(dev)
        secs = time.perf_counter() - t0
        if dev.type == "cuda":
            launches.append(_wide_launches("peft_lm", model.depth))
        if step == 0:  # the same step through the plain path
            set_scan_backend(wide, "plain")
            plain_loss, plain = grads_of(b)
            set_scan_backend(wide, "auto")
            loss_rel = abs(loss.item() - plain_loss.item()) / abs(
                plain_loss.item())
            _check(loss_rel <= TOWER_RTOL,
                   f"peft_lm: loss rel err {loss_rel:.3e}")
            check = dict(_grads_vs_plain(names, {"kernel": grads,
                                                 "plain": plain}, "peft_lm"),
                         loss_rel_err=f"{loss_rel:.3e}")
            del plain
        t0 = time.perf_counter()
        opt.step(dict(zip(names, grads)))
        _sync(dev)
        step_s.append(secs + time.perf_counter() - t0)
        losses.append(loss.item())
        del loss, grads
    _check(all(np.isfinite(losses)), f"peft_lm: losses {losses}")
    moved = sum(not torch.equal(start[k], v.detach())
                for k, v in leaves.items())
    _check(moved == len(leaves), f"peft_lm: {len(leaves) - moved} adapter "
           "tensors did not move")
    _check(all(torch.equal(before[k], v) for k, v in base.items()),
           "peft_lm: a base tensor changed")
    total = {k: sum(run[k] for run in launches) for k in mf.launches}
    adapters = sorted({k.split("|")[1] for k in tree})
    _phase("peft_lm", d_state=f"{model.d_state}->{n}",
           adapters=",".join(adapters), adapter_tensors=len(leaves),
           adapter_params=sum(v.numel() for v in leaves.values()),
           rows=batches[0]["lm_ids"].shape[0],
           tokens=batches[0]["lm_ids"].shape[1],
           losses=",".join(f"{x:.5f}" for x in losses), **check,
           step_s=",".join(f"{x:.3f}" for x in step_s),
           launches=_compact(total))
    return total


def phase_peft_arm(dev, gen, overrides=()) -> dict:
    """``r2gengpt_mimic``'s ARM-B tower (12 layers, four directions, no
    remat; random weights from the seed) as the base of ``PEFT_ARM``'s
    adapters, merged into a tower built at d_state 17, at the training
    step's 12 images: the tokens within TOWER_RTOL of the plain path's
    largest, and every adapter's gradient from one random cotangent
    (``_grads_vs_plain``). ``overrides`` are ``--set`` items of the
    preset. Returns the kernel pass's launches."""
    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        flax_named_parameters,
    )
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.mamba import (
        ARM,
        set_scan_backend,
    )
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf
    from medical_image_analysis_tpu_torch.peft import mamba_peft
    from medical_image_analysis_tpu_torch.train.loop import vision_preset

    cfg = load_config(str(PRESET), list(overrides))
    vk = dict(vision_preset(cfg.model.vision, cfg.model.vision_size,
                            cfg.model.vision_kwargs), remat=False)
    size = cfg.data.input_size
    images = cfg.data.batch_size * cfg.data.num_views
    arm = ARM(**vk, img_size=size, device=dev)
    init_params(arm, gen)
    base = {k: v.detach() for k, v in flax_named_parameters(arm).items()}
    pcfg, tree, leaves = _peft_tree(base, PEFT_ARM, dev)
    n0 = arm.layers[0].mixer.n
    n = mamba_peft.effective_d_state(pcfg, n0)
    wide = ARM(**dict(vk, d_state=n), img_size=size, device="meta")
    del arm
    x = torch.randn(images, size, size, 3, device=dev, generator=gen)
    names = list(leaves)
    out, grads, secs = {}, {}, {}
    cot = None
    for path, backend in (("kernel", "auto"), ("plain", "plain")):
        set_scan_backend(wide, backend)
        mf.reset_launches()
        t0 = time.perf_counter()
        y = mamba_peft.apply_merged(
            wide, mamba_peft.merge_mamba_peft(base, tree, pcfg), x)
        if cot is None:
            cot = torch.randn(y.shape, device=dev, generator=gen)
        grads[path] = torch.autograd.grad(y, [leaves[k] for k in names], cot)
        _sync(dev)
        secs[path] = time.perf_counter() - t0
        out[path] = y.detach()
        del y
        if path == "kernel" and dev.type == "cuda":
            launches = _wide_launches("peft_arm", len(wide.layers))
    err, scale = _max_err(out["kernel"], out["plain"])
    _check(err <= TOWER_RTOL * scale,
           f"peft_arm: tokens max abs err {err:.3e} > {TOWER_RTOL} x "
           f"{scale:.3f}")
    _phase("peft_arm", images=images, d_state=f"{n0}->{n}",
           adapters=",".join(sorted({k.split("|")[1] for k in tree})),
           adapter_tensors=len(leaves), tokens_err=f"{err:.3e}",
           **_grads_vs_plain(names, grads, "peft_arm"),
           kernel_s=f"{secs['kernel']:.3f}", plain_s=f"{secs['plain']:.3f}")
    return launches if dev.type == "cuda" else {}


def phase_train_mac_rrg(vocab: int, save_dir: Path, device: str = "cuda",
                        overrides=()) -> dict:
    """The mac_rrg_mimic preset at full width (Swin-B; the 1.8B-parameter
    LLM at Qwen1.5's vocabulary, frozen with LoRA r16; the agents' rag and
    concept rows 768 wide, 32 chunks and 32 entities; 6 studies x 2 views)
    through the CLI: 5 steps and one validation at ``MRG_GEN``, the agents'
    context (alias dictionary, relations, chunk corpus and its embeddings)
    built on the card first. The Swin kernel launches once a block a
    validation batch and never in a training step (the tower trains, so
    its blocks take the unfused route)."""
    run = _mrg_through_cli(MAC_PRESET, vocab, save_dir, device, overrides)
    model, val_b = run["model"], run["val_batches"]
    blocks = sum(model.vision.swin.depths)
    _check_launches(run, {"swin_attn_fwd": blocks * val_b}, "train_mac_rrg",
                    f"{blocks} Swin blocks x {val_b} val batches, none in "
                    f"the {run['n_steps']} steps (a gradient)")
    si = run["cfg"]["model"]["side_inputs"]
    _phase("train_mac_rrg", preset=MAC_PRESET.name,
           swin=f"{model.vision.out_dim}x{blocks}",
           llm=f"{model.llm_cfg.dim}x{model.llm_cfg.n_layers}",
           params=sum(p.numel() for p in model.parameters()),
           agents=f"dim{si['dim']}_chunks{si['max_chunks']}_entities"
                  f"{si['max_entities']}",
           context=_compact(run["side"]["side_inputs"]),
           side_s=f"{run['side']['side_s']:.2f}", **run["fields"])
    return run


def _mac_val_batch(sets, dev):
    """The first val batch of mac_rrg_mimic's data with the agents' arrays,
    on ``dev``, and the seconds the agents took for its 6 drafts (a fresh
    context on ``dev``, nothing cached)."""
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.train.loop import (
        _device_batch,
        build_data,
        make_task_adapter,
    )

    cfg = load_config(str(MAC_PRESET), [*sets, "data.num_workers=1"])
    ann, tok, batcher, loader = build_data(cfg)
    ad = make_task_adapter(cfg, ann, tok, loader, dev)
    vb = batcher("val", extra_fn=ad.extra_fn)
    try:
        t0 = time.perf_counter()
        for sample in vb.samples[: vb.batch_size]:
            ad.extra_fn(sample)
        agents_s = time.perf_counter() - t0
        host = next(vb.batches(shuffle=False, drop_last=False))
    finally:
        vb.close()
    return _device_batch(host, dev), agents_s


def phase_tower_mac_rrg(model, sets) -> dict:
    """The first val batch (6 studies x 2 views, the agents' arrays of a
    fresh context): ``encode_img`` through the Swin kernel, once a block,
    against the unfused route (``set_fused(model, False)``) within
    TOWER_RTOL of the largest value. Prints the agents' seconds for the
    batch's drafts. Returns the batch."""
    from medical_image_analysis_tpu_torch.models.common import set_fused
    from medical_image_analysis_tpu_torch.ops import swin_block as sb

    dev = next(model.parameters()).device
    b, agents_s = _mac_val_batch(sets, dev)
    blocks = sum(model.vision.swin.depths)
    out, secs = {}, {}
    for fused in (True, False):
        set_fused(model, fused)
        sb.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            out[fused] = model.encode_img(b["images"], b["rag_embeds"],
                                          b["concept_embeds"])
        _sync(dev)
        secs[fused] = time.perf_counter() - t0
        if dev.type == "cuda":
            _check(sb.launches["swin_attn_fwd"] == (blocks if fused else 0),
                   f"tower_mac_rrg launches {sb.launches}")
    set_fused(model, True)
    want = out[False]
    rel = ((out[True] - want).abs().max() / want.abs().max()).item()
    _check(bool(torch.isfinite(out[True]).all()) and rel <= TOWER_RTOL,
           f"tower_mac_rrg: max rel err {rel:.3e} > {TOWER_RTOL}")
    rows = [int(b[k].shape[1]) for k in ("rag_embeds", "concept_embeds")]
    _phase("tower_mac_rrg", images=b["images"].shape[0] * b["images"].shape[1],
           prompt_rows=_compact({"image": want.shape[1] - sum(rows),
                                 "rag": rows[0], "concept": rows[1]}),
           rag_rows_used=int(b["rag_embeds"].abs().sum(-1).gt(0).sum()),
           concept_rows_used=int(b["concept_embeds"].abs().sum(-1).gt(0)
                                 .sum()),
           max_rel_err=f"{rel:.3e}", bound=TOWER_RTOL,
           fused_s=f"{secs[True]:.3f}", unfused_s=f"{secs[False]:.3f}",
           agents_batch_s=f"{agents_s:.3f}")
    return b


def _refine_through_cli(run: dict, delta: Path, device: str, sets=(),
                        check_start=None) -> dict:
    """``cli.mac_refine.main`` in-process on ``delta`` (``--rounds 1
    --max-batches 1``, the training run's ``--set`` items, then ``sets``),
    with the kernels' counts at 0 just before and read just after; every
    draft's agent arrays are recorded. ``check_start(model, named)`` runs
    once the weights are in place. Returns the scores, the counts, the
    arrays, the Swin blocks and the seconds."""
    from medical_image_analysis_tpu_torch.cli import mac_refine

    seen = {"agents": []}

    def on_start(model, named, ctx):
        if check_start is not None:
            check_start(model, named)
        seen["blocks"] = sum(model.vision.swin.depths)
        seen["tensors"] = len(named)
        agent_embeds = ctx.agent_embeds

        def recorded(draft):
            out = agent_embeds(draft)
            seen["agents"].append(out)
            return out

        ctx.agent_embeds = recorded
        _sync(torch.device(device))
        seen["setup_s"] = time.perf_counter() - t0

    argv = ["--config", str(MAC_PRESET), "--delta", str(delta),
            "--rounds", "1", "--max-batches", "1", "--device", device]
    for item in (*run["sets"], *sets):
        argv += ["--set", item]
    _reset_launches()
    t0 = time.perf_counter()
    out = mac_refine.main(argv, on_start=on_start)
    _sync(torch.device(device))
    seen["total_s"] = time.perf_counter() - t0
    seen["launches"] = _all_launches()
    for key in ("draft", "refined"):
        _check(all(np.isfinite(v) for v in out[key].values()),
               f"refine_mac_rrg: non-finite {key} scores")
    reckon = {"launches": seen["launches"],
              "cuda": torch.device(device).type == "cuda"}
    _check_launches(reckon, {"swin_attn_fwd": 2 * seen["blocks"]},
                    "refine_mac_rrg",
                    f"{seen['blocks']} Swin blocks x 2 generations (the "
                    f"draft and one refinement) of one batch")
    seen["rag"] = np.stack([r for r, _ in seen["agents"]])
    seen["concept"] = np.stack([c for _, c in seen["agents"]])
    return {**seen, "scores": out}


def phase_refine_mac_rrg(run: dict, save_dir: Path,
                         device: str = "cuda") -> list:
    """``cli.mac_refine.main`` in-process on ``train_mac_rrg``'s delta, twice
    (``_refine_through_cli``; ``MRG_GEN``): the Swin kernel launches once a
    block a generation (the draft and one refinement), and the scores of
    the drafts and the refined reports are finite.

    - At the run's vocabulary (Qwen1.5's): once merged, every tensor of the
      model equals the trained model's, in its dtype.
    - At the tokenizer's vocabulary (the same delta: it holds no tensor of
      the vocabulary's size; the frozen LLM is drawn again): the random LLM
      then drafts in report words, where the agents find entities, so the
      refined round's rag and concept arrays are not all zero. At Qwen1.5's
      151,936 ids the random LLM drafts ids past the tokenizer's, which
      decode to ``<unk>``: no entity, so zero arrays there.

    Returns the two runs' launches."""
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.train.loop import build_data

    state = run["state"]
    trained = {**state.params, **state.frozen}
    delta = save_dir / "checkpoint_best.pt"

    def same_as_trained(model, named):
        _check(set(named) == set(trained),
               "refine_mac_rrg: the model's tensors are not the run's")
        differ = [n for n, p in named.items()
                  if p.dtype != trained[n].dtype
                  or not torch.equal(p, trained[n])]
        _check(not differ, f"refine_mac_rrg: {len(differ)} tensors differ "
                           f"from the trained model's, e.g. {differ[:3]}")

    full = _refine_through_cli(run, delta, device,
                               check_start=same_as_trained)
    _, tok, _, _ = build_data(load_config(str(MAC_PRESET), list(run["sets"])))
    small = _refine_through_cli(
        run, delta, device,
        (f"model.llm_kwargs.vocab_size={tok.vocab_size}",))
    _check(small["rag"].any() and small["concept"].any(),
           "refine_mac_rrg: the refined round's rag or concept arrays are "
           "all zero at the tokenizer's vocabulary")

    def rows_used(a):
        return int((np.abs(a).sum(-1) > 0).sum())

    fields = {}
    for tag, r in (("", full), ("tokvocab_", small)):
        fields.update({
            f"{tag}rag_rows_used": rows_used(r["rag"]),
            f"{tag}concept_rows_used": rows_used(r["concept"]),
            **{f"{tag}{k}_{m}": f"{r['scores'][k][m]:.4f}"
               for k in ("draft", "refined")
               for m in ("Bleu_4", "CIDEr", "ce_f1")},
            f"{tag}setup_s": f"{r['setup_s']:.2f}",
            f"{tag}total_s": f"{r['total_s']:.2f}"})
    _phase("refine_mac_rrg", tensors=full["tensors"], tensors_equal=True,
           drafts=len(full["agents"]), tokenizer_vocab=tok.vocab_size,
           **fields, launches=json.dumps(full["launches"],
                                         separators=(",", ":")))
    return [full["launches"], small["launches"]]

# Real checkpoint files (the checkpoint loading / tokenizer / preprocessing
# layer): an HF directory of Qwen1.5-1.8B's public shape written from the
# seed, served in bf16 and int8, trained on; the on-device preprocessing.

# Qwen/Qwen1.5-1.8B's config.json (the fields the loader reads)
QWEN_1_8B = {
    "architectures": ["Qwen2ForCausalLM"], "hidden_size": 2048,
    "intermediate_size": 5504, "num_hidden_layers": 24,
    "num_attention_heads": 16, "num_key_value_heads": 16,
    "vocab_size": 151936, "rope_theta": 1000000.0, "rms_norm_eps": 1e-06,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
}
HF_TOKENIZER = Path(__file__).resolve().parent / "tests" / "data" / \
    "report_bpe_tokenizer.json"
HF_SHARDS = 2
HF_INT8_SAVING = 1.4 * 2**30  # int8 holds at least this much less
HF_TRAIN_BATCH = 10  # 3 steps of the 32 synthetic studies, accumulation 2
HF_QUANT_LAYERS = (0, 11, 23)  # kernels held against _quantize
PREP_BATCH = 16
PREP_CASES = ((1024, 224), (128, 224))  # source side -> 224
PREP_DICOM = 256  # the JPEG-Lossless DICOM's side before decode_scaled
PREP_ATOL = 1e-4  # card against CPU, fp32, normalised values


def hf_tensors(hc: dict) -> list[tuple[str, tuple, float]]:
    """(HF name, shape, init scale) of every tensor of a Qwen2 checkpoint;
    a scale of -1 marks a norm (1 + 0.05 N(0, 1))."""
    d, h, v = hc["hidden_size"], hc["intermediate_size"], hc["vocab_size"]
    kv = d // hc["num_attention_heads"] * hc["num_key_value_heads"]
    out = [("model.embed_tokens.weight", (v, d), 0.02)]
    for i in range(hc["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out += [(f"{p}input_layernorm.weight", (d,), -1.0),
                (f"{p}self_attn.q_proj.weight", (d, d), 0.02),
                (f"{p}self_attn.q_proj.bias", (d,), 0.02),
                (f"{p}self_attn.k_proj.weight", (kv, d), 0.02),
                (f"{p}self_attn.k_proj.bias", (kv,), 0.02),
                (f"{p}self_attn.v_proj.weight", (kv, d), 0.02),
                (f"{p}self_attn.v_proj.bias", (kv,), 0.02),
                (f"{p}self_attn.o_proj.weight", (d, d), 0.02),
                (f"{p}post_attention_layernorm.weight", (d,), -1.0),
                (f"{p}mlp.gate_proj.weight", (h, d), 0.02),
                (f"{p}mlp.up_proj.weight", (h, d), 0.02),
                (f"{p}mlp.down_proj.weight", (d, h), 0.02)]
    out += [("model.norm.weight", (d,), -1.0), ("lm_head.weight", (v, d), 0.02)]
    return out


def write_hf_checkpoint(out: Path, hc: dict, dev, seed: int = SEED) -> dict:
    """Write ``hc``'s tensors in bf16, random from ``seed`` (drawn on
    ``dev``), as ``HF_SHARDS`` safetensors shards with
    ``model.safetensors.index.json``, beside ``config.json`` and the report
    tokenizer. Refuses to start where the disk is short. Returns the bytes
    written, the seconds and the free bytes before."""
    import shutil

    tensors = hf_tensors(hc)
    sizes = [int(np.prod(shape)) * 2 for _, shape, _ in tensors]
    need = sum(sizes)
    free = shutil.disk_usage(out).free
    _check(free >= need + 2**30,
           f"hf_ckpt: {free / 2**30:.2f} GiB free under {out}, the checkpoint "
           f"needs {need / 2**30:.2f} GiB (+1 GiB); refusing to write it")
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(seed)
    bounds = np.searchsorted(np.cumsum(sizes), need * np.arange(1, HF_SHARDS)
                             / HF_SHARDS)
    groups = np.split(np.arange(len(tensors)), bounds)
    weight_map, written = {}, 0
    for k, idx in enumerate(groups):
        name = f"model-{k + 1:05d}-of-{HF_SHARDS:05d}.safetensors"
        header, off = {}, 0
        for i in idx:
            tname, shape, _ = tensors[i]
            header[tname] = {"dtype": "BF16", "shape": list(shape),
                             "data_offsets": [off, off + sizes[i]]}
            weight_map[tname] = name
            off += sizes[i]
        head = json.dumps(header).encode()
        head += b" " * (-len(head) % 8)
        with open(out / name, "wb") as f:
            f.write(len(head).to_bytes(8, "little") + head)
            for i in idx:
                _, shape, scale = tensors[i]
                t = torch.randn(shape, device=dev, generator=gen)
                t = (1.0 + 0.05 * t) if scale < 0 else t * scale
                f.write(t.bfloat16().cpu().view(torch.int16).numpy().data)
        written += 8 + len(head) + off
    (out / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": need}, "weight_map": weight_map}))
    (out / "config.json").write_text(json.dumps(hc))
    (out / "tokenizer.json").write_bytes(HF_TOKENIZER.read_bytes())
    return {"bytes": written, "write_s": time.perf_counter() - t0,
            "free_before": free, "tensors": len(tensors)}


def phase_hf_ckpt(out: Path, dev, hc: dict = QWEN_1_8B) -> dict:
    info = write_hf_checkpoint(out, hc, dev)
    _phase("hf_ckpt", shape=f"{hc['hidden_size']}x{hc['num_hidden_layers']}",
           vocab=hc["vocab_size"], tensors=info["tensors"], shards=HF_SHARDS,
           bytes=info["bytes"], write_s=f"{info['write_s']:.2f}",
           free_gib_before=f"{info['free_before'] / 2**30:.2f}")
    return info


def _hf_config(out: Path, ckpt: Path, int8: bool, overrides=()) -> Path:
    """The preset with the checkpoint (and its tokenizer), as a YAML file
    for ``cli.demo --config``; ``overrides`` are ``key=value`` items."""
    import yaml

    raw = yaml.safe_load(PRESET.read_text())
    items = (f"model.llm_weights_dir={ckpt}", f"data.tokenizer_dir={ckpt}",
             f"model.llm_int8={str(int8).lower()}", *overrides)
    for item in items:
        key, value = item.split("=", 1)
        sect, name = key.split(".", 1)
        raw.setdefault(sect, {})[name] = yaml.safe_load(value)
    path = out / f"serve_hf{'_int8' if int8 else ''}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


def _llm_bytes(lm) -> int:
    return sum(p.numel() * p.element_size() for p in lm.parameters())


def _llm_equals_file(lm, ckpt: Path) -> int:
    """Every tensor of ``lm`` that the checkpoint maps equals the file's
    (in the tensor's dtype: bf16 bit for bit, norms widened to fp32);
    returns how many were held."""
    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        flax_named_parameters,
    )
    from medical_image_analysis_tpu_torch.ckpt.hf_load import llm_key_map
    from medical_image_analysis_tpu_torch.ckpt.safetensors import (
        SafetensorsIndex,
    )

    named = flax_named_parameters(lm)
    sd = SafetensorsIndex(str(ckpt))
    n = 0
    for path, (hf, kind) in llm_key_map(lm.cfg, sd).items():
        name = f"{path}/kernel" if kind == "kernel" else path
        p = named[name]
        t = sd.tensor(hf, p.device)
        _check(torch.equal(p.detach(), t.to(p.dtype)),
               f"LLM tensor {name} differs from {hf} in the file")
        n += 1
    sd.close()
    return n


def _int8_equals_quantize(lm, ckpt: Path) -> int:
    """``kernel_q`` and ``scale`` of q/k/v/o and gate/up/down at
    ``HF_QUANT_LAYERS`` and of ``lm_head`` equal ``_quantize`` of the
    file's tensor, computed on the host; returns how many were held."""
    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        flax_named_parameters,
    )
    from medical_image_analysis_tpu_torch.ckpt.hf_load import _quantize
    from medical_image_analysis_tpu_torch.ckpt.safetensors import (
        SafetensorsIndex,
    )

    named = flax_named_parameters(lm)
    sd = SafetensorsIndex(str(ckpt))
    pairs = [("lm_head", "lm_head.weight")]
    for i in HF_QUANT_LAYERS:
        if i >= lm.cfg.n_layers:
            continue
        pairs += [(f"layers_{i}/self_attn/{p}",
                   f"model.layers.{i}.self_attn.{p}.weight")
                  for p in ("q_proj", "k_proj", "v_proj", "o_proj")]
        pairs += [(f"layers_{i}/mlp/{p}", f"model.layers.{i}.mlp.{p}.weight")
                  for p in ("gate_proj", "up_proj", "down_proj")]
    for path, hf in pairs:
        qs = _quantize(sd[hf].T)  # on the host, from the mapped bytes
        _check(torch.equal(named[f"{path}/kernel_q"].cpu(), qs["kernel_q"].T)
               and torch.equal(named[f"{path}/scale"].cpu(), qs["scale"]),
               f"{path}: kernel_q/scale differ from _quantize of {hf}")
    sd.close()
    return len(pairs)


def _fresh_tokenizer(ckpt: Path):
    """The checkpoint's ``tokenizer.json`` read anew by the port's reader,
    apart from the served pipeline's copy; its round trip of the synthetic
    reports checked. Returns it and the reports' ids and token counts."""
    from medical_image_analysis_tpu_torch.data.datasets import (
        synthetic_annotations,
    )
    from medical_image_analysis_tpu_torch.data.hf_tokenizer import HFTokenizer

    tok = HFTokenizer.from_file(str(ckpt / "tokenizer.json"))
    reports = [s.report for split in synthetic_annotations().values()
               for s in split]
    n_ids = 0
    for text in reports:
        ids = tok.encode(text)
        _check(all(0 <= i < tok.vocab_size for i in ids),
               "tokenizer: an id past the vocabulary")
        _check(len(ids) < len(text.encode()),
               f"tokenizer: no merge applied to {text!r}")
        _check(tok.decode(ids) == text,
               f"tokenizer: {text!r} does not survive encode and decode")
        n_ids += len(ids)
    return tok, len(reports), n_ids


def phase_serve_hf(ckpt: Path, work: Path, device: str = "cuda",
                   int8: bool = False, ref: dict | None = None,
                   overrides=(), requests: int = REQUESTS) -> dict:
    """``cli.demo.build_pipeline`` on the preset with the checkpoint and its
    tokenizer (``int8``: ``model.llm_int8``) behind ``make_server``: the
    LLM held against the file, ``requests`` POSTs (beam 3, the preset's
    decode length), each reply decoded by the port's tokenizer, the ARM
    kernels once per layer per request. The replies are decoded again by
    a tokenizer read anew from the file, which also round-trips the
    synthetic reports. ``ref`` (the bf16 run's result) gives its tower
    and projector, copied over this run's so that both runs feed the LLM
    the same image tokens, the first decode step's logit gap and the
    saving in bytes."""
    from medical_image_analysis_tpu_torch.cli import demo
    from medical_image_analysis_tpu_torch.models.llm import transient_bytes

    phase = "serve_hf_int8" if int8 else "serve_hf"
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    load = {}
    splice = demo.splice_llm_weights

    def timed_splice(model, cfg):
        _sync(dev)
        t = time.perf_counter()
        out = splice(model, cfg)
        _sync(dev)
        load["s"] = time.perf_counter() - t
        return out

    demo.splice_llm_weights = timed_splice
    try:
        t0 = time.perf_counter()
        pipe = demo.build_pipeline(argparse.Namespace(
            config=str(_hf_config(work, ckpt, int8, overrides)), vocab=None,
            vocab_size=None, delta=None, device=device, seed=SEED))
        _sync(dev)
        build_s = time.perf_counter() - t0
    finally:
        demo.splice_llm_weights = splice
    model, tok, gcfg = pipe.model, pipe.tok, pipe.gcfg
    lm = model.llm
    # the seed draws the LLM's tensors before the projector's, and int8
    # layers draw none: without this copy the two runs would differ in
    # the image tokens too, and the logit gap would not be int8's alone
    rest = {n: t for n, t in model.state_dict().items()
            if not n.startswith("llm.")}
    rest_differing = None
    if ref is not None:
        _check(set(ref["rest"]) == set(rest),
               f"{phase}: the tower and projector differ in names from "
               "serve_hf's")
        rest_differing = 0
        with torch.no_grad():
            for n, t in ref["rest"].items():
                rest_differing += not torch.equal(rest[n].cpu(), t)
                rest[n].copy_(t)
        _check(all(torch.equal(rest[n].cpu(), t)
                   for n, t in ref["rest"].items()),
               f"{phase}: the tower and projector differ from serve_hf's "
               "after the copy")
    fresh_tok, n_reports, n_report_ids = _fresh_tokenizer(ckpt)
    held = _llm_equals_file(lm, ckpt) if not int8 else 0
    quant = _int8_equals_quantize(lm, ckpt) if int8 else 0
    nbytes = _llm_bytes(lm)
    head = lm.lm_head  # fp32 compute over int8 or bf16 weights
    head_transient = transient_bytes(lm.cfg.vocab_size, lm.cfg.dim,
                                     torch.float32)
    first = {}

    def grab(_mod, _args, out):
        if "logits" not in first:
            first["logits"] = out.float().reshape(-1, out.shape[-1])[-1].cpu()

    depth = len(model.vision.arm.layers)
    rng = np.random.default_rng(SEED)
    pngs = [_png(rng, 224) for _ in range(requests)]
    server = demo.make_server(pipe, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    secs, words = [], []
    hook = head.register_forward_hook(grab)
    try:
        _reset_launches()
        for png in pngs:
            t = time.perf_counter()
            status, out = _post(server.server_address[1], png)
            secs.append(time.perf_counter() - t)
            hook.remove()
            ids = out["ids"]
            _check(status == 200, f"{phase}: HTTP status {status}")
            _check(len(ids) == gcfg.max_new_tokens,
                   f"{phase}: {len(ids)} ids, expected {gcfg.max_new_tokens}")
            _check(all(0 <= i < lm.cfg.vocab_size for i in ids),
                   f"{phase}: token id out of range")
            _check(out["report"] == fresh_tok.decode(ids),
                   f"{phase}: the reply differs from its ids decoded by the "
                   "checkpoint's tokenizer.json read anew")
            words.append(len(out["report"].split()))
        launches = _all_launches()
    finally:
        hook.remove()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    _check(not thread.is_alive(), f"{phase}: server thread did not stop")
    want = {"mamba_xdbl": depth * requests, "mamba_scan": depth * requests}
    if cuda:
        for name, n in want.items():
            _check(launches.get(name, 0) == n,
                   f"{phase}: {name} launched {launches.get(name, 0)} times; "
                   f"expected {depth} layers x {requests} requests")
        _check(launches.get("mamba_scan_bwd", 0) == 0,
               f"{phase}: the backward kernel launched while serving")
    fields = dict(
        preset=PRESET.name, llm=f"{lm.cfg.dim}x{lm.cfg.n_layers}",
        vocab=lm.cfg.vocab_size, tokenizer_vocab=tok.vocab_size,
        beams=gcfg.num_beams, new_tokens=gcfg.max_new_tokens,
        load_s=f"{load['s']:.2f}", build_s=f"{build_s:.2f}",
        llm_tensor_bytes=nbytes, llm_tensor_gib=f"{nbytes / 2**30:.3f}",
        lm_head_transient_bytes=head_transient,
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}"
        if cuda else "n/a",
        request_s=",".join(f"{s:.3f}" for s in secs),
        report_words=",".join(map(str, words)),
        reports_round_tripped=n_reports, report_ids=n_report_ids,
        launches=_compact(launches))
    if held:
        fields["tensors_equal_file"] = held
    if quant:
        fields["int8_kernels_equal_quantize"] = quant
    if ref is not None:
        want = ref["first_logits"]
        gap = (first["logits"] - want).abs().max().item()
        same_top = bool(first["logits"].argmax() == want.argmax())
        saved = ref["llm_bytes"] - nbytes
        _check(saved >= HF_INT8_SAVING,
               f"{phase}: int8 holds {saved / 2**30:.3f} GiB less in LLM "
               f"tensors than bf16; expected at least "
               f"{HF_INT8_SAVING / 2**30:.1f}")
        fields.update(tower_proj_tensors=len(rest),
                      tower_proj_differing_before_copy=rest_differing,
                      first_step_max_logit_gap=f"{gap:.4f}",
                      bf16_max_abs_logit=f"{want.abs().max().item():.4f}",
                      same_first_token=same_top,
                      saved_gib=f"{saved / 2**30:.3f}",
                      bf16_request_s=ref["request_s"])
    _phase(phase, **fields)
    result = {"first_logits": first["logits"], "llm_bytes": nbytes,
              "request_s": fields["request_s"], "launches": launches,
              "rest": None if ref is not None else
              {n: t.detach().cpu().clone() for n, t in rest.items()}}
    del rest
    del pipe, model, lm, head
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return result


def phase_train_hf(ckpt: Path, save_dir: Path, device: str = "cuda",
                   overrides=()) -> dict:
    """``fit_mrg`` of the preset with ``model.llm_weights_dir`` and
    ``data.tokenizer_dir`` set, through ``cli.train.main``: LoRA r16, 3
    steps and one validation at the preset's decode length; the checks of
    ``train``, every frozen LLM tensor equal to the file after training,
    launches reckoned as ``train``'s."""
    argv = ["--config", str(PRESET)]
    for item in ("data.dataset=synthetic", f"data.batch_size={HF_TRAIN_BATCH}",
                 f"model.llm_weights_dir={ckpt}", f"data.tokenizer_dir={ckpt}",
                 "train.epochs=1", "train.save_state_every_epochs=2",
                 "train.log_every=1", f"train.save_dir={save_dir}",
                 *overrides):
        argv += ["--set", item]
    run = _train_through_cli(argv, save_dir, device)
    model, n_steps = run["model"], run["n_steps"]
    accum = run["cfg"]["train"]["accum_steps"]
    _check(run["cfg"]["train"]["lora_llm"] and not any(
        n.startswith("base/llm/") for n in run["state"].params),
        "train_hf: expected LoRA on a frozen LLM")
    held = _llm_equals_file(model.llm, ckpt)
    depth = len(model.vision.arm.layers)
    val_batches = run["val_batches"]
    fwd_step, bwd_step = depth * accum * 2, depth * accum
    fwd = n_steps * fwd_step + val_batches * depth
    _check_launches(
        run, {"mamba_xdbl": fwd, "mamba_scan": fwd,
              "mamba_scan_bwd": n_steps * bwd_step}, "train_hf",
        f"per step {depth} layers x {accum} micro-batches x 2 forwards = "
        f"{fwd_step} of each forward kernel and {depth} x {accum} = "
        f"{bwd_step} backward; {n_steps} steps + {val_batches} val batches "
        f"x {depth} layers")
    _phase("train_hf", preset=PRESET.name, accum=accum,
           llm_tensors_equal_file=held, **run["fields"])
    launches = run["launches"]
    del run, model
    gc.collect()
    return launches


def phase_prep_dev(dev, work: Path, batch: int = PREP_BATCH,
                   cases=PREP_CASES, dicom_side: int = PREP_DICOM) -> None:
    """``device_preprocess`` on the card against the same function on the
    CPU (fp32, ``PREP_ATOL``): a batch of ``batch`` uint8 images of each
    source side resized to 224, the first of the large batch a
    JPEG-Lossless DICOM decoded by ``decode_scaled``; the card's time."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import dicom_files

    from medical_image_analysis_tpu_torch.data.preprocessing import (
        decode_scaled,
        device_preprocess,
    )

    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:dicom_side, 0:dicom_side] / dicom_side
    pix = (3000 * np.exp(-((xx - 0.5) ** 2 + (yy - 0.45) ** 2) * 4)
           + rng.normal(0, 80, xx.shape)).clip(0, 4095).astype(np.uint16)
    dcm = work / "study.dcm"
    dcm.write_bytes(dicom_files.make_dicom_jll(pix, wc=1800, ww=3200))
    for side, size in cases:
        raw = rng.integers(0, 256, (batch, side, side, 3), dtype=np.uint8)
        if side == cases[0][0]:
            t0 = time.perf_counter()
            raw[0] = decode_scaled(str(dcm), side)
            dicom_s = time.perf_counter() - t0
        host = torch.from_numpy(raw)
        want = device_preprocess(host, size, torch.float32)
        x = host.to(dev)
        got = device_preprocess(x, size, torch.float32)
        err = (got.cpu() - want).abs().max().item()
        _check(bool(torch.isfinite(got).all()) and err <= PREP_ATOL,
               f"prep_dev: {side}->{size} max abs err {err:.3e} > {PREP_ATOL}")
        ms = (device_ms(lambda: device_preprocess(x, size), 20)
              if dev.type == "cuda" else float("nan"))
        bound_ms = (x.numel() + batch * size * size * 3 * 2) / HBM_BYTES_S * 1e3
        fields = dict(source=f"{batch}x{side}x{side}x3", size=size,
                      max_abs_err=f"{err:.3e}", bound=PREP_ATOL,
                      ms_bf16=f"{ms:.4f}", bytes_bound_ms=f"{bound_ms:.4f}")
        if side == cases[0][0]:
            fields.update(dicom=f"jpeg_lossless_sv1 {dicom_side}^2 -> {side}",
                          dicom_decode_s=f"{dicom_s:.3f}")
        _phase("prep_dev", **fields)


# --------------------------------------------------------------------------
# The reference's checkpoints, the learned CheXbert labeler, JAX train
# states and artifacts, --throughput and train.debug_nans
# --------------------------------------------------------------------------

TESTS_DIR = Path(__file__).resolve().parent / "tests"
# The towers' batches on their main paths: r2gengpt_mimic's and r2gencsr_iu's
# and R2GenKG's 6 studies x 2 views (ARM-B, vssm1_base, Swin-B),
# dp_finetune's 64 images (ViT-B/16); the heads at 12 rows.
REF_BATCH = {"arm": 12, "vssm": 12, "swin": 12, "vit": 64, "head": 12}
# tests/test_torch_chexbert.py's bound on the heads' logits (fp32), times
# max(1, the largest |logit|): here the card's against the CPU's
CHEXBERT_ATOL = 2e-5
CHEXBERT_LEN = 128  # tokens a report, as the JAX labeler's default
THROUGHPUT_PRESETS = (("swinchex.yaml", ()), ("vssm_classify.yaml", ()),
                      ("r2gencsr_iu.yaml", VSSM1_OVERRIDES),
                      ("r2gengpt_mimic.yaml", ()))
THROUGHPUT_KERNELS = {"swin": ("swin_attn_fwd",),
                      "vssm": ("mamba_xdbl", "mamba_scan"),
                      "vssm1": ("scan_n1_fwd",),
                      "arm": ("mamba_xdbl", "mamba_scan")}


def _tests_module(name: str):
    """A maker module of ``tests/`` (no pytest, no JAX)."""
    import importlib

    if str(TESTS_DIR) not in sys.path:
        sys.path.insert(0, str(TESTS_DIR))
    return importlib.import_module(name)


def _scan_switch(model, fused: bool) -> None:
    from medical_image_analysis_tpu_torch.models.mamba import set_scan_backend

    set_scan_backend(model, "auto" if fused else "plain")


def _block_switch(model, fused: bool) -> None:
    from medical_image_analysis_tpu_torch.models.common import set_fused

    set_fused(model, fused)


def _ref_cases():
    """(name, state dict maker, released wrapper, map, module constructor,
    inputs maker, kernel switch, kernels) of every reference layout, at the
    presets' full widths: ARM-B (four directions, and a one-direction
    stage-1 file through ``replicate_dir_weights``), vssm1_base, HF Swin-B,
    timm ViT-B/16, CheXbert, and AM-MRG's Q-Former and Hopfield memory,
    R2GenKG's cross block and R2Gen at 512 x 3."""
    from medical_image_analysis_tpu_torch.ckpt import torch_import as ti
    from medical_image_analysis_tpu_torch.evalx.chexbert_model import (
        CheXbert,
        chexbert_torch_to_flax,
    )
    from medical_image_analysis_tpu_torch.models.bert import (
        BertConfig,
        Blip2QFormer,
    )
    from medical_image_analysis_tpu_torch.models.hopfield import Hopfield
    from medical_image_analysis_tpu_torch.models.mamba import ARM, ARM_CONFIGS
    from medical_image_analysis_tpu_torch.models.r2gen import R2Gen
    from medical_image_analysis_tpu_torch.models.rgcn import (
        ResidualCrossAttentionBlock,
    )
    from medical_image_analysis_tpu_torch.models.swin import (
        SWIN_CONFIGS,
        SwinTransformer,
    )
    from medical_image_analysis_tpu_torch.models.vit import VIT_CONFIGS, ViT
    from medical_image_analysis_tpu_torch.models.vmamba import (
        VSSM,
        VSSM_CONFIGS,
    )

    ref = _tests_module("ref_ckpt_files")
    arm_b = ARM_CONFIGS["arm_base_pz16"]
    swin_b = SWIN_CONFIGS["swin_base"]
    vssm1 = dict(VSSM_CONFIGS["vssm_base"], d_state=1, disable_z=True,
                 conv_bias=False, patch_embed_version="v2")

    def images(key):
        return lambda dev, gen: (torch.randn(
            REF_BATCH[key], 224, 224, 3, device=dev, generator=gen),)

    def rows(*shapes):
        return lambda dev, gen: tuple(
            torch.randn(REF_BATCH["head"], *s, device=dev, generator=gen)
            for s in shapes)

    def qformer_map(sd):
        return {"query_tokens": sd["query_tokens"],
                "bert": ti.blip2_qformer_to_flax(sd, 12)["params"]}

    return [
        ("arm_b", ref.arm_sd, None, lambda sd: ti.arm_torch_to_flax(sd, 12),
         lambda d: ARM(**arm_b, device=d), images("arm"), _scan_switch,
         ("mamba_xdbl", "mamba_scan")),
        ("arm_b_stage1", lambda r: ref.arm_sd(r, dirs=1), None,
         lambda sd: ti.arm_torch_to_flax(ti.replicate_dir_weights(sd), 12),
         lambda d: ARM(**arm_b, device=d), images("arm"), _scan_switch,
         ("mamba_xdbl", "mamba_scan")),
        ("vssm1_base", ref.vssm_sd, None,
         lambda sd: ti.vssm_torch_to_flax(sd, list(vssm1["depths"])),
         lambda d: VSSM(**vssm1, device=d), images("vssm"), _scan_switch,
         ("scan_n1_fwd",)),
        ("swin_b_hf", ref.swin_hf_sd, None,
         lambda sd: ti.swin_hf_to_flax(sd, list(swin_b["depths"])),
         lambda d: SwinTransformer(**swin_b, device=d), images("swin"),
         _block_switch, ("swin_attn_fwd",)),
        ("vit_b_timm", ref.vit_timm_sd, "model",
         lambda sd: ti.vit_torch_to_flax(sd, 12, final_norm=True),
         lambda d: ViT(**VIT_CONFIGS["vit_base"], fixed_sincos_pos=False,
                       device=d), images("vit"), _block_switch,
         ("vit_attn_fwd", "vit_mlp_fwd")),
        ("chexbert", ref.chexbert_sd, "model_state_dict",
         chexbert_torch_to_flax,
         lambda d: CheXbert(BertConfig(), device=d), None, None,
         ()),
        ("qformer_am_mrg", ref.qformer_lavis_sd, None, qformer_map,
         lambda d: Blip2QFormer(enc_dim=1408, text_ffn=True, device=d),
         rows((197, 1408)), None, ()),
        ("hopfield_am_mrg", ref.hopfield_sd, None, ti.hopfield_torch_to_flax,
         lambda d: Hopfield(768, 1024, num_heads=6, pattern_dim=768,
                            scaling=4.0, device=d),
         rows((14, 768), (200, 768)), None, ()),
        ("cross_block_r2genkg", ref.cross_block_sd, None,
         ti.cross_block_torch_to_flax,
         lambda d: ResidualCrossAttentionBlock(768, 8, device=d),
         rows((14, 768), (49, 768)), None, ()),
        ("r2gen", ref.r2gen_sd, None, lambda sd: ti.r2gen_torch_to_flax(sd, 3),
         lambda d: R2Gen(761, 768, device=d),
         lambda dev, gen: (torch.randn(REF_BATCH["head"], 197, 768,
                                       device=dev, generator=gen),
                           torch.randint(0, 761, (REF_BATCH["head"], 60),
                                         device=dev, generator=gen)),
         None, ()),
    ]


def _equal_to_tree(module, tree) -> tuple[int, int]:
    """(tensors of ``module`` equal to the mapped tree's leaves in the
    port's layout, tensors of the tree)."""
    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        state_dict_from_jax,
    )

    want = state_dict_from_jax(tree)
    got = module.state_dict()
    return sum(torch.equal(got[k].detach().cpu(), v)
               for k, v in want.items()), len(want)


def _fused_vs_plain(model, inputs, switch, kernels, what: str) -> dict:
    """The module's output through its kernels and through the plain
    versions on the card, in turns; the kernels must launch, the relative
    gap stay within ``TOWER_RTOL``."""
    out, ms = {}, {}
    dev = inputs[0].device
    with torch.no_grad():
        for fused in (False, True, True, False):
            switch(model, fused)
            _reset_launches()
            _sync(dev)
            t0 = time.perf_counter()
            out[fused] = model(*inputs).float()
            _sync(dev)
            ms[fused] = ms.get(fused, 0.0) + (time.perf_counter() - t0) * 5e2
            if fused:
                launches = {k: _all_launches()[k] for k in kernels}
    switch(model, True)
    got, want = out[True], out[False]
    _check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
           f"{what}: output {tuple(got.shape)} not finite or not "
           f"{tuple(want.shape)}")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    _check(rel <= TOWER_RTOL, f"{what}: max rel err {rel:.3e} > {TOWER_RTOL}")
    if dev.type == "cuda":
        _check(all(launches.values()), f"{what}: launches {launches}")
    return {"shape": tuple(got.shape), "max_rel_err": f"{rel:.3e}",
            "launches": _compact(launches), "kernel_ms": f"{ms[True]:.3f}",
            "plain_ms": f"{ms[False]:.3f}"}


def phase_ref_ckpt(work: Path, dev, gen, cases=None) -> dict:
    """Every reference layout (``_ref_cases``) written from ``SEED`` as its
    released file (``tests/ref_ckpt_files.py:save_pth``), read back by
    ``load_torch_state_dict`` (``weights_only``), mapped by its
    ``ckpt/torch_import.py`` function and loaded strictly onto the card;
    every tensor must equal the mapped file's. Each tower then runs at its
    preset's batch through its kernels and through the plain versions on
    the card (``TOWER_RTOL``), each head once. Prints the file's bytes and
    the load seconds (read, map, copy to the card). Returns the loaded
    CheXbert and its mapped tree."""
    import shutil

    from medical_image_analysis_tpu_torch.ckpt.from_jax import load_jax_params
    from medical_image_analysis_tpu_torch.ckpt.torch_import import (
        load_torch_state_dict,
    )

    ref = _tests_module("ref_ckpt_files")
    rng = np.random.default_rng(SEED)
    kept = {}
    for name, make, wrap, mapper, build, inputs, switch, kernels in (
            cases or _ref_cases()):
        path = work / f"{name}.pth"
        sd = make(rng)
        need = sum(v.nbytes for v in sd.values())
        free = shutil.disk_usage(work).free
        _check(free >= need + 2**30,
               f"ref_ckpt: {free / 2**30:.2f} GiB free under {work}, "
               f"{name} needs {need / 2**30:.2f} GiB (+1 GiB)")
        t0 = time.perf_counter()
        nbytes = ref.save_pth(path, sd, wrap)
        write_s = time.perf_counter() - t0
        del sd
        t0 = time.perf_counter()
        tree = mapper(load_torch_state_dict(str(path)))
        model = load_jax_params(build(dev).eval(), tree)
        _sync(dev)
        load_s = time.perf_counter() - t0
        equal, total = _equal_to_tree(model, tree)
        _check(equal == total, f"ref_ckpt {name}: {total - equal} of {total} "
               "tensors differ from the file")
        fields = dict(file=name, bytes=nbytes,
                      file_bytes=path.stat().st_size, tensors=total,
                      equal=equal, write_s=f"{write_s:.2f}",
                      load_s=f"{load_s:.2f}")
        path.unlink()
        if switch is not None:
            fields.update(_fused_vs_plain(model, inputs(dev, gen), switch,
                                          kernels, f"ref_ckpt {name}"))
        elif inputs is not None:
            with torch.no_grad():
                out = model(*inputs(dev, gen))
            _check(bool(torch.isfinite(out).all()),
                   f"ref_ckpt {name}: non-finite output")
            fields.update(shape=tuple(out.shape))
        _phase("ref_ckpt", **fields)
        if name == "chexbert":
            kept = {"model": model, "tree": tree}
        else:
            del model
        del tree
        torch.cuda.empty_cache()
    return kept


def phase_chexbert(model, tree) -> None:
    """The 48 synthetic reports (train, val and test) labelled by the
    CheXbert of ``ref_ckpt`` on the card and by the same weights on the
    CPU, one report a call as the JAX labeler: labels equal, the heads'
    logits within ``CHEXBERT_ATOL`` x max(1, largest); seconds a report on
    each, and the P/R/F1 that ``clinical_efficacy`` gives with the learned
    labeler (each report against the next)."""
    from medical_image_analysis_tpu_torch.ckpt.from_jax import load_jax_params
    from medical_image_analysis_tpu_torch.data.datasets import (
        synthetic_annotations,
    )
    from medical_image_analysis_tpu_torch.data.tokenizer import WordTokenizer
    from medical_image_analysis_tpu_torch.evalx.chexbert import (
        clinical_efficacy,
    )
    from medical_image_analysis_tpu_torch.evalx.chexbert_model import (
        CheXbert,
        make_learned_labeler,
    )
    from medical_image_analysis_tpu_torch.models.bert import BertConfig

    reports = [s.report for split in synthetic_annotations().values()
               for s in split]
    tok = WordTokenizer(sorted({w for r in reports for w in r.split()}))
    dev = next(model.parameters()).device
    cpu = load_jax_params(CheXbert(BertConfig()).eval(), tree)
    gap, scale = 0.0, 1.0
    with torch.no_grad():
        for r in reports:
            ids, mask = tok.pad(tok.encode(r, max_len=CHEXBERT_LEN),
                                CHEXBERT_LEN)
            ids, mask = torch.tensor([ids]), torch.tensor([mask])
            for a, b in zip(model(ids.to(dev), mask.to(dev)),
                            cpu(ids, mask)):
                gap = max(gap, (a.cpu() - b).abs().max().item())
                scale = max(scale, b.abs().max().item())
    _check(gap <= CHEXBERT_ATOL * scale,
           f"chexbert: logit gap {gap:.3e} > {CHEXBERT_ATOL} x {scale:.3f}")
    secs, labels = {}, {}
    for where, m in (("card", model), ("cpu", cpu)):
        labeler = make_learned_labeler(m, tok, max_len=CHEXBERT_LEN)
        _sync(dev)
        t0 = time.perf_counter()
        labels[where] = np.stack([labeler(r) for r in reports])
        _sync(dev)
        secs[where] = (time.perf_counter() - t0) / len(reports)
    _check(np.array_equal(labels["card"], labels["cpu"]),
           "chexbert: the card's labels differ from the CPU's")
    labeler = make_learned_labeler(model, tok, max_len=CHEXBERT_LEN)
    gts = {str(i): [r] for i, r in enumerate(reports)}
    res = {str(i): [reports[(i + 1) % len(reports)]]
           for i in range(len(reports))}
    ce = clinical_efficacy(gts, res, labeler=labeler)
    _phase("chexbert", reports=len(reports), max_len=CHEXBERT_LEN,
           logit_gap=f"{gap:.3e}", bound=f"{CHEXBERT_ATOL * scale:.3e}",
           positives=int(labels["card"].sum()),
           s_per_report=f"{secs['card']:.4f}",
           cpu_s_per_report=f"{secs['cpu']:.4f}",
           **{k: f"{v:.4f}" for k, v in ce.items()})


def _state_snapshot(state) -> dict:
    """Every tensor and number of a ``TrainState``, copied to the CPU."""
    sd = state.state_dict()

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        return tree.detach().cpu().clone() if isinstance(
            tree, torch.Tensor) else tree

    return cpu(sd)


def _same_state(a: dict, b: dict, what: str) -> int:
    """Checks two snapshots equal, bit for bit; returns the tensors."""
    n = 0
    for key in ("params", "frozen", "ema"):
        if a[key] is None or b[key] is None:
            _check(a[key] is b[key], f"{what}: {key} present in one only")
            continue
        _check(a[key].keys() == b[key].keys(), f"{what}: {key} names differ")
        for name, t in a[key].items():
            _check(torch.equal(t, b[key][name]), f"{what}: {key}/{name}")
            n += 1
    for key in ("mu", "nu"):
        for name, t in a["opt"][key].items():
            _check(torch.equal(t, b["opt"][key][name]),
                   f"{what}: {key}/{name}")
            n += 1
    _check(a["opt"]["count"] == b["opt"]["count"] and a["step"] == b["step"],
           f"{what}: count {a['opt']['count']} / {b['opt']['count']}, step "
           f"{a['step']} / {b['step']}")
    return n


def phase_resume_jax(save_dir: Path, device: str = "cuda",
                     overrides=()) -> list:
    """``dp_finetune`` (ViT-B/16, B=64, EMA) for one epoch of 2 steps; its
    state written in the JAX package's msgpack layout
    (``tests/jax_state_files.py``, optax's tree included), which
    ``restore_train_state`` must read back equal to the ``.pt``; then the
    run resumed once from the ``.pt`` and once from the ``.msgpack``
    through the CLI (``train.resume``): after the load every parameter,
    moment, EMA tensor, the count and the step equal the saved state's,
    and the next epoch's losses are equal. Returns the runs' counts."""
    from medical_image_analysis_tpu_torch.ckpt.checkpoint import (
        restore_train_state,
    )

    jsf = _tests_module("jax_state_files")
    first = _cls_through_cli("dp_finetune.yaml", save_dir / "first", device,
                             ("train.save_state_every_epochs=1",
                              *overrides))
    pt = save_dir / "first" / "state_epoch00000.pt"
    saved = torch.load(pt, map_location="cpu", weights_only=True)["state"]
    t0 = time.perf_counter()
    msgpack = Path(jsf.write_jax_state(str(save_dir / "jax"), saved, 0))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, epoch = restore_train_state(str(msgpack))
    read_s = time.perf_counter() - t0
    _check(epoch == 0, f"resume_jax: epoch {epoch}")
    n = _same_state(saved, back, "resume_jax: msgpack read back")
    runs, seen, losses = [first["launches"]], {}, {}
    for kind, path in (("pt", pt), ("msgpack", msgpack)):
        run_dir = save_dir / kind
        sets = ("data.dataset=synthetic_learnable",
                f"data.synthetic_train_size={CLS_TRAIN['dp_finetune.yaml']}",
                "train.epochs=2", f"train.resume={path}",
                "train.save_state_every_epochs=2", "train.log_every=1",
                f"train.save_dir={run_dir}", *overrides)
        argv = ["--config", str(PRESET.parent / "dp_finetune.yaml")]
        for item in sets:
            argv += ["--set", item]

        def snapshot(model, state, kind=kind):
            seen[kind] = _state_snapshot(state)
            return {}

        run = _train_through_cli(argv, run_dir, device, check_start=snapshot)
        runs.append(run["launches"])
        losses[kind] = run["losses"]
        del run
    _same_state(saved, seen["pt"], "resume_jax: resumed from .pt")
    _same_state(seen["pt"], seen["msgpack"], "resume_jax: .msgpack vs .pt")
    _check(losses["pt"] == losses["msgpack"],
           f"resume_jax: losses {losses['pt']} vs {losses['msgpack']}")
    _phase("resume_jax", preset="dp_finetune.yaml", tensors=n,
           count=saved["opt"]["count"], step=saved["step"],
           msgpack_bytes=msgpack.stat().st_size, pt_bytes=pt.stat().st_size,
           write_s=f"{write_s:.2f}", read_s=f"{read_s:.2f}",
           losses_pt=",".join(f"{x:.6f}" for x in losses["pt"]),
           losses_msgpack=",".join(f"{x:.6f}" for x in losses["msgpack"]))
    return runs


def phase_vision_init_jax(vocab: int, clip_artifact: Path, work: Path,
                          device: str = "cuda", overrides=()) -> None:
    """``clip_align``'s state (phase ``train_clip``) written as the JAX
    package writes one; ``model.vision_init`` at that ``.msgpack`` must
    resolve the same ARM overlay as at the ``.pt`` (names and tensors), and
    ``r2gengpt_mimic``'s initialisation (``init_mrg_model``, as ``fit_mrg``
    calls it) must graft every tensor that ``stage_chain`` grafted from the
    ``.pt``."""
    from medical_image_analysis_tpu_torch.ckpt.bridge import (
        flatten,
        load_pretrain_params,
        resolve_vision_overlay,
    )
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.train.loop import init_mrg_model

    jsf = _tests_module("jax_state_files")
    blob = torch.load(clip_artifact, map_location="cpu", weights_only=True)
    t0 = time.perf_counter()
    jpath = Path(jsf.write_jax_state(str(work), blob["state"],
                                     blob["epoch"]))
    write_s = time.perf_counter() - t0
    del blob
    overlay = {}
    for kind, path in (("pt", clip_artifact), ("msgpack", jpath)):
        t0 = time.perf_counter()
        overlay[kind] = flatten(resolve_vision_overlay(
            load_pretrain_params(str(path)), "arm"))
        overlay[f"{kind}_s"] = time.perf_counter() - t0
    _check(overlay["pt"].keys() == overlay["msgpack"].keys()
           and all(torch.equal(t, overlay["msgpack"][n])
                   for n, t in overlay["pt"].items()),
           "vision_init_jax: the .msgpack's overlay differs from the .pt's")
    clip = _flat_state(clip_artifact)
    tower = {n.split("/", 1)[1]: t for n, t in clip.items()
             if n.startswith("visual_encoder/")}
    cfg = load_config(str(PRESET), ["data.dataset=synthetic",
                                    f"model.llm_kwargs.vocab_size={vocab}",
                                    f"model.vision_init={jpath}", *overrides])
    t0 = time.perf_counter()
    model = init_mrg_model(cfg, vocab, {}, device)
    _sync(torch.device(device))
    init_s = time.perf_counter() - t0
    grafted = _grafted_check("vision/arm", tower, 1)(model, None)["grafted"]
    _check(grafted == len(overlay["pt"]),
           f"vision_init_jax: {grafted} grafted, the overlay has "
           f"{len(overlay['pt'])}")
    del model
    _phase("vision_init_jax", artifact=jpath.name,
           msgpack_bytes=jpath.stat().st_size, write_s=f"{write_s:.2f}",
           overlay_pt_s=f"{overlay['pt_s']:.2f}",
           overlay_msgpack_s=f"{overlay['msgpack_s']:.2f}",
           grafted=grafted, init_s=f"{init_s:.2f}")


def phase_throughput(device: str = "cuda", presets=THROUGHPUT_PRESETS,
                     overrides=()) -> list:
    """``cli.train --throughput`` on swinchex (swin_large, B=64),
    vssm_classify (vssm_tiny, B=128), r2gencsr_iu on vssm1_base and
    r2gengpt_mimic (ARM-B): prints each JSON, and the tower's kernels must
    have launched. Returns the runs' counts."""
    from medical_image_analysis_tpu_torch.cli import train as cli_train

    runs = []
    for preset, sets in presets:
        argv = ["--config", str(PRESET.parent / preset), "--throughput",
                "--device", device]
        for item in (*sets, *overrides):
            argv += ["--set", item]
        _reset_launches()
        t0 = time.perf_counter()
        stats = cli_train.main(argv)
        wall_s = time.perf_counter() - t0
        launches = _all_launches()
        runs.append(launches)
        tower = stats["vision"]
        if tower == "vssm" and any("d_state: 1" in s for s in sets):
            tower = "vssm1"
        elif tower not in ("swin", "vssm"):
            tower = "arm"  # as the JAX function, every other tower an ARM
        if torch.device(device).type == "cuda":
            _check(all(launches[k] > 0 for k in THROUGHPUT_KERNELS[tower]),
                   f"throughput {preset}: launches {launches}")
        _check(np.isfinite(stats["ms_per_iter"]) and stats["ms_per_iter"] > 0,
               f"throughput {preset}: {stats}")
        _phase("throughput", preset=preset, tower=tower,
               **{k: (f"{v:.3f}" if isinstance(v, float) else v)
                  for k, v in stats.items()},
               wall_s=f"{wall_s:.2f}",
               launches=_compact({k: v for k, v in launches.items() if v}))
    return runs


def phase_debug_nans(config: str, vocab: int, save_dir: Path,
                     plain: dict, device: str = "cuda",
                     overrides=()) -> dict:
    """``train``'s run again with ``train.debug_nans=true``, its validation
    (greedy decoding) included: its losses and scores must equal
    ``train``'s (``plain``, the losses and scores of that run), exactly.
    Then the same with a NaN put into the ARM's final norm before the first
    step: ``FloatingPointError`` naming that module. Returns the clean
    run's counts."""
    from medical_image_analysis_tpu_torch.cli import train as cli_train

    sets = ("data.dataset=synthetic", f"model.llm_kwargs.vocab_size={vocab}",
            "train.epochs=1", "train.save_state_every_epochs=2",
            "train.log_every=1", "train.debug_nans=true", *overrides)
    argv = ["--config", config]
    for item in (*sets, f"train.save_dir={save_dir / 'clean'}"):
        argv += ["--set", item]
    run = _train_through_cli(argv, save_dir / "clean", device)
    _check(run["losses"] == plain["losses"],
           f"debug_nans: losses {run['losses']} with the flag, "
           f"{plain['losses']} without")
    _check(run["scores"] == plain["scores"],
           f"debug_nans: scores {run['scores']} with the flag, "
           f"{plain['scores']} without")
    launches, fields = run["launches"], run["fields"]
    del run

    def poison(model, state):
        with torch.no_grad():
            model.vision.arm.norm_f.weight[0] = float("nan")

    argv = ["--config", config, "--device", device]
    for item in (*sets, f"train.save_dir={save_dir / 'nan'}"):
        argv += ["--set", item]
    message = ""
    try:
        cli_train.main(argv, on_start=poison)
    except FloatingPointError as e:
        message = str(e)
    _check("module vision.arm.norm_f output" in message,
           f"debug_nans: the injected NaN raised {message!r}")
    _phase("debug_nans", preset=Path(config).name, raised=repr(message),
           losses=fields["losses"], step_s=fields["step_s"],
           setup_s=fields["setup_s"], val_s=fields["val_s"])
    return launches


# The last slice: the general scan at every d_state and the fused layer past
# its kernels' widths; training and serving over several processes. The card
# machine has one H100 and NCCL puts no two ranks on one device, so the
# multi-process phases run their ranks as processes that share the card over
# gloo (CUDA tensors; every collective copies through the host): their step
# seconds are not a multi-GPU speed. The NCCL code path runs as a group of
# world size 1 (multi_gpu_nccl1).

SS_WIDTHS = (2, 5, 12, 17, 32, 40, 64)
SS_WIDTH_SHAPE = (2, 4, 197, 192)  # batch, K, L, D: ARM-B's L
SS_N32_CASE = "vssm_tiny stage 0 B=128 N=32"
FUSED_WIDE = ((40, 4), (12, 5))  # (d_state, taps): past 32 states, 4 taps
MULTI_GRID = (2, 2)  # (data, model)
MULTI_SETS = ("data.dataset=synthetic", f"model.llm_kwargs.vocab_size={VOCAB}",
              "model.llm_kwargs.dtype=float32", "data.batch_size=16",
              "train.accum_steps=2", "train.zero_opt=true",
              "train.warmup_steps=1", "train.epochs=1",
              "train.val_every_epochs=2", "train.save_state_every_epochs=2",
              "train.log_every=1")  # 2 steps of the 32 synthetic studies
MULTI_RTOL = 1e-5  # loss and post-step norm (JAX dryrun_multichip's bound)
TP_SERVE_SETS = ("model.llm_kwargs.dtype=float32",
                 "generate.max_new_tokens=40", "generate.min_new_tokens=20")
TP_SERVE_REQUESTS = 2
SP_SHAPE = (2, 2048, 256, 16)  # batch, L, D, N
SP_RTOL = 1e-4  # plain fp32 loop against the kernel's fp32 walk
CHILD_TIMEOUT = 900.0


def _ptxas(log: str, keys=("selective_scan", "Li32E")) -> dict:
    """{kernel: "registers/spill stores/spill loads"} of the entries whose
    mangled names hold every one of ``keys``, from nvcc's ptxas log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if all(k in m.group(1) for k in keys) else None
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m[1])
    short = {}
    for name, v in out.items():
        kind = "fwd" if "fwd" in name else "bwd"
        src = "bf16" if "bfloat16" in name else "fp32"
        short[f"{kind}_{src}"] = (f"{v.get('registers', '?')}reg/"
                                  f"{v.get('spill_stores', '?')}st/"
                                  f"{v.get('spill_loads', '?')}ld")
    return short


def phase_ss_widths(dev, gen) -> dict:
    """The general scan's wrappers at every d_state of ``SS_WIDTHS`` (the
    kernels are built for 1, 4, 8, 16 and 32: the others pad up, past 32
    run in groups) against the plain versions, fp32 and bf16, forward and
    backward, a launch per state group and call; ptxas's registers and
    spills of the N = 32 kernels; both kernels timed at vssm_tiny's stage
    0, B=128, N=32 beside their bounds (the kernels line's ``_n32`` rows);
    then the fused Mamba layer past its kernels' 32 states and 4 taps,
    forward and every gradient, against its plain version."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf
    from medical_image_analysis_tpu_torch.ops import selective_scan_pallas as ssp

    b, k, l, d = SS_WIDTH_SHAPE
    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "ddelta_bias")
    for n in SS_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            args = _ss_case(dev, gen, b, k, l, d, n, dtype)
            dy = torch.randn(b * k, l, d, device=dev, generator=gen).to(dtype)
            before = dict(ssp.launches)
            y = ssp.selective_scan_fwd(*args, True)
            got = ssp.selective_scan_bwd(*args, dy, True)
            _sync(dev)
            groups = len(ssp.state_groups(n))
            _check({key: ssp.launches[key] - before[key] for key in before}
                   == dict.fromkeys(before, groups),
                   f"ss_widths N={n}: launches {ssp.launches} from {before}")
            errs = {}
            for name, g, w in zip(("y", *names),
                                  (y, *got),
                                  (ssp.selective_scan_fwd_plain(*args, True),
                                   *ssp.selective_scan_bwd_plain(*args, dy,
                                                                 True))):
                _check(g.shape == w.shape and g.dtype == w.dtype
                       and bool(torch.isfinite(g).all()),
                       f"ss_widths N={n} {name}: shape, dtype or finiteness")
                err, scale = _max_err(g, w)
                tol = (Y_RTOL[g.dtype] if g.dtype == torch.bfloat16
                       else BWD_RTOL)
                _check(err <= tol * scale,
                       f"ss_widths N={n} {dtype} {name}: max abs err "
                       f"{err:.3e} > {tol} x {scale:.3f}")
                errs[name] = f"{err:.2e}"
            _phase("ss_widths", N=n, src=_dtype_name(dtype), B=b, K=k, L=l,
                   D=d, launches_a_call=groups, width=ssp.state_width(
                       min(n, 32)), errs=json.dumps(errs, separators=(",",
                                                                      ":")))
            del args, dy, y, got
    _, log = ssp.build()
    _phase("ss_widths_ptxas", n=32, kernels=json.dumps(
        _ptxas(log) if log != "cached" else "not read (a cached build)",
        separators=(",", ":")))
    rows = {}
    l0, d0 = SS_VSSM_STAGES[0]
    for kind in ("fwd", "bwd"):
        args = _ss_case(dev, gen, SS_VSSM_BATCH, 4, l0, d0, 32, torch.float32)
        extra = []
        if kind == "fwd":
            def plain():
                return (ssp.selective_scan_fwd_plain(*args, True),)

            def kernel():
                return (ssp.selective_scan_fwd(*args, True),)
        else:
            dy = torch.randn(SS_VSSM_BATCH * 4, l0, d0, device=dev,
                             generator=gen)
            extra = [dy]

            def plain():
                return ssp.selective_scan_bwd_plain(*args, dy, True)

            def kernel():
                return ssp.selective_scan_bwd(*args, dy, True)
        want, got = plain(), kernel()
        err = max(_max_err(g, w)[0] for g, w in zip(got, want))
        scale = max(_max_err(g, w)[1] for g, w in zip(got, want))
        _check(err <= BWD_RTOL * scale,
               f"ss_widths {SS_N32_CASE} {kind}: max abs err {err:.3e}")
        del want
        t = _in_turns(plain, kernel, 1, 3)
        bound = _bound([*args, *extra, *got], ssp.flops(
            kind, SS_VSSM_BATCH * 4, l0, d0, 32))
        occ = (ssp.fwd_occupancy if kind == "fwd" else ssp.bwd_occupancy)(
            32, torch.float32)
        _phase("ss_widths_n32", kind=kind, case=SS_N32_CASE,
               err=f"{err:.3e}", ms=f"{t['kernel']:.4f}",
               plain_ms=f"{t['plain']:.4f}", bound_ms=f"{bound[0]:.4f}",
               bound_by=bound[1], blocks_per_sm=occ[0], smem_bytes=occ[1])
        rows[f"selective_scan_{kind}_n32"] = (err, t["kernel"], t["plain"],
                                              *bound[:2])
        del args, got, extra
        torch.cuda.empty_cache()
    k_dirs, fb, fl, fd, fr = 4, 2, 197, 192, 6
    for n, taps in FUSED_WIDE:
        rng = np.random.default_rng(n + taps)

        def t_(*shape, scale=0.5):
            return torch.from_numpy((rng.standard_normal(shape) * scale)
                                    .astype(np.float32)).to(dev)

        leaves0 = [t_(fb, fl, fd), t_(fb, fl, fd), t_(k_dirs, taps, fd),
                   t_(k_dirs, fd), t_(k_dirs, fr + 2 * n, fd),
                   t_(k_dirs, fd, fr), t_(k_dirs, fd),
                   -torch.exp(t_(k_dirs, fd, n, scale=0.3)), t_(k_dirs, fd)]
        cot = t_(fb, k_dirs, fl, fd, scale=1.0)

        def run(plain):
            leaves = [x.clone().requires_grad_() for x in leaves0]
            y = mf.mamba_fused_dirs(*leaves, plain=plain)
            (y * cot).sum().backward()
            return y.detach(), [x.grad for x in leaves]

        mf.reset_launches()
        got_y, got_g = run(False)
        _sync(dev)
        launched = dict(mf.launches)
        want_y, want_g = run(True)
        _check(all(v > 0 for v in launched.values()),
               f"fused N={n} taps={taps}: launches {launched}")
        err_y, scale = _max_err(got_y, want_y)
        _check(err_y <= Y_RTOL[torch.float32] * scale,
               f"fused N={n} taps={taps}: y err {err_y:.3e}")
        worst = 0.0
        for g, w in zip(got_g, want_g):
            rel = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
            worst = max(worst, rel)
        _check(worst <= BWD_RTOL,
               f"fused N={n} taps={taps}: gradient rel err {worst:.3e}")
        _phase("ss_widths_fused", N=n, taps=taps, K=k_dirs, B=fb, L=fl, D=fd,
               y_err=f"{err_y:.3e}", grad_rel_err=f"{worst:.3e}",
               launches=json.dumps(launched, separators=(",", ":")))
    return rows


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child(fn, rank, world, port, args, out):
    import os
    import traceback

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        torch.set_num_threads(2)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out.put((rank, "ok", fn(rank, world, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent
        out.put((rank, "error", traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(fn, world: int, *args, timeout: float = CHILD_TIMEOUT) -> list:
    """``fn(rank, world, *args)`` in ``world`` processes (the ``spawn``
    method, one hash seed for all: the synthetic images follow it), joined
    by torchrun's variables on a free port; their results in rank order.
    A rank that raises, dies or outlives ``timeout`` fails the phase, and
    every process is then killed."""
    import multiprocessing as mp
    import os
    import queue

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child, args=(fn, r, world, port, args, out),
                         daemon=True) for r in range(world)]
    saved = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        for p in procs:
            p.start()
    finally:
        if saved is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = saved
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            try:
                rank, status, value = out.get(timeout=max(left, 1.0))
            except queue.Empty:
                raise RuntimeError(
                    f"chip_smoke: ranks {sorted(set(range(world)) - set(results))}"
                    f" of {fn.__name__} gave no result in {timeout} s") from None
            _check(status == "ok", f"{fn.__name__} rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(world)]


def _train_ranks(sets, save_dir: str, out_path: str, mesh=None) -> dict:
    """``cli.train.main`` of the preset with ``sets`` in this process (a
    rank of the job, or its only process), the counts at 0 just before the
    first step and read just after the last; every rank times its steps
    (synchronised) and counts the collectives' bytes. Rank 0 saves the
    trained tensors (gathered whole) to ``out_path``. ``mesh``, when given,
    is the grid the run takes instead of ``_mesh_for``'s."""
    import torch.distributed as dist

    from medical_image_analysis_tpu_torch.cli import train as cli_train
    from medical_image_analysis_tpu_torch.parallel import mesh as pm
    from medical_image_analysis_tpu_torch.train import loop

    seen, step_s = {}, []
    real_step, real_mesh = loop.make_train_step, loop._mesh_for

    def timed_step(*a, **kw):
        step = real_step(*a, **kw)

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return m
        return timed

    def on_start(model, state):
        seen["model"], seen["state"] = model, state
        torch.cuda.synchronize()
        _reset_launches()
        pm.reset_traffic()

    loop.make_train_step = timed_step
    if mesh is not None:
        loop._mesh_for = lambda *a, **kw: mesh
    try:
        argv = ["--config", str(PRESET), "--device", "cuda"]
        for item in (*sets, f"train.save_dir={save_dir}"):
            argv += ["--set", item]
        cli_train.main(argv, on_start=on_start)
    finally:
        loop.make_train_step, loop._mesh_for = real_step, real_mesh
    torch.cuda.synchronize()
    launches, traffic = _all_launches(), dict(pm.traffic)
    state = seen["state"]
    plan = state.plan
    whole = state.whole_params()
    rank = dist.get_rank() if dist.is_initialized() else 0
    res = {"launches": launches, "traffic": traffic, "step_s": step_s,
           "zero": 0 if plan is None else len(plan.zero),
           "cut": 0 if plan is None else len(plan.tp),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if rank == 0:
        torch.save({n: t.detach().cpu() for n, t in whole.items()}, out_path)
        with open(Path(save_dir) / "log.txt") as f:
            steps = [r for r in map(json.loads, f) if "step" in r]
        res.update(losses=[r["loss"] for r in steps],
                   grad_norms=[r["grad_norm"] for r in steps],
                   lr=max(r["lr"] for r in steps),
                   norm=float(torch.sqrt(sum(
                       (t.double() ** 2).sum() for t in whole.values()))))
    del seen, state, whole
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _serve_ranks(pngs, config: str) -> list | None:
    """``cli.demo``'s pipeline of ``config`` (tensor-parallel over the job's
    processes, or whole in one): rank 0 generates for each PNG and returns
    the tokens; the other ranks follow."""
    from medical_image_analysis_tpu_torch.cli.demo import build_pipeline
    from medical_image_analysis_tpu_torch.parallel.mesh import world_and_rank

    pipe = build_pipeline(argparse.Namespace(
        config=config, vocab=None, vocab_size=VOCAB, delta=None,
        device="cuda", seed=SEED))
    if world_and_rank()[1] != 0:
        pipe.follow()
        return None
    import PIL.Image

    try:
        tokens = []
        for png in pngs:
            with PIL.Image.open(io.BytesIO(png)) as pil:
                img = np.asarray(pil.convert("RGB"), np.uint8)
            tokens.append(pipe(img)["ids"])
    finally:
        pipe.stop()
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return tokens


def _sp_ranks(rank, world, inputs, softplus) -> np.ndarray:
    from medical_image_analysis_tpu_torch.parallel.mesh import make_mesh
    from medical_image_analysis_tpu_torch.parallel.sp_scan import (
        selective_scan_sp,
    )

    mesh = make_mesh(world, 1)
    t = {k: torch.from_numpy(v).cuda() for k, v in _sp_case(inputs,
                                                            softplus).items()}
    rows = t["u"].shape[1] // world
    sl = slice(rank * rows, (rank + 1) * rows)
    y = selective_scan_sp(t["u"][:, sl], t["delta"][:, sl], t["A"],
                          t["B"][:, sl], t["C"][:, sl], t["D"],
                          t["delta_bias"], softplus, mesh)
    torch.cuda.synchronize()
    return y.cpu().numpy()


def _sp_case(inputs: dict, softplus: bool) -> dict:
    """Without softplus, dt = |delta| + |bias|: the states keep decaying
    over the 2,048 rows (a negative dt grows them past fp32)."""
    if softplus:
        return inputs
    return {**inputs, "delta": np.abs(inputs["delta"]),
            "delta_bias": np.abs(inputs["delta_bias"])}


def _sp_inputs() -> dict:
    b, l, d, n = SP_SHAPE
    rng = np.random.default_rng(SEED)

    def t(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(u=t(b, l, d), delta=t(b, l, d, scale=0.5),
                A=-np.exp(t(d, n, scale=0.3)), B=t(b, l, n), C=t(b, l, n),
                D=t(d), delta_bias=t(d, scale=0.2))


def _one_child(rank, world, work: str, serve_cfg: str, pngs):
    """The one-process side: the preset's 2 steps (plain, no grid), the
    same 2 steps through an NCCL group of world size 1 (every collective
    of the sharded step over it), and the served tokens."""
    import torch.distributed as dist

    from medical_image_analysis_tpu_torch.parallel.mesh import Mesh

    plain = _train_ranks(MULTI_SETS, f"{work}/one", f"{work}/one.pt")
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1,
        rank=0)
    mesh = Mesh(1, 1, 0)
    mesh.groups = {"data": dist.group.WORLD, "model": dist.group.WORLD}
    nccl = _train_ranks(MULTI_SETS, f"{work}/nccl1", f"{work}/nccl1.pt",
                        mesh)
    dist.destroy_process_group()
    tokens = _serve_ranks(pngs, serve_cfg)
    return {"plain": plain, "nccl": nccl, "tokens": tokens}


def _pair_child(rank, world, serve_cfg: str, pngs, sp):
    from medical_image_analysis_tpu_torch.parallel.mesh import (
        init_distributed,
    )

    init_distributed()
    tokens = _serve_ranks(pngs, serve_cfg)
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    serve_launches = dict(mf.launches)
    ys = [_sp_ranks(rank, world, sp, s) for s in (True, False)]
    return {"tokens": tokens, "serve_launches": serve_launches, "sp": ys}


def _quad_child(rank, world, work: str, sp):
    res = _train_ranks(
        (*MULTI_SETS, f"train.mesh_data={MULTI_GRID[0]}",
         f"train.mesh_model={MULTI_GRID[1]}"), f"{work}/quad",
        f"{work}/quad.pt")
    res["sp"] = [_sp_ranks(rank, world, sp, s) for s in (True, False)]
    return res


def _serve_config(work: Path) -> str:
    import yaml

    raw = yaml.safe_load(PRESET.read_text())
    for item in TP_SERVE_SETS:
        key, value = item.split("=", 1)
        sect, *path = key.split(".")
        node = raw.setdefault(sect, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = yaml.safe_load(value)
    out = work / "serve_tp.yaml"
    out.write_text(yaml.safe_dump(raw))
    return str(out)


def _tensors_close(one: dict, other: dict, lr: float, what: str) -> float:
    """Every trained tensor of ``other`` within MULTI_RTOL of the
    one-process tensor's largest value plus 5e-2 of the learning rate (Adam
    divides each element's gradient by its own running RMS: a reordered sum
    moves an element whose gradient is near the others' rounding by a
    fraction of lr); returns the largest gap over that bound's first
    term."""
    _check(one.keys() == other.keys(), f"{what}: other tensors")
    worst = 0.0
    for n, a in one.items():
        b = other[n]
        _check(a.shape == b.shape, f"{what}: {n} shape")
        gap = (a.double() - b.double()).abs().max().item()
        scale = a.double().abs().max().item()
        _check(gap <= MULTI_RTOL * scale + 5e-2 * lr,
               f"{what}: {n} differs by {gap:.3e} (max {scale:.3e})")
        worst = max(worst, gap / max(scale, 1e-30))
    return worst


def phase_multi_gpu(work: Path) -> list:
    """multi_gpu, multi_gpu_nccl1, tp_serve and sp_scan (see the module's
    docstring); returns the launches of the 4-process run's rank 0 for the
    kernels line."""
    from medical_image_analysis_tpu_torch.ops import selective_scan_pallas as ssp

    rng = np.random.default_rng(SEED)
    pngs = [_png(rng, 224) for _ in range(TP_SERVE_REQUESTS)]
    serve_cfg = _serve_config(work)
    sp = _sp_inputs()
    t0 = time.perf_counter()
    one = _spawn(_one_child, 1, str(work), serve_cfg, pngs)[0]
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    quad = _spawn(_quad_child, 4, str(work), sp)
    quad_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pair = _spawn(_pair_child, 2, serve_cfg, pngs, sp)
    pair_s = time.perf_counter() - t0

    # multi_gpu: (2, 2) against one process
    ref = one["plain"]
    want = torch.load(work / "one.pt", weights_only=True)
    got = torch.load(work / "quad.pt", weights_only=True)
    lead = quad[0]
    for i, (a, b) in enumerate(zip(ref["losses"], lead["losses"])):
        _check(abs(a - b) <= MULTI_RTOL * abs(a),
               f"multi_gpu: step {i} loss {b} against {a}")
    _check(len(lead["losses"]) == len(ref["losses"]) == 2, "multi_gpu: steps")
    _check(abs(lead["norm"] - ref["norm"]) <= MULTI_RTOL * ref["norm"],
           f"multi_gpu: post-step norm {lead['norm']} against {ref['norm']}")
    worst = _tensors_close(want, got, ref["lr"], "multi_gpu")
    steps = len(ref["losses"])
    for r, res in enumerate(quad):
        fused = {k: v for k, v in res["launches"].items()
                 if k.startswith("mamba_")}
        _check(all(v > 0 for v in fused.values()),
               f"multi_gpu rank {r}: fused kernels {fused}")
        _phase("multi_gpu_rank", rank=r, grid="x".join(map(str, MULTI_GRID)),
               backend="gloo, CUDA tensors, 4 processes on one card",
               launches=json.dumps(fused, separators=(",", ":")),
               step_s_gloo_one_card=",".join(f"{s:.3f}"
                                             for s in res["step_s"]),
               all_reduce_bytes_a_step=res["traffic"]["all_reduce"] // steps,
               all_gather_bytes_a_step=res["traffic"]["all_gather"] // steps,
               broadcast_bytes_a_step=res["traffic"]["broadcast"] // steps,
               zero_slices=res["zero"], tp_cut=res["cut"],
               peak_mem_gib=f"{res['peak_gib']:.2f}")
    _phase("multi_gpu", preset=PRESET.name,
           grid="x".join(map(str, MULTI_GRID)),
           losses=",".join(f"{x:.6f}" for x in lead["losses"]),
           losses_one=",".join(f"{x:.6f}" for x in ref["losses"]),
           norm=f"{lead['norm']:.6f}", norm_one=f"{ref['norm']:.6f}",
           tensors=len(want), worst_rel_gap=f"{worst:.2e}",
           step_s_one=",".join(f"{s:.3f}" for s in ref["step_s"]),
           one_process_s=f"{one_s:.1f}", four_process_s=f"{quad_s:.1f}")

    # multi_gpu_nccl1: the sharded step through NCCL at world size 1
    nccl = one["nccl"]
    got1 = torch.load(work / "nccl1.pt", weights_only=True)
    _check(all(abs(a - b) <= 1e-6 * abs(a)
               for a, b in zip(ref["losses"], nccl["losses"]))
           and len(nccl["losses"]) == len(ref["losses"]),
           f"multi_gpu_nccl1: losses {nccl['losses']} against {ref['losses']}")
    worst1 = _tensors_close(want, got1, ref["lr"], "multi_gpu_nccl1")
    _check(nccl["traffic"]["all_reduce"] > 0, "multi_gpu_nccl1: no NCCL")
    _phase("multi_gpu_nccl1", backend="nccl", world=1,
           losses=",".join(f"{x:.6f}" for x in nccl["losses"]),
           worst_rel_gap=f"{worst1:.2e}",
           all_reduce_bytes_a_step=nccl["traffic"]["all_reduce"] // steps,
           step_s=",".join(f"{s:.3f}" for s in nccl["step_s"]))

    # tp_serve: model=2 on 2 processes, beam 3, the one process's tokens
    _check(pair[0]["tokens"] == one["tokens"],
           f"tp_serve: tokens differ from the one process's")
    _check(pair[1]["tokens"] is None, "tp_serve: rank 1 served")
    fwd = {k: v for k, v in pair[0]["serve_launches"].items()
           if k in ("mamba_xdbl", "mamba_scan")}
    _check(all(v > 0 for v in fwd.values())
           and pair[0]["serve_launches"].get("mamba_scan_bwd") == 0,
           f"tp_serve: fused kernels {pair[0]['serve_launches']}")
    _phase("tp_serve", grid="1x2", backend="gloo, CUDA tensors, one card",
           requests=len(pngs), tokens=len(one["tokens"][0]),
           equal=True, launches=json.dumps(fwd, separators=(",", ":")),
           pair_s=f"{pair_s:.1f}")

    # sp_scan against the CUDA selective-scan kernel on the whole sequence
    for i, softplus in enumerate((True, False)):
        t = {k: torch.from_numpy(v).cuda()
             for k, v in _sp_case(sp, softplus).items()}
        before = ssp.launches["selective_scan_fwd"]
        whole = ssp.selective_scan_pallas(
            t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"],
            t["delta_bias"], softplus)
        torch.cuda.synchronize()
        _check(ssp.launches["selective_scan_fwd"] == before + 1,
               "sp_scan: the kernel did not launch")
        want_y = whole.cpu().numpy()
        scale = max(1.0, float(np.abs(want_y).max()))
        for world, res in ((2, pair), (4, quad)):
            got_y = np.concatenate([r["sp"][i] for r in res], axis=1)
            err = float(np.abs(got_y - want_y).max())
            _check(err <= SP_RTOL * scale,
                   f"sp_scan {world} ranks softplus={softplus}: err {err:.3e}")
            _phase("sp_scan", ranks=world, softplus=softplus,
                   shape="x".join(map(str, SP_SHAPE)), err=f"{err:.3e}",
                   bound=f"{SP_RTOL * scale:.3e}",
                   exchange_bytes=2 * SP_SHAPE[0] * SP_SHAPE[2]
                   * SP_SHAPE[3] * 4 * world)
    return [lead["launches"]]


def phase_hf_tp_load(ckpt: Path, dev) -> None:
    """``load_llm_params(mesh=)`` of the hf_ckpt checkpoint at model=2, bf16
    and int8: each rank's tensors equal its slices of the full load's; the
    bytes each read."""
    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        flax_named_parameters,
    )
    from medical_image_analysis_tpu_torch.ckpt.hf_load import (
        load_llm_params,
        read_hf_config,
    )
    from medical_image_analysis_tpu_torch.models.llm import TransformerLM
    from medical_image_analysis_tpu_torch.parallel.mesh import Mesh
    from medical_image_analysis_tpu_torch.parallel.tp import tp_slice

    for int8 in (False, True):
        cfg = read_hf_config(str(ckpt), quant_int8=int8)
        full = TransformerLM(cfg, device=dev)
        t0 = time.perf_counter()
        load_llm_params(str(ckpt), full)
        full_s = time.perf_counter() - t0
        whole = flax_named_parameters(full)
        read, secs = [], []
        for rank in range(2):
            part = TransformerLM(cfg, device=dev)
            t0 = time.perf_counter()
            load_llm_params(str(ckpt), part, mesh=Mesh(1, 2, rank,
                                                       groups=False))
            secs.append(time.perf_counter() - t0)
            got = flax_named_parameters(part)
            _check(got.keys() == whole.keys(), "hf_tp_load: names")
            for n, w in whole.items():
                how = part.tp_cut.get(n)
                want = w if how is None else tp_slice(w, how[0], 2, rank,
                                                      how[1])
                _check(torch.equal(got[n].detach(), want.detach()),
                       f"hf_tp_load int8={int8} rank {rank}: {n}")
            read.append(part.bytes_read)
            _check(part.bytes_read < full.bytes_read,
                   "hf_tp_load: a rank read the whole checkpoint")
            del part, got
        _phase("hf_tp_load", int8=int8, grid="1x2", tensors=len(whole),
               full_bytes=full.bytes_read,
               rank_bytes=",".join(map(str, read)),
               full_s=f"{full_s:.2f}",
               rank_s=",".join(f"{s:.2f}" for s in secs))
        del full, whole
        gc.collect()
        torch.cuda.empty_cache()


def main() -> None:
    phase_device()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(SEED)
    from medical_image_analysis_tpu_torch.configs.config import load_config

    cfg = load_config(str(PRESET))
    phase_build()
    measured = phase_kernels(cfg, dev, gen)
    phase_kernels_fwd_vssm(dev, gen)
    measured["mamba_scan_bwd"] = phase_kernels_bwd(cfg, dev, gen)
    measured["scan_n1_fwd"] = phase_kernels_n1(dev, gen)
    measured["scan_n1_bwd"] = phase_kernels_n1_bwd(dev, gen)
    _reset_launches()
    pipe, png, launches, depth = phase_serve(str(PRESET), VOCAB, "cuda",
                                             REQUESTS)
    for name in ("mamba_xdbl", "mamba_scan"):
        _check(launches.get(name, 0) == depth * REQUESTS,
               f"{name} launched {launches.get(name, 0)} times while serving; "
               f"expected {depth} layers x {REQUESTS} requests")
    _check(launches.get("mamba_scan_bwd") == 0,
           "the backward kernel launched while serving")
    phase_tower(pipe, png)
    del pipe
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        run = phase_train(str(PRESET), VOCAB, Path(tmp))
    phase_train_grads(run["model"], run["state"], str(PRESET), run["batch"],
                      run["accum"])
    train_launches = run["launches"]
    train_plain = {"losses": run["losses"], "scores": run["scores"]}
    del run
    torch.cuda.empty_cache()
    # real checkpoint files: an HF directory of Qwen1.5-1.8B's shape,
    # served in bf16 and in int8 and trained on; the on-device preprocessing
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hf_") as tmp:
        ckpt = Path(tmp) / "qwen1_5_1_8b"
        ckpt.mkdir()
        phase_hf_ckpt(ckpt, dev)
        phase_hf_tp_load(ckpt, dev)
        bf16 = phase_serve_hf(ckpt, Path(tmp))
        int8 = phase_serve_hf(ckpt, Path(tmp), int8=True, ref=bf16)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as run_dir:
            hf_runs = [bf16["launches"], int8["launches"],
                       phase_train_hf(ckpt, Path(run_dir))]
        del bf16, int8
        torch.cuda.empty_cache()
        phase_prep_dev(dev, Path(tmp))
    # MambaXray-VL: AR pretraining -> CLIP alignment -> the SFT above
    phase_kernels_ar(dev, gen)
    pretrain_launches = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ar_") as ar_dir, \
            tempfile.TemporaryDirectory(prefix="chip_smoke_clip_") as clip_dir:
        ar = phase_train_ar(Path(ar_dir))
        phase_train_ar_grads(ar["model"], ar["sets"])
        pretrain_launches.append(ar["launches"])
        ar_artifact = ar["artifact"]
        del ar
        torch.cuda.empty_cache()
        clip = phase_train_clip(ar_artifact, Path(clip_dir))
        pretrain_launches.append(clip["launches"])
        clip_artifact = clip["artifact"]
        del clip
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_chain_") as tmp:
            pretrain_launches.append(phase_stage_chain(
                VOCAB, clip_artifact, Path(tmp))["launches"])
            phase_vision_init_jax(VOCAB, clip_artifact, Path(tmp))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_csr_") as tmp:
        csr = phase_train_csr(VOCAB, Path(tmp))
    phase_train_csr_grads(csr["model"], csr["state"], csr["overrides"])
    csr_launches = csr["launches"]
    del csr
    torch.cuda.empty_cache()
    measured.update(phase_kernels_vit(dev, gen))
    measured.update(phase_kernels_vit_bwd(dev, gen))
    phase_kernels_vit_parts(dev, gen)
    phase_kernels_swin_parts(dev, gen)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mae_") as tmp:
        mae = phase_train_mae(Path(tmp))
    phase_train_mae_grads(mae["model"], mae["overrides"])
    runs = [launches, train_launches, *hf_runs, *pretrain_launches,
            csr_launches, mae["launches"]]
    del mae
    torch.cuda.empty_cache()

    measured.update({f"swin_attn_fwd{k}": v
                     for k, v in phase_kernels_swin(dev, gen).items()})
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cls_") as tmp:
        cls = phase_train_cls(Path(tmp))
    phase_tower_cls(cls["model"], cls["sets"])
    runs.append(cls["launches"])
    del cls
    cls_fields = {}
    for preset in ("vssm_classify.yaml", "dp_finetune.yaml"):
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cls_") as tmp:
            other = phase_train_cls_other(preset, Path(tmp))
        runs.append(other["launches"])
        cls_fields[preset] = other["fields"]
        del other
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_csr_swin_") as tmp:
        runs.append(phase_train_csr_swin(VOCAB, Path(tmp))["launches"])

    torch.cuda.empty_cache()
    measured["selective_scan_fwd"] = phase_kernels_ss(dev, gen, "fwd")
    measured["selective_scan_bwd"] = phase_kernels_ss(dev, gen, "bwd")
    measured.update(phase_ss_widths(dev, gen))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cls_") as tmp:
        pallas = phase_train_cls_other("vssm_classify.yaml", Path(tmp),
                                       overrides=(VSSM_PALLAS,))
    runs.append(pallas["launches"])
    fused = cls_fields["vssm_classify.yaml"]
    _phase("train_cls_vssm_pallas_vs_fused", **{
        f"{k}{suffix}": f[k] for k in ("step_s", "val_s", "peak_mem_gib")
        for suffix, f in (("", pallas["fields"]), ("_fused", fused))})
    del pallas
    torch.cuda.empty_cache()
    runs.append(phase_tower_arm_pallas(dev, gen))
    torch.cuda.empty_cache()
    measured["fused_attention"] = phase_kernels_attn(dev, gen)
    runs.append(phase_attn(dev, gen))

    # AM-MRG and R2GenKG
    torch.cuda.empty_cache()
    measured.update(phase_kernels_am(dev, gen))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_am_") as tmp:
        am = phase_train_am_mrg(VOCAB, Path(tmp))
    phase_train_am_mrg_grads(am["model"], am["state"], am["sets"])
    runs.append(am["launches"])
    del am
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kg_") as tmp:
        runs.append(phase_train_r2genkg(VOCAB, Path(tmp))["launches"])

    # EMRRG and R2Gen
    torch.cuda.empty_cache()
    measured.update(phase_kernels_emrrg(dev, gen))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_emrrg_") as tmp:
        em = phase_train_emrrg(VOCAB, Path(tmp))
    phase_train_emrrg_grads(em["model"], em["state"], em["sets"])
    runs.append(em["launches"])
    del em
    torch.cuda.empty_cache()
    measured.update(phase_kernels_r2gen(dev, gen))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_r2gen_") as tmp:
        r2 = phase_train_r2gen(Path(tmp))
    phase_train_r2gen_grads(r2["model"], r2["sets"])
    runs.append(r2["launches"])
    del r2

    # The Mamba LM's SFT, and MAC-RRG trained and refined
    torch.cuda.empty_cache()
    measured.update(phase_kernels_lm(dev, gen))
    measured.update(phase_kernels_peft17(dev, gen))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
        lm = phase_train_lm_sft(Path(tmp))
    phase_train_lm_sft_grads(lm["model"], lm["sets"])
    phase_lm_decode(lm["model"], lm["sets"])
    runs.append(lm["launches"])
    # the weight-space MambaPEFT family at d_state 17
    runs.append(phase_peft_lm(lm["model"], lm["sets"]))
    del lm
    torch.cuda.empty_cache()
    runs.append(phase_peft_arm(dev, gen))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mac_") as tmp:
        mac = phase_train_mac_rrg(VOCAB, Path(tmp))
        runs.append(mac["launches"])
        phase_tower_mac_rrg(mac["model"], mac["sets"])
        runs += phase_refine_mac_rrg(mac, Path(tmp))
    del mac

    # The reference's checkpoints and the learned labeler; JAX train states
    # resumed; --throughput; train.debug_nans
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ref_") as tmp:
        chex = phase_ref_ckpt(Path(tmp), dev, gen)
    phase_chexbert(chex["model"], chex["tree"])
    del chex
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
        runs += phase_resume_jax(Path(tmp))
    torch.cuda.empty_cache()
    runs += phase_throughput()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nans_") as tmp:
        runs.append(phase_debug_nans(str(PRESET), VOCAB, Path(tmp),
                                     train_plain))

    # several processes: (data 2, model 2) training, NCCL at world size 1,
    # tensor-parallel serving, the sequence-parallel scan
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multi_") as tmp:
        runs += phase_multi_gpu(Path(tmp))

    # launches: the main paths' runs (serving in bf16 and int8 from the HF
    # checkpoint, the eighteen trainings with train_hf, the
    # ARM tower on scan_backend=pallas, the Attention module, the MAC-RRG
    # refinement, the dp_finetune runs resumed from a .pt and a JAX
    # .msgpack, the four --throughput towers, the debug_nans run, the
    # MambaPEFT LM's steps and ARM tower at d_state 17, rank 0 of the
    # (2, 2) run), each read just after it was driven with the counts at 0
    main_runs = {name: sum(run.get(name, 0) for run in runs)
                 for name in REPLACES}
    sources = {k: m.KERNEL_SOURCE for m in _kernel_modules()
               for k in m.launches}
    kernels = []
    vit = ("vit_attn_fwd", "vit_mlp_fwd", "vit_attn_bwd", "vit_mlp_bwd")
    cases = {**{name: [*VIT_ROWS.values(), *R2GEN_ROWS.values()]
                for name in vit},
             **{name: [("", None), ("_arm_l", ARM_L_CASE),
                       ("_emrrg", EMRRG_CASE), ("_lm", LM_CASE),
                       ("_peft17", PEFT17_CASE)]
                for name in ("mamba_xdbl", "mamba_scan", "mamba_scan_bwd")},
             "swin_attn_fwd": [("", None), ("_swin_b", SWIN_B_CASE)],
             **{name: [("", None), ("_n32", SS_N32_CASE)]
                for name in ("selective_scan_fwd", "selective_scan_bwd")}}
    for name in REPLACES:
        for suffix, case in cases.get(name, [("", None)]):
            err, ms, plain_ms, bound_ms, bound_by, *lib = measured[
                name + suffix]
            kernels.append({
                "name": name, "route": "cuda", "source": sources[name],
                "replaces": REPLACES[name], "launches": main_runs[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib[0] if lib else None})
            if case is not None:  # launches: every shape's
                kernels[-1]["case"] = case
    _check(all(k["launches"] > 0 for k in kernels),
           f"a kernel of the main paths never launched: {main_runs}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
