#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cvnets_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--deeplab | --segmentation | --families | --clip |
                           --range-augment | --byteformer | --mask-rcnn |
                           --vit-segmentation | --moe | --video]

``--deeplab`` runs only phases 1, 10 and 11 (DeepLabv3's train, a/b and
profile; about a minute) and prints neither JSON line: run in turns from two
checkouts in one call (parent, change, change, parent, ...), it compares their
DeepLabv3 steps on one card, as the whole script does with five recipes.
``--segmentation`` runs only phases 1, 2, 11b and 11c (the build, segmentation
through ``main_train`` and ``main_worker_segmentation``, PSPNet; about a
minute of command time) and prints neither JSON line. ``--families`` runs
only phases 1, 2 and 18 (MobileViT v1, FastViT and SSDLite) and prints
neither JSON line; ``--clip`` only phases 1, 2 and 19 (CLIP ViT-B/16);
``--range-augment`` only phases 1, 2 and 20 (RangeAugment and distillation,
MobileViTv2-2.0's 384² finetune, the schedulers); ``--byteformer`` only
phases 1, 2 and 21 (ByteFormer and audio); ``--mask-rcnn`` only phases 1, 2
and 22 (Mask R-CNN on both yamls); ``--vit-segmentation``, ``--moe`` and
``--video`` only phases 1, 2 and 23 in full for DeepLabv3-ViT-B/16 (output
strides 16 and 8), ViT-B/16-MoE, and MobileViT-S spatio-temporal with its
MobileViTv2-1.0 variant.

Phases, one line each or more (any failure exits non-zero):

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: compiles csrc/separable_attention.cu, csrc/mha_attention.cu,
   csrc/seg_ce.cu, csrc/window_attention.cu and csrc/jpeg_decode.cu (linked
   with nvJPEG) for sm_90a, one nvcc each, started together;
3. kernel: the separable-attention forward and backward kernels against their
   plain torch versions at the flagship's shapes (BP = 128·4, (N, C) of each
   MobileViTv2 stage) and at DeepLabv3's (BP = 8·4 at 512² and output stride
   16), bfloat16 and float32: the output, the autograd Function's gradient of
   qkv, the backward kernel's dqkv against ``separable_attention_backward``
   and the same bits on a rerun; each kernel and its plain version timed with
   CUDA events;
4. mha kernel: the fused multi-head attention forward and backward kernels
   against their plain versions at ViT-B/16's shapes (B = 128, S = 197, H = 12,
   D = 64; q, k, v column slices of one qkv tensor), the micro ViT's D = 16 and
   S = 512; bfloat16 and float32, with and without a key mask (one batch element
   fully masked); output, the forward's row statistics (max and log-sum),
   dq, dk and dv, and the backward's dq, dk and dv the same bit for bit on a
   second call. The bf16 forward is the Hopper design: 128 query rows a block,
   a cp.async ring of 64-key tiles with one barrier a tile, exp2 with log2 e
   folded in, and at D = 64 and 128 wgmma products in two warpgroups (K and V
   in the 128-byte swizzle, P from registers); D = 16 and 32 take mma.sync with
   ldmatrix fragments in eight warps. The backward is a pre-pass, a dQ and a
   dK/dV kernel. Kernels, plain versions
   and ``F.scaled_dot_product_attention`` (the library yardstick, under its
   cuDNN and its flash backend, each named on the line) timed at ViT-B, with
   the forward's and the backward's TFLOP/s and ratio to each. TF32 is off for
   the comparisons;
5. seg ce kernel: the fused resize + pixel CE forward and backward kernels
   against the plain unfused version at DeepLabv3's shapes (head logits
   (8, 32, 32, 150) → labels (8, 512, 512)), 5% ignored pixels and one fully
   ignored image, label smoothing 0 and 0.1, class weights off and on, float32
   and bfloat16 logits: loss and dlogits; under each float32 case the forward
   kernel's (loss_sum, n_valid) against ``seg_ce_fwd_plain`` (1e-6 relative,
   the count exact, the same bits on a rerun), and at the yaml's case the
   backward kernel's dhm against ``seg_ce_bwd_plain`` and the same bits on a
   rerun; the forward again on logits spread over ±100 with one class at 300
   in a fifth of the head pixels, where the kernel's bound on a pixel's max
   lies far above it (the count of pixels that take its exact fallback is
   printed, and must not be 0); the same checks at C 21 (the pascal_voc
   recipes); kernels and plain versions timed, at C 21 too;
6. train: MobileViTv2-1.0 train steps at batch 128 × 256² with the flagship yaml's
   settings passed as flags (bf16 autocast, AdamW, EMA, clip 10, label smoothing
   0.1) on random weights and uint8 batches from a seeded generator on the card;
   checks 9 forward and 9 backward separable-attention launches a step, finite
   losses, that params and EMA moved, and that the kernel path's logits match
   the plain attention path's; then its a/b and profile as for ViT-B
   (results/mobilevit_profile.txt);
6b. trainer: the port's ``Trainer`` on the flagship's flags with the yaml's
   stats (val loss, top-1, top-5; checkpoints ranked by top-1, highest best;
   val batch 100), auto-resume, log-freq 2, save-interval-freq 3, k-best 2
   and every epoch's checkpoint: 3 epochs of 4 seeded uint8 batches of 128 ×
   256² in pinned host memory, each followed by a validation epoch and an
   EMA one on 2 batches of 100; a second Trainer on the same directory
   resumes (its params, AdamW moments and steps, EMA, BN buffers, epoch,
   iterations and best metric equal the first's bit for bit) and runs a 4th.
   Checks 9 forward and 9 backward separable launches a train step and 9
   forward an eval forward, finite statistics, every checkpoint role on
   disk, the ``Evaluator`` on checkpoint_ema_last.pt against the last EMA
   validation (loss 1e-5 relative, top-k within one sample's share), and no
   CUDA sync debug warning ("warn" mode over every train step, read-backs
   and interval saves excluded) whose stack passes through the engine,
   metrics or checkpoint code; prints the Trainer's img/s over epochs 1-2
   beside phase 6's kernel-path a/b. Then one step at
   ``--common.accum-freq 2`` (two micro-batches of 64, 18 + 18 separable
   launches) and its peak memory beside phase 6's;
6c. main_train: ``cvnets_tpu_torch.main_train.main_worker`` on the flagship
   yaml's flags as a list (``MAIN_TRAIN_ARGS``: random resized crop bicubic,
   flip, RandAugment, random erasing 0.25, mixup 0.2, cutmix 1.0, AdamW, EMA,
   clip 10; val through resize 288 bicubic and center crop 256) on the script's
   own dataset (``smoke_imagenet``: seeded uint8 images of about 500 × 375, as
   the card machine has no image files): 2 epochs of 4 batches of 128
   × 256² and 2 val batches of 100, through the real sampler, host transforms,
   8 loader threads, collate, pinning, device augmentation, mixing and soft-
   target CE. First the train loader alone for two epochs (img/s on the host)
   and the augmentation and mixing of a step alone (device ms by
   ``torch.profiler``). Checks finite statistics, soft targets whose rows sum
   to 1 in every train step, 9 + 9 separable launches a step and 9 an eval
   forward, no CUDA sync debug warning whose stack passes through the data,
   ops, loss, engine, metrics or checkpoint code between log points, and
   ``main_eval`` on the run's checkpoint_ema_last.pt against its last EMA
   validation; prints main_train's img/s over epoch 2 beside the loader's, the
   augmentation's ms and phase 6's bare-step a/b;
7. vit train: the same for ViT-B/16 at batch 128 × 224² with vit.yaml's settings
   (AdamW with weight decay 0.2, clip 1.0, EMA 0.0005, GELU, BN in the stem);
   checks 12 forward and 12 backward MHA launches a step;
8. vit a/b: whole ViT-B steps through the kernels against the plain (einsum)
   attention path, in alternating blocks in this one run; both medians, and
   the host's time to enqueue a step;
9. vit profile: ``torch.profiler`` over 3 ViT-B steps: device time a step, busy
   share, the top kernels; the whole table goes to results/vit_profile.txt;
10. deeplab train: DeepLabv3-MobileViTv2-1.0 at batch 8 × 512² with
   deeplabv3_mobilevitv2.yaml's settings (150 classes, OS 16, aux head, ASPP
   512 at rates 6/12/18, dropouts 0.1, BN for SyncBN, SGD 0.9 with weight decay
   1e-4 and the head's LR ×10, clip 10, EMA 0.0005, bf16) and labels with 5%
   ignored pixels; checks 2 seg-CE forward, 2 backward and 9 + 9 separable-attention
   launches a step, finite losses (total, seg, aux), that params and EMA moved,
   the kernel path's loss against the plain path's on the same outputs, and the
   eval logits through the kernels against the plain attention path;
11. deeplab a/b and deeplab profile, as for ViT-B (results/deeplab_profile.txt);
11b. seg main_train: ``cvnets_tpu_torch.main_train.main_worker`` on
   deeplabv3_mobilevitv2.yaml's flags as a list (``SEG_MAIN_TRAIN_ARGS``:
   short side 256-768 bicubic up to 1024, flip, a 512² random crop with mask
   fill 255, validation resized to 512², stats loss and iou, checkpoints ranked
   by iou, highest best) on the script's own dataset (``smoke_ade20k``: seeded
   uint8 images of about 683 × 512 and masks of raw labels 0-150 in blobs):
   the loader alone for two epochs (img/s on the host; uint8 pinned images and
   masks), then 2 epochs of 3 batches of 8 × 512² and 2 val batches of 8
   (validation and EMA validation) through the real sampler, transforms, 8
   loader threads, collate, pinning and the segmentation step. Checks 2 + 2
   seg-CE and 9 + 9 separable launches a step (an eval forward 9 separable and
   no seg-CE: its full-size logits take the unfused CE), finite statistics, an
   iou in [0, 100], no CUDA sync debug warning through the data, ops, loss,
   engine, metrics or checkpoint code between log points, and
   ``main_worker_segmentation`` (``validation_set``, inputs resized to 512²,
   the validation's batch) on the run's checkpoint_ema_last.pt, whose mIoU
   must equal the last EMA validation's iou; prints main_train's img/s over
   epoch 2 beside the loader's and phase 11's bare-step a/b;
11c. pspnet: PSPNet-MobileViTv2-1.0 train steps at batch 8 × 512² with
   pspnet_mobilevitv2.yaml's settings (``PSPNET_ARGS``: OS 8, pyramid pools
   1/2/3/6, 512 channels, aux head, swish, SGD, EMA, bf16), 2 + 2 seg-CE and
   9 + 9 separable launches a step, finite losses, its logits and loss through
   the kernels against the plain path's, then 24 steady steps (median step
   time, img/s, host enqueue, peak memory);
12. window kernel: the window-attention forward and backward kernels against
   their plain versions at Swin-T's four stage shapes at batch 128 (S = 49,
   D = 32; B·nW, H = 8192, 3 / 2048, 6 / 512, 12 / 128, 24; q, k, v column
   thirds of one qkv tensor), with the stage's real shift mask and without,
   bfloat16 and float32: output, dq, dk, dv and dbias, and dbias the same bit
   for bit on a second run; kernels, plain versions and
   ``F.scaled_dot_product_attention`` with the bias as a float mask timed, the
   forward's and the backward's ratio to its bound and to SDPA on each bf16
   line. Both bf16 kernels are the Hopper design: the next window's tiles
   copied by cp.async while this one computes, ldmatrix fragments for every
   product, exp2 with log2 e folded into the bias, held in shared memory in
   fragment order, and as few images a block as fill one wave of the card;
13. mha long kernel: the same kernels (the Hopper forward of phase 4 serves
   every S) against the plain versions at S = 1024 (ViT-B/16 at 512² without
   the CLS token, B = 32) and S = 4096 (B = 2), H = 12, D = 64, with and
   without a key mask (one batch element fully masked), bfloat16 and float32:
   output, statistics and grads, the backward the same bit for bit on a
   second call; timed at S = 1024 as in phase 4, the backward's time split
   between its pre-pass, dQ and dK/dV kernels by ``torch.profiler``;
14. swin train, swin a/b, swin profile: Swin-T steps at batch 128 × 224² with
   swin.yaml's settings (AdamW with weight decay 0.05, cosine LR, clip 5,
   label smoothing 0.1, EMA 0.0005, GELU, LayerNorm, stochastic depth 0.2);
   checks 12 forward and 12 backward window-attention launches a step, then as
   for ViT-B (results/swin_profile.txt);
15. vit long train, a/b and profile: ViT-B/16 steps at batch 32 × 512² without
   the CLS token (S = 1024), vit.yaml's settings otherwise; checks 12 forward
   and 12 backward MHA launches a step at S = 1024 and the logits against the
   einsum path, then as for ViT-B (results/vit_long_profile.txt);
16. conv: the conv classification families, whose paths run no port kernel
   (cuDNN convs, ATen BN). ResNet-50 with resnet.yaml's settings as flags
   (``RESNET_ARGS``: SGD 0.9 with weight decay 1e-4 on every tensor, cosine
   LR to 0.4 after a warmup from 0.05, label smoothing 0.1, no EMA, bf16) at
   batch 128 × 224²: train steps (finite losses, params moved), its f32 eval
   logits on the card against a copy of the model on the CPU (TF32 off,
   1e-3 of max(1, |logit|)), 24 steady steps (median step time, img/s, the
   host's enqueue, peak memory) and a profile with device time by kernel
   family (results/resnet_profile.txt); then ``main_train`` on resnet.yaml's
   flags and data settings (``RESNET_MAIN_TRAIN_ARGS``) on ``smoke_imagenet``,
   2 epochs of 4 batches of 128, no sync debug warning through the port's
   code between log points, and ``main_eval`` on its checkpoint_last.pt
   against its last validation; then 2 + 3 train steps of MobileNetV1-1.0,
   MobileNetV2-1.0, MobileNetV3-large-1.0, MobileOne-s1, EfficientNet-b0
   and RegNetY-16GF at batch 128 × 224² with their yamls' settings (the
   RangeAugment yamls without the augmentor and composite loss), each held
   against its copy on the CPU and then timed over 24 steady steps as
   ResNet-50 is, and MobileOne-s1's f32 eval forward folded
   by ``reparameterize_model`` against its branches (1e-4 of max(1,
   |logit|)).
17. native: the native JPEG path (``--dataset.decoder native``). A seeded
   ImageFolder of JPEG files written through Pillow at run time
   (``write_jpeg_corpus``: 8 classes, 2048 train and 200 val files of about
   500 × 375, quality 90, 4:2:0 with every 8th 4:4:4 and every 16th
   grayscale; one train file cut at half its bytes, one inside its header).
   (a) the crop → resize → flip kernel against its plain version on the same
   nvJPEG rasters, bit for bit, at every crop class (prescale 1, 2, 4 and 8,
   area and bilinear; ``NATIVE_CLASS_CASES``), with and without the flip, on
   whole images and on random resized crops at 128 × 224² and 128 × 256²,
   its time at both (and the plain version's, and its bound: the crops'
   bytes of the rasters and the batch over the HBM rate); (b) nvJPEG's
   rasters against Pillow's decode of the same files, mean and max |diff| by
   kind (``NVJPEG_PILLOW_MEAN``), and nvJPEG's decode time a batch of 128 on
   1 and 8 decoding threads; (c) the damaged files' status and their slots
   replaced in place by valid ones (``fetch_batch_native``); (d) the
   flagship's train loader alone over two epochs (32 batches), ``native``
   against ``pil``, in img/s after the first batch. Then ``main_train`` for
   2 epochs (16 steps each at batch 128) with the native
   decoder on the corpus on each of the flagship's, vit.yaml's and
   swin.yaml's flags (``NATIVE_MAIN_TRAIN``; ViT-B/16 and Swin-T at full
   width, the ViT's variable batch sampler drawing its crop and batch every
   batch): one kernel launch a train batch, each model's attention kernels
   a step, finite statistics, no host sync through the port's code between
   log points, img/s over epoch 2; then the same on mobilevit.yaml's flags
   (MobileViT-S, the variable batch sampler at 160-320 px) and on
   fastvit.yaml's (FastViT-T8, 128-320 px), whose paths run no attention
   kernel.
18. families: MobileViT-S at batch 128 × 256² with mobilevit.yaml's settings
   (``MOBILEVIT_ARGS``: number-heads 4, so heads of D = 36, 48 and 60, which
   take the einsum route): train steps held against its copy on the CPU, 24
   steady steps, a profile by kernel family (results/mobilevit_s_profile.txt)
   and, from the same profile, the einsum attention's device time a step (the
   kernels inside the MHA layer's ``EINSUM_ROUTE`` range and those of the
   backward nodes of its ops) and its share;
   MobileViT-XXS at the same settings, whose layer 3 (D = 16, S = 256) runs
   the MHA kernels: 2 forward and 2 backward launches a step, its logits and
   float32 grads through the kernels against the einsum path, a/b; FastViT-T8
   at batch 128 × 224² with fastvit.yaml's settings: train steps against the
   CPU copy, steady steps; SSDLite-MobileViT-S at the detection yaml's batch
   32 × 320² (``SSD_ARGS``; targets matched on the host to its 3,234
   anchors): train steps, its scores and box offsets against the CPU copy,
   steady steps, a profile (results/ssd_profile.txt), ``predict`` (decode and
   padded NMS on the card) with no host sync, timed, and its postprocess
   against the CPU's on the same outputs; then ``main_train`` for 2 epochs on
   a seeded COCO folder (``SSD_CORPUS``: 20 steps an epoch) and its train
   loader alone: finite statistics, no host sync through the port's code
   between log points, img/s over epoch 2 after its first batch beside the
   loader's; then ``main_worker_detection`` on its val split with the run's
   checkpoint (the mAPs), and the eval path's ``predict`` on the card
   against a CPU copy of the checkpoint on 3 val images at their own sizes.
19. clip: CLIP ViT-B/16 with clip_vit.yaml's settings as flags (``CLIP_ARGS``:
   ViT-B/16 image tower with float32 LayerNorms, a 12 × 512 causal text
   tower of 8 heads, context 77, vocab 49,408, projection 512, AdamW β2
   0.98 with weight decay 0.2 off rank ≤ 1 tensors, clip 1.0, EMA 0.0005,
   iteration-based cosine with warmup, bf16) at batch 128 × 224² and seeded
   captions: 12 forward and 12 backward MHA launches a step (the image
   tower; the text tower's causal mask takes the einsum route), finite
   losses, the embeddings through the kernels against the plain path and
   against a CPU copy; a/b, 24 steady steps, a profile split into the image
   tower, the text tower, its einsum attention, the loss and the optimizer
   (clip, AdamW and EMA), with peak memory (results/clip_profile.txt); then
   ``main_train`` on a flickr corpus written at run time (phase 17's 2,048 +
   200 JPEG files with a seeded caption each; 2 epochs of 16 steps, each
   validated with the loss and the retrieval recalls) and its loader alone:
   no host sync between log points, img/s over epoch 2 after its first
   batch; ``main_eval`` zero-shot over the val folder's 8 classes with a
   class-names file, and its logits from checkpoint_last.pt on the card
   against a CPU copy's on 3 images.
20. range augment: (a) the RangeAugment distillation recipe
   (examples/range_augment/distillation/teacher_resnet101_student_mobilenet_v2.yaml
   as ``RANGE_AUGMENT_ARGS`` and its composite list): MobileNetV2-1.0 with
   the distribution augmentor (brightness, contrast, noise) and a ResNet-101
   teacher read from a checkpoint the phase writes from a seeded model, the
   composite of soft KL (T 1) and neural augmentation, SGD, EMA, bf16, at
   the variable batch sampler's base size, 256 × 224², standing in for its
   scales: train steps (finite losses, a nonzero grad on each of the six
   augmentor scalars, the teacher unchanged, in eval mode, outside the
   optimizer and the EMA), the student's eval logits and its train forward
   with the composite's terms against CPU copies, 24 steady steps (step ms,
   img/s, host enqueue, peak memory) and a profile split into the teacher's
   forward, the augmentor, the loss terms, the optimizer and the student
   (results/range_augment_profile.txt); (b) ``main_train.main`` on the same
   recipe with its variable batch sampler over phase 17's JPEG corpus
   through the native decoder, 2 epochs with validation (top-1), no host
   sync between log points, img/s over epoch 2 after its first batch beside
   the loader alone; (c) MobileViTv2-2.0's 384² finetune
   (config/classification/finetune_higher_res_in1k/mobilevit_v2.yaml as
   ``FINETUNE_ARGS``, ``--common.finetune`` from a 256² checkpoint the phase
   writes): 9 forward and 9 backward separable-attention launches a step, by
   (BP, N, C) exactly (576, 256) ×2, (144, 384) ×4 and (36, 512) ×3 over BP
   = 128, the logits through the kernels against the plain path, steady
   steps, and each shape's kernels against their plain versions, timed
   beside them and their bounds; (d) the Trainer on those flags with a
   ``multi_step`` schedule: the LR written into the optimizer at every
   iteration is the scheduler's.
21. byteformer: ByteFormer-Tiny (E 192, 12 layers of 3 heads of 64, conv
   16 / stride 8, token merging after layers 3, 7 and 11) at batch 48, bf16,
   with the yamls' settings as flags. (a) byteformer.yaml (``BYTEFORMER_ARGS``:
   windows of 128, AdamW, cosine LR, label smoothing 0.1, EMA 0.0005) on
   seeded byte sequences of 7,000-8,192 bytes (what ``pil_save`` at quality
   60 makes of a 224² crop) padded with -1 to the bucket of 8,192: 12 forward
   and 12 backward MHA launches a step, by (B·n_windows, window) exactly
   (384, 128) ×4, (192, 128) ×4 and (96, 128) ×4 (``BYTEFORMER_SHAPES``,
   read by ``ShapeLog``s standing in for the wrappers), finite losses,
   params and EMA moved, the float32 eval logits through the kernels against
   the einsum route and against a CPU copy; 24 steady steps (step ms, img/s,
   host enqueue, peak memory); a profile with the MHA kernels' share
   (results/byteformer_jpeg_profile.txt). (b) byteformer_wav.yaml
   (``BYTEFORMER_WAV_ARGS``: windows of 32, 35 classes) on 32,044-byte
   sequences (a 1-s 16 kHz int16 wav) in the bucket of 32,768: launches at
   (6144, 32) ×4, (3072, 32) ×4 and (1536, 32) ×4, then as (a)
   (results/byteformer_wav_profile.txt). (c) the MHA kernels at (384, 128,
   3, 64) and (6144, 32, 3, 64), bf16 and f32, with and without a key mask
   (one window masked whole), against their plain versions as in phase 4;
   every window shape of a step timed beside its plain versions, its bound
   and SDPA, and summed to a step's. (d) one step of (a) under
   ``--model.classification.byteformer.mask-windowed-attn``: 6 forward and
   6 backward launches (the unshifted layers, with the key-padding mask), 6
   einsum layers (the shifted ones' additive mask), the logits against the
   einsum route's. (e) ``main_train`` on (a)'s flags over phase 17's JPEG
   corpus cut to 48 + 12 files a class (Pillow a sample,
   ``byteformer_image_collate_fn`` with ``pil_save`` at quality 60) and (f)
   on (b)'s over a Speech Commands folder written at run time (35 words × 16
   + 2 one-second clips): 2 epochs with validation and EMA validation, 12 +
   12 launches a train step and 12 an eval forward, no host sync between
   log points, img/s over epoch 2 after its first batch beside the loader
   alone, the buckets padded to, ``main_eval`` on checkpoint_ema_last.pt
   against the last EMA validation.
22. mask rcnn: Mask R-CNN at the yamls' batch of 8, bf16, their settings as
   flags: path A config/detection/mask_rcnn_coco/vit_fpn.yaml
   (``MASK_RCNN_A_ARGS``: MobileViTv2-1.0 and the FPN at 512², AdamW with
   the backbone's LR ×0.7, multi_step, EMA, clip 1.0) and path B
   vit_fpn_lsj.yaml (``MASK_RCNN_B_ARGS``: ViT-B/16 with the simple FPN at
   1024², S = 4,097 tokens with the CLS token, which no 128-row block
   divides: the MHA kernels tile it ragged). (a) the kernels at the slice's
   shapes against their plain versions, as phases 3 and 4 hold them, and
   timed: the separable attention at path A's (BP 32: (1024, 128), (256,
   192), (64, 256)), bf16 and f32; the MHA kernels at (8, 4097, 12, 64)
   bf16 with SDPA and the bounds, and at batch 1 in f32. (b) per path, bare
   train steps on seeded images with 1-12 boxes and their elliptic masks:
   9 + 9 separable (A) or 12 + 12 MHA (B) launches a step, the five losses
   finite, params and EMA moved; steady steps (step ms, img/s, the host's
   enqueue, peak memory); a profile split into backbone, FPN, RPN with its
   NMS, matching and sampling, RoIAlign, the box and mask heads and the
   optimizer, with the kernels' share (results/mask_rcnn_{a,b}_profile.txt);
   ``predict`` on a batch of 8 at the crop size (masks pasted there) with no
   host sync; in float32 the FPN's maps and the five losses through the
   kernels against the plain path on the same draws (``mask_rcnn_held``),
   and 3 train steps of each route from the same weights, batches and
   draws (``mask_rcnn_held_steps``; batch 8 on A, 1 on B); path A's a/b. (c) path B at batch 2, where the einsum route fits too: a/b
   of the kernels against it, each with its peak memory. (d) a micro Mask
   R-CNN (MobileViTv2-0.5 at 128²) on the card against its copy on the CPU,
   float32. (e) path A through ``main_train`` over a seeded COCO folder with
   polygon masks (160 + 8 files), 2 epochs with validation, the separable
   launches counted every epoch, no host sync between log points, then
   ``main_worker_detection`` with the bbox and segm mAPs in [0, 1]; its
   train loader alone over 2 epochs.

23. the rest of ViT and video, the yamls' settings as flags
   (``VIT_SEG_ARGS`` / ``VIT_SEG_8_ARGS`` with ``VIT_SEG_COMPOSITE``,
   ``VIT_MOE_ARGS``, ``VIDEO_ARGS`` and ``VIDEO_V2_ARGS``), bf16: DeepLabv3 on
   ViT-B/16 at output strides 16 and 8 (4 × 512², 150 classes, S = 1,025 and
   4,097 with the CLS token, the composite loss), ViT-B/16-MoE (128 × 224², 6
   MoE blocks of 8 experts, top-2, capacity factor 1.25, the load-balance
   loss at 0.01), MobileViT-S spatio-temporal (8 videos × 8 frames × 256²,
   400 classes; its head dims send its attention down the einsum route) and
   the same over MobileViTv2-1.0 (whose blocks' cross path runs the separable
   kernels). (a) the kernels at these shapes against their plain versions:
   the MHA kernels at (4, 1025), (4, 4097) and (128, 197), 12 heads of 64; the
   seg-CE kernels from 32² and 64² head logits to 512²; the separable kernels
   at BP 32 and the layer's cross path against its plain branch. (b) per path,
   5 train steps on one repeated batch at ``REST_LR``: the launches of each
   kernel a step (12 + 12 MHA, 1 + 1 seg CE, 72 + 72 separable: 9 a frame),
   the loss finite and falling, params and EMA moved; then the float32 eval
   logits through the kernels against the plain path (MobileViT-S: against a
   CPU copy) and the segmentation paths' composite loss through the seg-CE
   kernels against the unfused CE, its neural-augmentation term 0. With its
   flag, a path also: (a) timed by events and by the profiler, beside the
   plain versions, the bounds, SDPA and the concatenation before the cross
   kernel; (b) on the yaml's device augmentation and mixing (MoE), steady
   steps (step ms with its quartiles, img/s, host enqueue, peak memory) and a
   profile (results/<path>_profile.txt: the kernels' share, MoE's routing,
   expert products and combine); (c) ``main_train`` for one epoch on a corpus
   written at run time (ADE20k JPEG images with PNG masks, a JPEG corpus for
   ImageNet through the native decoder, Kinetics JPEG frame folders), the
   kernels' launches counted every epoch and no host sync between log points,
   then its evaluation (``main_segmentation_evaluation``, ``main_eval``; video
   with one clip a video and with two voted by sum) of the EMA checkpoint.

The second-to-last line is the kernels' JSON record, one entry for each TPU
kernel's counterpart: ``ms``/``plain_ms`` are a kernel's and its plain
version's time for one train step's launches (the separable attention's 9
forward and 9 backward at the flagship from the per-shape bf16 medians, with
their launches by path, the flagship's, MobileViTv2-2.0's 384² finetune's
Mask R-CNN path A's and MobileViTv2-1.0 spatio-temporal's, in
``launches_by_path`` and the finetune's own
times in ``by_path``, each MHA kernel's 12 at ViT-B and at ViT-B 512² (the
S ≤ 512 rows also give their launches by path, ViT-B/16's, CLIP's and
ByteFormer-Tiny's on JPEG and on wav bytes and ViT-B/16-MoE's, in
``launches_by_path``, and
ByteFormer's step of 12 launches at its window shapes in ``by_path``; the
long rows ViT-B 512²'s, Mask R-CNN path B's at S = 4,097 and
DeepLabv3-ViT-B/16's at output strides 16 and 8), each seg-CE kernel's 2 at
DeepLabv3 (its launches by path beside DeepLabv3-ViT-B/16's), each window kernel's 12 at Swin-T
from the per-stage medians; the native decode's crop → resize → flip
kernel's one launch a batch at 128 × 256², its launches those of the
flagship's native ``main_train`` run, and
nvJPEG's decode times beside it), ``bound_ms`` the least time the card could
take for the same work (bytes over the HBM rate or operations over their unit's
peak, whichever is larger; the MHA backward's counts the function's work, 5
products of 2·S²·D a head and one exponential a logit, whatever the design
recomputes) and ``library_ms`` one PyTorch call that computes the same
function, where there is one (for the MHA kernels the faster SDPA backend,
named in ``library_backend``, every backend's time in
``library_ms_by_backend``). The two long-sequence backward rows share the
whole backward's bound, plain and library times by the gradients each writes
(``BWD_ROW_SHARE``), so their sum is the whole backward's. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA card it exits 2 before any
result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

# separable attention: (BP, {(N, C) of layer_3, layer_4, layer_5: attention blocks})
SEP_FLAGSHIP = (128 * 4, {(256, 128): 2, (64, 192): 4, (16, 256): 3})  # 128 × 256²
SEP_DEEPLAB = (8 * 4, {(1024, 128): 2, (256, 192): 4, (256, 256): 3})  # 8 × 512², OS 16
WARMUP_STEPS, TIMED_STEPS = 2, 5
VIT_BLOCKS = 12  # ViT-B/16's transformer blocks, one MHA each
# (label, B, S, H, D) for the MHA kernel checks; the first is ViT-B/16 at 224²
MHA_CASES = [("vit_base", 128, 197, 12, 64), ("vit_micro", 128, 197, 4, 16),
             ("seq512", 32, 512, 12, 64)]
AB_BLOCKS, AB_STEPS = ("plain", "kernel", "kernel", "plain"), 8
# seg CE at DeepLabv3's shapes: head logits (B, h, w, C) → labels (B, H, W)
SEG_B, SEG_HEAD, SEG_FULL, SEG_C = 8, 32, 512, 150
SEG_CALLS = 2  # main head and aux head, each one forward and one backward a step
SEG_C_VOC = 21  # config/segmentation/pascal_voc/*.yaml
# Swin-T at batch 128 × 224²: (label, map side, heads, unshifted and shifted
# blocks a step); windows of 7 × 7 = 49 tokens, D = 32, stage 4 never shifts
SWIN_BATCH, WIN, WIN_D = 128, 7, 32
SWIN_STAGES = [("stage1", 56, 3, 1, 1), ("stage2", 28, 6, 1, 1),
               ("stage3", 14, 12, 3, 3), ("stage4", 7, 24, 2, 0)]
SWIN_BLOCKS = 12
# the MHA kernels past S = 512: (label, B, S, H, D); the first is the main path's
MHA_LONG_CASES = [("vit_base_512", 32, 1024, 12, 64), ("vit_base_1024", 2, 4096, 12, 64)]
# the long backward's two rows (TPU kernels _pallas_dq and _pallas_dkv) share
# the whole backward's bound, plain and library times by the gradients each
# writes: dq one of three, dk and dv two
BWD_ROW_SHARE = {"dq": 1 / 3, "dkdv": 2 / 3}

# card peaks for the bounds (H100 SXM data sheet);
# the SFU rate is 16 exponentials a clock per SM (CUDA C++ programming guide,
# arithmetic instruction throughput, compute capability 9.0) at the 1,980 MHz
# boost clock of the 700 W part
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
BF16_TC_FLOP_S = 989e12
SFU_EXP_S = 132 * 16 * 1.98e9
# the SDPA backends the MHA kernels are timed against, by name: cuDNN's,
# PyTorch's own choice on the H100, and flash (FlashAttention-2, the mma.sync
# design the MHA kernels are held to); library_ms is the faster of the two
SDPA_BACKENDS = ("CUDNN_ATTENTION", "FLASH_ATTENTION")

# the run settings the three imagenet yamls share, which only the Trainer reads
# (the train phases take bare steps)
IMAGENET_RUN_ARGS = [
    "--dataset.val-batch-size0", "100",
    "--common.run-label", "train",
    "--common.log-freq", "500",
    "--common.auto-resume",
    "--stats.val", "loss", "top1", "top5",
    "--stats.checkpoint-metric", "top1",
    "--stats.checkpoint-metric-max",
]

FLAGSHIP_ARGS = [  # config/classification/imagenet/mobilevit_v2.yaml, as flags
    "--model.classification.name", "mobilevit_v2",
    "--model.classification.n-classes", "1000",
    "--model.classification.mitv2.width-multiplier", "1.0",
    "--model.classification.mitv2.attn-norm-layer", "layer_norm_2d",
    "--model.classification.activation.name", "swish",  # parsed, read by no layer
    "--model.activation.name", "swish",
    "--model.normalization.name", "batch_norm",
    "--model.normalization.momentum", "0.1",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.conv-init-std-dev", "0.02",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--loss.category", "classification",
    "--loss.classification.name", "cross_entropy",
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.05",
    "--optim.no-decay-bn-filter-bias",
    "--optim.adamw.beta1", "0.9",
    "--optim.adamw.beta2", "0.999",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "300",
    "--scheduler.warmup-iterations", "20000",
    "--scheduler.warmup-init-lr", "1e-6",
    "--scheduler.cosine.max-lr", "0.002",
    "--scheduler.cosine.min-lr", "0.0002",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--common.mixed-precision",
    "--common.mixed-precision-dtype", "bfloat16",
    "--common.grad-clip", "10.0",
    "--dataset.train-batch-size0", "128",
    "--sampler.bs.crop-size-width", "256",
    "--sampler.bs.crop-size-height", "256",
    "--common.seed", "0",
]

DEEPLAB_ARGS = [  # config/segmentation/ade20k/deeplabv3_mobilevitv2.yaml, as flags
    "--dataset.category", "segmentation",
    "--model.segmentation.name", "encoder_decoder",
    "--model.segmentation.n-classes", "150",
    "--model.segmentation.lr-multiplier", "10",
    "--model.segmentation.seg-head", "deeplabv3",
    "--model.segmentation.output-stride", "16",
    "--model.segmentation.use-aux-head",
    "--model.segmentation.classifier-dropout", "0.1",
    "--model.segmentation.aux-dropout", "0.1",
    "--model.segmentation.deeplabv3.aspp-dropout", "0.1",
    "--model.segmentation.deeplabv3.aspp-out-channels", "512",
    "--model.segmentation.deeplabv3.aspp-rates", "6", "12", "18",
    "--model.classification.name", "mobilevit_v2",
    "--model.classification.mitv2.width-multiplier", "1.0",
    "--model.classification.mitv2.attn-norm-layer", "layer_norm_2d",
    # as bench_tasks.py:115 runs it: BN for SyncBN on one card; the JAX package
    # builds every layer with model.activation.name (relu), its
    # model.classification.activation.name (swish) is read by no layer
    "--model.classification.activation.name", "swish",
    "--model.normalization.name", "batch_norm",
    "--model.normalization.momentum", "0.1",
    "--model.activation.name", "relu",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "normal",
    "--loss.category", "segmentation",
    "--loss.segmentation.name", "cross_entropy",
    "--loss.segmentation.cross-entropy.aux-weight", "0.4",
    "--loss.segmentation.cross-entropy.ignore-index", "255",
    "--optim.name", "sgd",
    "--optim.weight-decay", "1e-4",
    "--optim.no-decay-bn-filter-bias",
    "--optim.sgd.momentum", "0.9",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "120",
    "--scheduler.warmup-iterations", "500",
    "--scheduler.warmup-init-lr", "0.0009",
    "--scheduler.cosine.max-lr", "0.02",
    "--scheduler.cosine.min-lr", "0.0002",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--common.mixed-precision",
    "--common.mixed-precision-dtype", "bfloat16",
    "--common.grad-clip", "10.0",
    "--dataset.train-batch-size0", "8",  # bench_tasks.py:115 (the yaml: 4 a GPU × 8)
    "--sampler.bs.crop-size-width", "512",
    "--sampler.bs.crop-size-height", "512",
    "--common.seed", "0",
]

VIT_ARGS = [  # config/classification/imagenet/vit.yaml, as flags
    "--model.classification.name", "vit",
    "--model.classification.n-classes", "1000",
    "--model.classification.vit.mode", "base",
    "--model.classification.vit.norm-layer", "layer_norm",
    "--model.activation.name", "gelu",
    "--model.normalization.name", "batch_norm",
    "--model.normalization.momentum", "0.1",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--loss.category", "classification",
    "--loss.classification.name", "cross_entropy",
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.2",
    "--optim.no-decay-bn-filter-bias",
    "--optim.adamw.beta1", "0.9",
    "--optim.adamw.beta2", "0.999",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "300",
    "--scheduler.warmup-iterations", "7500",
    "--scheduler.warmup-init-lr", "1e-6",
    "--scheduler.cosine.max-lr", "0.002",
    "--scheduler.cosine.min-lr", "2e-5",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--common.mixed-precision",
    "--common.mixed-precision-dtype", "bfloat16",
    "--common.grad-clip", "1.0",
    "--dataset.train-batch-size0", "128",
    "--sampler.bs.crop-size-width", "224",
    "--sampler.bs.crop-size-height", "224",
    "--common.seed", "0",
] + IMAGENET_RUN_ARGS

SWIN_ARGS = [  # config/classification/imagenet/swin.yaml, as flags
    "--model.classification.name", "swin",
    "--model.classification.n-classes", "1000",
    "--model.classification.swin.mode", "tiny",
    "--model.classification.swin.stochastic-depth-prob", "0.2",
    "--model.normalization.name", "layer_norm",
    "--model.activation.name", "gelu",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--loss.category", "classification",
    "--loss.classification.name", "cross_entropy",
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.05",
    "--optim.no-decay-bn-filter-bias",
    "--optim.adamw.beta1", "0.9",
    "--optim.adamw.beta2", "0.999",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "300",
    "--scheduler.warmup-iterations", "20000",
    "--scheduler.warmup-init-lr", "1e-6",
    "--scheduler.cosine.max-lr", "0.001",
    "--scheduler.cosine.min-lr", "1e-5",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--common.mixed-precision",
    "--common.mixed-precision-dtype", "bfloat16",
    "--common.grad-clip", "5.0",
    "--dataset.train-batch-size0", str(SWIN_BATCH),
    "--sampler.bs.crop-size-width", "224",
    "--sampler.bs.crop-size-height", "224",
    "--common.seed", "0",
] + IMAGENET_RUN_ARGS

# ViT-B/16 at 512² without the CLS token: S = 32² = 1024 tokens, the
# long-sequence kernels' range; the batch is vit.yaml's 128 at 224² scaled by
# the area and rounded up (128 · 224² / 512² = 24.5 → 32)
VIT_LONG_ARGS = VIT_ARGS + [
    "--model.classification.vit.no-cls-token",
    "--dataset.train-batch-size0", "32",
    "--sampler.bs.crop-size-width", "512",
    "--sampler.bs.crop-size-height", "512",
]


RESNET_ARGS = [  # config/classification/imagenet/resnet.yaml, as flags
    "--model.classification.name", "resnet",
    "--model.classification.n-classes", "1000",
    "--model.classification.resnet.depth", "50",
    "--model.activation.name", "relu",
    "--model.normalization.name", "batch_norm",
    "--model.normalization.momentum", "0.1",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "normal",
    "--loss.category", "classification",
    "--loss.classification.name", "cross_entropy",
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "sgd",
    "--optim.weight-decay", "1e-4",
    "--optim.sgd.momentum", "0.9",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "150",
    "--scheduler.warmup-iterations", "7500",
    "--scheduler.warmup-init-lr", "0.05",
    "--scheduler.cosine.max-lr", "0.4",
    "--scheduler.cosine.min-lr", "2e-4",
    "--common.mixed-precision",
    "--dataset.train-batch-size0", "128",
    "--sampler.bs.crop-size-width", "224",
    "--sampler.bs.crop-size-height", "224",
    "--common.seed", "0",
]

# the settings the conv family yamls (mobilenet_v1/v2/v3, mobileone,
# efficientnet_rangeaugment, regnet_y_16gf_rangeaugment) share, at a fixed 224²
# where most of them take the variable-batch sampler
_CONV_FAMILY_ARGS = [
    "--model.classification.n-classes", "1000",
    "--model.normalization.name", "batch_norm",
    "--model.normalization.momentum", "0.1",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "normal",
    "--loss.category", "classification",
    "--loss.classification.name", "cross_entropy",
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "sgd",
    "--optim.no-decay-bn-filter-bias",
    "--optim.sgd.momentum", "0.9",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "300",
    "--scheduler.warmup-iterations", "7500",
    "--scheduler.warmup-init-lr", "0.05",
    "--scheduler.cosine.max-lr", "0.4",
    "--scheduler.cosine.min-lr", "2e-4",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--common.mixed-precision",
    "--dataset.train-batch-size0", "128",
    "--sampler.bs.crop-size-width", "224",
    "--sampler.bs.crop-size-height", "224",
    "--common.seed", "0",
]
# each family at its yaml's width and mode; the two RangeAugment yamls without
# their augmentor and composite loss (ROADMAP.md queue 1 item 12): their
# classification CE alone
CONV_FAMILY_ARGS = {
    "MobileNetV1-1.0": _CONV_FAMILY_ARGS + [
        "--model.classification.name", "mobilenetv1",
        "--model.classification.mobilenetv1.width-multiplier", "1.0",
        "--model.activation.name", "relu", "--optim.weight-decay", "4e-5"],
    "MobileNetV2-1.0": _CONV_FAMILY_ARGS + [
        "--model.classification.name", "mobilenetv2",
        "--model.classification.mobilenetv2.width-multiplier", "1.0",
        "--model.activation.name", "relu6", "--optim.weight-decay", "4e-5"],
    "MobileNetV3-large-1.0": _CONV_FAMILY_ARGS + [
        "--model.classification.name", "mobilenetv3",
        "--model.classification.mobilenetv3.mode", "large",
        "--model.classification.mobilenetv3.width-multiplier", "1.0",
        "--model.activation.name", "hard_swish", "--optim.weight-decay", "4e-5",
        "--scheduler.warmup-iterations", "3000", "--scheduler.warmup-init-lr", "0.1",
        "--scheduler.cosine.max-lr", "0.8"],
    "MobileOne-s1": _CONV_FAMILY_ARGS + [
        "--model.classification.name", "mobileone",
        "--model.classification.mobileone.variant", "s1",
        "--model.activation.name", "relu", "--optim.weight-decay", "1e-4"],
    "EfficientNet-b0": _CONV_FAMILY_ARGS + [
        "--model.classification.name", "efficientnet",
        "--model.classification.efficientnet.mode", "b0",
        "--model.classification.activation.name", "swish",
        "--model.activation.name", "swish", "--optim.weight-decay", "1e-5",
        "--common.grad-clip", "10.0", "--scheduler.max-epochs", "600",
        "--scheduler.cosine.min-lr", "4e-4"],
    "RegNetY-16GF": _CONV_FAMILY_ARGS + [
        "--model.classification.name", "regnet",
        "--model.classification.regnet.mode", "y_16gf",
        "--model.activation.name", "relu", "--optim.weight-decay", "5e-5"],
}
CONV_FAMILY_STEPS = (2, 3)  # warm-up and timed steps of each family's phase

MOBILEVIT_ARGS = [  # config/classification/imagenet/mobilevit.yaml, as flags
    "--model.classification.name", "mobilevit",
    "--model.classification.n-classes", "1000",
    "--model.classification.mit.mode", "small",
    "--model.classification.mit.ffn-dropout", "0.0",
    "--model.classification.mit.attn-dropout", "0.0",
    "--model.classification.mit.number-heads", "4",
    "--model.classification.activation.name", "swish",
    "--model.normalization.name", "batch_norm",
    "--model.normalization.momentum", "0.1",
    "--model.activation.name", "swish",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--loss.category", "classification",
    "--loss.classification.name", "cross_entropy",
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.01",
    "--optim.no-decay-bn-filter-bias",
    "--optim.adamw.beta1", "0.9",
    "--optim.adamw.beta2", "0.999",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "300",
    "--scheduler.warmup-iterations", "3000",
    "--scheduler.warmup-init-lr", "0.0002",
    "--scheduler.cosine.max-lr", "0.002",
    "--scheduler.cosine.min-lr", "0.0002",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--common.mixed-precision",
    "--dataset.train-batch-size0", "128",
    "--sampler.bs.crop-size-width", "256",
    "--sampler.bs.crop-size-height", "256",
    "--common.seed", "0",
] + IMAGENET_RUN_ARGS
MOBILEVIT_DATA_ARGS = [  # the rest of mobilevit.yaml: loader, sampler, transforms
    "--dataset.category", "classification",
    "--dataset.workers", "8",
    "--sampler.name", "variable_batch_sampler",
    "--sampler.vbs.crop-size-width", "256",
    "--sampler.vbs.crop-size-height", "256",
    "--sampler.vbs.max-n-scales", "5",
    "--sampler.vbs.min-crop-size-width", "160",
    "--sampler.vbs.max-crop-size-width", "320",
    "--sampler.vbs.min-crop-size-height", "160",
    "--sampler.vbs.max-crop-size-height", "320",
    "--sampler.vbs.check-scale", "32",
    "--image-augmentation.random-resized-crop.enable",
    "--image-augmentation.random-resized-crop.interpolation", "bilinear",
    "--image-augmentation.random-horizontal-flip.enable",
    "--image-augmentation.resize.enable",
    "--image-augmentation.resize.size", "288",
    "--image-augmentation.center-crop.enable",
    "--image-augmentation.center-crop.size", "256",
]
# MobileViT-XXS with the yaml's settings: layer 3's heads have D = 64 / 4 = 16,
# a head dim of the MHA kernels (S = 256 tokens at 256²); layers 4 and 5 (D =
# 20 and 24) take the einsum route
MOBILEVIT_XXS_ARGS = MOBILEVIT_ARGS + ["--model.classification.mit.mode", "xx_small"]
XXS_MHA_BLOCKS = 2
FASTVIT_ARGS = [  # config/classification/imagenet/fastvit.yaml, as flags
    "--model.classification.name", "fastvit",
    "--model.classification.n-classes", "1000",
    "--model.classification.fastvit.variant", "T8",
    "--model.normalization.name", "batch_norm",
    "--model.normalization.momentum", "0.1",
    "--model.activation.name", "gelu",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--loss.category", "classification",
    "--loss.classification.name", "cross_entropy",
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.05",
    "--optim.no-decay-bn-filter-bias",
    "--optim.adamw.beta1", "0.9",
    "--optim.adamw.beta2", "0.999",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "300",
    "--scheduler.warmup-iterations", "7500",
    "--scheduler.warmup-init-lr", "1e-6",
    "--scheduler.cosine.max-lr", "0.002",
    "--scheduler.cosine.min-lr", "2e-5",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--common.mixed-precision",
    "--dataset.train-batch-size0", "128",
    "--sampler.bs.crop-size-width", "224",
    "--sampler.bs.crop-size-height", "224",
    "--common.seed", "0",
] + IMAGENET_RUN_ARGS
FASTVIT_DATA_ARGS = [  # the rest of fastvit.yaml: loader, sampler, transforms
    "--dataset.category", "classification",
    "--dataset.workers", "8",
    "--sampler.name", "variable_batch_sampler",
    "--sampler.vbs.crop-size-width", "224",
    "--sampler.vbs.crop-size-height", "224",
    "--sampler.vbs.max-n-scales", "5",
    "--sampler.vbs.min-crop-size-width", "128",
    "--sampler.vbs.max-crop-size-width", "320",
    "--sampler.vbs.min-crop-size-height", "128",
    "--sampler.vbs.max-crop-size-height", "320",
    "--sampler.vbs.check-scale", "32",
    "--image-augmentation.random-resized-crop.enable",
    "--image-augmentation.random-resized-crop.interpolation", "bilinear",
    "--image-augmentation.random-horizontal-flip.enable",
    "--image-augmentation.resize.enable",
    "--image-augmentation.resize.size", "232",
    "--image-augmentation.center-crop.enable",
    "--image-augmentation.center-crop.size", "224",
]
SSD_ARGS = [  # config/detection/ssd_coco/mobilevit.yaml, as flags
    "--dataset.category", "detection",
    "--model.detection.name", "ssd",
    "--model.detection.n-classes", "81",
    "--model.detection.ssd.proj-channels", "512", "256", "256", "128", "128", "64",
    "--model.detection.ssd.nms-iou-threshold", "0.5",
    "--model.classification.name", "mobilevit",
    "--model.classification.mit.mode", "small",
    "--model.normalization.name", "batch_norm",
    "--model.normalization.momentum", "0.1",
    "--model.activation.name", "swish",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--anchor-generator.name", "ssd",
    "--anchor-generator.ssd.output-strides", "16", "32", "64", "128", "256", "-1",
    *sum((["--anchor-generator.ssd.aspect-ratios", "2", "3"] for _ in range(5)), []),
    "--anchor-generator.ssd.aspect-ratios", "2",
    "--anchor-generator.ssd.min-scale-ratio", "0.1",
    "--anchor-generator.ssd.max-scale-ratio", "1.05",
    "--matcher.name", "ssd",
    "--matcher.ssd.center-variance", "0.1",
    "--matcher.ssd.size-variance", "0.2",
    "--matcher.ssd.iou-threshold", "0.5",
    "--loss.category", "detection",
    "--loss.detection.name", "ssd_multibox_loss",
    "--loss.detection.ssd-multibox-loss.neg-pos-ratio", "3",
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.01",
    "--optim.no-decay-bn-filter-bias",
    "--optim.adamw.beta1", "0.9",
    "--optim.adamw.beta2", "0.999",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "200",
    "--scheduler.warmup-iterations", "500",
    "--scheduler.warmup-init-lr", "9e-5",
    "--scheduler.cosine.max-lr", "0.0009",
    "--scheduler.cosine.min-lr", "1.6e-5",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--common.mixed-precision",
    "--common.grad-clip", "10.0",
    "--common.run-label", "train",
    "--common.log-freq", "500",
    "--common.auto-resume",
    "--dataset.train-batch-size0", "32",
    "--dataset.val-batch-size0", "32",
    "--sampler.name", "batch_sampler",
    "--sampler.bs.crop-size-width", "320",
    "--sampler.bs.crop-size-height", "320",
    "--stats.val", "loss",
    "--stats.train", "loss",
    "--stats.checkpoint-metric", "loss",
    "--common.seed", "0",
]
SSD_DATA_ARGS = [  # the rest of the detection yaml: loader, collate, transforms
    "--dataset.name", "coco_ssd",
    "--dataset.workers", "8",
    "--dataset.collate-fn-name-train", "coco_ssd_collate_fn",
    "--dataset.collate-fn-name-val", "coco_ssd_collate_fn",
    "--dataset.collate-fn-name-test", "coco_ssd_collate_fn",
    "--image-augmentation.ssd-crop.enable",
    "--image-augmentation.photo-metric-distort.enable",
    "--image-augmentation.random-horizontal-flip.enable",
    "--image-augmentation.resize.enable",
]
# the seeded COCO folder of the SSD main_train phase (tools/coco_corpus.py):
# train images (20 steps of 32 an epoch), val images, the longer side's limit
SSD_CORPUS = (640, 16, 640)

CLIP_ARGS = [  # config/multi_modal_image_text/clip_vit.yaml, as flags
    "--dataset.category", "multi_modal_image_text",
    "--dataset.name", "flickr",
    "--dataset.train-batch-size0", "128",
    "--dataset.val-batch-size0", "64",
    "--dataset.workers", "8",
    "--dataset.collate-fn-name-train", "multi_modal_img_text_collate_fn",
    "--dataset.collate-fn-name-val", "multi_modal_img_text_collate_fn",
    "--dataset.collate-fn-name-test", "multi_modal_img_text_collate_fn",
    "--text-tokenizer.name", "clip",
    "--image-augmentation.random-resized-crop.enable",
    "--image-augmentation.random-resized-crop.interpolation", "bilinear",
    "--image-augmentation.resize.enable",
    "--image-augmentation.resize.size", "224",
    "--sampler.name", "batch_sampler",
    "--sampler.bs.crop-size-width", "224",
    "--sampler.bs.crop-size-height", "224",
    "--loss.category", "multi_modal_image_text",
    "--loss.multi-modal-image-text.name", "contrastive_loss_clip",
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.2",
    "--optim.no-decay-bn-filter-bias",
    "--optim.adamw.beta1", "0.9",
    "--optim.adamw.beta2", "0.98",
    "--scheduler.name", "cosine",
    "--scheduler.is-iteration-based",
    "--scheduler.max-iterations", "200000",
    "--scheduler.warmup-iterations", "2000",
    "--scheduler.warmup-init-lr", "1e-6",
    "--scheduler.cosine.max-lr", "0.0005",
    "--scheduler.cosine.min-lr", "1e-6",
    "--model.multi-modal-image-text.name", "clip",
    "--model.multi-modal-image-text.clip.projection-dim", "512",
    "--model.classification.name", "vit",
    "--model.classification.vit.mode", "base",
    "--model.classification.vit.norm-layer", "layer_norm_fp32",
    "--model.text.name", "transformer",
    "--model.text.context-length", "77",
    "--model.text.vocab-size", "49408",
    "--model.text.transformer.model-dim", "512",
    "--model.text.transformer.n-transformer-layers", "12",
    "--model.text.transformer.n-heads-per-layer", "8",
    "--model.text.transformer.causal-masking",
    "--model.normalization.name", "layer_norm",
    "--model.activation.name", "gelu",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--stats.val", "loss",
    "--stats.train", "loss",
    "--stats.checkpoint-metric", "loss",
    "--common.run-label", "train",
    "--common.log-freq", "500",
    "--common.auto-resume",
    "--common.mixed-precision",
    "--common.grad-clip", "1.0",
    "--common.seed", "0",
]
# the CLIP train phase's batch (the yaml's): 128 images and captions of 77
# tokens, SOT and EOT the vocabulary's last two ids
CLIP_BATCH, CLIP_CONTEXT, CLIP_VOCAB = 128, 77, 49408
CLIP_SOT, CLIP_EOT = CLIP_VOCAB - 2, CLIP_VOCAB - 1
# main_train's flickr corpus: the native phase's JPEG corpus (2,048 train and
# 200 val files, two damaged) with a seeded caption a file; 16 steps an
# epoch, 2 epochs, a log point every 4 steps; validation with the retrieval
# recalls; then zero-shot over the val folder's 8 classes with these names
CLIP_MAIN_TRAIN_ARGS = CLIP_ARGS + [
    "--scheduler.max-iterations", "32",
    "--common.log-freq", "4",
    "--stats.val", "loss", "image_text_retrieval",
]
CLIP_WORDS = (("red", "small", "old", "bright", "wet", "striped", "wooden", "shiny"),
              ("dog", "car", "tree", "boat", "house", "bird", "chair", "cup"),
              ("on a beach", "in the snow", "at night", "near a river", "in a field",
               "on a table", "under a bridge", "in the city"))
CLIP_CLASS_NAMES = ("tench", "goldfish", "great white shark", "tiger shark", "hammerhead",
                    "electric ray", "stingray", "cock")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, launches: int = 20, samples: int = 11, warmup: int = 5) -> float:
    """Median over ``samples`` of the mean time of ``launches`` back-to-back calls
    between two CUDA events: a single call between events would also time the
    host's launch overhead of a kernel that runs for tens of microseconds."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


class no_tf32:
    """TF32 off for convs and matmuls inside the block (it rounds their inputs to
    10 mantissa bits, so two float32 paths that differ by ~1e-7 would show ~1e-3);
    the previous settings come back afterwards."""

    def __enter__(self):
        import torch

        self.saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def set_use_kernel(model, on: bool, criteria=None) -> None:
    """Route every attention layer of ``model`` (and the loss, or each entry
    of a composite loss, where it has a switch) through the kernels or
    through the plain versions."""
    for m in model.modules():
        if hasattr(m, "use_kernel"):
            m.use_kernel = on
    for fn in (criteria, *getattr(criteria, "loss_fns", {}).values()):
        if hasattr(fn, "use_kernel"):
            fn.use_kernel = on


def bound(n_bytes: float, *ops) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM rate
    and each (count, peak rate a second) of ``ops`` over its rate."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = max((count / rate for count, rate in ops), default=0.0)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_yardstick(qh, kh, vh, dh, **kwargs) -> tuple:
    """The library yardstick: ``F.scaled_dot_product_attention`` forward and
    backward on (B, H, S, D) tensors that require grad, timed under each of
    ``SDPA_BACKENDS`` by name. Returns ({backend: {"fwd": ms, "bwd": ms}} of
    those that took the inputs, {backend: why} of those that refused)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times, refused = {}, {}
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                out = F.scaled_dot_product_attention(qh, kh, vh, **kwargs)
                fwd = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, **kwargs))
                bwd = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), dh,
                                                          retain_graph=True))
        except RuntimeError as err:  # no kernel of this backend takes the inputs
            refused[name] = str(err).splitlines()[0][:80]
            continue
        times[name] = {"fwd": fwd, "bwd": bwd}
    check(bool(times), f"an SDPA backend ran: {refused}")
    return times, refused


def _records(*parts) -> dict:
    """An empty kernel record for the JSON line, for each of ``parts``."""
    return {p: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "bound_by": "bytes", "library_ms": None} for p in parts}


def phase_device() -> str:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    return smi


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from cvnets_tpu_torch import native
    from cvnets_tpu_torch.ops.cuda_build import BUILD_DIR, build_library
    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel
    from cvnets_tpu_torch.ops.seg_ce_kernel import seg_ce_bwd_kernel, seg_ce_fwd_kernel
    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_bwd_kernel,
        separable_attention_kernel,
    )
    from cvnets_tpu_torch.ops.window_attention import window_bwd_kernel, window_fwd_kernel

    def build(source: str) -> str:
        lib = os.path.join(BUILD_DIR, os.path.splitext(source)[0] + ".so")
        before = os.path.isfile(lib)
        t0 = time.perf_counter()
        build_library(source)
        return (f"{source} in {time.perf_counter() - t0:.2f} s"
                f"{' (library found from an earlier build)' if before else ''}")

    sources = ("separable_attention.cu", "mha_attention.cu", "seg_ce.cu",
               "window_attention.cu", "jpeg_decode.cu")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, together
        done = list(pool.map(build, sources))
    print(f"build: {'; '.join(done)}; {time.perf_counter() - t0:.2f} s in all", flush=True)
    for kernel in (separable_attention_kernel, separable_attention_bwd_kernel,
                   mha_fwd_kernel, mha_bwd_kernel,
                   seg_ce_fwd_kernel, seg_ce_bwd_kernel, window_fwd_kernel,
                   window_bwd_kernel, native.crop_resize_flip_kernel):
        kernel.load()
    native.load_library()


def check_qkv_grads(got, ref, c: int, dtype, what: str) -> list:
    """Holds dq, dk and dv, the column parts of one (BP, N, 1 + 2C) gradient,
    each to its reference: finite, and float32 within 1e-4 absolute (three
    sums chained in another order), bfloat16 within 2e-2 of that part's
    largest value (each rounded to bf16 once, from float32 values that
    differ), and never under the float32 1e-4: where a part is zero in exact
    arithmetic (dq at N = 1, where s = 1) the two sides' float32
    cancellations leave ~1e-6. Each part has its own tolerance: dq runs about
    100 times larger than dk and dv, so one for the whole dqkv would let a
    wrong dk or dv pass. Returns (part, max abs err, tolerance) for each."""
    import torch

    check(bool(torch.isfinite(got).all()), f"{what} not finite")
    errs = []
    for part, a, b in zip(("dq", "dk", "dv"), got.float().split([1, c, c], dim=-1),
                          ref.float().split([1, c, c], dim=-1)):
        err = (a - b).abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else max(2e-2 * b.abs().max().item(), 1e-4)
        check(err <= tol, f"{what} {part} err {err} > {tol}")
        errs.append((part, err, tol))
    return errs


def _separable_case(g, bp: int, n: int, c: int, dtype, name: str) -> dict:
    """The separable-attention kernels on one seeded qkv against the plain
    versions: the forward's output; the gradient of qkv through the Function
    (both kernels) against autograd of the plain forward; the backward kernel
    alone against the plain backward, and the same bits on a rerun. Raises on
    a fault; returns the inputs, the kernels' calls and the errors."""
    import torch

    from cvnets_tpu_torch.ops.separable_attention import (
        SeparableAttention,
        separable_attention_backward,
        separable_attention_bwd_kernel,
        separable_attention_kernel,
        separable_attention_plain,
    )

    # q, k, v as column slices of one qkv projection, as on the main path
    qkv = torch.randn((bp, n, 1 + 2 * c), generator=g, device="cuda").to(dtype)
    q, k, v = qkv.split([1, c, c], dim=-1)
    out, stats, ctx = separable_attention_kernel(q, k, v)
    ref = separable_attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    abs_err = err.max().item()
    # relative to |ref| + 1e-5: where ctx cancels to ~0 the two f32 sum
    # orders differ by ~1e-7 absolute but not relatively
    rel_err = (err / (ref.float().abs() + 1e-5)).max().item()
    if dtype == torch.float32:
        check(abs_err <= 1e-5, f"f32 ({bp},{n},{c}) max abs err {abs_err}")
    else:
        # bf16 output rounding of nearly the same f32 value: 2^-8 relative
        check(rel_err <= 2e-2, f"bf16 ({bp},{n},{c}) max rel err {rel_err}")

    # grads: the Function (both kernels) against autograd of plain
    w = torch.randn((bp, n, c), generator=g, device="cuda").to(dtype)
    grads = []
    for fn in (lambda x: SeparableAttention.apply(x, c),
               lambda x: separable_attention_plain(*x.split([1, c, c], dim=-1))):
        x = qkv.detach().clone().requires_grad_()
        (fn(x).float() * w.float()).sum().backward()
        grads.append(x.grad)
    gerr = max(e for _, e, _ in check_qkv_grads(grads[0], grads[1], c, dtype,
                                                f"{name} ({bp},{n},{c}) grad"))

    # the backward kernel alone against the plain backward, and its bits
    dqkv, again = torch.empty_like(qkv), torch.empty_like(qkv)

    def bwd_kernel(dst=dqkv):
        separable_attention_bwd_kernel(q, k, v, w, stats, ctx, *dst.split([1, c, c], dim=-1))

    def bwd_plain():
        return torch.cat(separable_attention_backward(q, k, v, w), dim=-1)

    bwd_kernel()
    bwd_kernel(again)
    ref_grad = bwd_plain()
    torch.cuda.synchronize()
    errs = check_qkv_grads(dqkv, ref_grad, c, dtype, f"{name} ({bp},{n},{c}) backward kernel")
    check(torch.equal(dqkv, again), f"{name} ({bp},{n},{c}) backward differs on a rerun")
    return dict(qkv=qkv, q=q, k=k, v=v, out=out, abs_err=abs_err, rel_err=rel_err, gerr=gerr,
                errs=errs, bwd_kernel=bwd_kernel, bwd_plain=bwd_plain)


# (BP, N, C) off the main path's shapes, checked but not timed: a ragged last
# run of each block (N not a multiple of the blocks a row times a step of
# tokens) with, on a 132-SM card, 1, 2, 4 and 8 blocks a row; N past the old
# 12,256 limit; a block with fewer tokens than a warp step; one token; C 512
SEP_RAGGED = ((512, 1000, 128), (200, 1000, 128), (100, 1000, 192), (32, 1000, 128),
              (32, 12257, 128), (4, 5, 64), (3, 1, 128), (16, 300, 512))


def phase_kernel(card: str) -> dict:
    """The separable-attention forward and backward kernels at the flagship's
    and DeepLabv3's shapes, checked and timed, and at SEP_RAGGED, checked;
    returns the flagship's records for the JSON line."""
    import torch

    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_kernel,
        separable_attention_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(0)
    records = _records("fwd", "bwd")
    for label, (bp, blocks) in (("flagship", SEP_FLAGSHIP), ("deeplab", SEP_DEEPLAB)):
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            for n, c in blocks:
                r = _separable_case(g, bp, n, c, dtype, name)
                q, k, v, qkv, out = r["q"], r["k"], r["v"], r["qkv"], r["out"]
                k_ms = time_ms(lambda: separable_attention_kernel(q, k, v))
                p_ms = time_ms(lambda: separable_attention_plain(q, k, v))
                kb_ms = time_ms(r["bwd_kernel"])
                pb_ms = time_ms(r["bwd_plain"])
                # reads q, k, v (the qkv columns) once, writes the output; 4 flops
                # an element of k/v (ctx, relu·ctx) and one exp a token
                b_ms, b_by = bound(qkv.numel() * qkv.element_size() + out.numel()
                                   * out.element_size(), (4 * bp * n * c, FP32_FLOP_S),
                                   (bp * n, SFU_EXP_S))
                # reads g, k, v and q once, writes dk, dv and dq once (10 bytes an
                # element in bf16, plus q and dq); 7 flops an element (dv, dctx,
                # dk, ds) and one exp a token
                bb_ms, bb_by = bound((5 * c + 2) * bp * n * qkv.element_size(),
                                     (7 * bp * n * c, FP32_FLOP_S), (bp * n, SFU_EXP_S))
                berr = max(e for _, e, _ in r["errs"])
                if dtype == torch.bfloat16 and label == "flagship":
                    for rec, e, t, pt, bt, by in (
                            (records["fwd"], r["abs_err"], k_ms, p_ms, b_ms, b_by),
                            (records["bwd"], berr, kb_ms, pb_ms, bb_ms, bb_by)):
                        rec["max_abs_err"] = max(rec["max_abs_err"], e)
                        rec["ms"] += blocks[(n, c)] * t
                        rec["plain_ms"] += blocks[(n, c)] * pt
                        rec["bound_ms"] += blocks[(n, c)] * bt
                        rec["bound_by"] = by
                print(f"kernel: {label} {name} BP={bp} N={n} C={c} max_abs_err={r['abs_err']:.3e} "
                      f"max_rel_err={r['rel_err']:.3e} grad_err={r['gerr']:.3e} "
                      f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) | "
                      f"bwd: {_grad_errs(r['errs'])} same_bits=True "
                      f"bwd_ms={kb_ms:.4f} bwd_plain_ms={pb_ms:.4f} bwd_bound_ms={bb_ms:.4f} "
                      f"({bb_by}) bwd/bound={kb_ms / bb_ms:.2f} | {card}", flush=True)
    for bp, n, c in SEP_RAGGED:
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            r = _separable_case(g, bp, n, c, dtype, name)
            print(f"kernel: ragged {name} BP={bp} N={n} C={c} max_abs_err={r['abs_err']:.3e} "
                  f"max_rel_err={r['rel_err']:.3e} grad_err={r['gerr']:.3e} | bwd: "
                  f"{_grad_errs(r['errs'])} same_bits=True", flush=True)
            del r
    return records


def _grad_errs(errs) -> str:
    return " ".join(f"{part}_err={e:.3e} (tol {t:.3e})" for part, e, t in errs)


def _mha_case(g, label: str, b: int, s: int, h: int, d: int, dtype, masked: bool):
    """The MHA kernels forward and backward against the plain versions on one
    seeded input; raises on a non-finite or wrong output. Returns the inputs,
    the kernel's output and statistics, the plain output and the errors."""
    import torch

    from cvnets_tpu_torch.ops.mha_attention import (
        mha_attention_backward_plain,
        mha_attention_plain,
        mha_attention_stats_plain,
        mha_bwd_kernel,
        mha_fwd_kernel,
    )

    e = h * d
    # q, k, v as column slices of one qkv projection, q scaled, as
    # MultiHeadAttention hands them over
    qkv = torch.randn((b, s, 3 * e), generator=g, device="cuda").to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    q = q * d ** -0.5
    mask = None
    if masked:  # -1e30 as the layer makes it; batch element 0 fully masked
        mask = torch.where(torch.rand((b, s), generator=g, device="cuda") < 0.2, -1e30, 0.0)
        mask[0] = -1e30
    dout = torch.randn((b, s, e), generator=g, device="cuda").to(dtype)
    out, stats = mha_fwd_kernel(q, k, v, h, mask)
    grads = mha_bwd_kernel(q, k, v, mask, out, dout, stats, h)
    again = mha_bwd_kernel(q, k, v, mask, out, dout, stats, h)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(grads, again)),
          f"{label} dq, dk, dv differ between two calls")
    ref = mha_attention_plain(q, k, v, h, mask)
    ref_grads = mha_attention_backward_plain(q, k, v, mask, ref, dout, h)
    errs = {}
    for what, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), (ref, *ref_grads)):
        check(bool(torch.isfinite(got).all()), f"{label} {what} finite")
        err = (got.float() - want.float()).abs().max().item()
        # float32: the same math in another order; bf16: P and dS rounded to
        # bf16 before their products, outputs rounded
        tol = ((1e-5 if what == "out" else 1e-4) if dtype == torch.float32
               else 2e-2 * want.float().abs().max().item())
        check(err <= tol, f"{label} {what} err {err} > {tol}")
        errs[what] = err
    # the statistics (row max and log-sum, which the backward reads), relative
    # to max(|ref|, 1): the log-sum is near 0 where one key dominates.
    # float32: the same float32 sums in another order (1e-5); bf16: the
    # logits and sums are float32 there too, from the bf16 inputs, so 1e-2
    # is loose; the line prints what the kernel reached
    ref_stats = mha_attention_stats_plain(q, k, v, h, mask)
    check(bool(torch.isfinite(stats).all()), f"{label} stats finite")
    err = ((stats - ref_stats).abs() / ref_stats.abs().clamp(min=1.0)).max().item()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    check(err <= tol, f"{label} stats rel err {err} > {tol}")
    errs["stats"] = err
    return q, k, v, mask, dout, out, stats, ref, errs


def mha_bounds(b: int, s: int, h: int, d: int, itemsize: int, tc_rate: float) -> dict:
    """The least time of the MHA functions, not of a design: each input read
    once and each output written once (forward: q, k, v in, O and the (2, B,
    H, S) statistics out; backward: q, k, v, O, dO and the statistics in, dq,
    dk, dv out); 2 products of 2·S²·D a head forward and 5 backward (S, dP,
    dV, dK, dQ, however many a design recomputes); one exponential a logit."""
    act = b * s * h * d * itemsize
    stats = 2 * b * h * s * 4
    prod = 2 * b * h * s * s * d
    exps = (b * h * s * s, SFU_EXP_S)
    return {"fwd": bound(4 * act + stats, (2 * prod, tc_rate), exps),
            "bwd": bound(8 * act + stats, (5 * prod, tc_rate), exps)}


def _mha_times(b, s, h, d, q, k, v, dout, out, stats, ref) -> dict:
    """One call's time of the MHA kernels, their plain versions and SDPA
    (each of ``SDPA_BACKENDS`` by name; ``lib_fwd`` and ``lib_bwd`` the
    faster one's, which ``lib_fwd_backend`` and ``lib_bwd_backend`` name) at
    a bf16 shape without a mask."""
    import torch

    from cvnets_tpu_torch.ops.mha_attention import (
        mha_attention_backward_plain,
        mha_attention_plain,
        mha_bwd_kernel,
        mha_fwd_kernel,
    )

    t = {"fwd": time_ms(lambda: mha_fwd_kernel(q, k, v, h, None)),
         "fwd_plain": time_ms(lambda: mha_attention_plain(q, k, v, h, None)),
         "bwd": time_ms(lambda: mha_bwd_kernel(q, k, v, None, out, dout, stats, h)),
         "bwd_plain": time_ms(lambda: mha_attention_backward_plain(q, k, v, None, ref, dout,
                                                                   h))}
    # SDPA on (B, H, S, D) copies
    qh, kh, vh, dh = (t_.detach().reshape(b, s, h, d).transpose(1, 2).contiguous()
                      .requires_grad_() for t_ in (q, k, v, dout))
    t["sdpa"], t["sdpa_refused"] = sdpa_yardstick(qh, kh, vh, dh, scale=1.0)
    for p in ("fwd", "bwd"):
        fastest = min(t["sdpa"], key=lambda name: t["sdpa"][name][p])
        t[f"lib_{p}"], t[f"lib_{p}_backend"] = t["sdpa"][fastest][p], fastest
    del qh, kh, vh, dh
    torch.cuda.empty_cache()
    return t


def _mha_library(record: dict, t: dict, p: str, scale: float) -> None:
    """``record``'s library fields from ``t``'s SDPA times of pass ``p``:
    ``library_ms`` the faster backend's, named in ``library_backend``, and
    every backend's in ``library_ms_by_backend``, each times ``scale``."""
    record["library_ms"] = scale * t[f"lib_{p}"]
    record["library_backend"] = t[f"lib_{p}_backend"]
    record["library_ms_by_backend"] = {name: scale * ms[p] for name, ms in t["sdpa"].items()}


def _mha_times_line(t: dict, bounds: dict, flops_fwd: float) -> str:
    return (" ".join(f"{k_}_ms={t[k_]:.4f}" for k_ in ("fwd", "fwd_plain", "bwd", "bwd_plain"))
            + "".join(f" {p}_bound_ms={bounds[p][0]:.4f} ({bounds[p][1]})" for p in bounds)
            + f" fwd_tflops={flops_fwd / t['fwd'] / 1e9:.1f}"
            f" bwd_tflops={2.5 * flops_fwd / t['bwd'] / 1e9:.1f}"
            + "".join(f" | sdpa [{name}] fwd_ms={ms['fwd']:.4f} bwd_ms={ms['bwd']:.4f}"
                      f" fwd_tflops={flops_fwd / ms['fwd'] / 1e9:.1f}"
                      f" bwd/sdpa={t['bwd'] / ms['bwd']:.3f} fwd/sdpa={t['fwd'] / ms['fwd']:.3f}"
                      for name, ms in t["sdpa"].items())
            + "".join(f" | sdpa [{name}] refused ({why})" for name, why in t["sdpa_refused"].items())
            + f" | library: fwd [{t['lib_fwd_backend']}] bwd [{t['lib_bwd_backend']}]"
            f" fwd/library={t['fwd'] / t['lib_fwd']:.3f} bwd/library={t['bwd'] / t['lib_bwd']:.3f}")


def phase_mha_kernel(card: str) -> dict:
    """Returns {"fwd": record, "bwd": record} for the JSON line."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(1)
    records = _records("fwd", "bwd")
    with no_tf32():
        for label, b, s, h, d in MHA_CASES:
            e = h * d
            for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                for masked in (False, True):
                    q, k, v, mask, dout, out, stats, ref, errs = _mha_case(
                        g, f"{label} {name} mask={masked}", b, s, h, d, dtype, masked)
                    if dtype == torch.bfloat16:
                        records["fwd"]["max_abs_err"] = max(records["fwd"]["max_abs_err"],
                                                            errs["out"])
                        records["bwd"]["max_abs_err"] = max(
                            records["bwd"]["max_abs_err"], errs["dq"], errs["dk"], errs["dv"])
                    times = ""
                    if label == "vit_base" and dtype == torch.bfloat16 and not masked:
                        bounds = mha_bounds(b, s, h, d, q.element_size(), BF16_TC_FLOP_S)
                        t = _mha_times(b, s, h, d, q, k, v, dout, out, stats, ref)
                        for p in ("fwd", "bwd"):
                            records[p]["ms"] = VIT_BLOCKS * t[p]
                            records[p]["plain_ms"] = VIT_BLOCKS * t[f"{p}_plain"]
                            records[p]["bound_ms"] = VIT_BLOCKS * bounds[p][0]
                            records[p]["bound_by"] = bounds[p][1]
                            _mha_library(records[p], t, p, VIT_BLOCKS)
                        times = " " + _mha_times_line(t, bounds, 4 * b * s * s * e)
                    print(f"mha kernel: {label} {name} B={b} S={s} H={h} D={d} "
                          f"mask={masked} " + " ".join(f"{w}_err={x:.3e}"
                                                       for w, x in errs.items())
                          + times + f" | {card}", flush=True)
    return records


def seg_ce_inputs(g, c: int) -> tuple:
    """Head logits (SEG_B, SEG_HEAD, SEG_HEAD, c) float32, a permuted view of
    NCHW storage as the loss passes them, and labels (SEG_B, SEG_FULL,
    SEG_FULL) int64 with 5% ignored pixels (255) and one fully ignored image,
    from the generator ``g`` on the card."""
    import torch

    logits = 2.0 * torch.randn((SEG_B, c, SEG_HEAD, SEG_HEAD), generator=g,
                               device="cuda").permute(0, 2, 3, 1)
    target = torch.randint(0, c, (SEG_B, SEG_FULL, SEG_FULL), generator=g, device="cuda")
    target[torch.rand(target.shape, generator=g, device="cuda") < 0.05] = 255
    target[SEG_B - 1] = 255  # one fully ignored image
    return logits, target


def seg_ce_spread(g, c: int) -> tuple:
    """Head logits spread uniformly over ±100 with, in a fifth of the head
    pixels, one class at 300, and labels as ``seg_ce_inputs`` makes them: an
    output pixel beside a hot head pixel lies tens of units under the bound
    on its max that the forward kernel shifts by (the weighted maxima of its
    input columns), so its sum of exponentials underflows and it takes the
    kernel's two passes with its true max."""
    import torch

    logits, target = seg_ce_inputs(g, c)
    logits = 100.0 * (2.0 * torch.rand(logits.shape, generator=g, device="cuda") - 1.0)
    logits = logits.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)  # as the loss's
    hot = torch.rand(logits.shape[:3], generator=g, device="cuda") < 0.2
    cls = torch.randint(0, c, logits.shape[:3] + (1,), generator=g, device="cuda")
    logits.scatter_(-1, cls, torch.where(hot[..., None], 300.0, logits.gather(-1, cls)))
    return logits, target


def seg_ce_underflows(hmid, aw, target) -> int:
    """The valid pixels whose sum of exponentials under the forward kernel's
    bound falls below its 2^-60 (kTiny in seg_ce.cu): those that take its
    two-pass fallback."""
    import torch

    col = torch.matmul(aw, hmid)
    bound = torch.matmul(aw, hmid.amax(-1, keepdim=True))
    s = torch.exp2((col - bound) * 1.4426950408889634).sum(-1)
    return int(((s < 2.0 ** -60) & (target != 255)).sum())


def seg_ce_bounds(logits, target) -> dict:
    """{"fwd": (ms, by), "bwd": (ms, by)}: each input read once, each output
    written once (the forward reads the head logits and the labels, the
    backward hmid, (B, H, w, C) float32, and the labels, and writes dhm); per
    logit of a pixel that is not ignored (both kernels skip the others) one
    exp, 2 taps (4 flops) and the max/sum/sub (3) forward, and the softmax, G
    and 2 taps back (7 more)."""
    b, _, w, c = logits.shape
    n = int((target != 255).sum()) * c
    label_bytes = target.numel() * target.element_size()
    hmid_bytes = b * target.shape[1] * w * c * 4
    return {"fwd": bound(logits.numel() * 4 + label_bytes + 8, (7 * n, FP32_FLOP_S),
                         (n, SFU_EXP_S)),
            "bwd": bound(2 * hmid_bytes + label_bytes, (14 * n, FP32_FLOP_S), (n, SFU_EXP_S))}


def _seg_dhm_check(label: str, hmid, target, aw, taps, cw, ls: float) -> float:
    """The backward kernel's dhm against ``seg_ce_bwd_plain`` (1e-6 of its
    largest value: sums of up to 32 terms in another order, as the card tests
    hold it) and the same bits on a rerun; returns the largest error."""
    import torch

    from cvnets_tpu_torch.ops.seg_ce_kernel import seg_ce_bwd_kernel, seg_ce_bwd_plain

    scale = torch.full((1,), 1.0 / target.numel(), device=hmid.device)
    dhm = seg_ce_bwd_kernel(hmid, target, taps, cw, scale, 255, ls)
    again = seg_ce_bwd_kernel(hmid, target, taps, cw, scale, 255, ls)
    ref = seg_ce_bwd_plain(hmid, aw, target, cw, scale, 255, ls)
    torch.cuda.synchronize()
    err = (dhm - ref).abs().max().item()
    tol = 1e-6 * ref.abs().max().item()
    check(bool(torch.isfinite(dhm).all()) and err <= tol,
          f"seg ce {label} dhm err {err} > {tol}")
    check(torch.equal(dhm, again), f"seg ce {label} dhm differs between two runs")
    return err


def _seg_fwd_check(label: str, logits, target, a, taps, cw, ls: float) -> float:
    """The forward kernel's (loss_sum, n_valid) against ``seg_ce_fwd_plain``
    of ``h_interp``'s hmid (``a`` and ``taps`` serve A_h and A_w: the resize
    is square): the sum within 1e-6 relative (float32 terms over up to 2 M
    pixels summed in another order), the count exact, and the same bits on a
    rerun; returns the error of the mean, loss_sum / n_valid."""
    import torch

    from cvnets_tpu_torch.ops.seg_ce_kernel import h_interp, seg_ce_fwd_kernel, seg_ce_fwd_plain

    loss_sum, n_valid = seg_ce_fwd_kernel(logits, target, taps, taps, cw, 255, ls)
    again = seg_ce_fwd_kernel(logits, target, taps, taps, cw, 255, ls)
    ref_sum, ref_n = seg_ce_fwd_plain(h_interp(logits, a), a, target, cw, 255, ls)
    err = abs(loss_sum.item() - ref_sum.item())
    check(bool(torch.isfinite(loss_sum)) and err <= 1e-6 * abs(ref_sum.item()),
          f"seg ce {label} loss_sum {loss_sum.item()} against {ref_sum.item()}")
    check(n_valid.item() == ref_n.item(),
          f"seg ce {label} n_valid {n_valid.item()} against {ref_n.item()}")
    check(torch.equal(loss_sum, again[0]) and torch.equal(n_valid, again[1]),
          f"seg ce {label} (loss_sum, n_valid) differ between two runs")
    print(f"seg ce kernel: fwd {label} loss_sum {loss_sum.item():.6e} rel err "
          f"{err / abs(ref_sum.item()):.3e}, n_valid {int(n_valid.item())} exact, same bits "
          f"on a rerun", flush=True)
    return err / max(ref_n.item(), 1.0)


def phase_seg_ce_kernel(card: str) -> dict:
    """The fused resize + CE kernels against the plain unfused version at
    DeepLabv3's shapes; the forward's (loss_sum, n_valid) and the backward's
    dhm each against its plain version, under the four label-smoothing and
    class-weight cases, on spread logits (the forward's fallback) and at C
    21; returns {"fwd": record, "bwd": record}."""
    import torch

    from cvnets_tpu_torch.loss.base_criteria import BaseCriteria
    from cvnets_tpu_torch.ops.seg_ce import (
        fused_resize_ce,
        resize_ce_plain,
        resize_matrix,
        resize_taps,
    )
    from cvnets_tpu_torch.ops.seg_ce_kernel import (
        h_interp,
        seg_ce_bwd_kernel,
        seg_ce_bwd_plain,
        seg_ce_fwd_kernel,
        seg_ce_fwd_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(2)
    logits32, target = seg_ce_inputs(g, SEG_C)
    wts = BaseCriteria._class_weights(torch.where(target == 255, 0, target), SEG_C)
    dev = logits32.device
    ah = resize_matrix(SEG_FULL, SEG_HEAD, dev)
    aw = resize_matrix(SEG_FULL, SEG_HEAD, dev)
    taps = resize_taps(SEG_FULL, SEG_HEAD, dev)
    records = _records("fwd", "bwd")
    with no_tf32():
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            for ls in (0.0, 0.1):
                for cw in (None, wts):
                    errs = {}
                    losses, grads = [], []
                    for fn in (fused_resize_ce, resize_ce_plain):
                        x = logits32.to(dtype, copy=True).requires_grad_()
                        loss = fn(x, target, label_smoothing=ls, class_wts=cw)
                        loss.backward()
                        losses.append(loss.detach().float())
                        grads.append(x.grad.float())
                    torch.cuda.synchronize()
                    check(all(bool(torch.isfinite(t).all()) for t in losses + grads),
                          f"seg ce {name} ls={ls} finite")
                    errs["loss"] = (losses[0] - losses[1]).abs().item()
                    errs["dlogits"] = (grads[0] - grads[1]).abs().max().item()
                    gmax = grads[1].abs().max().item()
                    # float32: sums over 1.9 M pixels and over C in other orders;
                    # bfloat16: both grads rounded to bf16 from nearly equal floats
                    check(errs["loss"] <= 1e-5 * losses[1].abs().item(),
                          f"seg ce {name} ls={ls} wts={cw is not None} loss err {errs['loss']}")
                    gtol = (1e-4 if dtype == torch.float32 else 2 ** -7) * gmax
                    check(errs["dlogits"] <= gtol, f"seg ce {name} ls={ls} "
                          f"wts={cw is not None} dlogits err {errs['dlogits']} > {gtol}")
                    records["bwd"]["max_abs_err"] = max(records["bwd"]["max_abs_err"],
                                                        errs["dlogits"])
                    times = ""
                    if dtype == torch.float32:
                        records["fwd"]["max_abs_err"] = max(
                            records["fwd"]["max_abs_err"], _seg_fwd_check(
                                f"C={SEG_C} ls={ls} class_wts={cw is not None}", logits32,
                                target, aw, taps, cw, ls))
                    if dtype == torch.float32 and ls == 0.0 and cw is None:  # the yaml's case
                        hmid = h_interp(logits32, ah)
                        errs["dhm"] = _seg_dhm_check(f"C={SEG_C}", hmid, target, aw, taps,
                                                     None, 0.0)
                        scale = torch.full((1,), 1e-6, device=dev)
                        t = {"fwd": time_ms(lambda: seg_ce_fwd_kernel(logits32, target, taps,
                                                                      taps, None, 255, 0.0)),
                             "fwd_plain": time_ms(lambda: seg_ce_fwd_plain(
                                 h_interp(logits32, ah), aw, target, None, 255, 0.0)),
                             "bwd": time_ms(lambda: seg_ce_bwd_kernel(hmid, target, taps, None,
                                                                      scale, 255, 0.0)),
                             "bwd_plain": time_ms(lambda: seg_ce_bwd_plain(
                                 hmid, aw, target, None, scale, 255, 0.0))}
                        bounds = seg_ce_bounds(logits32, target)
                        for p in ("fwd", "bwd"):
                            records[p]["ms"] = SEG_CALLS * t[p]
                            records[p]["plain_ms"] = SEG_CALLS * t[f"{p}_plain"]
                            records[p]["bound_ms"] = SEG_CALLS * bounds[p][0]
                            records[p]["bound_by"] = bounds[p][1]
                        times = f" dhm_err={errs['dhm']:.3e} (same bits on a rerun)" + "".join(
                            f" {k}_ms={v:.4f}" for k, v in t.items()) + "".join(
                            f" {p}_bound_ms={bounds[p][0]:.4f} ({bounds[p][1]})"
                            for p in ("fwd", "bwd"))
                    print(f"seg ce kernel: {name} B={SEG_B} h=w={SEG_HEAD} H=W={SEG_FULL} "
                          f"C={SEG_C} ls={ls} class_wts={cw is not None} loss_err="
                          f"{errs['loss']:.3e} dlogits_err={errs['dlogits']:.3e} "
                          f"(max |dlogits| {gmax:.3e}){times} | {card}", flush=True)
        # spread logits: the forward's two-pass fallback, ls 0 and 0.1 with
        # class weights
        logits_sp, target_sp = seg_ce_spread(g, SEG_C)
        hmid_sp = h_interp(logits_sp, ah)
        n_under = seg_ce_underflows(hmid_sp, aw, target_sp)
        check(n_under > 0, "seg ce spread logits send no pixel to the fallback")
        print(f"seg ce kernel: spread logits C={SEG_C}: {n_under} valid pixels under the "
              f"bound's reach (the fallback) | {card}", flush=True)
        for ls, cw in ((0.0, None), (0.1, wts)):
            records["fwd"]["max_abs_err"] = max(records["fwd"]["max_abs_err"], _seg_fwd_check(
                f"spread C={SEG_C} ls={ls} class_wts={cw is not None}", logits_sp, target_sp,
                aw, taps, cw, ls))
        del hmid_sp
        # C 21: the loss, dlogits, forward and dhm checks at f32, ls 0, no class
        # weights
        logits21, target21 = seg_ce_inputs(g, SEG_C_VOC)
        losses, grads = [], []
        for fn in (fused_resize_ce, resize_ce_plain):
            x = logits21.clone().requires_grad_()
            loss = fn(x, target21)
            loss.backward()
            losses.append(loss.detach())
            grads.append(x.grad)
        hmid21 = h_interp(logits21, ah)
        records["fwd"]["max_abs_err"] = max(records["fwd"]["max_abs_err"], _seg_fwd_check(
            f"C={SEG_C_VOC}", logits21, target21, aw, taps, None, 0.0))
        dhm_err = _seg_dhm_check(f"C={SEG_C_VOC}", hmid21, target21, aw, taps, None, 0.0)
        loss_err = (losses[0] - losses[1]).abs().item()
        dl_err = (grads[0] - grads[1]).abs().max().item()
        gmax = grads[1].abs().max().item()
        check(loss_err <= 1e-5 * losses[1].abs().item(), f"seg ce C={SEG_C_VOC} loss err")
        check(dl_err <= 1e-4 * gmax, f"seg ce C={SEG_C_VOC} dlogits err {dl_err}")
        scale = torch.full((1,), 1e-6, device=dev)
        fwd_ms = time_ms(lambda: seg_ce_fwd_kernel(logits21, target21, taps, taps, None, 255,
                                                   0.0))
        bwd_ms = time_ms(lambda: seg_ce_bwd_kernel(hmid21, target21, taps, None, scale, 255,
                                                   0.0))
        bound21 = seg_ce_bounds(logits21, target21)
        print(f"seg ce kernel: f32 B={SEG_B} h=w={SEG_HEAD} H=W={SEG_FULL} C={SEG_C_VOC} "
              f"ls=0.0 class_wts=False loss_err={loss_err:.3e} dlogits_err={dl_err:.3e} "
              f"(max |dlogits| {gmax:.3e}) dhm_err={dhm_err:.3e} (same bits on a rerun) "
              f"fwd_ms={fwd_ms:.4f} fwd_bound_ms={bound21['fwd'][0]:.4f} "
              f"({bound21['fwd'][1]}) bwd_ms={bwd_ms:.4f} bwd_bound_ms={bound21['bwd'][0]:.4f} "
              f"({bound21['bwd'][1]}) | {card}", flush=True)
    return records


def window_inputs(g, side: int, h: int, dtype, shifted: bool) -> tuple:
    """q, k, v (column thirds of one qkv tensor, as WindowAttention makes them,
    q scaled), the bias, the stage's real shift mask or None, and dO, at a
    Swin-T stage at batch SWIN_BATCH."""
    import torch

    from cvnets_tpu_torch.modules.swin_transformer_block import shifted_window_mask

    s, e = WIN * WIN, h * WIN_D
    bnw = SWIN_BATCH * (side // WIN) ** 2
    qkv = torch.randn((bnw, s, 3 * e), generator=g, device="cuda").to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    q = q * WIN_D ** -0.5
    bias = 0.5 * torch.randn((h, s, s), generator=g, device="cuda")
    mask = (torch.from_numpy(shifted_window_mask(side, side, WIN, WIN // 2)).cuda()
            if shifted else None)
    dout = torch.randn((bnw, s, e), generator=g, device="cuda").to(dtype)
    return q, k, v, bias, mask, dout


def window_bounds(q, h: int, mask) -> dict:
    """{"fwd", "bwd": bound(...)} of the window kernels on these inputs: each
    input read once, each output written once (dbias too); 2 products
    forward, 5 backward, one exponential a logit."""
    bnw, s, e = q.shape
    act = bnw * s * e * q.element_size()
    small = (h + (0 if mask is None else mask.shape[0])) * s * s * 4
    flops = 4 * bnw * s * s * e
    exps = (bnw * h * s * s, SFU_EXP_S)
    return {"fwd": bound(4 * act + small, (flops, BF16_TC_FLOP_S), exps),
            "bwd": bound(7 * act + small + h * s * s * 4, (2.5 * flops, BF16_TC_FLOP_S), exps)}


def window_sdpa(q, k, v, dout, h: int, bias, mask) -> tuple:
    """The library yardstick: SDPA on (B·nW, H, S, D) copies with the bias
    (plus the mask) as a float attn_mask; (forward, backward) callables, the
    backward giving dq, dk and dv, not dbias."""
    import torch
    import torch.nn.functional as F

    bnw, s, e = q.shape
    qh, kh, vh, dh = (t_.detach().reshape(bnw, s, h, e // h).transpose(1, 2)
                      .contiguous().requires_grad_() for t_ in (q, k, v, dout))
    if mask is None:
        am = bias[None]
    else:
        nw = mask.shape[0]
        am = (bias[None, None] + mask[None, :, None]).expand(
            bnw // nw, nw, h, s, s).reshape(bnw, h, s, s)
    am = am.to(q.dtype)
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am, scale=1.0)
    return (lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am, scale=1.0),
            lambda: torch.autograd.grad(lib_out, (qh, kh, vh), dh, retain_graph=True))


def phase_window_kernel(card: str) -> dict:
    """The window-attention kernels against their plain versions at Swin-T's
    stage shapes; returns {"fwd": record, "bwd": record} summed over one step's
    12 blocks (bf16, unshifted and shifted blocks at their own times). The bf16
    kernels prefetch the next window by cp.async, build every fragment by
    ldmatrix and take exp2 (csrc/window_attention.cu's head comment); each
    bf16 line ends with the forward's and the backward's time over its bound
    (``fwd/bound``, ``bwd/bound``) and over SDPA's (``fwd/library``,
    ``bwd/library``)."""
    import torch

    from cvnets_tpu_torch.ops.window_attention import (
        window_attention_backward_plain,
        window_attention_plain,
        window_bwd_kernel,
        window_fwd_kernel,
    )

    g = torch.Generator(device="cuda").manual_seed(3)
    records = _records("fwd", "bwd")
    records["fwd"]["library_ms"] = records["bwd"]["library_ms"] = 0.0
    s = WIN * WIN
    with no_tf32():
        for label, side, h, n_plain, n_shift in SWIN_STAGES:
            bnw = SWIN_BATCH * (side // WIN) ** 2
            for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                for shifted in (False, True):
                    if shifted and not n_shift:
                        continue
                    q, k, v, bias, mask, dout = window_inputs(g, side, h, dtype, shifted)
                    out = window_fwd_kernel(q, k, v, h, bias, mask)
                    grads = window_bwd_kernel(q, k, v, h, bias, mask, dout)
                    again = window_bwd_kernel(q, k, v, h, bias, mask, dout)[3]
                    torch.cuda.synchronize()
                    check(torch.equal(grads[3], again), f"window {label} {name} dbias differs "
                                                        f"between two runs")
                    ref = window_attention_plain(q, k, v, h, bias, mask)
                    ref_grads = window_attention_backward_plain(q, k, v, h, bias, mask, ref,
                                                                dout)
                    errs = {}
                    for what, got, want in zip(("out", "dq", "dk", "dv", "dbias"),
                                               (out, *grads), (ref, *ref_grads)):
                        check(bool(torch.isfinite(got).all()), f"window {label} {what} finite")
                        err = (got.float() - want.float()).abs().max().item()
                        big = want.float().abs().max().item()
                        # float32: the same math in another order (dbias sums
                        # B·nW windows, so relative to its size); bf16: P and dS
                        # rounded to bf16 before their products, outputs rounded
                        if dtype == torch.float32:
                            tol = {"out": 1e-5, "dbias": 1e-5 * max(1.0, big)}.get(what, 1e-4)
                        else:
                            tol = 2e-2 * big
                        check(err <= tol, f"window {label} {name} shift={shifted} {what} "
                                          f"err {err} > {tol}")
                        errs[what] = err
                    if dtype == torch.bfloat16:
                        records["fwd"]["max_abs_err"] = max(records["fwd"]["max_abs_err"],
                                                            errs["out"])
                        records["bwd"]["max_abs_err"] = max(
                            records["bwd"]["max_abs_err"],
                            *(errs[w] for w in ("dq", "dk", "dv", "dbias")))
                    times = ""
                    if dtype == torch.bfloat16:
                        t = {"fwd": time_ms(lambda: window_fwd_kernel(q, k, v, h, bias, mask)),
                             "fwd_plain": time_ms(lambda: window_attention_plain(
                                 q, k, v, h, bias, mask)),
                             "bwd": time_ms(lambda: window_bwd_kernel(q, k, v, h, bias, mask,
                                                                      dout)),
                             "bwd_plain": time_ms(lambda: window_attention_backward_plain(
                                 q, k, v, h, bias, mask, ref, dout))}
                        lib_fwd, lib_bwd = window_sdpa(q, k, v, dout, h, bias, mask)
                        t["lib_fwd"] = time_ms(lib_fwd)
                        t["lib_bwd"] = time_ms(lib_bwd)
                        bounds = window_bounds(q, h, mask)
                        n_blocks = n_shift if shifted else n_plain
                        for p in ("fwd", "bwd"):
                            records[p]["ms"] += n_blocks * t[p]
                            records[p]["plain_ms"] += n_blocks * t[f"{p}_plain"]
                            records[p]["bound_ms"] += n_blocks * bounds[p][0]
                            records[p]["bound_by"] = bounds[p][1]
                            records[p]["library_ms"] += n_blocks * t[f"lib_{p}"]
                        times = "".join(f" {k_}_ms={v_:.4f}" for k_, v_ in t.items()) + "".join(
                            f" {p}_bound_ms={bounds[p][0]:.4f} ({bounds[p][1]})"
                            for p in ("fwd", "bwd")) + "".join(
                            f" {p}/bound={t[p] / bounds[p][0]:.3f}"
                            f" {p}/library={t[p] / t[f'lib_{p}']:.3f}" for p in ("fwd", "bwd"))
                        del lib_fwd, lib_bwd
                    print(f"window kernel: {label} {name} BnW={bnw} S={s} H={h} D={WIN_D} "
                          f"shift={shifted} " + " ".join(f"{w}_err={x:.3e}"
                                                         for w, x in errs.items())
                          + times + f" | {card}", flush=True)
    return records


def phase_mha_long_kernel(card: str) -> dict:
    """The MHA kernels at S = 1024 and 4096; returns {"fwd", "dq", "dkdv"}
    records for one ViT-B 512² step's 12 launches. The wrapper's backward runs
    a pre-pass (the statistics scaled and delta), a dQ kernel and a dK/dV
    kernel: its event-timed total is split between them by their device times
    in ``torch.profiler``, the pre-pass counting in the dQ row. The whole
    backward's bound, plain and library times are split between the two rows
    by the gradients each writes (``BWD_ROW_SHARE``), so that the rows add up
    to the whole backward and nothing is counted twice; the printed line
    carries the whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel

    g = torch.Generator(device="cuda").manual_seed(4)
    records = _records("fwd", "dq", "dkdv")
    with no_tf32():
        for label, b, s, h, d in MHA_LONG_CASES:
            e = h * d
            for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                for masked in (False, True):
                    q, k, v, mask, dout, out, stats, ref, errs = _mha_case(
                        g, f"{label} {name} mask={masked}", b, s, h, d, dtype, masked)
                    if dtype == torch.bfloat16:
                        records["fwd"]["max_abs_err"] = max(records["fwd"]["max_abs_err"],
                                                            errs["out"])
                        for p in ("dq", "dkdv"):
                            records[p]["max_abs_err"] = max(
                                records[p]["max_abs_err"],
                                *(errs[w] for w in (("dq",) if p == "dq" else ("dk", "dv"))))
                    times = ""
                    if label == MHA_LONG_CASES[0][0] and dtype == torch.bfloat16 and not masked:
                        t = _mha_times(b, s, h, d, q, k, v, dout, out, stats, ref)
                        with profile(activities=[ProfilerActivity.CUDA]) as prof:
                            for _ in range(5):
                                mha_bwd_kernel(q, k, v, None, out, dout, stats, h)
                            torch.cuda.synchronize()
                        dev = {"prep": 0.0, "dq": 0.0, "dkdv": 0.0}
                        for ev in prof.key_averages():
                            for p in dev:
                                if f"mha_bwd_{p}_" in ev.key:
                                    dev[p] += ev.self_device_time_total
                        check(all(v_ > 0 for v_ in dev.values()),
                              f"profiler saw the backward kernels: {dev}")
                        share = {p: dev[p] / sum(dev.values()) for p in dev}
                        bounds = mha_bounds(b, s, h, d, q.element_size(), BF16_TC_FLOP_S)
                        kernel_ms = {"fwd": t["fwd"],
                                     "dq": (share["prep"] + share["dq"]) * t["bwd"],
                                     "dkdv": share["dkdv"] * t["bwd"]}
                        for p in ("fwd", "dq", "dkdv"):
                            src = "fwd" if p == "fwd" else "bwd"
                            scale = VIT_BLOCKS * BWD_ROW_SHARE.get(p, 1.0)
                            records[p]["ms"] = VIT_BLOCKS * kernel_ms[p]
                            records[p]["plain_ms"] = scale * t[f"{src}_plain"]
                            records[p]["bound_ms"] = scale * bounds[src][0]
                            records[p]["bound_by"] = bounds[src][1]
                            _mha_library(records[p], t, src, scale)
                        times = (" " + _mha_times_line(t, bounds, 4 * b * s * s * e)
                                 + " | bwd split: " + " ".join(
                                     f"{p}_ms={share[p] * t['bwd']:.4f} ({100 * share[p]:.1f}%)"
                                     for p in share))
                    print(f"mha long kernel: {label} {name} B={b} S={s} H={h} D={d} "
                          f"mask={masked} " + " ".join(f"{w}_err={x:.3e}"
                                                       for w, x in errs.items())
                          + times + f" | {card}", flush=True)
                    del out, stats, ref
    return records


def _logits(out):
    """A classifier's logits, or a detector's scores and box offsets side by side."""
    import torch

    if isinstance(out, dict):
        return torch.cat([out["scores"], out["boxes"]], dim=-1)
    return out


def cpu_reference(label: str, model, x, shape: tuple) -> None:
    """The trained model's float32 eval logits on the card (TF32 off) against a
    copy of it on the CPU, on the same small batch: finite, of ``shape``, and
    within 1e-3 of max(1, the largest logit) (cuDNN's and the CPU's convs sum
    in other orders). A detector's scores and box offsets count as its logits."""
    import copy

    import torch

    model.eval()
    on_cpu = copy.deepcopy(model).cpu()
    with no_tf32(), torch.no_grad():
        got = _logits(model(x)).cpu()
        ref = _logits(on_cpu(x.cpu()))
    diff, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    check(tuple(got.shape) == shape and bool(torch.isfinite(got).all()),
          f"{label}: logits shape {tuple(got.shape)} or finiteness")
    check(diff <= 1e-3 * max(1.0, scale), f"{label}: card vs CPU logits differ by {diff}")
    print(f"reference: {label} card vs CPU float32 eval logits max diff {diff:.3e} "
          f"(max |logit| {scale:.3e}, {x.shape[0]} images)", flush=True)


def phase_train(card: str, label: str, args, kernels: dict, per_step: dict,
                steps: tuple = (WARMUP_STEPS, TIMED_STEPS)):
    """Train steps of the model of ``args`` (``steps``: warm-up and timed
    steps); ``kernels`` are the wrappers of the path, whose counts are set to 0
    just before the steps and read just after. A path without a kernel holds
    its float32 eval logits on the card against the same model's on the CPU
    instead of against its plain path. Returns the counts and what the A/B
    phase needs."""
    import torch

    from cvnets_tpu_torch.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim import build_optimizer
    from cvnets_tpu_torch.optim.scheduler import build_scheduler
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.utils.checkpoint_utils import load_finetune

    opts = get_training_arguments(args=args)
    n_warmup, n_timed = steps
    device = torch.device("cuda:0")
    category = getattr(opts, "dataset.category")
    batch = getattr(opts, "dataset.train_batch_size0")
    hw = (getattr(opts, "sampler.bs.crop_size_height"),
          getattr(opts, "sampler.bs.crop_size_width"))
    model = get_model(opts)  # on the card
    state = create_train_state(
        model, build_optimizer(opts, model, model.get_lr_multipliers(opts)),
        ema_enabled=getattr(opts, "ema.enable"))
    load_finetune(opts, state)  # --common.finetune, where the args give one
    criteria = build_loss_fn(opts)
    train_step = make_train_step(model, criteria, opts,
                                 build_metrics(opts, ["loss", "grad_norm"]))
    scheduler = build_scheduler(opts)
    n_classes = getattr(opts, f"model.{category}.n_classes")
    g = torch.Generator(device=device).manual_seed(getattr(opts, "common.seed"))

    def targets():
        if category == "classification":
            return torch.randint(0, n_classes, (batch,), generator=g, device=device)
        if category == "detection":
            return detection_targets(opts, batch, hw, device)
        # per-pixel labels with 5% ignored, as bench_tasks.py:128-130 makes them
        t = torch.randint(0, n_classes, (batch, *hw), generator=g, device=device)
        t[torch.rand(t.shape, generator=g, device=device) < 0.05] = 255
        return t

    batches = [{"samples": torch.randint(0, 256, (batch, 3, *hw), generator=g,
                                         device=device, dtype=torch.uint8),
                "targets": targets()}
               for _ in range(n_warmup + n_timed)]
    params0 = [p.detach().clone() for p in model.parameters()]
    ema0 = ([t.detach().clone() for t in state.ema.model.state_dict().values()]
            if state.ema is not None else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for kernel in kernels.values():
        kernel.launches = 0
    losses, step_s = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, metrics = train_step(state, b, scheduler.retrieve_lr(0, state.step))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: s.item() for m in metrics.values() for k, (s, _) in m.items()})
    launches = {name: kernel.launches for name, kernel in kernels.items()}

    n_steps = len(batches)
    for name, count in launches.items():
        check(count == per_step[name] * n_steps,
              f"{label}: {count} {name} launches in {n_steps} steps, "
              f"want {per_step[name]} a step")
    # the loss and, for segmentation, its seg and aux parts, and the grad norm
    check(all(math.isfinite(v) for m in losses for v in m.values()),
          f"{label}: losses not finite: {losses}")
    parts = {k: [round(m[k], 4) for m in losses] for k in losses[0]}
    check(any(not torch.equal(a, b) for a, b in zip(params0, model.parameters())),
          f"{label}: params did not change")
    check(ema0 is None or any(not torch.equal(a, b) for a, b in zip(
        ema0, state.ema.model.state_dict().values())), f"{label}: EMA did not change")
    del params0, ema0
    timed = step_s[n_warmup:]
    img_s = batch * len(timed) / sum(timed)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"train: {label} batch={batch} {hw[0]}x{hw[1]} bf16 steps={n_steps} "
          f"losses={parts} step_s={[round(x, 4) for x in step_s]} "
          f"img_s={img_s:.1f} peak_mem_gib={peak_gib:.2f} launches={launches} "
          f"| {card}", flush=True)

    x = batches[0]["samples"][:8 if category == "classification" else 2].float() / 255.0
    if not kernels:
        if category == "detection":  # scores and box offsets of every anchor
            n_anchors = model.anchors(*hw, device).shape[0]
            cpu_reference(label, model, x[:2], (2, n_anchors, n_classes + 4))
        else:
            cpu_reference(label, model, x[:4], (4, n_classes))
        return launches, (state, train_step, scheduler, batches, criteria)
    # reference: the trained model's logits through the kernels and through the
    # plain attention path (float32, eval mode, TF32 off), on a small batch
    model.eval()
    with no_tf32(), torch.no_grad():
        with_kernel = model(x)
        set_use_kernel(model, False)
        plain = model(x)
    set_use_kernel(model, True)
    diff = (with_kernel - plain).abs().max().item()
    scale = plain.abs().max().item()
    want = (x.shape[0], n_classes) + (() if category == "classification" else hw)
    check(with_kernel.shape == want and bool(torch.isfinite(with_kernel).all()),
          f"{label}: logits shape or finiteness")
    check(diff <= 1e-4 * max(1.0, scale), f"{label}: kernel vs plain logits differ by {diff}")
    print(f"reference: {label} kernel-path vs plain-path logits max diff {diff:.3e} "
          f"(max |logit| {scale:.3e})", flush=True)
    if category == "segmentation":
        # the loss through the seg-CE kernels and through the plain unfused CE, on
        # the same train-mode (head-resolution) outputs of the whole batch
        model.train()
        with no_tf32(), torch.no_grad():
            out = model(batches[0]["samples"].float() / 255.0)
            both = []
            for on in (True, False):
                set_use_kernel(model, on, criteria)
                both.append(criteria(None, out, batches[0]["targets"]))
        set_use_kernel(model, True, criteria)
        for key in both[0]:
            got, ref = both[0][key].item(), both[1][key].item()
            check(abs(got - ref) <= 1e-5 * abs(ref), f"{label}: {key} kernel {got} vs "
                                                     f"plain {ref}")
        print(f"reference: {label} kernel-path vs plain-path loss " + " ".join(
            f"{k}={both[0][k].item():.7f}/{both[1][k].item():.7f}" for k in both[0]),
            flush=True)
    return launches, (state, train_step, scheduler, batches, criteria)


def phase_ab(card: str, label: str, run) -> dict:
    """Whole train steps through the kernels against the plain path (attention
    and, for segmentation, the unfused CE), in alternating blocks (plain,
    kernel, kernel, plain) in this one run. Beside each median step time, the
    median time until ``train_step`` returns: where it nears the step time,
    the host's launches, not the card, set the pace. Returns the kernel path's
    median img/s and peak memory."""
    import torch

    from cvnets_tpu_torch.engine.train_state import batch_size

    state, train_step, scheduler, batches, criteria = run
    model = state.model
    times = {"plain": [], "kernel": []}
    host = {"plain": [], "kernel": []}  # until train_step returns: the host's enqueue
    peak = {"plain": 0, "kernel": 0}
    set_use_kernel(model, False, criteria)
    train_step(state, batches[0], scheduler.retrieve_lr(0, state.step))  # plain warm-up
    for mode in AB_BLOCKS:
        set_use_kernel(model, mode == "kernel", criteria)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(AB_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(state, batches[i % len(batches)], scheduler.retrieve_lr(0, state.step))
            host[mode].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            times[mode].append(time.perf_counter() - t0)
        peak[mode] = max(peak[mode], torch.cuda.max_memory_allocated())
    set_use_kernel(model, True, criteria)
    batch = batch_size(batches[0]["samples"])
    parts = []
    for mode, ts in times.items():
        ms = 1e3 * statistics.median(ts)
        q1, _, q3 = statistics.quantiles(ts, n=4)
        parts.append(f"{mode}_ms={ms:.3f} (q1 {1e3 * q1:.3f}, q3 {1e3 * q3:.3f}; "
                     f"{batch / ms * 1e3:.1f} img/s; peak {peak[mode] / 2**30:.2f} GiB; "
                     f"host enqueue {1e3 * statistics.median(host[mode]):.3f} ms)")
    ratio = statistics.median(times["kernel"]) / statistics.median(times["plain"])
    print(f"a/b: {label} {len(AB_BLOCKS)} blocks of {AB_STEPS} steps, "
          f"medians: {'; '.join(parts)}; kernel/plain={ratio:.4f} | {card}", flush=True)
    return {"img_s": batch / statistics.median(times["kernel"]),
            "peak_gib": peak["kernel"] / 2**30}


def phase_steady(card: str, label: str, run, blocks: int = 3, steps: int = 8) -> dict:
    """Train steps of a path without a kernel (no a/b to make): ``blocks`` blocks
    of ``steps`` synchronized steps; the median step time, its img/s, the
    host's enqueue time and the peak memory. Returns img/s and peak GiB as
    ``phase_ab`` does."""
    import torch

    from cvnets_tpu_torch.engine.train_state import batch_size

    state, train_step, scheduler, batches, _ = run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, host = [], []
    for i in range(blocks * steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batches[i % len(batches)], scheduler.retrieve_lr(0, state.step))
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    batch = batch_size(batches[0]["samples"])
    ms = 1e3 * statistics.median(times)
    q1, _, q3 = statistics.quantiles(times, n=4)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"steady: {label} {blocks * steps} steps, median step_ms={ms:.3f} (q1 "
          f"{1e3 * q1:.3f}, q3 {1e3 * q3:.3f}) img_s={batch / ms * 1e3:.1f} "
          f"host_enqueue_ms={1e3 * statistics.median(host):.3f} peak_mem_gib={peak:.2f} "
          f"| {card}", flush=True)
    return {"img_s": batch / ms * 1e3, "peak_gib": peak}


# device kernels by family, first match wins: cuDNN's convolution kernels name
# their pass (fprop, dgrad, wgrad), ATen's depthwise ones theirs (backward is
# the input grad, grad_weight the weight grad), and only then does a generic
# conv key count as the forward; cuBLAS's GEMMs are nvjet_* and cutlass_*
KERNEL_FAMILIES = (
    ("conv wgrad", ("wgrad", "conv_depthwise2d_grad_weight")),
    ("conv dgrad", ("dgrad", "conv_depthwise2d_backward")),
    ("conv fprop", ("fprop", "conv", "implicit_gemm", "xmma")),
    ("layout transform", ("nchwToNhwc", "nhwcToNchw", "transpose", "Transpose")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_", "welford", "Welford")),
    ("gemm", ("gemm", "nvjet", "cutlass", "cublas")),
    ("optimizer", ("multi_tensor", "foreach", "Foreach")),
    ("reduction", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "Elementwise")),
    ("memcpy / memset", ("Memcpy", "Memset", "memcpy", "memset")),
)


def kernel_family(name: str) -> str:
    for family, keys in KERNEL_FAMILIES:
        if any(k in name for k in keys):
            return family
    return "other"


def route_device_us(events, name: str) -> float:
    """Device µs of the kernels launched inside every ``record_function(name)``
    range of a profile's ``events`` and of those launched by the backward
    nodes of the range's ops, which share an op's autograd sequence number
    and forward thread (each backward node counted once, with the kernels of
    its ``evaluate_function`` wrapper)."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    seqs, total = set(), 0.0
    for e in events:
        if e.name == name and e.device_type == cpu:
            total += e.device_time_total
            stack = list(e.cpu_children)
            while stack:
                c = stack.pop()
                if c.sequence_nr >= 0:
                    seqs.add((c.sequence_nr, c.thread))
                stack.extend(c.cpu_children)
    backward = [e for e in events if e.device_type == cpu
                and (e.scope == 1 or e.name.startswith("autograd::engine::evaluate_function"))
                and (e.sequence_nr, e.fwd_thread) in seqs]
    picked = set(map(id, backward))

    def outermost(e) -> bool:
        p = e.cpu_parent
        while p is not None:
            if id(p) in picked:
                return False
            p = p.cpu_parent
        return True

    check(bool(seqs) and bool(backward), f"profile: no op or backward node in the {name} ranges")
    return total + sum(e.device_time_total for e in backward if outermost(e))


def range_device_us(events, name: str) -> float:
    """Device µs of the kernels launched inside every ``record_function(name)``
    range of a profile's ``events`` (a range without backward nodes: the
    optimizer's)."""
    import torch

    return sum(e.device_time_total for e in events
               if e.name == name and e.device_type == torch.autograd.DeviceType.CPU)


def phase_profile(card: str, label: str, run, path: str, route: str = None,
                  split: tuple = (), ranges: tuple = (), rest: str = "other",
                  named: tuple = ()) -> float:
    """torch.profiler over 3 steps: device time by kernel into ``path``;
    returns the device ms a step. With ``route``, also prints the device ms
    a step of that ``record_function`` range, forward and backward
    (``route_device_us``), and its share of the step's. ``split`` (ranges
    with backward nodes, by ``route_device_us``) and ``ranges`` (without, by
    ``range_device_us``) print the step's device time split between them,
    the rest as ``rest`` ("other" unless the caller names it). ``named``
    (parts of kernel names) prints the device ms a step of the kernels whose
    names hold one of them, and their share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state, train_step, scheduler, batches, _ = run
    n = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            train_step(state, batches[i], scheduler.retrieve_lr(0, state.step))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    # kernels, memcpys and memsets on the card; a user annotation's range on the
    # device timeline (Optimizer.step) would count its kernels twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    device_s = sum(e.self_device_time_total for e in events) / 1e6 / n
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{label}: {n} profiled steps | {card}\n")
        f.write(f"device_ms_per_step={device_s * 1e3:.3f} wall_ms_per_step={wall * 1e3:.3f} "
                f"busy_share={device_s / wall:.3f} kernels_per_step={sum(e.count for e in events) / n:.0f}\n")
        for e in events:
            f.write(f"{e.self_device_time_total / 1e3 / n:10.3f} ms/step {e.count // n:6d}x  "
                    f"{e.key[:160]}\n")
    print(f"profile: {label} device_ms_per_step={device_s * 1e3:.3f} wall_ms_per_step="
          f"{wall * 1e3:.3f} busy_share={device_s / wall:.3f} (table in {path}) | {card}",
          flush=True)
    for e in events[:12]:
        print(f"profile:   {e.self_device_time_total / 1e3 / n:9.3f} ms/step "
              f"{e.count // n:5d}x {e.key[:110]}", flush=True)
    families = {}
    for e in events:
        ms, count = families.get(kernel_family(e.key), (0.0, 0))
        families[kernel_family(e.key)] = (ms + e.self_device_time_total / 1e3 / n,
                                          count + e.count // n)
    print(f"profile: {label} device ms a step by kernel family: " + "; ".join(
        f"{f} {ms:.3f} ({c}x)" for f, (ms, c) in sorted(families.items(),
                                                       key=lambda kv: -kv[1][0])), flush=True)
    if named:
        picked = [e for e in events if any(part in e.key for part in named)]
        named_ms = sum(e.self_device_time_total for e in picked) / 1e3 / n
        print(f"profile: {label} kernels named *{'*/*'.join(named)}*: {named_ms:.3f} device ms a "
              f"step in {sum(e.count for e in picked) // n} launches, share "
              f"{named_ms / (device_s * 1e3):.3f} | {card}", flush=True)
    if route:
        route_ms = route_device_us(prof.events(), route) / 1e3 / n
        print(f"profile: {label} {route} forward + backward device {route_ms:.3f} ms a step "
              f"of the step's {device_s * 1e3:.3f}: share {route_ms / (device_s * 1e3):.3f} "
              f"| {card}", flush=True)
    if split or ranges:
        parts = {name: route_device_us(prof.events(), name) / 1e3 / n for name in split}
        parts.update({name: range_device_us(prof.events(), name) / 1e3 / n for name in ranges})
        parts[rest] = device_s * 1e3 - sum(parts.values())
        print(f"profile: {label} device ms a step by part: " + "; ".join(
            f"{name} {ms:.3f} (share {ms / (device_s * 1e3):.3f})" for name, ms in parts.items())
            + f" | {card}", flush=True)
    return device_s * 1e3


# the Trainer on the flagship: the yaml's stats, checkpoint metric and val
# batch, auto-resume, and the checkpoint roles at a short run's scale
TRAINER_ARGS = FLAGSHIP_ARGS + IMAGENET_RUN_ARGS + [
    "--common.log-freq", "2",
    "--common.save-interval-freq", "3",
    "--common.k-best-checkpoints", "2",
    "--common.save-all-checkpoints",
]
TRAINER_TRAIN_BATCHES, TRAINER_VAL_BATCHES, TRAINER_EPOCHS = 4, 2, 3
# a sync debug warning whose stack passes through one of these fails the phase
ENGINE_FILES = tuple(os.path.join("cvnets_tpu_torch", part) + suffix for part, suffix in
                     (("engine", os.sep), ("metrics", os.sep),
                      (os.path.join("utils", "checkpoint_utils.py"), "")))


# the rest of config/classification/imagenet/mobilevit_v2.yaml, as flags: its loader,
# sampler, host transforms and augmentation (dataset.name and its roots are the
# yaml's ImageNet on disk; main_train's phase names its own dataset instead)
FLAGSHIP_DATA_ARGS = [
    "--dataset.category", "classification",
    "--dataset.eval-batch-size0", "100",
    "--dataset.workers", "8",
    "--dataset.prefetch-factor", "2",
    "--sampler.name", "batch_sampler",
    "--image-augmentation.random-resized-crop.enable",
    "--image-augmentation.random-resized-crop.interpolation", "bicubic",
    "--image-augmentation.random-horizontal-flip.enable",
    "--image-augmentation.rand-augment.enable",
    "--image-augmentation.random-erase.enable",
    "--image-augmentation.random-erase.p", "0.25",
    "--image-augmentation.mixup.enable",
    "--image-augmentation.mixup.alpha", "0.2",
    "--image-augmentation.cutmix.enable",
    "--image-augmentation.cutmix.alpha", "1.0",
    "--image-augmentation.resize.enable",
    "--image-augmentation.resize.size", "288",
    "--image-augmentation.resize.interpolation", "bicubic",
    "--image-augmentation.center-crop.enable",
    "--image-augmentation.center-crop.size", "256",
]
# main_train on the flagship yaml's flags, on the script's own dataset (the card
# machine has no image files): 4 train batches of 128 and 2 val
# batches of 100 an epoch, 2 epochs
SMOKE_DATASET = "smoke_imagenet"
MAIN_TRAIN_ARGS = FLAGSHIP_ARGS + IMAGENET_RUN_ARGS + FLAGSHIP_DATA_ARGS + [
    "--dataset.name", SMOKE_DATASET,
    "--scheduler.max-epochs", "2",
]
SMOKE_TRAIN_SAMPLES, SMOKE_VAL_SAMPLES = 4 * 128, 2 * 100
# a sync debug warning whose stack passes through one of these fails phase 6c
MAIN_TRAIN_FILES = ENGINE_FILES + tuple(
    os.path.join("cvnets_tpu_torch", part) + os.sep for part in ("data", "ops", "loss"))


# the rest of config/classification/imagenet/resnet.yaml, as flags: its loader,
# sampler and host transforms; main_train's ResNet-50 phase runs them on the
# script's own dataset, 2 epochs of 4 batches of 128
RESNET_DATA_ARGS = [
    "--dataset.category", "classification",
    "--dataset.workers", "8",
    "--sampler.name", "batch_sampler",
    "--image-augmentation.random-resized-crop.enable",
    "--image-augmentation.random-resized-crop.interpolation", "bilinear",
    "--image-augmentation.random-horizontal-flip.enable",
    "--image-augmentation.resize.enable",
    "--image-augmentation.resize.size", "232",
    "--image-augmentation.center-crop.enable",
    "--image-augmentation.center-crop.size", "224",
]
RESNET_MAIN_TRAIN_ARGS = RESNET_ARGS + IMAGENET_RUN_ARGS + RESNET_DATA_ARGS + [
    "--dataset.name", SMOKE_DATASET,
    "--scheduler.max-epochs", "2",
]

# the rest of config/segmentation/ade20k/deeplabv3_mobilevitv2.yaml, as flags: its
# loader, sampler, host transforms and stats (dataset.name and its roots are the
# yaml's ADE20k on disk; the segmentation phases name the script's own dataset),
# with the batch of DEEPLAB_ARGS for validation and offline evaluation too
SEG_DATA_ARGS = [
    "--dataset.val-batch-size0", "8",
    "--dataset.eval-batch-size0", "8",
    "--dataset.workers", "8",
    "--sampler.name", "batch_sampler",
    "--image-augmentation.random-crop.enable",
    "--image-augmentation.random-crop.mask-fill", "255",
    "--image-augmentation.random-horizontal-flip.enable",
    "--image-augmentation.random-short-size-resize.enable",
    "--image-augmentation.random-short-size-resize.short-side-min", "256",
    "--image-augmentation.random-short-size-resize.short-side-max", "768",
    "--image-augmentation.random-short-size-resize.max-img-dim", "1024",
    "--image-augmentation.random-short-size-resize.interpolation", "bicubic",
    "--image-augmentation.resize.enable",
    "--image-augmentation.resize.size", "512", "512",
    "--model.normalization.name", "sync_batch_norm",  # plain BN on one card
    "--stats.val", "loss", "iou",
    "--stats.train", "loss",
    "--stats.checkpoint-metric", "iou",
    "--stats.checkpoint-metric-max",
    "--common.run-label", "train",
    "--common.log-freq", "200",
    "--common.auto-resume",
]
# main_train on the DeepLabv3 yaml's flags, on the script's own dataset: 3 train
# batches of 8 and 2 val batches of 8 an epoch, 2 epochs
SEG_DATASET = "smoke_ade20k"
SEG_MAIN_TRAIN_ARGS = DEEPLAB_ARGS + SEG_DATA_ARGS + [
    "--dataset.name", SEG_DATASET,
    "--scheduler.max-epochs", "2",
]
SEG_TRAIN_SAMPLES, SEG_VAL_SAMPLES, SEG_BATCH = 3 * 8, 2 * 8, 8

PSPNET_ARGS = [  # config/segmentation/ade20k/pspnet_mobilevitv2.yaml, as flags
    "--dataset.category", "segmentation",
    "--model.segmentation.name", "encoder_decoder",
    "--model.segmentation.n-classes", "150",
    "--model.segmentation.lr-multiplier", "10",
    "--model.segmentation.seg-head", "pspnet",
    "--model.segmentation.output-stride", "8",
    "--model.segmentation.use-aux-head",
    "--model.segmentation.pspnet.psp-dropout", "0.1",
    "--model.segmentation.pspnet.psp-out-channels", "512",
    "--model.segmentation.pspnet.psp-pool-sizes", "1", "2", "3", "6",
    "--model.classification.name", "mobilevit_v2",
    "--model.classification.mitv2.width-multiplier", "1.0",
    "--model.classification.mitv2.attn-norm-layer", "layer_norm_2d",
    "--model.classification.activation.name", "swish",
    "--model.normalization.momentum", "0.1",
    "--model.activation.name", "swish",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "normal",
    "--loss.category", "segmentation",
    "--loss.segmentation.name", "cross_entropy",
    "--loss.segmentation.cross-entropy.aux-weight", "0.4",
    "--loss.segmentation.cross-entropy.ignore-index", "255",
    "--optim.name", "sgd",
    "--optim.weight-decay", "1e-4",
    "--optim.no-decay-bn-filter-bias",
    "--optim.sgd.momentum", "0.9",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "120",
    "--scheduler.warmup-iterations", "500",
    "--scheduler.warmup-init-lr", "0.0009",
    "--scheduler.cosine.max-lr", "0.02",
    "--scheduler.cosine.min-lr", "0.0002",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--common.mixed-precision",
    "--common.grad-clip", "10.0",
    "--dataset.train-batch-size0", "8",
    "--sampler.bs.crop-size-width", "512",
    "--sampler.bs.crop-size-height", "512",
    "--common.seed", "0",
] + SEG_DATA_ARGS


def pinned_batches(g, n: int, batch: int, hw: tuple, n_classes: int) -> list:
    """Seeded uint8 batches in pinned host memory, as a loader with
    ``pin_memory`` hands them over."""
    import torch

    return [{"samples": torch.randint(0, 256, (batch, 3, *hw), generator=g,
                                      dtype=torch.uint8).pin_memory(),
             "targets": torch.randint(0, n_classes, (batch,), generator=g).pin_memory()}
            for _ in range(n)]


class SyncWatch:
    """Collects CUDA sync debug warnings with the Python stack that raised
    them; ``on``/``off`` switch ``torch.cuda.set_sync_debug_mode``."""

    def __init__(self) -> None:
        self.caught = []

    def __enter__(self):
        import traceback
        import warnings

        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            # "called a synchronizing CUDA operation"; not the notice, on the
            # first switch, that the debug mode is a prototype
            text = str(message)
            if "synchroniz" in text and "prototype" not in text:
                self.caught.append((str(message).splitlines()[0],
                                    traceback.extract_stack()[:-1]))
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        return self

    def __exit__(self, *exc):
        self.off()
        self._ctx.__exit__(*exc)

    def through(self, files) -> list:
        """The frames of ``files`` in each caught warning's stack, for the
        warnings whose stack passes through one of them."""
        bad = [[f"{f.filename}:{f.lineno}" for f in stack
                if any(part in f.filename for part in files)] for _, stack in self.caught]
        return [frames for frames in bad if frames]

    @staticmethod
    def on() -> None:
        import torch

        torch.cuda.set_sync_debug_mode("warn")

    @staticmethod
    def off() -> None:
        import torch

        torch.cuda.set_sync_debug_mode("default")


class _CountedLoader:
    """A loader that counts the batches it yields (its other attributes are
    the loader's)."""

    def __init__(self, loader) -> None:
        self.loader, self.yielded = loader, 0

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            self.yielded += 1
            yield batch


def _watch_trainer(trainer, kernels: dict, watch: SyncWatch, per_step: int, log: dict):
    """Wrap the trainer's epochs, read-backs and interval saves: the train steps
    run under the sync debug mode, the read-backs and saves outside it; each
    epoch's launches are checked against the batches its train loader yielded
    (one train step each, ``per_step`` forward and backward launches a train
    step, ``per_step`` forward an eval forward, none backward; ``kernels``
    empty and ``per_step`` 0 for a path without one) and its time,
    statistics and interval-save time kept in ``log``."""
    import torch

    trainer.train_loader = loader = _CountedLoader(trainer.train_loader)
    train_epoch, val_epoch = trainer.train_epoch, trainer.val_epoch
    read_back, save_interval = trainer.read_back, trainer.ckpt_manager.save_interval

    def counts():  # a path without a kernel counts none
        return ((kernels["fwd"].launches, kernels["bwd"].launches) if kernels else (0, 0))

    def train(epoch):
        before, saves = counts(), log["save_s"]
        steps, yielded = trainer.train_iterations, loader.yielded
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        watch.on()
        stats = train_epoch(epoch)
        watch.off()
        torch.cuda.synchronize()
        log["train"].append((epoch, time.perf_counter() - t0, log["save_s"] - saves, stats))
        fwd, bwd = (a - b for a, b in zip(counts(), before))
        n = loader.yielded - yielded
        check(trainer.train_iterations - steps == n > 0,
              f"trainer epoch {epoch}: {trainer.train_iterations - steps} train steps of "
              f"{n} batches the loader yielded")
        check((fwd, bwd) == (per_step * n, per_step * n),
              f"trainer epoch {epoch}: {fwd} forward and {bwd} backward separable launches "
              f"in {n} steps, want {per_step} and {per_step} a step")
        return stats

    def val(epoch, use_ema=False):
        before = counts()
        stats = val_epoch(epoch, use_ema=use_ema)
        fwd, bwd = (a - b for a, b in zip(counts(), before))
        n = len(trainer.val_loader)
        check((fwd, bwd) == (per_step * n, 0),
              f"trainer epoch {epoch} val (ema={use_ema}): {fwd} forward and {bwd} backward "
              f"separable launches in {n} eval forwards, want {per_step} and 0 each")
        log["ema" if use_ema else "val"].append(stats)
        return stats

    def quiet(fn, key=None):
        def wrapped(*args):
            watch.off()
            if key:  # the save's own time, not the queued steps' it waits for
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            if key:
                log[key] += time.perf_counter() - t0
            watch.on()
            return out
        return wrapped

    trainer.train_epoch, trainer.val_epoch = train, val
    trainer.read_back = quiet(read_back)
    trainer.ckpt_manager.save_interval = quiet(save_interval, "save_s")


def _state_equal(a, b) -> list:
    """The names of the tensors that differ between two Trainers' model, EMA
    and optimizer states."""
    import torch

    differ = []
    for part, x, y in (("model", a.model.state_dict(), b.model.state_dict()),
                       ("ema", a.state.ema.model.state_dict(), b.state.ema.model.state_dict())):
        differ += [f"{part}.{k}" for k in x if not torch.equal(x[k], y[k])]
    oa, ob = a.state.optimizer.state_dict(), b.state.optimizer.state_dict()
    differ += [f"optimizer.{i}.{k}" for i, st in oa["state"].items() for k in st
               if not torch.equal(st[k].cpu(), ob["state"][i][k].cpu())]
    return differ


def phase_trainer(card: str, bare: dict) -> None:
    """The port's Trainer on the flagship: 3 epochs of 4 seeded batches of 128 ×
    256², each followed by a validation epoch and an EMA one on 2 batches of 100;
    a second Trainer on the same directory resumes and runs a 4th; the
    Evaluator on checkpoint_ema_last.pt; then one step at --common.accum-freq 2.
    ``bare`` is phase 6's kernel-path a/b (img/s, peak GiB)."""
    import shutil

    import torch

    from cvnets_tpu_torch.engine import Evaluator, Trainer
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_bwd_kernel,
        separable_attention_kernel,
    )
    from cvnets_tpu_torch.options.opts import get_training_arguments

    results = os.path.join("results", "trainer_smoke")
    shutil.rmtree(results, ignore_errors=True)
    opts = get_training_arguments(args=TRAINER_ARGS + ["--common.results-loc", results])
    batch, val_batch = (getattr(opts, "dataset.train_batch_size0"),
                        getattr(opts, "dataset.val_batch_size0"))
    hw = (getattr(opts, "sampler.bs.crop_size_height"),
          getattr(opts, "sampler.bs.crop_size_width"))
    n_classes = getattr(opts, "model.classification.n_classes")
    g = torch.Generator().manual_seed(getattr(opts, "common.seed"))
    train = pinned_batches(g, TRAINER_TRAIN_BATCHES, batch, hw, n_classes)
    val = pinned_batches(g, TRAINER_VAL_BATCHES, val_batch, hw, n_classes)
    kernels = {"fwd": separable_attention_kernel, "bwd": separable_attention_bwd_kernel}
    per_step = sum(SEP_FLAGSHIP[1].values())
    log = {"train": [], "val": [], "ema": [], "save_s": 0.0}

    def build(label: str, extra=(), train=train, val=val):
        return Trainer(get_training_arguments(args=TRAINER_ARGS + [
            "--common.results-loc", results, "--common.run-label", label, *extra]),
            get_model(opts), build_loss_fn(opts), train, val)

    with SyncWatch() as probe:  # the watch catches a read-back under "warn"
        probe.on()
        torch.ones(1, device="cuda").item()
    check(len(probe.caught) == 1, f"sync watch: {len(probe.caught)} warnings for one .item()")
    with SyncWatch() as watch:
        first = build("run")
        first.max_epochs = TRAINER_EPOCHS
        _watch_trainer(first, kernels, watch, per_step, log)
        for kernel in kernels.values():
            kernel.launches = 0
        first.run()
        resumed = build("run")
        resumed.max_epochs = TRAINER_EPOCHS + 1
        check((resumed.start_epoch, resumed.train_iterations, resumed.state.step)
              == (TRAINER_EPOCHS, first.train_iterations, first.state.step),
              f"trainer resume: epoch {resumed.start_epoch}, iterations "
              f"{resumed.train_iterations}, step {resumed.state.step}")
        check(resumed.ckpt_manager.best_metric == first.ckpt_manager.best_metric,
              f"trainer resume: best {resumed.ckpt_manager.best_metric} vs "
              f"{first.ckpt_manager.best_metric}")
        differ = _state_equal(first, resumed)
        check(not differ, f"trainer resume: {len(differ)} tensors differ: {differ[:5]}")
        first = None
        _watch_trainer(resumed, kernels, watch, per_step, log)
        resumed.run()
    launches = {name: k.launches for name, k in kernels.items()}

    bad = watch.through(ENGINE_FILES)
    where = sorted({f"{f.filename.split('cvnets_tpu_torch')[-1]}:{f.lineno}"
                    for _, stack in watch.caught for f in stack[-3:]})
    print(f"trainer: sync debug warnings in the train steps: {len(watch.caught)} "
          f"(innermost frames: {where[:6]}); through the engine, metrics or "
          f"checkpoints: {len(bad)}", flush=True)
    check(not bad, f"trainer: the engine synchronizes between log points: {bad[:3]}")
    for stage in ("train", "val", "ema"):
        values = [v for entry in log[stage] for v in
                  (entry[3] if stage == "train" else entry).values()]
        check(values and all(math.isfinite(v) for v in values),
              f"trainer: {stage} statistics not finite: {log[stage]}")
    save_dir = resumed.save_dir
    files = set(os.listdir(save_dir))
    n_iter = resumed.train_iterations
    roles = {"config.yaml", "training_checkpoint_last.pt", "checkpoint_last.pt",
             "checkpoint_best.pt", "checkpoint_ema_last.pt", "checkpoint_ema_best.pt",
             "checkpoint_avg.pt",
             *(f"checkpoint_epoch_{e}.pt" for e in range(TRAINER_EPOCHS + 1)),
             *(f"checkpoint_iter_{n}.pt" for n in range(3, n_iter + 1, 3))}
    # the resumed run ranks its own epochs only (the JAX package does not
    # restore the k-best list), so the first run's score files stay beside them
    kept = {os.path.basename(p) for _, p in resumed.ckpt_manager.k_best_scores}
    check(roles <= files and kept and kept <= files,
          f"trainer: checkpoint files missing: {sorted(roles - files)}, {sorted(kept - files)}")

    evaluator = Evaluator(opts, get_model(opts), val,
                          checkpoint=os.path.join(save_dir, "checkpoint_ema_last.pt"))
    before = kernels["fwd"].launches
    got, want = evaluator.eval_fn_image(), log["ema"][-1]
    share = 100.0 / (val_batch * len(val))
    check(kernels["fwd"].launches - before == per_step * len(val),
          f"evaluator: {kernels['fwd'].launches - before} forward launches")
    check(abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
          and all(abs(got[k] - want[k]) <= share for k in ("top1", "top5")),
          f"evaluator on checkpoint_ema_last.pt: {got} vs the last EMA validation {want}")
    resumed = evaluator = None

    timed = [e for e in log["train"] if e[0] in range(1, TRAINER_EPOCHS)]
    n_img = batch * len(train) * len(timed)
    epoch_s, save_s = sum(e[1] for e in timed), sum(e[2] for e in timed)
    print(f"trainer: MobileViTv2-1.0 batch={batch} {hw[0]}x{hw[1]} bf16 epochs="
          f"{TRAINER_EPOCHS}+1 (resumed) launches={launches} "
          f"train={[{k: round(v, 4) for k, v in e[3].items()} for e in log['train']]} "
          f"val={[{k: round(v, 4) for k, v in s.items()} for s in log['val']]} "
          f"ema={[{k: round(v, 4) for k, v in s.items()} for s in log['ema']]} "
          f"evaluator={ {k: round(v, 6) for k, v in got.items()} } "
          f"checkpoints={len(files)} | {card}", flush=True)
    print(f"trainer: img_s={n_img / epoch_s:.1f} over epochs 1-{TRAINER_EPOCHS - 1} "
          f"({len(timed) * len(train)} steps, {len(timed) * 2} read-backs, interval saves "
          f"{save_s:.3f} s), without the saves {n_img / (epoch_s - save_s):.1f}; bare step "
          f"(phase 6 a/b, kernel path) img_s={bare['img_s']:.1f} | {card}", flush=True)

    # one step at --common.accum-freq 2: two micro-batches of 64
    gc.collect()
    torch.cuda.empty_cache()
    accum = build("accum", train=train[:1], val=None,
                  extra=["--common.accum-freq", "2", "--scheduler.max-epochs", "1"])
    for kernel in kernels.values():
        kernel.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    accum.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = (kernels["fwd"].launches, kernels["bwd"].launches)
    check(got == (2 * per_step, 2 * per_step),
          f"accum-freq 2: {got} separable launches in one step, want "
          f"{2 * per_step} forward and {2 * per_step} backward")
    print(f"trainer: accum-freq 2 batch={batch} as 2x{batch // 2} launches={got} "
          f"peak_mem_gib={peak:.2f} (bare step at {batch}: {bare['peak_gib']:.2f}) | {card}",
          flush=True)


def register_smoke_dataset() -> None:
    """Register ``smoke_imagenet``: ImageNet's layout without its files. Sample i
    is a seeded uint8 HWC image of about ImageNet's 500 × 375 (either way round,
    ±20%) made where the JAX and the port's readers decode a file, labels spread
    over the 1,000 classes; 512 training samples and 200 validation ones. The
    real transforms, loader, collate and pinning run on it."""
    import numpy as np

    from cvnets_tpu_torch.data.datasets import DATASET_REGISTRY
    from cvnets_tpu_torch.data.datasets.classification.base_image_classification_dataset \
        import BaseImageClassificationDataset

    if (SMOKE_DATASET, "classification") in DATASET_REGISTRY:
        return

    @DATASET_REGISTRY.register(name=SMOKE_DATASET, type="classification")
    class SmokeImageNet(BaseImageClassificationDataset):
        def _find_samples(self):
            self.classes = [f"n{c:08d}" for c in range(1000)]
            n = SMOKE_TRAIN_SAMPLES if self.is_training else SMOKE_VAL_SAMPLES
            return [(None, (i * 7919) % 1000) for i in range(n)]

        def image_size(self, idx):
            rng = np.random.default_rng([idx, 1])
            h, w = int(rng.integers(300, 451)), int(rng.integers(400, 601))
            return (w, h) if idx % 3 == 0 else (h, w)

        def read_image(self, idx):
            rng = np.random.default_rng([idx, 2])
            return rng.integers(0, 256, (*self.image_size(idx), 3), dtype=np.uint8)


def register_smoke_ade20k() -> None:
    """Register ``smoke_ade20k``: ADE20k's layout without its files. Pair i is a
    seeded uint8 HWC image of about ADE20k's 683 × 512 (either way round, ±20%)
    and a mask of raw labels 0-150 in blobs (a seeded 6 × 8 grid of labels
    scaled up by nearest neighbour, raw 0 read as the ignore label), made where
    the readers decode the files; 24 training pairs and 16 validation ones. The
    real transforms (short-side resize, flip, crop with its fit), loader,
    collate and pinning run on it."""
    import numpy as np

    from cvnets_tpu_torch.data.datasets import DATASET_REGISTRY
    from cvnets_tpu_torch.data.datasets.segmentation.ade20k import ADE20KDataset

    if (SEG_DATASET, "segmentation") in DATASET_REGISTRY:
        return

    @DATASET_REGISTRY.register(name=SEG_DATASET, type="segmentation")
    class SmokeADE20k(ADE20KDataset):
        def __init__(self, opts, *args, **kwargs) -> None:
            super().__init__(opts, *args, **kwargs)
            n = SEG_TRAIN_SAMPLES if self.is_training else SEG_VAL_SAMPLES
            self.images, self.masks = [None] * n, [None] * n

        def _seed(self, idx, part):
            return np.random.default_rng([idx, int(self.is_training), part])

        def image_size(self, idx):
            rng = self._seed(idx, 0)
            h, w = int(rng.integers(410, 615)), int(rng.integers(546, 820))
            return (w, h) if idx % 3 == 0 else (h, w)

        def read_image(self, idx):
            return self._seed(idx, 1).integers(0, 256, (*self.image_size(idx), 3),
                                               dtype=np.uint8)

        def read_mask(self, idx):
            h, w = self.image_size(idx)
            coarse = self._seed(idx, 2).integers(0, 151, (6, 8)).astype(np.uint8)
            return coarse[np.arange(h) * 6 // h][:, np.arange(w) * 8 // w]


def loader_alone(opts, check_batch, device="cuda") -> tuple:
    """Two epochs of the train loader of ``opts`` with pinned batches (a native
    route's on ``device``) and no step on the card; ``check_batch`` checks
    each batch. Returns the images, the seconds, the seconds to the first
    batch and the loader's threads."""
    import torch

    from cvnets_tpu_torch.data.data_loaders import create_train_val_loader
    from cvnets_tpu_torch.engine.train_state import batch_size

    loader, _, sampler = create_train_val_loader(opts, pin_memory=True, device=device)
    n_img, t0, first = 0, time.perf_counter(), None
    for epoch in range(2):
        sampler.set_epoch(epoch)
        for batch in loader:
            first = first or time.perf_counter() - t0
            check_batch(batch)
            n_img += batch_size(batch["samples"])
    torch.cuda.synchronize()  # a native route's last batch is done
    return n_img, time.perf_counter() - t0, first, loader.num_workers


def _augment_device_ms(opts, card: str) -> float:
    """Device time of one step's augmentation and mixing (RandAugment, random
    erasing, mixup or cutmix) on a uint8 batch of 128 × 256², by
    ``torch.profiler`` over 10 draws (kernels, copies and memsets)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cvnets_tpu_torch.engine.train_state import AUGMENT_STREAM, MIXING_STREAM, step_rng
    from cvnets_tpu_torch.ops.image_ops import build_device_augmenter
    from cvnets_tpu_torch.ops.mixing import build_mixing_fn

    augment, mixing = build_device_augmenter(opts), build_mixing_fn(opts)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = getattr(opts, "dataset.train_batch_size0")
    x = torch.randint(0, 256, (batch, 3, 256, 256), generator=g, device="cuda",
                      dtype=torch.uint8)
    y = torch.randint(0, 1000, (batch,), generator=g, device="cuda")
    n = 10

    def run(step):
        out, soft = mixing(augment(x.float() / 255.0, step_rng(0, step, AUGMENT_STREAM)), y,
                           1000, step_rng(0, step, MIXING_STREAM))
        return out, soft

    host_ms = []
    for step in range(3 + n):  # warm-up, then the host's time to enqueue a step's
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(step)
        host_ms.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for step in range(3, 3 + n):
            run(step)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    launches = sum(e.count for e in events) / n
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / n:.3f}" for e in events[:5])
    print(f"main_train: augmentation + mixing device_ms_per_step={device_ms:.3f} "
          f"kernels_per_step={launches:.0f} host_enqueue_ms={statistics.median(host_ms[3:]):.3f} "
          f"(torch.profiler, {n} steps of {batch} x 256^2; top: {top}) | {card}", flush=True)
    return device_ms


def phase_main_train(card: str, bare: dict) -> None:
    """6c: ``cvnets_tpu_torch.main_train.main_worker`` on the flagship's flags and
    the script's dataset: the loader alone, the device augmentation's time, then
    2 epochs of 4 batches of 128 and their validations through the entry point,
    and ``main_eval`` on its ``checkpoint_ema_last.pt``. ``bare`` is phase 6's
    kernel-path a/b (img/s, peak GiB)."""
    import shutil

    import torch

    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.main_eval import main_worker as main_eval
    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_bwd_kernel,
        separable_attention_kernel,
    )
    from cvnets_tpu_torch.options.opts import get_training_arguments

    register_smoke_dataset()
    results = os.path.join("results", "main_train_smoke")
    shutil.rmtree(results, ignore_errors=True)
    args = MAIN_TRAIN_ARGS + ["--common.results-loc", results]
    opts = get_training_arguments(args=args)

    def check_batch(batch):
        x = batch["samples"]
        check(x.dtype == torch.uint8 and x.is_pinned() and tuple(x.shape) == (128, 3, 256, 256),
              f"main_train loader: batch {x.shape} {x.dtype}, pinned {x.is_pinned()}")

    n_img, loader_s, first, threads = loader_alone(opts, check_batch)
    print(f"main_train: loader alone img_s={n_img / loader_s:.1f} ({n_img} images in "
          f"{loader_s:.3f} s, first batch after {first:.3f} s; {threads} threads, "
          f"{os.cpu_count()} cores; RRC bicubic + flip from ~500x375 uint8 to 256^2) | {card}",
          flush=True)
    aug_ms = _augment_device_ms(opts, card)

    kernels = {"fwd": separable_attention_kernel, "bwd": separable_attention_bwd_kernel}
    per_step = sum(SEP_FLAGSHIP[1].values())
    log = {"train": [], "val": [], "ema": [], "save_s": 0.0}
    soft = {"calls": 0, "err": None}
    watch = SyncWatch()
    built = []

    def watched_loss(criteria):
        def loss(x, prediction, target, training=False, **kwargs):
            if training and target.dim() == 2:  # soft rows; the error summed on the card
                soft["calls"] += 1
                err = (target.sum(dim=1) - 1.0).abs().max()
                soft["err"] = err if soft["err"] is None else torch.maximum(soft["err"], err)
            return criteria(x, prediction, target, training=training, **kwargs)
        return loss

    class WatchedTrainer(main_train.Trainer):
        def __init__(self, opts, model, criteria, *a, **k):
            super().__init__(opts, model, watched_loss(criteria), *a, **k)
            _watch_trainer(self, kernels, watch, per_step, log)
            built.append(self)

    with watch:
        main_train.Trainer = WatchedTrainer
        try:
            for kernel in kernels.values():
                kernel.launches = 0
            main_train.main_worker(args=args)
        finally:
            main_train.Trainer = WatchedTrainer.__bases__[0]
    trainer = built[0]
    launches = {name: k.launches for name, k in kernels.items()}
    n_steps = trainer.train_iterations
    bad = watch.through(MAIN_TRAIN_FILES)
    where = sorted({f"{f.filename.split('cvnets_tpu_torch')[-1]}:{f.lineno}"
                    for _, stack in watch.caught for f in stack[-3:]})
    print(f"main_train: sync debug warnings in the train steps: {len(watch.caught)} "
          f"(innermost frames: {where[:6]}); through the data, ops, loss, engine, metrics "
          f"or checkpoints: {len(bad)}", flush=True)
    check(not bad, f"main_train: a host sync between log points: {bad[:3]}")
    check(n_steps == 2 * SMOKE_TRAIN_SAMPLES // 128, f"main_train: {n_steps} steps")
    check(launches == {"fwd": per_step * (n_steps + 2 * 2 * 2), "bwd": per_step * n_steps},
          f"main_train: separable launches {launches} in {n_steps} steps and 8 eval forwards")
    check(soft["calls"] == n_steps and soft["err"] is not None
          and soft["err"].item() <= 1e-5,
          f"main_train: {soft['calls']} steps with soft targets, row sums off by "
          f"{None if soft['err'] is None else soft['err'].item()}")
    for stage in ("train", "val", "ema"):
        values = [v for entry in log[stage] for v in
                  (entry[3] if stage == "train" else entry).values()]
        check(values and all(math.isfinite(v) for v in values),
              f"main_train: {stage} statistics not finite: {log[stage]}")

    ckpt = os.path.join(trainer.save_dir, "checkpoint_ema_last.pt")
    trainer = None
    built.clear()
    gc.collect()
    before = kernels["fwd"].launches
    got, want = main_eval(args=args + ["--model.classification.pretrained", ckpt]), log["ema"][-1]
    share = 100.0 / SMOKE_VAL_SAMPLES
    check(kernels["fwd"].launches - before == per_step * 2,
          f"main_eval: {kernels['fwd'].launches - before} forward launches")
    check(abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
          and all(abs(got[k] - want[k]) <= share for k in ("top1", "top5")),
          f"main_eval on checkpoint_ema_last.pt: {got} vs the last EMA validation {want}")
    epoch_s = log["train"][-1][1]
    print(f"main_train: MobileViTv2-1.0 batch=128 256x256 bf16 epochs=2 steps={n_steps} "
          f"launches={launches} soft_target_steps={soft['calls']} "
          f"train={[{k: round(v, 4) for k, v in e[3].items()} for e in log['train']]} "
          f"val={[{k: round(v, 4) for k, v in s.items()} for s in log['val']]} "
          f"ema={[{k: round(v, 4) for k, v in s.items()} for s in log['ema']]} "
          f"main_eval={ {k: round(v, 6) for k, v in got.items()} } | {card}", flush=True)
    print(f"main_train: img_s={SMOKE_TRAIN_SAMPLES / epoch_s:.1f} over epoch 2 "
          f"({SMOKE_TRAIN_SAMPLES // 128} steps, {epoch_s:.3f} s, the loader's first batch "
          f"included); loader alone img_s={n_img / loader_s:.1f}; augmentation + mixing "
          f"{aug_ms:.3f} device ms a step; bare step (phase 6 a/b, kernel path) "
          f"img_s={bare['img_s']:.1f} | {card}", flush=True)


def phase_resnet_main_train(card: str, bare: dict) -> None:
    """``cvnets_tpu_torch.main_train.main_worker`` on resnet.yaml's flags
    (``RESNET_MAIN_TRAIN_ARGS``: random resized crop bilinear, flip, SGD, no
    EMA; val through resize 232 and center crop 224) and the script's
    dataset: 2 epochs of 4 batches of 128 × 224² and 2 val batches of 100,
    then ``main_eval`` on the run's checkpoint_last.pt against its last
    validation (at the val batch of 100, where the yaml leaves the eval batch
    at 1: the same batches give the same bf16 convs). Checks finite statistics and no CUDA sync debug warning whose
    stack passes through the data, ops, loss, engine, metrics or checkpoint
    code between log points; prints the img/s over epoch 2 beside ``bare``,
    the ResNet-50 steady steps' (img/s, peak GiB)."""
    import shutil

    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.main_eval import main_worker as main_eval

    register_smoke_dataset()
    results = os.path.join("results", "resnet_main_train_smoke")
    shutil.rmtree(results, ignore_errors=True)
    args = RESNET_MAIN_TRAIN_ARGS + ["--common.results-loc", results]
    log = {"train": [], "val": [], "ema": [], "save_s": 0.0}
    watch = SyncWatch()
    built = []

    class WatchedTrainer(main_train.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            _watch_trainer(self, {}, watch, 0, log)
            built.append(self)

    with watch:
        main_train.Trainer = WatchedTrainer
        try:
            main_train.main_worker(args=args)
        finally:
            main_train.Trainer = WatchedTrainer.__bases__[0]
    trainer = built[0]
    n_steps = trainer.train_iterations
    bad = watch.through(MAIN_TRAIN_FILES)
    print(f"main_train: ResNet-50 sync debug warnings in the train steps: "
          f"{len(watch.caught)}; through the data, ops, loss, engine, metrics or "
          f"checkpoints: {len(bad)}", flush=True)
    check(not bad, f"main_train ResNet-50: a host sync between log points: {bad[:3]}")
    check(n_steps == 2 * SMOKE_TRAIN_SAMPLES // 128, f"main_train ResNet-50: {n_steps} steps")
    check(trainer.state.ema is None and not log["ema"], "main_train ResNet-50: an EMA ran")
    for stage in ("train", "val"):
        values = [v for entry in log[stage] for v in
                  (entry[3] if stage == "train" else entry).values()]
        check(values and all(math.isfinite(v) for v in values),
              f"main_train ResNet-50: {stage} statistics not finite: {log[stage]}")
    ckpt = os.path.join(trainer.save_dir, "checkpoint_last.pt")
    trainer = None
    built.clear()
    gc.collect()
    got = main_eval(args=args + ["--model.classification.pretrained", ckpt,
                                 "--dataset.eval-batch-size0", "100"])
    want, share = log["val"][-1], 100.0 / SMOKE_VAL_SAMPLES
    check(abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
          and all(abs(got[k] - want[k]) <= share for k in ("top1", "top5")),
          f"main_eval on checkpoint_last.pt: {got} vs the last validation {want}")
    epoch_s = log["train"][-1][1]
    print(f"main_train: ResNet-50 batch=128 224x224 bf16 epochs=2 steps={n_steps} "
          f"train={[{k: round(v, 4) for k, v in e[3].items()} for e in log['train']]} "
          f"val={[{k: round(v, 4) for k, v in s.items()} for s in log['val']]} "
          f"main_eval={ {k: round(v, 6) for k, v in got.items()} } | {card}", flush=True)
    print(f"main_train: ResNet-50 img_s={SMOKE_TRAIN_SAMPLES / epoch_s:.1f} over epoch 2 "
          f"({SMOKE_TRAIN_SAMPLES // 128} steps, {epoch_s:.3f} s, the loader's first batch "
          f"included; RRC bilinear + flip from ~500x375 uint8 to 224^2, 8 threads); "
          f"bare step img_s={bare['img_s']:.1f} | {card}", flush=True)


def phase_seg_main_train(card: str, bare) -> None:
    """``cvnets_tpu_torch.main_train.main_worker`` on the DeepLabv3 yaml's flags
    (``SEG_MAIN_TRAIN_ARGS``) and the script's ADE20k: the loader alone, then 2
    epochs of 3 batches of 8 × 512² and their validations (loss, iou; EMA too)
    through the entry point, then ``main_worker_segmentation`` on the run's
    ``checkpoint_ema_last.pt``, whose mIoU must equal the last EMA validation's
    iou. Checks 2 + 2 seg-CE and 9 + 9 separable launches a step (9 separable
    and no seg-CE an eval forward: full-size logits take the unfused CE), finite
    statistics, an iou in [0, 100], uint8 pinned masks, and no CUDA sync debug
    warning whose stack passes through the port's data, ops, loss, engine,
    metrics or checkpoint code between log points. ``bare`` is DeepLabv3's
    kernel-path a/b (img/s, peak GiB), or None."""
    import shutil

    import torch

    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.main_eval import main_worker_segmentation
    from cvnets_tpu_torch.ops.seg_ce_kernel import seg_ce_bwd_kernel, seg_ce_fwd_kernel
    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_bwd_kernel,
        separable_attention_kernel,
    )
    from cvnets_tpu_torch.options.opts import get_training_arguments

    register_smoke_ade20k()
    results = os.path.join("results", "seg_main_train_smoke")
    shutil.rmtree(results, ignore_errors=True)
    args = SEG_MAIN_TRAIN_ARGS + ["--common.results-loc", results]
    opts = get_training_arguments(args=args)

    def check_batch(batch):
        x, y = batch["samples"], batch["targets"]
        check(x.dtype == y.dtype == torch.uint8 and x.is_pinned() and y.is_pinned()
              and tuple(x.shape) == (SEG_BATCH, 3, 512, 512)
              and tuple(y.shape) == (SEG_BATCH, 512, 512),
              f"seg main_train loader: {x.shape} {x.dtype} / {y.shape} {y.dtype}, "
              f"pinned {x.is_pinned()} / {y.is_pinned()}")

    n_img, loader_s, first, threads = loader_alone(opts, check_batch)
    print(f"seg main_train: loader alone img_s={n_img / loader_s:.1f} ({n_img} images in "
          f"{loader_s:.3f} s, first batch after {first:.3f} s, then "
          f"{(n_img - SEG_BATCH) / (loader_s - first):.1f} img/s; {threads} threads, "
          f"{os.cpu_count()} cores; short side 256-768 bicubic from ~683x512 uint8, flip, "
          f"512^2 crop; uint8 masks) | {card}", flush=True)

    sep = {"fwd": separable_attention_kernel, "bwd": separable_attention_bwd_kernel}
    seg = {"seg_ce_fwd": seg_ce_fwd_kernel, "seg_ce_bwd": seg_ce_bwd_kernel}
    per_step = sum(SEP_DEEPLAB[1].values())
    log = {"train": [], "val": [], "ema": [], "save_s": 0.0}
    watch = SyncWatch()
    built = []

    class WatchedTrainer(main_train.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            _watch_trainer(self, sep, watch, per_step, log)
            built.append(self)

    with watch:
        main_train.Trainer = WatchedTrainer
        try:
            for kernel in (*sep.values(), *seg.values()):
                kernel.launches = 0
            main_train.main_worker(args=args)
        finally:
            main_train.Trainer = WatchedTrainer.__bases__[0]
    trainer = built[0]
    launches = {name: k.launches for name, k in {**sep, **seg}.items()}
    n_steps = trainer.train_iterations
    n_eval = 2 * 2 * SEG_VAL_SAMPLES // SEG_BATCH  # 2 epochs, validation and EMA
    bad = watch.through(MAIN_TRAIN_FILES)
    print(f"seg main_train: sync debug warnings in the train steps: {len(watch.caught)}; "
          f"through the data, ops, loss, engine, metrics or checkpoints: {len(bad)}",
          flush=True)
    check(not bad, f"seg main_train: a host sync between log points: {bad[:3]}")
    check(n_steps == 2 * SEG_TRAIN_SAMPLES // SEG_BATCH, f"seg main_train: {n_steps} steps")
    check(launches == {"fwd": per_step * (n_steps + n_eval), "bwd": per_step * n_steps,
                       "seg_ce_fwd": SEG_CALLS * n_steps, "seg_ce_bwd": SEG_CALLS * n_steps},
          f"seg main_train: launches {launches} in {n_steps} steps and {n_eval} eval forwards")
    for stage in ("train", "val", "ema"):
        values = [v for entry in log[stage] for v in
                  (entry[3] if stage == "train" else entry).values()]
        check(values and all(math.isfinite(v) for v in values),
              f"seg main_train: {stage} statistics not finite: {log[stage]}")
    check(all(0.0 <= s["iou"] <= 100.0 for s in log["val"] + log["ema"]),
          f"seg main_train: iou out of [0, 100]: {log['val']} {log['ema']}")

    ckpt = os.path.join(trainer.save_dir, "checkpoint_ema_last.pt")
    trainer = None
    built.clear()
    gc.collect()
    before = sep["fwd"].launches
    miou = main_worker_segmentation(args=args + [
        "--model.segmentation.pretrained", ckpt,
        "--evaluation.segmentation.resize-input-images-fixed-size", "512", "512"])
    want = log["ema"][-1]["iou"]
    check(sep["fwd"].launches - before == per_step * SEG_VAL_SAMPLES // SEG_BATCH,
          f"main_worker_segmentation: {sep['fwd'].launches - before} forward launches")
    check(miou == want, f"main_worker_segmentation mIoU {miou!r} vs the last EMA "
                        f"validation's iou {want!r}")
    epoch_s = log["train"][-1][1]
    rounded = lambda stats: [{k: round(v, 4) for k, v in s.items()} for s in stats]  # noqa: E731
    print(f"seg main_train: DeepLabv3-MobileViTv2-1.0 batch={SEG_BATCH} 512x512 bf16 epochs=2 "
          f"steps={n_steps} launches={launches} "
          f"train={rounded([e[3] for e in log['train']])} val={rounded(log['val'])} "
          f"ema={rounded(log['ema'])} main_worker_segmentation miou={miou!r} | {card}",
          flush=True)
    print(f"seg main_train: img_s={SEG_TRAIN_SAMPLES / epoch_s:.1f} over epoch 2 "
          f"({n_steps // 2} steps, {epoch_s:.3f} s, the loader's first batch included); "
          f"loader alone img_s={n_img / loader_s:.1f}; bare step (DeepLabv3 a/b, kernel "
          f"path) img_s={'not run' if bare is None else format(bare['img_s'], '.1f')} "
          f"| {card}", flush=True)


def phase_pspnet(card: str) -> dict:
    """PSPNet-MobileViTv2-1.0 train steps at batch 8 × 512² with
    pspnet_mobilevitv2.yaml's settings (OS 8, pyramid 1/2/3/6, 512 channels,
    aux head), then its steady steps; the seg-CE (2 + 2) and separable (9 +
    9) launches a step. Returns the launch counts."""
    from cvnets_tpu_torch.ops.seg_ce_kernel import seg_ce_bwd_kernel, seg_ce_fwd_kernel
    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_bwd_kernel,
        separable_attention_kernel,
    )

    sep = {"separable_attention": separable_attention_kernel,
           "separable_attention_bwd": separable_attention_bwd_kernel}
    label = "PSPNet-MobileViTv2-1.0"
    launches, run = phase_train(
        card, label, PSPNET_ARGS,
        {"seg_ce_fwd": seg_ce_fwd_kernel, "seg_ce_bwd": seg_ce_bwd_kernel, **sep},
        {"seg_ce_fwd": SEG_CALLS, "seg_ce_bwd": SEG_CALLS,
         **{name: sum(SEP_DEEPLAB[1].values()) for name in sep}})
    phase_steady(card, label, run)
    return launches


def phase_mobileone_fused(card: str, run) -> None:
    """The trained MobileOne-s1's float32 eval forward (TF32 off) through its
    branches and through a copy folded by ``reparameterize_model``, on 8 of its
    images: within 1e-4 of max(1, the largest logit)."""
    import copy

    import torch

    from cvnets_tpu_torch.modules.mobileone_block import MobileOneBlock
    from cvnets_tpu_torch.utils.reparam_utils import reparameterize_model

    state, _, _, batches, _ = run
    model = state.model.eval()
    x = batches[0]["samples"][:8].float() / 255.0
    folded = reparameterize_model(copy.deepcopy(model))
    blocks = [m for m in folded.modules() if isinstance(m, MobileOneBlock)]
    check(blocks and all(b.reparam_conv is not None and b.skip_bn is None for b in blocks),
          "MobileOne-s1: a block kept its branches")
    with no_tf32(), torch.no_grad():
        multi, fused = model(x), folded(x)
    diff, scale = (multi - fused).abs().max().item(), multi.abs().max().item()
    check(bool(torch.isfinite(fused).all()) and diff <= 1e-4 * max(1.0, scale),
          f"MobileOne-s1: folded vs multi-branch logits differ by {diff}")
    n_multi = sum(p.numel() for p in model.parameters())
    n_fused = sum(p.numel() for p in folded.parameters())
    print(f"reference: MobileOne-s1 folded vs multi-branch float32 eval logits max diff "
          f"{diff:.3e} (max |logit| {scale:.3e}); {len(blocks)} blocks folded, params "
          f"{n_multi} -> {n_fused} | {card}", flush=True)


def phase_conv(card: str) -> None:
    """The conv families: ResNet-50 at resnet.yaml's settings (train, steady
    steps, profile, main_train and main_eval), then a short train phase of
    each of the other families at its yaml's width and its steady steps
    (MobileOne-s1's folded forward after them). No port kernel runs on these
    paths."""
    import torch

    def release() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    _, run = phase_train(card, "ResNet-50", RESNET_ARGS, {}, {})
    bare = phase_steady(card, "ResNet-50", run)
    phase_profile(card, "ResNet-50", run, os.path.join("results", "resnet_profile.txt"))
    run = None
    release()
    phase_resnet_main_train(card, bare)
    release()
    for label, args in CONV_FAMILY_ARGS.items():
        _, run = phase_train(card, label, args, {}, {}, steps=CONV_FAMILY_STEPS)
        phase_steady(card, label, run)
        if label == "MobileOne-s1":
            phase_mobileone_fused(card, run)
        run = None
        release()


# ---- the native JPEG path: nvJPEG and the crop -> resize -> flip kernel ----
# a seeded ImageFolder of JPEG files written through Pillow at run time (the
# card machine has no image files): classes of train and val files of about
# ImageNet's 500 × 375 (either way round, ±20%), quality 90, 4:2:0 but every
# 8th 4:4:4 and every 16th grayscale; two damaged train files replace two of
# class 0's: one cut at half its bytes, inside the entropy-coded data
# ("truncated"), and one cut inside its header, before the frame
# ("cut_header")
NATIVE_CLASSES, NATIVE_TRAIN_PER_CLASS, NATIVE_VAL_PER_CLASS = 8, 256, 25
NATIVE_TRAIN = NATIVE_CLASSES * NATIVE_TRAIN_PER_CLASS  # 2048: 16 batches of 128
# the kernel's crop classes: (denom, area, out side, crop w, crop h); each
# gives the prescale and the rule named (decode.cpp:151-155, 201)
NATIVE_CLASS_CASES = [(1, True, 128, 200, 210), (1, False, 224, 250, 240),
                      (2, True, 100, 320, 330), (2, False, 100, 210, 300),
                      (4, True, 45, 320, 330), (4, False, 45, 185, 320),
                      (8, True, 20, 320, 340), (8, False, 20, 165, 320)]
NATIVE_BATCH = 128
# nvJPEG's rasters against Pillow's decode of the same file: the mean |diff| a
# kind of file may reach, in levels. nvJPEG's IDCT is not libjpeg's (4:4:4
# 0.51, gray 0.02 levels measured on an NVIDIA H100 80GB HBM3, 700.00 W), and
# its 4:2:0 chroma upsampling is not libjpeg's fancy upsampling (2.88 there)
NVJPEG_PILLOW_MEAN = {"420": 4.0, "444": 1.0, "gray": 0.5}
NATIVE_OUT = ((224, 224), (256, 256))  # the ImageNet recipes' train crops


def _corpus_image(rng, h: int, w: int):
    """Smooth colour fields and grain, so that a file weighs about what an
    ImageNet photo does at quality 90."""
    import numpy as np
    from PIL import Image

    low = rng.integers(0, 256, (h // 24 + 2, w // 24 + 2, 3)).astype(np.uint8)
    field = np.asarray(Image.fromarray(low).resize((w, h), Image.BICUBIC), np.int16)
    return np.clip(field + rng.integers(-24, 25, (h, w, 3)), 0, 255).astype(np.uint8)


def write_jpeg_corpus(root: str, seed: int = 0, train_per_class: int = NATIVE_TRAIN_PER_CLASS,
                      val_per_class: int = NATIVE_VAL_PER_CLASS) -> dict:
    """The corpus above under ``root`` (``train_per_class`` and
    ``val_per_class`` files a class): {"train": dir, "val": dir, "truncated":
    path, "cut_header": path, "kinds": {path: "420" | "444" | "gray"}}. File
    ``k`` draws from ``default_rng([seed, k])``; the files are encoded on a
    thread each core (Pillow's encoder leaves the GIL)."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    out = {"train": os.path.join(root, "train"), "val": os.path.join(root, "val"), "kinds": {}}
    jobs = []
    for split, per_class in (("train", train_per_class), ("val", val_per_class)):
        for c in range(NATIVE_CLASSES):
            folder = os.path.join(out[split], f"n{c:08d}")
            os.makedirs(folder)
            for i in range(per_class):
                k = len(jobs)
                name = f"img_{k:05d}.jpg"
                if split == "train" and c == 0 and i < 2:  # the two damaged files
                    key = ("truncated", "cut_header")[i]
                    name = f"{key}.jpg"
                    out[key] = os.path.join(folder, name)
                kind = "gray" if k % 16 == 5 else "444" if k % 8 == 3 else "420"
                out["kinds"][os.path.join(folder, name)] = kind
                jobs.append((k, os.path.join(folder, name), kind))

    def write(job) -> None:
        k, path, kind = job
        rng = np.random.default_rng([seed, k])
        h, w = int(rng.integers(300, 451)), int(rng.integers(400, 601))
        if k % 3 == 0:
            h, w = w, h
        img = Image.fromarray(_corpus_image(rng, h, w))
        if kind == "gray":
            img = img.convert("L")
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=90, subsampling=0 if kind == "444" else 2)
        data = buf.getvalue()
        if path == out["truncated"]:
            data = data[:len(data) // 2]
        elif path == out["cut_header"]:
            data = data[:100]
        with open(path, "wb") as f:
            f.write(data)

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(write, jobs))
    return out


def native_batch(corpus: dict, n: int = NATIVE_BATCH) -> tuple:
    """The first ``n`` intact train files by name (paths, blobs)."""
    bad = {corpus["truncated"], corpus["cut_header"]}
    paths = sorted(p for p in corpus["kinds"] if p.startswith(corpus["train"]) and p not in bad)
    paths = sorted(paths, key=os.path.basename)[:n]
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    return paths, blobs


def native_rasters(decoder, blobs) -> tuple:
    """nvJPEG's rasters of ``blobs`` in one card buffer: (raster, info,
    offsets, status, [(H, W, 3) uint8 view of each on the card])."""
    from cvnets_tpu_torch.native import raster_layout

    info = decoder.info(blobs)
    offsets, total = raster_layout(info)
    raster, status = decoder.decode(blobs, info, offsets, total)
    views = []
    for (w, h, comps), off in zip(info, offsets):
        ch = 1 if comps == 1 else 3
        v = raster[off:off + w * h * ch].view(int(h), int(w), ch)
        views.append(v.expand(-1, -1, 3) if ch == 1 else v)
    return raster, info, offsets, status, views


def native_bound(info, crops, out_hw) -> tuple:
    """(ms, "bytes" or "operations") of one kernel launch: each raster byte its
    crop's prescale boxes cover read once, the uint8 batch and the params
    written and read once, over the HBM rate (a few integer operations a
    byte: bytes bound it)."""
    from cvnets_tpu_torch.native import N_PARAMS
    from cvnets_tpu_torch.native.plain import crop_plan

    n_bytes = len(crops) * (3 * out_hw[0] * out_hw[1] + 8 * N_PARAMS)
    for (w, h, comps), crop in zip(info, crops):
        d, x, y, cw, ch, _ = crop_plan(int(w), int(h), crop, out_hw)
        rows = min((y + ch) * d, int(h)) - y * d
        cols = min((x + cw) * d, int(w)) - x * d
        n_bytes += rows * cols * (1 if comps == 1 else 3)
    return bound(n_bytes)


def rrc_crops(info, out_hw, seed: int) -> tuple:
    """Random resized crops (scale 0.08-1, aspect 3/4-4/3) and flips of the
    images of ``info``, as the train chain draws them."""
    import random

    from cvnets_tpu_torch.data.transforms.image import RandomResizedCrop
    from cvnets_tpu_torch.options.opts import get_training_arguments

    rrc = RandomResizedCrop(get_training_arguments(args=[]), size=out_hw)
    rng = random.Random(seed)
    crops, flips = [], []
    for w, h, _ in info:
        top, left, ch, cw = rrc.get_params(int(h), int(w), rng)
        crops.append((left, top, cw, ch))
        flips.append(rng.random() < 0.5)
    return crops, flips


def phase_native_kernel(card: str, corpus: dict) -> dict:
    """The native decode phase's kernel checks: (a) the crop → resize → flip
    kernel against its plain version on the same nvJPEG rasters, exactly, at
    every crop class (prescale 1, 2, 4 and 8, each side of the 1.5× rule,
    with and without the flip), the whole image, and random resized crops at
    128 × 224² and 128 × 256²; (b) nvJPEG's rasters against Pillow's decode
    of the same files, by kind; the kernel's and nvJPEG's times a batch.
    Returns the kernel's record for the JSON line."""
    import random
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from PIL import Image

    from cvnets_tpu_torch import native
    from cvnets_tpu_torch.native.plain import crop_plan, crop_resize_flip

    device = torch.device("cuda:0")
    paths, blobs = native_batch(corpus)
    decoder = native.JpegDecoder(device)
    raster, info, offsets, status, views = native_rasters(decoder, blobs)
    torch.cuda.synchronize()
    check(status.all(), f"native: nvJPEG failed {np.flatnonzero(status == 0).tolist()}")
    kinds = [corpus["kinds"][p] for p in paths]
    check({"420", "444", "gray"} <= set(kinds), f"native: kinds {set(kinds)}")

    # (b) nvJPEG against Pillow, levels
    diffs = {}
    for p, kind, view in zip(paths, kinds, views):
        with Image.open(p) as img:
            want = torch.from_numpy(np.array(img.convert("RGB"))).to(device)
        d = (view.int() - want.int()).abs()
        diffs.setdefault(kind, []).append((d.float().mean().item(), d.max().item()))
    for kind, ds in sorted(diffs.items()):
        mean = sum(m for m, _ in ds) / len(ds)
        print(f"native: nvJPEG vs Pillow {kind} ({len(ds)} files): mean |diff| "
              f"{mean:.4f} levels, max {max(x for _, x in ds)} | {card}", flush=True)
        check(mean < NVJPEG_PILLOW_MEAN[kind],
              f"native: nvJPEG {kind} off Pillow's decode by {mean} levels")

    # (a) the kernel against its plain version on the same rasters
    rng = random.Random(0)
    worst, n_cases, seen = 0, 0, set()

    def compare(crops, flips, out_hw, label):
        nonlocal worst, n_cases
        params = torch.from_numpy(native.kernel_params(info, offsets, crops, flips, status))
        got = native.crop_resize_flip(raster, params, out_hw)
        for i, (crop, flip) in enumerate(zip(crops, flips)):
            want = crop_resize_flip(views[i], crop, flip, out_hw)
            err = (got[i].int() - want.int()).abs().max().item()
            worst = max(worst, err)
            check(err == 0, f"native kernel {label} image {i} crop {crop} flip {flip}: "
                            f"{err} levels off its plain version")
            n_cases += 1

    for denom, area, side, cw, ch in NATIVE_CLASS_CASES:
        crops, flips = [], []
        for k, (w, h, _) in enumerate(info):
            if k >= 16 or w < cw or h < ch:
                crops.append((0, 0, -1, -1))
            else:
                crops.append((rng.randint(0, int(w) - cw), rng.randint(0, int(h) - ch), cw, ch))
                plan = crop_plan(int(w), int(h), crops[-1], (side, side))
                check((plan[0], plan[5]) == (denom, area), f"native case {denom, area}: {plan}")
                seen.add((denom, area))
            flips.append(k % 2 == 1)
        compare(crops, flips, (side, side), f"prescale {denom} {'area' if area else 'bilinear'}")
    check(len(seen) == len(NATIVE_CLASS_CASES), f"native: crop classes seen {sorted(seen)}")
    compare([(0, 0, -1, -1)] * len(blobs), [k % 2 == 0 for k in range(len(blobs))],
            (224, 224), "whole image")
    record = {"max_abs_err": float(worst)}
    times = {}
    for out_hw in NATIVE_OUT:
        crops, flips = rrc_crops(info, out_hw, seed=out_hw[0])
        compare(crops, flips, out_hw, f"rrc {out_hw[0]}")
        params = torch.from_numpy(native.kernel_params(info, offsets, crops, flips, status)).to(device)
        out = torch.empty((len(blobs), 3, *out_hw), dtype=torch.uint8, device=device)
        kernel = native.crop_resize_flip_kernel
        t_kernel = time_ms(lambda: kernel.launch(device, raster.data_ptr(), params.data_ptr(),
                                                 len(blobs), out_hw[0], out_hw[1],
                                                 out.data_ptr()))
        t_plain = time_ms(lambda: [crop_resize_flip(v, c, f, out_hw)
                                   for v, c, f in zip(views, crops, flips)],
                          launches=1, samples=3, warmup=1)
        b_ms, b_by = native_bound(info, crops, out_hw)
        times[out_hw[0]] = (t_kernel, t_plain, b_ms)
        print(f"native kernel: batch {len(blobs)} x {out_hw[0]}^2 (random resized crops of "
              f"~500x375) kernel_ms={t_kernel:.4f} plain_ms={t_plain:.4f} bound_ms={b_ms:.4f} "
              f"({b_by}; kernel/bound {t_kernel / b_ms:.2f}) | {card}", flush=True)
        if out_hw == NATIVE_OUT[1]:  # the flagship's 256² batches
            record.update(ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
                          library_ms=None)
    n_bytes = sum(len(b) for b in blobs)
    for threads in (1, 8):  # nvJPEG handles decoding chunks of the batch at once
        with ThreadPoolExecutor(threads) as pool:
            timed = native.JpegDecoder(device, threads=threads, pool=pool)
            decode_ms = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                native_rasters(timed, blobs)
                torch.cuda.synchronize()
                decode_ms.append(1e3 * (time.perf_counter() - t0))
            timed.close()
        record[f"decode_ms_{threads}_threads"] = statistics.median(decode_ms[1:])
        print(f"native: nvJPEG decode of {len(blobs)} files ({n_bytes / len(blobs) / 1e3:.1f} "
              f"kB each, ~500x375), {threads} decoding threads: median "
              f"{statistics.median(decode_ms[1:]):.3f} ms a batch (host clock to a sync; "
              f"{[round(t, 3) for t in decode_ms]}, the first one's set-up excluded) | {card}",
              flush=True)
    print(f"native kernel: {n_cases} image cases equal to the plain version bit for bit "
          f"(max |diff| {worst} levels) over prescale 1/2/4/8 x area/bilinear, flips, whole "
          f"images and random resized crops at 224^2 and 256^2 | {card}", flush=True)
    decoder.close()
    return record


# the rest of config/classification/imagenet/vit.yaml and swin.yaml, as flags: their
# loaders, samplers, host transforms and augmentation (dataset.name and its roots
# are the yamls' ImageNet on disk; the native phases name the JPEG corpus)
VIT_DATA_ARGS = [
    "--dataset.category", "classification",
    "--dataset.workers", "8",
    "--sampler.name", "variable_batch_sampler",
    "--sampler.vbs.crop-size-width", "224",
    "--sampler.vbs.crop-size-height", "224",
    "--sampler.vbs.max-n-scales", "5",
    "--sampler.vbs.min-crop-size-width", "128",
    "--sampler.vbs.max-crop-size-width", "320",
    "--sampler.vbs.min-crop-size-height", "128",
    "--sampler.vbs.max-crop-size-height", "320",
    "--sampler.vbs.check-scale", "32",
    "--image-augmentation.random-resized-crop.enable",
    "--image-augmentation.random-resized-crop.interpolation", "bilinear",
    "--image-augmentation.random-horizontal-flip.enable",
    "--image-augmentation.rand-augment.enable",
    "--image-augmentation.random-erase.enable",
    "--image-augmentation.random-erase.p", "0.25",
    "--image-augmentation.mixup.enable",
    "--image-augmentation.mixup.alpha", "0.2",
    "--image-augmentation.cutmix.enable",
    "--image-augmentation.cutmix.alpha", "1.0",
    "--image-augmentation.resize.enable",
    "--image-augmentation.resize.size", "232",
    "--image-augmentation.center-crop.enable",
    "--image-augmentation.center-crop.size", "224",
]
SWIN_DATA_ARGS = [
    "--dataset.category", "classification",
    "--dataset.workers", "8",
    "--sampler.name", "batch_sampler",
    "--image-augmentation.random-resized-crop.enable",
    "--image-augmentation.random-resized-crop.interpolation", "bicubic",
    "--image-augmentation.random-horizontal-flip.enable",
    "--image-augmentation.rand-augment.enable",
    "--image-augmentation.random-erase.enable",
    "--image-augmentation.random-erase.p", "0.25",
    "--image-augmentation.mixup.enable",
    "--image-augmentation.mixup.alpha", "0.8",
    "--image-augmentation.cutmix.enable",
    "--image-augmentation.cutmix.alpha", "1.0",
    "--image-augmentation.resize.enable",
    "--image-augmentation.resize.size", "232",
    "--image-augmentation.center-crop.enable",
    "--image-augmentation.center-crop.size", "224",
]
# main_train on each yaml's flags with the native decoder, on the JPEG corpus:
# 2 epochs (the ViT's variable batch sampler draws a crop of 128-320 and its
# batch every batch)
NATIVE_MAIN_TRAIN = {
    "MobileViTv2-1.0": FLAGSHIP_ARGS + IMAGENET_RUN_ARGS + FLAGSHIP_DATA_ARGS,
    "ViT-B/16": VIT_ARGS + VIT_DATA_ARGS,
    "Swin-T": SWIN_ARGS + SWIN_DATA_ARGS,
    "MobileViT-S": MOBILEVIT_ARGS + MOBILEVIT_DATA_ARGS,
    "FastViT-T8": FASTVIT_ARGS + FASTVIT_DATA_ARGS,
}


def corpus_args(corpus: dict, decoder: str = "native") -> list:
    return ["--dataset.name", "imagenet", "--dataset.root-train", corpus["train"],
            "--dataset.root-val", corpus["val"], "--dataset.decoder", decoder,
            "--scheduler.max-epochs", "2"]


def phase_native_loader(card: str, corpus: dict) -> dict:
    """The native decode phase's loader checks: (c) the two damaged files'
    status from nvJPEG and their slots replaced by valid ones in place
    (``fetch_batch_native``), and (d) the flagship's train loader alone over
    two epochs of the corpus, ``--dataset.decoder native`` (nvJPEG, 8 decoding
    threads, the kernel; batches on the card) against ``pil`` (8 threads of
    Pillow and the port's resampling; pinned host batches). Returns the
    loaders' img/s by decoder."""
    import random

    import numpy as np
    import torch

    from cvnets_tpu_torch import native
    from cvnets_tpu_torch.data.datasets import get_train_val_datasets
    from cvnets_tpu_torch.options.opts import get_training_arguments

    device = torch.device("cuda:0")
    base = NATIVE_MAIN_TRAIN["MobileViTv2-1.0"]
    opts = get_training_arguments(args=base + corpus_args(corpus))
    dataset, _ = get_train_val_datasets(opts)
    paths = [p for p, _ in dataset.samples]
    bad = [paths.index(corpus["truncated"]), paths.index(corpus["cut_header"])]
    good = [i for i in range(len(paths)) if i not in bad][:6]
    idxs = good[:3] + bad + good[3:]
    blobs = [dataset._read_bytes(i) for i in idxs]
    _, status = native.decode_rrc_batch(blobs, [(0, 0, -1, -1)] * len(blobs), None,
                                        (256, 256), device)
    batch = dataset.fetch_batch_native([(256, 256, i) for i in idxs], random.Random(0),
                                       device)
    torch.cuda.synchronize()
    failed = [k for k, ok in enumerate(status) if not ok]
    truncated, cut_header = 3, 4  # their slots in idxs
    check(cut_header in failed, f"native: the file cut inside its header decoded: {status}")
    for k in failed:
        rep = batch["sample_id"][k].item()
        check(rep != idxs[k] and rep in good and batch["targets"][k].item()
              == dataset.samples[rep][1] and torch.equal(batch["samples"][k],
                                                         batch["samples"][idxs.index(rep)]),
              f"native: failed slot {k} not replaced by a valid one: id {rep}")
    print(f"native: damaged files: truncated at half its bytes status "
          f"{int(status[truncated])}, cut inside its header status {int(status[cut_header])}; "
          f"failed slots "
          f"{failed} replaced in place by valid ones (ids "
          f"{[batch['sample_id'][k].item() for k in failed]}) | {card}", flush=True)

    rates = {}
    for decoder in ("native", "pil"):
        opts = get_training_arguments(args=base + corpus_args(corpus, decoder))

        def check_batch(batch, decoder=decoder):
            x = batch["samples"]
            where = x.is_cuda if decoder == "native" else x.is_pinned()
            check(x.dtype == torch.uint8 and where and tuple(x.shape) == (128, 3, 256, 256),
                  f"native loader ({decoder}): batch {x.shape} {x.dtype} on {x.device}")

        n_img, secs, first, threads = loader_alone(opts, check_batch, device=device)
        rates[decoder] = (n_img - NATIVE_BATCH) / (secs - first)
        print(f"native: loader alone --dataset.decoder {decoder} img_s={rates[decoder]:.1f} "
              f"after the first batch ({n_img} images of ~500x375 JPEG files in {secs:.3f} "
              f"s, first batch after {first:.3f} s, {n_img / secs:.1f} img/s with it; "
              f"{threads} threads, {os.cpu_count()} cores; RRC bicubic + flip to 128 x "
              f"256^2) | {card}", flush=True)
    return rates


def phase_native_main_train(card: str, label: str, corpus: dict, kernels: dict,
                            per_step: int) -> dict:
    """``main_worker`` on the yaml's flags of ``label`` (``NATIVE_MAIN_TRAIN``)
    with ``--dataset.decoder native`` on the JPEG corpus, 2 epochs and their
    validations (Pillow); every train batch goes through nvJPEG and one launch
    of the crop → resize → flip kernel. Checks that launch a batch, the
    model's ``kernels`` (``per_step`` forward and backward a train step and
    forward an eval forward), finite statistics and no host sync through the
    port's data, ops, loss, engine, metrics or checkpoint code between log
    points. Returns the kernel's launches and img/s over epoch 2."""
    import shutil

    import torch

    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.native import crop_resize_flip_kernel

    results = os.path.join("results", "native_" + label.replace("/", "_"))
    shutil.rmtree(results, ignore_errors=True)
    args = NATIVE_MAIN_TRAIN[label] + corpus_args(corpus) + ["--common.results-loc", results]
    log = {"train": [], "val": [], "ema": [], "save_s": 0.0}
    watch, built, images = SyncWatch(), [], []

    class WatchedTrainer(main_train.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            _watch_trainer(self, kernels, watch, per_step, log)
            step, epoch_fn = self._train_step, self.train_epoch

            def counted(state, batch, *rest):
                images[-1] += batch["samples"].shape[0]
                check(batch["samples"].is_cuda and batch["samples"].dtype == torch.uint8,
                      f"{label} native: a batch {batch['samples'].dtype} on "
                      f"{batch['samples'].device}")
                return step(state, batch, *rest)

            def epoch(e):
                images.append(0)
                return epoch_fn(e)

            self._train_step, self._train_step_noaccum = counted, None
            self.train_epoch = epoch
            built.append(self)

    with watch:
        main_train.Trainer = WatchedTrainer
        try:
            crop_resize_flip_kernel.launches = 0
            main_train.main_worker(args=args)
            launches = crop_resize_flip_kernel.launches
        finally:
            main_train.Trainer = WatchedTrainer.__bases__[0]
    trainer = built[0]
    n_steps = trainer.train_iterations
    bad = watch.through(MAIN_TRAIN_FILES)
    check(not bad, f"{label} native main_train: a host sync between log points: {bad[:3]}")
    check(launches == n_steps > 0, f"{label} native main_train: {launches} crop_resize_flip "
                                   f"launches in {n_steps} train steps")
    for stage in ("train", "val", "ema"):
        values = [v for entry in log[stage] for v in
                  (entry[3] if stage == "train" else entry).values()]
        check(values and all(math.isfinite(v) for v in values),
              f"{label} native main_train: {stage} statistics not finite: {log[stage]}")
    epoch_s = log["train"][-1][1]
    img_s = images[-1] / epoch_s
    print(f"native main_train: {label} --dataset.decoder native epochs=2 steps={n_steps} "
          f"crop_resize_flip launches={launches} img_s={img_s:.1f} over epoch 2 "
          f"({images[-1]} images in {epoch_s:.3f} s, the loader's first batch included) "
          f"train={[{k: round(v, 4) for k, v in e[3].items()} for e in log['train']]} "
          f"val={[{k: round(v, 4) for k, v in s.items()} for s in log['val']]} | {card}",
          flush=True)
    return {"launches": launches, "img_s": img_s}


def phase_native(card: str) -> dict:
    """The native JPEG path, phases 17a-17c: the corpus, the kernel and decode
    checks, the loaders, then main_train on the three yamls. Returns the
    kernel's JSON record."""
    import tempfile

    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel
    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_bwd_kernel,
        separable_attention_kernel,
    )
    from cvnets_tpu_torch.ops.window_attention import window_bwd_kernel, window_fwd_kernel

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        corpus = write_jpeg_corpus(root)
        print(f"native: corpus of {len(corpus['kinds'])} JPEG files written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        record = phase_native_kernel(card, corpus)
        phase_native_loader(card, corpus)
        runs = {}
        for label, kernels, per_step in (
                ("MobileViTv2-1.0", {"fwd": separable_attention_kernel,
                                     "bwd": separable_attention_bwd_kernel},
                 sum(SEP_FLAGSHIP[1].values())),
                ("ViT-B/16", {"fwd": mha_fwd_kernel, "bwd": mha_bwd_kernel}, VIT_BLOCKS),
                ("Swin-T", {"fwd": window_fwd_kernel, "bwd": window_bwd_kernel},
                 SWIN_BLOCKS), ("MobileViT-S", {}, 0), ("FastViT-T8", {}, 0)):
            runs[label] = phase_native_main_train(card, label, corpus, kernels, per_step)
            gc.collect()
    record["launches"] = runs["MobileViTv2-1.0"]["launches"]
    return record


# ---- MobileViT v1, FastViT and SSDLite (phase 18) ----
def detection_targets(opts, batch: int, hw: tuple, device) -> dict:
    """Per-anchor targets of ``batch`` images of ``hw``: 1-6 random boxes an
    image matched to the options' anchors on the host, as the COCO dataset
    matches them, then copied to ``device``."""
    import numpy as np
    import torch

    from cvnets_tpu_torch.models.detection.ssd import anchor_generator_and_matcher, anchors_for

    gen, matcher = anchor_generator_and_matcher(opts)
    anchors = anchors_for(gen, *hw)
    rng = np.random.default_rng(0)
    n_classes = getattr(opts, "model.detection.n_classes")
    locs, labels = [], []
    for _ in range(batch):
        n = int(rng.integers(1, 7))
        xy = rng.random((n, 2)) * 0.7
        boxes = np.concatenate([xy, xy + 0.05 + rng.random((n, 2)) * 0.25], 1)
        loc, lab = matcher(np.minimum(boxes, 1.0).astype(np.float32),
                           rng.integers(1, n_classes, n), anchors)
        locs.append(loc)
        labels.append(lab)
    return {"box_labels": torch.from_numpy(np.stack(labels)).to(device),
            "box_coordinates": torch.from_numpy(np.stack(locs)).to(device)}


def phase_xxs_kernel_grads(card: str, run) -> None:
    """MobileViT-XXS's float32 eval-mode loss grads (TF32 off) on 8 of its
    images through the MHA kernels (layer 3, D = 16) against the einsum path:
    every parameter's grad within 5e-4 of the largest grad (the CPU tests'
    grad bound), and the kernels launched 2 + 2 times in the kernel pass."""
    import torch

    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel

    state, _, _, batches, criteria = run
    model = state.model.eval()
    x = batches[0]["samples"][:8].float() / 255.0
    y = batches[0]["targets"][:8]
    grads = {}
    with no_tf32():
        for on in (True, False):
            set_use_kernel(model, on)
            model.zero_grad(set_to_none=True)
            mha_fwd_kernel.launches = mha_bwd_kernel.launches = 0
            criteria(x, model(x), y, training=True).backward()
            launches = (mha_fwd_kernel.launches, mha_bwd_kernel.launches)
            check(launches == ((XXS_MHA_BLOCKS, XXS_MHA_BLOCKS) if on else (0, 0)),
                  f"MobileViT-XXS grads (kernel={on}): MHA launches {launches}")
            grads[on] = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    set_use_kernel(model, True)
    model.zero_grad(set_to_none=True)
    gmax = max(g.abs().max().item() for g in grads[False].values())
    err = max((grads[True][k] - g).abs().max().item() for k, g in grads[False].items())
    check(all(bool(torch.isfinite(g).all()) for g in grads[True].values())
          and err <= 5e-4 * gmax, f"MobileViT-XXS: kernel vs plain grads differ by {err}")
    print(f"reference: MobileViT-XXS kernel-path vs plain-path float32 eval-mode param "
          f"grads max diff {err:.3e} (max |grad| {gmax:.3e}; {len(grads[True])} tensors; "
          f"layer 3's MHA at D = 16, S = 256 through the kernels) | {card}", flush=True)


def phase_ssd_predict(card: str, run) -> None:
    """SSDLite's ``predict`` on a batch of 32 × 320²: the eval forward under
    bf16 autocast, then decode, top-k and class-aware padded NMS on the card
    (``postprocess``), with no host sync (the CUDA sync debug mode catches
    none); the postprocess alone and the whole predict timed with CUDA events;
    and the postprocess on the card of the CPU copy's float32 outputs against
    the CPU's postprocess of them: the same labels, scores within 1e-6, boxes
    within 1e-5."""
    import copy

    import torch

    state, _, _, batches, _ = run
    model = state.model.eval()
    x = batches[0]["samples"].float() / 255.0
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        pred = model(x)
    torch.cuda.synchronize()
    watch = SyncWatch()
    with watch, torch.no_grad():
        watch.on()
        out = model.postprocess(pred)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            full = model.predict(x)
        watch.off()
        torch.cuda.synchronize()
    check(not watch.caught, f"SSD predict: a host sync: {watch.through(('cvnets_tpu_torch',))}")
    check(tuple(out.boxes.shape) == (32, 200, 4) and bool(torch.isfinite(out.scores).all())
          and bool(torch.isfinite(full.boxes).all()), "SSD predict: shapes or finiteness")
    with torch.no_grad():
        post_ms = time_ms(lambda: model.postprocess(pred), launches=5, samples=5, warmup=2)

        def whole():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                model.predict(x)

        predict_ms = time_ms(whole, launches=5, samples=5, warmup=2)
        # decode and NMS on the card against the CPU, on the same float32 outputs
        on_cpu = copy.deepcopy(model).cpu()
        with no_tf32():
            raw = on_cpu(x[:4].cpu())
        got = model.postprocess({k: v.cuda() for k, v in raw.items()})
        want = on_cpu.postprocess(raw)
    ls = (got.labels.cpu() == want.labels).float().mean().item()
    ds = (got.scores.cpu() - want.scores).abs().max().item()
    db = (got.boxes.cpu() - want.boxes).abs().max().item()
    check(ls == 1.0 and ds <= 1e-6 and db <= 1e-5,
          f"SSD postprocess card vs CPU: labels {ls}, scores {ds}, boxes {db}")
    kept = (out.scores > 0).sum(dim=1).float().mean().item()
    print(f"predict: SSDLite-MobileViT-S batch=32 320x320 postprocess_ms={post_ms:.3f} "
          f"(softmax, decode, top-400, class-aware NMS to 200 slots, 200 greedy steps) "
          f"predict_ms={predict_ms:.3f} (bf16 forward + postprocess) kept/image={kept:.1f}; "
          f"no host sync; card vs CPU postprocess of the same outputs: labels equal, "
          f"scores {ds:.1e}, boxes {db:.1e} | {card}", flush=True)


def ssd_eval_reference(card: str, args: list, ckpt: str, n_images: int = 3) -> None:
    """The offline eval path's ``eval_detection.predict`` (the checkpoint's
    weights, ``UnitNormalizer``, each image at its own size with its own
    anchors, batch 1) on the card against the same call on a CPU copy built
    from the same checkpoint, on the first ``n_images`` of the val split,
    float32 with TF32 off: the forward's scores and box offsets within
    ``cpu_reference``'s bound and the anchors within 1e-6; then the card's
    postprocess of the CPU's outputs against the CPU's result: the same
    labels, scores within 1e-6 and boxes within 1e-5 (as ``phase_ssd_predict``)."""
    import torch

    from cvnets_tpu_torch.data.data_loaders import create_test_loader
    from cvnets_tpu_torch.engine.eval_detection import predict
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_eval_arguments
    from cvnets_tpu_torch.utils.checkpoint_utils import load_model_weights

    opts = get_eval_arguments(args=args)
    setattr(opts, "common.mixed_precision", False)
    loader = create_test_loader(opts, pin_memory=False)
    weights = load_model_weights(ckpt)
    models, raw = {}, {}
    for dev in ("cuda", "cpu"):
        model = get_model(opts, device=dev)
        model.load_state_dict(weights)
        post, raw[dev] = model.postprocess, []
        # keep each forward's outputs on their way into the postprocess
        model.postprocess = lambda p, post=post, keep=raw[dev]: (keep.append(p), post(p))[1]
        models[dev] = (model, post)
    sizes, worst = [], [0.0, 0.0, 0.0, 0.0]
    for _, batch in zip(range(n_images), loader):
        x = batch["samples"]
        sizes.append(tuple(x.shape[-2:]))
        with no_tf32():
            got = predict(opts, models["cuda"][0], x.cuda())
            want = predict(opts, models["cpu"][0], x)
        card_raw, cpu_raw = raw["cuda"][-1], raw["cpu"][-1]
        out, ref = _logits(card_raw).cpu(), _logits(cpu_raw)
        d_fwd = (out - ref).abs().max().item()
        d_anchor = (card_raw["anchors"].cpu() - cpu_raw["anchors"]).abs().max().item()
        check(bool(torch.isfinite(got.scores).all()) and bool(torch.isfinite(got.boxes).all())
              and d_fwd <= 1e-3 * max(1.0, ref.abs().max().item()) and d_anchor <= 1e-6,
              f"SSD eval predict at {sizes[-1]}: card vs CPU forward {d_fwd}, anchors {d_anchor}")
        with torch.no_grad():
            again = models["cuda"][1]({k: v.cuda() for k, v in cpu_raw.items()})
        labels = (again.labels.cpu() == want.labels).float().mean().item()
        d_s = (again.scores.cpu() - want.scores).abs().max().item()
        d_b = (again.boxes.cpu() - want.boxes).abs().max().item()
        check(labels == 1.0 and d_s <= 1e-6 and d_b <= 1e-5,
              f"SSD eval postprocess at {sizes[-1]}: card vs CPU labels {labels}, scores {d_s}, "
              f"boxes {d_b}")
        worst = [max(w, v) for w, v in zip(worst, (d_fwd, d_anchor, d_s, d_b))]
    check(len(set(sizes)) > 1, f"SSD eval: val images all of one size {sizes}")
    print(f"reference: SSDLite-MobileViT-S eval_detection.predict from checkpoint_last.pt, "
          f"card vs CPU float32 on {len(sizes)} val images at {sizes}: forward max diff "
          f"{worst[0]:.3e}, anchors {worst[1]:.1e}; postprocess of the same outputs: labels "
          f"equal, scores {worst[2]:.1e}, boxes {worst[3]:.1e} | {card}", flush=True)


def phase_ssd_main_train(card: str) -> None:
    """``main_train`` on the detection yaml's flags (``SSD_ARGS`` +
    ``SSD_DATA_ARGS``: SSD crop, photometric distortion, resize to 320², flip,
    host matching, AdamW, EMA, clip 10, bf16) over a seeded COCO folder
    written at run time (``tools/coco_corpus.py``, ``SSD_CORPUS``), 2 epochs
    and their validations; its train loader alone over 2 epochs; then
    ``main_worker_detection`` on its val split (each image at its own size)
    with the run's checkpoint_last.pt, and ``ssd_eval_reference``. Checks
    finite statistics, no CUDA sync debug warning through the port's code
    between log points, mAPs in [0, 1]; prints img/s over epoch 2 after its
    first batch, the loader's alone after its first batch, and the mAPs."""
    import shutil
    import tempfile

    import torch

    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.main_eval import main_worker_detection
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.tools.coco_corpus import write_coco_corpus

    results = os.path.join("results", "ssd_main_train_smoke")
    shutil.rmtree(results, ignore_errors=True)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        n_train, n_val, side = SSD_CORPUS
        write_coco_corpus(root, n_train=n_train, n_val=n_val, max_side=side)
        print(f"ssd: COCO folder of {n_train} + {n_val} JPEG files written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        args = SSD_ARGS + SSD_DATA_ARGS + [
            "--dataset.root-train", root, "--dataset.root-val", root,
            "--scheduler.max-epochs", "2", "--common.results-loc", results]
        log = {"train": [], "val": [], "ema": [], "save_s": 0.0}
        # per epoch: [images after the first batch, first batch's arrival, end]
        watch, built, epochs = SyncWatch(), [], []

        class WatchedTrainer(main_train.Trainer):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                _watch_trainer(self, {}, watch, 0, log)
                step, epoch_fn = self._train_step, self.train_epoch

                def counted(state, batch, *rest):
                    if epochs[-1][1] is None:
                        epochs[-1][1] = time.perf_counter()
                    else:
                        epochs[-1][0] += batch["samples"].shape[0]
                    return step(state, batch, *rest)

                def epoch(e):
                    epochs.append([0, None, None])
                    out = epoch_fn(e)  # ends with a device sync, outside the watch
                    epochs[-1][2] = time.perf_counter()
                    return out

                self._train_step, self.train_epoch = counted, epoch
                built.append(self)

        with watch:
            main_train.Trainer = WatchedTrainer
            try:
                main_train.main_worker(args=args)
            finally:
                main_train.Trainer = WatchedTrainer.__bases__[0]
        trainer = built[0]
        bad = watch.through(MAIN_TRAIN_FILES + (os.path.join("cvnets_tpu_torch", "models")
                                                + os.sep,))
        check(not bad, f"SSD main_train: a host sync between log points: {bad[:3]}")
        for stage in ("train", "val", "ema"):
            values = [v for entry in log[stage] for v in
                      (entry[3] if stage == "train" else entry).values()]
            check(values and all(math.isfinite(v) for v in values),
                  f"SSD main_train: {stage} statistics not finite: {log[stage]}")
        n_steps = trainer.train_iterations
        after_first, first_at, end_at = epochs[-1]
        check(n_steps >= 2 * 16, f"SSD main_train: {n_steps} steps in 2 epochs, want 16+ each")
        ckpt = os.path.join(trainer.save_dir, "checkpoint_last.pt")
        trainer = None
        built.clear()
        gc.collect()

        def check_batch(batch):
            x = batch["samples"]
            check(x.dtype == torch.uint8 and x.is_pinned() and tuple(x.shape) == (32, 3, 320, 320)
                  and batch["targets"]["box_labels"].shape[0] == 32,
                  f"SSD loader: batch {tuple(x.shape)} {x.dtype}")

        opts = get_training_arguments(args=args)
        n_img, secs, first, threads = loader_alone(opts, check_batch)
        loader_img_s = (n_img - 32) / (secs - first)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = main_worker_detection(args=args + ["--model.detection.pretrained", ckpt])
        eval_s = time.perf_counter() - t0
        ssd_eval_reference(card, args, ckpt)
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values()),
          f"SSD main_worker_detection: {res}")
    print(f"main_train: SSDLite-MobileViT-S batch=32 320x320 bf16 epochs=2 steps={n_steps} "
          f"img_s={after_first / (end_at - first_at):.1f} over epoch 2 after its first batch "
          f"({after_first} images in {end_at - first_at:.3f} s; SSD crop, photometric "
          f"distortion, resize, flip and matching on {threads} host threads) "
          f"train={[{k: round(v, 4) for k, v in e[3].items()} for e in log['train']]} "
          f"val={[{k: round(v, 4) for k, v in s.items()} for s in log['val']]} | {card}",
          flush=True)
    print(f"ssd: loader alone img_s={loader_img_s:.1f} after the first batch ({n_img} images "
          f"of up to {SSD_CORPUS[2]} px JPEG files in {secs:.3f} s over 2 epochs, first "
          f"batch after {first:.3f} s; {threads} threads, {os.cpu_count()} cores; pinned "
          f"batches of 32 x 320^2 with matched targets, no step) | {card}", flush=True)
    print(f"eval: SSDLite-MobileViT-S main_worker_detection on {SSD_CORPUS[1]} val images at "
          f"their own sizes in {eval_s:.2f} s: " + " ".join(
              f"{k}={v:.4f}" for k, v in res.items()) + f" | {card}", flush=True)


def clip_text_batch(g, batch: int, device) -> "torch.Tensor":
    """Seeded token rows on ``device``: SOT, random ids, EOT (the largest id)
    at a random place, 5 to 77 tokens in all, zeros after."""
    import torch

    lengths = torch.randint(5, CLIP_CONTEXT + 1, (batch, 1), generator=g, device=device)
    ids = torch.randint(1, CLIP_SOT, (batch, CLIP_CONTEXT), generator=g, device=device)
    text = torch.where(torch.arange(CLIP_CONTEXT, device=device) < lengths - 1, ids, 0)
    text[:, 0] = CLIP_SOT
    return text.scatter_(1, lengths - 1, CLIP_EOT)


def _embedding_diffs(got: dict, ref: dict) -> tuple:
    return tuple((got[k].float().cpu() - ref[k].float().cpu()).abs().max().item()
                 for k in ("image", "text"))


def phase_clip_train(card: str, kernels: dict) -> tuple:
    """CLIP ViT-B/16 train steps with clip_vit.yaml's settings (``CLIP_ARGS``)
    at its batch of 128 × 224² and captions of 77 tokens, seeded on the card:
    12 forward and 12 backward MHA launches a step (the image tower; the
    text tower's causal mask takes the einsum route), finite losses, params
    and EMA moved; then, on the trained model in float32 (TF32 off) on 8
    images and captions, the embeddings through the kernels against the
    plain attention path (1e-4: unit vectors) and against a copy of the model
    on the CPU (1e-3, ``cpu_reference``'s bound). Returns the launches and
    what the A/B phase needs."""
    import copy

    import torch

    from cvnets_tpu_torch.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim import build_optimizer
    from cvnets_tpu_torch.optim.scheduler import build_scheduler
    from cvnets_tpu_torch.options.opts import get_training_arguments

    label = "CLIP ViT-B/16"
    opts = get_training_arguments(args=CLIP_ARGS)
    device = torch.device("cuda:0")
    model = get_model(opts)
    state = create_train_state(
        model, build_optimizer(opts, model, model.get_lr_multipliers(opts)), ema_enabled=True)
    criteria = build_loss_fn(opts)
    train_step = make_train_step(model, criteria, opts, build_metrics(opts, ["loss", "grad_norm"]))
    scheduler = build_scheduler(opts)
    g = torch.Generator(device=device).manual_seed(0)
    batches = [{"samples": {"image": torch.randint(0, 256, (CLIP_BATCH, 3, 224, 224), generator=g,
                                                   device=device, dtype=torch.uint8),
                            "text": clip_text_batch(g, CLIP_BATCH, device)},
                "targets": torch.arange(CLIP_BATCH, device=device)}
               for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    params0 = [p.detach().clone() for p in model.parameters()]
    ema0 = [t.detach().clone() for t in state.ema.model.state_dict().values()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel in kernels.values():
        kernel.launches = 0
    losses, step_s = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, metrics = train_step(state, b, scheduler.retrieve_lr(0, state.step))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: s.item() for m in metrics.values() for k, (s, _) in m.items()})
    launches = {name: kernel.launches for name, kernel in kernels.items()}
    n_steps = len(batches)
    for name, count in launches.items():
        check(count == VIT_BLOCKS * n_steps,
              f"{label}: {count} {name} launches in {n_steps} steps, want {VIT_BLOCKS} a step")
    check(all(math.isfinite(v) for m in losses for v in m.values()),
          f"{label}: losses not finite: {losses}")
    check(any(not torch.equal(a, b) for a, b in zip(params0, model.parameters())),
          f"{label}: params did not change")
    check(any(not torch.equal(a, b) for a, b in zip(ema0, state.ema.model.state_dict().values())),
          f"{label}: EMA did not change")
    del params0, ema0
    timed = step_s[WARMUP_STEPS:]
    parts = {k: [round(m[k], 4) for m in losses] for k in losses[0]}
    print(f"train: {label} batch={CLIP_BATCH} 224x224 + {CLIP_CONTEXT} tokens bf16 "
          f"steps={n_steps} losses={parts} step_s={[round(x, 4) for x in step_s]} "
          f"img_s={CLIP_BATCH * len(timed) / sum(timed):.1f} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"launches={launches} | {card}", flush=True)

    model.eval()
    x = {"image": batches[0]["samples"]["image"][:8].float() / 255.0,
         "text": batches[0]["samples"]["text"][:8]}
    on_cpu = copy.deepcopy(model).cpu()
    with no_tf32(), torch.no_grad():
        with_kernel = model(x)
        set_use_kernel(model, False)
        plain = model(x)
        set_use_kernel(model, True)
        ref = on_cpu({k: v.cpu() for k, v in x.items()})
    for name, out in (("kernel", with_kernel), ("plain", plain)):
        check(all(tuple(out[k].shape) == (8, 512) and bool(torch.isfinite(out[k]).all())
                  for k in ("image", "text")), f"{label}: {name} embeddings' shape or finiteness")
    d_plain, d_cpu = _embedding_diffs(with_kernel, plain), _embedding_diffs(with_kernel, ref)
    check(max(d_plain) <= 1e-4, f"{label}: kernel vs plain embeddings differ by {d_plain}")
    check(max(d_cpu) <= 1e-3, f"{label}: card vs CPU embeddings differ by {d_cpu}")
    print(f"reference: {label} float32 eval embeddings (unit vectors, 8 images and captions): "
          f"kernel path vs plain path max diff image {d_plain[0]:.3e} text {d_plain[1]:.3e}; "
          f"card vs CPU copy image {d_cpu[0]:.3e} text {d_cpu[1]:.3e} | {card}", flush=True)
    return launches, (state, train_step, scheduler, batches, criteria)


def write_clip_corpus(root: str) -> dict:
    """``write_jpeg_corpus`` under ``root`` with a flickr manifest for each
    split (``clip_train``, ``clip_val``: a seeded caption a file, its path
    relative to the manifest) and a class-names file for the val folder's 8
    classes (``class_names``)."""
    import numpy as np

    corpus = write_jpeg_corpus(root, seed=1)
    rng = np.random.default_rng(1)
    for split in ("train", "val"):
        folder = os.path.join(root, f"clip_{split}")
        os.makedirs(folder)
        files = sorted(p for p in corpus["kinds"] if p.startswith(corpus[split] + os.sep))
        with open(os.path.join(folder, "captions.tsv"), "w") as f:
            for path in files:
                words = [w[int(rng.integers(len(w)))] for w in CLIP_WORDS]
                f.write(f"{os.path.relpath(path, folder)}\ta photo of a {' '.join(words)}\n")
        corpus[f"clip_{split}"] = folder
    corpus["class_names"] = os.path.join(root, "class_names.txt")
    with open(corpus["class_names"], "w") as f:
        f.write("\n".join(CLIP_CLASS_NAMES) + "\n")
    return corpus


def clip_eval_reference(card: str, args: list, ckpt: str, n_images: int = 3) -> None:
    """The zero-shot route's logits (``evaluation_engine.class_embeddings``
    and the model's ``zero_shot_image_logits``) from the run's checkpoint on
    the card against the same on a CPU copy built from the same file, on the
    first ``n_images`` images of the zero-shot set, float32 with TF32 off:
    the class embeddings within 1e-3 (unit vectors) and the logits within
    1e-3 of max(1, the largest logit), ``cpu_reference``'s bound."""
    import torch

    from cvnets_tpu_torch.data.data_loaders import create_test_loader
    from cvnets_tpu_torch.engine.evaluation_engine import class_embeddings
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_eval_arguments
    from cvnets_tpu_torch.utils.checkpoint_utils import load_model_weights

    opts = get_eval_arguments(args=args)
    setattr(opts, "common.mixed_precision", False)
    loader = create_test_loader(opts, pin_memory=False)
    tokens = loader.dataset.class_caption_tokens()
    images = next(iter(loader))["samples"][:n_images].float() / 255.0
    weights = load_model_weights(ckpt)
    out = {}
    for dev in ("cuda", "cpu"):
        model = get_model(opts, device=dev)
        model.load_state_dict(weights)
        with no_tf32(), torch.no_grad():
            emb = class_embeddings(opts, model, tokens, torch.device(dev))
            logits = model.eval()({"image": images.to(dev), "text": emb})
        out[dev] = (emb.cpu(), logits["zero_shot_image_logits"].cpu())
    d_emb = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    d_logit = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    scale = out["cpu"][1].abs().max().item()
    check(tuple(out["cuda"][1].shape) == (n_images, len(CLIP_CLASS_NAMES))
          and bool(torch.isfinite(out["cuda"][1]).all()), "CLIP zero-shot logits shape")
    check(d_emb <= 1e-3 and d_logit <= 1e-3 * max(1.0, scale),
          f"CLIP zero-shot card vs CPU: class embeddings {d_emb}, logits {d_logit}")
    print(f"reference: CLIP ViT-B/16 zero-shot from checkpoint_last.pt, card vs CPU float32 "
          f"on {n_images} images x {tokens.shape[0]} classes ({tokens.shape[1]} captions a "
          f"class): class embeddings max diff {d_emb:.3e}, logits {d_logit:.3e} (max |logit| "
          f"{scale:.3f}) | {card}", flush=True)


def phase_clip_main_train(card: str, kernels: dict, bare: dict) -> None:
    """``main_train`` on clip_vit.yaml's flags (``CLIP_MAIN_TRAIN_ARGS``:
    flickr manifests over a seeded JPEG corpus written at run time, Pillow
    and random resized crop bilinear a sample, the CLIP tokenizer's fallback
    in the producer thread, AdamW, EMA, clip 1.0, bf16), 2 epochs of 16
    steps, each validated with the loss and the retrieval recalls (EMA too);
    its train loader alone over 2 epochs; ``main_eval`` zero-shot over the
    val folder's 8 classes with a class-names file from the run's
    checkpoint_last.pt, then ``clip_eval_reference``. Checks 12 + 12 MHA
    launches a train step and 12 an eval forward, finite statistics and
    recalls in [0, 100], no CUDA sync debug warning through the port's code
    between log points, a top-1 and top-5 in [0, 100]; prints img/s over
    epoch 2 after its first batch beside the loader's and the bare step's."""
    import shutil
    import tempfile

    import torch

    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.engine.train_state import batch_size
    from cvnets_tpu_torch.main_eval import main_worker as main_eval
    from cvnets_tpu_torch.options.opts import get_training_arguments

    label = "CLIP ViT-B/16"
    results = os.path.join("results", "clip_main_train_smoke")
    shutil.rmtree(results, ignore_errors=True)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        corpus = write_clip_corpus(root)
        print(f"clip: flickr corpus of {NATIVE_TRAIN} + {NATIVE_CLASSES * NATIVE_VAL_PER_CLASS} "
              f"JPEG files with seeded captions written in {time.perf_counter() - t0:.2f} s",
              flush=True)
        args = CLIP_MAIN_TRAIN_ARGS + ["--dataset.root-train", corpus["clip_train"],
                                       "--dataset.root-val", corpus["clip_val"],
                                       "--common.results-loc", results]
        log = {"train": [], "val": [], "ema": [], "save_s": 0.0}
        watch, built, epochs = SyncWatch(), [], []

        class WatchedTrainer(main_train.Trainer):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                _watch_trainer(self, kernels, watch, VIT_BLOCKS, log)
                step, epoch_fn = self._train_step, self.train_epoch

                def counted(state, batch, *rest):
                    if epochs[-1][1] is None:
                        epochs[-1][1] = time.perf_counter()
                    else:
                        epochs[-1][0] += batch_size(batch["samples"])
                    return step(state, batch, *rest)

                def epoch(e):
                    epochs.append([0, None, None])
                    out = epoch_fn(e)  # ends with a device sync, outside the watch
                    epochs[-1][2] = time.perf_counter()
                    return out

                self._train_step, self.train_epoch = counted, epoch
                built.append(self)

        with watch:
            main_train.Trainer = WatchedTrainer
            try:
                main_train.main_worker(args=args)
            finally:
                main_train.Trainer = WatchedTrainer.__bases__[0]
        trainer = built[0]
        bad = watch.through(MAIN_TRAIN_FILES + (os.path.join("cvnets_tpu_torch", "models")
                                                + os.sep,))
        check(not bad, f"{label} main_train: a host sync between log points: {bad[:3]}")
        for stage in ("train", "val", "ema"):
            values = [v for entry in log[stage] for v in
                      (entry[3] if stage == "train" else entry).values()]
            check(values and all(math.isfinite(v) for v in values),
                  f"{label} main_train: {stage} statistics not finite: {log[stage]}")
        recalls = [v for s in log["val"] + log["ema"] for k, v in s.items()
                   if k.startswith("image_text_retrieval")]
        check(len(recalls) == 4 * 6 and all(0.0 <= v <= 100.0 for v in recalls),
              f"{label} main_train: retrieval recalls {recalls}")
        n_steps = trainer.train_iterations
        after_first, first_at, end_at = epochs[-1]
        check(n_steps == 32, f"{label} main_train: {n_steps} steps, want 2 epochs of 16")
        ckpt = os.path.join(trainer.save_dir, "checkpoint_last.pt")
        trainer = None
        built.clear()
        gc.collect()
        torch.cuda.empty_cache()

        def check_batch(batch):
            x, text = batch["samples"]["image"], batch["samples"]["text"]
            check(x.dtype == torch.uint8 and x.is_pinned() and text.is_pinned()
                  and tuple(x.shape) == (CLIP_BATCH, 3, 224, 224)
                  and tuple(text.shape) == (CLIP_BATCH, CLIP_CONTEXT),
                  f"{label} loader: batch {tuple(x.shape)} {x.dtype}, text {tuple(text.shape)}")

        opts = get_training_arguments(args=args)
        n_img, secs, first, threads = loader_alone(opts, check_batch)
        loader_img_s = (n_img - CLIP_BATCH) / (secs - first)
        eval_args = CLIP_ARGS + [
            "--dataset.name", "imagenet_zero_shot", "--dataset.root-val", corpus["val"],
            "--dataset.eval-batch-size0", "100",
            "--dataset.zero-shot.class-names-file", corpus["class_names"],
            "--model.multi-modal-image-text.pretrained", ckpt]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = main_eval(args=eval_args)
        eval_s = time.perf_counter() - t0
        check(set(res) == {"top1", "top5"} and all(0.0 <= v <= 100.0 for v in res.values()),
              f"{label} main_eval zero-shot: {res}")
        clip_eval_reference(card, eval_args, ckpt)
    print(f"main_train: {label} batch={CLIP_BATCH} 224x224 + {CLIP_CONTEXT} tokens bf16 "
          f"epochs=2 steps={n_steps} img_s={after_first / (end_at - first_at):.1f} over epoch "
          f"2 after its first batch ({after_first} images in {end_at - first_at:.3f} s; Pillow, "
          f"random resized crop and tokenizer on {threads} host threads) bare step "
          f"{bare['img_s']:.1f} img/s "
          f"train={[{k: round(v, 4) for k, v in e[3].items()} for e in log['train']]} "
          f"val={[{k: round(v, 2) for k, v in s.items()} for s in log['val']]} | {card}",
          flush=True)
    print(f"clip: loader alone img_s={loader_img_s:.1f} after the first batch ({n_img} images "
          f"of ~500x375 JPEG files in {secs:.3f} s over 2 epochs, first batch after "
          f"{first:.3f} s; {threads} threads, {os.cpu_count()} cores; pinned batches of 128 x "
          f"224^2 and their tokens, no step) | {card}", flush=True)
    print(f"eval: {label} main_eval zero-shot on {NATIVE_CLASSES * NATIVE_VAL_PER_CLASS} "
          f"images x {NATIVE_CLASSES} classes (80 captions a class) in {eval_s:.2f} s: "
          + " ".join(f"{k}={v:.2f}" for k, v in res.items()) + f" | {card}", flush=True)


def phase_clip(card: str) -> dict:
    """Phase 19, CLIP ViT-B/16: train (with the kernel/plain and CPU checks),
    a/b, steady steps, a profile split into the image tower, the text tower
    (and its einsum attention), the loss and the optimizer, then main_train,
    its loader, main_eval zero-shot and its CPU check. Returns the MHA
    kernels' launches in the train phase."""
    import torch

    from cvnets_tpu_torch.engine.train_state import OPTIMIZER_RANGE
    from cvnets_tpu_torch.layers.multi_head_attention import EINSUM_ROUTE
    from cvnets_tpu_torch.loss.multi_modal import LOSS_RANGE
    from cvnets_tpu_torch.models.multi_modal.clip import IMAGE_TOWER, TEXT_TOWER
    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel

    label = "CLIP ViT-B/16"
    kernels = {"mha_attention_fwd": mha_fwd_kernel, "mha_attention_bwd": mha_bwd_kernel}
    launches, run = phase_clip_train(card, kernels)
    bare = phase_ab(card, label, run)
    phase_steady(card, label, run)
    phase_profile(card, label, run, os.path.join("results", "clip_profile.txt"),
                  route=EINSUM_ROUTE, split=(IMAGE_TOWER, TEXT_TOWER, LOSS_RANGE),
                  ranges=(OPTIMIZER_RANGE,))
    run = None
    gc.collect()
    torch.cuda.empty_cache()
    phase_clip_main_train(card, {"fwd": mha_fwd_kernel, "bwd": mha_bwd_kernel}, bare)
    return launches


def phase_families(card: str) -> None:
    """Phase 18: MobileViT-S (train, 24 steady steps, profile, the einsum
    attention's share of the step), MobileViT-XXS (its layer 3 through the
    MHA kernels at D = 16: launches, logits and grads against the plain path,
    a/b), FastViT-T8 (train, steady), SSDLite-MobileViT-S (train, steady,
    profile, predict, main_train and main_worker_detection). Each model
    without a kernel is held against its copy on the CPU."""
    import torch

    from cvnets_tpu_torch.layers.multi_head_attention import EINSUM_ROUTE
    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel

    def release() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    _, run = phase_train(card, "MobileViT-S", MOBILEVIT_ARGS, {}, {})
    phase_steady(card, "MobileViT-S", run)
    # the einsum attention of layers 3-5 (D = 36, 48, 60; 9 blocks)
    phase_profile(card, "MobileViT-S", run, os.path.join("results", "mobilevit_s_profile.txt"),
                  route=EINSUM_ROUTE)
    run = None
    release()
    mha = {"mha_attention_fwd": mha_fwd_kernel, "mha_attention_bwd": mha_bwd_kernel}
    _, run = phase_train(card, "MobileViT-XXS", MOBILEVIT_XXS_ARGS, mha,
                         {name: XXS_MHA_BLOCKS for name in mha})
    phase_xxs_kernel_grads(card, run)
    phase_ab(card, "MobileViT-XXS", run)
    run = None
    release()
    _, run = phase_train(card, "FastViT-T8", FASTVIT_ARGS, {}, {})
    phase_steady(card, "FastViT-T8", run)
    run = None
    release()
    _, run = phase_train(card, "SSDLite-MobileViT-S", SSD_ARGS, {}, {})
    phase_steady(card, "SSDLite-MobileViT-S", run)
    phase_profile(card, "SSDLite-MobileViT-S", run,
                  os.path.join("results", "ssd_profile.txt"))
    phase_ssd_predict(card, run)
    run = None
    release()
    phase_ssd_main_train(card)
    release()


def phase_deeplab(card: str) -> tuple:
    """DeepLabv3's train, a/b and profile phases; returns the launch counts and
    the kernel path's a/b (img/s, peak GiB)."""
    from cvnets_tpu_torch.ops.seg_ce_kernel import seg_ce_bwd_kernel, seg_ce_fwd_kernel
    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_bwd_kernel,
        separable_attention_kernel,
    )

    sep = {"separable_attention": separable_attention_kernel,
           "separable_attention_bwd": separable_attention_bwd_kernel}
    launches, run = phase_train(
        card, "DeepLabv3-MobileViTv2-1.0", DEEPLAB_ARGS,
        {"seg_ce_fwd": seg_ce_fwd_kernel, "seg_ce_bwd": seg_ce_bwd_kernel, **sep},
        {"seg_ce_fwd": SEG_CALLS, "seg_ce_bwd": SEG_CALLS,
         **{name: sum(SEP_DEEPLAB[1].values()) for name in sep}})
    bare = phase_ab(card, "DeepLabv3-MobileViTv2-1.0", run)
    phase_profile(card, "DeepLabv3-MobileViTv2-1.0", run,
                  os.path.join("results", "deeplab_profile.txt"))
    return launches, bare


# ---- RangeAugment, distillation and the schedulers (phase 20) ----
# examples/range_augment/distillation/teacher_resnet101_student_mobilenet_v2.yaml,
# as flags: MobileNetV2-1.0 with the distribution augmentor (brightness,
# contrast, noise), a ResNet-101 teacher, SGD, cosine LR, EMA, bf16, at the
# variable batch sampler's base size (256 × 224²) for the bare steps; the
# composite loss is the yaml's list, which no flag carries
# (``RANGE_AUGMENT_COMPOSITE``, set by ``range_augment_opts``)
RANGE_AUGMENT_ARGS = [
    "--model.classification.name", "mobilenetv2",
    "--model.classification.mobilenetv2.width-multiplier", "1.0",
    "--model.learn-augmentation.mode", "distribution",
    "--model.learn-augmentation.brightness",
    "--model.learn-augmentation.contrast",
    "--model.learn-augmentation.noise",
    "--model.normalization.name", "batch_norm",
    "--model.normalization.momentum", "0.1",
    "--model.activation.name", "relu6",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "normal",
    "--teacher.model.classification.name", "resnet",
    "--teacher.model.classification.resnet.depth", "101",
    "--teacher.model.normalization.name", "batch_norm",
    "--teacher.model.normalization.momentum", "0.1",
    "--teacher.model.activation.name", "relu",
    "--teacher.model.layer.global-pool", "mean",
    "--teacher.model.layer.conv-init", "kaiming_normal",
    "--teacher.model.layer.linear-init", "normal",
    "--loss.category", "composite_loss",
    "--optim.name", "sgd",
    "--optim.weight-decay", "4e-5",
    "--optim.no-decay-bn-filter-bias",
    "--optim.sgd.momentum", "0.9",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "300",
    "--scheduler.warmup-iterations", "7500",
    "--scheduler.warmup-init-lr", "0.05",
    "--scheduler.cosine.max-lr", "0.4",
    "--scheduler.cosine.min-lr", "2e-4",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--common.mixed-precision",
    "--dataset.category", "classification",
    "--dataset.train-batch-size0", "256",
    "--sampler.bs.crop-size-width", "224",
    "--sampler.bs.crop-size-height", "224",
    "--common.seed", "0",
]
RANGE_AUGMENT_COMPOSITE = [
    {"loss_category": "distillation", "loss_weight": 1.0,
     "distillation": {"name": "soft_kl_loss", "soft_kl_loss": {"temperature": 1.0}}},
    {"loss_category": "neural_augmentation", "loss_weight": 1.0,
     "neural_augmentation": {"perceptual_metric": "psnr", "target_value": [40, 20],
                             "curriculum_method": "cosine"}},
]
# the rest of the yaml: its loader, variable batch sampler, host transforms and
# stats, for main_train (dataset.name and its roots are the yaml's ImageNet on
# disk; the phase names the JPEG corpus instead)
RANGE_AUGMENT_DATA_ARGS = IMAGENET_RUN_ARGS + [
    "--dataset.workers", "8",
    "--sampler.name", "variable_batch_sampler",
    "--sampler.vbs.crop-size-width", "224",
    "--sampler.vbs.crop-size-height", "224",
    "--sampler.vbs.max-n-scales", "5",
    "--sampler.vbs.min-crop-size-width", "128",
    "--sampler.vbs.max-crop-size-width", "320",
    "--sampler.vbs.min-crop-size-height", "128",
    "--sampler.vbs.max-crop-size-height", "320",
    "--sampler.vbs.check-scale", "32",
    "--image-augmentation.random-resized-crop.enable",
    "--image-augmentation.random-resized-crop.interpolation", "bilinear",
    "--image-augmentation.random-horizontal-flip.enable",
    "--image-augmentation.resize.enable",
    "--image-augmentation.resize.size", "232",
    "--image-augmentation.center-crop.enable",
    "--image-augmentation.center-crop.size", "224",
]
TEACHER_SEED = 101  # the seed of the teacher whose checkpoint phase 20 writes
# config/classification/finetune_higher_res_in1k/mobilevit_v2.yaml, as flags:
# MobileViTv2-2.0 at 384², batch 32, SGD at a fixed LR of 1e-3 after a warmup
# of 500 iterations from 1e-6, label smoothing 0.1, EMA, bf16;
# ``--common.finetune`` is the 256² checkpoint the phase writes
FINETUNE_ARGS = [
    "--model.classification.name", "mobilevit_v2",
    "--model.classification.mitv2.width-multiplier", "2.0",
    "--model.normalization.name", "batch_norm",
    "--model.normalization.momentum", "0.1",
    "--model.activation.name", "swish",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--loss.category", "classification",
    "--loss.classification.name", "cross_entropy",
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "sgd",
    "--optim.weight-decay", "4e-5",
    "--optim.no-decay-bn-filter-bias",
    "--optim.sgd.momentum", "0.9",
    "--scheduler.name", "fixed",
    "--scheduler.max-epochs", "10",
    "--scheduler.warmup-iterations", "500",
    "--scheduler.warmup-init-lr", "1e-6",
    "--scheduler.fixed.lr", "1e-3",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--common.mixed-precision",
    "--dataset.category", "classification",
    "--dataset.train-batch-size0", "32",
    "--sampler.name", "batch_sampler",
    "--sampler.bs.crop-size-width", "384",
    "--sampler.bs.crop-size-height", "384",
    "--common.seed", "0",
]
# separable attention of MobileViTv2-2.0 at 384²: (BP, {(N, C): blocks a step})
SEP_FINETUNE = (32 * 4, {(576, 256): 2, (144, 384): 4, (36, 512): 3})
# the Trainer on the finetune flags with a multi_step schedule: 2 epochs of 3
# pinned batches of 8 × 384² (and 1 val batch), warmup 2, the LR ×0.1 at epoch 1
SCHEDULER_ARGS = FINETUNE_ARGS + [
    "--dataset.train-batch-size0", "8",
    "--dataset.val-batch-size0", "8",
    "--scheduler.name", "multi_step",
    "--scheduler.multi-step.lr", "0.01",
    "--scheduler.multi-step.gamma", "0.1",
    "--scheduler.multi-step.milestones", "1",
    "--scheduler.warmup-iterations", "2",
    "--scheduler.max-epochs", "2",
    "--common.log-freq", "2",
]


def range_augment_opts(args):
    """The options of ``args`` with the RangeAugment yaml's composite loss."""
    import copy

    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=args)
    setattr(opts, "loss.composite_loss", copy.deepcopy(RANGE_AUGMENT_COMPOSITE))
    return opts


def write_teacher_checkpoint(path: str, extra=()) -> None:
    """A seeded ResNet-101 (the teacher options of ``RANGE_AUGMENT_ARGS`` and
    ``extra``) as a checkpoint of the port: its model state dict, with its BN
    statistics set to their averages over 4 seeded batches of 32 images.
    With the init's statistics (mean 0, variance 1) its eval-mode features
    grow through the 33 blocks until one class wins on every image, which a
    student matches in a step (a KL of 0 thereafter)."""
    import torch

    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.utils import extract_opts_with_prefix_replacement

    opts = range_augment_opts(RANGE_AUGMENT_ARGS + list(extra))
    teacher_opts = extract_opts_with_prefix_replacement(opts, "teacher.model.", "model.")
    teacher = get_model(teacher_opts, category="classification",
                        generator=torch.Generator().manual_seed(TEACHER_SEED))
    norms = [m for m in teacher.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None  # a cumulative average
    g = torch.Generator(device="cuda").manual_seed(TEACHER_SEED)
    with torch.no_grad():
        teacher.train()
        for _ in range(4):
            teacher(torch.rand((32, 3, 224, 224), generator=g, device="cuda"))
    torch.save(teacher.state_dict(), path)


def range_augment_reference(card: str, label: str, model, criteria, x) -> None:
    """The student's float32 train forward (augmentor on the same draws, classifier dropout
    off) and the composite's terms on the card (TF32 off) against copies of the
    model and the loss on the CPU, on a small batch: logits and each term within
    1e-3 of max(1, |reference|) (``cpu_reference``'s bound)."""
    import copy

    import torch

    on_card, on_cpu = copy.deepcopy(model).train(), copy.deepcopy(model).cpu().train()
    for m in (*on_card.modules(), *on_cpu.modules()):  # the two would draw other masks
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    cpu_criteria = copy.deepcopy(criteria)
    for fn in cpu_criteria.loss_fns.values():
        if hasattr(fn, "teacher"):
            fn.teacher = fn.teacher.cpu()
    draws = on_cpu.neural_augmentor.draw(x.cpu(), torch.Generator().manual_seed(1))
    card_draws = {name: {k: None if t is None else t.cuda() for k, t in d.items()}
                  for name, d in draws.items()}
    y = torch.arange(x.shape[0]) * 7
    kw = {"training": True, "epoch": 0, "iterations": 0}
    with no_tf32(), torch.no_grad():
        got = on_card(x, augmentation_draws=card_draws)
        got_terms = criteria(x, got, y.cuda(), **kw)
        ref = on_cpu(x.cpu(), augmentation_draws=draws)
        ref_terms = cpu_criteria(x.cpu(), ref, y, **kw)
    diff = (got["logits"].cpu() - ref["logits"]).abs().max().item()
    scale = ref["logits"].abs().max().item()
    check(bool(torch.isfinite(got["logits"]).all()) and diff <= 1e-3 * max(1.0, scale),
          f"{label}: card vs CPU train logits differ by {diff}")
    terms = {k: (got_terms[k].item(), ref_terms[k].item()) for k in ref_terms}
    for key, (a, b) in terms.items():
        check(math.isfinite(a) and abs(a - b) <= 1e-3 * max(1.0, abs(b)),
              f"{label}: {key} card {a} vs CPU {b}")
    print(f"reference: {label} card vs CPU float32 train forward ({x.shape[0]} images, the "
          f"same draws): logits max diff {diff:.3e} (max |logit| {scale:.3e}); " + " ".join(
              f"{k}={a:.6f}/{b:.6f}" for k, (a, b) in terms.items()) + f" | {card}", flush=True)


def phase_range_augment_train(card: str, teacher_ckpt: str) -> tuple:
    """Phase 20a: bare train steps of the RangeAugment distillation recipe
    (``RANGE_AUGMENT_ARGS``, the teacher from ``teacher_ckpt``) at 256 × 224²
    on seeded uint8 batches: finite losses (total, soft KL, neural
    augmentation), a nonzero grad on every augmentor scalar, params and EMA
    moved, the teacher's tensors unchanged and outside the optimizer and the
    EMA; the student's eval logits and its train forward with the composite's
    terms against CPU copies. Returns what ``phase_steady`` and
    ``phase_profile`` take."""
    import torch

    from cvnets_tpu_torch.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim import build_optimizer
    from cvnets_tpu_torch.optim.scheduler import build_scheduler

    label = "RangeAugment MobileNetV2-1.0 <- ResNet-101"
    opts = range_augment_opts(RANGE_AUGMENT_ARGS + [
        "--teacher.model.classification.pretrained", teacher_ckpt])
    device = torch.device("cuda:0")
    model = get_model(opts)
    state = create_train_state(
        model, build_optimizer(opts, model, model.get_lr_multipliers(opts)), ema_enabled=True)
    criteria = build_loss_fn(opts)
    teacher = criteria.loss_fns["distillation"].teacher
    teacher0 = {k: v.clone() for k, v in teacher.state_dict().items()}
    train_step = make_train_step(model, criteria, opts, build_metrics(opts, ["loss", "grad_norm"]))
    scheduler = build_scheduler(opts)
    batch = getattr(opts, "dataset.train_batch_size0")
    g = torch.Generator(device=device).manual_seed(0)
    batches = [{"samples": torch.randint(0, 256, (batch, 3, 224, 224), generator=g,
                                         device=device, dtype=torch.uint8),
                "targets": torch.randint(0, 1000, (batch,), generator=g, device=device)}
               for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    params0 = [p.detach().clone() for p in model.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, host_s = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        state, metrics = train_step(state, b, scheduler.retrieve_lr(0, state.step))
        host_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: s.item() for m in metrics.values() for k, (s, _) in m.items()})
    parts = {k: [round(m[k], 4) for m in losses] for k in losses[0]}
    check({"loss", "loss.distillation", "loss.neural_augmentation"} <= set(parts)
          and all(math.isfinite(v) for m in losses for v in m.values()),
          f"{label}: losses {parts}")
    aug_grads = {n: p.grad for n, p in model.named_parameters() if "neural_augmentor" in n}
    check(len(aug_grads) == 6 and all(
        g is not None and bool(torch.isfinite(g)) and g.item() != 0.0
        for g in aug_grads.values()), f"{label}: augmentor grads {aug_grads}")
    check(any(not torch.equal(a, b) for a, b in zip(params0, model.parameters())),
          f"{label}: params did not change")
    del params0
    changed = [k for k, v in teacher.state_dict().items() if not torch.equal(v, teacher0[k])]
    check(not changed, f"{label}: the teacher changed: {changed[:3]}")
    teacher_ptrs = {t.data_ptr() for t in teacher.state_dict().values()}
    in_state = {p.data_ptr() for grp in state.optimizer.param_groups for p in grp["params"]}
    in_state |= {t.data_ptr() for t in state.ema.model.state_dict().values()}
    check(not teacher_ptrs & in_state and not teacher.training
          and not any(p.requires_grad for p in teacher.parameters()),
          f"{label}: the teacher is in the optimizer or the EMA, or trains")
    del teacher0
    timed, host = step_s[WARMUP_STEPS:], host_s[WARMUP_STEPS:]
    print(f"train: {label} batch={batch} 224x224 bf16 steps={len(batches)} losses={parts} "
          f"step_s={[round(x, 4) for x in step_s]} "
          f"step_ms={1e3 * statistics.median(timed):.3f} "
          f"img_s={batch * len(timed) / sum(timed):.1f} "
          f"host_enqueue_ms={1e3 * statistics.median(host):.3f} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"augmentor_grads={ {n.split('.')[-1]: round(g.item(), 6)
                               for n, g in aug_grads.items()} } "
          f"(the variable batch sampler's base size stands in for its 128-320 px scales) "
          f"| {card}", flush=True)
    x = batches[0]["samples"][:4].float() / 255.0
    cpu_reference(label + " student", model, x, (4, 1000))
    range_augment_reference(card, label, model, criteria, x)
    return state, train_step, scheduler, batches, criteria


def phase_range_augment_main_train(card: str, bare: dict) -> None:
    """Phase 20b: ``main_train.main`` on the RangeAugment distillation yaml's
    flags and composite (the teacher from a checkpoint of a seeded ResNet-101
    with the corpus's 8 classes: the dataset sets the student's count, and
    the yaml's teacher and ImageNet share theirs), its variable
    batch sampler, random resized crop and flip through ``--dataset.decoder
    native`` on phase 17's seeded JPEG corpus, 2 epochs with validation (the
    composite's loss, top-1, top-5; EMA too); the train loader alone beside
    it. Checks one crop kernel launch a train batch, finite statistics, a
    top-1 in [0, 100], no CUDA sync debug warning through the port's code
    between log points; prints img/s over epoch 2 after its first batch."""
    import shutil
    import tempfile

    import torch

    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.engine.train_state import batch_size
    from cvnets_tpu_torch.native import crop_resize_flip_kernel

    label = "RangeAugment MobileNetV2-1.0 <- ResNet-101"
    results = os.path.join("results", "range_augment_main_train")
    shutil.rmtree(results, ignore_errors=True)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        corpus = write_jpeg_corpus(root)
        print(f"range_augment: corpus of {len(corpus['kinds'])} JPEG files written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        classes = ["--teacher.model.classification.n-classes", str(NATIVE_CLASSES)]
        teacher_ckpt = os.path.join(root, "resnet101_teacher_8.pt")
        write_teacher_checkpoint(teacher_ckpt, classes)
        args = (RANGE_AUGMENT_ARGS + RANGE_AUGMENT_DATA_ARGS + corpus_args(corpus) + classes
                + ["--common.results-loc", results,
                   "--teacher.model.classification.pretrained", teacher_ckpt])
        log = {"train": [], "val": [], "ema": [], "save_s": 0.0}
        watch, built, epochs = SyncWatch(), [], []

        class WatchedTrainer(main_train.Trainer):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                _watch_trainer(self, {}, watch, 0, log)
                step, epoch_fn = self._train_step, self.train_epoch

                def counted(state, batch, *rest):
                    if epochs[-1][1] is None:
                        epochs[-1][1] = time.perf_counter()
                    else:
                        epochs[-1][0] += batch_size(batch["samples"])
                    return step(state, batch, *rest)

                def epoch(e):
                    epochs.append([0, None, None])
                    out = epoch_fn(e)  # ends with a device sync, outside the watch
                    epochs[-1][2] = time.perf_counter()
                    return out

                self._train_step, self.train_epoch = counted, epoch
                built.append(self)

        with watch:
            main_train.Trainer = WatchedTrainer
            try:
                crop_resize_flip_kernel.launches = 0
                main_train.main(range_augment_opts(args))
                launches = crop_resize_flip_kernel.launches
            finally:
                main_train.Trainer = WatchedTrainer.__bases__[0]
        trainer = built[0]
        n_steps = trainer.train_iterations
        bad = watch.through(MAIN_TRAIN_FILES + (os.path.join("cvnets_tpu_torch", "models")
                                                + os.sep,))
        check(not bad, f"{label} main_train: a host sync between log points: {bad[:3]}")
        check(launches == n_steps > 0, f"{label} main_train: {launches} crop_resize_flip "
                                       f"launches in {n_steps} train steps")
        for stage in ("train", "val", "ema"):
            values = [v for entry in log[stage] for v in
                      (entry[3] if stage == "train" else entry).values()]
            check(values and all(math.isfinite(v) for v in values),
                  f"{label} main_train: {stage} statistics not finite: {log[stage]}")
        top1 = [s["top1"] for s in log["val"] + log["ema"]]
        check(len(top1) == 4 and all(0.0 <= v <= 100.0 for v in top1),
              f"{label} main_train: val top-1 {top1}")
        after_first, first_at, end_at = epochs[-1]
        trainer = None
        built.clear()
        gc.collect()
        torch.cuda.empty_cache()

        sizes = []

        def check_batch(batch):
            x = batch["samples"]
            check(x.is_cuda and x.dtype == torch.uint8 and x.shape[1] == 3,
                  f"{label} loader: batch {tuple(x.shape)} {x.dtype} on {x.device}")
            sizes.append(x.shape[0])

        n_img, secs, first, threads = loader_alone(range_augment_opts(args), check_batch)
    print(f"main_train: {label} --dataset.decoder native epochs=2 steps={n_steps} "
          f"img_s={after_first / (end_at - first_at):.1f} over epoch 2 after its first batch "
          f"({after_first} images in {end_at - first_at:.3f} s; the variable batch sampler's "
          f"128-320 px scales) bare step {bare['img_s']:.1f} img/s at 256 x 224^2 "
          f"train={[{k: round(v, 4) for k, v in e[3].items()} for e in log['train']]} "
          f"val={[{k: round(v, 3) for k, v in s.items()} for s in log['val']]} "
          f"ema={[{k: round(v, 3) for k, v in s.items()} for s in log['ema']]} | {card}",
          flush=True)
    print(f"range_augment: loader alone img_s={(n_img - sizes[0]) / (secs - first):.1f} after "
          f"the first batch ({n_img} images in {secs:.3f} s over 2 epochs, first batch after "
          f"{first:.3f} s; native decode, {threads} threads, {os.cpu_count()} cores; no step) "
          f"| {card}", flush=True)


def phase_finetune(card: str) -> tuple:
    """Phase 20c: MobileViTv2-2.0 384² finetune steps (``FINETUNE_ARGS``,
    ``--common.finetune`` from a 256² checkpoint of a seeded MobileViTv2-2.0 written
    here): 9 forward and 9 backward separable-attention launches a step at (N, C) =
    (576, 256) ×2, (144, 384) ×4 and (36, 512) ×3 over BP = 32·4 (a layer that left
    the kernel route fails the counts), then steady steps and a profile
    (results/mobilevit_v2_finetune_profile.txt, with the separable kernels' device
    time a step); each shape's forward and backward kernel held against its plain
    version and timed beside it and its bound, as phase 3 does the flagship's.
    Returns the launches of the train steps and the kernels' records at this path
    (one step's 9 + 9)."""
    import collections
    import tempfile

    import torch

    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_bwd_kernel,
        separable_attention_kernel,
        separable_attention_plain,
    )

    label = "MobileViTv2-2.0 384^2 finetune"
    kernels = {"separable_attention": separable_attention_kernel,
               "separable_attention_bwd": separable_attention_bwd_kernel}
    bp, blocks = SEP_FINETUNE
    shapes = {name: collections.Counter() for name in kernels}

    def recording(name, launch):
        def wrapped(device, *args):  # (ptrs, strides, stats, ctx, BP, N, C, dtype)
            shapes[name][tuple(args[4:7])] += 1
            return launch(device, *args)
        return wrapped

    with tempfile.TemporaryDirectory() as root:
        ckpt = os.path.join(root, "mobilevit_v2_2.0_256.pt")
        opts = get_training_arguments(args=FINETUNE_ARGS)
        torch.save(get_model(opts, generator=torch.Generator().manual_seed(256)).state_dict(),
                   ckpt)
        for name, kernel in kernels.items():
            kernel.launch = recording(name, kernel.launch)
        try:
            launches, run = phase_train(card, label, FINETUNE_ARGS + ["--common.finetune", ckpt],
                                        kernels, {name: sum(blocks.values()) for name in kernels})
        finally:
            for kernel in kernels.values():
                del kernel.launch  # the class's method again
    n_steps = WARMUP_STEPS + TIMED_STEPS
    want = {(bp, n, c): count * n_steps for (n, c), count in blocks.items()}
    for name in kernels:
        got = {s: k for s, k in shapes[name].items() if s[0] == bp}
        check(got == want, f"{label}: {name} launches by (BP, N, C) {got}, want {want}")
    print(f"kernel: {label} launches by (BP, N, C) in {n_steps} train steps: "
          f"{dict(shapes['separable_attention'])} forward, "
          f"{dict(shapes['separable_attention_bwd'])} backward | {card}", flush=True)
    phase_steady(card, label, run)
    path = os.path.join("results", "mobilevit_v2_finetune_profile.txt")
    phase_profile(card, label, run, path)
    device = {"fwd": [0.0, 0], "bwd": [0.0, 0]}  # the separable kernels' ms and launches
    with open(path) as f:
        for line in f:
            for part in device:
                if f"separable_attention_{part}_kernel" in line:
                    ms, _, count = line.split()[:3]
                    device[part][0] += float(ms)
                    device[part][1] += int(count.rstrip("x"))
    check(all(n == sum(blocks.values()) for _, n in device.values()),
          f"{label}: the profile's separable launches a step {device}")
    print(f"profile: {label} separable kernels' device time a step: " + "; ".join(
        f"{part} {ms:.3f} ms ({n} launches)" for part, (ms, n) in device.items())
        + f" | {card}", flush=True)
    run = None
    gc.collect()
    torch.cuda.empty_cache()
    records = _records("fwd", "bwd")
    g = torch.Generator(device="cuda").manual_seed(2)
    for (n, c), count in blocks.items():
        r = _separable_case(g, bp, n, c, torch.bfloat16, "bf16")
        q, k, v, qkv, out = r["q"], r["k"], r["v"], r["qkv"], r["out"]
        k_ms = time_ms(lambda: separable_attention_kernel(q, k, v))
        p_ms = time_ms(lambda: separable_attention_plain(q, k, v))
        kb_ms, pb_ms = time_ms(r["bwd_kernel"]), time_ms(r["bwd_plain"])
        b_ms, b_by = bound(qkv.numel() * qkv.element_size() + out.numel() * out.element_size(),
                           (4 * bp * n * c, FP32_FLOP_S), (bp * n, SFU_EXP_S))
        bb_ms, bb_by = bound((5 * c + 2) * bp * n * qkv.element_size(),
                             (7 * bp * n * c, FP32_FLOP_S), (bp * n, SFU_EXP_S))
        berr = max(e for _, e, _ in r["errs"])
        for rec, e, t, pt, bt, by in ((records["fwd"], r["abs_err"], k_ms, p_ms, b_ms, b_by),
                                      (records["bwd"], berr, kb_ms, pb_ms, bb_ms, bb_by)):
            rec["max_abs_err"] = max(rec["max_abs_err"], e)
            rec["ms"] += count * t
            rec["plain_ms"] += count * pt
            rec["bound_ms"] += count * bt
            rec["bound_by"] = by
        print(f"kernel: {label} bf16 BP={bp} N={n} C={c} max_abs_err={r['abs_err']:.3e} "
              f"grad_err={r['gerr']:.3e} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) kernel/bound={k_ms / b_ms:.2f} | bwd: "
              f"{_grad_errs(r['errs'])} bwd_ms={kb_ms:.4f} bwd_plain_ms={pb_ms:.4f} "
              f"bwd_bound_ms={bb_ms:.4f} ({bb_by}) bwd/bound={kb_ms / bb_ms:.2f} | {card}",
              flush=True)
        del r
    for part, rec in records.items():
        print(f"kernel: {label} {part} a step ({sum(blocks.values())} launches): "
              f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
              f"kernel/bound={rec['ms'] / rec['bound_ms']:.2f} | {card}", flush=True)
    return launches, records


def phase_schedulers(card: str) -> None:
    """Phase 20d: the Trainer on the finetune flags with a ``multi_step``
    schedule (``SCHEDULER_ARGS``: warmup 2, the LR ×0.1 from epoch 1) over 2
    epochs of pinned batches: at every iteration the LR the train step writes
    into every param group of the optimizer is the scheduler's host value
    (``retrieve_lr``), and the last epoch's is the milestone's."""
    import shutil

    import torch

    from cvnets_tpu_torch.engine import Trainer
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim.scheduler import build_scheduler
    from cvnets_tpu_torch.options.opts import get_training_arguments

    results = os.path.join("results", "schedulers_smoke")
    shutil.rmtree(results, ignore_errors=True)
    opts = get_training_arguments(args=SCHEDULER_ARGS + ["--common.results-loc", results])
    g = torch.Generator().manual_seed(3)
    train = pinned_batches(g, 3, 8, (384, 384), 1000)
    trainer = Trainer(opts, get_model(opts), build_loss_fn(opts), train,
                      pinned_batches(g, 1, 8, (384, 384), 1000))
    written, step = [], trainer._train_step

    def recorded(state, batch, lr, epoch, *rest):
        out = step(state, batch, lr, epoch, *rest)
        written.append((epoch, trainer.train_iterations, lr,
                        [grp["lr"] / grp.get("lr_mult", 1.0)
                         for grp in state.optimizer.param_groups]))
        return out

    trainer._train_step = recorded
    trainer.run()
    host = build_scheduler(opts)
    want = [host.retrieve_lr(e, i) for e, i, _, _ in written]
    got = [groups for _, _, _, groups in written]
    check(len(written) == 6 and all(gs == [w] * len(gs) for gs, w in zip(got, want)),
          f"schedulers: the optimizer's LRs {got}, the scheduler's {want}")
    check(want[-1] == 0.001 and want[0] == 1e-6, f"schedulers: multi_step LRs {want}")
    print(f"schedulers: multi_step over {len(written)} Trainer iterations (epoch, iteration, "
          f"LR): {[(e, i, w) for (e, i, _, _), w in zip(written, want)]}; every param group "
          f"of the optimizer at the scheduler's LR | {card}", flush=True)


def phase_range_augment(card: str) -> dict:
    """Phase 20: the RangeAugment distillation recipe (train with its checks,
    steady steps, a profile split into the teacher, the augmentor + loss
    terms, the optimizer and the rest, the student's forward and backward;
    then main_train natively), MobileViTv2-2.0's 384² finetune on the
    separable-attention kernels, and the multi_step scheduler through the
    Trainer. Returns the finetune path's separable launches and kernel
    records."""
    import tempfile

    import torch

    from cvnets_tpu_torch.engine.train_state import OPTIMIZER_RANGE
    from cvnets_tpu_torch.loss.distillation import DISTILLATION_RANGE, TEACHER_RANGE
    from cvnets_tpu_torch.loss.neural_augmentation import NA_LOSS_RANGE
    from cvnets_tpu_torch.models.neural_augmentor.neural_aug import AUGMENTOR_RANGE

    def release() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    label = "RangeAugment MobileNetV2-1.0 <- ResNet-101"
    with tempfile.TemporaryDirectory() as root:
        teacher_ckpt = os.path.join(root, "resnet101_teacher.pt")
        write_teacher_checkpoint(teacher_ckpt)
        run = phase_range_augment_train(card, teacher_ckpt)
        bare = phase_steady(card, label, run)
        phase_profile(card, label, run, os.path.join("results", "range_augment_profile.txt"),
                      split=(AUGMENTOR_RANGE, DISTILLATION_RANGE, NA_LOSS_RANGE),
                      ranges=(TEACHER_RANGE, OPTIMIZER_RANGE), rest="student")
        run = None
    release()
    phase_range_augment_main_train(card, bare)
    release()
    out = phase_finetune(card)
    release()
    phase_schedulers(card)
    release()
    return out


# ---- ByteFormer and audio (phase 21) ----
BYTEFORMER_MODEL_ARGS = [  # the model, loss and optimizer of both ByteFormer yamls
    "--model.classification.byteformer.mode", "tiny",
    "--model.classification.byteformer.conv-kernel-size", "16",
    "--model.activation.name", "gelu",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--loss.category", "classification",
    "--loss.classification.name", "cross_entropy",
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.05",
    "--optim.no-decay-bn-filter-bias",
    "--optim.adamw.beta1", "0.9",
    "--optim.adamw.beta2", "0.999",
    "--scheduler.name", "cosine",
    "--scheduler.warmup-init-lr", "1e-6",
    "--scheduler.cosine.max-lr", "0.001",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--common.mixed-precision",
    "--common.run-label", "train",
    "--common.auto-resume",
    "--dataset.train-batch-size0", "48",
    "--dataset.val-batch-size0", "48",
    "--dataset.workers", "8",
    "--sampler.name", "batch_sampler",
    "--stats.train", "loss",
    "--stats.checkpoint-metric", "top1",
    "--stats.checkpoint-metric-max",
    "--common.seed", "0",
]
BYTEFORMER_ARGS = BYTEFORMER_MODEL_ARGS + [  # config/classification/imagenet/byteformer.yaml
    "--model.classification.name", "byteformer",
    "--model.classification.byteformer.window-sizes", "128",
    "--model.classification.byteformer.max-num-tokens", "50000",
    "--model.normalization.name", "layer_norm",
    "--scheduler.max-epochs", "300",
    "--scheduler.warmup-iterations", "7500",
    "--scheduler.cosine.min-lr", "2e-5",
    "--common.log-freq", "500",
    "--dataset.category", "classification",
    "--dataset.collate-fn-name-train", "byteformer_image_collate_fn",
    "--dataset.collate-fn-name-val", "byteformer_image_collate_fn",
    "--dataset.collate-fn-name-test", "byteformer_image_collate_fn",
    "--image-augmentation.random-resized-crop.enable",
    "--image-augmentation.random-resized-crop.interpolation", "bilinear",
    "--image-augmentation.random-horizontal-flip.enable",
    "--image-augmentation.pil-save.enable",
    "--image-augmentation.pil-save.encoding", "jpeg",
    "--image-augmentation.pil-save.quality", "60",
    "--image-augmentation.resize.enable",
    "--image-augmentation.resize.size", "224",
    "--sampler.bs.crop-size-width", "224",
    "--sampler.bs.crop-size-height", "224",
    "--stats.val", "loss", "top1", "top5",
]
BYTEFORMER_WAV_ARGS = BYTEFORMER_MODEL_ARGS + [  # config/.../byteformer_wav.yaml
    "--model.audio-classification.name", "byteformer",
    "--model.classification.name", "byteformer",
    "--model.classification.n-classes", "35",
    "--model.classification.byteformer.window-sizes", "32",
    "--model.normalization.name", "batch_norm",
    "--model.normalization.momentum", "0.1",
    "--scheduler.max-epochs", "100",
    "--scheduler.warmup-iterations", "2000",
    "--scheduler.cosine.min-lr", "1e-5",
    "--common.log-freq", "200",
    "--dataset.name", "speech_commands_v2",
    "--dataset.category", "audio_classification",
    "--dataset.collate-fn-name-train", "byteformer_audio_collate_fn",
    "--dataset.collate-fn-name-val", "byteformer_audio_collate_fn",
    "--audio-augmentation.set-fixed-length.enable",
    "--audio-augmentation.set-fixed-length.length", "16000",
    "--sampler.bs.crop-size-width", "1",
    "--sampler.bs.crop-size-height", "1",
    "--stats.val", "loss", "top1",
]
BYTEFORMER_BATCH, BYTEFORMER_LAYERS = 48, 12
# (seeded byte counts, bucket): pil_save at quality 60 of a 224² crop of the
# JPEG corpus's images weighs 7.4-7.7 KB; a 1-s 16 kHz int16 wav is 32,044 bytes
BYTEFORMER_CELLS = {
    "ByteFormer-Tiny JPEG": (BYTEFORMER_ARGS, (7000, 8192), 8192),
    "ByteFormer-Tiny wav": (BYTEFORMER_WAV_ARGS, (32044, 32044), 32768),
}
# (B·n_windows, window) of each MHA launch of a step at batch 48, four layers
# each: tokens (bucket − 16) / 8 + 1, halved by the token merging after layers
# 3 and 7
BYTEFORMER_SHAPES = {
    "ByteFormer-Tiny JPEG": {(384, 128): 4, (192, 128): 4, (96, 128): 4},
    "ByteFormer-Tiny wav": {(6144, 32): 4, (3072, 32): 4, (1536, 32): 4},
}
BYTEFORMER_HEADS, BYTEFORMER_HEAD_DIM = 3, 64
BYTEFORMER_JPEG_CORPUS = (48, 12)  # train and val files a class of the 8 classes
BYTEFORMER_WAV_CORPUS = (16, 2)  # train and val clips a word of the 35


class ShapeLog:
    """Stands in for an MHA kernel wrapper in ``ops.mha_attention``: counts the
    (B, S) of each call and calls the wrapper (whose ``launches`` count)."""

    def __init__(self, kernel) -> None:
        import collections

        self.kernel, self.shapes = kernel, collections.Counter()

    def __call__(self, q, *args, **kwargs):
        self.shapes[tuple(q.shape[:2])] += 1
        return self.kernel(q, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.kernel, name)


class shape_logs:
    """Both MHA wrappers of ``ops.mha_attention`` replaced by ``ShapeLog``s
    inside the block: ``with shape_logs() as (fwd, bwd)``."""

    def __enter__(self):
        import cvnets_tpu_torch.ops.mha_attention as mha

        self.saved = mha.mha_fwd_kernel, mha.mha_bwd_kernel
        mha.mha_fwd_kernel, mha.mha_bwd_kernel = (ShapeLog(k) for k in self.saved)
        return mha.mha_fwd_kernel, mha.mha_bwd_kernel

    def __exit__(self, *exc):
        import cvnets_tpu_torch.ops.mha_attention as mha

        mha.mha_fwd_kernel, mha.mha_bwd_kernel = self.saved


def byteformer_batches(seed: int, n: int, lengths: tuple, n_classes: int, device) -> list:
    """``n`` batches of ``BYTEFORMER_BATCH`` seeded byte sequences of
    ``lengths`` (inclusive) padded with -1 to their bucket by the collate's
    ``pad_batch``, on ``device``."""
    import numpy as np
    import torch

    from cvnets_tpu_torch.data.collate.byteformer_collate_functions import pad_batch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        seqs = [rng.integers(0, 256, int(rng.integers(lengths[0], lengths[1] + 1)))
                for _ in range(BYTEFORMER_BATCH)]
        out.append({"samples": torch.from_numpy(pad_batch(seqs)).to(device),
                    "targets": torch.from_numpy(rng.integers(0, n_classes, BYTEFORMER_BATCH)
                                                ).to(device)})
    return out


def _byteformer_state(args, device):
    from cvnets_tpu_torch.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim import build_optimizer
    from cvnets_tpu_torch.optim.scheduler import build_scheduler
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=args)
    model = get_model(opts, device=device)
    state = create_train_state(model, build_optimizer(opts, model, model.get_lr_multipliers(opts)),
                               ema_enabled=True)
    criteria = build_loss_fn(opts)
    step = make_train_step(model, criteria, opts, build_metrics(opts, ["loss", "grad_norm"]))
    return opts, model, state, criteria, step, build_scheduler(opts)


def phase_byteformer_train(card: str, label: str) -> tuple:
    """Phase 21a/b: ByteFormer-Tiny train steps on the yaml's flags at batch 48
    of seeded byte sequences padded to their bucket, bf16. Checks 12 forward
    and 12 backward MHA launches a step, by (B·n_windows, window) exactly
    ``BYTEFORMER_SHAPES[label]``, finite losses, params and EMA moved; the
    float32 eval logits through the kernels against the einsum route and
    against a CPU copy. Returns the launches and the run for the steady
    steps and the profile."""
    import torch

    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel

    args, lengths, bucket = BYTEFORMER_CELLS[label]
    device = torch.device("cuda:0")
    opts, model, state, criteria, train_step, scheduler = _byteformer_state(args, device)
    n_classes = getattr(opts, "model.classification.n_classes")
    batches = byteformer_batches(0, WARMUP_STEPS + TIMED_STEPS, lengths, n_classes, device)
    check(all(b["samples"].shape[1] == bucket for b in batches),
          f"{label}: buckets {[b['samples'].shape[1] for b in batches]}, want {bucket}")
    params0 = [p.detach().clone() for p in model.parameters()]
    ema0 = [t.detach().clone() for t in state.ema.model.state_dict().values()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    with shape_logs() as (fwd, bwd):
        mha_fwd_kernel.launches = mha_bwd_kernel.launches = 0
        for b in batches:
            t0 = time.perf_counter()
            state, metrics = train_step(state, b, scheduler.retrieve_lr(0, state.step))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(metrics["loss"]["loss"][0].item())
        launches = {"mha_attention_fwd": mha_fwd_kernel.launches,
                    "mha_attention_bwd": mha_bwd_kernel.launches}
    n = len(batches)
    want = {shape: count * n for shape, count in BYTEFORMER_SHAPES[label].items()}
    check(launches == {k: BYTEFORMER_LAYERS * n for k in launches}
          and dict(fwd.shapes) == want and dict(bwd.shapes) == want,
          f"{label}: launches {launches}, forward shapes {dict(fwd.shapes)}, backward "
          f"{dict(bwd.shapes)} in {n} steps; want {BYTEFORMER_LAYERS} a step, {want}")
    check(all(math.isfinite(v) for v in losses), f"{label}: losses {losses}")
    check(any(not torch.equal(a, b) for a, b in zip(params0, model.parameters())),
          f"{label}: params did not change")
    check(any(not torch.equal(a, b) for a, b in zip(ema0, state.ema.model.state_dict().values())),
          f"{label}: EMA did not change")
    del params0, ema0
    timed = step_s[WARMUP_STEPS:]
    print(f"train: {label} batch={BYTEFORMER_BATCH} tokens of {bucket} bytes bf16 steps={n} "
          f"losses={[round(v, 4) for v in losses]} step_s={[round(x, 4) for x in step_s]} "
          f"img_s={BYTEFORMER_BATCH * len(timed) / sum(timed):.1f} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.2f} launches={launches} "
          f"shapes (B, S) a step={ {k: v // n for k, v in fwd.shapes.items()} } | {card}",
          flush=True)
    x = batches[0]["samples"][:4]
    model.eval()
    with no_tf32(), torch.no_grad():
        with_kernel = model(x)
        set_use_kernel(model, False)
        plain = model(x)
    set_use_kernel(model, True)
    diff, scale = (with_kernel - plain).abs().max().item(), plain.abs().max().item()
    check(tuple(with_kernel.shape) == (4, n_classes) and bool(torch.isfinite(with_kernel).all()),
          f"{label}: logits shape or finiteness")
    check(diff <= 1e-4 * max(1.0, scale), f"{label}: kernel vs plain logits differ by {diff}")
    print(f"reference: {label} kernel-path vs plain-path logits max diff {diff:.3e} "
          f"(max |logit| {scale:.3e})", flush=True)
    cpu_reference(label, model, x[:2], (2, n_classes))
    return launches, (state, train_step, scheduler, batches, criteria)


def phase_byteformer_masked(card: str) -> None:
    """Phase 21d: one train step of (a) under
    ``--model.classification.byteformer.mask-windowed-attn``: the six
    unshifted layers take the kernels with the key-padding mask (6 forward and
    6 backward launches), the six shifted ones the einsum route (an additive
    mask); finite loss; float32 eval logits against the einsum route's."""
    import torch

    from cvnets_tpu_torch.layers.multi_head_attention import MultiHeadAttention
    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel

    label = "ByteFormer-Tiny JPEG --mask-windowed-attn"
    args, lengths, _ = BYTEFORMER_CELLS["ByteFormer-Tiny JPEG"]
    device = torch.device("cuda:0")
    opts, model, state, _, train_step, scheduler = _byteformer_state(
        args + ["--model.classification.byteformer.mask-windowed-attn"], device)
    batch = byteformer_batches(1, 1, lengths, 1000, device)[0]
    calls = []
    hooks = [m.register_forward_hook(lambda *a: calls.append(1))
             for m in model.modules() if isinstance(m, MultiHeadAttention)]
    mha_fwd_kernel.launches = mha_bwd_kernel.launches = 0
    state, metrics = train_step(state, batch, scheduler.retrieve_lr(0, state.step))
    loss = metrics["loss"]["loss"][0].item()
    fwd, bwd = mha_fwd_kernel.launches, mha_bwd_kernel.launches
    for h in hooks:
        h.remove()
    half = BYTEFORMER_LAYERS // 2
    check((fwd, bwd, len(calls) - fwd) == (half, half, half) and math.isfinite(loss),
          f"{label}: {fwd} forward and {bwd} backward launches, {len(calls) - fwd} einsum "
          f"layers, loss {loss}; want {half} each")
    x = batch["samples"][:4]
    model.eval()
    with no_tf32(), torch.no_grad():
        with_kernel = model(x)
        set_use_kernel(model, False)
        plain = model(x)
    diff, scale = (with_kernel - plain).abs().max().item(), plain.abs().max().item()
    check(bool(torch.isfinite(with_kernel).all()) and diff <= 1e-4 * max(1.0, scale),
          f"{label}: kernel vs plain logits differ by {diff}")
    print(f"train: {label} one step: forward launches={fwd} backward={bwd} einsum layers="
          f"{len(calls) - fwd} loss={loss:.4f}; kernel-path vs plain-path logits max diff "
          f"{diff:.3e} (max |logit| {scale:.3e}) | {card}", flush=True)


def phase_byteformer_kernel(card: str) -> dict:
    """Phase 21c: the MHA kernels at ByteFormer-Tiny's first-stage windows,
    (384, 128, 3, 64) and (6144, 32, 3, 64), bf16 and f32, with and without a
    key mask (batch element 0, one window, masked whole), against their plain
    versions (``_mha_case``: output, statistics, dq, dk, dv, the backward's
    bits on a second call); then every window shape of a step
    (``BYTEFORMER_SHAPES``) timed in bf16 without a mask beside its plain
    versions, its bound and SDPA. Returns {path: {"fwd": record, "bwd":
    record}}, each a step's four launches of each shape."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(21)
    h, d = BYTEFORMER_HEADS, BYTEFORMER_HEAD_DIM
    out = {}
    with no_tf32():
        for label, shapes in BYTEFORMER_SHAPES.items():
            records = _records("fwd", "bwd")
            for p in ("fwd", "bwd"):
                records[p].update(library_ms=0.0, library_ms_by_backend={})
            first = next(iter(shapes))
            for (b, s), count in shapes.items():
                cases = [(dt, m) for dt in (torch.bfloat16, torch.float32) for m in (False, True)
                         ] if (b, s) == first else [(torch.bfloat16, False)]
                for dtype, masked in cases:
                    name = "bf16" if dtype == torch.bfloat16 else "f32"
                    q, k, v, mask, dout, o, stats, ref, errs = _mha_case(
                        g, f"{label} {name} B={b} S={s} mask={masked}", b, s, h, d, dtype,
                        masked)
                    if dtype == torch.bfloat16:
                        records["fwd"]["max_abs_err"] = max(records["fwd"]["max_abs_err"],
                                                            errs["out"])
                        records["bwd"]["max_abs_err"] = max(
                            records["bwd"]["max_abs_err"], errs["dq"], errs["dk"], errs["dv"])
                    times = ""
                    if dtype == torch.bfloat16 and not masked:
                        bounds = mha_bounds(b, s, h, d, q.element_size(), BF16_TC_FLOP_S)
                        t = _mha_times(b, s, h, d, q, k, v, dout, o, stats, ref)
                        for p in ("fwd", "bwd"):
                            r = records[p]
                            r["ms"] += count * t[p]
                            r["plain_ms"] += count * t[f"{p}_plain"]
                            r["bound_ms"] += count * bounds[p][0]
                            r["library_ms"] += count * t[f"lib_{p}"]
                            for bk, ms in t["sdpa"].items():
                                r["library_ms_by_backend"][bk] = (
                                    r["library_ms_by_backend"].get(bk, 0.0) + count * ms[p])
                            r.setdefault("bound_by_shape", {})[f"{b}x{s}"] = bounds[p][1]
                        times = (" " + _mha_times_line(t, bounds, 4 * b * s * s * h * d)
                                 + " fwd/bound=" + f"{t['fwd'] / bounds['fwd'][0]:.2f}"
                                 + " bwd/bound=" + f"{t['bwd'] / bounds['bwd'][0]:.2f}")
                    print(f"mha kernel: {label} {name} B={b} S={s} H={h} D={d} mask={masked} "
                          + " ".join(f"{w}_err={x:.3e}" for w, x in errs.items())
                          + times + f" | {card}", flush=True)
                    del q, k, v, mask, dout, o, stats, ref
            for p in ("fwd", "bwd"):
                r = records[p]
                kinds = set(r.pop("bound_by_shape").values())
                r["bound_by"] = kinds.pop() if len(kinds) == 1 else "operations"
                r["library_backend"] = min(r["library_ms_by_backend"],
                                           key=r["library_ms_by_backend"].get)
                print(f"mha kernel: {label} {p} a step ({BYTEFORMER_LAYERS} launches): "
                      f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, bound "
                      f"{r['bound_ms']:.4f} ({r['bound_by']}), kernel/bound "
                      f"{r['ms'] / r['bound_ms']:.2f}, library {r['library_ms']:.4f} (the "
                      f"faster SDPA backend a shape; {r['library_ms_by_backend']}) | {card}",
                      flush=True)
            out[label] = records
            torch.cuda.empty_cache()
    return out


def write_byteformer_corpora(root: str) -> dict:
    """Phase 17's JPEG corpus, cut to ``BYTEFORMER_JPEG_CORPUS`` files a class,
    and a Speech Commands folder of ``BYTEFORMER_WAV_CORPUS`` clips a word,
    whose validation clips are also its test list (``main_eval`` reads the
    test split)."""
    import shutil

    from cvnets_tpu_torch.tools.speech_commands_corpus import write_speech_commands

    jpeg = write_jpeg_corpus(os.path.join(root, "jpeg"), train_per_class=BYTEFORMER_JPEG_CORPUS[0],
                             val_per_class=BYTEFORMER_JPEG_CORPUS[1])
    wav = os.path.join(root, "speech_commands")
    write_speech_commands(wav, *BYTEFORMER_WAV_CORPUS)
    shutil.copy(os.path.join(wav, "validation_list.txt"), os.path.join(wav, "testing_list.txt"))
    return {"jpeg": jpeg, "wav": wav}


def phase_byteformer_main_train(card: str, label: str, roots: tuple, bare: dict) -> None:
    """Phase 21e/f: ``main_worker`` on the yaml's flags of ``label`` over
    ``roots`` (train, val), 2 epochs, each validated (and its EMA): 12 + 12
    MHA launches a train step and 12 an eval forward, finite statistics, no
    host sync through the port's code between log points, the buckets the
    collate padded to; img/s over epoch 2 after its first batch beside the
    train loader alone and the bare step; ``main_eval`` on
    checkpoint_ema_last.pt against the last EMA validation."""
    import collections
    import shutil

    import torch

    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.engine.train_state import batch_size
    from cvnets_tpu_torch.main_eval import main_worker as main_eval
    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel
    from cvnets_tpu_torch.options.opts import get_training_arguments

    args0 = BYTEFORMER_CELLS[label][0]
    results = os.path.join("results", "byteformer_" + label.split()[-1].lower())
    shutil.rmtree(results, ignore_errors=True)
    args = args0 + ["--dataset.root-train", roots[0], "--dataset.root-val", roots[1],
                    "--scheduler.max-epochs", "2", "--common.results-loc", results]
    if "--dataset.name" not in args0:  # the yaml's decoder (native) and collate: Pillow a sample
        args += ["--dataset.name", "imagenet"]
    log = {"train": [], "val": [], "ema": [], "save_s": 0.0}
    watch, built, epochs, buckets = SyncWatch(), [], [], collections.Counter()
    kernels = {"fwd": mha_fwd_kernel, "bwd": mha_bwd_kernel}

    class WatchedTrainer(main_train.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            _watch_trainer(self, kernels, watch, BYTEFORMER_LAYERS, log)
            step, epoch_fn = self._train_step, self.train_epoch

            def counted(state, batch, *rest):
                buckets[batch["samples"].shape[1]] += 1
                if epochs[-1][1] is None:
                    epochs[-1][1] = time.perf_counter()
                else:
                    epochs[-1][0] += batch_size(batch["samples"])
                return step(state, batch, *rest)

            def epoch(e):
                epochs.append([0, None, None])
                out = epoch_fn(e)
                epochs[-1][2] = time.perf_counter()
                return out

            self._train_step, self._train_step_noaccum = counted, None
            self.train_epoch = epoch
            built.append(self)

    with watch:
        main_train.Trainer = WatchedTrainer
        try:
            main_train.main_worker(args=args)
        finally:
            main_train.Trainer = WatchedTrainer.__bases__[0]
    trainer = built[0]
    bad = watch.through(MAIN_TRAIN_FILES + (os.path.join("cvnets_tpu_torch", "models")
                                            + os.sep,))
    check(not bad, f"{label} main_train: a host sync between log points: {bad[:3]}")
    for stage in ("train", "val", "ema"):
        values = [v for entry in log[stage] for v in
                  (entry[3] if stage == "train" else entry).values()]
        check(values and all(math.isfinite(v) for v in values),
              f"{label} main_train: {stage} statistics not finite: {log[stage]}")
    n_steps = trainer.train_iterations
    after_first, first_at, end_at = epochs[-1]
    ckpt = os.path.join(trainer.save_dir, "checkpoint_ema_last.pt")
    trainer = None
    built.clear()
    gc.collect()
    torch.cuda.empty_cache()

    def check_batch(batch):
        x = batch["samples"]
        check(x.dtype == torch.int32 and x.is_pinned() and x.dim() == 2
              and x.shape[1] >= 256 and x.shape[1] & (x.shape[1] - 1) == 0,
              f"{label} loader: batch {tuple(x.shape)} {x.dtype}")

    opts = get_training_arguments(args=args)
    n_img, secs, first, threads = loader_alone(opts, check_batch)
    loader_img_s = (n_img - BYTEFORMER_BATCH) / (secs - first)
    category = getattr(opts, "dataset.category")
    before = mha_fwd_kernel.launches
    # the validation's batches: a batch pads to the bucket of its longest sequence
    got = main_eval(args=args + [f"--model.{category.replace('_', '-')}.pretrained", ckpt,
                                 "--dataset.eval-batch-size0", str(BYTEFORMER_BATCH)])
    want = log["ema"][-1]
    check(mha_fwd_kernel.launches > before and abs(got["loss"] - want["loss"])
          <= 1e-4 * max(1.0, abs(want["loss"]))
          and all(abs(got[k] - want[k]) <= 1e-3 for k in want if k != "loss"),
          f"{label} main_eval on checkpoint_ema_last.pt: {got} vs the last EMA validation {want}")
    print(f"main_train: {label} batch={BYTEFORMER_BATCH} bf16 epochs=2 steps={n_steps} "
          f"img_s={after_first / (end_at - first_at):.1f} over epoch 2 after its first batch "
          f"({after_first} samples in {end_at - first_at:.3f} s) buckets={dict(buckets)} "
          f"loader alone img_s={loader_img_s:.1f} ({n_img} samples in {secs:.3f} s over 2 "
          f"epochs, first batch after {first:.3f} s; {threads} threads, {os.cpu_count()} "
          f"cores) bare step img_s={bare['img_s']:.1f} "
          f"train={[{k: round(v, 4) for k, v in e[3].items()} for e in log['train']]} "
          f"val={[{k: round(v, 4) for k, v in s.items()} for s in log['val']]} "
          f"ema={[{k: round(v, 4) for k, v in s.items()} for s in log['ema']]} "
          f"main_eval={ {k: round(v, 6) for k, v in got.items()} } | {card}", flush=True)


def phase_byteformer(card: str) -> tuple:
    """Phase 21: ByteFormer-Tiny on JPEG bytes (a) and on wav bytes (b), each
    with 24 steady steps and a profile with the MHA kernels' share; the MHA
    kernels at ByteFormer's windows (c); ``--mask-windowed-attn`` (d);
    ``main_train`` over a JPEG corpus (e) and a Speech Commands folder (f).
    Returns ({path: launches}, {path: kernel records})."""
    import tempfile

    import torch

    def release() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    launches, bare = {}, {}
    for label in BYTEFORMER_CELLS:
        launches[label], run = phase_byteformer_train(card, label)
        bare[label] = phase_steady(card, label, run)
        phase_profile(card, label, run, os.path.join(
            "results", f"byteformer_{label.split()[-1].lower()}_profile.txt"), named=("::mha_",))
        run = None
        release()
    records = phase_byteformer_kernel(card)
    release()
    phase_byteformer_masked(card)
    release()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        corpora = write_byteformer_corpora(root)
        print(f"byteformer: corpora written in {time.perf_counter() - t0:.2f} s", flush=True)
        phase_byteformer_main_train(card, "ByteFormer-Tiny JPEG",
                                    (corpora["jpeg"]["train"], corpora["jpeg"]["val"]),
                                    bare["ByteFormer-Tiny JPEG"])
        release()
        phase_byteformer_main_train(card, "ByteFormer-Tiny wav", (corpora["wav"],) * 2,
                                    bare["ByteFormer-Tiny wav"])
        release()
    return launches, records


# Mask R-CNN (phase 22): config/detection/mask_rcnn_coco/vit_fpn.yaml (path A:
# MobileViTv2-1.0 and the FPN at 512²) and vit_fpn_lsj.yaml (path B: ViT-B/16
# with the simple FPN under Large Scale Jitter at 1024²), as flags
MASK_RCNN_COMMON_ARGS = [
    "--dataset.name", "coco_mask_rcnn",
    "--dataset.category", "detection",
    "--dataset.train-batch-size0", "8",
    "--dataset.val-batch-size0", "8",
    "--dataset.workers", "8",
    "--dataset.collate-fn-name-train", "coco_mask_rcnn_collate_fn",
    "--dataset.collate-fn-name-val", "coco_mask_rcnn_collate_fn",
    "--dataset.collate-fn-name-test", "coco_mask_rcnn_collate_fn",
    "--image-augmentation.random-horizontal-flip.enable",
    "--model.detection.name", "mask_rcnn",
    "--model.detection.n-classes", "81",
    "--loss.category", "detection",
    "--loss.detection.name", "mask_rcnn_loss",
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.1",
    "--optim.no-decay-bn-filter-bias",
    "--scheduler.name", "multi_step",
    "--scheduler.max-epochs", "100",
    "--scheduler.warmup-iterations", "250",
    "--scheduler.multi-step.lr", "0.0001",
    "--common.run-label", "train",
    "--common.mixed-precision",
    "--common.log-freq", "500",
    "--common.auto-resume",
    "--common.grad-clip", "1.0",
]
MASK_RCNN_A_ARGS = MASK_RCNN_COMMON_ARGS + [
    "--sampler.bs.crop-size-width", "512",
    "--sampler.bs.crop-size-height", "512",
    "--image-augmentation.resize.enable",
    "--image-augmentation.resize.size", "512", "512",
    "--model.classification.name", "mobilevit_v2",
    "--model.classification.activation.name", "swish",
    "--model.detection.mask-rcnn.backbone-lr-multiplier", "0.7",
    "--model.normalization.name", "sync_batch_norm",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--scheduler.warmup-init-lr", "1e-06",
    "--scheduler.multi-step.milestones", "70", "90",
]
MASK_RCNN_B_ARGS = MASK_RCNN_COMMON_ARGS + [
    "--dataset.detection.coco-mask-rcnn.use-lsj-aug",
    "--sampler.bs.crop-size-width", "1024",
    "--sampler.bs.crop-size-height", "1024",
    "--image-augmentation.scale-jitter.enable",
    "--image-augmentation.scale-jitter.target-size", "1024", "1024",
    "--image-augmentation.scale-jitter.scale-range", "0.1", "2.0",
    "--image-augmentation.fixed-size-crop.enable",
    "--image-augmentation.fixed-size-crop.size", "1024", "1024",
    "--model.classification.name", "vit",
    "--model.classification.vit.use-simple-fpn",
    "--model.detection.mask-rcnn.backbone-lr-multiplier", "0.1",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--model.activation.name", "gelu",
    "--scheduler.warmup-init-lr", "8e-06",
    "--scheduler.multi-step.milestones", "88", "96",
]
MASK_RCNN_A, MASK_RCNN_B = "Mask R-CNN MobileViTv2-1.0 512²", "Mask R-CNN ViT-B/16 1024²"
# path A's separable attention at 8 × 512² (no dilation): (BP, {(N, C): blocks})
SEP_MASK_RCNN = (8 * 4, {(1024, 128): 2, (256, 192): 4, (64, 256): 3})
# path B's MHA: ViT-B/16 at 1024² with its CLS token, S = 64² + 1 = 17 · 241
MHA_MASK_RCNN = (8, 64 * 64 + 1, 12, 64)
MASK_RCNN_STEPS = (2, 5)  # warm-up and timed bare steps of each path
MASK_RCNN_CORPUS = (160, 8, 640)  # path A main_train: train and val files (20 steps an epoch), longest side
# the micro configuration of the CPU reference (tests/torch_mask_rcnn_helpers.py's sizes)
MASK_RCNN_MICRO_ARGS = [
    "--dataset.category", "detection", "--model.detection.name", "mask_rcnn",
    "--model.detection.n-classes", "5", "--model.classification.name", "mobilevit_v2",
    "--model.classification.mitv2.width-multiplier", "0.5",
    "--model.detection.mask-rcnn.pre-nms-top-n", "64",
    "--model.detection.mask-rcnn.post-nms-top-n", "16",
    "--model.detection.mask-rcnn.box-batch-per-image", "16",
    "--model.detection.mask-rcnn.mask-positives", "4",
    "--model.detection.mask-rcnn.detections-per-image", "8",
    "--model.detection.mask-rcnn.fpn-out-channels", "32",
    "--loss.category", "detection", "--loss.detection.name", "mask_rcnn_loss",
]


def mask_rcnn_batches(n: int, batch: int, hw: tuple, n_classes: int, device,
                      seed: int = 0) -> list:
    """``n`` train batches as coco_mask_rcnn's collate gives them, on
    ``device``: ``batch`` seeded uint8 images of ``hw``, 1-12 boxes an image
    (5-60% of each side) padded to MAX_GT, random labels, and each box's mask
    the ellipse inside it at a quarter of ``hw`` (bool)."""
    import numpy as np
    import torch

    from cvnets_tpu_torch.models.detection.mask_rcnn import MAX_GT

    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h // 4, 0:w // 4] + 0.5
    out = []
    for _ in range(n):
        boxes = np.zeros((batch, MAX_GT, 4), np.float32)
        labels = np.zeros((batch, MAX_GT), np.int64)
        masks = np.zeros((batch, MAX_GT, h // 4, w // 4), bool)
        for b in range(batch):
            for i in range(int(rng.integers(1, 13))):
                bw, bh = rng.uniform(0.05, 0.6) * w, rng.uniform(0.05, 0.6) * h
                x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                boxes[b, i] = [x1, y1, x1 + bw, y1 + bh]
                labels[b, i] = rng.integers(1, n_classes)
                masks[b, i] = (((xx - (x1 + bw / 2) / 4) / (bw / 8)) ** 2
                               + ((yy - (y1 + bh / 2) / 4) / (bh / 8)) ** 2) <= 1
        image = rng.integers(0, 256, (batch, 3, h, w), dtype=np.uint8)
        targets = {"box_coordinates": boxes, "box_labels": labels, "masks": masks}
        out.append({"samples": {"image": torch.from_numpy(image).to(device),
                                "targets": {k: torch.from_numpy(v).to(device)
                                            for k, v in targets.items()}},
                    "targets": {}})
    return out


def _mask_rcnn_state(args, batch: int = None, device="cuda"):
    """The model of ``args`` on ``device``, its train state (the backbone's LR
    multiplier in the optimizer's groups), loss, train step and scheduler."""
    import torch

    from cvnets_tpu_torch.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim import build_optimizer
    from cvnets_tpu_torch.optim.scheduler import build_scheduler
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=args)
    if batch is not None:
        setattr(opts, "dataset.train_batch_size0", batch)
    model = get_model(opts, device=device)
    state = create_train_state(
        model, build_optimizer(opts, model, model.get_lr_multipliers(opts)),
        ema_enabled=getattr(opts, "ema.enable"))
    criteria = build_loss_fn(opts, device=torch.device(device))
    step = make_train_step(model, criteria, opts, build_metrics(opts, ["loss", "grad_norm"]))
    return opts, state, criteria, step, build_scheduler(opts)


def phase_mask_rcnn_train(card: str, label: str, args, kernels: dict, per_step: int,
                          batch: int = None, steps: tuple = MASK_RCNN_STEPS, device="cuda"):
    """Bare train steps of the Mask R-CNN of ``args`` at its batch (or
    ``batch``) and crop: the kernels' counts set to 0 just before the steps
    and read just after, each ``per_step`` a step; the five losses and the
    grad norm finite, the params and the EMA moved. Returns the counts and
    what the a/b, steady and profile phases take."""
    import torch

    opts, state, criteria, train_step, scheduler = _mask_rcnn_state(args, batch, device)
    model = state.model
    batch = getattr(opts, "dataset.train_batch_size0")
    hw = (getattr(opts, "sampler.bs.crop_size_height"),
          getattr(opts, "sampler.bs.crop_size_width"))
    batches = mask_rcnn_batches(sum(steps), batch, hw, getattr(opts, "model.detection.n_classes"),
                                device, seed=getattr(opts, "common.seed"))
    params0 = [p.detach().clone() for p in model.parameters()]
    ema0 = ([t.detach().clone() for t in state.ema.model.state_dict().values()]
            if state.ema is not None else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel in kernels.values():
        kernel.launches = 0
    losses, step_s = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, metrics = train_step(state, b, scheduler.retrieve_lr(0, state.step))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: s.item() for m in metrics.values() for k, (s, _) in m.items()})
    launches = {name: kernel.launches for name, kernel in kernels.items()}
    for name, count in launches.items():
        check(count == per_step * len(batches) > 0,
              f"{label}: {count} {name} launches in {len(batches)} steps, want {per_step} a step")
    check(len(losses[0]) == 7 and all(math.isfinite(v) for m in losses for v in m.values()),
          f"{label}: losses not finite or not the five and the total: {losses}")
    check(any(not torch.equal(a, b) for a, b in zip(params0, model.parameters())),
          f"{label}: params did not change")
    check(ema0 is None or any(not torch.equal(a, b) for a, b in zip(
        ema0, state.ema.model.state_dict().values())), f"{label}: EMA did not change")
    del params0, ema0
    timed = step_s[steps[0]:]
    parts = {k: [round(m[k], 4) for m in losses] for k in losses[0]}
    print(f"train: {label} batch={batch} {hw[0]}x{hw[1]} bf16 steps={len(batches)} "
          f"losses={parts} step_s={[round(x, 4) for x in step_s]} "
          f"img_s={batch * len(timed) / sum(timed):.1f} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.2f} launches={launches} "
          f"a step={ {k: v // len(batches) for k, v in launches.items()} } | {card}", flush=True)
    return launches, (state, train_step, scheduler, batches, criteria)


def torch_generator(device, seed: int):
    import torch

    return torch.Generator(device=device).manual_seed(seed)


RPN_LOSSES = ("loss_objectness", "loss_rpn_box_reg")


def mask_rcnn_losses_close(got: dict, want: dict, rpn_tol: float = 1e-4) -> float:
    """The largest difference of two sets of the five losses, each over max(1,
    |loss|); raises where the RPN's exceed ``rpn_tol`` or the heads' 2e-2.
    On the same weights the RPN's losses read the anchors alone; the heads'
    read the proposals, which a near tie among 16-261 thousand objectness
    logits or in an NMS can swap at the edge of the kept set, moving a loss
    by at most a few of its 16-128 sampled RoIs' share."""
    worst = 0.0
    for key, ref in want.items():
        diff = abs(got[key] - ref) / max(1.0, abs(ref))
        check(math.isfinite(got[key]) and diff <= (rpn_tol if key in RPN_LOSSES else 2e-2),
              f"{key}: {got[key]} vs {ref}")
        worst = max(worst, diff)
    return worst


def mask_rcnn_held(card: str, label: str, model, batch: dict, n: int) -> None:
    """The model through the kernels against the plain path (float32, TF32
    off) on ``n`` images of ``batch``: the FPN's maps within 1e-4 of max(1,
    their largest), and the five training losses on the same draws
    (``mask_rcnn_losses_close``)."""
    import torch

    x = batch["samples"]["image"][:n].float() / 255.0
    targets = {k: v[:n] for k, v in batch["samples"]["targets"].items()}
    feats, losses = {}, {}
    with no_tf32(), torch.no_grad():
        n_anchors = model.anchors([tuple(f.shape[-2:]) for f in model.feature_maps(x)],
                                  x.device).shape[0]
        draws = model.draw(n, n_anchors, targets["box_labels"].shape[1],
                           torch_generator(x.device, 7))
        for on in (True, False):  # eval first: a train forward moves BN's statistics
            set_use_kernel(model, on)
            feats[on] = model.eval().feature_maps(x)
        for on in (True, False):
            set_use_kernel(model, on)
            pred = model.train()({"image": x, "targets": targets}, draws=draws)
            losses[on] = {k: v.item() for k, v in pred["losses"].items()}
    set_use_kernel(model, True)
    fdiff = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                for a, b in zip(feats[True], feats[False]))
    check(fdiff <= 1e-4, f"{label}: kernel vs plain FPN maps differ by {fdiff}")
    ldiff = mask_rcnn_losses_close(losses[True], losses[False])
    print(f"reference: {label} kernel-path vs plain-path float32 on {n} images: FPN maps "
          f"max diff {fdiff:.3e} of max(1, |map|); losses " + " ".join(
              f"{k}={losses[True][k]:.6f}/{losses[False][k]:.6f}" for k in losses[False])
          + f" (max rel diff {ldiff:.2e}) | {card}", flush=True)


def mask_rcnn_held_steps(card: str, label: str, args, batch: int, n_steps: int = 3,
                         device="cuda") -> None:
    """``n_steps`` float32 train steps (TF32 off, the yaml's optimizer, EMA
    and clip) through the kernels and through the plain path, each from the
    same seeded weights, on the same batches and the same (seed, step)
    draws: the first step's five losses held by ``mask_rcnn_losses_close``;
    after it the two routes' weights differ (AdamW turns grads that differ
    at float32's noise into steps of up to ±lr where a grad is near 0), so
    a later step's RPN losses are held to the heads' 2e-2 too."""
    import torch

    per_route = {}
    for on in (True, False):
        opts, state, _, train_step, scheduler = _mask_rcnn_state(args, batch, device)
        setattr(opts, "common.mixed_precision", False)  # the step's autocast reads it each call
        set_use_kernel(state.model, on)
        hw = (getattr(opts, "sampler.bs.crop_size_height"),
              getattr(opts, "sampler.bs.crop_size_width"))
        batches = mask_rcnn_batches(n_steps, batch, hw, getattr(opts, "model.detection.n_classes"),
                                    device, seed=getattr(opts, "common.seed"))
        losses = []
        with no_tf32():
            for b in batches:
                state, metrics = train_step(state, b, scheduler.retrieve_lr(0, state.step))
                losses.append({k[len("loss."):]: v[0].item() for k, v in metrics["loss"].items()
                               if k.startswith("loss.")})
        per_route[on] = losses
        state = train_step = batches = None
        gc.collect()
        torch.cuda.empty_cache()
    worst = max(mask_rcnn_losses_close(got, want, 1e-4 if i == 0 else 2e-2)
                for i, (got, want) in enumerate(zip(per_route[True], per_route[False])))
    print(f"reference: {label} {n_steps} float32 train steps at batch {batch}, kernels vs plain "
          f"path from the same weights and draws: total loss " + " ".join(
              f"{sum(a.values()):.6f}/{sum(b.values()):.6f}"
              for a, b in zip(per_route[True], per_route[False]))
          + f" (max rel diff of a loss {worst:.2e}) | {card}", flush=True)


def phase_mask_rcnn_predict(card: str, label: str, run) -> None:
    """``predict`` on a batch at the crop size (the yamls' validation batch
    of 8): the eval forward under bf16 autocast, decode, score threshold,
    class-aware NMS to 100 slots, the mask head on the kept boxes and the
    masks pasted at the input's size, all on the card with no host sync (the
    CUDA sync debug mode catches none); timed with CUDA events."""
    import torch

    state, _, _, batches, _ = run
    model = state.model.eval()
    x = batches[0]["samples"]["image"].float() / 255.0

    def whole():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            return model.predict(x)

    out = whole()
    torch.cuda.synchronize()
    watch = SyncWatch()
    with watch:
        watch.on()
        out = whole()
        watch.off()
        torch.cuda.synchronize()
    check(not watch.caught, f"{label} predict: a host sync: {watch.through(('cvnets_tpu_torch',))}")
    b, _, h, w = x.shape
    k = model.detections_per_image
    check(tuple(out.boxes.shape) == (b, k, 4) and tuple(out.masks.shape) == (b, k, h, w)
          and bool(torch.isfinite(out.scores).all()) and bool(torch.isfinite(out.boxes).all())
          and bool(((out.masks >= 0) & (out.masks <= 1)).all()),
          f"{label} predict: shapes {tuple(out.boxes.shape)} {tuple(out.masks.shape)} or values")
    with torch.no_grad():
        ms = time_ms(whole, launches=3, samples=3, warmup=1)
    kept = (out.scores > 0).sum(dim=1).float().mean().item()
    print(f"predict: {label} batch={b} {h}x{w} predict_ms={ms:.3f} (bf16 forward, decode, "
          f"top-400, class-aware NMS to 100 slots, the mask head on them, masks pasted at "
          f"{h}x{w}) kept/image={kept:.1f}; no host sync | {card}", flush=True)
    del out


def phase_mask_rcnn_kernels(card: str) -> None:
    """The kernels at this slice's shapes against their plain versions, and
    timed: the separable attention at path A's three stage shapes (bf16 and
    f32), the MHA kernels at path B's S = 4,097 (bf16 at its batch of 8, f32
    at batch 1), each held as the earlier phases hold them."""
    import torch

    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_kernel,
        separable_attention_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(23)
    bp, blocks = SEP_MASK_RCNN
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for n, c in blocks:
            r = _separable_case(g, bp, n, c, dtype, name)
            times = ""
            if dtype == torch.bfloat16:  # the bounds as phase_kernel counts them
                q, k, v, qkv, out = r["q"], r["k"], r["v"], r["qkv"], r["out"]
                b_ms, b_by = bound(qkv.numel() * qkv.element_size() + out.numel()
                                   * out.element_size(), (4 * bp * n * c, FP32_FLOP_S),
                                   (bp * n, SFU_EXP_S))
                bb_ms, bb_by = bound((5 * c + 2) * bp * n * qkv.element_size(),
                                     (7 * bp * n * c, FP32_FLOP_S), (bp * n, SFU_EXP_S))
                times = (f" kernel_ms={time_ms(lambda: separable_attention_kernel(q, k, v)):.4f}"
                         f" plain_ms={time_ms(lambda: separable_attention_plain(q, k, v)):.4f}"
                         f" bound_ms={b_ms:.4f} ({b_by})"
                         f" bwd_ms={time_ms(r['bwd_kernel']):.4f}"
                         f" bwd_plain_ms={time_ms(r['bwd_plain']):.4f}"
                         f" bwd_bound_ms={bb_ms:.4f} ({bb_by}) blocks_a_step={blocks[(n, c)]}")
            print(f"kernel: {MASK_RCNN_A} {name} BP={bp} N={n} C={c} "
                  f"max_abs_err={r['abs_err']:.3e} max_rel_err={r['rel_err']:.3e} "
                  f"grad_err={r['gerr']:.3e} | bwd: {_grad_errs(r['errs'])} same_bits=True"
                  f"{times} | {card}", flush=True)
            del r
    b, s, h, d = MHA_MASK_RCNN
    with no_tf32():
        for dtype, name, batch in ((torch.bfloat16, "bf16", b), (torch.float32, "f32", 1)):
            q, k, v, mask, dout, out, stats, ref, errs = _mha_case(
                g, f"{MASK_RCNN_B} {name}", batch, s, h, d, dtype, False)
            times = ""
            if dtype == torch.bfloat16:
                t = _mha_times(batch, s, h, d, q, k, v, dout, out, stats, ref)
                times = " " + _mha_times_line(t, mha_bounds(batch, s, h, d, 2, BF16_TC_FLOP_S),
                                              4 * batch * s * s * h * d)
            print(f"mha long kernel: {MASK_RCNN_B} {name} B={batch} S={s} (ragged: no 128-row "
                  f"block divides it) H={h} D={d} " + " ".join(
                      f"{w_}_err={x_:.3e}" for w_, x_ in errs.items()) + times + f" | {card}",
                  flush=True)
            del q, k, v, dout, out, stats, ref
            gc.collect()
            torch.cuda.empty_cache()


def phase_mask_rcnn_cpu_reference(card: str) -> None:
    """A micro Mask R-CNN (MobileViTv2-0.5, 128², the tests' proposal counts)
    on the card through the separable kernels against the same model on the
    CPU (its plain path), float32 with TF32 off, on the same draws and
    targets: the FPN's maps in eval mode within 1e-3 of max(1, their largest)
    (``cpu_reference``'s bound: cuDNN's and the CPU's convs sum in other
    orders), and one training forward's five losses
    (``mask_rcnn_losses_close``)."""
    import copy

    import torch

    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=MASK_RCNN_MICRO_ARGS)
    on_cpu = get_model(opts, device="cpu")
    model = copy.deepcopy(on_cpu).cuda()
    batch = mask_rcnn_batches(1, 2, (128, 128), 5, "cpu", seed=11)[0]["samples"]
    x = batch["image"].float() / 255.0
    draws = on_cpu.draw(2, sum((128 // s) ** 2 * 3 for s in (4, 8, 16, 32)), 100,
                        torch_generator("cpu", 5))
    launches = separable_launches()
    feats, losses = {}, {}
    with no_tf32(), torch.no_grad():
        for net, dev in ((model, "cuda"), (on_cpu, "cpu")):  # copies: BN moves on each alone
            feats[dev] = [f.cpu() for f in net.eval().feature_maps(x.to(dev))]
            pred = net.train()({"image": x.to(dev),
                                "targets": {k: v.to(dev) for k, v in batch["targets"].items()}},
                               draws={k: v.to(dev) for k, v in draws.items()})
            losses[dev] = {k: v.item() for k, v in pred["losses"].items()}
    launched = separable_launches() - launches
    check(launched == 2 * 9, f"Mask R-CNN micro on the card: {launched} separable launches, "
                             "want 9 an eval and 9 a train forward")
    fdiff = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                for a, b in zip(feats["cuda"], feats["cpu"]))
    check(fdiff <= 1e-3, f"Mask R-CNN micro card vs CPU FPN maps differ by {fdiff}")
    ldiff = mask_rcnn_losses_close(losses["cuda"], losses["cpu"])
    print(f"reference: Mask R-CNN micro (MobileViTv2-0.5, 128²) card vs CPU float32: FPN maps "
          f"max diff {fdiff:.3e} of max(1, |map|); losses " + " ".join(
              f"{k}={losses['cuda'][k]:.6f}/{v:.6f}" for k, v in losses["cpu"].items())
          + f" (max rel diff {ldiff:.2e}) | {card}", flush=True)


def separable_launches() -> int:
    from cvnets_tpu_torch.ops.separable_attention import separable_attention_kernel

    return separable_attention_kernel.launches


def phase_mask_rcnn_main_train(card: str) -> None:
    """Path A's ``main_train`` (``MASK_RCNN_A_ARGS``: resize to 512², flip,
    AdamW with the backbone's LR ×0.7, multi_step, EMA, clip 1.0, bf16) over
    a seeded COCO folder with polygon masks written at run time
    (``tools/coco_corpus.py``, ``MASK_RCNN_CORPUS``), 2 epochs and their
    validations, the separable kernels' launches checked each epoch (9 + 9 a
    step, 9 an eval forward) and no host sync between log points; then
    ``main_worker_detection`` with ``--stats.coco-map.iou-types bbox segm`` on
    its val split with the run's checkpoint_last.pt: box and mask mAPs in
    [0, 1]. Prints img/s over epoch 2 after its first batch, beside the
    train loader alone over 2 epochs."""
    import shutil
    import tempfile

    import torch

    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.main_eval import main_worker_detection
    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_bwd_kernel,
        separable_attention_kernel,
    )
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.tools.coco_corpus import write_coco_corpus

    results = os.path.join("results", "mask_rcnn_main_train_smoke")
    shutil.rmtree(results, ignore_errors=True)
    kernels = {"fwd": separable_attention_kernel, "bwd": separable_attention_bwd_kernel}
    per_step = sum(SEP_MASK_RCNN[1].values())
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        n_train, n_val, side = MASK_RCNN_CORPUS
        write_coco_corpus(root, n_train=n_train, n_val=n_val, max_side=side)
        print(f"mask_rcnn: COCO folder of {n_train} + {n_val} JPEG files with polygons "
              f"written in {time.perf_counter() - t0:.2f} s", flush=True)
        args = MASK_RCNN_A_ARGS + ["--dataset.root-train", root, "--dataset.root-val", root,
                                   "--scheduler.max-epochs", "2",
                                   "--common.results-loc", results]
        log = {"train": [], "val": [], "ema": [], "save_s": 0.0}
        watch, built, epochs = SyncWatch(), [], []

        class WatchedTrainer(main_train.Trainer):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                _watch_trainer(self, kernels, watch, per_step, log)
                step, epoch_fn = self._train_step, self.train_epoch

                def counted(state, batch, *rest):
                    if epochs[-1][1] is None:
                        epochs[-1][1] = time.perf_counter()
                    else:
                        epochs[-1][0] += batch["samples"]["image"].shape[0]
                    return step(state, batch, *rest)

                def epoch(e):
                    epochs.append([0, None, None])
                    out = epoch_fn(e)
                    epochs[-1][2] = time.perf_counter()
                    return out

                self._train_step, self.train_epoch = counted, epoch
                built.append(self)

        with watch:
            main_train.Trainer = WatchedTrainer
            try:
                main_train.main_worker(args=args)
            finally:
                main_train.Trainer = WatchedTrainer.__bases__[0]
        trainer = built[0]
        bad = watch.through(MAIN_TRAIN_FILES + (os.path.join("cvnets_tpu_torch", "models")
                                                + os.sep,))
        check(not bad, f"Mask R-CNN main_train: a host sync between log points: {bad[:3]}")
        train_stats = [entry[3] for entry in log["train"]]
        check(len(train_stats) == 2 and all(
            len(s) >= 6 and all(math.isfinite(v) for v in s.values()) for s in train_stats),
            f"Mask R-CNN main_train: train statistics {train_stats}")
        check(all(math.isfinite(v) for s in log["val"] + log["ema"] for v in s.values()),
              f"Mask R-CNN main_train: val statistics {log['val']} {log['ema']}")
        n_steps = trainer.train_iterations
        after_first, first_at, end_at = epochs[-1]
        ckpt = os.path.join(trainer.save_dir, "checkpoint_last.pt")
        trainer = None
        built.clear()
        gc.collect()
        torch.cuda.empty_cache()

        def check_batch(batch):
            x, t = batch["samples"]["image"], batch["samples"]["targets"]
            check(x.dtype == torch.uint8 and x.is_pinned() and tuple(x.shape) == (8, 3, 512, 512)
                  and t["masks"].dtype == torch.bool
                  and tuple(t["masks"].shape) == (8, 100, 128, 128),
                  f"Mask R-CNN loader: batch {tuple(x.shape)} {x.dtype}")

        n_img, secs, first, threads = loader_alone(get_training_arguments(args=args),
                                                   check_batch)
        loader_img_s = (n_img - 8) / (secs - first)
        t0 = time.perf_counter()
        res = main_worker_detection(args=args + ["--model.detection.pretrained", ckpt,
                                                 "--stats.coco-map.iou-types", "bbox", "segm"])
        eval_s = time.perf_counter() - t0
    check({"bbox", "segm"} <= set(res) and all(
        math.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values()),
        f"Mask R-CNN main_worker_detection: {res}")
    print(f"main_train: {MASK_RCNN_A} batch=8 512x512 bf16 epochs=2 steps={n_steps} "
          f"img_s={after_first / (end_at - first_at):.1f} over epoch 2 after its first batch "
          f"({after_first} images in {end_at - first_at:.3f} s; resize, flip and the polygon "
          f"masks rasterized on the loader's threads) train="
          f"{[{k: round(v, 4) for k, v in s.items()} for s in train_stats]} | {card}",
          flush=True)
    print(f"mask_rcnn: loader alone img_s={loader_img_s:.1f} after the first batch ({n_img} "
          f"images of up to {MASK_RCNN_CORPUS[2]} px JPEG files in {secs:.3f} s over 2 epochs, "
          f"first batch after {first:.3f} s; {threads} threads, {os.cpu_count()} cores; pinned "
          f"batches of 8 x 512^2 with their masks, no step) | {card}", flush=True)
    print(f"eval: {MASK_RCNN_A} main_worker_detection on {MASK_RCNN_CORPUS[1]} val images "
          f"in {eval_s:.2f} s: " + " ".join(f"{k}={v:.4f}" for k, v in res.items())
          + f" | {card}", flush=True)


def phase_mask_rcnn(card: str) -> dict:
    """Phase 22, Mask R-CNN through both yamls: the kernels at the slice's
    shapes; per path the bare train steps at batch 8 (launches a step),
    steady steps (step ms, img/s, the host's enqueue, peak), a profile split
    into backbone, FPN, RPN + NMS, RoIAlign, heads and optimizer, with the
    kernels' share, ``predict``, and the kernel vs plain checks (a float32
    forward of the trained model; 3 float32 train steps from the same
    weights, at batch 8 on A and 1 on B); path B's
    step at batch 2 through the kernels against the einsum route (which does
    not fit at 8), with each route's peak; the micro CPU reference; path A
    through ``main_train`` and ``main_worker_detection``. Returns each
    path's kernel launches in its train phase."""
    import torch

    from cvnets_tpu_torch.engine.train_state import OPTIMIZER_RANGE
    from cvnets_tpu_torch.models.detection.mask_rcnn import (
        BACKBONE_RANGE,
        FPN_RANGE,
        HEADS_RANGE,
        ROI_RANGE,
        RPN_RANGE,
    )
    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel
    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_bwd_kernel,
        separable_attention_kernel,
    )

    def release() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    split = (BACKBONE_RANGE, FPN_RANGE, RPN_RANGE, ROI_RANGE, HEADS_RANGE)
    # the host these host-paced steps share: threads left by earlier phases, load
    print(f"mask_rcnn: {threading.active_count()} Python threads alive, load average "
          f"{os.getloadavg()[0]:.2f} on {os.cpu_count()} cores | {card}", flush=True)
    phase_mask_rcnn_kernels(card)
    release()
    launches = {}
    for label, args, kernels, per_step, named, profile in (
            (MASK_RCNN_A, MASK_RCNN_A_ARGS,
             {"separable_attention": separable_attention_kernel,
              "separable_attention_bwd": separable_attention_bwd_kernel},
             sum(SEP_MASK_RCNN[1].values()), "separable_attention_", "mask_rcnn_a_profile.txt"),
            (MASK_RCNN_B, MASK_RCNN_B_ARGS,
             {"mha_attention_fwd": mha_fwd_kernel, "mha_attention_bwd": mha_bwd_kernel},
             VIT_BLOCKS, "::mha_", "mask_rcnn_b_profile.txt")):
        launches[label], run = phase_mask_rcnn_train(card, label, args, kernels, per_step)
        phase_steady(card, label, run, blocks=2, steps=6)
        phase_profile(card, label, run, os.path.join("results", profile), split=split,
                      ranges=(OPTIMIZER_RANGE,), named=(named,))
        phase_mask_rcnn_predict(card, label, run)
        mask_rcnn_held(card, label, run[0].model, run[3][0], 2 if label == MASK_RCNN_A else 1)
        if label == MASK_RCNN_A:
            phase_ab(card, label, run)
        run = None
        release()
        # float32 plain attention at 1024² fits one image a step, not 8
        mask_rcnn_held_steps(card, label, args, 8 if label == MASK_RCNN_A else 1)
        release()
    # path B: the kernels against the einsum route at batch 2, where both fit
    _, run = phase_mask_rcnn_train(card, MASK_RCNN_B + " batch 2", MASK_RCNN_B_ARGS,
                                   {"mha_attention_fwd": mha_fwd_kernel}, VIT_BLOCKS, batch=2,
                                   steps=(1, 1))
    phase_ab(card, MASK_RCNN_B + " batch 2", run)
    run = None
    release()
    phase_mask_rcnn_cpu_reference(card)
    release()
    phase_mask_rcnn_main_train(card)
    return launches


VIT_SEG_ARGS = [  # examples/vit/segmentation/ade20k/deeplabv3_vit_base_clip_os_16.yaml, as
    # flags: its finetune (/mnt, not in the repo) and data roots left out; its
    # composite loss list is ``VIT_SEG_COMPOSITE`` (``path_opts`` sets it)
    "--common.run-label", "train",
    "--common.log-freq", "200",
    "--common.auto-resume",
    "--common.mixed-precision",
    "--common.grad-clip", "10.0",
    "--dataset.name", "ade20k",
    "--dataset.category", "segmentation",
    "--dataset.train-batch-size0", "4",
    "--dataset.val-batch-size0", "4",
    "--dataset.workers", "8",
    "--image-augmentation.random-short-size-resize.enable",
    "--image-augmentation.random-short-size-resize.interpolation", "bilinear",
    "--image-augmentation.random-short-size-resize.short-side-min", "256",
    "--image-augmentation.random-short-size-resize.short-side-max", "768",
    "--image-augmentation.random-short-size-resize.max-img-dim", "1024",
    "--image-augmentation.random-crop.enable",
    "--image-augmentation.random-crop.seg-class-max-ratio", "0.75",
    "--image-augmentation.random-crop.pad-if-needed",
    "--image-augmentation.random-crop.mask-fill", "255",
    "--image-augmentation.random-horizontal-flip.enable",
    "--image-augmentation.resize.enable",
    "--image-augmentation.resize.size", "512", "512",
    "--sampler.name", "batch_sampler",
    "--sampler.bs.crop-size-width", "512",
    "--sampler.bs.crop-size-height", "512",
    "--loss.category", "composite_loss",
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.1",
    "--optim.no-decay-bn-filter-bias",
    "--optim.adamw.beta1", "0.9",
    "--optim.adamw.beta2", "0.999",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "50",
    "--scheduler.warmup-iterations", "500",
    "--scheduler.warmup-init-lr", "1e-06",
    "--scheduler.cosine.max-lr", "3e-05",
    "--scheduler.cosine.min-lr", "3e-06",
    "--model.segmentation.name", "encoder_decoder",
    "--model.segmentation.seg-head", "deeplabv3",
    "--model.segmentation.n-classes", "150",
    "--model.segmentation.output-stride", "16",
    "--model.segmentation.activation.name", "relu",
    "--model.segmentation.deeplabv3.aspp-dropout", "0.1",
    "--model.segmentation.deeplabv3.aspp-out-channels", "512",
    "--model.segmentation.deeplabv3.aspp-rates", "12", "24", "36",
    "--model.classification.name", "vit",
    "--model.classification.vit.mode", "base",
    "--model.classification.vit.norm-layer", "layer_norm",
    "--model.learn-augmentation.mode", "distribution",
    "--model.learn-augmentation.brightness",
    "--model.learn-augmentation.contrast",
    "--model.learn-augmentation.noise",
    "--model.normalization.name", "layer_norm",
    "--model.activation.name", "gelu",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--stats.val", "loss", "iou",
    "--stats.train", "loss",
    "--stats.checkpoint-metric", "iou",
    "--stats.checkpoint-metric-max",
]
VIT_SEG_8_ARGS = VIT_SEG_ARGS + ["--model.segmentation.output-stride", "8"]  # the _os_8 yaml
VIT_SEG_COMPOSITE = [
    {"loss_category": "segmentation", "loss_weight": 1.0,
     "segmentation": {"name": "cross_entropy", "cross_entropy": {"ignore_index": 255}}},
    {"loss_category": "neural_augmentation", "loss_weight": 1.0,
     "neural_augmentation": {"perceptual_metric": "psnr", "target_value": [40, 20],
                             "curriculum_method": "cosine"}},
]
VIT_MOE_ARGS = [  # config/classification/imagenet/vit_moe.yaml, as flags (no data roots)
    "--common.run-label", "train",
    "--common.log-freq", "500",
    "--common.auto-resume",
    "--common.mixed-precision",
    "--common.grad-clip", "1.0",
    "--dataset.name", "imagenet",
    "--dataset.category", "classification",
    "--dataset.train-batch-size0", "128",
    "--dataset.val-batch-size0", "100",
    "--dataset.workers", "8",
    "--image-augmentation.random-resized-crop.enable",
    "--image-augmentation.random-resized-crop.interpolation", "bilinear",
    "--image-augmentation.random-horizontal-flip.enable",
    "--image-augmentation.rand-augment.enable",
    "--image-augmentation.random-erase.enable",
    "--image-augmentation.random-erase.p", "0.25",
    "--image-augmentation.mixup.enable",
    "--image-augmentation.mixup.alpha", "0.2",
    "--image-augmentation.cutmix.enable",
    "--image-augmentation.cutmix.alpha", "1.0",
    "--image-augmentation.resize.enable",
    "--image-augmentation.resize.size", "232",
    "--image-augmentation.center-crop.enable",
    "--image-augmentation.center-crop.size", "224",
    "--sampler.name", "batch_sampler",
    "--sampler.bs.crop-size-width", "224",
    "--sampler.bs.crop-size-height", "224",
    "--loss.category", "classification",
    "--loss.classification.name", "cross_entropy",
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.2",
    "--optim.no-decay-bn-filter-bias",
    "--optim.adamw.beta1", "0.9",
    "--optim.adamw.beta2", "0.999",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "300",
    "--scheduler.warmup-iterations", "7500",
    "--scheduler.warmup-init-lr", "1e-06",
    "--scheduler.cosine.max-lr", "0.002",
    "--scheduler.cosine.min-lr", "2e-05",
    "--model.moe.aux-loss-weight", "0.01",
    "--model.classification.name", "vit",
    "--model.classification.vit.mode", "base",
    "--model.classification.vit.norm-layer", "layer_norm",
    "--model.classification.vit.moe-num-experts", "8",
    "--model.classification.vit.moe-top-k", "2",
    "--model.classification.vit.moe-capacity-factor", "1.25",
    "--model.classification.vit.moe-layer-period", "2",
    "--model.normalization.name", "batch_norm",
    "--model.normalization.momentum", "0.1",
    "--model.activation.name", "gelu",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--stats.val", "loss", "top1", "top5",
    "--stats.train", "loss",
    "--stats.checkpoint-metric", "top1",
    "--stats.checkpoint-metric-max",
]
VIDEO_ARGS = [  # config/video_classification/kinetics/mobilevit_st_small.yaml, as flags
    "--common.run-label", "train",
    "--common.log-freq", "200",
    "--common.auto-resume",
    "--common.mixed-precision",
    "--dataset.name", "kinetics",
    "--dataset.category", "video_classification",
    "--dataset.train-batch-size0", "8",
    "--dataset.val-batch-size0", "8",
    "--dataset.workers", "8",
    "--dataset.persistent-workers",
    "--dataset.pin-memory",
    "--video-reader.name", "frame_folder",
    "--video-reader.frames-per-clip", "8",
    "--video-reader.frame-stack-format", "sequence_first",
    "--video-augmentation.random-resized-crop.enable",
    "--video-augmentation.random-horizontal-flip.enable",
    "--video-augmentation.to-tensor.enable",
    "--sampler.name", "batch_sampler",
    "--sampler.bs.crop-size-width", "256",
    "--sampler.bs.crop-size-height", "256",
    "--model.video-classification.name", "spatio_temporal",
    "--model.video-classification.n-classes", "400",
    "--model.classification.name", "mobilevit",
    "--model.classification.mit.mode", "small",
    "--model.classification.mit.ffn-dropout", "0.0",
    "--model.classification.mit.attn-dropout", "0.0",
    "--model.classification.mit.dropout", "0.1",
    "--model.classification.mit.number-heads", "4",
    "--model.classification.mit.conv-kernel-size", "3",
    "--model.activation.name", "swish",
    "--model.normalization.name", "batch_norm",
    "--model.normalization.momentum", "0.1",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--loss.category", "classification",
    "--loss.classification.name", "cross_entropy",
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "sgd",
    "--optim.weight-decay", "4e-05",
    "--optim.no-decay-bn-filter-bias",
    "--optim.sgd.momentum", "0.9",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "100",
    "--scheduler.warmup-iterations", "3000",
    "--scheduler.warmup-init-lr", "0.05",
    "--scheduler.cosine.max-lr", "0.5",
    "--scheduler.cosine.min-lr", "0.0002",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--stats.val", "loss", "top1", "top5",
    "--stats.train", "loss",
    "--stats.checkpoint-metric", "top1",
    "--stats.checkpoint-metric-max",
]
# the same model, shapes and recipe over MobileViTv2-1.0, whose blocks' cross
# path runs the separable kernels (MobileViT-S's head dims 36, 48 and 60 send
# its attention down the einsum route)
VIDEO_V2_ARGS = VIDEO_ARGS + ["--model.classification.name", "mobilevit_v2",
                              "--model.classification.mitv2.width-multiplier", "1.0"]
VIT_SEG_16, VIT_SEG_8 = "DeepLabv3-ViT-B/16 os16", "DeepLabv3-ViT-B/16 os8"
VIT_MOE = "ViT-B/16-MoE"
VIDEO_V1, VIDEO_V2 = "MobileViT-S spatio-temporal", "MobileViTv2-1.0 spatio-temporal"
REST_PATHS = {VIT_SEG_16: VIT_SEG_ARGS, VIT_SEG_8: VIT_SEG_8_ARGS, VIT_MOE: VIT_MOE_ARGS,
              VIDEO_V1: VIDEO_ARGS, VIDEO_V2: VIDEO_V2_ARGS}
VIDEO_FRAMES = 8
# (B, S) of the MHA calls of each path, 12 heads of 64 (with the CLS token)
MHA_REST = {VIT_SEG_16: (4, 32 * 32 + 1), VIT_SEG_8: (4, 64 * 64 + 1), VIT_MOE: (128, 197)}
SEG_VIT_HEADS = {VIT_SEG_16: 32, VIT_SEG_8: 64}  # the head's logits, to 512², C 150
# (BP, {(N, C): calls a frame}) of the separable cross calls at 8 clips × 256²
SEP_VIDEO = (8 * 4, {(256, 128): 2, (64, 192): 4, (16, 256): 3})
# the learning rate of the loss-falls check: each yaml's peak (past its warmup),
# the video yaml's warmup start (its peak of 0.5 on a fresh model overshoots)
REST_LR = {VIT_SEG_16: 3e-5, VIT_SEG_8: 3e-5, VIT_MOE: 2e-3, VIDEO_V1: 0.05, VIDEO_V2: 0.05}
REST_STEPS = 5  # steps on one repeated batch
MHA_ROW_ERRS = {"fwd": ("out",), "bwd": ("dq", "dk", "dv"), "dq": ("dq",), "dkdv": ("dk", "dv")}


def path_opts(args):
    """The options of ``args``, with the ViT segmentation yamls' composite
    loss where they name one."""
    import copy

    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=args)
    if getattr(opts, "loss.category") == "composite_loss":
        setattr(opts, "loss.composite_loss", copy.deepcopy(VIT_SEG_COMPOSITE))
    return opts


def path_kernels(label: str) -> dict:
    """{name: (wrapper, launches a train step)} of a path's kernels."""
    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel
    from cvnets_tpu_torch.ops.seg_ce_kernel import seg_ce_bwd_kernel, seg_ce_fwd_kernel
    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_bwd_kernel,
        separable_attention_kernel,
    )

    if label == VIDEO_V1:  # head dims 36, 48, 60: the einsum route
        return {}
    if label == VIDEO_V2:
        n = sum(SEP_VIDEO[1].values()) * VIDEO_FRAMES
        return {"separable_attention": (separable_attention_kernel, n),
                "separable_attention_bwd": (separable_attention_bwd_kernel, n)}
    out = {"mha_attention_fwd": (mha_fwd_kernel, VIT_BLOCKS),
           "mha_attention_bwd": (mha_bwd_kernel, VIT_BLOCKS)}
    if label in SEG_VIT_HEADS:  # one head, no aux head
        out.update(seg_ce_fwd=(seg_ce_fwd_kernel, 1), seg_ce_bwd=(seg_ce_bwd_kernel, 1))
    return out


def path_corpus_args(label: str, corpora: dict, tmp: str) -> list:
    """The data roots of a path's corpus, written under ``tmp`` at its first
    use (``corpora`` keeps them): ADE20k JPEG images with PNG masks (8 + 4),
    a JPEG ImageNet corpus of 8 classes × 16 + 4 files, Kinetics frame
    folders (4 classes × 4 videos × 12 frames)."""
    if label in SEG_VIT_HEADS:
        if "ade20k" not in corpora:
            corpora["ade20k"] = write_ade20k_corpus(os.path.join(tmp, "ade20k"))
        return ["--dataset.root-train", corpora["ade20k"],
                "--dataset.root-val", corpora["ade20k"]]
    if label == VIT_MOE:
        if "imagenet" not in corpora:
            corpora["imagenet"] = write_jpeg_corpus(os.path.join(tmp, "imagenet"),
                                                    train_per_class=16, val_per_class=4)
        return ["--dataset.root-train", corpora["imagenet"]["train"],
                "--dataset.root-val", corpora["imagenet"]["val"]]
    if "kinetics" not in corpora:
        corpora["kinetics"] = write_kinetics_corpus(os.path.join(tmp, "kinetics"))
    return ["--dataset.root-train", corpora["kinetics"], "--dataset.root-val",
            corpora["kinetics"]]


def loader_batch(opts) -> dict:
    """The first training batch of ``opts``' train loader (the yaml's
    dataset, transforms, sampler and collate on its corpus; ImageNet's
    through the native decoder on the card), on the card. The loader gets a
    copy of the options: its dataset writes its own class count into them."""
    import copy

    from cvnets_tpu_torch.data.data_loaders import create_train_val_loader
    from cvnets_tpu_torch.engine.train_state import to_device

    loader_opts = copy.deepcopy(opts)
    setattr(loader_opts, "dataset.disable_val", True)
    train_loader, _, _ = create_train_val_loader(loader_opts, pin_memory=True, device="cuda")
    for batch in train_loader:
        return to_device(batch, "cuda")
    raise RuntimeError("check failed: the corpus's train loader yielded no batch")


def phase_rest_train(card: str, label: str, data_args: list, augment: bool = False):
    """``REST_STEPS`` train steps of a path, its model from the yaml's flags at
    full width, on one repeated batch (the first of its train loader over
    ``data_args``' corpus) at its ``REST_LR``: the launches of each of its kernels a step, the loss finite
    and falling, params and EMA moved. ``augment``: the yaml's device tier
    and mixing too (ViT-B/16-MoE's RandAugment, erasing, mixup and cutmix),
    for the steps phase_steady times afterwards. Returns the launches in
    those steps and (state, step, scheduler, batches, criteria)."""
    import torch

    from cvnets_tpu_torch.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.ops.image_ops import build_device_augmenter
    from cvnets_tpu_torch.ops.mixing import build_mixing_fn
    from cvnets_tpu_torch.optim import build_optimizer
    from cvnets_tpu_torch.optim.scheduler import build_scheduler

    opts = path_opts(REST_PATHS[label] + data_args)
    model = get_model(opts)
    state = create_train_state(model, build_optimizer(opts, model, model.get_lr_multipliers(opts)),
                               ema_enabled=True)
    criteria = build_loss_fn(opts)
    metrics = build_metrics(opts, ["loss", "grad_norm"])
    step = make_train_step(model, criteria, opts, metrics)
    batch = loader_batch(opts)
    kernels = path_kernels(label)
    params0 = [p.detach().clone() for p in model.parameters()]
    ema0 = [t.detach().clone() for t in state.ema.model.state_dict().values()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel, _ in kernels.values():
        kernel.launches = 0
    losses, step_s = [], []
    for _ in range(REST_STEPS):
        t0 = time.perf_counter()
        state, out = step(state, batch, REST_LR[label])
        losses.append(out["loss"]["loss"][0].item())  # a read-back: the step ends here
        step_s.append(time.perf_counter() - t0)
    launches = {name: kernel.launches for name, (kernel, _) in kernels.items()}
    for name, (kernel, per_step) in kernels.items():
        check(kernel.launches == per_step * REST_STEPS,
              f"{label}: {kernel.launches} {name} launches in {REST_STEPS} steps, want "
              f"{per_step} a step")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"{label}: the loss on one repeated batch is not finite and falling: {losses}")
    check(any(not torch.equal(a, b) for a, b in zip(params0, model.parameters())),
          f"{label}: params did not change")
    check(any(not torch.equal(a, b) for a, b in zip(ema0, state.ema.model.state_dict().values())),
          f"{label}: EMA did not change")
    del params0, ema0
    print(f"rest train: {label} batch={tuple(batch['samples'].shape)} bf16 lr={REST_LR[label]} "
          f"losses={[round(v, 4) for v in losses]} step_s={[round(s, 4) for s in step_s]} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.2f} launches={launches} "
          f"a step={ {k: v // REST_STEPS for k, v in launches.items()} } | {card}", flush=True)
    if augment:
        step = make_train_step(model, criteria, opts, metrics,
                               augment_fn=build_device_augmenter(opts),
                               mixing_fn=build_mixing_fn(opts))
    return launches, (state, step, build_scheduler(opts), [batch] * 3, criteria)


def phase_rest_held(card: str, label: str, run) -> None:
    """The trained model's float32 eval logits (TF32 off) through the kernels
    against the plain path on two samples (MobileViT-S's, with no kernel,
    against a CPU copy), and for the segmentation paths the composite loss
    of the batch's train-mode outputs through the seg-CE kernels against the
    unfused CE (1e-5 relative)."""
    import torch

    from cvnets_tpu_torch.engine.train_state import VIDEO_BATCH_DIMS

    state, _, _, batches, criteria = run
    model = state.model
    x = batches[0]["samples"][:2].float() / 255.0
    if x.dim() == VIDEO_BATCH_DIMS:  # a video's first clip: (B, T, 3, H, W)
        x = x[:, 0]
    if label == VIDEO_V1:
        cpu_reference(label, model, x, (2, getattr(path_opts(VIDEO_ARGS),
                                                    "model.video_classification.n_classes")))
        return
    model.eval()
    with no_tf32(), torch.no_grad():
        with_kernel = model(x)
        set_use_kernel(model, False)
        plain = model(x)
    set_use_kernel(model, True)
    diff, scale = (with_kernel - plain).abs().max().item(), plain.abs().max().item()
    check(bool(torch.isfinite(with_kernel).all()) and diff <= 1e-4 * max(1.0, scale),
          f"{label}: kernel vs plain logits differ by {diff} (max {scale})")
    line = (f"reference: {label} kernel-path vs plain-path float32 logits "
            f"{tuple(with_kernel.shape)} max diff {diff:.3e} (max |logit| {scale:.3e})")
    if label in SEG_VIT_HEADS:
        model.train()
        b = batches[0]
        with no_tf32(), torch.no_grad():
            out = model(b["samples"].float() / 255.0)
            both = []
            for on in (True, False):
                set_use_kernel(model, on, criteria)
                both.append(criteria(b["samples"].float() / 255.0, out, b["targets"].long(),
                                     training=True, epoch=0, iterations=0))
        set_use_kernel(model, True, criteria)
        for key in both[0]:
            got, ref = float(both[0][key]), float(both[1][key])
            check(abs(got - ref) <= 1e-5 * max(abs(ref), 1e-6),
                  f"{label}: {key} kernel {got} vs plain {ref}")
        check(float(both[0]["neural_augmentation"]) == 0.0,
              f"{label}: a segmentation encoder's neural-augmentation term is 0")
        line += "; composite loss kernel/plain " + " ".join(
            f"{k}={float(both[0][k]):.7f}/{float(both[1][k]):.7f}" for k in both[0])
    print(line + f" | {card}", flush=True)


def profile_kernel_ms(fn, parts: tuple) -> dict:
    """Device ms a call of ``fn`` of the kernels whose names hold each of
    ``parts``, by ``torch.profiler`` over 5 calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    out = {p: 0.0 for p in parts}
    for ev in prof.key_averages():
        for p in parts:
            if p in ev.key:
                out[p] += ev.self_device_time_total / 1e3 / 5
    return out


def phase_rest_kernels(card: str, timed: bool, labels=tuple(REST_PATHS)) -> dict:
    """The kernels at the new paths' shapes against their plain versions:
    the MHA kernels at DeepLabv3-ViT-B/16's S = 1,025 and 4,097 (batch 4,
    bf16; f32 at batch 1) and ViT-B/16-MoE's (128, 197); the seg-CE kernels
    from (4, 32², 150) and (4, 64², 150) head logits to 512² labels (f32 and
    bf16 logits: loss and dlogits; the forward's (loss_sum, n_valid) and the
    backward's dhm against their plain versions, the same bits on a rerun);
    the separable kernels at MobileViTv2-1.0's video shapes (BP 32), and its
    layer's cross path (q, k from the previous frame, v from this one,
    concatenated into one qkv) against the layer's plain branch, output and
    the gradients of both frames and the projections. ``timed``: each also
    timed by events and by the profiler, beside its plain version, its bound
    and the library call (SDPA at the MHA shapes), and the concatenation
    before the cross kernel. Returns {path: {row: record}} for the JSON line."""
    import torch

    from cvnets_tpu_torch.layers.linear_attention import LinearSelfAttention
    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel
    from cvnets_tpu_torch.ops.seg_ce import fused_resize_ce, resize_ce_plain, resize_matrix
    from cvnets_tpu_torch.ops.seg_ce import resize_taps
    from cvnets_tpu_torch.ops.seg_ce_kernel import (
        h_interp,
        seg_ce_bwd_kernel,
        seg_ce_bwd_plain,
        seg_ce_fwd_kernel,
        seg_ce_fwd_plain,
    )
    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_kernel,
        separable_attention_plain,
    )
    from cvnets_tpu_torch.options.opts import get_training_arguments

    g = torch.Generator(device="cuda").manual_seed(24)
    records = {}
    h, d = 12, 64
    with no_tf32():
        for label, (b, s) in MHA_REST.items():
            if label not in labels:
                continue
            rows = ("fwd", "dq", "dkdv") if s > 512 else ("fwd", "bwd")
            rec = records[label] = _records(*rows)
            for dtype, name, batch in ((torch.bfloat16, "bf16", b), (torch.float32, "f32", 1)):
                if label == VIT_MOE and dtype == torch.float32:
                    continue  # phase 4 holds (128, 197) in f32
                q, k, v, mask, dout, out, stats, ref, errs = _mha_case(
                    g, f"{label} {name}", batch, s, h, d, dtype, False)
                times = ""
                if dtype == torch.bfloat16:
                    for r in rows:
                        rec[r]["max_abs_err"] = max(errs[w] for w in MHA_ROW_ERRS[r])
                if timed and dtype == torch.bfloat16:
                    t = _mha_times(batch, s, h, d, q, k, v, dout, out, stats, ref)
                    dev = profile_kernel_ms(lambda: mha_bwd_kernel(q, k, v, None, out, dout,
                                                                   stats, h),
                                            ("mha_bwd_prep", "mha_bwd_dq", "mha_bwd_dkdv"))
                    dev_fwd = profile_kernel_ms(lambda: mha_fwd_kernel(q, k, v, h, None),
                                                ("mha_fwd",))["mha_fwd"]
                    bounds = mha_bounds(batch, s, h, d, 2, BF16_TC_FLOP_S)
                    bwd_dev = sum(dev.values())
                    share = {"dq": (dev["mha_bwd_prep"] + dev["mha_bwd_dq"]) / bwd_dev,
                             "dkdv": dev["mha_bwd_dkdv"] / bwd_dev, "bwd": 1.0}
                    for r in rows:
                        src = "fwd" if r == "fwd" else "bwd"
                        split = 1.0 if r in ("fwd", "bwd") else BWD_ROW_SHARE[r]
                        rec[r].update(
                            ms=VIT_BLOCKS * (t["fwd"] if r == "fwd" else share[r] * t["bwd"]),
                            device_ms=VIT_BLOCKS * (dev_fwd if r == "fwd"
                                                    else share[r] * bwd_dev),
                            plain_ms=VIT_BLOCKS * split * t[f"{src}_plain"],
                            bound_ms=VIT_BLOCKS * split * bounds[src][0],
                            bound_by=bounds[src][1])
                        _mha_library(rec[r], t, src, VIT_BLOCKS * split)
                    times = (" " + _mha_times_line(t, bounds, 4 * batch * s * s * h * d)
                             + f" | profiler: fwd_ms={dev_fwd:.4f} " + " ".join(
                                 f"{p}={ms:.4f}" for p, ms in dev.items()))
                print(f"rest mha kernel: {label} {name} B={batch} S={s} H={h} D={d} "
                      + " ".join(f"{w}_err={x:.3e}" for w, x in errs.items()) + times
                      + f" | {card}", flush=True)
                del q, k, v, dout, out, stats, ref
                gc.collect()
                torch.cuda.empty_cache()

        c, big = 150, 512
        for label, head in SEG_VIT_HEADS.items():
            if label not in labels:
                continue
            logits = 2.0 * torch.randn((4, c, head, head), generator=g,
                                       device="cuda").permute(0, 2, 3, 1)
            target = torch.randint(0, c, (4, big, big), generator=g, device="cuda")
            target[torch.rand(target.shape, generator=g, device="cuda") < 0.05] = 255
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                losses, grads = [], []
                for fn in (fused_resize_ce, resize_ce_plain):
                    x = logits.to(dtype, copy=True).requires_grad_()
                    loss = fn(x, target)
                    loss.backward()
                    losses.append(loss.detach().float())
                    grads.append(x.grad.float())
                gmax = grads[1].abs().max().item()
                lerr = (losses[0] - losses[1]).abs().item()
                gerr = (grads[0] - grads[1]).abs().max().item()
                gtol = (1e-4 if dtype == torch.float32 else 2 ** -7) * gmax
                check(lerr <= 1e-5 * losses[1].abs().item() and gerr <= gtol,
                      f"{label} seg ce {dtype}: loss err {lerr}, dlogits err {gerr} > {gtol}")
                errs[f"{str(dtype)[6:]}_loss"], errs[f"{str(dtype)[6:]}_dlogits"] = lerr, gerr
            a = resize_matrix(big, head, logits.device)
            taps = resize_taps(big, head, logits.device)
            fwd_err = _seg_fwd_check(f"{label} C={c}", logits, target, a, taps, None, 0.0)
            hmid = h_interp(logits, a)
            dhm_err = _seg_dhm_check(f"{label} C={c}", hmid, target, a, taps, None, 0.0)
            rec = records[label]
            rec.update(_records("seg_fwd", "seg_bwd"))
            rec["seg_fwd"]["max_abs_err"], rec["seg_bwd"]["max_abs_err"] = fwd_err, max(
                errs["bfloat16_dlogits"], errs["float32_dlogits"])
            times = ""
            if timed:
                scale = torch.full((1,), 1e-6, device=logits.device)
                fwd = lambda: seg_ce_fwd_kernel(logits, target, taps, taps, None, 255, 0.0)  # noqa
                bwd = lambda: seg_ce_bwd_kernel(hmid, target, taps, None, scale, 255, 0.0)  # noqa
                t = {"fwd": time_ms(fwd),
                     "fwd_plain": time_ms(lambda: seg_ce_fwd_plain(h_interp(logits, a), a,
                                                                   target, None, 255, 0.0)),
                     "bwd": time_ms(bwd),
                     "bwd_plain": time_ms(lambda: seg_ce_bwd_plain(hmid, a, target, None,
                                                                   scale, 255, 0.0))}
                dev = {"fwd": sum(profile_kernel_ms(fwd, ("seg_ce_fwd",)).values()),
                       "bwd": sum(profile_kernel_ms(bwd, ("seg_ce_bwd",)).values())}
                bounds = seg_ce_bounds(logits, target)
                for p in ("fwd", "bwd"):
                    rec[f"seg_{p}"].update(ms=t[p], device_ms=dev[p], plain_ms=t[f"{p}_plain"],
                                           bound_ms=bounds[p][0], bound_by=bounds[p][1])
                times = " " + " ".join(f"{k_}_ms={v_:.4f}" for k_, v_ in t.items()) + " " + \
                    " ".join(f"{p}_device_ms={dev[p]:.4f} {p}_bound_ms={bounds[p][0]:.4f} "
                             f"({bounds[p][1]})" for p in ("fwd", "bwd"))
            print(f"rest seg ce kernel: {label} B=4 h=w={head} H=W={big} C={c} " + " ".join(
                f"{k_}_err={v_:.3e}" for k_, v_ in errs.items())
                + f" fwd_mean_err={fwd_err:.3e} dhm_err={dhm_err:.3e}{times} | {card}",
                flush=True)
            del logits, target, hmid
            torch.cuda.empty_cache()

    if VIDEO_V2 not in labels:
        return records
    rec = records[VIDEO_V2] = _records("fwd", "bwd")
    bp, blocks = SEP_VIDEO
    opts = get_training_arguments(args=[])
    for (n, c), calls in blocks.items():
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            r = _separable_case(g, bp, n, c, dtype, name)
            if dtype == torch.bfloat16:
                rec["fwd"]["max_abs_err"] = max(rec["fwd"]["max_abs_err"], r["abs_err"])
                rec["bwd"]["max_abs_err"] = max(rec["bwd"]["max_abs_err"], r["gerr"])
            # the layer's cross path against its plain branch
            torch.manual_seed(0)
            layer = LinearSelfAttention(opts, c).cuda().to(dtype)
            x, x_prev, w = (torch.randn((bp // 4, 4, n, c), generator=g, device="cuda")
                            .to(dtype) for _ in range(3))
            results = []
            for on in (True, False):
                layer.use_kernel = on
                layer.zero_grad()
                a_, b_ = (t_.detach().clone().requires_grad_() for t_ in (x, x_prev))
                out = layer(a_, b_)
                out.backward(w)
                results.append([out.detach(), a_.grad, b_.grad]
                               + [p.grad.clone() for p in layer.parameters()])
            torch.cuda.synchronize()
            cross_err = 0.0
            for i, (got, want) in enumerate(zip(*results)):
                scale = max(want.float().abs().max().item(), 1.0)
                err = (got.float() - want.float()).abs().max().item()
                tol = (1e-4 if dtype == torch.float32 else 2e-2) * scale
                check(bool(torch.isfinite(got).all()) and err <= tol,
                      f"{VIDEO_V2} cross path ({bp},{n},{c}) {name} tensor {i}: err {err} > {tol}")
                cross_err = max(cross_err, err / scale)
            times = ""
            if timed and dtype == torch.bfloat16:
                q, k, v = r["q"], r["k"], r["v"]
                qk = torch.randn((bp, n, 1 + c), generator=g, device="cuda").to(dtype)
                vv = torch.randn((bp, n, c), generator=g, device="cuda").to(dtype)
                t = {"fwd": time_ms(lambda: separable_attention_kernel(q, k, v)),
                     "fwd_plain": time_ms(lambda: separable_attention_plain(q, k, v)),
                     "bwd": time_ms(r["bwd_kernel"]), "bwd_plain": time_ms(r["bwd_plain"]),
                     "cat": time_ms(lambda: torch.cat([qk, vv], dim=-1))}
                dev = {"fwd": profile_kernel_ms(lambda: separable_attention_kernel(q, k, v),
                                                ("",))[""],
                       "bwd": profile_kernel_ms(r["bwd_kernel"], ("",))[""],
                       "cat": profile_kernel_ms(lambda: torch.cat([qk, vv], dim=-1), ("",))[""]}
                check(all(ms > 0 for ms in dev.values()), f"the profiler saw no kernel: {dev}")
                qkv = r["qkv"]
                bounds = {"fwd": bound(qkv.numel() * 2 + bp * n * c * 2,
                                       (4 * bp * n * c, FP32_FLOP_S), (bp * n, SFU_EXP_S)),
                          "bwd": bound((5 * c + 2) * bp * n * 2, (7 * bp * n * c, FP32_FLOP_S),
                                       (bp * n, SFU_EXP_S))}
                per_step = calls * VIDEO_FRAMES
                for p in ("fwd", "bwd"):
                    rec[p]["ms"] += per_step * t[p]
                    rec[p]["device_ms"] = rec[p].get("device_ms", 0.0) + per_step * dev[p]
                    rec[p]["plain_ms"] += per_step * t[f"{p}_plain"]
                    rec[p]["bound_ms"] += per_step * bounds[p][0]
                    rec[p]["bound_by"] = bounds[p][1]
                rec["fwd"]["cat_ms"] = rec["fwd"].get("cat_ms", 0.0) + per_step * t["cat"]
                times = (" " + " ".join(f"{k_}_ms={v_:.4f}" for k_, v_ in t.items())
                         + " " + " ".join(f"{k_}_device_ms={v_:.4f}" for k_, v_ in dev.items())
                         + f" fwd_bound_ms={bounds['fwd'][0]:.4f} ({bounds['fwd'][1]})"
                         f" bwd_bound_ms={bounds['bwd'][0]:.4f} ({bounds['bwd'][1]})"
                         f" cat/fwd={t['cat'] / t['fwd']:.3f} calls_a_step={per_step}")
            print(f"rest kernel: {VIDEO_V2} {name} BP={bp} N={n} C={c} max_abs_err="
                  f"{r['abs_err']:.3e} grad_err={r['gerr']:.3e} | cross path vs plain branch "
                  f"max err {cross_err:.3e} of max(1, |ref|){times} | {card}", flush=True)
            del r, layer
    return records


def write_ade20k_corpus(root: str, n_train: int = 8, n_val: int = 4, seed: int = 0) -> str:
    """ADEChallengeData2016's layout under ``root``: seeded JPEG images of
    about ADE20k's 683 × 512 (either way round) and PNG masks of raw labels
    0-150 in blobs (a 6 × 8 grid scaled up by nearest neighbour)."""
    import numpy as np
    from PIL import Image

    for split, n in (("training", n_train), ("validation", n_val)):
        os.makedirs(os.path.join(root, "images", split))
        os.makedirs(os.path.join(root, "annotations", split))
        for i in range(n):
            rng = np.random.default_rng([seed, i, int(split == "training")])
            h, w = int(rng.integers(410, 615)), int(rng.integers(546, 820))
            if i % 3 == 0:
                h, w = w, h
            Image.fromarray(_corpus_image(rng, h, w)).save(
                os.path.join(root, "images", split, f"ADE_{i:05d}.jpg"), quality=90)
            coarse = rng.integers(0, 151, (6, 8)).astype(np.uint8)
            Image.fromarray(coarse[np.arange(h) * 6 // h][:, np.arange(w) * 8 // w]).save(
                os.path.join(root, "annotations", split, f"ADE_{i:05d}.png"))
    return root


def write_kinetics_corpus(root: str, n_classes: int = 4, per_class: int = 4,
                          n_frames: int = 12, hw: tuple = (240, 320), seed: int = 0) -> str:
    """Kinetics' layout under ``root``: ``<class>/<video>/frame_*.jpg``,
    seeded frames that drift from one to the next."""
    import numpy as np
    from PIL import Image

    for c in range(n_classes):
        for v in range(per_class):
            folder = os.path.join(root, f"class_{c:03d}", f"video_{v:03d}")
            os.makedirs(folder)
            rng = np.random.default_rng([seed, c, v])
            base = _corpus_image(rng, hw[0] + n_frames * 4, hw[1])
            for t in range(n_frames):
                Image.fromarray(np.ascontiguousarray(base[4 * t:4 * t + hw[0]])).save(
                    os.path.join(folder, f"frame_{t:04d}.jpg"), quality=90)
    return root


def rest_main_train(card: str, label: str, args: list, kernels: dict, per_step: int):
    """``main_train.main`` on ``args`` (the yaml's flags and a corpus), one
    epoch and its validations, the kernels' launches counted every epoch,
    finite statistics, no host sync through the port's data, ops, loss,
    engine, metrics or checkpoint code between log points. Returns the
    options, the Trainer's save dir and its log."""
    import cvnets_tpu_torch.main_train as main_train

    opts = path_opts(args)
    log = {"train": [], "val": [], "ema": [], "save_s": 0.0}
    watch, built = SyncWatch(), []

    class WatchedTrainer(main_train.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            _watch_trainer(self, kernels, watch, per_step, log)
            built.append(self)

    with watch:
        main_train.Trainer = WatchedTrainer
        try:
            main_train.main(opts)
        finally:
            main_train.Trainer = WatchedTrainer.__bases__[0]
    trainer = built[0]
    bad = watch.through(MAIN_TRAIN_FILES)
    check(not bad, f"{label} main_train: a host sync between log points: {bad[:3]}")
    for stage in ("train", "val", "ema"):
        values = [v for entry in log[stage] for v in
                  (entry[3] if stage == "train" else entry).values()]
        check(values and all(math.isfinite(v) for v in values),
              f"{label} main_train: {stage} statistics not finite: {log[stage]}")
    rounded = lambda stats: [{k: round(v, 4) for k, v in s.items()} for s in stats]  # noqa: E731
    n_img = trainer.train_iterations * getattr(opts, "dataset.train_batch_size0")
    print(f"rest main_train: {label} steps={trainer.train_iterations} epoch_s="
          f"{log['train'][-1][1]:.3f} ({n_img / log['train'][-1][1]:.1f} samples/s, the "
          f"loader's first batch included) train={rounded([e[3] for e in log['train']])} "
          f"val={rounded(log['val'])} ema={rounded(log['ema'])} | {card}", flush=True)
    save_dir = trainer.save_dir
    built.clear()
    gc.collect()
    return opts, save_dir, log


def phase_vit_segmentation_main_train(card: str, tmp: str) -> None:
    """DeepLabv3-ViT-B/16 os16 through ``main_train`` on an ADE20k folder
    written here (8 + 4 files), then ``main_segmentation_evaluation`` of its
    ``checkpoint_ema_last.pt`` over the same validation files at the same
    batch, whose mIoU is the last EMA validation's."""
    import copy

    from cvnets_tpu_torch.engine.eval_segmentation import main_segmentation_evaluation
    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel

    root = write_ade20k_corpus(os.path.join(tmp, "ade20k"))
    args = VIT_SEG_ARGS + ["--dataset.root-train", root, "--dataset.root-val", root,
                           "--scheduler.max-epochs", "1", "--dataset.workers", "4",
                           "--common.results-loc", os.path.join(tmp, "vit_seg_results")]
    opts, save_dir, log = rest_main_train(card, VIT_SEG_16, args, {
        "fwd": mha_fwd_kernel, "bwd": mha_bwd_kernel}, VIT_BLOCKS)
    eval_opts = copy.deepcopy(opts)
    setattr(eval_opts, "model.segmentation.pretrained",
            os.path.join(save_dir, "checkpoint_ema_last.pt"))
    setattr(eval_opts, "dataset.eval_batch_size0", getattr(opts, "dataset.val_batch_size0"))
    miou = main_segmentation_evaluation(eval_opts, device="cuda")
    want = log["ema"][-1]["iou"]
    check(abs(miou - want) <= 1e-2, f"{VIT_SEG_16}: main_segmentation_evaluation mIoU {miou} "
                                    f"vs the last EMA validation's iou {want}")
    print(f"rest main_eval: {VIT_SEG_16} main_segmentation_evaluation miou={miou!r} (last EMA "
          f"validation {want!r}) | {card}", flush=True)


def phase_moe_main_train(card: str, tmp: str) -> None:
    """ViT-B/16-MoE through ``main_train`` with the yaml's native-decoder
    loader, RandAugment, erasing, mixup and cutmix over a JPEG corpus (8
    classes × 32 + 8 files), then ``main_eval`` of its
    ``checkpoint_ema_last.pt``, whose top-1 is the last EMA validation's."""
    from cvnets_tpu_torch.main_eval import main_worker as main_eval
    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel

    corpus = write_jpeg_corpus(os.path.join(tmp, "moe_corpus"), train_per_class=32,
                               val_per_class=8)
    args = VIT_MOE_ARGS + corpus_args(corpus) + [
        "--scheduler.max-epochs", "1", "--dataset.val-batch-size0", "32",
        "--common.results-loc", os.path.join(tmp, "moe_results")]
    _, save_dir, log = rest_main_train(card, VIT_MOE, args, {
        "fwd": mha_fwd_kernel, "bwd": mha_bwd_kernel}, VIT_BLOCKS)
    stats = main_eval(args=args + ["--model.classification.pretrained",
                                   os.path.join(save_dir, "checkpoint_ema_last.pt"),
                                   "--dataset.eval-batch-size0", "32"])
    want = log["ema"][-1]["top1"]
    check(abs(stats["top1"] - want) <= 1e-3,
          f"{VIT_MOE}: main_eval top1 {stats['top1']} vs the last EMA validation's {want}")
    print(f"rest main_eval: {VIT_MOE} main_eval {stats} (last EMA validation top1 {want!r}) "
          f"| {card}", flush=True)


def phase_video_main_train(card: str, tmp: str) -> None:
    """MobileViT-S spatio-temporal through ``main_train`` on a Kinetics tree
    of JPEG frame folders written here (4 classes × 4 videos × 12 frames),
    then ``main_eval`` of its ``checkpoint_ema_last.pt``: with one clip a
    video its top-1 is the last EMA validation's; with two, it votes over
    them."""
    from cvnets_tpu_torch.main_eval import main_worker as main_eval

    root = write_kinetics_corpus(os.path.join(tmp, "kinetics"))
    args = VIDEO_ARGS + ["--dataset.root-train", root, "--dataset.root-val", root,
                         "--scheduler.max-epochs", "1", "--dataset.workers", "4",
                         "--common.results-loc", os.path.join(tmp, "video_results")]
    _, save_dir, log = rest_main_train(card, VIDEO_V1, args, {}, 0)
    ckpt = ["--model.video-classification.pretrained",
            os.path.join(save_dir, "checkpoint_ema_last.pt"), "--dataset.eval-batch-size0", "8"]
    one = main_eval(args=args + ckpt)
    two = main_eval(args=args + ckpt + ["--video-reader.clips-per-video", "2",
                                        "--common.inference-modality", "video"])
    want = log["ema"][-1]["top1"]
    check(abs(one["top1"] - want) <= 1e-3 and all(0.0 <= s["top1"] <= 100.0 for s in (one, two)),
          f"{VIDEO_V1}: main_eval top1 {one['top1']} vs the last EMA validation's {want}")
    print(f"rest main_eval: {VIDEO_V1} main_eval one clip {one} (last EMA validation top1 "
          f"{want!r}); two clips voted by sum {two} | {card}", flush=True)


def phase_aspp_conv(card: str) -> None:
    """The ViT yamls' ASPP 3×3 convs (768 → 512 channels, dilation 12, 24 and
    36, padding = dilation) at batch 4 on the 32² (os16) and 64² (os8) maps,
    bf16 forward + backward, timed by events under cuDNN's default choice
    and under ``torch.backends.cudnn.benchmark``, NCHW and channels-last:
    what the step's profile shows as cuDNN's direct dilated conv. Measured,
    not changed."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(5)
    saved = torch.backends.cudnn.benchmark
    try:
        for side in (32, 64):
            x0 = torch.randn((4, 768, side, side), generator=g, device="cuda").to(torch.bfloat16)
            parts = []
            for rate in (12, 24, 36):
                conv = torch.nn.Conv2d(768, 512, 3, padding=rate, dilation=rate,
                                       bias=False).cuda().to(torch.bfloat16)
                for layout in ("nchw", "channels_last"):
                    fmt = torch.channels_last if layout == "channels_last" else \
                        torch.contiguous_format
                    c, x = conv.to(memory_format=fmt), x0.to(memory_format=fmt)
                    x.requires_grad_(True)
                    for bench in (False, True):
                        torch.backends.cudnn.benchmark = bench

                        def fwd_bwd():
                            c(x).sum().backward()

                        parts.append(f"rate {rate} {layout} benchmark={bench}: "
                                     f"{time_ms(fwd_bwd, launches=3, samples=5, warmup=2):.3f}")
            print(f"aspp conv: 4 x 768 x {side}² -> 512, 3x3 dilated, bf16 fwd+bwd ms: "
                  + "; ".join(parts) + f" | {card}", flush=True)
    finally:
        torch.backends.cudnn.benchmark = saved


REST_FLAGS = {"--vit-segmentation": ((VIT_SEG_16, VIT_SEG_8), phase_vit_segmentation_main_train),
              "--moe": ((VIT_MOE,), phase_moe_main_train),
              "--video": ((VIDEO_V1, VIDEO_V2), phase_video_main_train)}


def phase_rest_profile(card: str, label: str, run) -> None:
    """A profile of 3 steps (results/<path>_profile.txt): the step's device
    time, its kernels' share, MoE's routing, expert products and combine."""
    from cvnets_tpu_torch.engine.train_state import OPTIMIZER_RANGE
    from cvnets_tpu_torch.layers.multi_head_attention import EINSUM_ROUTE
    from cvnets_tpu_torch.modules.moe import MOE_COMBINE, MOE_EXPERTS, MOE_ROUTE

    name = label.replace("/", "_").replace(" ", "_").lower()
    kwargs = {"ranges": (OPTIMIZER_RANGE,)}
    if label == VIT_MOE:
        kwargs.update(split=(MOE_ROUTE, MOE_EXPERTS, MOE_COMBINE), named=("::mha_",))
    elif label in SEG_VIT_HEADS:
        kwargs.update(named=("::mha_", "seg_ce"))
    elif label == VIDEO_V2:
        kwargs.update(named=("separable",))
    else:
        kwargs.update(route=EINSUM_ROUTE)
    phase_profile(card, label, run, os.path.join("results", f"{name}_profile.txt"), **kwargs)


def phase_rest(card: str, labels=tuple(REST_PATHS), full: bool = False) -> tuple:
    """Phase 23: the paths of ``labels`` (all five in the whole run, briefly):
    the kernels at their shapes (``phase_rest_kernels``), then for each path
    ``phase_rest_train`` on its corpus (``path_corpus_args``) and
    ``phase_rest_held``; ``full``: the kernels timed,
    and each path's steady steps and profile. Returns the launches of each
    path's train steps by path and the kernels' records by path."""
    import tempfile

    import torch

    records = phase_rest_kernels(card, timed=full, labels=labels)
    launches, corpora = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label in labels:
            data_args = path_corpus_args(label, corpora, tmp)
            launches[label], run = phase_rest_train(card, label, data_args,
                                                    augment=full and label == VIT_MOE)
            phase_rest_held(card, label, run)
            if full:
                phase_steady(card, label, run, blocks=2, steps=6)
                phase_rest_profile(card, label, run)
            run = None
            gc.collect()
            torch.cuda.empty_cache()
    return launches, records


def main(argv) -> int:
    import torch

    if argv not in ([], ["--deeplab"], ["--segmentation"], ["--families"], ["--clip"],
                    ["--range-augment"], ["--byteformer"], ["--mask-rcnn"],
                    *([flag] for flag in REST_FLAGS)):
        print(f"chip_smoke: unknown arguments {argv}; usage: chip_smoke.py "
              "[--deeplab | --segmentation | --families | --clip | --range-augment | "
              "--byteformer | --mask-rcnn | --vit-segmentation | --moe | --video]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import cvnets_tpu_torch  # noqa: F401  (fails here, before any output, outside the repo)
    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel
    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_bwd_kernel,
        separable_attention_kernel,
    )
    from cvnets_tpu_torch.ops.window_attention import window_bwd_kernel, window_fwd_kernel

    def release() -> None:  # each phase's peak memory is its own
        gc.collect()
        torch.cuda.empty_cache()

    card = phase_device()
    if argv == ["--deeplab"]:
        phase_deeplab(card)
        return 0
    if argv == ["--families"]:
        phase_build()
        phase_families(card)
        return 0
    if argv == ["--clip"]:
        phase_build()
        phase_clip(card)
        return 0
    if argv == ["--range-augment"]:
        phase_build()
        phase_range_augment(card)
        return 0
    if argv == ["--byteformer"]:
        phase_build()
        phase_byteformer(card)
        return 0
    if argv == ["--mask-rcnn"]:
        phase_build()
        phase_mask_rcnn(card)
        return 0
    if argv and argv[0] in REST_FLAGS:
        import tempfile

        labels, main_train_phase = REST_FLAGS[argv[0]]
        phase_build()
        phase_rest(card, labels, full=True)
        release()
        if argv[0] == "--vit-segmentation":
            phase_aspp_conv(card)
            release()
        with tempfile.TemporaryDirectory() as tmp:
            main_train_phase(card, tmp)
        return 0
    if argv == ["--segmentation"]:
        phase_build()
        phase_seg_main_train(card, None)
        release()
        phase_pspnet(card)
        return 0
    phase_build()
    sep_records = phase_kernel(card)
    mha_records = phase_mha_kernel(card)
    seg_records = phase_seg_ce_kernel(card)
    win_records = phase_window_kernel(card)
    release()
    mha_long_records = phase_mha_long_kernel(card)
    release()
    sep_kernels = {"separable_attention": separable_attention_kernel,
                   "separable_attention_bwd": separable_attention_bwd_kernel}
    sep_launches, run = phase_train(card, "MobileViTv2-1.0", FLAGSHIP_ARGS, sep_kernels,
                                    {name: sum(SEP_FLAGSHIP[1].values()) for name in sep_kernels})
    bare = phase_ab(card, "MobileViTv2-1.0", run)
    phase_profile(card, "MobileViTv2-1.0", run,
                  os.path.join("results", "mobilevit_profile.txt"))
    run = None
    release()
    phase_trainer(card, bare)
    release()
    phase_main_train(card, bare)
    release()
    vit_launches, run = phase_train(
        card, "ViT-B/16", VIT_ARGS,
        {"mha_attention_fwd": mha_fwd_kernel, "mha_attention_bwd": mha_bwd_kernel},
        {"mha_attention_fwd": VIT_BLOCKS, "mha_attention_bwd": VIT_BLOCKS})
    phase_ab(card, "ViT-B/16", run)
    phase_profile(card, "ViT-B/16", run, os.path.join("results", "vit_profile.txt"))
    run = None
    release()
    seg_launches, deeplab_bare = phase_deeplab(card)
    release()
    phase_seg_main_train(card, deeplab_bare)
    release()
    phase_pspnet(card)
    release()
    win_kernels = {"window_attention_fwd": window_fwd_kernel,
                   "window_attention_bwd": window_bwd_kernel}
    swin_launches, run = phase_train(card, "Swin-T", SWIN_ARGS, win_kernels,
                                     {name: SWIN_BLOCKS for name in win_kernels})
    phase_ab(card, "Swin-T", run)
    phase_profile(card, "Swin-T", run, os.path.join("results", "swin_profile.txt"))
    run = None
    release()
    vit_long_launches, run = phase_train(
        card, "ViT-B/16 512² no CLS", VIT_LONG_ARGS,
        {"mha_attention_fwd": mha_fwd_kernel, "mha_attention_bwd": mha_bwd_kernel},
        {"mha_attention_fwd": VIT_BLOCKS, "mha_attention_bwd": VIT_BLOCKS})
    vit = run[0].model
    with torch.no_grad():  # every one of those launches saw S = 1024 tokens
        stem = vit.patch_emb_2(vit.patch_emb_1(vit.patch_emb_0(
            torch.zeros((1, 3, 512, 512), device="cuda"))))
    check(stem.shape[-2] * stem.shape[-1] == 1024 and not vit.use_cls_token,
          f"ViT-B/16 512²: {stem.shape[-2] * stem.shape[-1]} tokens")
    phase_ab(card, "ViT-B/16 512² no CLS", run)
    phase_profile(card, "ViT-B/16 512² no CLS", run,
                  os.path.join("results", "vit_long_profile.txt"))
    run = vit = None
    release()
    phase_conv(card)
    release()
    native_record = phase_native(card)
    release()
    phase_families(card)
    release()
    clip_launches = phase_clip(card)
    release()
    finetune_launches, finetune_records = phase_range_augment(card)
    release()
    byteformer_launches, byteformer_records = phase_byteformer(card)
    release()
    mask_rcnn_launches = phase_mask_rcnn(card)
    release()
    rest_launches, _ = phase_rest(card)
    release()

    def entry(name, source, replaces, launches, record):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, **record}

    def mha_entry(name, replaces, key, record, part):  # ViT-B/16's, CLIP's, ByteFormer's
        return {**entry(name, "cvnets_tpu_torch/csrc/mha_attention.cu", replaces,
                        vit_launches[key], record),
                "launches_by_path": {"ViT-B/16": vit_launches[key],
                                     "CLIP ViT-B/16": clip_launches[key],
                                     VIT_MOE: rest_launches[VIT_MOE][key],
                                     **{path: n[key] for path, n in byteformer_launches.items()}},
                "by_path": {path: r[part] for path, r in byteformer_records.items()}}

    def sep_entry(name, replaces, part):  # the flagship's, the finetune's, Mask R-CNN A's
        return {**entry(name, "cvnets_tpu_torch/csrc/separable_attention.cu", replaces,
                        sep_launches[name], sep_records[part]),
                "launches_by_path": {"MobileViTv2-1.0": sep_launches[name],
                                     "MobileViTv2-2.0 384² finetune": finetune_launches[name],
                                     MASK_RCNN_A: mask_rcnn_launches[MASK_RCNN_A][name],
                                     VIDEO_V2: rest_launches[VIDEO_V2][name]},
                "by_path": {"MobileViTv2-2.0 384² finetune": finetune_records[part]}}

    def long_entry(name, replaces, key, record):  # ViT-B 512²'s and Mask R-CNN B's
        return {**entry(name, "cvnets_tpu_torch/csrc/mha_attention.cu", replaces,
                        vit_long_launches[key], record),
                "launches_by_path": {"ViT-B/16 512² no CLS": vit_long_launches[key],
                                     MASK_RCNN_B: mask_rcnn_launches[MASK_RCNN_B][key],
                                     **{p: rest_launches[p][key] for p in SEG_VIT_HEADS}}}

    def seg_entry(name, replaces, record):  # DeepLabv3-MobileViTv2's and the ViT's
        return {**entry(name, "cvnets_tpu_torch/csrc/seg_ce.cu", replaces, seg_launches[name],
                        record),
                "launches_by_path": {"DeepLabv3-MobileViTv2-1.0": seg_launches[name],
                                     **{p: rest_launches[p][name] for p in SEG_VIT_HEADS}}}

    print(json.dumps({"kernels": [
        sep_entry("separable_attention", "cvnets_tpu/ops/pallas/mobilevit_attn.py:44", "fwd"),
        sep_entry("separable_attention_bwd", "cvnets_tpu/ops/pallas/mobilevit_attn.py:120",
                  "bwd"),
        mha_entry("mha_attention_fwd", "cvnets_tpu/ops/pallas/mha_attn.py:134",
                  "mha_attention_fwd", mha_records["fwd"], "fwd"),
        mha_entry("mha_attention_bwd", "cvnets_tpu/ops/pallas/mha_attn.py:153",
                  "mha_attention_bwd", mha_records["bwd"], "bwd"),
        seg_entry("seg_ce_fwd", "cvnets_tpu/ops/pallas/seg_ce_kernel.py:159", seg_records["fwd"]),
        seg_entry("seg_ce_bwd", "cvnets_tpu/ops/pallas/seg_ce_kernel.py:200", seg_records["bwd"]),
        long_entry("mha_attention_fwd_long", "cvnets_tpu/ops/pallas/mha_attn_long.py:142",
                   "mha_attention_fwd", mha_long_records["fwd"]),
        long_entry("mha_attention_bwd_long_dq", "cvnets_tpu/ops/pallas/mha_attn_long.py:257",
                   "mha_attention_bwd", mha_long_records["dq"]),
        long_entry("mha_attention_bwd_long_dkdv", "cvnets_tpu/ops/pallas/mha_attn_long.py:279",
                   "mha_attention_bwd", mha_long_records["dkdv"]),
        entry("window_attention_fwd", "cvnets_tpu_torch/csrc/window_attention.cu",
              "cvnets_tpu/ops/pallas/window_attn.py:279",
              swin_launches["window_attention_fwd"], win_records["fwd"]),
        entry("window_attention_bwd", "cvnets_tpu_torch/csrc/window_attention.cu",
              "cvnets_tpu/ops/pallas/window_attn.py:300",
              swin_launches["window_attention_bwd"], win_records["bwd"]),
        entry("jpeg_crop_resize_flip", "cvnets_tpu_torch/csrc/jpeg_decode.cu",
              "cvnets_tpu/native/decode.cpp:118", native_record.pop("launches"),
              native_record),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
