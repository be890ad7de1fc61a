"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--requests N] [--swin-requests N] [--steps N]
                          [--swin-steps N] [--train-steps N] [--profile]

Drives the port (nicr_mtsa_tpu_torch) end to end on the card, in
phases; any failure exits non-zero and prints no result:

1. report the card (nvidia-smi name and power limit), build every CUDA
   kernel from nicr_mtsa_tpu_torch/ops/cuda/csrc (one nvcc per source,
   in parallel) and the native host-preprocessing library
   (native/mtsa_preproc.cpp, g++ with native/Makefile's flags; a failed
   build fails the run), print the registers, spills and resident blocks an SM
   of the window-attention tile kernels (rows 7 and 9's forward tile,
   row 7's bf16 backward, row 8's two bf16 kernels), pin f32 convs and
   matmuls to full precision;
2. hold each kernel against its plain PyTorch version on the card at
   the shapes its path gives it (idx, ids, min_d2 and counts exact,
   scores within rtol 1e-5; the intersection also against
   torch.bincount), tied and edge inputs included, and time both
   (median of CUDA event timings); the 4x finisher at the serving call
   ((8, 40, 120, 160) bf16 channels-last, the head's layout on the
   card) and at FINISHER4X_CASES (NCHW and f32, a ragged (2, 40, 37,
   53), 19 classes), tied classes at 8 and 40 classes, with the card's
   time alone (`stream_ms`) and its plan, registers, spills and blocks
   an SM; the crop+resize+reduce also on crops
   with y0, x0 > 0, an output wider than its crop, a 333 x 500 output,
   NCHW and channels-last, bf16 and f32, tied classes at 8 and 40
   classes, with the card's time alone (`stream_ms`) and its plan,
   registers, spills and blocks an SM, and, timed apart with its own
   plan and bound, at the f32 call of phase 21's retrievals (channels-
   last (8, 40, 480, 640) -> 512 x 512); the score/argmax reduce at the
   eval call and in `_sr_cases` (NCHW, f32 in both layouts, the sliced
   view of a crop, storage one element off alignment, 41 classes, ties
   at 8 classes in both layouts and 40 channels-last), with the kernel
   each case took (`sr_plan`), the staged kernel's plan, registers,
   spills and blocks an SM, one device launch a call and `stream_ms`
   beside `cuda_ms` at the eval call and NCHW; the intersection histogram on random maps, one bin,
   out-of-range slots, 257 x 129 bins, B=1, P = 262143, storage 4 bytes
   off a 16-byte boundary (both maps, one map) and an image stride of P
   + 1, with each case's plan, registers, spills, one device launch a
   call and `stream_ms` (random, one bin); the grouping through
   both entries
   (the pipeline's, on the offset map, at the serving call and
   GROUPING_CASES: bf16 and f32 offsets, channels-last and NCHW, with
   and without a distance threshold, no valid centre, valid and invalid
   centres interleaved, K = 1 and 254, tied centres; the loc-level one
   at 307200 pixels, no valid centre, a ragged P), ids and min_d2 bit
   for bit, timed (`cuda_ms`, `stream_ms`) with their grids, registers,
   spills and blocks an SM; the calls of the dataset eval path (phase
   23, 10 classes) in `check_dataset_kernels`: the crop+resize+reduce
   at (8, 10, 480, 640) bf16 channels-last -> 120 x 160 (a 4x downscale,
   the generic instance) and on an NCHW f32 copy, the score/argmax
   reduce at (8, 10, 480, 640) bf16 in both layouts (the strided
   kernel) with tied classes at 10, the intersection at (8, 19200) slots
   of 129 x 129 bins, also against torch.bincount, each timed with its
   plan, registers and blocks an SM; check that centre selection and
   the merge resolve tied inputs on the card exactly as on the CPU;
3. serve the full-width `emsanet-bench` EMSANet (2x ResNet-34 NBt1D,
   480 x 640, bf16, random weights from a seed) on B=8 uint8/uint16
   requests, with the launch counters set to 0 just before and read
   just after: exactly 1 finisher and 1 grouping launch a request;
4. run the same pipeline in f32 on one frame on the card and on the
   CPU with identical weights: semantic_idx must agree on >= 99.9 %,
   and the panoptic segments must match: the share of segment pixels
   in segments matched by class and IoU > 0.5 (PQ's rule, blind to
   renumbering) at least PANOPTIC_MATCH_MIN, and their borders in
   place: the pixel agreement of the matched segments at least
   PANOPTIC_BORDER_MIN, while planted faults of the card's map (the
   largest segment given another class; two instances of a class
   merged, where the frame has two) must fall below the first gate and
   the map rolled by BORDER_ROLL columns below the second; an earlier
   line says whether the centre tables agree in order or only as sets;
5. run the fused eval step of `bench.py --eval` (the same model with
   the semantic upsampling in the head, 40 classes of which 8 things,
   top-k 64, segment table 128) on a synthetic B=8 batch (480 x 640,
   ground truth at 512 x 512), three timed rounds of N steps with the
   metric states carried across steps and the counters set to 0 just
   before: the crop+resize+reduce, the score/argmax reduce and the
   intersection histogram must have run in every step (1, 1 and 2
   launches a step), and mIoU, PQ and the scene accuracy from the
   states must lie in [0, 1]; the slot maps the warm-up step passed
   the intersection histogram, captured, must be two (8, 262144) pairs
   at 129 x 129 bins and give counts equal to the plain version's and
   torch.bincount's (timed, `stream_ms`);
6. postprocess and update the metric states of the card's raw eval
   outputs (B=2) on the card and on the CPU: integer states equal,
   float sums within rtol 1e-5;
7. hold the Swin path's kernels against their plain versions at its
   shapes: the window-attention sub-block through the image entry the
   Swin blocks call at all four stages of B=8 serving (120 x 160 x 128,
   60 x 80 x 256, 30 x 40 x 512, 15 x 20 x 1024 padded to 16 x 24; 4 to
   32 heads), v2 shifted and unshifted, through its windows entry at
   stages 1 and 4 (2400 windows of 64 tokens, C=128; 48, C=1024),
   shifted v2, plus a shifted v1 image of 49-token windows, in bf16 and
   f32 (within 1e-4 of max |out| in f32, 2e-2 in bf16; outputs finite),
   timed at every stage against the bound; the LayerNorm at every width
   of its path (C 32, 96, 128, 256, 512, 1024) with the path's rows and
   with 4801, in bf16/f32 -> bf16/f32, eps 1e-5 and 1e-6 and on
   misaligned views (bf16 outputs within 1 ulp, or 1e-6 of max |out|
   where the affine cancels to near 0; f32 within 1e-5), each path
   shape timed against its bound and F.layer_norm with its plan,
   registers, spills and blocks an SM; the bilinear 4x finisher as
   the 4x finisher of phase 2 (idx exact, scores within rtol 1e-5, ties
   to the first index; timed with its plan and ptxas figures);
8. serve `emsaformer_dve_v2` (multimodal SwinV2-T-128 RGB-D, MLP
   decoders, 480 x 640, bf16, random weights from a seed) on B=8
   requests, counters set to 0 just before: exactly 12 window-attention
   launches, 36 LayerNorm launches (every LN of the path), 1 bilinear
   finisher and 1 grouping launch a request;
9. run that pipeline in f32 on one frame on the card and on the CPU:
   the gates of phase 4;
10. hold the Swin training path's window-attention core (forward,
   flash-style backward and the deterministic dbias reduction) against
   its plain versions at stages 1 to 4 (2400 windows, C=128, 4 heads;
   640, 256, 8; 160, 512, 16; 48, 1024, 32) and a v1 stage of 49-token
   windows (24 windows of a 3 x 4 grid, C=128), all shifted: f32 within
   1e-4 and bf16 within 1e-2 of max |.|, the reduction exactly, the
   backward's outputs bit-equal over two runs; timed at every stage
   against the bound, F.scaled_dot_product_attention and torch.sum, the
   plain versions at stage 1;
11. train `emsaformer_dve_v2` (`bench.py --train`: 480 x 640, bf16,
   AdamW 1e-4, the random batch at B=8, stochastic depth and dropout
   from a CUDA generator): a first step (deterministic cuDNN and
   algorithms), then three timed rounds of N steps, each ending in a
   sync on the loss, counters set to 0 just before: exactly 12
   forward, 12 backward and 12 dbias launches of the core a step and
   none of the serving kernels (the window-attention sub-block, the
   LayerNorm); every loss finite, the total loss of the
   last step below the first's;
12. take one f32 training step with drop rates 0 on the card and on the
   CPU from the same weights and batch (B=8 at 256 x 320, the
   orientation head's bias away from 0: see `TRAIN_CPU_HW`): losses
   within rtol 1e-5, the BatchNorm running statistics within 1e-5,
   each gradient within 1e-3 of its tensor's max |grad|, or within 4x
   what the CPU's other summation orders (channels-last, no oneDNN)
   move it in the same run where that is more; the card's step with a
   planted 1 % fault (row 7's dbias; the instance losses) must fail
   that check;
13. hold the 2x finisher of EMSANet's `--no-defer4x` variant (the one-
   stage instance of the 4x finisher's tile template) against its
   plain version at the path's (8, 40, 240, 320), channels-last as the
   head gives it and contiguous, in bf16 and f32, and at
   FINISHER2X_CASES (a ragged shape, 19 classes, an odd shape without a
   bias), plus tied classes at 8 and 40 classes (idx exact, scores
   within rtol 1e-5); time it (`cuda_ms`, `stream_ms`) with its plan,
   registers, spills and blocks an SM;
14. serve `emsanet_bench_config(defer=True)` (the head applies the first
   prediction upsampling and defers the last) on B=8 requests, counters
   set to 0 just before: exactly 1 finisher2x, 0 finisher4x and 1
   grouping launch a request;
15. run that pipeline in f32 on one frame on the card and on the CPU:
   the gates of phase 4;
16. hold the attention over the packed qkv of EMSAFormer's `--attn-qkv`
   variant against its plain version at stage 1 (2400 windows, C=128,
   4 heads) and stages 2-4 (640, 256, 8; 160, 512, 16; 48, 1024, 32;
   the qkv of padded images, whose pad tokens have k = 0 exactly), all
   shifted v2, and a shifted v1 stage of 49-token windows, in bf16
   (within 2e-2 of max |out|) and f32 (1e-4); time it at every stage
   against the bound and F.scaled_dot_product_attention, the plain
   version at stage 1;
17. serve `emsaformer_bench_config(attn_backend='qkv')` on B=8 requests,
   counters set to 0 just before: exactly 12 window_attention_qkv, 0
   window_attention_block, 36 LayerNorm, 1 bilinear finisher and 1
   grouping launch a request;
18. run that pipeline in f32 on one frame on the card and on the CPU:
   the gates of phase 4;
19. train `emsanet_train_config()` (`bench.py --train`'s default model:
   2x ResNet-34 NBt1D, dense decoders with their side heads, the
   semantic upsampling in the head; 480 x 640, bf16, AdamW 1e-4, the
   random batch at B=8, channel dropout from a CUDA generator): a
   warm-up step, then three timed rounds of N steps, each ending in a
   sync on the loss, counters set to 0 just before: no launch of any
   kernel wrapper (the JAX package trains EMSANet through XLA); every
   loss finite, the total loss of the last step below the first's;
20. take one EMSANet training step with drop rates 0 on the card and on
   the CPU, the recipe and gates of phase 12 (B=8 at 256 x 320) in
   float64 (the model too), with its own planted 1 % faults: the
   gradients of the decoders' learned-upsampling weights, and the
   instance losses; beside it, ungated, the f32 step's losses card vs
   CPU and between two CPU summation orders (an f32 step of this ReLU
   network at random init moves by more than phase 12's limits with
   the summation order alone);
21. run the fused eval step of `bench.py --eval --model
   emsaformer_dve_v2` (`emsaformer_eval_config()`: the semantic
   upsampling in the head; the semantic, instance, orientation, scene
   and dense-visual-embedding tasks plus the panoptic helper, the
   bench's class tables and DVE targets, embedding 512) on a synthetic
   B=8 bf16 batch (480 x 640, ground truth at 512 x 512): a warm-up
   step, then three timed rounds of N steps with the states carried,
   counters set to 0 just before: exactly SWIN_EVAL_KERNELS' launches
   a step (12 window-attention sub-blocks, 39 LayerNorms, 3
   crop+resize+reduce, 1 score/argmax reduce, 2 groupings, 2
   intersection histograms; every other wrapper none); every loss
   finite, the DVE loss in [0, 2], every epoch metric in [0, 1], both
   retrieval mIoUs among them;
22. postprocess and update the metric states of the card's raw Swin
   eval outputs (f32, B=2) on the card and on the CPU: the gates of
   phase 6, except that the two retrieval confusion matrices may differ
   at pixels whose top two full-resolution logits on the CPU lie within
   1e-5 of their magnitude (counted; any other difference fails); on
   the card at the full shape, the DVE loss of each pixel's own LUT row
   must be <= 1e-5 and of its negation within 1e-5 of 2, and the
   embedding set to the text-table row of each pixel's working-
   resolution GT class must read a text retrieval mIoU >= 0.99 against
   that GT (nothing resized) and retrieve >= 99 % of the counted pixels
   right against the 512 x 512 GT (its mIoU printed: class borders
   move under the resize).

23. evaluate the repo's dataset fixture as `bench.py --eval --dataset
   tests/fixtures/mini_dataset` does (the `valid` split cycled to B=8,
   the bench's eval preprocessing at 480 x 640 on the port's dataset,
   PNG codec and native library, the EMSANet eval model with the
   dataset's 10 classes and meta.json's 3 things, bf16): (a) the fused
   step on one resident batch, states carried, and (b) host-inclusive,
   DataLoader (2 worker threads) -> prefetch_to_device -> the step; 3
   timed rounds of N steps each, counters set to 0 just before: exactly
   DATASET_EVAL_KERNELS' launches a step (1 crop+resize+reduce, 1
   score/argmax reduce, 2 groupings, 2 intersection histograms, every
   other wrapper none); the segment tables hold every GT id, every
   epoch metric (printed as the bench prints them) lies in range, the
   warm-up step's two slot maps are (8, 19200) pairs of 129 x 129 bins
   counted as the plain version and torch.bincount count them; the host
   ms a sample of the file read and of each preprocessing step;
24. postprocess and update the metric states of the f32 model's raw
   outputs on the fixture's first two samples on the card and on the
   CPU: the gates of phase 6;
25. serve `bench.py --stream`: `emsanet_bench_config()` at B=8 on 4
   distinct uint8/uint16 host batches through prefetch_to_device(size=
   2) (pinned staging ring, copy stream), 3 timed rounds of N requests
   beside phase 3's device-resident frames/s, counters set to 0 just
   before: exactly 1 finisher and 1 grouping launch a request; with
   cudnn pinned deterministic, every prefetched request's outputs
   bit-equal to its frames served through a blocking copy (requests
   interleaved with the prefetch, and every batch taken first), while
   a planted staging race (no wait for a slot's event, the copy stream
   delayed) must break that equality; the copy stream's time for one
   request's 12.3 MB.

At the bench's own batch sizes (`bench.py`'s defaults; their seconds
are printed as `bench_size_seconds`):

26. `bench.py --latency`: each family's default serving path
   (`emsanet_bench_config()`, `--defer4x`; `emsaformer_bench_config()`,
   'auto') at B=1 and B=8, 30 requests (LATENCY_STEPS) each fenced by
   a device-to-host fetch of out['panoptic'][0, 0, 0]: the median ms a
   request;
27. serving at bench size: EMSANet at B=256, `--stream` at B=256 (4
   distinct host batches through prefetch_to_device), EMSAFormer at
   B=128, and at B=8 `emsaformer_dve` (Swin v1, 7 x 7 windows) and
   `--quick` (`emsanet_bench_config(quick=True)`, 128 x 160): three
   timed rounds of BENCH_REQUESTS requests (the B=8 paths as phase
   8), counters set to 0 just before and exact launches a
   request, frames/s (the median round) and peak memory
   (torch.cuda.max_memory_allocated after reset_peak_memory_stats);
28. eval at bench size: EMSANet's fused step at B=128 with the segment
   table at 128 (three rounds of BENCH_EVAL_STEPS steps, exact launches,
   metrics in [0, 1]), then the Swin/DVE step down the ladder 128, 64,
   32, 16, catching only torch.cuda.OutOfMemoryError (each failed size
   printed with the allocation it asked for, the cache emptied after
   each); B=16 must fit; frames/s and peak memory of the largest size
   that fits;
29. training at B=48, both families, without and with remat (`remat=
   True`: every block recomputes its activations in the backward pass):
   as phase 11 (the Swin core's forward 24 times a step with remat),
   three timed rounds of BENCH_TRAIN_STEPS steps, frames/s and peak
   memory from before the first step. An out-of-memory error is caught
   only without remat, and printed; with remat B=48 must run, below
   the other run's peak (or below 80 GB where that run is out of
   memory). The remat run's first step against the other's from the
   same weights, batch and generator seed, both in bf16 under
   deterministic cuDNN and torch's deterministic algorithms (at B=16
   where B=48 does not fit without remat): losses, BatchNorm
   statistics and the generator's state equal, each gradient within
   1e-3 of its tensor's max |grad|; printed beside it, the spread of
   two plain first steps with torch's default algorithms (some sum
   gradients in an order that changes from run to run);
30. attention chunking: EMSAFormer serving at B=128 with `attn_chunk=
   32` (48 sub-block launches a request): its outputs under
   deterministic cuDNN bit-equal to the unchunked run's, frames/s and
   peak memory beside the unchunked run's;
31. the kernels at bench shapes: every call of rows 1, 2, 3, 5, 6, 8, 10
   and 11 that phases 27 and 28 captured at their bench sizes (rows 8
   and 10 one call a stage shape, shift and dtype; row 5 the bf16 and
   the f32 call) run on the whole batch, on images 0-7 and on the last
   8 images alone: the outputs for those images equal (integers bit for
   bit, floats within the row's rule of phase 2 or 7), and the last 8
   images against the plain version; row 7's stage-1 call of the Swin
   remat step (forward and backward) likewise, dbias against its plain
   version.

And the training loop of examples/train_synthetic.py (its seconds are
printed as `train_loop_seconds`):

32. write 16 train and 8 valid frames of 960 x 1280 (twice the model's
   size in each axis, as the JAX example builds its dataset) from the
   port's SyntheticRGBDDataset (11 classes with void, classes 1-3
   things with an orientation, 5 scenes) as a directory dataset with
   the port's PNG writer (the row filters it used printed), then train
   the full-width `emsanet_train_config` with the example's heads
   (bf16, AdamW 3e-4, DWA over its five loss keys) 3 epochs of 2 steps
   at B=8, 480 x 640: the example's training preprocessing with its
   augmentations (each sample from the loader's RandomState of seed,
   pass and index) through the threaded loader and prefetch_to_device,
   an eager validation epoch after each (the bench's eval
   preprocessing, the 960 x 1280 ground truth kept), the checkpoint
   policy on the validation mIoU and PQ, a checkpoint with the DWA
   state when it says so, the CSV log. Gates: losses finite; DWA's
   weights 1 for steps 1-5 and at step 6 the DWA formula of the two
   recorded epoch means (summing to 5); each validation epoch launches
   exactly LOOP_VALID_KERNELS (1 crop+resize+reduce, 1 score/argmax
   reduce, 2 groupings, 2 intersection histograms; every other wrapper
   none; the training steps none), and its eager states equal the
   fused eval step's on the same batches (phase 6's rule, an
   angular-error sum also within LOOP_ANGLE_ATOL a counted angle); the
   first validation step's calls at new shapes against their plain
   versions, timed: row 5's 2x upscale ((8, 10, 480, 640) bf16 -> 960
   x 1280; idx exact, scores within rtol 1e-5) and row 11's two
   (8, 1228800) slot-map pairs (exact, also against torch.bincount);
   the step after each checkpoint taken also by a pipeline loaded from
   it (another seed's weights overwritten) under deterministic cuDNN
   and algorithms: losses, parameters, statistics, AdamW moments, the
   DWA state and the generators bit-equal, the epoch and DWA state
   back from `extra`; one f32 validation batch (B=2) postprocessed and
   scored on the card and on the CPU from the card's raw outputs (the
   rule above, the MAE against the GT instances included), the card's
   side with one image's orientations opposite to its GT failing it.
   Printed: host-inclusive train and validation frames/s (all epochs,
   and the last alone), the host ms a sample of the read and of each
   transform, peak memory, checkpoint size and save / load ms; with
   `--profile` one training and one validation step on a resident
   batch.

And the rest of the dense model surface (their seconds are printed as
`surface_seconds`):

33. surface normals on `emsanet-bench` with 'normal' added to its tasks
   (a 3-channel unit-length head beside the others): (a) serving at
   B=8, 480 x 640, bf16, `extra_output_tasks=('normal',)`, launches a
   request exactly phase 3's (1 finisher4x, 1 grouping, every other
   wrapper none), every normal unit length within NORMAL_UNIT_TOL (bf16
   rounding), frames/s and peak memory printed beside phase 3's; (b)
   that pipeline in f32 on one frame on the card and on the CPU:
   phase 4's gates, and the normals agreeing (within NORMAL_CPU_DIST)
   on at least NORMAL_AGREE_MIN of the pixels, one image's normals
   negated failing that; (c) the fused eval step at B=8 (phase 5's
   model and batch with the normal task, its helper and seeded
   synthetic normal targets): launches a step exactly
   NORMAL_EVAL_KERNELS, losses finite, the metrics (normal_rmse too)
   in range; the eager `validation_step`s of the semantic, scene and
   normal helpers on the same raw outputs give the fused step's states
   (phase 6's rule, atol 0); the card's raw outputs (B=2) postprocessed
   and scored on the card and on the CPU: phase 6's rule, `sum_rmse`
   within rtol 1e-5 and `n_elements` equal; (d) training
   `emsanet_train_config()` with the normal task at B=8 bf16 with
   `_down_<k>` targets for the side outputs (phase 19's gates: no
   wrapper launched, losses finite and falling), then one float64 step
   card vs CPU by phase 20's recipe and gates at NORMAL_TRAIN_CPU_HW
   (the normal decoder's leaves and side heads included), its planted
   faults and one in the normal losses caught;
34. the model surface at full width, 480 x 640 bf16: (a) 2x ResNet-50
   (bottleneck) with SE-add fusion and the APPM context, the
   `emsanet-bench` decoders and heads: B=8 serving (rows 1 and 2 once
   a request, their calls against their plain versions) and its f32
   card-vs-CPU frame by phase 4's gates; a B=8 request at 960 x 1280
   (the APPM bins doubled, checked on the branches' shapes; rows 1
   and 2 once); one training step at B=8 (losses finite, its time and
   peak memory); (b) one B=8 serving request a round (3 rounds) each of
   SURFACE_VARIANTS: a -d16 encoder with no context module, SE
   encoders, learned-3x3 and nearest upsampling (the semantic head not
   deferred: row 6 serves, rows 1, 3 and 4 launch none), `ln`
   normalization and the dense embedding decoder (its map's shape and
   finite values); each kernel call of a request against its plain
   version.

And the outputs beyond the eval step, the host extras and the examples
(their seconds are printed as `outputs_seconds`):

35. `emsanet-bench`'s fused eval step (phase 5's model and batch, B=8)
   with the panoptic postprocessor's dense scores (`compute_scores`),
   the instance postprocessor's debug branches (`debug`) and every
   helper's example images (`store_examples`): three timed rounds of N
   steps, launches a step exactly OUTPUTS_EVAL_KERNELS (phase 5's and a
   third grouping: the all-foreground segmentation), the three score
   maps finite and in [0, 1], losses finite, metrics in range,
   frames/s printed beside phase 5's; the f32 model's raw outputs (B=2)
   postprocessed on the card and on the CPU: the panoptic ids and the
   all-foreground segmentation agreeing on at least
   PANOPTIC_MATCH_MIN of the pixels, the score maps within rtol 1e-5
   where the ids agree; then the eager `validation_step` of every
   helper on the fixture's frames (B=8 cycled, 480 x 640, the 10-class
   model) equal to the fused states (phase 6's rule, atol 0), with
   OUTPUTS_EVAL_KERNELS launched by each of the two postprocessings,
   and EXAMPLE_KEYS written by `write_png` under chiprun_out/examples/
   and read back equal;
36. a deferred head's full-resolution keys on a 960 x 1280
   ground-truth batch (B=8 frames at 480 x 640, bf16), `--defer4x`
   (DeferredUpsampling2) and `--no-defer4x` (DeferredUpsampling): the
   working-resolution idx of the finisher equal bit for bit to the
   argmax of `apply_deferred_upsampling_exact`'s bf16 logits (tie
   pixels counted), the full-resolution idx row 5 on those logits,
   launches exactly 1 finisher and 1 crop+resize+reduce; row 5 at that
   call against its plain version, timed with its plan and bound;
37. `emsaformer_dve_v2` eval (the 10-class model) from the fixture's
   frames through the host extras: `SemanticClassMapper` (class
   MAPPED_CLASS to void, its pixels counted), a `TransformWrapper`
   flip, the bench's eval preprocessing, seeded synthetic segment
   embeddings (D=512) and `DenseVisualEmbeddingTargetGenerator` (LUT
   rows unit length), the LUTs padded; five- and ten-crop of a frame;
   every helper's eager `validation_step` (the DVE helper's included)
   equal to the fused states at atol 0; then `emsanet_train_config()`
   trained three steps at B=8 with a `StepCheckpointManager`
   (`max_to_keep=2`) saving after each: the last two steps kept, the
   restored state equal, the next step of a pipeline of another seed
   restored from it bit-equal under deterministic algorithms;
   checkpoint MB, save, wait and load ms printed;
38. `python -m nicr_mtsa_tpu_torch.examples.infer_panoptic` and
   `python -m nicr_mtsa_tpu_torch.examples.eval_dataset --dataset
   tests/fixtures/mini_dataset` on the card: exit 0, the three PNGs
   decodable by `read_png`, the printed metrics finite and in range.

And the pretrained backbones and normal training from recorded frames
(their seconds are printed as `pretrained_seconds`):

39. a seeded ResNet-34 (basic blocks) state dict in torchvision's
   layout, with its `fc` head, `num_batches_tracked` buffers and a
   `module.`-prefixed copy of one weight (other values), loaded by
   `load_pretrained_backbone` through $MTSA_PRETRAINED_DIR for RGB and
   through `checkpoint_path` for depth (the stem summed to 1 channel),
   grafted by `merge_backbone_variables` into both encoders of
   `emsanet-bench` with basic blocks (480 x 640, bf16): every grafted
   tensor equal to the loaded one, the depth stem to the checkpoint's
   summed kernel, every other tensor unchanged; served at B=8 as phase
   3 (launches a request exactly 1 finisher4x and 1 grouping, frames/s
   printed beside phase 3's); the f32 pipeline card vs CPU under phase
   4's gates; the ImageNet classifier on that backbone (B=8, 224 x
   224, f32, 1000 classes): logits card vs CPU within CLASSIFIER_TOL
   of the largest, the card's forward timed;
40. a seeded Swin-T v1 state dict in torchvision's layout (`swin_t`'s
   shapes, `_orig_mod.`-prefixed, with its head and buffers) loaded
   into the `swin-t` backbone, its forward at B=8, 224 x 224, f32 on
   the card with the counters set to 0 just before: launches exactly
   PRETRAINED_SWIN_KERNELS (12 window-attention sub-blocks, 29
   LayerNorms; every other wrapper none), each stage within
   SWIN_STAGE_TOL of the CPU's, each captured kernel call against its
   plain version (phase 7's rules), the forward timed;
41. phase 32's loop with 'normal' added to the tasks: 24 train and 8
   valid frames of 960 x 1280 with seeded smooth unit normal fields
   (.npy beside the PNG maps), the example's training preprocessing
   with normals, 3 training steps at B=8 (no wrapper launched) and one
   eager validation step (LOOP_VALID_KERNELS); losses finite, the
   normal losses (main and side outputs) among them, `normal_rmse` in
   (0, 2], image 0's normal targets negated moving the validation's
   normal loss by more than NORMAL_FAULT_MIN of it and 100 times its
   rerun spread, and the normal loss of predictions equal to the
   targets 0, with image 0's targets negated at least
   NORMAL_ORACLE_MIN.

It prints the kernels line `{"kernels": [...]}` and, last, the result
line `{"ok": true, "device": {...}}`. Details go to
chiprun_out/chip_smoke.json. Needs no network and no JAX."""
import argparse
import atexit
import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12                  # dense tensor cores
PEAK_BYTES_PER_S = 3.35e12
SERVING_KERNELS = ('finisher4x', 'grouping')
# launches of each eval kernel in one fused eval step: the working- and
# the full-resolution semantic reduce, and one intersection histogram
# for each of the two PQ helpers (panoptic, instance)
EVAL_KERNELS = {'resize_reduce': 1, 'semantic_reduce': 1,
                'intersection': 2}
# launches of each Swin serving kernel in one request: one
# window-attention sub-block per Swin block (2 + 2 + 6 + 2), every
# LayerNorm of the path (the backbone's 30: 2 patch embeds, 24 in
# blocks, 3 merges, the final norm; and the 3 skip LNs of each of the
# semantic and the instance decoder), one finisher, one grouping
SWIN_KERNELS = {'finisher4x_bilinear': 1, 'window_attention_block': 12,
                'layernorm': 36, 'grouping': 1}
# launches of each kernel in one request of the two serving variants:
# EMSANet `--no-defer4x` (the 2x finisher in place of the 4x one) and
# EMSAFormer `--attn-qkv` (attention over the packed qkv in place of
# the whole sub-block, one per Swin block)
DEFER2X_KERNELS = {'finisher2x': 1, 'finisher4x': 0, 'grouping': 1}
QKV_KERNELS = {'window_attention_qkv': 12, 'window_attention_block': 0,
               'layernorm': 36, 'finisher4x_bilinear': 1, 'grouping': 1}
# launches of each kernel in one fused Swin eval step (`bench.py --eval
# --model emsaformer_dve_v2`, phase 21): the sub-block once per Swin
# block, every LayerNorm (serving's 36 and the embedding decoder's 3
# skip LNs), the crop+resize+reduce for the semantic head (bf16) and the
# two DVE retrievals (f32), the score/argmax reduce once (semantic), the
# grouping and the intersection histogram twice each (the instance and
# the panoptic helper); every other wrapper none
SWIN_EVAL_KERNELS = {'window_attention_block': 12, 'layernorm': 39,
                     'resize_reduce': 3, 'semantic_reduce': 1, 'grouping': 2,
                     'intersection': 2}
# launches of each kernel in one Swin training step: the attention core's
# forward, backward and dbias reduction once per Swin block; the serving
# kernels never (training LayerNorms run their plain version, as the
# JAX package trains through XLA)
TRAIN_KERNELS = {'window_attention_core_fwd': 12,
                 'window_attention_core_bwd': 12,
                 'window_attention_core_dbias': 12,
                 'window_attention_block': 0, 'layernorm': 0}
# the training card-vs-CPU step: 256 x 320 (sides multiples of 32, as
# the MLP decoders need) shifts the windows of stages 1-3; B=8, the
# training batch: at B=1 or 4 the PPM's training BatchNorms normalise a
# handful of values, an f32 variance so ill-conditioned that another
# summation order on the CPU alone moves some gradients by percents of
# their max
TRAIN_CPU_HW, TRAIN_CPU_BATCH = (256, 320), 8
# orientation bias of that step: raw orientation vectors away from 0,
# where unit_length's gradient (growing as 1 / |x|) amplifies rounding
TRAIN_CPU_ORIENTATION_BIAS = (1.0, -0.5)
# other f32 summation orders the CPU can take for the same step: its
# convs on channels-last tensors, and without oneDNN (other algorithms)
TRAIN_CPU_ORDERS = ('channels_last', 'no_mkldnn')
# a tensor's card-vs-CPU gradient limit, as a share of its max |grad|:
# 1e-3, or TRAIN_SPREAD_FACTOR times the most the CPU's other orders
# move it in the same run, where that is more
TRAIN_GRAD_TOL, TRAIN_SPREAD_FACTOR = 1e-3, 4.0
# planted faults the gradient check must catch, each of this relative
# size, and the tensors whose gradients each moves by all of it: row 7's
# dbias (the CPB MLPs), the instance losses (the instance decoder)
TRAIN_FAULTS = {'core_dbias': '.attn.cpb_fc',
                'instance_losses': 'instance_decoder.'}
TRAIN_FAULT_SIZE = 1e-2
# EMSANet training (phases 19, 20; `bench.py --train`'s default model):
# no kernel of the port runs in its step (the JAX package trains it
# through XLA), so every wrapper of KERNELS must count this many
# launches a step
EMSANET_TRAIN_LAUNCHES = 0
# its card-vs-CPU step runs in float64: at random init its f32 step is
# too sensitive to summation order for phase 12's gates (its f32 losses
# card vs CPU and between two CPU orders are printed beside), and in
# f32 a few of its ReLUs' pre-activations round to the other side of 0;
# the planted faults of that step: the gradients of the decoders'
# learned-upsampling weights (their group: the decoder steps' and the
# heads' upsamplings, weights and biases), the instance losses
EMSANET_TRAIN_FAULTS = {'upsampling_weight_grad': '.upsample',
                        'instance_losses': 'instance_decoder.'}
# surface normals (phase 33): the unit-length error allowed a bf16
# normal (its norm, the division and the output each rounded to bf16's
# 8 bits; the JAX package's serving test allows the same); card vs CPU
# in f32, the least share of pixels whose normals lie within
# NORMAL_CPU_DIST of each other; the eval step's launches (phase 5's,
# the grouping twice: the panoptic merge and the instance helper's GT
# foreground); the side outputs' `_down_<k>` targets of training; the
# float64 card-vs-CPU step's size (phase 20's takes three CPU steps at
# 256 x 320, here cut to keep the phase short) and its planted faults,
# phase 20's and one in the normal losses
NORMAL_UNIT_TOL = 2e-2
NORMAL_CPU_DIST, NORMAL_AGREE_MIN = 1e-3, 0.999
NORMAL_EVAL_KERNELS = dict(EVAL_KERNELS, grouping=2)
NORMAL_DOWNSCALES = (8, 16, 32)
NORMAL_TRAIN_CPU_HW = (128, 160)
NORMAL_TRAIN_FAULTS = dict(EMSANET_TRAIN_FAULTS,
                           normal_losses='normal_decoder.')
# that step's floor of a gradient's scale, as a share of the step's
# largest |grad| (phase 20's 1e-5 is an f32 step's rounding noise): at
# random init the normal decoder's gradients peak at 1.6e-6 of the
# largest (the depth stem's; the step on the CPU at 128 x 160), so
# phase 20's floor would hide them and a fault in them; float64
# rounding noise lies far below 1e-9
NORMAL_GRAD_FLOOR = 1e-9
# panoptic ids are class * PANOPTIC_ID_CLASS + k (ops/merge.py); the
# card-vs-CPU panoptic gate: the least share of segment pixels in
# segments matched by class and IoU > 0.5 (see PERF.md section 2)
PANOPTIC_ID_CLASS = 1 << 16
PANOPTIC_MATCH_MIN = 0.999
# the border-level gate: the pixel agreement of the matched segments
# (`panoptic_border_agreement`), by card_vs_cpu key, the matched-share
# limit where none is named; a roll of the card's map by BORDER_ROLL
# columns is the planted control that must fail it
PANOPTIC_BORDER_MIN = {}
BORDER_ROLL = 16
# kernels whose device time and calls each profile sums by name
PROFILED_KERNELS = ('layer_norm_kernel', 'resize_reduce_kernel',
                    'finisher4x_kernel', 'finisher2x_kernel',
                    'group_pixels_kernel', 'staged_kernel',
                    'intersection_kernel')


def fail(msg: str) -> None:
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, n: int = 10) -> float:
    """Median device time of fn() over n runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def stream_ms(fn, n: int = 10, batch: int = 10) -> float:
    """The card's time alone for one fn(): the median over n batches of
    `batch` back-to-back calls queued behind a spin kernel (~6 ms, longer
    than the host time of the batch's launches), per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        torch.cuda._sleep(10_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return float(np.median(times))


def bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def ptxas_entries(log: str):
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from the `nvcc -Xptxas -v` output of one build."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m and name:
            out[name] = [None, int(m.group(1)), int(m.group(2))]
        m = re.search(r'Used (\d+) registers', line)
        if m and name in out:
            out[name][0] = int(m.group(1))
    return out


# the kernels redesigned for Hopper in the window-attention sources, by
# library: (a piece of the mangled name, the entry giving its resident
# blocks an SM)
TILE_KERNELS = {
    'window_attention_block': (
        ('qkv_attend_kernelILb1E',
         'window_attention_block_qkv_attend_blocks_per_sm'),
        ('qkv_attend_kernelILb0E', None),
        ('proj_kernel', 'window_attention_block_proj_blocks_per_sm')),
    'window_attention_core': (
        ('wac_fwd_bf16_kernel', 'wac_forward_bf16_blocks_per_sm'),
        ('wac_bwd_bf16_kernel', 'wac_backward_bf16_blocks_per_sm')),
    'window_attention_qkv': (
        ('waq_bf16_kernelILb1E', 'window_attention_qkv_bf16_blocks_per_sm'),
        ('waq_bf16_kernelILb0E', None)),
}


def kernel_resources(build, result):
    """Print the registers, spills and resident blocks an SM of the
    window-attention tile kernels (ptxas of this run's build)."""
    import ctypes
    res = {}
    for lib, kernels in TILE_KERNELS.items():
        entries = ptxas_entries(build.BUILD_LOGS.get(lib, ''))
        for piece, occ in kernels:
            found = [v for k, v in entries.items() if piece in k]
            regs, st, ld = found[0] if found else (None, None, None)
            per_sm = None
            if occ is not None:
                fn = getattr(build.load_library(lib), occ)
                fn.restype, fn.argtypes = ctypes.c_int, []
                per_sm = fn()
            res[piece] = dict(registers=regs, spill_store_bytes=st,
                              spill_load_bytes=ld, blocks_per_sm=per_sm)
    result['tile_kernels'] = res
    print(json.dumps({'phase': 'tile_kernels', 'kernels': res}), flush=True)


def _finisher_bound(x):
    """Bound of a 4x finisher (either entry) on logits x (B, C, H, W)."""
    B, C, H, W = x.shape
    P = B * 16 * H * W                        # output pixels
    # logits read once, two (C, 16) kernels and (C,) biases in f32,
    # idx and score written once
    n_bytes = x.numel() * x.element_size() + 2 * C * 17 * 4 + P * 8
    # per output pixel-class: stage-2 taps 4 mul + 3 add + bias add,
    # max, sub, exp, sum add; per stage-1 value 8; per pixel 1 divide
    n_ops = (P * C * (8 + 4) + B * C * (2 * H + 2) * (2 * W + 2) * 8 + P)
    return bound(n_bytes, n_ops)


# the 4x finisher's checks beyond the serving call: (B, C, H, W, dtype,
# layout): the serving shape in both layouts and dtypes, a ragged shape
# (no tile divides 148 x 212: the zero ring and the edge replication
# inside tiles), and 19 classes (the generic instance)
FINISHER4X_CASES = ((8, 40, 120, 160, 'bf16', 'nchw'),
                    (8, 40, 120, 160, 'f32', 'cl'),
                    (8, 40, 120, 160, 'f32', 'nchw'),
                    (2, 40, 37, 53, 'bf16', 'cl'),
                    (2, 40, 37, 53, 'f32', 'nchw'),
                    (2, 19, 37, 53, 'bf16', 'cl'),
                    (2, 19, 37, 53, 'f32', 'nchw'))


def _finisher4x_input(g, B, C, H, W, dt, layout):
    x = (torch.randn(B, C, H, W, device='cuda', generator=g) * 3).to(
        torch.bfloat16 if dt == 'bf16' else torch.float32)
    return (x.contiguous(memory_format=torch.channels_last)
            if layout == 'cl' else x)


def _check_finisher4x(name, g, call, plain):
    """Row 1 or 3 through `call(x, C)` against `plain(x, C)`: the
    serving call ((8, 40, 120, 160) bf16 channels-last) and
    FINISHER4X_CASES, idx bit for bit and scores within rtol 1e-5; tied
    classes at 8 and 40 classes must resolve to the first index.
    Returns (the serving input, the largest score error, cases)."""
    serving = (8, 40, 120, 160, 'bf16', 'cl')
    x = _finisher4x_input(g, *serving)
    err = 0.0
    for case in (serving, *FINISHER4X_CASES):
        xx = x if case == serving else _finisher4x_input(g, *case)
        got = call(xx, case[1])
        torch.cuda.synchronize()
        err = max(err, _same(f'{name} {case}', got, plain(xx, case[1])))
    for C, first, other in ((8, 2, 5), (40, 7, 31)):
        xt = torch.zeros(2, C, 48, 64, device='cuda', dtype=torch.bfloat16)
        xt[:, first] = 1.5
        xt[:, other] = 1.5
        i_k, _ = call(xt.contiguous(memory_format=torch.channels_last), C,
                      centre_taps=True)
        torch.cuda.synchronize()
        if not bool((i_k == first).all()):
            fail(f'{name}: tied classes ({C} classes) did not resolve to '
                 f'the first index')
    return x, err, len(FINISHER4X_CASES) + 3


def _finisher4x_resources(fin, build, x, bilinear):
    """The plan of the serving call and the ptxas figures and resident
    blocks an SM of the instance it takes (C = 40, bf16)."""
    plan = fin.f4_plan(tuple(x.shape), x.stride(), x.element_size(),
                       x.data_ptr() % 16 == 0)
    regs, st, ld = _ptxas_of(build, 'finisher4x', 'finisher4x_kernelI13'
                             f'__nv_bfloat16Lb{int(bilinear)}ELi40E')
    return dict(plan=plan._asdict(), grid=[plan.tiles_x, plan.tiles_y,
                                           x.shape[0]],
                registers=regs, spill_store_bytes=st, spill_load_bytes=ld,
                blocks_per_sm=fin.blocks_per_sm(x.dtype, 40, plan))


def check_finisher(fin, report, build):
    """Row 1: the EMSANet serving call ((8, 40, 120, 160) bf16 channels-
    last, the head's layout on the card), FINISHER4X_CASES and ties,
    against the plain version; times the serving call (`cuda_ms` and
    `stream_ms`) and prints its plan, registers, spills and blocks an
    SM."""
    g = torch.Generator(device='cuda').manual_seed(0)
    weights = {}

    def params(C, centre_taps=False):
        if centre_taps:               # the centre tap: ties survive
            kt = torch.zeros(C, 1, 3, 3, device='cuda')
            kt[:, :, 1, 1] = 1.0
            return kt, None, kt, None
        if C not in weights:
            weights[C] = (
                torch.randn(C, 1, 3, 3, device='cuda', generator=g) * 0.3,
                torch.randn(C, device='cuda', generator=g) * 0.1,
                torch.randn(C, 1, 3, 3, device='cuda', generator=g) * 0.3,
                torch.randn(C, device='cuda', generator=g) * 0.1)
        return weights[C]

    x, err, n_cases = _check_finisher4x(
        'finisher4x', g,
        lambda x, C, centre_taps=False: fin.upsample4x_argmax_score(
            x, *params(C, centre_taps)),
        lambda x, C: fin.upsample4x_argmax_score_reference(x, *params(C)))
    k = params(40)
    ms = cuda_ms(lambda: fin.upsample4x_argmax_score(x, *k))
    card = stream_ms(lambda: fin.upsample4x_argmax_score(x, *k))
    plain_ms = cuda_ms(lambda: fin.upsample4x_argmax_score_reference(x, *k))
    b_ms, b_by = _finisher_bound(x)
    report['finisher4x'] = dict(
        name='finisher4x', route='cuda',
        source='nicr_mtsa_tpu_torch/ops/cuda/csrc/finisher4x.cu',
        replaces='nicr_mtsa_tpu/ops/pallas/semantic_finisher4x.py:197',
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    print(json.dumps({'phase': 'kernel', **report['finisher4x'],
                      'stream_ms': card, 'cases': n_cases,
                      'resources': _finisher4x_resources(fin, build, x,
                                                         False)}),
          flush=True)


# the grouping's checks beyond the serving calls (tests/test_torch_
# grouping.py's cases): (name, B, H, W, K, valid centres ('p0.7': each
# with that probability, 'alternate': every other one, 'none'), offset
# dtype, layout ('cl' channels-last, 'nchw'), distance threshold)
GROUPING_CASES = (
    ('bf16_cl', 2, 48, 64, 64, 'p0.7', 'bf16', 'cl', None),
    ('bf16_nchw_threshold', 2, 48, 64, 64, 'p0.7', 'bf16', 'nchw', 6.0),
    ('f32_cl_threshold', 2, 48, 64, 64, 'p0.7', 'f32', 'cl', 4.5),
    ('f32_nchw', 2, 48, 64, 64, 'p0.7', 'f32', 'nchw', None),
    ('no_valid_centre', 2, 48, 64, 64, 'none', 'bf16', 'cl', None),
    ('alternate_valid', 2, 48, 64, 64, 'alternate', 'f32', 'cl', 5.0),
    ('k1', 2, 37, 53, 1, 'p1.0', 'bf16', 'cl', None),
    ('k254', 2, 37, 53, 254, 'p0.7', 'f32', 'nchw', 3.0),
    ('k254_bf16', 2, 37, 53, 254, 'p0.7', 'bf16', 'cl', None))


def _grouping_offsets_case(g, B, H, W, K, valid, dt, layout, spread=8.0):
    """Offsets (B, 2, H, W) of N(0, spread) pixels in `dt` and `layout`,
    int32 centres (B, K, 2) inside the image, their validity and a
    foreground mask of ~60 % of the pixels, on the card."""
    off = (torch.randn(B, 2, H, W, device='cuda', generator=g) * spread).to(
        torch.bfloat16 if dt == 'bf16' else torch.float32)
    if layout == 'cl':
        off = off.contiguous(memory_format=torch.channels_last)
    ctr = torch.stack([
        torch.randint(0, H, (B, K), device='cuda', generator=g),
        torch.randint(0, W, (B, K), device='cuda', generator=g)],
        -1).to(torch.int32)
    if valid == 'none':
        ok = torch.zeros(B, K, dtype=torch.bool, device='cuda')
    elif valid == 'alternate':
        ok = (torch.arange(K, device='cuda') % 2 == 1).expand(B, K)
        ok = ok.contiguous()
    else:
        ok = torch.rand(B, K, device='cuda', generator=g) < float(valid[1:])
    fg = torch.rand(B, H, W, device='cuda', generator=g) < 0.6
    return off, ctr, ok, fg


def _same_grouping(name, got, want):
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f'grouping {name}: ids/min_d2 differ from the plain version')


def check_grouping(grp, report, build):
    """Row 2, both entries against their plain versions, ids and min_d2
    bit for bit: the pipeline entry (`group_pixels_offsets`) at the
    serving call (offsets (8, 2, 480, 640) bf16 channels-last, 64 int32
    centres ~70 % valid) and GROUPING_CASES, plus two tied centres (the
    first must win); the loc-level entry (`group_pixels_kernel`) at B=8,
    P=307200, K=64 with invalid centres, no valid centre, a ragged P, f32
    and int32 centres, and K=254 at P=1500. Times both at B=8
    (`cuda_ms`, `stream_ms`) and prints their grids, registers, spills
    and blocks an SM."""
    g = torch.Generator(device='cuda').manual_seed(1)
    B, H, W, K = 8, 480, 640, 64
    P = H * W
    serving = _grouping_offsets_case(g, B, H, W, K, 'p0.7', 'bf16', 'cl')
    cases = [('serving', serving, None), ('serving_threshold', serving, 7.0)]
    for name, B_, H_, W_, K_, valid, dt, layout, thr in GROUPING_CASES:
        cases.append((name, _grouping_offsets_case(g, B_, H_, W_, K_, valid,
                                                   dt, layout), thr))
    # a tie: three centres at one place, the first invalid: centre 1
    # (id 2) must win every foreground pixel
    off, ctr, ok, fg = _grouping_offsets_case(g, 2, 48, 64, 3, 'p1.0',
                                              'f32', 'cl')
    ctr[:, 1:] = ctr[:, :1]
    ok[:, 0] = False
    cases.append(('tie', (off, ctr, ok, fg), None))
    for name, args, thr in cases:
        got = grp.group_pixels_offsets(*args, threshold=thr,
                                       return_min_d2=True)
        torch.cuda.synchronize()
        _same_grouping(name, got, grp.group_pixels_offsets_reference(
            *args, threshold=thr))
        if name == 'no_valid_centre' and bool((got[0] != 0).any()):
            fail('grouping: ids without any valid centre')
        if name == 'tie' and not bool((got[0][args[3]] == 2).all()):
            fail('grouping: tied centres did not resolve to the first')
    loc_y = torch.rand(B, P, device='cuda', generator=g) * H
    loc_x = torch.rand(B, P, device='cuda', generator=g) * W
    ctr = serving[1]
    valid = serving[2]
    fg = torch.rand(B, P, device='cuda', generator=g) < 0.6
    k254 = _grouping_offsets_case(g, 2, 16, 128, 254, 'p0.6', 'f32', 'cl')
    loc_cases = [(loc_y, loc_x, ctr.float(), valid, fg),
                 (loc_y, loc_x, ctr, valid, fg),
                 (loc_y, loc_x, ctr, torch.zeros_like(valid), fg),
                 (loc_y[:, :100003], loc_x[:, :100003], ctr, valid,
                  fg[:, :100003]),
                 (loc_y[:2, :1500] * (16 / H), loc_x[:2, :1500] * (128 / W),
                  k254[1], k254[2], fg[:2, :1500])]
    for i, args in enumerate(loc_cases):
        got = grp.group_pixels_kernel(*args)
        torch.cuda.synchronize()
        _same_grouping(f'loc case {i}', got, grp.group_pixels_reference(*args))
        if i == 2 and bool((got[0] != 0).any()):
            fail('grouping: ids without any valid centre')
    ms = cuda_ms(lambda: grp.group_pixels_offsets(*serving))
    card = stream_ms(lambda: grp.group_pixels_offsets(*serving))
    plain_ms = cuda_ms(lambda: grp.group_pixels_offsets_reference(*serving))
    loc_args = loc_cases[0]
    loc_ms = cuda_ms(lambda: grp.group_pixels_kernel(*loc_args))
    loc_card = stream_ms(lambda: grp.group_pixels_kernel(*loc_args))
    off, _, ok, fg_s = serving
    # bytes: offsets, mask and ids, the centres and their validity, each
    # once; operations: each foreground pixel against each valid centre
    # of its image (dy, dx, dx * dx, fma as 2, compare: 6), what this
    # run's data needs (background pixels are not grouped)
    n_bytes = off.numel() * off.element_size() + B * P * (1 + 4) + B * K * 9
    n_ops = 6 * int((fg_s.reshape(B, -1).sum(1) * ok.sum(1)).sum())
    b_ms, b_by = bound(n_bytes, n_ops)
    loc_bytes = B * P * (4 + 4 + 1 + 4 + 4) + B * K * 9
    loc_b_ms, _ = bound(loc_bytes, 6 * P * int(valid.sum()))
    resources = {}
    for key, pieces, loc in (
            ('offsets', ('group_pixels_kernelILb0E13__nv_bfloat16i',), False),
            ('loc', ('group_pixels_kernelILb1Eff',), True)):
        regs, st, ld = _ptxas_of(build, 'grouping', *pieces)
        resources[key] = dict(grid=[-(-P // grp.TILE), B], registers=regs,
                              spill_store_bytes=st, spill_load_bytes=ld,
                              blocks_per_sm=grp.blocks_per_sm(loc, K))
    report['grouping'] = dict(
        name='grouping', route='cuda',
        source='nicr_mtsa_tpu_torch/ops/cuda/csrc/grouping.cu',
        replaces='nicr_mtsa_tpu/ops/pallas/grouping_kernel.py:58',
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    print(json.dumps({'phase': 'kernel', **report['grouping'],
                      'stream_ms': card, 'cases': len(cases) + len(loc_cases),
                      'valid_centres': int(ok.sum()),
                      'loc_entry': {'ms': loc_ms, 'stream_ms': loc_card,
                                    'bound_ms': loc_b_ms},
                      'resources': resources}), flush=True)


def _eval_logits(seed):
    """(8, 40, 480, 640) bf16 logits, NCHW and channels-last (the
    layout of the eval model's head on the card)."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    x = (torch.randn(8, 40, 480, 640, device='cuda', generator=g) * 3
         ).to(torch.bfloat16)
    return x, x.contiguous(memory_format=torch.channels_last)


def _tied_logits():
    """Classes 2 and 5 equal and largest everywhere: 2 must win."""
    xt = torch.zeros(2, 8, 48, 64, device='cuda', dtype=torch.bfloat16)
    xt[:, 2] = 1.5
    xt[:, 5] = 1.5
    return xt


def _same(name, got, want):
    (i_k, s_k), (i_r, s_r) = got, want
    n_bad = int((i_k != i_r).sum())
    if n_bad:
        fail(f'{name}: {n_bad} idx differ from the plain version')
    torch.testing.assert_close(s_k, s_r, rtol=1e-5, atol=0)
    return float((s_k - s_r).abs().max())


def _reduce_ops(n_values, n_px, per_value):
    # per class value: `per_value` f32 operations (taps, lerps) plus
    # compare, subtract, exp and add; per pixel one divide
    return n_values * (per_value + 4) + n_px


def _sr_cases(x, x_cl):
    """Row 6's cases beyond the eval call, from its NCHW x and
    channels-last x_cl: (name, logits, the first index every pixel must
    take or None)."""
    g = torch.Generator(device='cuda').manual_seed(6)
    off = torch.empty(x_cl[:2].numel() + 1, device='cuda',
                      dtype=torch.bfloat16)[1:].as_strided(
        x_cl[:2].shape, x_cl[:2].stride())
    off.copy_(x_cl[:2])
    c41 = (torch.randn(2, 41, 480, 640, device='cuda', generator=g) * 3
           ).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    tied40 = torch.zeros(2, 40, 48, 64, device='cuda', dtype=torch.bfloat16)
    tied40[:, 7] = 1.5
    tied40[:, 31] = 1.5
    return (('nchw', x, None), ('cl_f32', x_cl.float(), None),
            ('nchw_f32', x.float(), None),
            ('cl_sliced', x_cl[:, :, 8:472, 16:624], None),
            ('cl_misaligned', off, None), ('cl_41_classes', c41, None),
            ('ties_8_nchw', _tied_logits(), 2),
            ('ties_8_cl', _tied_logits().contiguous(
                memory_format=torch.channels_last), 2),
            ('ties_40_cl', tied40.contiguous(
                memory_format=torch.channels_last), 7))


def check_semantic_reduce(sr, report, build):
    """Row 6: the eval call ((8, 40, 480, 640) bf16 channels-last) and
    `_sr_cases` against the plain version (idx bit for bit, scores
    within rtol 1e-5; tied classes to the first index). Prints each
    case's path, the staged kernel's plan, registers, spills and blocks
    an SM (the strided kernel's registers and spills at C = 40); one
    device launch a call at the eval call and NCHW, both timed
    (`cuda_ms`, `stream_ms`)."""
    x, x_cl = _eval_logits(3)
    err, paths = 0.0, {}
    for name, xx, first in (('eval_cl', x_cl, None), *_sr_cases(x, x_cl)):
        got = sr.semantic_argmax_score(xx)
        torch.cuda.synchronize()
        err = max(err, _same(f'semantic_reduce {name}', got,
                             sr.semantic_argmax_score_reference(xx)))
        if first is not None and not bool((got[0] == first).all()):
            fail(f'semantic_reduce {name}: tied classes did not resolve '
                 f'to the first index')
        paths[name] = sr.plan_of(xx).path
    launches = {name: device_launches(lambda: sr.semantic_argmax_score(xx))
                for name, xx in (('eval_cl', x_cl), ('nchw', x))}
    if set(launches.values()) != {1}:
        fail(f'semantic_reduce: device launches a call {launches}, '
             f'expected 1')
    ms = cuda_ms(lambda: sr.semantic_argmax_score(x_cl))
    card = stream_ms(lambda: sr.semantic_argmax_score(x_cl))
    nchw = {'cuda_ms': cuda_ms(lambda: sr.semantic_argmax_score(x)),
            'stream_ms': stream_ms(lambda: sr.semantic_argmax_score(x))}
    plain_ms = cuda_ms(lambda: sr.semantic_argmax_score_reference(x_cl))
    B, C, H, W = x.shape
    P = B * H * W
    b_ms, b_by = bound(x.numel() * 2 + P * 8,
                       _reduce_ops(x.numel(), P, 0))
    plan = sr.plan_of(x_cl)
    regs, st, ld = _ptxas_of(build, 'semantic_reduce',
                             'staged_kernelI13__nv_bfloat16Li40E')
    _, _, occ = sr._fns(torch.bfloat16)
    resources = dict(plan=plan._asdict(), registers=regs,
                     spill_store_bytes=st, spill_load_bytes=ld,
                     blocks_per_sm=occ(C, plan.run, plan.smem),
                     strided_nchw=dict(zip(
                         ('registers', 'spill_store_bytes',
                          'spill_load_bytes'),
                         _ptxas_of(build, 'semantic_reduce',
                                   'strided_kernelI13__nv_bfloat16Li40E'))))
    report['semantic_reduce'] = dict(
        name='semantic_reduce', route='cuda',
        source='nicr_mtsa_tpu_torch/ops/cuda/csrc/semantic_reduce.cu',
        replaces='nicr_mtsa_tpu/ops/pallas/semantic_reduce.py:42',
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    print(json.dumps({'phase': 'kernel', **report['semantic_reduce'],
                      'stream_ms': card, 'nchw': nchw, 'paths': paths,
                      'device_launches': launches,
                      'resources': resources}), flush=True)


def _ptxas_of(build, lib, *pieces):
    """(registers, spill store bytes, spill load bytes) of the first
    kernel of `lib` whose mangled name holds every one of `pieces`
    (this run's build), or Nones."""
    found = [v for k, v in ptxas_entries(build.BUILD_LOGS.get(lib, '')
                                          ).items()
             if all(p in k for p in pieces)]
    return tuple(found[0]) if found else (None, None, None)


# row 5's checks beyond the eval call: (layout, crop rows, crop cols,
# out_h, out_w); 'cl' channels-last bf16, 'nchw' contiguous bf16, and
# their f32 copies 'cl_f32', 'nchw_f32'
RESIZE_CASES = (('nchw', (0, 480), (0, 640), 512, 512),
                ('cl', (16, 464), (0, 640), 512, 512),
                ('nchw_f32', (0, 480), (0, 640), 512, 512),
                ('cl', (3, 477), (5, 637), 512, 512),     # y0, x0 > 0
                ('cl', (0, 480), (160, 480), 512, 700),   # wider than crop
                ('cl', (0, 480), (0, 640), 333, 500),     # not whole tiles
                ('nchw', (3, 477), (5, 637), 333, 500),
                ('cl_f32', (3, 477), (5, 637), 512, 512))


def check_resize_reduce(rr, report, build):
    """Row 5: the eval call (channels-last bf16 (8, 40, 480, 640) ->
    512 x 512) and RESIZE_CASES against the plain version (idx bit for
    bit, scores within rtol 1e-5); tied classes at 8 classes (NCHW) and
    at 40 (channels-last) must resolve to the first index. Prints the
    plan, registers, spills and blocks an SM of the kernel; times the
    eval call."""
    x, x_cl = _eval_logits(4)
    layouts = {'nchw': x, 'cl': x_cl, 'nchw_f32': x.float(),
               'cl_f32': x_cl.float()}
    full = (slice(0, 480), slice(0, 640))
    err = 0.0
    cases = [('cl', (0, 480), (0, 640), 512, 512), *RESIZE_CASES]
    for layout, (r0, r1), (c0, c1), oh, ow in cases:
        xx, crop = layouts[layout], (slice(r0, r1), slice(c0, c1))
        got = rr.crop_resize_argmax_score(xx, crop, oh, ow)
        torch.cuda.synchronize()
        err = max(err, _same(f'resize_reduce {layout} {crop} -> {oh} x '
                             f'{ow}', got,
                             rr.crop_resize_argmax_score_reference(
                                 xx, crop, oh, ow)))
    del layouts
    tied = _tied_logits()
    tied40 = torch.zeros(2, 40, 48, 64, device='cuda', dtype=torch.bfloat16)
    tied40[:, 7] = 1.5
    tied40[:, 31] = 1.5
    for xt, first in ((tied, 2), (tied40.contiguous(
            memory_format=torch.channels_last), 7)):
        i_k, _ = rr.crop_resize_argmax_score(
            xt, (slice(0, 48), slice(0, 64)), 64, 80)
        torch.cuda.synchronize()
        if not bool((i_k == first).all()):
            fail(f'resize_reduce: tied classes ({xt.shape[1]} classes) did '
                 f'not resolve to the first index')
    ms = cuda_ms(lambda: rr.crop_resize_argmax_score(x_cl, full, 512, 512))
    card = stream_ms(lambda: rr.crop_resize_argmax_score(x_cl, full, 512,
                                                         512))
    plain_ms = cuda_ms(lambda: rr.crop_resize_argmax_score_reference(
        x_cl, full, 512, 512))
    P = 8 * 512 * 512
    # per output value: 4 taps and 3 lerps (3 operations each), then
    # compare, subtract, exp and add
    b_ms, b_by = bound(x.numel() * 2 + P * 8,
                       _reduce_ops(P * 40, P, 9))
    plan = rr._plan(8, 40, 480, 512, 640, 512, torch.bfloat16,
                    torch.cuda.current_device())
    regs, st, ld = _ptxas_of(build, 'resize_reduce',
                             'resize_reduce_kernelI13__nv_bfloat16Li40E')
    _, occ = rr._fn(torch.bfloat16)
    resources = dict(plan=plan._asdict(), registers=regs,
                     spill_store_bytes=st, spill_load_bytes=ld,
                     blocks_per_sm=occ(40, plan.smem))
    report['resize_reduce'] = dict(
        name='resize_reduce', route='cuda',
        source='nicr_mtsa_tpu_torch/ops/cuda/csrc/resize_reduce.cu',
        replaces='nicr_mtsa_tpu/ops/pallas/resize_reduce.py:252',
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    print(json.dumps({'phase': 'kernel', **report['resize_reduce'],
                      'stream_ms': card, 'cases': len(cases) + 2,
                      'resources': resources}), flush=True)
    check_resize_reduce_f32(rr, report, build, x_cl.float())


def check_resize_reduce_f32(rr, report, build, x32):
    """Row 5's f32 instance at the call of the Swin eval step's two
    dense-visual-embedding retrievals: channels-last f32 (8, 40, 480,
    640) -> 512 x 512 against the plain version (idx bit for bit,
    scores within rtol 1e-5), timed, with its plan, registers, spills
    and blocks an SM; its bound counts f32 input bytes."""
    full = (slice(0, 480), slice(0, 640))
    err = _same('resize_reduce f32 retrieval call',
                rr.crop_resize_argmax_score(x32, full, 512, 512),
                rr.crop_resize_argmax_score_reference(x32, full, 512, 512))
    ms = cuda_ms(lambda: rr.crop_resize_argmax_score(x32, full, 512, 512))
    card = stream_ms(lambda: rr.crop_resize_argmax_score(x32, full, 512,
                                                         512))
    plain_ms = cuda_ms(lambda: rr.crop_resize_argmax_score_reference(
        x32, full, 512, 512))
    P = 8 * 512 * 512
    b_ms, b_by = bound(x32.numel() * 4 + P * 8, _reduce_ops(P * 40, P, 9))
    plan = rr._plan(8, 40, 480, 512, 640, 512, torch.float32,
                    torch.cuda.current_device())
    regs, st, ld = _ptxas_of(build, 'resize_reduce',
                             'resize_reduce_kernelIfLi40E')
    _, occ = rr._fn(torch.float32)
    report['resize_reduce_f32'] = dict(
        name='resize_reduce_f32', call='(8, 40, 480, 640) f32 '
        'channels-last -> 512 x 512 (the DVE retrievals)', max_abs_err=err,
        ms=ms, stream_ms=card, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, resources=dict(
            plan=plan._asdict(), registers=regs, spill_store_bytes=st,
            spill_load_bytes=ld, blocks_per_sm=occ(40, plan.smem)))
    print(json.dumps({'phase': 'kernel_f32', **report['resize_reduce_f32']}),
          flush=True)


def _bincount(a, b, n_gt, n_pred):
    """torch.bincount of the (image, gt, pred) cells of slot maps (B, P)
    (out-of-range slots to a dropped cell): the same counts as row 11."""
    B, G, Q = a.shape[0], n_gt + 1, n_pred + 1
    ok = (a >= 0) & (a <= n_gt) & (b >= 0) & (b <= n_pred)
    img = torch.arange(B, device=a.device)[:, None] * (G * Q)
    cell = torch.where(ok, img + a.long() * Q + b.long(), B * G * Q)
    return torch.bincount(cell.reshape(-1), minlength=B * G * Q + 1
                          )[:-1].view(B, G, Q)


def _offset_view(t, by: int):
    """A copy of (B, P) t whose storage starts `by` int32 elements past
    a 16-byte boundary (unit strides)."""
    buf = torch.empty(t.numel() + 4, device=t.device, dtype=t.dtype)
    view = buf[by:by + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def device_launches(fn, attempts: int = 3) -> int:
    """The device activities (kernels, copies, fills) of one fn() call,
    by torch.profiler, after a warm-up call. A trace that recorded no
    device activity at all is taken again, up to `attempts` times: a
    call that launched a kernel has at least one (one such trace of
    row 11 was seen among calls that counted 1)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with prof(activities=[ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        n = int(sum(e.count for e in p.key_averages()
                    if e.device_type == DeviceType.CUDA))
        if n:
            break
    return n


def _same_counts(it, name, a, b, n_gt, n_pred):
    got = it.intersection_matrix_kernel(a, b, n_gt, n_pred)
    torch.cuda.synchronize()
    if not (torch.equal(got, it.intersection_matrix_reference(
            a, b, n_gt, n_pred)) and torch.equal(
                got, _bincount(a, b, n_gt, n_pred).float())):
        fail(f'intersection {name}: counts differ from the plain version '
             f'or torch.bincount')
    return it.plan_of(a.to(torch.int32), b.to(torch.int32), n_gt,
                      n_pred)._asdict()


def check_intersection(it, report, build):
    """Row 11 on slot maps (8, 512 * 512) in [0, 128]: random, every
    pixel in one bin, out-of-range slots (not counted), 257 x 129 bins,
    B=1, P = 262143, storage 4 bytes past a 16-byte boundary (both maps,
    one map) and rows 4 bytes apart (an image stride of P + 1); exact
    against the plain version and torch.bincount. Prints each case's
    plan, the kernel's registers and spills and the device launches of
    one call (which must be 1); times the random and the one-bin case (`cuda_ms`,
    `stream_ms`). The eval step's own maps: `check_intersection_eval`."""
    g = torch.Generator(device='cuda').manual_seed(5)
    B, P, n = 8, 512 * 512, 128
    gt = torch.randint(0, n + 1, (B, P), device='cuda', generator=g,
                       dtype=torch.int32)
    pred = torch.randint(0, n + 1, (B, P), device='cuda', generator=g,
                         dtype=torch.int32)
    one = (torch.full_like(gt, 7), torch.full_like(pred, 3))
    gt256 = torch.randint(0, 257, (B, P), device='cuda', generator=g,
                          dtype=torch.int32)
    wide = torch.randint(0, n + 1, (B, P + 1), device='cuda', generator=g,
                         dtype=torch.int32)
    cases = (('random', gt, pred, n, n), ('one_bin', *one, n, n),
             ('out_of_range', gt - 1, pred + 1, n, n),
             ('bins_257x129', gt256, pred, 256, n),
             ('b1', gt[:1], pred[:1], n, n),
             ('p262143', gt[:, :P - 1], pred[:, :P - 1], n, n),
             ('offset_both', _offset_view(gt, 1), _offset_view(pred, 1),
              n, n),
             ('offset_gt', _offset_view(gt, 1), pred, n, n),
             ('row_stride_p_plus_1', wide[:, 1:], pred, n, n))
    plans = {name: _same_counts(it, name, a, b, ng, npd)
             for name, a, b, ng, npd in cases}
    if int(it.intersection_matrix_kernel(*one, n, n)[:, 7, 3].min()) != P:
        fail('intersection: the one-bin case lost counts')
    call = lambda: it.intersection_matrix_kernel(gt, pred, n, n)
    launches = device_launches(call)
    if launches != 1:
        fail(f'intersection: {launches} device launches a call, '
             f'expected 1')
    ms = cuda_ms(call)
    stream = {'random': stream_ms(call), 'one_bin': stream_ms(
        lambda: it.intersection_matrix_kernel(*one, n, n))}
    plain_ms = cuda_ms(lambda: it.intersection_matrix_reference(
        gt, pred, n, n))
    library_ms = cuda_ms(lambda: _bincount(gt, pred, n, n))
    b_ms, b_by = bound(2 * B * P * 4 + B * (n + 1) ** 2 * 4, 2 * B * P)
    regs, st, ld = _ptxas_of(build, 'intersection', 'intersection_kernel')
    report['intersection'] = dict(
        name='intersection', route='cuda',
        source='nicr_mtsa_tpu_torch/ops/cuda/csrc/intersection.cu',
        replaces='nicr_mtsa_tpu/ops/pallas/intersection_kernel.py:60',
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=library_ms)
    print(json.dumps({'phase': 'kernel', **report['intersection'],
                      'stream_ms': stream, 'plans': plans,
                      'device_launches': launches,
                      'resources': dict(registers=regs,
                                        spill_store_bytes=st,
                                        spill_load_bytes=ld)}), flush=True)


def check_intersection_eval(it, maps):
    """Row 11 on the slot maps the fused eval step passed it (phase 5:
    the panoptic and the instance helper's, which must be two maps of
    (8, 512 * 512) pixels and 129 x 129 bins): exact against the plain
    version and torch.bincount, timed (`stream_ms`)."""
    got = [(tuple(a.shape), tuple(b.shape), n_gt, n_pred)
           for a, b, n_gt, n_pred in maps]
    if got != [((8, 512 * 512), (8, 512 * 512), 128, 128)] * 2:
        fail(f'intersection: the eval step passed row 11 {got}, expected '
             f'two (8, 262144) map pairs of 129 x 129 bins')
    out = {}
    for i, (a, b, n_gt, n_pred) in enumerate(maps):
        plan = _same_counts(it, f'eval map {i}', a, b, n_gt, n_pred)
        out[f'map{i}'] = dict(plan=plan, stream_ms=stream_ms(
            lambda: it.intersection_matrix_kernel(a, b, n_gt, n_pred)),
            shape=list(a.shape),
            distinct_pairs=int((_bincount(a, b, n_gt, n_pred) > 0).sum()))
    print(json.dumps({'phase': 'intersection_eval_maps', **out}),
          flush=True)


def _blocks_from_registers(regs, threads):
    """Resident blocks an SM that `regs` registers a thread allow at
    `threads` threads a block (H100: 65536 registers, 2048 threads, 32
    blocks an SM; no shared memory), where no occupancy entry exists."""
    if regs is None:
        return None
    return int(min(32, 2048 // threads, 65536 // (regs * threads)))


def _layout(x):
    return 'NCHW' if x.is_contiguous() else 'channels-last'


def _timed(fn, plain, library=None):
    return dict(cuda_ms=cuda_ms(fn), stream_ms=stream_ms(fn),
                plain_ms=cuda_ms(plain),
                library_ms=None if library is None else cuda_ms(library))


def check_dataset_kernels(rr, sr, it, result, build):
    """The kernel calls of the dataset eval path (phase 23: 10 classes,
    480 x 640 working and 120 x 160 full resolution) against their plain
    versions, idx bit for bit and scores within rtol 1e-5, each timed
    (`cuda_ms`, `stream_ms`) with its plan, registers and blocks an SM:
    row 5 at (8, 10, 480, 640) bf16 channels-last -> 120 x 160 (a 4x
    downscale, the generic instance) and on an NCHW f32 copy; row 6 at
    (8, 10, 480, 640) bf16 channels-last and NCHW (both strided: 10
    bf16 classes are 20 bytes), tied classes at 10 in both layouts; row
    11 at (8, 19200) slots of 129 x 129 bins, also against
    torch.bincount. Each bound counts every input byte the function
    needs once: row 5's only the rows and columns its two taps touch
    (`bound_plan_ms`: the whole input, which its plan reads)."""
    from nicr_mtsa_tpu_torch.models.upsampling import two_tap_params
    dev = torch.cuda.current_device()
    g = torch.Generator(device='cuda').manual_seed(23)
    x = (torch.randn(8, 10, 480, 640, device='cuda', generator=g) * 3).to(
        torch.bfloat16)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    full, OH, OW = (slice(0, 480), slice(0, 640)), 120, 160
    P_out, P_in = 8 * OH * OW, 8 * 480 * 640
    out = {}
    touched_rows = len(np.unique(np.concatenate(two_tap_params(480, OH)[:2])))
    touched_cols = len(np.unique(np.concatenate(two_tap_params(640, OW)[:2])))
    for name, xx in (('resize_reduce_4x_down', x_cl),
                     ('resize_reduce_4x_down_nchw_f32', x.float())):
        err = _same(name, rr.crop_resize_argmax_score(xx, full, OH, OW),
                    rr.crop_resize_argmax_score_reference(xx, full, OH, OW))
        elt = xx.element_size()
        plan = rr._plan(8, 10, 480, OH, 640, OW, xx.dtype, dev)
        piece = ('resize_reduce_kernelI13__nv_bfloat16Li0E'
                 if xx.dtype == torch.bfloat16 else
                 'resize_reduce_kernelIfLi0E')
        regs, st, ld = _ptxas_of(build, 'resize_reduce', piece)
        _, occ = rr._fn(xx.dtype)
        ops = _reduce_ops(P_out * 10, P_out, 9)
        # the function reads only the rows and columns its taps touch
        b_ms, b_by = bound(
            8 * touched_rows * touched_cols * 10 * elt + P_out * 8, ops)
        out[name] = dict(
            call=f'(8, 10, 480, 640) {xx.dtype} {_layout(xx)} -> {OH} x '
                 f'{OW}',
            max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
            # the plan issues every crop row and column into its ring
            bound_plan_ms=bound(xx.numel() * elt + P_out * 8, ops)[0],
            **_timed(lambda: rr.crop_resize_argmax_score(xx, full, OH, OW),
                     lambda: rr.crop_resize_argmax_score_reference(
                         xx, full, OH, OW)),
            resources=dict(plan=plan._asdict(), registers=regs,
                           spill_store_bytes=st, spill_load_bytes=ld,
                           blocks_per_sm=occ(10, plan.smem)))
    tied = torch.zeros(2, 10, 48, 64, device='cuda', dtype=torch.bfloat16)
    tied[:, 2] = 1.5
    tied[:, 5] = 1.5
    for xt in (tied, tied.contiguous(memory_format=torch.channels_last)):
        i_k, _ = sr.semantic_argmax_score(xt)
        torch.cuda.synchronize()
        if not bool((i_k == 2).all()):
            fail('semantic_reduce: tied classes at 10 classes did not '
                 'resolve to the first index')
    regs, st, ld = _ptxas_of(build, 'semantic_reduce',
                             'strided_kernelI13__nv_bfloat16Li0E')
    for name, xx in (('semantic_reduce_10', x_cl),
                     ('semantic_reduce_10_nchw', x)):
        err = _same(name, sr.semantic_argmax_score(xx),
                    sr.semantic_argmax_score_reference(xx))
        plan = sr.plan_of(xx)
        if plan.path != 'strided':
            fail(f'{name}: took the {plan.path} kernel, expected strided')
        b_ms, b_by = bound(xx.numel() * 2 + P_in * 8,
                           _reduce_ops(xx.numel(), P_in, 0))
        out[name] = dict(
            call=f'(8, 10, 480, 640) bf16 {_layout(xx)}',
            max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
            **_timed(lambda: sr.semantic_argmax_score(xx),
                     lambda: sr.semantic_argmax_score_reference(xx)),
            device_launches=device_launches(
                lambda: sr.semantic_argmax_score(xx)),
            resources=dict(plan=plan._asdict(), registers=regs,
                           spill_store_bytes=st, spill_load_bytes=ld,
                           blocks_per_sm_from_registers=(
                               _blocks_from_registers(
                                   regs, sr.STRIDED_THREADS))))
    gt = torch.randint(0, 129, (8, OH * OW), device='cuda', generator=g,
                       dtype=torch.int32)
    pred = torch.randint(0, 129, (8, OH * OW), device='cuda', generator=g,
                         dtype=torch.int32)
    plan = _same_counts(it, 'dataset call', gt, pred, 128, 128)
    regs, st, ld = _ptxas_of(build, 'intersection', 'intersection_kernel')
    b_ms, b_by = bound(2 * gt.numel() * 4 + 8 * 129 * 129 * 4,
                       2 * gt.numel())
    out['intersection_19200'] = dict(
        call='(8, 19200) int32 slot maps, 129 x 129 bins', max_abs_err=0.0,
        bound_ms=b_ms, bound_by=b_by,
        **_timed(lambda: it.intersection_matrix_kernel(gt, pred, 128, 128),
                 lambda: it.intersection_matrix_reference(gt, pred, 128,
                                                          128),
                 lambda: _bincount(gt, pred, 128, 128)),
        device_launches=device_launches(
            lambda: it.intersection_matrix_kernel(gt, pred, 128, 128)),
        resources=dict(plan=plan, registers=regs, spill_store_bytes=st,
                       spill_load_bytes=ld))
    result['dataset_kernels'] = out
    for name, row in out.items():
        print(json.dumps({'phase': 'kernel_dataset', 'name': name, **row}),
              flush=True)


def check_ties():
    """First-index tie-breaks on the card: the centre table of a
    heatmap full of tied maxima and the merge's majority vote equal
    the CPU results exactly (torch.topk leaves the order of ties
    undefined on CUDA; the port's selections are stable sorts and
    explicit first-index reductions)."""
    from nicr_mtsa_tpu_torch.ops.merge import deeplab_merge
    from nicr_mtsa_tpu_torch.ops.nms import get_instance_centers
    g = torch.Generator().manual_seed(2)
    shape = (8, 480, 640)
    heat = torch.randint(0, 6, shape, generator=g).float() / 5
    sem = torch.randint(0, 41, shape, generator=g, dtype=torch.int32)
    ins = torch.randint(0, 65, shape, generator=g, dtype=torch.int32)
    fg = torch.rand(shape, generator=g) < 0.5
    thing = (torch.arange(41) > 0) & (torch.arange(41) < 9)
    for name, fn, args in (('centres', get_instance_centers, (heat,)),
                           ('merge', deeplab_merge, (sem, ins, fg, thing))):
        on_cpu = fn(*args)
        on_card = fn(*[a.cuda() for a in args])
        torch.cuda.synchronize()
        for a, b in zip(on_cpu, on_card):
            if not torch.equal(a, b.cpu()):
                fail(f'{name}: card and CPU differ on tied inputs')
    print(json.dumps({'phase': 'ties', 'centres': 'exact',
                      'merge': 'exact'}), flush=True)


def _wab_weights(g, C, v2, ws):
    """Random weights of one window-attention sub-block (f32)."""
    h, N = C // 32, ws * ws
    r = lambda *shape, s=1.0: torch.randn(*shape, device='cuda',
                                          generator=g) * s
    bqkv = r(3 * C, s=0.1)
    if v2:
        bqkv[C:2 * C] = 0.0
    return dict(wqkv=r(C, 3 * C, s=C ** -0.5), bqkv=bqkv,
                wproj=r(C, C, s=C ** -0.5), bproj=r(C, s=0.1),
                bias=(16 * torch.sigmoid(r(h, N, N)) if v2
                      else r(h, N, N, s=0.5)),
                n_heads=h,
                v2_scale=(torch.exp(torch.clamp(
                    np.log(10.0) + r(h, s=0.3), max=float(np.log(100.0))))
                    if v2 else None))


def _wab_ops_bytes(Bw, N, C, n_elems, elt):
    """Flops of the sub-block over Bw windows of N tokens (qkv and
    output products, QK^T and PV) and its bytes (n_elems activations
    in and out, the weights and the bias table once)."""
    n_ops = Bw * (2 * N * C * 4 * C + 4 * N * N * C)
    n_bytes = 2 * n_elems * elt + 4 * C * C * elt + C * N * N // 8
    return n_ops, n_bytes


# row 8's Swin stages of B=8 480 x 640 serving: image (H, W, C), each
# padded to 8 x 8 windows (stage 4: 15 x 20 to 16 x 24)
BLOCK_STAGES = {'stage1': (120, 160, 128), 'stage2': (60, 80, 256),
                'stage3': (30, 40, 512), 'stage4': (15, 20, 1024)}


def check_window_attention(wa, report, result):
    """Row 8 through both entries, bf16 and f32 (within 1e-4 of max |out|
    in f32, 2e-2 in bf16): the image entry the Swin blocks call at the
    four stages of B=8 serving (`BLOCK_STAGES`, 4 to 32 heads), v2,
    shifted and unshifted; the windows entry at stage 1 (2400 windows of
    64 tokens, C=128) and stage 4 (48, C=1024), shifted v2; a shifted v1
    image of 49-token windows (B=2, 120 x 160 padded to 126 x 161).
    Times the image entry in bf16, shifted, at every stage against the
    bound, the plain version at stages 1 and 4; the line carries the
    ptxas figures of the two bf16 kernels (phase 1)."""
    g = torch.Generator(device='cuda').manual_seed(6)
    rnd = lambda *shape: torch.randn(*shape, device='cuda', generator=g)
    w = {st: _wab_weights(g, C, True, 8)
         for st, (_, _, C) in BLOCK_STAGES.items()}
    wv1 = _wab_weights(g, 128, False, 7)
    cases = {
        'stage1_windows': (wa.window_attention_block, wa.
                           window_attention_block_reference,
                           dict(w['stage1'], x=rnd(2400, 64, 128),
                                grid_hw=(15, 20), shift=(4, 4))),
        'stage4_windows': (wa.window_attention_block, wa.
                           window_attention_block_reference,
                           dict(w['stage4'], x=rnd(48, 64, 1024),
                                grid_hw=(2, 3), shift=(4, 4))),
        'v1_image': (wa.window_attention_image,
                     wa.window_attention_image_reference,
                     dict(wv1, x=rnd(2, 120, 160, 128), ws=7, shift=3)),
    }
    for st, (H, W, C) in BLOCK_STAGES.items():
        x = rnd(8, H, W, C)
        for shift, tag in ((4, ''), (0, '_unshifted')):
            cases[f'{st}_image{tag}'] = (
                wa.window_attention_image,
                wa.window_attention_image_reference,
                dict(w[st], x=x, ws=8, shift=shift))
    errs, max_abs = {}, 0.0
    for name, (fn, ref_fn, c) in cases.items():
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = dict(c, x=c['x'].to(dt))
            got = fn(**args)
            torch.cuda.synchronize()
            want = ref_fn(**args)
            if not bool(torch.isfinite(got).all()):
                fail(f'window_attention_block {name} {dt}: non-finite '
                     f'output')
            err = float((got.float() - want.float()).abs().max())
            ref = float(want.float().abs().max())
            errs[f'{name}_{str(dt)[6:]}'] = err / ref
            max_abs = max(max_abs, err)
            if not err <= tol * ref:
                fail(f'window_attention_block {name} {dt}: max error '
                     f'{err} > {tol} x max |out| {ref}')
    stages = {}
    for st, (H, W, C) in BLOCK_STAGES.items():
        fn, ref_fn, c = cases[f'{st}_image']
        args = dict(c, x=c['x'].to(torch.bfloat16))
        # the padded image's windows: B x ceil(H / 8) x ceil(W / 8)
        Bw = 8 * -(-H // 8) * -(-W // 8)
        n_ops, n_bytes = _wab_ops_bytes(Bw, 64, C, 8 * H * W * C, 2)
        b_ms, b_by = bound(n_bytes, n_ops, PEAK_BF16_FLOPS)
        stages[st] = dict(shape=[8, H, W, C], windows=Bw,
                          ms=cuda_ms(lambda: fn(**args)), bound_ms=b_ms,
                          bound_by=b_by)
        if st in ('stage1', 'stage4'):
            stages[st]['plain_ms'] = cuda_ms(lambda: ref_fn(**args))
    s1 = stages['stage1']
    report['window_attention_block'] = dict(
        name='window_attention_block', route='cuda',
        source='nicr_mtsa_tpu_torch/ops/cuda/csrc/window_attention_block.cu',
        replaces='nicr_mtsa_tpu/ops/pallas/window_attention.py:300',
        max_abs_err=max_abs, ms=s1['ms'], plain_ms=s1['plain_ms'],
        bound_ms=s1['bound_ms'], bound_by=s1['bound_by'], library_ms=None)
    ptxas = {k: v for k, v in result.get('tile_kernels', {}).items()
             if 'attend_kernel' in k or k == 'proj_kernel'}
    print(json.dumps({'phase': 'kernel', **report['window_attention_block'],
                      'shape': s1['shape'], 'rel_err': errs,
                      'stages': stages, 'ptxas': ptxas,
                      'library': 'none: no single PyTorch call computes '
                                 'the qkv product, cosine attention with '
                                 'bias and shift mask, and the output '
                                 'projection'}), flush=True)


# row 7 at its training shapes (B=8, 480 x 640): stages 1 to 4, each a
# shifted v2 block on its padded window grid
CORE_CASES = {'stage1': (2400, 128, (15, 20)), 'stage2': (640, 256, (8, 10)),
              'stage3': (160, 512, (4, 5)), 'stage4': (48, 1024, (2, 3))}
# v1's 49-token windows (7 x 7), shifted (3, 3): 2 images of a 3 x 4
# window grid, C=128 (the kernels' rows >= N)
CORE_V1 = (24, 128, (3, 4), 49, (3, 3))
# bf16: a few ulps (2^-8 relative) of max |.|: another f32 summation
# order moves a logit by ~1e-6 and can flip the rounding of P, dS or an
# output value by one ulp
CORE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _core_inputs(g, Bw, C, dt, N=64):
    """Scaled q (v2: unit rows x ~10), unit k, v, the v2 bias range and
    an upstream gradient of N-token windows, in `dt` (bias f32)."""
    h = C // 32
    rnd = lambda *s: torch.randn(*s, device='cuda', generator=g)
    unit = lambda t: t / t.norm(dim=-1, keepdim=True)
    q = (unit(rnd(Bw, N, h, 32)) * 10).reshape(Bw, N, C)
    k = unit(rnd(Bw, N, h, 32)).reshape(Bw, N, C)
    bias = 16 * torch.sigmoid(rnd(h, N, N))
    return [t.to(dt) for t in (q, k, rnd(Bw, N, C), rnd(Bw, N, C))] \
        + [bias]


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def _core_bound(Bw, C, elt, backward: bool, peak):
    """Row 7's bound: forward 4 Bw N C elements + the lse, 4 Bw h N^2 d
    flops; backward 7 Bw N C elements + the lse, 10 Bw h N^2 d flops."""
    h, N = C // 32, 64
    n_bytes = (7 if backward else 4) * Bw * N * C * elt + Bw * h * N * 4
    return bound(n_bytes, (10 if backward else 4) * Bw * h * N * N * 32,
                 peak)


def _check_core_case(wac, g, case, Bw, C, grid, shift, N, errs, max_abs):
    """Row 7 at one shape against its plain versions in f32 and bf16:
    the forward (out, lse), the backward (dq, dk, dv, dbias from the
    plain lse) and the backward's outputs bit-equal over two runs."""
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do, bias = _core_inputs(g, Bw, C, dt, N)
        args = (q, k, v, bias, grid, shift)
        got = wac.window_attention_core_forward(*args)
        torch.cuda.synchronize()
        want = wac.window_attention_core_reference(*args)
        lse = want[1]
        bargs = (q, k, v, bias, do, lse, grid, shift)
        got += wac.window_attention_core_backward(*bargs)
        torch.cuda.synchronize()
        again = wac.window_attention_core_backward(*bargs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got[2:], again)):
            fail(f'window_attention_core {case} {dt}: two backward runs '
                 f'differ (dbias must be deterministic)')
        want += wac.window_attention_core_backward_reference(*bargs)
        for name, a, b in zip(('out', 'lse', 'dq', 'dk', 'dv',
                               'dbias_bwd'), got, want):
            tol = 1e-4 if name == 'lse' else CORE_TOL[dt]
            err = _rel_err(a, b)
            errs[f'{case}_{str(dt)[6:]}_{name}'] = err
            max_abs[name] = max(max_abs.get(name, 0.0), float(
                (a.float() - b.float()).abs().max()))
            if not err <= tol:
                fail(f'window_attention_core {case} {dt} {name}: max '
                     f'error {err} x max |.| > {tol}')


def check_window_attention_core(wac, report):
    """Row 7 against its plain versions at stages 1 to 4 (2400 windows,
    C 128, 4 heads; 640, 256, 8; 160, 512, 16; 48, 1024, 32), shifted,
    and at a shifted v1 stage of 49-token windows (CORE_V1): the
    forward (out and lse), the backward (dq, dk, dv, dbias, from the
    plain lse; its dbias sums the windows in another order than the
    plain version's `ds.sum(0)`) in f32 within 1e-4 and bf16 within 1e-2
    of max |.|, the dbias reduction alone bit for bit against its plain
    version on partials of the stage's shape (the same f32 adds in the
    same order), and the backward's outputs bit-equal over two runs.
    Times bf16 at every stage 1-4 against the bound and
    F.scaled_dot_product_attention (scale 1, the bias and shift mask as
    its float mask; forward alone and forward + backward, q, k, v
    gradients only), the plain versions at stage 1."""
    import torch.nn.functional as F
    g = torch.Generator(device='cuda').manual_seed(9)
    errs, max_abs, times = {}, {}, {}
    for case, (Bw, C, grid) in CORE_CASES.items():
        _check_core_case(wac, g, case, Bw, C, grid, (4, 4), 64, errs,
                         max_abs)
        # the reduction alone, on partials of the backward's shape at
        # this stage: the same f32 adds in the same order as its plain
        # version, so bit for bit
        h = C // 32
        parts = torch.randn(wac.bwd_partition(Bw, h)[1], h, 64, 64,
                            device='cuda', generator=g)
        got = wac.dbias_reduce(parts)
        torch.cuda.synchronize()
        want = wac.dbias_reduce_reference(parts)
        errs[f'{case}_dbias_reduce'] = _rel_err(got, want)
        max_abs['dbias_reduce'] = max(max_abs.get('dbias_reduce', 0.0),
                                      float((got - want).abs().max()))
        if not torch.equal(got, want):
            fail(f'window_attention_core {case}: the dbias reduction of '
                 f'{tuple(parts.shape)} partials differs from its plain '
                 f'version by {max_abs["dbias_reduce"]}')
        # timings in bf16 (the training dtype)
        q, k, v, do, bias = _core_inputs(g, Bw, C, torch.bfloat16)
        args = (q, k, v, bias, grid, (4, 4))
        _, lse = wac.window_attention_core_forward(*args)
        bargs = (q, k, v, bias, do, lse, grid, (4, 4))
        mask = wac.shift_attn_mask(grid, 8, (4, 4), 'cuda')
        nW = mask.shape[0]
        fmask = (bias[None, None] + mask[None, :, None]).expand(
            Bw // nW, -1, -1, -1, -1).reshape(Bw, h, 64, 64).to(
                torch.bfloat16)
        heads = [t.view(Bw, 64, h, 32).transpose(1, 2)
                 for t in (q, k, v, do)]
        leaves = [t.detach().clone().requires_grad_() for t in heads[:3]]

        def sdpa_fwd_bwd():
            for t in leaves:
                t.grad = None
            F.scaled_dot_product_attention(
                *leaves, attn_mask=fmask, scale=1.0).backward(heads[3])

        times[case] = {
            'fwd': cuda_ms(lambda: wac.window_attention_core_forward(*args)),
            'bwd': cuda_ms(
                lambda: wac.window_attention_core_backward(*bargs)),
            'dbias': cuda_ms(lambda: wac.dbias_reduce(parts)),
            'dbias_library': cuda_ms(lambda: parts.sum(0)),
            'sdpa_fwd': cuda_ms(lambda: F.scaled_dot_product_attention(
                *heads[:3], attn_mask=fmask, scale=1.0)),
            'sdpa_fwd_bwd': cuda_ms(sdpa_fwd_bwd),
            'fwd_bound': _core_bound(Bw, C, 2, False, PEAK_BF16_FLOPS),
            'bwd_bound': _core_bound(Bw, C, 2, True, PEAK_BF16_FLOPS),
            'dbias_bound': bound(parts.numel() * 4 + h * 64 * 64 * 4,
                                 parts.numel()),
            'dbias_partials': list(parts.shape)}
        if case == 'stage1':
            times[case].update(
                fwd_plain=cuda_ms(
                    lambda: wac.window_attention_core_reference(*args)),
                bwd_plain=cuda_ms(lambda: wac.
                                  window_attention_core_backward_reference(
                                      *bargs)),
                dbias_plain=cuda_ms(
                    lambda: wac.dbias_reduce_reference(parts)))
    Bw, C, grid, N, shift = CORE_V1
    _check_core_case(wac, g, 'v1_49', Bw, C, grid, shift, N, errs, max_abs)
    t1 = times['stage1']
    src = 'nicr_mtsa_tpu_torch/ops/cuda/csrc/window_attention_core.cu'
    rows = (('window_attention_core_fwd', 'fwd', ('out', 'lse'), 533,
             'sdpa_fwd'),
            ('window_attention_core_bwd', 'bwd',
             ('dq', 'dk', 'dv', 'dbias_bwd'), 563, 'sdpa_fwd_bwd'),
            ('window_attention_core_dbias', 'dbias', ('dbias_reduce',), 563,
             'dbias_library'))
    for name, key, err_keys, line, lib in rows:
        report[name] = dict(
            name=name, route='cuda', source=src,
            replaces=f'nicr_mtsa_tpu/ops/pallas/window_attention.py:{line}',
            max_abs_err=max(max_abs[n] for n in err_keys),
            ms=t1[key], plain_ms=t1[f'{key}_plain'],
            bound_ms=t1[f'{key}_bound'][0], bound_by=t1[f'{key}_bound'][1],
            library_ms=t1[lib])
    print(json.dumps({'phase': 'kernel_window_attention_core',
                      'shapes': {**{c: [Bw, 64, C] for c, (Bw, C, _) in
                                    CORE_CASES.items()},
                                 'v1_49': list(CORE_V1[:2]) + [CORE_V1[3]]},
                      'rel_err': errs, 'times': times,
                      'library': 'F.scaled_dot_product_attention(scale=1, '
                                 'float mask): forward, and forward + '
                                 'backward (q, k, v) for the backward row; '
                                 'torch.sum for the dbias reduction'}),
          flush=True)
    for name, *_ in rows:
        print(json.dumps({'phase': 'kernel', **report[name]}), flush=True)


def _ulp_check(got, want):
    """(values beyond one bf16 ulp of `want`, values beyond both one
    ulp and the f32 noise floor 1e-6 x max |want|): where the affine
    y * w + b cancels to near 0, another f32 summation order of the
    statistics moves the result by more than one ulp of a tiny value."""
    want = want.float()
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    diff = (got.float() - want).abs()
    floor = 1e-6 * float(want.abs().max())
    return int((diff > ulp).sum()), int((diff > torch.clamp(
        ulp, min=floor)).sum())


# row 10's path shapes in Swin serving at B=8 480 x 640 (rows, C,
# launches a request): the two patch embeds; stage 1 (4 block LNs, 2
# skip LNs at /4); stage 2 (4 blocks, merge 1, 2 skips); stage 3 (12
# blocks, merge 2, 2 skips); stage 4 (4 blocks, merge 3, final norm)
LN_SHAPES = ((153600, 96, 1), (153600, 32, 1), (153600, 128, 6),
             (38400, 256, 7), (9600, 512, 15), (2400, 1024, 6))
LN_DTYPES = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
             (torch.float32, torch.bfloat16), (torch.float32, torch.float32))


def _ln_bound(rows, C):
    # bf16 read once and written once, f32 scale and bias; ~8 f32
    # operations a value
    return bound(rows * C * 4 + 2 * C * 4, 8 * rows * C)


def _ln_agree(ln, x, w, b, eps, out_dtype, what, beyond_ulp):
    got = ln.fused_layer_norm(x, w, b, eps, out_dtype)
    torch.cuda.synchronize()
    want = ln.layer_norm_reference(x, w, b, eps, out_dtype)
    if out_dtype == torch.bfloat16:
        n_ulp, n_bad = _ulp_check(got, want)
        beyond_ulp[what] = n_ulp
        if n_bad:
            fail(f'layernorm {what}: {n_bad} values more than 1 ulp and '
                 f'1e-6 x max |out| from the plain version')
        return 0.0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    return float((got - want).abs().max())


def check_layernorm(ln, report, build):
    """Row 10 at every width of its path (C 32, 96, 128, 256, 512, 1024)
    with the path's rows and with 4801 rows (not a multiple of the rows
    a warp takes), in the four dtype pairs bf16/f32 -> bf16/f32, eps
    1e-5 and 1e-6, and on misaligned views (x[1:] of a flat buffer):
    bf16 outputs within 1 ulp (or 1e-6 x max |out|, where the affine
    cancels to near 0), f32 outputs within 1e-5. Times every path shape
    (`cuda_ms` and the card's time alone) against its bound, its plain
    version and F.layer_norm; prints the plan, registers, spills and
    blocks an SM of each; the kernels line times (153600, 128)."""
    import torch.nn.functional as F
    g = torch.Generator(device='cuda').manual_seed(7)
    err, beyond_ulp = 0.0, {}
    for k, (rows, C, _) in enumerate(LN_SHAPES):
        w = torch.rand(C, device='cuda', generator=g) + 0.5
        b = torch.randn(C, device='cuda', generator=g) * 0.1
        for n in (rows, 4801):
            x = torch.randn(n, C, device='cuda', generator=g) * 2 + 0.5
            for j, (tin, tout) in enumerate(LN_DTYPES):
                eps = 1e-6 if (j + k) % 2 else 1e-5
                what = f'({n}, {C}) {tin} -> {tout} eps {eps}'
                err = max(err, _ln_agree(ln, x.to(tin), w, b, eps, tout,
                                         what, beyond_ulp))
        for tin in (torch.bfloat16, torch.float32):
            flat = torch.randn(4801 * C + 1, device='cuda', generator=g)
            xm = flat.to(tin)[1:].view(4801, C)
            if xm.data_ptr() % 16 == 0:
                fail('layernorm: the misaligned view is aligned')
            err = max(err, _ln_agree(ln, xm, w, b, 1e-5, tin,
                                     f'misaligned (4801, {C}) {tin}',
                                     beyond_ulp))
    shapes, main = [], None
    for rows, C, launches in LN_SHAPES:
        x = (torch.randn(rows, C, device='cuda', generator=g)
             ).to(torch.bfloat16)
        w = torch.rand(C, device='cuda', generator=g) + 0.5
        b = torch.randn(C, device='cuda', generator=g) * 0.1
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
        plan = ln._plan(rows, C, torch.bfloat16, torch.bfloat16, True,
                        torch.cuda.current_device())
        regs, st, ld = _ptxas_of(
            build, 'layernorm', 'layer_norm_kernelI13__nv_bfloat16S',
            f'Li{plan.nv}E')
        _, occ = ln._fn(torch.bfloat16, torch.bfloat16)
        b_ms, b_by = _ln_bound(rows, C)
        shape = dict(
            rows=rows, C=C, launches_a_request=launches,
            ms=cuda_ms(lambda: ln.fused_layer_norm(x, w, b)),
            stream_ms=stream_ms(lambda: ln.fused_layer_norm(x, w, b)),
            plain_stream_ms=stream_ms(
                lambda: ln.layer_norm_reference(x, w, b)),
            library_stream_ms=stream_ms(
                lambda: F.layer_norm(x, (C,), wb, bb, 1e-5)),
            bound_ms=b_ms, bound_by=b_by, plan=plan._asdict(),
            registers=regs, spill_store_bytes=st, spill_load_bytes=ld,
            blocks_per_sm=occ(plan.nv))
        shapes.append(shape)
        print(json.dumps({'phase': 'layernorm_shape', **shape}), flush=True)
        if (rows, C) == (153600, 128):
            main = (x, w, b, wb, bb, b_ms, b_by)
    x, w, b, wb, bb, b_ms, b_by = main
    ms = cuda_ms(lambda: ln.fused_layer_norm(x, w, b))
    plain_ms = cuda_ms(lambda: ln.layer_norm_reference(x, w, b))
    library_ms = cuda_ms(lambda: F.layer_norm(x, (128,), wb, bb, 1e-5))
    report['layernorm'] = dict(
        name='layernorm', route='cuda',
        source='nicr_mtsa_tpu_torch/ops/cuda/csrc/layernorm.cu',
        replaces='nicr_mtsa_tpu/ops/pallas/layernorm.py:40',
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=library_ms)
    request = dict(
        stream_ms=sum(s['stream_ms'] * s['launches_a_request']
                      for s in shapes),
        bound_ms=sum(s['bound_ms'] * s['launches_a_request']
                     for s in shapes),
        plain_stream_ms=sum(s['plain_stream_ms'] *
                            s['launches_a_request'] for s in shapes),
        library_stream_ms=sum(s['library_stream_ms'] *
                              s['launches_a_request'] for s in shapes))
    print(json.dumps({'phase': 'kernel', **report['layernorm'],
                      'shape': [153600, 128], 'a_request': request,
                      'bf16_values_beyond_1ulp': beyond_ulp}), flush=True)


def check_finisher_bilinear(fin, report, build):
    """Row 3: the Swin serving call ((8, 40, 120, 160) bf16 channels-
    last), FINISHER4X_CASES and ties, against the plain version; times
    the serving call (`cuda_ms` and `stream_ms`) and prints its plan,
    registers, spills and blocks an SM."""
    g = torch.Generator(device='cuda').manual_seed(8)
    x, err, n_cases = _check_finisher4x(
        'finisher4x_bilinear', g,
        lambda x, C, centre_taps=False:
            fin.upsample4x_bilinear_argmax_score(x),
        lambda x, C: fin.upsample4x_bilinear_argmax_score_reference(x))
    ms = cuda_ms(lambda: fin.upsample4x_bilinear_argmax_score(x))
    card = stream_ms(lambda: fin.upsample4x_bilinear_argmax_score(x))
    plain_ms = cuda_ms(
        lambda: fin.upsample4x_bilinear_argmax_score_reference(x))
    b_ms, b_by = _finisher_bound(x)
    report['finisher4x_bilinear'] = dict(
        name='finisher4x_bilinear', route='cuda',
        source='nicr_mtsa_tpu_torch/ops/cuda/csrc/finisher4x.cu',
        replaces='nicr_mtsa_tpu/ops/pallas/semantic_finisher4x.py:285',
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    print(json.dumps({'phase': 'kernel', **report['finisher4x_bilinear'],
                      'stream_ms': card, 'cases': n_cases,
                      'resources': _finisher4x_resources(fin, build, x,
                                                         True),
                      'library': 'none: no single PyTorch call gives the '
                                 'argmax and max-softmax score of a 4x '
                                 'upsampling'}), flush=True)


# the 2x finisher's checks beyond the path's shape: (B, C, H, W, dtype,
# layout, bias): a ragged shape (no 32 x 64 tile divides 74 x 106), 19
# classes (the generic instance), and an odd shape without a bias
FINISHER2X_CASES = ((2, 40, 37, 53, 'bf16', 'cl', True),
                    (2, 40, 37, 53, 'f32', 'nchw', True),
                    (2, 19, 37, 53, 'bf16', 'cl', True),
                    (2, 19, 37, 53, 'f32', 'nchw', True),
                    (3, 13, 7, 10, 'bf16', 'nchw', False),
                    (3, 13, 7, 10, 'f32', 'cl', False))


def check_finisher2x(fin, report, build):
    """Row 4 at the `--no-defer4x` path's (8, 40, 240, 320) logits,
    channels-last (the head's layout on the card) and contiguous, bf16
    and f32, and at FINISHER2X_CASES; tied classes at 8 and 40 classes
    (the first index must win): idx bit for bit, scores within rtol
    1e-5. Times bf16 channels-last (`cuda_ms` and `stream_ms`) and
    prints its plan, registers, spills and blocks an SM."""
    g = torch.Generator(device='cuda').manual_seed(10)
    B, C, H, W = 8, 40, 240, 320
    x = torch.randn(B, C, H, W, device='cuda', generator=g) * 3
    k = torch.randn(C, 1, 3, 3, device='cuda', generator=g) * 0.3
    b = torch.randn(C, device='cuda', generator=g) * 0.1
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        cases += [(xd.contiguous(memory_format=torch.channels_last), k, b),
                  (xd, k, b)]
    for Bc, Cc, Hc, Wc, dt, layout, with_bias in FINISHER2X_CASES:
        xc = _finisher4x_input(g, Bc, Cc, Hc, Wc, dt, layout)
        kc = torch.randn(Cc, 1, 3, 3, device='cuda', generator=g) * 0.3
        bc = torch.randn(Cc, device='cuda', generator=g) * 0.1
        cases.append((xc, kc, bc if with_bias else None))
    err = 0.0
    for args in cases:
        got = fin.upsample2x_argmax_score(*args)
        torch.cuda.synchronize()
        err = max(err, _same(f'finisher2x {tuple(args[0].shape)} '
                             f'{args[0].dtype} {args[0].stride()}', got,
                             fin.upsample2x_argmax_score_reference(*args)))
    for Ct, first, other in ((8, 2, 5), (40, 7, 31)):
        kt = torch.zeros(Ct, 1, 3, 3, device='cuda')
        kt[:, :, 1, 1] = 1.0          # the centre tap: ties survive
        xt = torch.zeros(2, Ct, 48, 64, device='cuda', dtype=torch.bfloat16)
        xt[:, first] = 1.5
        xt[:, other] = 1.5
        i_k, _ = fin.upsample2x_argmax_score(
            xt.contiguous(memory_format=torch.channels_last), kt, None)
        torch.cuda.synchronize()
        if not bool((i_k == first).all()):
            fail(f'finisher2x: tied classes ({Ct} classes) did not resolve '
                 f'to the first index')
    xd = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    ms = cuda_ms(lambda: fin.upsample2x_argmax_score(xd, k, b))
    card = stream_ms(lambda: fin.upsample2x_argmax_score(xd, k, b))
    plain_ms = cuda_ms(lambda: fin.upsample2x_argmax_score_reference(xd, k, b))
    P = B * 4 * H * W                         # output pixels
    # logits read once, the (C, 16) kernel and (C,) bias in f32, idx and
    # score written once; per output pixel-class 4 mul + 3 add taps, the
    # bias add, max, subtract, exp and sum add; per pixel one divide
    b_ms, b_by = bound(xd.numel() * 2 + C * 17 * 4 + P * 8, P * C * 12 + P)
    plan = fin.plan_for(xd)
    regs, st, ld = _ptxas_of(build, 'finisher4x',
                             'finisher2x_kernelI13__nv_bfloat16Li40E')
    report['finisher2x'] = dict(
        name='finisher2x', route='cuda',
        source='nicr_mtsa_tpu_torch/ops/cuda/csrc/finisher4x.cu',
        replaces='nicr_mtsa_tpu/ops/pallas/semantic_finisher.py:161',
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    print(json.dumps({'phase': 'kernel', **report['finisher2x'],
                      'stream_ms': card, 'shape': [B, C, H, W],
                      'cases': len(cases) + 2,
                      'resources': dict(
                          plan=plan._asdict(),
                          grid=[plan.tiles_x, plan.tiles_y, B],
                          registers=regs, spill_store_bytes=st,
                          spill_load_bytes=ld,
                          blocks_per_sm=fin.blocks_per_sm(xd.dtype, C,
                                                          plan)),
                      'library': 'none: no single PyTorch call gives the '
                                 'argmax and max-softmax score of an '
                                 'upsampling'}), flush=True)


def _padded_stage_qkv(g, B, Hs, Ws, C, ws, shift, dt):
    """The packed qkv (Bw, ws * ws, 3C) of a Swin block on a random
    (B, Hs, Ws, C) image: zero-padded to window multiples, rolled by the
    shift and partitioned, then x . Wqkv + b with the k third of b zero
    (as v2 has it), so the pad tokens have k = 0 exactly. Returns (qkv
    in dt, the window grid)."""
    from nicr_mtsa_tpu_torch.ops.cuda.window_attention import (
        image_windows, window_partition)
    import torch.nn.functional as F
    x = torch.randn(B, Hs, Ws, C, device='cuda', generator=g)
    pad_h, pad_w, grid, (sh, sw) = image_windows(Hs, Ws, ws, shift)
    x = torch.roll(F.pad(x, (0, 0, 0, pad_w, 0, pad_h)), (-sh, -sw), (1, 2))
    w = torch.randn(C, 3 * C, device='cuda', generator=g) * C ** -0.5
    bq = torch.randn(3 * C, device='cuda', generator=g) * 0.1
    bq[C:2 * C] = 0.0
    qkv = window_partition(x, ws).to(dt) @ w.to(dt) + bq.to(dt)
    return qkv, grid


# row 9's padded stages 2-4 of B=8 480 x 640 serving: image (H, W, C)
PADDED_STAGES = {'stage2_padded': (60, 80, 256),
                 'stage3_padded': (30, 40, 512),
                 'stage4_padded': (15, 20, 1024)}


def check_window_attention_qkv(waq, report):
    """Row 9 against its plain version: stage 1 (2400 windows of 64
    tokens, C=128, 4 heads), stages 2, 3 and 4 (the qkv of the B=8 60 x
    80, 30 x 40 and 15 x 20 images padded to 64 x 80, 32 x 40 and 16 x
    24; C=256, 512, 1024; 8, 16, 32 heads: the pad tokens have k = 0),
    all shifted v2, and a shifted v1 stage of 49-token windows (B=2, 120
    x 160 padded to 126 x 161, C=128); bf16 within 2e-2 of max |out|,
    f32 within 1e-4, outputs finite. Times bf16 at stages 1 to 4 against
    the bound and F.scaled_dot_product_attention on q, k, v sliced from
    the same qkv (q and k normalised and the logit scale folded into q
    outside the timed call; the bias plus the shift mask as its float
    mask): SDPA's time leaves out the normalisation. The plain version
    is timed at stage 1."""
    import torch.nn.functional as F
    from nicr_mtsa_tpu_torch.ops.cuda.window_attention import shift_attn_mask
    g = torch.Generator(device='cuda').manual_seed(11)
    rnd = lambda *shape, s=1.0: torch.randn(*shape, device='cuda',
                                            generator=g) * s
    v2w = lambda h: dict(bias=16 * torch.sigmoid(rnd(h, 64, 64)),
                         v2_scale=torch.exp(torch.clamp(
                             np.log(10.0) + rnd(h, s=0.3),
                             max=float(np.log(100.0)))))
    cases = {
        'stage1': dict(v2w(4), qkv=rnd(2400, 64, 384), n_heads=4,
                       grid_hw=(15, 20), shift=(4, 4)),
        'stage2_padded': dict(v2w(8), n_heads=8, shift=(4, 4)),
        'stage3_padded': dict(v2w(16), n_heads=16, shift=(4, 4)),
        'stage4_padded': dict(v2w(32), n_heads=32, shift=(4, 4)),
        'v1_49_tokens': dict(bias=rnd(4, 49, 49, s=0.5), n_heads=4,
                             shift=(3, 3), v2_scale=None),
    }
    errs, max_abs, inputs = {}, 0.0, {}
    for name, c in cases.items():
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = dict(c)
            if name in PADDED_STAGES:
                Hs, Ws, C = PADDED_STAGES[name]
                args['qkv'], args['grid_hw'] = _padded_stage_qkv(
                    g, 8, Hs, Ws, C, 8, 4, dt)
            elif name == 'v1_49_tokens':
                args['qkv'], args['grid_hw'] = _padded_stage_qkv(
                    g, 2, 120, 160, 128, 7, 3, dt)
            else:
                args['qkv'] = args['qkv'].to(dt)
            got = waq.window_attention_qkv(**args)
            torch.cuda.synchronize()
            want = waq.window_attention_qkv_reference(**args)
            if not bool(torch.isfinite(got).all()):
                fail(f'window_attention_qkv {name} {dt}: non-finite output')
            err = float((got.float() - want.float()).abs().max())
            ref = float(want.float().abs().max())
            errs[f'{name}_{str(dt)[6:]}'] = err / ref
            max_abs = max(max_abs, err)
            if not err <= tol * ref:
                fail(f'window_attention_qkv {name} {dt}: max error {err} > '
                     f'{tol} x max |out| {ref}')
            inputs[name, dt] = args
    times = {}
    for name in ('stage1', *PADDED_STAGES):
        args = inputs[name, torch.bfloat16]
        qkv, h = args['qkv'], args['n_heads']
        Bw, N, C3 = qkv.shape
        q, k, v = (t.reshape(Bw, N, h, 32).transpose(1, 2)
                   for t in qkv.split(C3 // 3, dim=-1))
        unit = lambda t: t.float() / t.float().norm(
            dim=-1, keepdim=True).clamp_min(1e-6)
        q = (unit(q) * args['v2_scale'].view(1, h, 1, 1)).to(qkv.dtype)
        k = unit(k).to(qkv.dtype)
        mask = shift_attn_mask(args['grid_hw'], 8, args['shift'], 'cuda')
        nW = mask.shape[0]
        fmask = (args['bias'][None, None] + mask[None, :, None]).expand(
            Bw // nW, -1, -1, -1, -1).reshape(Bw, h, N, N).to(qkv.dtype)
        n_bytes = 4 * qkv.numel() // 3 * 2 + h * N * N * 4 + h * 4
        times[name] = {
            'ms': cuda_ms(lambda: waq.window_attention_qkv(**args)),
            'library_ms': cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=fmask, scale=1.0)),
            'bound': bound(n_bytes, 4 * Bw * h * N * N * 32,
                           PEAK_BF16_FLOPS),
            'shape': list(qkv.shape)}
    t1 = times['stage1']
    t1['plain_ms'] = cuda_ms(lambda: waq.window_attention_qkv_reference(
        **inputs['stage1', torch.bfloat16]))
    report['window_attention_qkv'] = dict(
        name='window_attention_qkv', route='cuda',
        source='nicr_mtsa_tpu_torch/ops/cuda/csrc/window_attention_qkv.cu',
        replaces='nicr_mtsa_tpu/ops/pallas/window_attention.py:392',
        max_abs_err=max_abs, ms=t1['ms'], plain_ms=t1['plain_ms'],
        bound_ms=t1['bound'][0], bound_by=t1['bound'][1],
        library_ms=t1['library_ms'])
    print(json.dumps({'phase': 'kernel', **report['window_attention_qkv'],
                      'shape': t1['shape'], 'rel_err': errs,
                      'stages': {n: times[n] for n in PADDED_STAGES},
                      'library': 'F.scaled_dot_product_attention(scale=1, '
                                 'float mask) on q, k, v sliced from the '
                                 'qkv, q and k normalised beforehand: the '
                                 'normalisation is not in its time'}),
          flush=True)


def frames(B, H=480, W=640, seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    depth = rng.integers(0, 2 ** 14, (B, H, W), dtype=np.uint16)
    depth[:, :16] = 0                         # invalid depth rows
    return rgb, depth


def check_outputs(out, B, H, W, n_classes):
    for k in ('panoptic', 'panoptic_semantic', 'panoptic_instance',
              'semantic_idx'):
        if tuple(out[k].shape) != (B, H, W) or out[k].dtype != torch.int32:
            fail(f'{k}: {tuple(out[k].shape)} {out[k].dtype}')
    if not (0 <= int(out['semantic_idx'].min())
            and int(out['semantic_idx'].max()) < n_classes):
        fail('semantic_idx out of range')
    if not (0 <= int(out['panoptic_instance'].min())
            and int(out['panoptic_instance'].max()) <= 64):
        fail('panoptic_instance out of range')
    if int(out['panoptic_semantic'].max()) > n_classes:
        fail('panoptic_semantic out of range')
    s = out['semantic_score']
    if not (bool(torch.isfinite(s).all()) and float(s.min()) > 0
            and float(s.max()) <= 1.0):
        fail('semantic_score not in (0, 1]')
    if tuple(out['scene_logits'].shape) != (B, 10) or \
            not bool(torch.isfinite(out['scene_logits'].float()).all()):
        fail('scene logits not finite (B, 10)')


def profile(fn, result, key):
    """Device time by kernel over 3 calls of fn (torch.profiler), the
    host wall time of the same calls, and the device's idle share.
    Only device events are summed: the CPU ops' rows repeat the time
    of the kernels they launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof
    n = 3
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    n_cpu_ops = 0
    for e in p.key_averages():
        if e.device_type == DeviceType.CUDA:
            rows.append((e.self_device_time_total / n / 1e3, e.key,
                         e.count / n))
        elif e.key.startswith('aten::'):
            n_cpu_ops += e.count
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    # device time and calls of PROFILED_KERNELS (summed over each one's
    # template instances)
    ported = {piece: {'ms': sum(r[0] for r in rows if piece in r[1]),
                      'calls': sum(r[2] for r in rows if piece in r[1])}
              for piece in PROFILED_KERNELS}
    result[f'profile_{key}'] = {
        'device_busy_ms': busy, 'wall_ms_under_profiler': wall_ms,
        'idle_share': 1.0 - busy / wall_ms, 'kernels': ported,
        'kernel_launches': sum(r[2] for r in rows),
        'aten_op_events_nested': n_cpu_ops / n,
        'top': [{'ms': r[0], 'name': r[1][:160], 'calls': r[2]}
                for r in rows[:40]]}
    print(json.dumps({'phase': f'profile_{key}', 'device_busy_ms': busy,
                      'wall_ms': wall_ms, 'idle_share': 1 - busy / wall_ms,
                      'kernels': ported,
                      'top5': [[round(r[0], 3), r[1][:60]]
                               for r in rows[:5]]}), flush=True)


def _segment_matches(pa, pb, M: int):
    """Of one image's two flat panoptic maps: the segment ids of each
    (ua, ub), each pixel's segment index (ia, ib), the segment areas
    (area_a, area_b), and the (len(ua), len(ub)) matrix of the segments
    matched by PQ's rule: same class and IoU > 0.5 (a match is then
    unique), void (0) never matched."""
    ua, ia = torch.unique(pa, return_inverse=True)
    ub, ib = torch.unique(pb, return_inverse=True)
    area_a = torch.bincount(ia, minlength=len(ua))
    area_b = torch.bincount(ib, minlength=len(ub))
    inter = torch.bincount(ia * len(ub) + ib, minlength=len(ua) * len(ub)
                           ).view(len(ua), len(ub))
    union = area_a[:, None] + area_b[None, :] - inter
    match = ((ua[:, None] // M == ub[None, :] // M) & (ua != 0)[:, None]
             & (ub != 0)[None, :] & (2 * inter > union))
    return ua, ub, ia, ib, area_a, area_b, match


def panoptic_matched_share(a, b, M: int = PANOPTIC_ID_CLASS):
    """The share of the segment pixels of two (B, H, W) panoptic maps
    (ids class * M + k, 0 void; both maps' pixels counted) that lie in
    segments matched between the maps: same class and IoU > 0.5, the
    rule by which PQ matches segments (a match is then unique). Any
    renumbering of a class's segments leaves it unchanged."""
    matched = total = 0
    for pa, pb in zip(a.reshape(len(a), -1).long(),
                      b.reshape(len(b), -1).long()):
        ua, ub, _, _, area_a, area_b, match = _segment_matches(pa, pb, M)
        matched += int(area_a[match.any(1)].sum() + area_b[match.any(0)].sum())
        total += int(area_a[ua != 0].sum() + area_b[ub != 0].sum())
    return matched / max(total, 1)


def panoptic_border_agreement(a, b, M: int = PANOPTIC_ID_CLASS):
    """The pixel agreement of the matched segments of two (B, H, W)
    panoptic maps: each segment of `a` matched by
    `panoptic_matched_share`'s rule is mapped to its segment of `b`;
    over the pixels that lie in a matched segment in either map, the
    share where `a`'s mapped segment is `b`'s segment. A border moved by
    a few pixels lowers it, where the matched share would not move;
    renumbering does not."""
    agree = total = 0
    for pa, pb in zip(a.reshape(len(a), -1).long(),
                      b.reshape(len(b), -1).long()):
        ua, _, ia, ib, _, _, match = _segment_matches(pa, pb, M)
        partner = torch.full((len(ua),), -1, dtype=torch.long)
        rows, cols = match.nonzero(as_tuple=True)
        partner[rows] = cols
        counted = match.any(1)[ia] | match.any(0)[ib]
        agree += int((partner[ia] == ib).sum())
        total += int(counted.sum())
    return agree / max(total, 1)


def planted_panoptic_faults(pan, M: int = PANOPTIC_ID_CLASS):
    """{name: a faulty copy of the (B, H, W) panoptic map, or None where
    the frame gives the fault nothing to act on}:
    - 'class_swapped': in each image the largest segment takes the next
      class id (a wrong majority class in the merge);
    - 'instances_merged': in each image, of the classes with two or more
      instances, the two largest instances of the one whose second is
      largest are merged (two instances taken for one)."""
    swapped, merged, any_pair = pan.clone(), pan.clone(), False
    for img_s, img_m in zip(swapped, merged):
        ids, area = torch.unique(img_s, return_counts=True)
        segs = sorted(((int(n), int(i)) for i, n in zip(ids, area) if i),
                      reverse=True)
        if segs:
            big = segs[0][1]
            img_s[img_s == big] = (big // M % 40 + 1) * M + big % M
        pairs = {}
        for n, i in segs:
            if i % M:                           # a thing instance
                pairs.setdefault(i // M, []).append((n, i))
        pairs = [v[:2] for v in pairs.values() if len(v) > 1]
        if pairs:
            (_, keep), (_, gone) = max(pairs, key=lambda v: v[1][0])
            img_m[img_m == gone] = keep
            any_pair = True
    return {'class_swapped': swapped,
            'instances_merged': merged if any_pair else None}


def _capture_centres(pipe, into: dict):
    """Record the instance centre table (centres_yx, valid) of each call
    of `pipe` into `into` (a hook on its postprocessing)."""
    postprocess = pipe.post.postprocess

    def hooked(*args, **kwargs):
        r_dict = postprocess(*args, **kwargs)
        meta = r_dict['panoptic_segmentation_deeplab_instance_meta']
        into['yx'], into['valid'] = meta['centers_yx'], meta['valid']
        return r_dict

    pipe.post.postprocess = hooked


def _centre_lists(table):
    """Per image, the valid centres' (y, x) in table order."""
    return [[tuple(int(v) for v in yx) for yx, ok in zip(img, val) if ok]
            for img, val in zip(table['yx'].cpu(), table['valid'].cpu())]


def _normal_agreement(a, b):
    """Share of pixels whose unit normals (B, 3, H, W) lie within
    NORMAL_CPU_DIST of each other, and the largest difference."""
    d = torch.linalg.vector_norm(a.float() - b.float(), dim=1)
    return (float((d <= NORMAL_CPU_DIST).float().mean()),
            float((a.float() - b.float()).abs().max()))


def card_vs_cpu(result, cfg, key, frame_seed, extra_output_tasks=(),
                prepare=None):
    """The f32 serving pipeline of `cfg` on one frame, on the card and
    on the CPU, with the same weights (the same seed builds the same
    model on both): semantic_idx must agree on >= 99.9 % of pixels, and
    the panoptic segments match (`panoptic_matched_share` >=
    PANOPTIC_MATCH_MIN) with their borders in place
    (`panoptic_border_agreement` >= PANOPTIC_BORDER_MIN), while each
    planted panoptic fault must fall below its gate. First prints
    whether the centre tables agree as ordered lists or only as sets.
    With 'normal' among `extra_output_tasks`, the normals must agree on
    NORMAL_AGREE_MIN of the pixels (`_normal_agreement`), and the card's
    with one image's normals negated must not. `prepare` (if any) takes
    each pipeline before its run (phase 39 grafts its backbones)."""
    from nicr_mtsa_tpu_torch.pipeline import build_serving_pipeline
    rgb, depth = frames(1, seed=frame_seed)
    outs, centres = {}, {}
    for dev in ('cuda', 'cpu'):
        pipe = build_serving_pipeline(cfg, device=dev, seed=0,
                                      extra_output_tasks=extra_output_tasks)
        if prepare is not None:
            prepare(pipe)
        centres[dev] = {}
        _capture_centres(pipe, centres[dev])
        outs[dev] = {k: v.cpu() for k, v in pipe(rgb, depth).items()}
        del pipe
    lists = {dev: _centre_lists(t) for dev, t in centres.items()}
    order = {'ordered_equal': lists['cuda'] == lists['cpu'],
             'set_equal': all(set(a) == set(b) for a, b in
                              zip(lists['cuda'], lists['cpu'])),
             'n_valid': {dev: [len(v) for v in li]
                         for dev, li in lists.items()}}
    print(json.dumps({'phase': f'{key}_centres', **order}), flush=True)
    check_outputs(outs['cuda'], 1, 480, 640, 40)
    agree = {k: float((outs['cuda'][k] == outs['cpu'][k]).float().mean())
             for k in ('semantic_idx', 'panoptic', 'panoptic_semantic',
                       'panoptic_instance')}
    # panoptic ids number the instances of a class in instance-id order:
    # one instance more or less on one side renumbers the class's later
    # instances, which the per-side instance counts show
    n_instances = {dev: [len(torch.unique(o['panoptic_instance'][b]))
                         for b in range(len(o['panoptic_instance']))]
                   for dev, o in outs.items()}
    scene_err = float((outs['cuda']['scene_logits']
                       - outs['cpu']['scene_logits']).abs().max())
    pan_card, pan_cpu = outs['cuda']['panoptic'], outs['cpu']['panoptic']
    matched = panoptic_matched_share(pan_card, pan_cpu)
    border = panoptic_border_agreement(pan_card, pan_cpu)
    faults = {name: None if bad is None else
              panoptic_matched_share(bad, pan_cpu) for name, bad in
              planted_panoptic_faults(pan_card).items()}
    rolled = torch.roll(pan_card, BORDER_ROLL, dims=2)
    roll = {'matched_share': panoptic_matched_share(rolled, pan_cpu),
            'border_agreement': panoptic_border_agreement(rolled, pan_cpu)}
    n_segments = {dev: [len(torch.unique(p)) for p in o['panoptic']]
                  for dev, o in outs.items()}
    border_min = PANOPTIC_BORDER_MIN.get(key, PANOPTIC_MATCH_MIN)
    normal = None
    if 'normal' in extra_output_tasks:
        n_card, n_cpu = (outs[d]['normal_output'] for d in ('cuda', 'cpu'))
        planted = n_card.clone()
        planted[0] = -planted[0]
        normal = dict(zip(('agreement', 'max_abs'),
                          _normal_agreement(n_card, n_cpu)),
                      planted_negated=_normal_agreement(planted, n_cpu)[0])
    result[key] = dict(agreement=agree, scene_max_abs=scene_err,
                       normal=normal,
                       n_instance_ids=n_instances,
                       panoptic_matched_share=matched,
                       panoptic_border_agreement=border,
                       panoptic_border_min=border_min,
                       panoptic_faults_matched_share=faults,
                       panoptic_roll=roll, centres=order,
                       n_panoptic_ids=n_segments)
    print(json.dumps({'phase': key, 'agreement': agree,
                      'n_instance_ids': n_instances,
                      'panoptic_matched_share': matched,
                      'panoptic_border_agreement': border,
                      'panoptic_border_min': border_min,
                      'panoptic_faults_matched_share': faults,
                      'panoptic_roll': roll,
                      'n_panoptic_ids': n_segments,
                      'scene_max_abs': scene_err, 'normal': normal}),
          flush=True)
    if normal is not None and not (
            normal['agreement'] >= NORMAL_AGREE_MIN
            > normal['planted_negated']):
        fail(f'{key}: normals agree on {normal["agreement"]} of the '
             f'pixels, the planted negation on '
             f'{normal["planted_negated"]}; the gate is {NORMAL_AGREE_MIN}')
    if agree['semantic_idx'] < 0.999:
        fail(f"{key}: semantic_idx agreement {agree['semantic_idx']}")
    if matched < PANOPTIC_MATCH_MIN:
        fail(f'{key}: panoptic matched share {matched} < '
             f'{PANOPTIC_MATCH_MIN}')
    if border < border_min:
        fail(f'{key}: panoptic border agreement {border} < {border_min}')
    for name, share in faults.items():
        if share is not None and share >= PANOPTIC_MATCH_MIN:
            fail(f'{key}: the planted panoptic fault {name} passed the '
                 f'gate (matched share {share})')
    if roll['border_agreement'] >= border_min:
        fail(f"{key}: the planted {BORDER_ROLL}-pixel roll passed the "
             f"border gate ({roll['border_agreement']})")


def serve_exact(cfg, n_requests, want, kernels, card, result, key,
                profile_it=False, B=8, targets=None, reference_of=None,
                keep_reference=False, extra_output_tasks=(),
                check_out=None, prepare=None):
    """Serving of `cfg` at B on frames of its input size: a warm-up
    request (the kernels' inputs captured by `targets`), then three
    timed rounds of `n_requests` requests with the counters set to 0
    just before; each wrapper must have launched exactly its `want`
    count a request (others none); frames/s is the median round, peak
    memory from before the warm-up. With `reference_of`, one more request
    under deterministic cuDNN must give `reference_of`'s outputs bit for
    bit; with `keep_reference`, that request's outputs are returned for
    such a comparison. `extra_output_tasks` go to the pipeline, and
    `check_out` (if any) checks the last request's outputs; `prepare`
    (if any) takes the pipeline before the warm-up. Returns (the
    launches of `want`, the captured calls, those outputs or None)."""
    from nicr_mtsa_tpu_torch.pipeline import build_serving_pipeline
    H, W = cfg.input_size
    pipe = build_serving_pipeline(cfg, device='cuda', seed=0,
                                  extra_output_tasks=extra_output_tasks)
    if prepare is not None:
        prepare(pipe)
    rgb, depth = (torch.from_numpy(a).cuda() for a in frames(B, H, W))
    _fresh()
    with _capture(targets or {}) as calls:
        out = pipe(rgb, depth)
    torch.cuda.synchronize()
    check_outputs(out, B, H, W, 40)

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_requests):
            out = pipe(rgb, depth)
        int(out['panoptic'][0, 0, 0])
        rounds.append(B * n_requests / (time.perf_counter() - t0))
    n = 3 * n_requests
    launches = _check_launches(kernels, want, n, key)
    check_outputs(out, B, H, W, 40)
    if check_out is not None:
        check_out(out)
    fps = float(np.median(rounds))
    peak = _peak_gb()
    ref = bit_equal = None
    if reference_of is not None or keep_reference:
        with _deterministic():
            ref = {k: v.clone() for k, v in pipe(rgb, depth).items()}
    if reference_of is not None:
        bit_equal = {k: bool(torch.equal(ref[k], reference_of[k]))
                     for k in reference_of}
        if not all(bit_equal.values()):
            fail(f'{key}: outputs {[k for k, v in bit_equal.items() if not v]}'
                 f' differ from the reference run')
        ref = None
    result[key] = dict(
        batch=B, requests_per_round=n_requests,
        rounds_frames_per_s=rounds, frames_per_s=fps, card=card,
        launches_per_request={k: c / n for k, c in launches.items() if c},
        peak_mem_gb=peak, bit_equal_to_reference=bit_equal,
        n_instances=[int(v) for v in out['panoptic_instance'].amax(
            dim=(1, 2))])
    print(json.dumps({'phase': key, 'frames_per_s': fps,
                      'rounds_frames_per_s': rounds, 'batch': B,
                      'requests': n, 'launches_per_request':
                          result[key]['launches_per_request'],
                      'peak_mem_gb': peak,
                      'bit_equal_to_reference': bit_equal,
                      'card': card}), flush=True)
    if profile_it:
        profile(lambda: pipe(rgb, depth), result, key)
    return {k: launches[k] for k in want}, calls, ref


def train(args, kernels, card, result, key, cfg=None, want=TRAIN_KERNELS,
          B=8, steps=None, batch=None, targets=None, profile_it=True):
    """Training of `cfg` (default `emsaformer_dve_v2`'s) at B, 480 x 640,
    bf16, on `batch` (default the synthetic training batch): a first step
    (`_first_step`, the kernels' inputs captured by `targets`), then
    three timed rounds of `steps` steps (default `args.train_steps`),
    each round ending in a sync on the total loss, the counters set to 0
    just before; each wrapper must make exactly its `want` launches a
    step (others none), every loss be finite and the last step's total
    loss below the first's. frames/s is the median round, peak memory
    from before the first step. With `args.profile` and `profile_it`, 3
    steps are traced. Returns (the launches of `want`, the first step's
    record, the captured calls)."""
    from nicr_mtsa_tpu_torch.testing import build_train_batch
    steps = steps or args.train_steps
    if batch is None:
        batch = build_train_batch(
            B, 480, 640, seed=0, device='cuda',
            rgbd=cfg is None or cfg.backbone_rgbd is not None)
    _fresh()
    with _capture(targets or {}) as calls:
        pipe, state, gen, first = _first_step(cfg, batch)
    history = [torch.tensor(list(first['losses'].values()), device='cuda')]

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps):
            state, losses = pipe.train_step(state, batch, gen)
            history.append(torch.stack(list(losses.values())).float())
        float(losses['total_loss'])
        rounds.append(B * steps / (time.perf_counter() - t0))
    n = 3 * steps
    launches = _check_launches(kernels, want, n, key)
    history = torch.stack(history).cpu()
    if not bool(torch.isfinite(history).all()):
        fail(f'{key}: a loss is not finite')
    first_loss = first['losses']['total_loss']
    last = float(losses['total_loss'])
    if not last < first_loss:
        fail(f'{key}: total loss {last} at the last step is not below '
             f'{first_loss} at the first')
    fps = float(np.median(rounds))
    result[key] = dict(
        batch=B, steps_per_round=steps,
        rounds_frames_per_s=rounds, frames_per_s=fps, card=card,
        launches_per_step={k: c / n for k, c in launches.items() if c},
        first_total_loss=first_loss, last_total_loss=last,
        total_loss_per_step=[float(v) for v in history[:, -1]],
        losses={k: float(v) for k, v in losses.items()},
        peak_mem_gb=_peak_gb())
    print(json.dumps({'phase': key, 'frames_per_s': fps,
                      'rounds_frames_per_s': rounds, 'batch': B,
                      'steps': n, 'launches_per_step':
                          result[key]['launches_per_step'],
                      'first_total_loss': first_loss, 'last_total_loss': last,
                      'peak_mem_gb': result[key]['peak_mem_gb'],
                      'card': card}), flush=True)
    if args.profile and profile_it:
        profile(lambda: pipe.train_step(state, batch, gen), result, key)
    return {k: launches[k] for k in want}, first, calls


@contextlib.contextmanager
def _planted_fault(fault, pipe):
    """`fault` (None or one of TRAIN_FAULTS, EMSANET_TRAIN_FAULTS)
    planted for one step of `pipe`: row 7's dbias, the gradients of the
    decoders' learned-upsampling weights, or the instance losses,
    scaled by 1 + TRAIN_FAULT_SIZE."""
    from nicr_mtsa_tpu_torch.ops.cuda import window_attention_core as wac
    scale = 1.0 + TRAIN_FAULT_SIZE
    core = wac._WindowAttentionCore
    backward, compute_losses = core.backward, pipe.compute_losses
    hooks = []
    if fault == 'core_dbias':
        def faulty(ctx, dout):
            dq, dk, dv, dbias, *rest = backward(ctx, dout)
            return (dq, dk, dv, dbias * scale, *rest)
        core.backward = staticmethod(faulty)
    elif fault == 'upsampling_weight_grad':
        # each ladder step's and each task head's upsampling weight
        hooks = [p.register_hook(lambda g: g * scale)
                 for n, p in pipe.model.named_parameters()
                 if n.startswith(('semantic_decoder.', 'instance_decoder.',
                                  'normal_decoder.'))
                 and '.upsample' in n and n.endswith('.weight')]
    elif fault in ('instance_losses', 'normal_losses'):
        prefix = fault.split('_')[0] + '_'
        pipe.compute_losses = lambda b, p: {
            k: v * scale if k.startswith(prefix) else v
            for k, v in compute_losses(b, p).items()}
    try:
        yield
    finally:
        core.backward = staticmethod(backward)
        pipe.compute_losses = compute_losses
        for h in hooks:
            h.remove()


def _train_step_result(cfg, hw, batch, dev, order=None, fault=None):
    """(losses, gradients, BatchNorm statistics, seconds) of one
    training step in `cfg`'s dtype (f32, or float64 with the model in
    float64) with drop rates 0 on `dev` from seed 0's weights and batch
    seed 2; on the CPU in summation `order` (None or one of
    TRAIN_CPU_ORDERS), on the card with `fault` planted."""
    from nicr_mtsa_tpu_torch.models.common import Dropout
    from nicr_mtsa_tpu_torch.pipeline import (MultiTaskPipeline,
                                              build_train_pipeline)
    from nicr_mtsa_tpu_torch.testing import build_train_batch
    pipe = build_train_pipeline(cfg, device=dev, seed=0)
    if order == 'channels_last':
        pipe = MultiTaskPipeline(pipe.model, pipe.postprocessors,
                                 pipe.task_helpers, cfg.torch_dtype,
                                 channels_last=True)
    for m in pipe.model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    if cfg.dtype == 'float64':
        pipe.model.double()         # parameters and statistics too
    with torch.no_grad():
        pipe.model.instance_decoder.task_head.conv_orientation.bias.copy_(
            torch.tensor(TRAIN_CPU_ORIENTATION_BIAS))
    normal = 'normal' in cfg.tasks
    batch_t = build_train_batch(
        batch, *hw, seed=2, device=dev, rgbd=cfg.backbone_rgbd is not None,
        normals=normal, downscales=NORMAL_DOWNSCALES if normal else ())
    state = pipe.create_train_state()
    t0 = time.perf_counter()
    with torch.backends.mkldnn.flags(enabled=order != 'no_mkldnn'), \
            _planted_fault(fault, pipe):
        state, losses = pipe.train_step(state, batch_t,
                                        torch.Generator(device=dev))
        losses = {k: float(v) for k, v in losses.items()}
    return (losses, {n: (torch.zeros_like(p) if p.grad is None
                         else p.grad).cpu()
                     for n, p in state['params'].items()},
            {n: b.cpu() for n, b in state['batch_stats'].items()},
            time.perf_counter() - t0)


def train_card_vs_cpu(result, hw=TRAIN_CPU_HW, batch=TRAIN_CPU_BATCH,
                      cfg=None, faults=TRAIN_FAULTS,
                      key='train_card_vs_cpu', f32_cfg=None,
                      grad_floor=1e-5):
    """One training step of `cfg` (default `emsaformer_dve_v2`'s, f32)
    with drop rates 0 on the card and on the CPU (`batch` at `hw`; the
    same seed builds the same weights and batch): losses within rtol
    1e-5, BatchNorm statistics within 1e-5, and each gradient within its
    limit of its tensor's max |grad| (of `grad_floor` x the step's
    largest, for a tensor whose exact gradient is 0): TRAIN_GRAD_TOL, or
    TRAIN_SPREAD_FACTOR times the spread of the same step on the CPU in
    its other summation orders, taken in this run, where that is more.
    Controls: the card's step again with each of `faults` planted must
    fail the same check, in every tensor the fault moves whose limit
    lies below a quarter of the fault. With `f32_cfg` (where `cfg` is a
    float64 step) it also reports, ungated, how far the f32 step's
    losses lie apart card vs CPU and between two CPU orders."""
    from nicr_mtsa_tpu_torch.pipeline import emsaformer_train_config
    if cfg is None:
        cfg = emsaformer_train_config(hw, 'float32', stochastic_depth=0.0,
                                      decoder_dropout=0.0)
    l_card, g_card, s_card, t_card = _train_step_result(cfg, hw, batch,
                                                        'cuda')
    faulty = {f: _train_step_result(cfg, hw, batch, 'cuda', fault=f)[1]
              for f in faults}
    l_cpu, g_cpu, s_cpu, t_cpu = _train_step_result(cfg, hw, batch, 'cpu')
    seconds = {'cuda': t_card, 'cpu': t_cpu}
    g_orders = {}
    for order in TRAIN_CPU_ORDERS:
        _, g_orders[order], _, seconds[f'cpu_{order}'] = _train_step_result(
            cfg, hw, batch, 'cpu', order)
    def rel(a, b):
        return max(abs(a[k] - v) / max(abs(v), 1e-30) for k, v in b.items())

    loss_err = rel(l_card, l_cpu)
    f32 = {}
    if f32_cfg is not None:
        l32 = {dev: _train_step_result(f32_cfg, hw, batch, dev)[0]
               for dev in ('cuda', 'cpu')}
        l32_cl = _train_step_result(f32_cfg, hw, batch, 'cpu',
                                    'channels_last')[0]
        f32 = {'f32_loss_rel_err': rel(l32['cuda'], l32['cpu']),
               'f32_cpu_loss_spread': rel(l32_cl, l32['cpu'])}
    if not loss_err <= 1e-5:
        fail(f'{key}: losses differ by rtol {loss_err}')
    largest = max(float(g.abs().max()) for g in g_cpu.values())
    den = {n: max(float(g.abs().max()), grad_floor * largest)
           for n, g in g_cpu.items()}

    def errs(grads):
        return {n: float((grads[n] - g).abs().max()) / den[n]
                for n, g in g_cpu.items()}
    order_errs = [errs(g) for g in g_orders.values()]
    spread = {n: max(e[n] for e in order_errs) for n in g_cpu}
    limit = {n: max(TRAIN_GRAD_TOL, TRAIN_SPREAD_FACTOR * spread[n])
             for n in g_cpu}
    grad_err = errs(g_card)
    ratio = {n: grad_err[n] / limit[n] for n in g_cpu}
    worst = max(ratio, key=ratio.get)
    table = sorted(((ratio[n], grad_err[n], limit[n], spread[n],
                     float(g_cpu[n].abs().max()), n) for n in g_cpu),
                   reverse=True)
    controls = {}
    for fault, grads in faulty.items():
        e = errs(grads)
        # the tensors of the fault's group it moves by at least half its
        # size (not those whose exact gradient is 0); where the limit
        # is under a quarter of it, the check cannot miss the fault
        group = [n for n in g_cpu if faults[fault] in n]
        moved = [n for n in group if float((grads[n] - g_card[n]).abs()
                                           .max()) / den[n]
                 >= TRAIN_FAULT_SIZE / 2]
        controls[fault] = dict(
            n_group=len(group), n_moved=len(moved),
            n_flagged=sum(e[n] > limit[n] for n in moved),
            missed=[n for n in moved if limit[n] < TRAIN_FAULT_SIZE / 4
                    and not e[n] > limit[n]],
            hidden=[n for n in moved if limit[n] >= TRAIN_FAULT_SIZE])
    print(json.dumps({'phase': f'{key}_grads',
                      'largest_grad': largest,
                      'worst': [list(r) for r in table[:12]],
                      'n_limit_above_tol': sum(
                          v > TRAIN_GRAD_TOL for v in limit.values()),
                      'max_limit': max(limit.values()),
                      'controls': controls,
                      'seconds': seconds}), flush=True)
    if not ratio[worst] <= 1.0:
        fail(f'{key}: gradient of {worst} differs by '
             f'{grad_err[worst]} of its max, above its limit {limit[worst]}')
    for fault, c in controls.items():
        if c['missed'] or not c['n_flagged']:
            fail(f'{key}: a planted {TRAIN_FAULT_SIZE} fault in '
                 f'{fault} passed the gradient check of {c["missed"]}')
    stat_err = max(float((s_card[n] - b).abs().max() / (1 + b.abs().max()))
                   for n, b in s_cpu.items() if b.is_floating_point())
    if not stat_err <= 1e-5:
        fail(f'{key}: BatchNorm statistics differ by {stat_err}')
    result[key] = dict(
        size=list(hw), batch=batch, dtype=cfg.dtype, loss_rel_err=loss_err,
        **f32,
        worst_grad=worst, worst_grad_rel_err=grad_err[worst],
        worst_grad_limit=limit[worst], bn_stat_err=stat_err,
        step_seconds=seconds, controls=controls,
        grads=[dict(zip(('err_over_limit', 'err', 'limit', 'cpu_spread',
                         'max_abs_grad', 'name'), r)) for r in table])
    print(json.dumps({'phase': key, 'size': list(hw),
                      'batch': batch, 'dtype': cfg.dtype,
                      'loss_rel_err': loss_err, **f32,
                      'worst_grad': worst,
                      'worst_grad_rel_err': grad_err[worst],
                      'worst_grad_limit': limit[worst],
                      'bn_stat_err': stat_err, 'step_seconds': seconds}),
          flush=True)


EVAL_LOG_KEYS = ('semantic_miou', 'panoptic_deeplab_semantic_miou',
                 'panoptic_all_deeplab_pq', 'instance_all_deeplab_pq',
                 'scene_acc')
IS_THING = tuple(i < 8 for i in range(40))


@contextlib.contextmanager
def _captured_slot_maps():
    """Within: the (gt slots, pred slots, n_gt, n_pred) of each call of
    the PQ metrics' intersection matrix (copies), in a list."""
    from nicr_mtsa_tpu_torch.metrics import pq
    inner, maps = pq.intersection_matrix, []

    def hooked(gt_slots, pred_slots, n_gt, n_pred):
        B = gt_slots.shape[0]
        maps.append((gt_slots.reshape(B, -1).clone(),
                     pred_slots.reshape(B, -1).clone(), n_gt, n_pred))
        return inner(gt_slots, pred_slots, n_gt, n_pred)

    pq.intersection_matrix = hooked
    try:
        yield maps
    finally:
        pq.intersection_matrix = inner


def evaluate(args, kernels, card, result):
    """The fused eval step at B=8: one warm-up step (the slot maps it
    passes row 11 captured), then three timed rounds of N steps carrying
    the metric states, each round ending in a device sync on a state
    scalar; frames/s is the median round. Returns the launches, the
    pipeline and the captured maps."""
    from nicr_mtsa_tpu_torch.pipeline import build_eval_pipeline
    from nicr_mtsa_tpu_torch.testing import build_eval_batch
    B = 8
    pipe = build_eval_pipeline(device='cuda', seed=0)
    eb = build_eval_batch(B, (480, 640), (512, 512), 40, IS_THING, seed=0,
                          segment_table_size=128, device='cuda')
    if eb.segment_table_overflow:
        fail(f'eval batch: {eb.segment_table_overflow} GT segments did '
             f'not fit into the segment tables')
    step = pipe.make_fused_eval_step(eb.static_batch)
    with _captured_slot_maps() as maps:
        _, losses, states = step(eb.batch, pipe.empty_metric_states())
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            _, losses, states = step(eb.batch, states)
        int(states['semantic'][0, 0])
        rounds.append(B * args.steps / (time.perf_counter() - t0))
    n_steps = 3 * args.steps
    launches = {n: fn.launches for n, fn in kernels.KERNELS.items()}
    for n, per_step in EVAL_KERNELS.items():
        if launches[n] != per_step * n_steps:
            fail(f'kernel {n}: {launches[n]} launches in {n_steps} eval '
                 f'steps, expected {per_step} in every step')
    bad = [k for k, v in losses.items() if not bool(torch.isfinite(v))]
    if bad:
        fail(f'eval losses not finite: {bad}')
    pipe.load_metric_states(states)
    _, _, logs = pipe.validation_epoch_end()
    metrics = {k: float(logs[k]) for k in EVAL_LOG_KEYS}
    for k, v in metrics.items():
        if not (np.isfinite(v) and 0.0 <= v <= 1.0):
            fail(f'eval metric {k} = {v} not in [0, 1]')
    fps = float(np.median(rounds))
    result['eval'] = dict(
        batch=B, steps_per_round=args.steps, rounds_frames_per_s=rounds,
        frames_per_s=fps, card=card,
        launches_per_step={n: c / n_steps for n, c in launches.items()},
        metrics=metrics, losses={k: float(v) for k, v in losses.items()},
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(json.dumps({'phase': 'eval', 'frames_per_s': fps,
                      'rounds_frames_per_s': rounds, 'batch': B,
                      'steps': n_steps,
                      'launches_per_step': result['eval'][
                          'launches_per_step'],
                      'metrics': metrics, 'card': card}), flush=True)
    if args.profile:
        profile(lambda: step(eb.batch, states), result, 'eval')
    return launches, pipe, maps


def _states_equal(card, cpu, name='', angle_atol=0.0):
    """None where the metric states `card` equal `cpu`, else where and
    how they first differ: integer states (and the f32 TP/FN/FP counts)
    exactly, the f32 IoU, angular-error and RMSE sums within rtol 1e-5.
    With
    `angle_atol` an angular-error sum may also differ by that many rad a
    counted angle (its state's `n_elements`)."""
    n = cpu.get('n_elements')
    atol = 0.0 if n is None else angle_atol * int(n)
    for k in card:
        where = f'{name}/{k}'
        if isinstance(card[k], dict):
            diff = _states_equal(card[k], cpu[k], where, angle_atol)
        else:
            diff = _state_difference(card[k].cpu(), cpu[k].cpu(), where,
                                     atol)
        if diff:
            return diff
    return None


def _state_difference(a, b, name, angle_atol):
    """One state tensor by `_states_equal`'s rule (`angle_atol` in rad,
    for an angular-error sum)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return f'{name}: {a.dtype} {tuple(a.shape)} against ' \
               f'{b.dtype} {tuple(b.shape)}'
    if name.endswith(('iou_per_class', 'sum_angular_error', 'sum_rmse')):
        atol = angle_atol if name.endswith('sum_angular_error') else 0.0
        if not torch.allclose(a, b, rtol=1e-5, atol=atol):
            return f'{name}: {a} against {b}'
    elif not torch.equal(a, b):
        return f'{name}: differs'
    return None


def _to_cpu(t):
    if isinstance(t, torch.Tensor):
        return t.cpu()
    if isinstance(t, (tuple, list)):
        return type(t)(_to_cpu(v) for v in t)
    return t


def eval_card_vs_cpu(pipe, result, key='eval_card_vs_cpu',
                     normals=False):
    """The card's raw eval outputs (bf16, B=2), postprocessed with
    their metric states updated on the card and, copied, on the CPU;
    with `normals`, on a batch with normal targets."""
    from nicr_mtsa_tpu_torch.testing import build_eval_batch
    eb = build_eval_batch(2, (480, 640), (512, 512), 40, IS_THING, seed=1,
                          device='cuda', normals=normals)
    batch = dict(eb.batch, **eb.static_batch)
    with torch.inference_mode():
        raw = pipe.model(pipe.model_inputs(batch))
        _, _, on_card = pipe.evaluate_outputs(raw, batch,
                                              pipe.empty_metric_states())
        raw_cpu = {k: _to_cpu(v) for k, v in raw.items()}
        batch_cpu = {k: _to_cpu(v) for k, v in batch.items()}
        _, _, on_cpu = pipe.evaluate_outputs(
            raw_cpu, batch_cpu, pipe.empty_metric_states('cpu'))
    diff = _states_equal(on_card, on_cpu)
    if diff:
        fail(f'{key}: {diff}')
    counts = {'semantic_pixels': int(on_cpu['semantic'].sum()),
              'panoptic_tp': float(on_cpu['panoptic']['pq'][
                  'tp_per_class'].sum()),
              'instance_tp': float(on_cpu['instance']['pq'][
                  'tp_per_class'].sum())}
    if normals:
        counts['normal_pixels'] = int(on_cpu['normal']['n_elements'])
    result[key] = dict(states='equal', **counts)
    print(json.dumps({'phase': key, 'states': 'equal', **counts}),
          flush=True)


SWIN_EVAL_LOG_KEYS = EVAL_LOG_KEYS + ('dense_visual_embedding_text_miou',
                                      'dense_visual_embedding_visual_mean_miou')
DVE = 'dense_visual_embedding'
DVE_PREFIXES = {'text_cm': f'{DVE}_text_based_semantic',
                'visual_mean_cm': f'{DVE}_visual_mean_based_semantic'}


def _swin_eval_pipeline(dtype='bfloat16'):
    """`bench.py --eval --model emsaformer_dve_v2`'s pipeline on the card
    (random weights from seed 0), with the bench's class tables."""
    from nicr_mtsa_tpu_torch.pipeline import (build_eval_pipeline,
                                              emsaformer_eval_config)
    from nicr_mtsa_tpu_torch.testing import dve_tables
    _, text, visual_mean = dve_tables(40, 512)
    return build_eval_pipeline(emsaformer_eval_config(dtype=dtype),
                               device='cuda', seed=0,
                               dve_tables=(text, visual_mean))


def _swin_eval_batch(B, seed):
    from nicr_mtsa_tpu_torch.testing import build_eval_batch
    eb = build_eval_batch(B, (480, 640), (512, 512), 40, IS_THING,
                          seed=seed, segment_table_size=128, device='cuda',
                          dve_dim=512)
    if eb.segment_table_overflow:
        fail(f'Swin eval batch: {eb.segment_table_overflow} GT segments '
             f'did not fit into the segment tables')
    return eb


def evaluate_swin(args, kernels, card, result):
    """The fused Swin/DVE eval step at B=8, bf16: one warm-up step, then
    three timed rounds of N steps carrying the metric states, each round
    ending in a device sync on a state scalar, the counters set to 0
    just before; each wrapper must launch exactly its SWIN_EVAL_KERNELS
    count a step (others none), every loss be finite (the DVE loss in
    [0, 2]) and every epoch metric in [0, 1]."""
    B = 8
    pipe = _swin_eval_pipeline()
    eb = _swin_eval_batch(B, seed=0)
    step = pipe.make_fused_eval_step(eb.static_batch)
    torch.cuda.reset_peak_memory_stats()
    _, losses, states = step(eb.batch, pipe.empty_metric_states())
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(args.swin_steps):
            _, losses, states = step(eb.batch, states)
        int(states['semantic'][0, 0])
        rounds.append(B * args.swin_steps / (time.perf_counter() - t0))
    n_steps = 3 * args.swin_steps
    launches = {n: fn.launches for n, fn in kernels.KERNELS.items()}
    for n, c in launches.items():
        if c != SWIN_EVAL_KERNELS.get(n, 0) * n_steps:
            fail(f'eval_swin: kernel {n}: {c} launches in {n_steps} steps, '
                 f'expected {SWIN_EVAL_KERNELS.get(n, 0)} a step')
    bad = [k for k, v in losses.items() if not bool(torch.isfinite(v))]
    if bad:
        fail(f'eval_swin: losses not finite: {bad}')
    dve_loss = float(losses[f'{DVE}_loss_main'])
    if not 0.0 <= dve_loss <= 2.0:
        fail(f'eval_swin: {DVE}_loss_main = {dve_loss} not in [0, 2]')
    pipe.load_metric_states(states)
    _, _, logs = pipe.validation_epoch_end()
    missing = [k for k in SWIN_EVAL_LOG_KEYS if k not in logs]
    if missing:
        fail(f'eval_swin: epoch metrics missing: {missing}')
    metrics = {k: float(logs[k]) for k in SWIN_EVAL_LOG_KEYS}
    for k, v in metrics.items():
        if not (np.isfinite(v) and 0.0 <= v <= 1.0):
            fail(f'eval_swin: metric {k} = {v} not in [0, 1]')
    fps = float(np.median(rounds))
    result['eval_swin'] = dict(
        batch=B, steps_per_round=args.swin_steps, rounds_frames_per_s=rounds,
        frames_per_s=fps, card=card,
        launches_per_step={n: c / n_steps for n, c in launches.items()},
        metrics=metrics, losses={k: float(v) for k, v in losses.items()},
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(json.dumps({'phase': 'eval_swin', 'frames_per_s': fps,
                      'rounds_frames_per_s': rounds, 'batch': B,
                      'steps': n_steps, 'launches_per_step': result[
                          'eval_swin']['launches_per_step'],
                      'peak_mem_gb': result['eval_swin']['peak_mem_gb'],
                      'metrics': metrics, 'card': card}), flush=True)
    if args.profile:
        profile(lambda: step(eb.batch, states), result, 'eval_swin')
    return launches


def _retrieval_near_ties(card_idx, cpu_idx, cpu_logits):
    """Pixels whose full-resolution retrieval idx differs card vs CPU,
    and how many of them are no near tie on the CPU's side: its top two
    full-resolution logits (the bilinear resize of its working-resolution
    logits) further apart than 1e-5 of their magnitude."""
    from nicr_mtsa_tpu_torch.models.upsampling import resize_bilinear
    diff = card_idx.cpu() != cpu_idx
    n = int(diff.sum())
    if n == 0:
        return 0, 0
    full = resize_bilinear(cpu_logits, *cpu_idx.shape[1:])
    top2 = full.permute(0, 2, 3, 1)[diff].topk(2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    return n, int((gap > 1e-5 * top2[:, 0].abs()).sum())


def swin_eval_card_vs_cpu(result):
    """The card's raw Swin eval outputs (f32, B=2), postprocessed with
    their metric states updated on the card and, copied, on the CPU: the
    states equal (float sums within rtol 1e-5), the DVE matrices equal
    or apart only at counted near ties; then `_dve_controls`."""
    pipe = _swin_eval_pipeline('float32')
    eb = _swin_eval_batch(2, seed=1)
    batch = dict(eb.batch, **eb.static_batch)
    keys = tuple(f'{p}{s}' for p in DVE_PREFIXES.values()
                 for s in ('_idx_fullres', '_output'))
    with torch.inference_mode():
        raw = pipe.model(pipe.model_inputs(batch))
        preds, losses, on_card = pipe.evaluate_outputs(
            raw, batch, pipe.empty_metric_states(), keys)
        raw_cpu = {k: _to_cpu(v) for k, v in raw.items()}
        batch_cpu = {k: _to_cpu(v) for k, v in batch.items()}
        del raw
        preds_cpu, losses_cpu, on_cpu = pipe.evaluate_outputs(
            raw_cpu, batch_cpu, pipe.empty_metric_states('cpu'), keys)
    diff = _states_equal({k: v for k, v in on_card.items() if k != DVE},
                         {k: v for k, v in on_cpu.items() if k != DVE})
    if diff:
        fail(f'swin eval card vs CPU: {diff}')
    ties = {}
    for state_key, prefix in DVE_PREFIXES.items():
        n, not_tie = _retrieval_near_ties(
            preds[f'{prefix}_idx_fullres'], preds_cpu[f'{prefix}_idx_fullres'],
            preds_cpu[f'{prefix}_output'])
        ties[state_key] = n
        if not_tie:
            fail(f'swin eval card vs CPU: {not_tie} of {n} pixels of the '
                 f'{state_key} retrieval differ without a near tie')
        if n == 0 and not torch.equal(on_card[DVE][state_key].cpu(),
                                      on_cpu[DVE][state_key]):
            fail(f'swin eval card vs CPU: {state_key} differs')
    del preds, preds_cpu, raw_cpu
    controls = _dve_controls(pipe, batch)
    counts = {'semantic_pixels': int(on_cpu['semantic'].sum()),
              'dve_pixels': int(on_cpu[DVE]['text_cm'].sum()),
              'dve_differing_pixels': ties,
              'dve_loss_card': float(losses[f'{DVE}_loss_main']),
              'dve_loss_cpu': float(losses_cpu[f'{DVE}_loss_main']),
              **controls}
    result['swin_eval_card_vs_cpu'] = dict(states='equal', **counts)
    print(json.dumps({'phase': 'swin_eval_card_vs_cpu', 'states': 'equal',
                      **counts}), flush=True)


def _dve_controls(pipe, batch):
    """On the card at the batch's shape: the DVE loss of each pixel's own
    LUT row (must be <= 1e-5) and of its negation (within 1e-5 of 2);
    the text retrieval of the embedding set to each pixel's working-
    resolution GT class row of the text table, scored against that
    working-resolution GT as its full resolution (mIoU >= 0.99: nothing
    is resized) and against the 512 x 512 GT (the share of counted
    pixels retrieved right >= 0.99: pixels at class borders move under
    the resize, and a small class's IoU with them, so its mIoU is
    printed, not gated)."""
    helper = pipe.task_helpers[DVE]
    post = pipe.postprocessors[DVE]
    lut = batch[f'{DVE}_lut']
    idx = batch[f'{DVE}_indices'].long()
    own = torch.stack([lut[b][idx[b]] for b in range(idx.shape[0])]
                      ).permute(0, 3, 1, 2)             # channels-last
    out = {}
    with torch.inference_mode():
        for name, p in (('own_row', own), ('negated', -own)):
            out[f'control_{name}_loss'] = float(helper.compute_losses(
                batch, {f'{DVE}_output': p, f'{DVE}_side_outputs': ()})[
                    f'{DVE}_loss_main'])
        del own
        sem = batch['semantic'].long()
        text = post._table(DVE_PREFIXES['text_cm'], sem.device)
        emb = torch.where((sem > 0)[..., None], text[(sem - 1).clamp(min=0)],
                          0.0).permute(0, 3, 1, 2)
        read = frozenset(helper.prediction_keys)
        for name, b in (('working', dict(batch, semantic_fullres=sem)),
                        ('fullres', batch)):
            state = helper.update_metric_states(
                None, b, post.postprocess((emb, ()), b, keys=read))
            cm = state['text_cm'].double()
            out[f'control_{name}_right_share'] = float(cm.trace() / cm.sum())
            helper.load_metric_states(state)
            out[f'control_{name}_text_miou'] = float(
                helper.validation_epoch_end()[2][f'{DVE}_text_miou'])
    if not out['control_own_row_loss'] <= 1e-5:
        fail(f'DVE control: own-row loss {out["control_own_row_loss"]} '
             f'> 1e-5')
    if not abs(out['control_negated_loss'] - 2.0) <= 1e-5:
        fail(f'DVE control: negated-row loss '
             f'{out["control_negated_loss"]} not within 1e-5 of 2')
    if not out['control_working_text_miou'] >= 0.99:
        fail(f'DVE control: text mIoU of the GT class rows at the working '
             f'resolution {out["control_working_text_miou"]} < 0.99')
    if not out['control_fullres_right_share'] >= 0.99:
        fail(f'DVE control: share of full-resolution pixels retrieved '
             f'right {out["control_fullres_right_share"]} < 0.99')
    return out


FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests',
                       'fixtures', 'mini_dataset')
# launches of each kernel in one fused eval step of `bench.py --eval
# --dataset` on the fixture (phase 23): the full-resolution semantic
# crop+resize+reduce, the working-resolution score/argmax reduce, the
# grouping and the intersection histogram for each of the instance and
# the panoptic helper; every other wrapper none
DATASET_EVAL_KERNELS = {'resize_reduce': 1, 'semantic_reduce': 1,
                        'grouping': 2, 'intersection': 2}
# launches of each kernel in one request of `bench.py --stream` (phase 25)
STREAM_KERNELS = {'finisher4x': 1, 'grouping': 1}
# the planted staging race of phase 25: a spin of this many cycles (~200
# ms) on the copy stream before each batch's copies, and no wait for a
# slot's event before its refill. The host must refill a slot while its
# copies still wait behind the spins: batch k's copies run after k + 1
# spins and its slot is refilled when batch k + 3 is staged, so over 8
# batches the host must stage a 12.3 MB batch in less than 5/7 of a
# spin (a host serving at 171 frames/s outran spins of ~20 ms)
RACE_SLEEP_CYCLES = 400_000_000


def _dataset_compose(is_thing_v, H=480, W=640, table=128, normals=False):
    """The eval preprocessing of `bench.py --eval` (bench.py:213-232);
    with `normals` the surface normals kept at full resolution and
    sub-sampled like the maps."""
    from nicr_mtsa_tpu_torch.data import preprocessing as p
    extra = ('normal',) if normals else ()
    return p.Compose([
        p.InstanceClearStuffIDs(semantic_classes_is_thing=is_thing_v),
        p.FullResCloner(('rgb', 'depth', 'semantic', 'instance') + extra),
        p.Resize(height=H, width=W),
        p.MultiscaleSupervisionGenerator(
            downscales=(4, 8, 16, 32),
            keys=('semantic', 'instance', 'orientations') + extra),
        p.InstanceTargetGenerator(
            sigma=8, semantic_classes_is_thing=is_thing_v,
            sigma_for_additional_downscales={4: 2, 8: 2, 16: 1, 32: 1}),
        p.OrientationTargetGenerator(
            semantic_classes_estimate_orientation=is_thing_v),
        p.PanopticTargetGenerator(semantic_classes_is_thing=is_thing_v,
                                  segment_table_size=table),
        p.NormalizeRGB(),
        p.NormalizeDepth(depth_mean=8000.0, depth_std=4000.0,
                         raw_depth=True),
        p.ToDeviceArrays(),
    ])


class _Cycled:
    """`n` samples of a split, cycled (`bench.py:241-243`)."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i % len(self.ds)]


def _fixture(split='valid'):
    """The fixture's split with the bench's eval preprocessing attached,
    and its thing classes (meta.json, without void)."""
    from nicr_mtsa_tpu_torch.data import get_dataset
    ds = get_dataset(FIXTURE, split=split)
    is_thing = ds.config.semantic_label_list_without_void.classes_is_thing
    ds.preprocessor = _dataset_compose((False,) + is_thing)
    return ds, is_thing


def _compose_step_ms(ds):
    """Host ms a sample of the file read and of each Compose step, over
    the split (the native library does the resizes and the RGB
    normalisation)."""
    compose, ds.preprocessor = ds.preprocessor, None
    ms = {'read': 0.0}
    try:
        for i in range(len(ds)):
            t0 = time.perf_counter()
            sample = ds[i]
            ms['read'] += time.perf_counter() - t0
            for t in compose.transforms:
                t0 = time.perf_counter()
                sample = t(sample)
                name = type(t).__name__
                ms[name] = ms.get(name, 0.0) + time.perf_counter() - t0
    finally:
        ds.preprocessor = compose
    return {k: v * 1e3 / len(ds) for k, v in ms.items()}


def _metrics_in_range(logs, key):
    for k, v in logs.items():
        if k.endswith('num_categories'):
            continue
        if '_mae_' in k:
            top = 180.0 if k.endswith('deg') else np.pi
            if not (np.isnan(v) or 0.0 <= v <= top):
                fail(f'{key}: {k} = {v} out of range')
        elif not (np.isfinite(v) and 0.0 <= v <= 1.0):
            fail(f'{key}: metric {k} = {v} not in [0, 1]')


def _check_launches(kernels, want, n, key):
    launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
    for k, c in launches.items():
        if c != want.get(k, 0) * n:
            fail(f'{key}: kernel {k}: {c} launches in {n} steps, expected '
                 f'{want.get(k, 0)} a step')
    return launches


def _same_batch(a, b, where):
    """a and b hold the same containers of the same types, tensors of
    one dtype, shape and value, and the same objects where the batch
    passes one through."""
    if type(a) is not type(b):
        fail(f'{where}: {type(a).__name__} against {type(b).__name__}')
    if isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape \
                or not torch.equal(a, b):
            fail(f'{where}: {a.dtype} {tuple(a.shape)} against {b.dtype} '
                 f'{tuple(b.shape)}, or the values differ')
    elif isinstance(a, dict):
        if list(a) != list(b):
            fail(f'{where}: keys {list(a)} against {list(b)}')
        for k in a:
            _same_batch(a[k], b[k], f'{where}[{k!r}]')
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            fail(f'{where}: {len(a)} items against {len(b)}')
        for i, (x, y) in enumerate(zip(a, b)):
            _same_batch(x, y, f'{where}[{i}]')
    elif a is not b:
        fail(f'{where}: a passed-through entry was replaced')


def evaluate_dataset(args, kernels, card, result):
    """`bench.py --eval --dataset tests/fixtures/mini_dataset` (phase 23):
    the full-width EMSANet of the eval step with the dataset's 10
    classes (meta.json's things) at B=8, bf16, on the `valid` split
    through the bench's eval preprocessing, cycled. (a) the fused step
    on one resident batch with the states carried, (b) host-inclusive:
    DataLoader (2 workers) -> prefetch_to_device -> the step; each 3
    timed rounds of N steps, the counters set to 0 just before, exactly
    DATASET_EVAL_KERNELS' launches a step (others none). The segment
    tables must hold every GT id, every epoch metric lie in range, the
    host path's states equal the resident ones' (scaled), and one batch
    through the prefetcher equal the blocking copy leaf by leaf; the
    slot maps the warm-up step passed row 11 are checked as phase 5's."""
    from nicr_mtsa_tpu_torch.data import (DataLoader, move_batch_to_device,
                                          mt_collate, prefetch_to_device)
    from nicr_mtsa_tpu_torch.data.preprocessing import (
        APPLIED_PREPROCESSING_KEY, segment_table_overflow)
    from nicr_mtsa_tpu_torch.ops.cuda import intersection as it
    from nicr_mtsa_tpu_torch.pipeline import (build_eval_pipeline,
                                              emsanet_bench_config,
                                              strip_non_arrays)
    B = 8
    ds, is_thing = _fixture()
    pipe = build_eval_pipeline(
        emsanet_bench_config(defer=False, n_classes=len(is_thing)),
        device='cuda', seed=0, is_thing=is_thing)
    step_ms = _compose_step_ms(ds)
    host = mt_collate([_Cycled(ds, B)[i] for i in range(B)])
    overflow = segment_table_overflow(host)
    if overflow:
        fail(f'eval_dataset: {overflow} GT ids did not fit into the '
             f'segment tables')
    static = {APPLIED_PREPROCESSING_KEY: host[APPLIED_PREPROCESSING_KEY]}
    batch = strip_non_arrays(move_batch_to_device(host))
    step = pipe.make_fused_eval_step(static)
    torch.cuda.reset_peak_memory_stats()
    with _captured_slot_maps() as maps:
        _, losses, states = step(batch, pipe.empty_metric_states())
    torch.cuda.synchronize()
    got = [(tuple(a.shape), n_gt, n_pred) for a, _, n_gt, n_pred in maps]
    if got != [((B, 120 * 160), 128, 128)] * 2:
        fail(f'eval_dataset: the step passed row 11 {got}, expected two '
             f'(8, 19200) map pairs of 129 x 129 bins')
    for i, (a, b, n_gt, n_pred) in enumerate(maps):
        _same_counts(it, f'eval_dataset map {i}', a, b, n_gt, n_pred)
    del maps

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    resident = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            _, losses, states = step(batch, states)
        int(states['semantic'][0, 0])
        resident.append(B * args.steps / (time.perf_counter() - t0))
    n_steps = 3 * args.steps
    launches = _check_launches(kernels, DATASET_EVAL_KERNELS, n_steps,
                               'eval_dataset')
    bad = [k for k, v in losses.items() if not bool(torch.isfinite(v))]
    if bad:
        fail(f'eval_dataset: losses not finite: {bad}')

    def host_path(n_batches, states_h):
        loader = DataLoader(_Cycled(ds, B * n_batches), batch_size=B,
                            num_workers=2, to_device=False)
        for hb in prefetch_to_device(loader, size=2):
            _, _, states_h = step(strip_non_arrays(hb), states_h)
        return states_h

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    hosted, states_h = [], pipe.empty_metric_states()
    for _ in range(3):
        t0 = time.perf_counter()
        states_h = host_path(args.steps, states_h)
        int(states_h['semantic'][0, 0])
        hosted.append(B * args.steps / (time.perf_counter() - t0))
    _check_launches(kernels, DATASET_EVAL_KERNELS, n_steps,
                    'eval_dataset host path')
    # every batch holds the same 8 samples: the host path's states are
    # the resident ones' scaled by the steps taken (1 + 3N against 3N)
    if not torch.equal(states_h['semantic'] * (1 + n_steps),
                       states['semantic'] * n_steps):
        fail('eval_dataset: host-path states differ from the resident ones')
    # one dict batch through the pinned staging ring, leaf by leaf
    # against the blocking copy (the NCHW transpose, the int32 casts, the
    # `_down_<k>` dicts)
    (staged,) = prefetch_to_device([host], size=1)
    _same_batch(staged, move_batch_to_device(host), 'eval_dataset prefetch')
    del staged

    pipe.load_metric_states(states)
    _, _, logs = pipe.validation_epoch_end()
    logs = {k: float(v) for k, v in logs.items()}
    _metrics_in_range(logs, 'eval_dataset')
    for k, v in sorted(logs.items()):
        print(f'# {k}: {v:.4f}', file=sys.stderr, flush=True)
    result['eval_dataset'] = dict(
        batch=B, steps_per_round=args.steps, card=card,
        resident_rounds_frames_per_s=resident,
        resident_frames_per_s=float(np.median(resident)),
        host_rounds_frames_per_s=hosted,
        host_frames_per_s=float(np.median(hosted)),
        host_ms_a_sample=step_ms, segment_table_overflow=overflow,
        host_path_semantic_states_equal=True, prefetched_batch_equal=True,
        launches_per_step={n: c / n_steps for n, c in launches.items()},
        metrics=logs, losses={k: float(v) for k, v in losses.items()},
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(json.dumps({'phase': 'eval_dataset', **{
        k: v for k, v in result['eval_dataset'].items()
        if k not in ('metrics', 'losses')}}), flush=True)
    if args.profile:
        profile(lambda: step(batch, states), result, 'eval_dataset')
        profile(lambda: host_path(1, pipe.empty_metric_states()), result,
                'eval_dataset_host')
    return launches


def _tree_to_cpu(t):
    if isinstance(t, dict):
        return {k: _tree_to_cpu(v) for k, v in t.items()}
    return _to_cpu(t)


def eval_dataset_card_vs_cpu(result):
    """Phase 24: the fixture's first two `valid` samples through the
    bench's eval preprocessing (B=2), the f32 model of phase 23's
    weights on the card; its raw outputs postprocessed with the metric
    states updated on the card and, copied, on the CPU: phase 6's
    gates."""
    from nicr_mtsa_tpu_torch.data import move_batch_to_device, mt_collate
    from nicr_mtsa_tpu_torch.data.preprocessing import (
        APPLIED_PREPROCESSING_KEY)
    from nicr_mtsa_tpu_torch.pipeline import (build_eval_pipeline,
                                              emsanet_bench_config,
                                              strip_non_arrays)
    ds, is_thing = _fixture()
    pipe = build_eval_pipeline(
        emsanet_bench_config(dtype='float32', defer=False,
                             n_classes=len(is_thing)),
        device='cuda', seed=0, is_thing=is_thing)
    host = mt_collate([ds[0], ds[1]])
    batch = dict(strip_non_arrays(move_batch_to_device(host)),
                 **{APPLIED_PREPROCESSING_KEY:
                    host[APPLIED_PREPROCESSING_KEY]})
    with torch.inference_mode():
        raw = pipe.model(pipe.model_inputs(batch))
        _, _, on_card = pipe.evaluate_outputs(raw, batch,
                                              pipe.empty_metric_states())
        _, _, on_cpu = pipe.evaluate_outputs(
            _tree_to_cpu(raw), _tree_to_cpu(batch),
            pipe.empty_metric_states('cpu'))
    diff = _states_equal(on_card, on_cpu)
    if diff:
        fail(f'eval_dataset card vs CPU: {diff}')
    counts = {'semantic_pixels': int(on_cpu['semantic'].sum()),
              'panoptic_fn': float(on_cpu['panoptic']['pq'][
                  'fn_per_class'].sum()),
              'panoptic_tp': float(on_cpu['panoptic']['pq'][
                  'tp_per_class'].sum())}
    result['eval_dataset_card_vs_cpu'] = dict(states='equal', **counts)
    print(json.dumps({'phase': 'eval_dataset_card_vs_cpu',
                      'states': 'equal', **counts}), flush=True)


def _outputs_equal(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in b)


def _stream_requests(pipe, host_batches, n, collect_first=False):
    """n requests of `host_batches` (cycled) through prefetch_to_device
    (size 2): each request's outputs, cloned. `collect_first` takes every
    batch from the prefetcher before serving any (the host runs ahead of
    the card: no request syncs it)."""
    from nicr_mtsa_tpu_torch.data import prefetch_to_device
    gen = (host_batches[i % len(host_batches)] for i in range(n))
    batches = prefetch_to_device(gen, size=2)
    if collect_first:
        batches = list(batches)
    return [{k: v.clone() for k, v in pipe(rgb, depth).items()}
            for rgb, depth in batches]


def serve_stream(args, kernels, card, result, key='serve_stream', B=8,
                 n_requests=None, checks=True):
    """`bench.py --stream` (phase 25; at the bench's B=256 in phase 27,
    `checks` off): `emsanet_bench_config()` serving at B on 4 pre-drawn
    distinct uint8/uint16 host batches at 480 x 640 through
    prefetch_to_device(size=2), 3 timed rounds of `n_requests` requests
    (default `args.requests`), counters set to 0 just before: exactly
    STREAM_KERNELS' launches a request (others none); peak memory from
    before the warm-up. With `checks`: the copy stream's time for a
    request's frames, and, with cudnn pinned deterministic, every
    prefetched request's outputs must be bit-equal to its frames served
    through a blocking `.to('cuda')`, interleaved and with every batch
    taken before the first request; a planted staging race (no wait for
    a slot's event, the copy stream delayed) must break that."""
    from nicr_mtsa_tpu_torch.data import feeder
    from nicr_mtsa_tpu_torch.pipeline import build_serving_pipeline
    n_requests = n_requests or args.requests
    pipe = build_serving_pipeline(device='cuda', seed=0)
    host_batches = [frames(B, seed=s) for s in range(4)]
    h2d_bytes = sum(a.nbytes for a in host_batches[0])
    _fresh()
    pipe(*(torch.from_numpy(a).cuda() for a in host_batches[0]))
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = _stream_requests(pipe, host_batches, n_requests)[-1]
        int(out['panoptic'][0, 0, 0])
        rounds.append(B * n_requests / (time.perf_counter() - t0))
    n = 3 * n_requests
    launches = _check_launches(kernels, STREAM_KERNELS, n, key)
    check_outputs(out, B, 480, 640, 40)
    fps = float(np.median(rounds))
    result[key] = dict(
        batch=B, requests_per_round=n_requests, rounds_frames_per_s=rounds,
        frames_per_s=fps, peak_mem_gb=_peak_gb(),
        h2d_bytes_a_request=h2d_bytes,
        launches_per_request={k: c / n for k, c in launches.items()},
        card=card)
    if not checks:
        print(json.dumps({'phase': key, **result[key]}), flush=True)
        return launches

    # the copy stream's time for one request's frames (pinned -> card)
    pinned = [torch.from_numpy(a).pin_memory() for a in host_batches[0]]
    copy_stream = torch.cuda.Stream()

    def copy():
        with torch.cuda.stream(copy_stream):
            for p in pinned:
                p.to('cuda', non_blocking=True)
    copies = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(copy_stream)
        copy()
        b.record(copy_stream)
        b.synchronize()
        copies.append(a.elapsed_time(b))

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want = [{k: v.clone() for k, v in pipe(*(
            torch.from_numpy(a).to('cuda') for a in hb)).items()}
            for hb in host_batches]
        checked = {}
        for name, collect in (('interleaved', False), ('collected', True)):
            got = _stream_requests(pipe, host_batches, 8, collect)
            bad = [i for i, o in enumerate(got)
                   if not _outputs_equal(o, want[i % 4])]
            if bad:
                fail(f'serve_stream: prefetched requests {bad} ({name}) '
                     f'differ from the blocking copies')
            checked[name] = len(got)
        waits = feeder._Feeder._acquire

        def racing_acquire(self, slot):
            with torch.cuda.stream(self.copy_stream):
                torch.cuda._sleep(RACE_SLEEP_CYCLES)
        feeder._Feeder._acquire = racing_acquire
        try:
            got = _stream_requests(pipe, host_batches, 8, True)
        finally:
            feeder._Feeder._acquire = waits
        caught = [i for i, o in enumerate(got)
                  if not _outputs_equal(o, want[i % 4])]
        if not caught:
            fail('serve_stream: the planted staging race went unnoticed')
    finally:
        torch.backends.cudnn.deterministic = deterministic

    result[key].update(
        device_resident_frames_per_s=result['serving']['frames_per_s'],
        copy_ms_a_request=float(np.median(copies)),
        bit_equal_requests=checked, planted_race_caught=caught)
    print(json.dumps({'phase': key, **result[key]}), flush=True)
    if args.profile:
        profile(lambda: _stream_requests(pipe, host_batches[:1], 1), result,
                key)
    return launches


# --- the bench's own batch sizes (phases 26-31) -----------------------------

# `bench.py`'s batch sizes: serving 256 for EMSANet and 128 for the Swin
# family (bench.py:677-688), eval 128 (:237), `--stream` 256 (:353),
# training 48 (:69); `--latency` at B=1 and 8 (:394-432)
BENCH_SERVE_B = {'emsanet': 256, 'swin': 128}
BENCH_EVAL_B = 128
BENCH_STREAM_B = 256
BENCH_TRAIN_B = 48
LATENCY_B = (1, 8)
# fenced requests a batch size and family of the latency phase (as
# bench.py --latency, 30); requests (serving), steps (eval, training)
# per timed round (3 rounds) at the bench sizes
LATENCY_STEPS = 30
BENCH_REQUESTS = 2
BENCH_EVAL_STEPS = 1
BENCH_TRAIN_STEPS = 1
# the Swin eval ladder: the bench's 128, then halves down to 16 (the
# JAX package's own supported point for this path); only B=16 must fit
SWIN_EVAL_LADDER = (128, 64, 32, 16)
# `--attn-chunk` of phase 30: images per window-attention chunk
ATTN_CHUNK = 32
# launches of each kernel in a request of `--quick` serving (EMSANet at
# 128 x 160, both upsamplings deferred); `emsaformer_dve` (Swin v1, 7 x
# 7 windows) serves with SWIN_KERNELS
QUICK_KERNELS = {'finisher4x': 1, 'grouping': 1}
# a Swin training step with remat: the recompute runs each block's
# attention core forward once more
REMAT_TRAIN_KERNELS = dict(TRAIN_KERNELS, window_attention_core_fwd=24)
# the card's memory: the remat run's peak must stay below it where the
# run without remat is out of memory (else below that run's peak)
CARD_MEMORY = 80e9
# the batch at which the first steps of remat and plain training are
# compared where B=48 does not fit without remat
COMPARE_B = 16


def _fresh():
    """Drop what the last phase left cached, reset the peak counter."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _peak_gb():
    return torch.cuda.max_memory_allocated() / 1e9


def _asked(e) -> str:
    """The allocation an out-of-memory error names ('12.00 GiB')."""
    m = re.search(r'Tried to allocate ([0-9.]+ [KMGT]?i?B)', str(e))
    return m.group(1) if m else str(e).split('\n')[0][:160]


@contextlib.contextmanager
def _deterministic(algorithms: bool = False):
    """Deterministic cuDNN and, with `algorithms`, torch's deterministic
    algorithms (an op without one warns and runs as it is)."""
    saved = torch.backends.cudnn.deterministic
    saved_algorithms = torch.are_deterministic_algorithms_enabled()
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(algorithms, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved
        torch.use_deterministic_algorithms(saved_algorithms)


class _Hook:
    """A callable in place of `inner` that keeps the (args, kwargs) of
    the first call under each key `key_of(*args, **kwargs)` returns
    (None: not kept), tensors detached, in `into`, then calls `inner`.
    Other attributes are `inner`'s: a wrapper that counts its launches
    on its own module-level name (`fn.launches += 1`) counts on the
    wrapped function."""

    def __init__(self, inner, into, key_of):
        object.__setattr__(self, '_hook', (inner, into, key_of))

    def __call__(self, *a, **k):
        inner, into, key_of = self._hook
        key = key_of(*a, **k)
        if key is not None and key not in into:
            into[key] = (tuple(t.detach() if torch.is_tensor(t) else t
                               for t in a), dict(k))
        return inner(*a, **k)

    def __getattr__(self, name):
        return getattr(self._hook[0], name)

    def __setattr__(self, name, value):
        setattr(self._hook[0], name, value)


@contextlib.contextmanager
def _capture(targets):
    """Within: for each `name: (module, attribute, key_of)` of
    `targets`, `module.attribute` is a `_Hook` keeping its calls in
    `calls[name]`; it runs as before (its launch counter included)."""
    calls = {name: {} for name in targets}
    saved = []
    for name, (mod, attr, key_of) in targets.items():
        inner = getattr(mod, attr)
        setattr(mod, attr, _Hook(inner, calls[name], key_of))
        saved.append((mod, attr, inner))
    try:
        yield calls
    finally:
        for mod, attr, inner in saved:
            setattr(mod, attr, inner)


def _first_calls(n: int = 1):
    """A capture key: the call's number, for the first `n` calls."""
    seen = []

    def key_of(*a, **k):
        if len(seen) < n:
            seen.append(None)
            return len(seen) - 1
        return None
    return key_of


def _by_shape(*a, **k):
    return tuple(a[0].shape[1:]) + (str(a[0].dtype),)


def _by_shape_shift(*a, **k):
    # window_attention_image(x, ..., n_heads, ws, shift, v2_scale)
    return tuple(a[0].shape[1:]) + (a[8],)


def _serving_targets(swin: bool):
    from nicr_mtsa_tpu_torch.models.backbones import swin as swin_mod
    from nicr_mtsa_tpu_torch.ops import grouping as grouping_mod
    from nicr_mtsa_tpu_torch.ops.cuda import finisher4x as fin, layernorm
    targets = {'grouping': (grouping_mod, 'group_pixels_offsets',
                            _first_calls())}
    if not swin:
        targets['finisher4x'] = (fin, 'upsample4x_argmax_score',
                                 _first_calls())
        return targets
    targets['finisher4x_bilinear'] = (
        fin, 'upsample4x_bilinear_argmax_score', _first_calls())
    targets['window_attention_block'] = (
        swin_mod, 'window_attention_image', _by_shape_shift)
    targets['layernorm'] = (layernorm, 'fused_layer_norm', _by_shape)
    return targets


def _eval_targets():
    from nicr_mtsa_tpu_torch.ops import grouping as grouping_mod, segments
    from nicr_mtsa_tpu_torch.postprocessing import semantic as sem_post
    return {'grouping': (grouping_mod, 'group_pixels_offsets',
                         _first_calls()),
            # the bf16 semantic call, and the f32 retrievals' (Swin)
            'resize_reduce': (sem_post, 'crop_resize_argmax_score',
                              _by_shape),
            'semantic_reduce': (sem_post, 'semantic_argmax_score',
                                _first_calls()),
            # both PQ helpers' calls
            'intersection': (segments, 'intersection_matrix_kernel',
                             _first_calls(2))}


def _agree_grouping(what, got, want):
    _same_grouping(what, got, want)
    return 0.0


def _agree_exact(what, got, want):
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f'{what}: counts differ')
    return 0.0


def _agree_ln(what, got, want):
    (got,), (want,) = got, want
    if got.dtype == torch.bfloat16:
        _, n_bad = _ulp_check(got, want)
        if n_bad:
            fail(f'{what}: {n_bad} values more than 1 ulp and 1e-6 x max '
                 f'|out| apart')
        return float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    return float((got - want).abs().max())


def _agree_attention(what, got, want):
    (got,), (want,) = got, want
    tol = 2e-2 if got.dtype == torch.bfloat16 else 1e-4
    err = _rel_err(got, want)
    if not err <= tol:
        fail(f'{what}: max error {err} x max |out| > {tol}')
    return err


def _plain_grouping(offset, centers_yx, centers_valid, foreground,
                    threshold=None, return_min_d2=True):
    from nicr_mtsa_tpu_torch.ops.cuda import grouping
    return grouping.group_pixels_offsets_reference(
        offset, centers_yx, centers_valid, foreground, threshold)


def _bench_rows():
    """Row name -> (kernel wrapper, plain version, batched positional
    arguments, agreement rule, kwargs forced for the check)."""
    from nicr_mtsa_tpu_torch.ops import cuda as k
    from nicr_mtsa_tpu_torch.ops.cuda import window_attention as wa
    return {
        'finisher4x': (k.upsample4x_argmax_score,
                       k.upsample4x_argmax_score_reference, (0,),
                       _same, {}),
        'finisher4x_bilinear': (
            k.upsample4x_bilinear_argmax_score,
            k.upsample4x_bilinear_argmax_score_reference, (0,),
            _same, {}),
        'grouping': (k.group_pixels_offsets, _plain_grouping, (0, 1, 2, 3),
                     _agree_grouping, {'return_min_d2': True}),
        'resize_reduce': (k.crop_resize_argmax_score,
                          k.crop_resize_argmax_score_reference, (0,),
                          _same, {}),
        'semantic_reduce': (k.semantic_argmax_score,
                            k.semantic_argmax_score_reference, (0,),
                            _same, {}),
        'intersection': (k.intersection_matrix_kernel,
                         k.intersection_matrix_reference, (0, 1),
                         _agree_exact, {}),
        'layernorm': (k.fused_layer_norm, k.layer_norm_reference, (0,),
                      _agree_ln, {}),
        'window_attention_block': (wa.window_attention_image,
                                   wa.window_attention_image_reference,
                                   (0,), _agree_attention, {}),
    }


def _outputs(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def check_bench_shapes(path, calls, result):
    """Each captured call of a path at its bench size: the kernel on the
    whole batch, on images 0-7 and on the last 8 images alone (outputs
    for those images equal: integers bit for bit, floats within the
    row's rule), and its plain version on the last 8 images."""
    rows = _bench_rows()
    report = {}
    for name, by_key in calls.items():
        fn, plain, batched, agree, forced = rows[name]
        for key, (args, kwargs) in by_key.items():
            kwargs = dict(kwargs, **forced)
            B = args[batched[0]].shape[0]
            full = _outputs(fn(*args, **kwargs))
            errs = {}
            for label, sl in (('first8', slice(0, 8)),
                              ('last8', slice(B - 8, B))):
                sub = tuple(a[sl] if i in batched else a
                            for i, a in enumerate(args))
                got = _outputs(fn(*sub, **kwargs))
                torch.cuda.synchronize()
                errs[label] = agree(
                    f'{path} {name} {key}: images {label} of {B}', got,
                    tuple(o[sl] for o in full))
            want = _outputs(plain(*sub, **kwargs))
            errs['plain_last8'] = agree(
                f'{path} {name} {key}: the last 8 of {B} against the plain '
                f'version', got, want)
            report[f'{name} {key}'] = dict(batch=B, max_err=errs)
    result.setdefault('bench_shapes', {})[path] = report
    print(json.dumps({'phase': f'bench_shapes_{path}', 'checked': {
        k: v['max_err'] for k, v in report.items()}}), flush=True)
    return report


def check_bench_core(q, k, v, bias, grid_hw, shift, result):
    """Row 7 at the training step's bench shape (its stage-1 call): the
    forward (out, lse) and the backward (dq, dk, dv) for images 0-7 and
    the last 8 of the whole batch equal the kernels' calls on those 8
    images alone; forward and backward (dbias included) of the last 8
    against the plain versions (CORE_TOL of max |.|; lse 1e-4)."""
    from nicr_mtsa_tpu_torch.ops.cuda import window_attention_core as wac
    nW = grid_hw[0] * grid_hw[1]
    B = q.shape[0] // nW
    g = torch.Generator(device='cuda').manual_seed(7)
    dout = torch.randn(q.shape, device='cuda', generator=g).to(q.dtype)
    out, lse = wac.window_attention_core_forward(q, k, v, bias, grid_hw,
                                                 shift)
    dq, dk, dv, _ = wac.window_attention_core_backward(
        q, k, v, bias, dout, lse, grid_hw, shift)
    full = (out, lse, dq, dk, dv)
    names = ('out', 'lse', 'dq', 'dk', 'dv')
    errs = {}
    tol = CORE_TOL[q.dtype]
    for label, lo in (('first8', 0), ('last8', B - 8)):
        sl = slice(lo * nW, (lo + 8) * nW)
        sub = (q[sl], k[sl], v[sl])
        o8, l8 = wac.window_attention_core_forward(*sub, bias, grid_hw, shift)
        got = (o8, l8) + wac.window_attention_core_backward(
            *sub, bias, dout[sl], l8, grid_hw, shift)
        torch.cuda.synchronize()
        for n, a, b in zip(names, got, full):
            err = _rel_err(a, b[sl])
            errs[f'{label}_{n}'] = err
            if not err <= (1e-4 if n == 'lse' else tol):
                fail(f'bench core: {n} of images {label} of {B}: {err} x '
                     f'max |.| against the whole batch')
    want = wac.window_attention_core_reference(*sub, bias, grid_hw, shift)
    want += wac.window_attention_core_backward_reference(
        *sub, bias, dout[sl], want[1], grid_hw, shift)
    for n, a, b in zip(names + ('dbias',), got, want):
        err = _rel_err(a, b)
        errs[f'plain_last8_{n}'] = err
        if not err <= (1e-4 if n == 'lse' else tol):
            fail(f'bench core: {n} of the last 8 of {B}: {err} x max |.| '
                 f'from the plain version')
    result.setdefault('bench_shapes', {})['train_swin'] = {
        'window_attention_core': dict(batch=B, windows=q.shape[0],
                                      max_err=errs)}
    print(json.dumps({'phase': 'bench_shapes_train_swin',
                      'window_attention_core': errs, 'batch': B}),
          flush=True)


def latency(card, result):
    """`bench.py --latency` (phase 26): each family's default serving
    path (`emsanet-bench` with `--defer4x`, `emsaformer_dve_v2` 'auto')
    at B=1 and B=8, a warm-up request, then LATENCY_STEPS requests each
    fenced by a device-to-host fetch of out['panoptic'][0, 0, 0]; the
    median ms."""
    from nicr_mtsa_tpu_torch.pipeline import (build_serving_pipeline,
                                              emsaformer_bench_config,
                                              emsanet_bench_config)
    rows = {}
    for fam, cfg in (('emsanet', emsanet_bench_config()),
                     ('emsaformer', emsaformer_bench_config())):
        pipe = build_serving_pipeline(cfg, device='cuda', seed=0)
        rows[fam] = {}
        for B in LATENCY_B:
            rgb, depth = (torch.from_numpy(a).cuda() for a in frames(B))
            int(pipe(rgb, depth)['panoptic'][0, 0, 0])
            times = []
            for _ in range(LATENCY_STEPS):
                t0 = time.perf_counter()
                out = pipe(rgb, depth)
                int(out['panoptic'][0, 0, 0])
                times.append((time.perf_counter() - t0) * 1e3)
            check_outputs(out, B, 480, 640, 40)
            ms = float(np.median(times))
            rows[fam][f'b{B}'] = dict(
                median_ms=ms, frames_per_s=1e3 * B / ms, steps=len(times),
                min_ms=float(min(times)), max_ms=float(max(times)))
        del pipe, out
        _fresh()
    result['latency'] = dict(rows, card=card)
    print(json.dumps({'phase': 'latency', **{
        f'{fam}_b{B}_median_ms': rows[fam][f'b{B}']['median_ms']
        for fam in rows for B in LATENCY_B}, 'steps': LATENCY_STEPS,
        'card': card}), flush=True)


def _eval_rounds(step, batch, states, n):
    B, rounds = next(iter(batch.values())).shape[0], []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            _, losses, states = step(batch, states)
        int(states['semantic'][0, 0])
        rounds.append(B * n / (time.perf_counter() - t0))
    return rounds, losses, states


def _eval_result(pipe, key, losses, states, log_keys):
    bad = [k for k, v in losses.items() if not bool(torch.isfinite(v))]
    if bad:
        fail(f'{key}: losses not finite: {bad}')
    pipe.load_metric_states(states)
    _, _, logs = pipe.validation_epoch_end()
    metrics = {k: float(logs[k]) for k in log_keys}
    for k, v in metrics.items():
        if not (np.isfinite(v) and 0.0 <= v <= 1.0):
            fail(f'{key}: metric {k} = {v} not in [0, 1]')
    return metrics


def eval_bench(kernels, card, result):
    """Eval at the bench's size (phase 28): EMSANet's fused step at
    B=128 with the segment table at 128 (its kernels' inputs captured,
    then checked at that shape), then the Swin/DVE step down the ladder
    128, 64, 32, 16: a size that runs out of memory is printed with the
    allocation it asked for (only torch.cuda.OutOfMemoryError is caught,
    the cache emptied after each), and B=16 must fit. Each size that
    runs: a warm-up step, three timed rounds of N steps with the states
    carried, the counters set to 0 just before, exact launches a step,
    finite losses, metrics in [0, 1], frames/s and peak memory."""
    from nicr_mtsa_tpu_torch.pipeline import build_eval_pipeline
    from nicr_mtsa_tpu_torch.testing import build_eval_batch
    B = BENCH_EVAL_B
    eb = build_eval_batch(B, (480, 640), (512, 512), 40, IS_THING, seed=0,
                          segment_table_size=128, device='cuda', dve_dim=512)
    if eb.segment_table_overflow:
        fail(f'bench eval batch: {eb.segment_table_overflow} GT segments '
             f'did not fit into the segment tables')
    pipe = build_eval_pipeline(device='cuda', seed=0)
    batch = {k: v for k, v in eb.batch.items() if not k.startswith(DVE)}
    step = pipe.make_fused_eval_step(eb.static_batch)
    _fresh()
    with _capture(_eval_targets()) as calls:
        _, losses, states = step(batch, pipe.empty_metric_states())
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    rounds, losses, states = _eval_rounds(step, batch, states,
                                          BENCH_EVAL_STEPS)
    n = 3 * BENCH_EVAL_STEPS
    # EMSANet's eval step launches the dataset eval path's kernels
    launches = _check_launches(kernels, DATASET_EVAL_KERNELS, n,
                               'eval_bench')
    metrics = _eval_result(pipe, 'eval_bench', losses, states,
                           EVAL_LOG_KEYS)
    fps = float(np.median(rounds))
    result['eval_bench'] = dict(
        batch=B, segment_table_size=128, steps_per_round=BENCH_EVAL_STEPS,
        rounds_frames_per_s=rounds, frames_per_s=fps, peak_mem_gb=_peak_gb(),
        launches_per_step={k: c / n for k, c in launches.items() if c},
        metrics=metrics, card=card)
    print(json.dumps({'phase': 'eval_bench', **result['eval_bench']}),
          flush=True)
    del pipe, step, losses, states
    _fresh()
    check_bench_shapes('eval_emsanet', calls, result)
    del calls
    _fresh()

    pipe = _swin_eval_pipeline()
    step = pipe.make_fused_eval_step(eb.static_batch)
    failed, fitted = [], None
    for b in SWIN_EVAL_LADDER:
        sub = {k: v[:b] for k, v in eb.batch.items()}
        asked = None
        _fresh()
        # a size fits where its warm-up and its timed rounds run
        try:
            _, losses, states = step(sub, pipe.empty_metric_states())
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            rounds, losses, states = _eval_rounds(step, sub, states,
                                                  BENCH_EVAL_STEPS)
        except torch.cuda.OutOfMemoryError as e:
            asked = _asked(e)
        if asked is not None:
            losses = states = None
            _fresh()
            failed.append({'batch': b, 'asked': asked})
            print(json.dumps({'phase': 'eval_swin_bench_oom', 'batch': b,
                              'asked': asked, 'card': card}), flush=True)
            continue
        launches = _check_launches(kernels, SWIN_EVAL_KERNELS, n,
                                   'eval_swin_bench')
        metrics = _eval_result(pipe, 'eval_swin_bench', losses, states,
                               SWIN_EVAL_LOG_KEYS)
        fitted = dict(batch=b, steps_per_round=BENCH_EVAL_STEPS,
                      rounds_frames_per_s=rounds,
                      frames_per_s=float(np.median(rounds)),
                      peak_mem_gb=_peak_gb(), metrics=metrics,
                      launches_per_step={k: c / n for k, c in
                                         launches.items() if c})
        # one more step from empty states, its kernels' inputs captured
        # for phase 31 (held only after the step has freed the rest)
        losses = states = None
        _fresh()
        with _capture(_eval_targets()) as calls:
            step(sub, pipe.empty_metric_states())
        break
    if fitted is None:
        fail(f'eval_swin_bench: not even B={SWIN_EVAL_LADDER[-1]} fits: '
             f'{failed}')
    result['eval_swin_bench'] = dict(fitted, out_of_memory=failed,
                                     largest_batch=fitted['batch'], card=card)
    print(json.dumps({'phase': 'eval_swin_bench',
                      **result['eval_swin_bench']}), flush=True)
    del pipe, step, eb, batch, sub
    _fresh()
    check_bench_shapes('eval_swin', calls, result)
    del calls
    _fresh()


def _first_step(cfg, batch, algorithms: bool = True):
    """One training step of `cfg` from seed 0's weights with a CUDA
    generator seeded 1, under deterministic cuDNN and, with
    `algorithms`, torch's deterministic algorithms (`_deterministic`):
    (pipeline, state, generator, the step's losses, gradients,
    BatchNorm statistics and the generator's state after it)."""
    from nicr_mtsa_tpu_torch.pipeline import build_train_pipeline
    pipe = build_train_pipeline(cfg, device='cuda', seed=0)
    gen = torch.Generator(device='cuda').manual_seed(1)
    state = pipe.create_train_state()
    with _deterministic(algorithms):
        state, losses = pipe.train_step(state, batch, gen)
        torch.cuda.synchronize()
    first = dict(
        losses={k: float(v) for k, v in losses.items()},
        grads={n: p.grad.detach().clone() for n, p in
               pipe.model.named_parameters() if p.grad is not None},
        stats={n: b.detach().clone() for n, b in
               pipe.model.named_buffers()},
        generator=gen.get_state())
    return pipe, state, gen, first


def _grad_errors(want, got):
    """{tensor: the largest difference of its gradients as a share of
    its max |grad| in `want`, or of 1e-5 x the step's largest |grad|
    where the tensor's is below that (a gradient that is 0 but for
    rounding, such as the bias of a LayerNorm a BatchNorm follows)}."""
    largest = max(float(g.float().abs().max()) for g in want.values())
    return {n: float((got[n].float() - g.float()).abs().max())
            / max(float(g.float().abs().max()), 1e-5 * largest, 1e-30)
            for n, g in want.items()}


def _compare_first_steps(key, plain, remat):
    """The remat step against the one without, both under torch's
    deterministic algorithms: losses, BatchNorm statistics and the
    generator's state equal, and each gradient within 1e-3 of its
    tensor's max |grad| (phase 12's rule, `_grad_errors`). Returns (the
    largest share, its tensor, the tensors not bit-equal)."""
    if plain['losses'] != remat['losses']:
        fail(f'{key}: remat losses {remat["losses"]} differ from '
             f'{plain["losses"]}')
    bad = [n for n, t in plain['stats'].items()
           if not torch.equal(t, remat['stats'][n])]
    if bad:
        fail(f'{key}: BatchNorm statistics differ under remat: {bad[:5]}')
    if not torch.equal(plain['generator'], remat['generator']):
        fail(f'{key}: the generator state after the remat step differs')
    if set(plain['grads']) != set(remat['grads']):
        fail(f'{key}: the remat step gives other gradients')
    errs = _grad_errors(plain['grads'], remat['grads'])
    for n, err in errs.items():
        if not err <= 1e-3:
            fail(f'{key}: gradient {n} under remat off by {err} of its max')
    return (*max((e, n) for n, e in errs.items()),
            sum(e > 0 for e in errs.values()))


def train_bench(args, kernels, card, result, family, capture=False):
    """Training at the bench's B=48 (phase 29), `family` 'emsanet' or
    'swin', without and with remat, each through `train`
    (BENCH_TRAIN_STEPS steps a round). An out-of-memory error is caught
    only in the run without remat, and printed; with remat B=48 must
    run, below the other run's peak (or the card's 80 GB). The two runs'
    first steps (torch's deterministic algorithms) must agree
    (`_compare_first_steps`; at COMPARE_B where B=48 does not fit
    without remat). Also printed: the run-to-run spread of two plain
    first steps with torch's default algorithms, which sum some
    gradients in an order that changes from run to run. `capture`:
    check row 7's stage-1 call at this shape (`check_bench_core`)."""
    from nicr_mtsa_tpu_torch.models.backbones import swin as swin_mod
    from nicr_mtsa_tpu_torch.pipeline import (emsaformer_train_config,
                                              emsanet_train_config)
    from nicr_mtsa_tpu_torch.testing import build_train_batch
    swin = family == 'swin'
    cfg_of = emsaformer_train_config if swin else emsanet_train_config
    want = {False: TRAIN_KERNELS if swin else {},
            True: REMAT_TRAIN_KERNELS if swin else {}}
    B = BENCH_TRAIN_B
    batch = build_train_batch(B, 480, 640, seed=0, device='cuda', rgbd=swin)
    firsts = {}
    for remat in (False, True):
        key = f'train_{family}_bench{"_remat" if remat else ""}'
        asked = None
        targets = ({'core': (swin_mod, 'window_attention_core',
                             _first_calls())} if capture and remat else {})
        try:
            _, firsts[remat], calls = train(
                args, kernels, card, result, key, cfg_of(remat=remat),
                want[remat], B=B, steps=BENCH_TRAIN_STEPS, batch=batch,
                targets=targets, profile_it=False)
        except torch.cuda.OutOfMemoryError as e:
            if remat:
                raise
            asked = _asked(e)
        if asked is not None:
            _fresh()
            result[key] = dict(batch=B, out_of_memory=asked)
            print(json.dumps({'phase': key, 'batch': B,
                              'out_of_memory': asked, 'card': card}),
                  flush=True)
            continue
        _fresh()
        if calls:
            check_bench_core(*calls['core'][0][0], result)
        del calls
        _fresh()
    runs = {rm: result[f'train_{family}_bench{"_remat" if rm else ""}']
            for rm in (False, True)}
    compared_at = B
    if 'out_of_memory' in runs[False]:
        compared_at = COMPARE_B
        batch = {k: v[:compared_at] for k, v in batch.items()}
        for remat in (False, True):
            firsts[remat] = _first_step(cfg_of(remat=remat), batch)[3]
            _fresh()
    worst, worst_at, n_differ = _compare_first_steps(
        f'train_{family}_bench', firsts[False], firsts[True])
    del firsts
    plain = []
    for _ in range(2):
        plain.append(_first_step(cfg_of(), batch, algorithms=False)[3])
        _fresh()
    spread = _grad_errors(plain[0]['grads'], plain[1]['grads'])
    del plain
    limit = runs[False].get('peak_mem_gb', CARD_MEMORY / 1e9)
    if not runs[True]['peak_mem_gb'] < limit:
        fail(f'train_{family}_bench: remat peak {runs[True]["peak_mem_gb"]}'
             f' GB is not below {limit} GB')
    result[f'train_{family}_bench'] = dict(
        first_steps_compared_at=compared_at,
        remat_grad_max_rel_err=[worst, worst_at],
        remat_grads_not_bit_equal=n_differ,
        default_algorithms_spread_max_rel_err=max(
            (e, n) for n, e in spread.items()),
        default_algorithms_spread_n_differ=sum(
            e > 0 for e in spread.values()),
        n_grads=len(spread), card=card)
    print(json.dumps({'phase': f'train_{family}_bench_remat_vs_plain',
                      **result[f'train_{family}_bench'],
                      'losses_equal': True, 'batch_stats_equal': True,
                      'generator_state_equal': True,
                      'peak_mem_gb': {'plain': runs[False].get('peak_mem_gb'),
                                      'remat': runs[True]['peak_mem_gb']}}),
          flush=True)
    del batch
    _fresh()


def bench_sizes(args, kernels, card, result):
    """Phases 26-31 (the bench's own batch sizes); returns their
    seconds."""
    from nicr_mtsa_tpu_torch.pipeline import (emsaformer_bench_config,
                                              emsanet_bench_config)
    secs = {}
    _fresh()
    t0 = time.perf_counter()
    latency(card, result)
    secs['latency'] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, calls, _ = serve_exact(
        emsanet_bench_config(), BENCH_REQUESTS,
        dict.fromkeys(SERVING_KERNELS, 1), kernels, card, result,
        'serve_emsanet_bench', B=BENCH_SERVE_B['emsanet'],
        targets=_serving_targets(False))
    _fresh()
    check_bench_shapes('serve_emsanet', calls, result)
    del calls
    _fresh()
    serve_stream(args, kernels, card, result, 'stream_bench',
                 B=BENCH_STREAM_B, n_requests=BENCH_REQUESTS, checks=False)
    _fresh()
    _, calls, unchunked = serve_exact(
        emsaformer_bench_config(), BENCH_REQUESTS, SWIN_KERNELS, kernels,
        card, result, 'serve_swin_bench', B=BENCH_SERVE_B['swin'],
        targets=_serving_targets(True), keep_reference=True)
    _fresh()
    check_bench_shapes('serve_swin', calls, result)
    del calls
    _fresh()
    serve_exact(emsaformer_bench_config(model='emsaformer_dve'),
                args.swin_requests, SWIN_KERNELS, kernels, card, result,
                'serving_swin_v1')
    _fresh()
    serve_exact(emsanet_bench_config(quick=True), args.requests,
                QUICK_KERNELS, kernels, card, result, 'serving_quick')
    _fresh()
    secs['serve'] = time.perf_counter() - t0

    t0 = time.perf_counter()
    chunks = BENCH_SERVE_B['swin'] // ATTN_CHUNK
    serve_exact(emsaformer_bench_config(attn_chunk=ATTN_CHUNK),
                BENCH_REQUESTS,
                dict(SWIN_KERNELS, window_attention_block=12 * chunks),
                kernels, card, result, 'serve_swin_bench_chunked',
                B=BENCH_SERVE_B['swin'], reference_of=unchunked)
    del unchunked
    _fresh()
    result['serve_swin_bench_chunked']['unchunked_peak_mem_gb'] = \
        result['serve_swin_bench']['peak_mem_gb']
    print(json.dumps({'phase': 'attn_chunk', 'chunk': ATTN_CHUNK,
                      'peak_mem_gb': {
                          'chunked': result['serve_swin_bench_chunked'][
                              'peak_mem_gb'],
                          'unchunked': result['serve_swin_bench'][
                              'peak_mem_gb']}}), flush=True)
    secs['attn_chunk'] = time.perf_counter() - t0

    t0 = time.perf_counter()
    eval_bench(kernels, card, result)
    secs['eval'] = time.perf_counter() - t0

    t0 = time.perf_counter()
    train_bench(args, kernels, card, result, 'emsanet')
    train_bench(args, kernels, card, result, 'swin', capture=True)
    secs['train'] = time.perf_counter() - t0
    return secs


# --- phase 32: the training loop of examples/train_synthetic.py ----------

LOOP_HW = (480, 640)                  # the model's input size
LOOP_FRAMES = {'train': 16, 'valid': 8}
LOOP_B = 8
LOOP_EPOCHS = 3
LOOP_CKPT_METRICS = ('valid_semantic_miou', 'valid_panoptic_all_deeplab_pq')
# a validation step postprocesses and scores as the fused eval step does
LOOP_VALID_KERNELS = DATASET_EVAL_KERNELS
# rad a counted angle by which the card's and the CPU's angular-error sums
# may differ: each term is the angle of an f32 mean of an instance's
# biternions, summed in another order on the card, and a sum of small
# terms moves by more than 1e-5 of itself
LOOP_ANGLE_ATOL = 1e-5
PNG_FILTERS = ('None', 'Sub', 'Up', 'Average', 'Paeth')


def _loop_write_dataset(root):
    """16 train and 8 valid frames of the port's SyntheticRGBDDataset at
    twice the model's size in each axis (960 x 1280, as the JAX example
    builds its dataset), written by the port's `write_directory_dataset`.
    Returns the seconds each split took."""
    from nicr_mtsa_tpu_torch.data import (DatasetConfig, SemanticLabel,
                                          SemanticLabelList,
                                          write_directory_dataset)
    from nicr_mtsa_tpu_torch.examples.train_synthetic import IS_THING
    from nicr_mtsa_tpu_torch.testing import SyntheticRGBDDataset
    H, W = LOOP_HW
    synth = SyntheticRGBDDataset(n_samples=sum(LOOP_FRAMES.values()),
                                 height=2 * H, width=2 * W,
                                 n_classes_with_void=len(IS_THING))
    config = DatasetConfig(
        SemanticLabelList([SemanticLabel('void')] + [
            SemanticLabel(f'class{i}', is_thing=t, use_orientation=t)
            for i, t in enumerate(IS_THING) if i]),
        scene_label_list=tuple(f'scene{i}' for i in range(1, 6)))
    secs, start = {}, 0
    for split, n in LOOP_FRAMES.items():
        t0 = time.perf_counter()
        write_directory_dataset(root, split, [synth.raw(start + i)
                                              for i in range(n)], config)
        secs[split] = time.perf_counter() - t0
        start += n
    return secs


def _png_row_filters(root):
    """How many rows of the dataset's PNG files use each row filter."""
    import struct
    import zlib
    counts = dict.fromkeys(PNG_FILTERS, 0)
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith('.png'):
                continue
            with open(os.path.join(dirpath, name), 'rb') as f:
                data = f.read()
            pos, idat, header = 8, [], None
            while pos < len(data):
                n, kind = struct.unpack('>I4s', data[pos:pos + 8])
                body = data[pos + 8:pos + 8 + n]
                if kind == b'IHDR':
                    header = struct.unpack('>IIBB', body[:10])
                elif kind == b'IDAT':
                    idat.append(body)
                pos += 12 + n
            width, height, depth, colour = header
            row = 1 + width * (3 if colour == 2 else 1) * depth // 8
            raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
            kinds = raw.reshape(height, row)[:, 0]
            for k, c in zip(*np.unique(kinds, return_counts=True)):
                counts[PNG_FILTERS[k]] += int(c)
    return counts


def _loop_pipeline(dtype='bfloat16', seed=0, model=None):
    """The example's pipeline (`make_pipeline`) around the full-width
    `emsanet_train_config` with the example's heads (10 classes plus
    void, classes 1-3 things, 5 scenes), the model built on the card from
    `seed` unless given."""
    import dataclasses
    from nicr_mtsa_tpu_torch.examples.train_synthetic import (
        IS_THING, SCENE_N_CLASSES, make_pipeline)
    from nicr_mtsa_tpu_torch.models.multi_task import build_model
    from nicr_mtsa_tpu_torch.pipeline import emsanet_train_config
    cfg = dataclasses.replace(
        emsanet_train_config(LOOP_HW, dtype, n_classes=len(IS_THING) - 1),
        scene_n_classes=SCENE_N_CLASSES)
    if model is None:
        model = build_model(cfg, device='cuda', seed=seed, train=True)
    return make_pipeline(model, cfg)


def _eager_states(pipe):
    """The metric states the helpers' eager steps accumulated, with the
    instance helper's MAE against the GT instances."""
    states = {n: h._eager_states for n, h in pipe.task_helpers.items()}
    states['mae_gt'] = pipe.task_helpers['instance']._mae_gt.state
    return states


def _train_state_equal(a, b, where):
    for group in ('params', 'batch_stats'):
        for n, t in a[group].items():
            if not torch.equal(t, b[group][n]):
                fail(f'{where}: {group} {n} differs')
    for moments in ('mu', 'nu'):
        for n, t in getattr(a['opt_state'], moments).items():
            if not torch.equal(t, getattr(b['opt_state'], moments)[n]):
                fail(f'{where}: AdamW {moments} of {n} differs')
    if int(a['step']) != int(b['step']) \
            or int(a['opt_state'].count) != int(b['opt_state'].count):
        fail(f'{where}: step counts differ')


def _resumed_step(live, resumed, batch, generator, batch_idx, where):
    """The next training step of the live pipeline and of the one loaded
    from its checkpoint, on one batch from generators in one state, under
    deterministic cuDNN and algorithms: losses, parameters, statistics,
    AdamW moments, the DWA state and the generators bit-equal."""
    (pa, sa), (pb, sb) = live, resumed
    twin = torch.Generator('cuda')
    twin.set_state(generator.get_state())
    with _deterministic(algorithms=True):
        sa, la = pa.train_step(sa, batch, generator, batch_idx=batch_idx)
        sb, lb = pb.train_step(sb, batch, twin, batch_idx=batch_idx)
    bad = [k for k in la if not torch.equal(la[k], lb[k])]
    if bad:
        fail(f'{where}: losses {bad} differ after the resume')
    _train_state_equal(sa, sb, where)
    if pa.loss_weighting.state_dict() != pb.loss_weighting.state_dict():
        fail(f'{where}: the DWA state differs after the resume')
    if not torch.equal(generator.get_state(), twin.get_state()):
        fail(f'{where}: the generators differ after the resume')
    return sa, la


class _LoopWatch:
    """The pipeline as the example's epoch routines see it in phase 32.
    Each train step's DWA weights (as they stood before it) and losses
    are kept; the first step after a checkpoint is also taken by the
    pipeline loaded from it (`resume`), between syncs, its seconds kept
    apart; each validation step's batch and losses are kept. Everything
    else is the pipeline's."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.weights, self.losses, self.batches = [], [], []
        self.resume, self.resumed_s = None, 0.0
        self.last_batch = self.valid_losses = None

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def train_step(self, state, batch, generator, batch_idx=0):
        self.weights.append(dict(self.pipe.loss_weighting.weights))
        if self.resume is None:
            state, losses = self.pipe.train_step(state, batch, generator,
                                                 batch_idx=batch_idx)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, losses = _resumed_step(
                (self.pipe, state), self.resume, batch, generator,
                batch_idx, f'train_loop resume at step {len(self.losses)}')
            torch.cuda.synchronize()
            self.resumed_s += time.perf_counter() - t0
            self.resume = None
        self.losses.append(losses)
        self.last_batch = batch
        return state, losses

    def validation_step(self, batch, batch_idx=0):
        out = self.pipe.validation_step(batch, batch_idx)
        self.batches.append(batch)
        self.valid_losses = out[1]
        return out


def _loop_card_vs_cpu(root, state):
    """One f32 validation batch (the first 2 valid frames) on the card
    and, from the card's raw outputs, on the CPU: the eager helpers'
    states by phase 6's rule, the MAE against the GT instances included
    (its sums also within LOOP_ANGLE_ATOL a counted angle); the card's
    side with image 0's orientations opposite to its GT must fail that
    rule."""
    from nicr_mtsa_tpu_torch.data import (get_dataset, move_batch_to_device,
                                          mt_collate)
    from nicr_mtsa_tpu_torch.examples.train_synthetic import IS_THING
    from nicr_mtsa_tpu_torch.parallel import load_train_state
    ds = get_dataset(root, 'valid', preprocessor=_dataset_compose(
        IS_THING, *LOOP_HW))
    host = mt_collate([ds[i] for i in range(2)])
    pipe = _loop_pipeline('float32', seed=0)
    load_train_state(pipe.create_train_state(), state)
    batch = move_batch_to_device(host, device='cuda')
    pipe.model.eval()
    with torch.inference_mode():
        raw = pipe.model(pipe.model_inputs(batch))

    def states(raw_outputs, on_batch):
        """The eager helpers' states of one validation step on given
        raw outputs, in helpers of their own."""
        p = _loop_pipeline('float32', model=pipe.model)
        p.validate_outputs(raw_outputs, on_batch)
        return _eager_states(p)

    on_card = states(raw, batch)
    raw_cpu = {k: _to_cpu(v) for k, v in raw.items()}
    on_cpu = states(raw_cpu, move_batch_to_device(host, device='cpu'))
    diff = _states_equal(on_card, on_cpu, angle_atol=LOOP_ANGLE_ATOL)
    if diff:
        fail(f'train_loop card vs CPU: {diff}')
    # image 0's orientations opposite to its GT under the GT orientation
    # foreground: each of its GT instances reads the largest error, pi,
    # so the MAE's sum can only grow
    (heat, offset, ori), side = raw['instance']
    turned = ori.clone()
    turned[0] = torch.where(batch['orientation_foreground'][0],
                            -batch['orientation'][0], ori[0])
    faulty = dict(raw, instance=((heat, offset, turned), side))
    planted = _states_equal(states(faulty, batch), on_cpu,
                            angle_atol=LOOP_ANGLE_ATOL)
    if planted is None:
        fail('train_loop card vs CPU: the planted orientation fault was '
             'not caught')
    n_mae = int(on_cpu['mae_gt']['n_elements'])
    if n_mae == 0:
        fail('train_loop card vs CPU: no GT instance was scored by the '
             'MAE against the GT instances')
    return dict(states='equal', mae_gt_instances=n_mae,
                mae_gt_sum_rad=float(on_cpu['mae_gt']['sum_angular_error']),
                planted_fault_caught=planted)


def _loop_host_ms(ds, n=4):
    """Host ms a sample of the file read and of each preprocessing step,
    over the first `n` samples (augmentations from RandomState(i))."""
    compose, ds.preprocessor = ds.preprocessor, None
    ms = {'read': 0.0}
    n = min(n, len(ds))
    try:
        for i in range(n):
            t0 = time.perf_counter()
            sample = ds[i]
            ms['read'] += time.perf_counter() - t0
            rng = np.random.RandomState(i)
            for t in compose.transforms:
                t0 = time.perf_counter()
                sample = t(sample, rng=rng)
                name = type(t).__name__
                ms[name] = ms.get(name, 0.0) + time.perf_counter() - t0
    finally:
        ds.preprocessor = compose
    return {k: v * 1e3 / n for k, v in ms.items()}


def _loop_rates(epochs):
    """Host-inclusive frames/s of the train and the validation epochs,
    all and the last alone. A train epoch's steps after a checkpoint
    (taken twice, under deterministic algorithms) are left out with
    their seconds."""
    def rate(eps, kind):
        frames = sum(e[f'{kind}_steps'] for e in eps) * LOOP_B
        return frames / sum(e[f'{kind}_s'] for e in eps)
    return dict(train_frames_per_s=rate(epochs, 'train'),
                valid_frames_per_s=rate(epochs, 'valid'),
                train_frames_per_s_last_epoch=rate(epochs[-1:], 'train'),
                valid_frames_per_s_last_epoch=rate(epochs[-1:], 'valid'))


def train_loop(args, kernels, card, result):
    """Phase 32: the training loop of examples/train_synthetic.py on the
    card, from recorded frames, through the example's own routines
    (`train_epoch`, `validate`, `end_epoch`, `save_epoch`) with the
    phase's checks between them (see the module's docstring). Returns
    the launches of the last validation epoch."""
    import tempfile
    from nicr_mtsa_tpu_torch.data import DataLoader, get_dataset
    from nicr_mtsa_tpu_torch.data.preprocessing import (
        APPLIED_PREPROCESSING_KEY)
    from nicr_mtsa_tpu_torch.examples.train_synthetic import (
        DWA_KEYS, IS_THING, end_epoch, save_epoch, train_epoch,
        train_preprocessing, validate)
    from nicr_mtsa_tpu_torch.ops.cuda import intersection as it
    from nicr_mtsa_tpu_torch.ops.cuda import resize_reduce as rr
    from nicr_mtsa_tpu_torch.parallel import (load_checkpoint,
                                              train_state_dict)
    from nicr_mtsa_tpu_torch.pipeline import strip_non_arrays
    from nicr_mtsa_tpu_torch.postprocessing import semantic as sem_post
    from nicr_mtsa_tpu_torch.utils import CheckpointHelper, CSVLogger
    from nicr_mtsa_tpu_torch.weighting.dwa import dwa_weights
    # the model first: without a card this raises before any work
    pipe = _loop_pipeline()
    watch = _LoopWatch(pipe)
    state = pipe.create_train_state()
    out = {'card': card, 'batch': LOOP_B, 'epochs': LOOP_EPOCHS,
           'frames': dict(LOOP_FRAMES), 'model_hw': list(LOOP_HW),
           'frame_hw': [2 * LOOP_HW[0], 2 * LOOP_HW[1]]}
    _fresh()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, 'synthetic')
        out['write_s'] = _loop_write_dataset(root)
        out['png_row_filters'] = _png_row_filters(root)
        print(json.dumps({'phase': 'train_loop_data', **{
            k: out[k] for k in ('write_s', 'png_row_filters',
                                'frame_hw')}}), flush=True)
        train_ds = get_dataset(root, 'train',
                               preprocessor=train_preprocessing(*LOOP_HW))
        valid_ds = get_dataset(root, 'valid', preprocessor=_dataset_compose(
            IS_THING, *LOOP_HW))
        out['host_ms_a_sample'] = {'train': _loop_host_ms(train_ds),
                                   'valid': _loop_host_ms(valid_ds)}
        train_loader = DataLoader(train_ds, batch_size=LOOP_B,
                                  num_workers=2, drop_last=True, seed=0)
        valid_loader = DataLoader(valid_ds, batch_size=LOOP_B,
                                  num_workers=2)
        helper = CheckpointHelper(LOOP_CKPT_METRICS, debug=False)
        logger = CSVLogger(os.path.join(tmp, 'log.csv'))
        epochs = []
        for epoch in range(LOOP_EPOCHS):
            # --- train: loader -> prefetch -> the weighted step --------
            kernels.reset_launch_counts()
            n_steps, resumed_s = len(watch.losses), watch.resumed_s
            resuming = watch.resume is not None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, losses = train_epoch(watch, state, train_loader, epoch,
                                        'cuda')
            torch.cuda.synchronize()
            resumed_s = watch.resumed_s - resumed_s
            ep = dict(epoch=epoch,
                      train_steps=len(watch.losses) - n_steps - resuming,
                      train_s=time.perf_counter() - t0 - resumed_s,
                      resumed_step_s=resumed_s)
            if any(fn.launches for fn in kernels.KERNELS.values()):
                fail('train_loop: a training step launched a kernel '
                     'wrapper')
            # --- eager validation epoch --------------------------------
            watch.batches = []
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                # the fused step below must see the eager steps' outputs
                stack.enter_context(_deterministic())
                calls, maps = {}, []
                if epoch == 0:     # the kernels' first calls at new shapes
                    calls = stack.enter_context(_capture({
                        'resize_reduce': (sem_post,
                                          'crop_resize_argmax_score',
                                          _first_calls())}))
                    maps = stack.enter_context(_captured_slot_maps())
                validate(watch, valid_loader, 'cuda')
                torch.cuda.synchronize()
                batches, watch.batches = watch.batches, []
                ep.update(valid_steps=len(batches),
                          valid_s=time.perf_counter() - t0)
                launches = _check_launches(
                    kernels, LOOP_VALID_KERNELS, len(batches),
                    f'train_loop validation epoch {epoch}')
                eager = _eager_states(pipe)
                # the fused eval step on the same batches
                step = pipe.make_fused_eval_step(
                    {APPLIED_PREPROCESSING_KEY:
                     batches[0][APPLIED_PREPROCESSING_KEY]})
                fused = pipe.empty_metric_states()
                for b in batches:
                    _, _, fused = step(strip_non_arrays(b), fused)
            if epoch == 0:
                out['resize_reduce_2x_up'] = _check_loop_resize(
                    rr, calls['resize_reduce'][0])
                # the validation step's two calls (the fused step's
                # follow within the capture)
                out['intersection_fullres'] = _check_loop_intersection(
                    it, maps[:2])
            del calls, maps
            diff = _states_equal(
                {k: v for k, v in eager.items() if k != 'mae_gt'}, fused)
            if diff:
                fail(f'train_loop epoch {epoch}: eager validation against '
                     f'the fused step: {diff}')
            bad = [k for k, v in watch.valid_losses.items()
                   if not bool(torch.isfinite(v))]
            if bad:
                fail(f'train_loop: validation losses not finite: {bad}')
            last_valid = batches[-1]
            del batches, eager, fused
            logs, to_save = end_epoch(watch, epoch,
                                      float(losses['total_loss']), helper,
                                      logger)
            _metrics_in_range({k[6:]: v for k, v in logs.items()
                               if k.startswith('valid_')
                               and not k.endswith('_time')}, 'train_loop')
            ep.update(to_save=sorted(to_save),
                      weights=dict(pipe.loss_weighting.weights),
                      metrics={k: logs[k] for k in (
                          'valid_semantic_miou',
                          'valid_panoptic_all_deeplab_pq',
                          'valid_orientation_mae_gt_deg')})
            if to_save:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path = save_epoch(pipe, state, epoch, tmp)
                ep['save_ms'] = (time.perf_counter() - t0) * 1e3
                ep['checkpoint_mb'] = os.path.getsize(path) / 1e6
                fresh = _loop_pipeline(seed=1)
                t0 = time.perf_counter()
                fresh_state, extra = load_checkpoint(
                    path, fresh.create_train_state())
                torch.cuda.synchronize()
                ep['load_ms'] = (time.perf_counter() - t0) * 1e3
                if extra['epoch'] != epoch:
                    fail('train_loop: the checkpoint lost its epoch')
                fresh.loss_weighting.load_state_dict(extra['dwa'])
                _train_state_equal(state, fresh_state,
                                   f'train_loop checkpoint {epoch}')
                watch.resume = (fresh, fresh_state)
            epochs.append(ep)
            print(json.dumps({'phase': 'train_loop_epoch', **ep}),
                  flush=True)
        if watch.resume is not None:
            # the last checkpoint: one more step of both
            state, _ = _resumed_step(
                (pipe, state), watch.resume, watch.last_batch,
                torch.Generator('cuda').manual_seed(LOOP_EPOCHS * 1000), 0,
                'train_loop resume after the loop')
            watch.resume = None
        logger.write()
        atexit.unregister(logger.write)      # its directory goes below
        with open(os.path.join(tmp, 'log.csv')) as f:
            out['log_rows'] = len(f.read().strip().splitlines()) - 1
        out['card_vs_cpu'] = _loop_card_vs_cpu(root, train_state_dict(state))
    # --- gates on the weighting and the losses -------------------------
    recorded = [{k: float(v) for k, v in losses.items()}
                for losses in watch.losses]
    bad = [(i, k) for i, r in enumerate(recorded) for k, v in r.items()
           if not np.isfinite(v)]
    if bad:
        fail(f'train_loop: losses not finite: {bad[:5]}')
    steps = len(recorded) // LOOP_EPOCHS
    used = watch.weights
    unit = [i for i, w in enumerate(used[:-1])
            if set(w.values()) != {1.0}]
    if unit:
        fail(f'train_loop: DWA weights other than 1 at steps {unit}')
    means = [{k: float(np.mean([r[k] for r in recorded[e * steps:
                                                       (e + 1) * steps]]))
              for k in DWA_KEYS} for e in range(2)]
    want = dwa_weights(means[1], means[0], DWA_KEYS, 2.0)
    got = used[-1]
    if set(got.values()) == {1.0} or abs(sum(got.values()) - 5) > 1e-9 \
            or any(abs(got[k] - want[k]) > 1e-12 for k in want):
        fail(f'train_loop: the 6th step used the DWA weights {got}, '
             f'expected {want}')
    out.update(
        epochs=epochs, checkpoints=[e['epoch'] for e in epochs
                                    if e['to_save']],
        dwa_weights_step6=got, losses_first=recorded[0],
        losses_last=recorded[-1], **_loop_rates(epochs),
        launches_per_validation_step=launches, peak_mem_gb=_peak_gb(),
        resumed_bit_equal=True, eager_equals_fused=True)
    result['train_loop'] = out
    print(json.dumps({'phase': 'train_loop', **{
        k: v for k, v in out.items()
        if k not in ('epochs', 'losses_first', 'losses_last')}}),
        flush=True)
    last_batch = watch.last_batch
    if args.profile:
        profile(lambda: pipe.train_step(
            state, last_batch, torch.Generator('cuda').manual_seed(0)),
            result, 'train_loop_step')
        profile(lambda: pipe.validation_step(last_valid), result,
                'train_loop_validation_step')
        pipe.validation_epoch_end()
    del pipe, watch, state, last_batch, last_valid
    _fresh()
    return launches


def _check_loop_intersection(it, maps):
    """Row 11 on the slot maps the loop's first validation step passed it
    (the instance and the panoptic helper's: two (8, 1228800) pairs at
    the 960 x 1280 ground truth, 129 x 129 bins): exact against the
    plain version and torch.bincount, timed with its plan and bound."""
    H, W = 2 * LOOP_HW[0], 2 * LOOP_HW[1]
    got = [(tuple(a.shape), n_gt, n_pred) for a, _, n_gt, n_pred in maps]
    if got != [((LOOP_B, H * W), 128, 128)] * 2:
        fail(f'train_loop: the validation step passed row 11 {got}, '
             f'expected two ({LOOP_B}, {H * W}) pairs of 129 x 129 bins')
    out = {}
    for i, (a, b, n_gt, n_pred) in enumerate(maps):
        plan = _same_counts(it, f'train_loop map {i}', a, b, n_gt, n_pred)
        b_ms, b_by = bound(2 * a.numel() * 4 + LOOP_B * 129 * 129 * 4,
                           2 * a.numel())
        out[f'map{i}'] = dict(
            call=f'({LOOP_B}, {H * W}) int32 slot maps, 129 x 129 bins',
            max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by, plan=plan,
            **_timed(lambda: it.intersection_matrix_kernel(a, b, n_gt,
                                                           n_pred),
                     lambda: it.intersection_matrix_reference(a, b, n_gt,
                                                              n_pred),
                     lambda: _bincount(a, b, n_gt, n_pred)))
        print(json.dumps({'phase': 'kernel_train_loop',
                          'name': f'intersection_map{i}', **out[f'map{i}']}),
              flush=True)
    return out


def _check_loop_resize(rr, call, phase='kernel_train_loop',
                       name='resize_reduce_2x_up'):
    """Row 5's first call of the loop's validation (the 2x upscale of
    (8, 10, 480, 640) bf16 to the 960 x 1280 ground truth, a plan no
    other phase makes), or another `call`, against its plain version:
    idx exact, scores within rtol 1e-5; timed with its plan and bound,
    printed under `phase` and `name`."""
    from nicr_mtsa_tpu_torch.models.upsampling import two_tap_params
    (x, crop, OH, OW), kwargs = call
    B, C, h, w = x.shape
    err = _same(f'{phase} {name}',
                rr.crop_resize_argmax_score(x, crop, OH, OW),
                rr.crop_resize_argmax_score_reference(x, crop, OH, OW))
    in_h = crop[0].stop - crop[0].start
    in_w = crop[1].stop - crop[1].start
    rows = len(np.unique(np.concatenate(two_tap_params(in_h, OH)[:2])))
    cols = len(np.unique(np.concatenate(two_tap_params(in_w, OW)[:2])))
    P_out = B * OH * OW
    b_ms, b_by = bound(B * rows * cols * C * x.element_size() + P_out * 8,
                       _reduce_ops(P_out * C, P_out, 9))
    plan = rr._plan(B, C, in_h, OH, in_w, OW, x.dtype,
                    torch.cuda.current_device())
    row = dict(call=f'{tuple(x.shape)} {x.dtype} {_layout(x)} -> {OH} x '
                    f'{OW}', max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
               plan=plan._asdict(),
               **_timed(lambda: rr.crop_resize_argmax_score(x, crop, OH, OW),
                        lambda: rr.crop_resize_argmax_score_reference(
                            x, crop, OH, OW)))
    print(json.dumps({'phase': phase, 'name': name, **row}), flush=True)
    return row


# --- phases 33-34: surface normals and the rest of the model surface ------

# phase 34: the serving variants of the dense model surface, each on
# `emsanet_bench_config()` with these fields replaced, and the wrappers
# each launches once a request (every other wrapper none): the
# learned-3x3 and nearest heads cannot be deferred, so the score/argmax
# reduce (row 6) serves them in place of the 4x finisher
SURFACE_VARIANTS = {
    'resnet34_d16_none': dict(backbone_rgb='resnet34-d16',
                              backbone_depth='resnet34-d16',
                              context_module='none'),
    'resnet18se': dict(backbone_rgb='resnet18se', backbone_depth='resnet18se'),
    'learned_3x3': dict(upsampling='learned-3x3',
                        prediction_upsampling='learned-3x3',
                        defer_semantic_prediction_upsampling=False),
    'nearest': dict(upsampling='nearest', prediction_upsampling='nearest',
                    defer_semantic_prediction_upsampling=False),
    'ln': dict(normalization='ln'),
    'embedding': dict(tasks=('semantic', 'instance', 'orientation', 'scene',
                             'dense_visual_embedding')),
}
# 2x ResNet-50 (bottleneck) with the adaptive PPM (phase 34 (a))
R50_APPM = dict(backbone_rgb='resnet50', backbone_depth='resnet50',
                context_module='appm')
# requests a timed round of each variant, and at 960 x 1280
SURFACE_REQUESTS = 1
LARGE_HW, LARGE_REQUESTS = (960, 1280), 2


def _with_normals(cfg):
    return dataclasses.replace(cfg, tasks=tuple(cfg.tasks) + ('normal',))


def _unit_length_err(n):
    return float((torch.linalg.vector_norm(n.float(), dim=1) - 1.0)
                 .abs().max())


def _serving_want(kernels, *names):
    """Every wrapper of the port: 1 launch a request for `names`, 0 for
    the others."""
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(dict.fromkeys(names, 1))
    return want


def _eager_equals_fused(pipe, batch, names, key):
    """The eager `validation_step`s of the helpers `names` on the fused
    step's raw outputs of `batch` accumulate the fused states (phase 6's
    rule at atol 0); the eager states are dropped after. Returns the
    example images the helpers stored."""
    with torch.inference_mode():
        raw = pipe.model(pipe.model_inputs(batch))
        _, _, fused = pipe.evaluate_outputs(raw, batch,
                                            pipe.empty_metric_states())
        helpers = {n: pipe.task_helpers[n] for n in names}
        keys = set()
        for h in helpers.values():
            keys.update(h.prediction_keys, h.validation_keys)
        post = pipe.postprocess_outputs(raw, batch, frozenset(keys))
        for h in helpers.values():
            h.validation_step(batch, 0, post)
    eager = {n: h._eager_states for n, h in helpers.items()}
    diff = _states_equal(eager, {n: fused[n] for n in names})
    examples = {}
    for h in helpers.values():
        examples.update(h.validation_epoch_end()[1])
    if diff:
        fail(f'{key}: eager states differ from the fused step: {diff}')
    return examples


def normals(args, kernels, card, result):
    """Phase 33 (see the module's docstring). Returns the launches of
    its serving, eval and training paths."""
    from nicr_mtsa_tpu_torch.pipeline import (build_eval_pipeline,
                                              emsanet_bench_config,
                                              emsanet_train_config)
    from nicr_mtsa_tpu_torch.testing import (build_eval_batch,
                                             build_train_batch)
    paths, found = {}, {}

    def unit(out):
        n = out['normal_output']
        if tuple(n.shape) != (8, 3, 480, 640) or \
                not bool(torch.isfinite(n).all()):
            fail(f'normal_output: {tuple(n.shape)} or not finite')
        found['unit_length_err'] = _unit_length_err(n)
        if not found['unit_length_err'] <= NORMAL_UNIT_TOL:
            fail(f'normals {found["unit_length_err"]} off unit length')

    paths['serve_normals'] = serve_exact(
        _with_normals(emsanet_bench_config()), args.requests,
        _serving_want(kernels, *SERVING_KERNELS), kernels, card, result,
        'serving_normals', args.profile, extra_output_tasks=('normal',),
        check_out=unit)[0]
    beside = {k: {m: result[k][m] for m in ('frames_per_s', 'peak_mem_gb')}
              for k in ('serving', 'serving_normals') if k in result}
    result['serving_normals'].update(found, beside_phase_3=beside)
    print(json.dumps({'phase': 'serving_normals_beside_phase_3', **beside,
                      **found, 'card': card}), flush=True)
    card_vs_cpu(result, _with_normals(emsanet_bench_config(dtype='float32')),
                'normals_card_vs_cpu', frame_seed=7,
                extra_output_tasks=('normal',))

    # the fused eval step with the normal helper
    B = 8
    pipe = build_eval_pipeline(_with_normals(emsanet_bench_config(
        defer=False)), device='cuda', seed=0)
    eb = build_eval_batch(B, (480, 640), (512, 512), 40, IS_THING, seed=0,
                          device='cuda', normals=True)
    _fresh()
    step = pipe.make_fused_eval_step(eb.static_batch)
    _, losses, states = step(eb.batch, pipe.empty_metric_states())
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            _, losses, states = step(eb.batch, states)
        int(states['normal']['n_elements'])
        rounds.append(B * args.steps / (time.perf_counter() - t0))
    paths['eval_normals'] = _check_launches(
        kernels, NORMAL_EVAL_KERNELS, 3 * args.steps, 'eval_normals')
    bad = [k for k, v in losses.items() if not bool(torch.isfinite(v))]
    if bad or 'normal_total_loss' not in losses:
        fail(f'eval_normals: losses not finite {bad} or no normal loss')
    pipe.load_metric_states(states)
    _, _, logs = pipe.validation_epoch_end()
    metrics = {k: float(logs[k]) for k in EVAL_LOG_KEYS}
    _metrics_in_range(metrics, 'eval_normals')
    rmse = float(logs['normal_rmse'])
    if not 0.0 < rmse <= 2.0:
        fail(f'eval_normals: normal_rmse {rmse} not in (0, 2]')
    result['eval_normals'] = dict(
        batch=B, steps_per_round=args.steps, rounds_frames_per_s=rounds,
        frames_per_s=float(np.median(rounds)), card=card,
        beside_phase_5=result.get('eval', {}).get('frames_per_s'),
        normal_rmse=rmse,
        metrics=metrics, peak_mem_gb=_peak_gb(),
        launches_per_step={k: c / (3 * args.steps)
                           for k, c in paths['eval_normals'].items() if c})
    print(json.dumps({'phase': 'eval_normals', **result['eval_normals']}),
          flush=True)
    _eager_equals_fused(pipe, dict(eb.batch, **eb.static_batch),
                        ('semantic', 'scene', 'normal'), 'eval_normals')
    eval_card_vs_cpu(pipe, result, 'eval_normals_card_vs_cpu', normals=True)
    del pipe, step, eb, states

    # training with the normal task and the side outputs' targets
    cfg = _with_normals(emsanet_train_config())
    batch = build_train_batch(B, 480, 640, seed=0, device='cuda',
                              rgbd=False, normals=True,
                              downscales=NORMAL_DOWNSCALES)
    paths['train_normals'] = train(
        args, kernels, card, result, 'train_normals', cfg,
        dict.fromkeys(kernels.KERNELS, EMSANET_TRAIN_LAUNCHES), batch=batch,
        profile_it=False)[0]
    if not any(k.startswith('normal_loss_down_')
               for k in result['train_normals']['losses']):
        fail('train_normals: no side-output loss of the normal task')
    del batch
    _fresh()
    hw = NORMAL_TRAIN_CPU_HW
    train_card_vs_cpu(result, hw=hw,
                      cfg=_with_normals(emsanet_train_config(hw, 'float64')),
                      faults=NORMAL_TRAIN_FAULTS,
                      key='normal_train_card_vs_cpu',
                      grad_floor=NORMAL_GRAD_FLOOR)
    return paths


def model_surface(args, kernels, card, result):
    """Phase 34 (see the module's docstring). Returns the launches of
    its serving paths."""
    from nicr_mtsa_tpu_torch.pipeline import (build_serving_pipeline,
                                              build_train_pipeline,
                                              emsanet_bench_config,
                                              emsanet_train_config)
    from nicr_mtsa_tpu_torch.testing import build_train_batch
    paths = {}
    cfg = dataclasses.replace(emsanet_bench_config(), **R50_APPM)
    paths['serve_r50_appm'], calls, _ = serve_exact(
        cfg, args.requests, _serving_want(kernels, *SERVING_KERNELS),
        kernels, card, result, 'serving_r50_appm', args.profile,
        targets=_serving_targets(False))
    check_bench_shapes('serving_r50_appm', calls, result)
    del calls
    card_vs_cpu(result, dataclasses.replace(
        emsanet_bench_config(dtype='float32'), **R50_APPM),
        'r50_appm_card_vs_cpu', frame_seed=8)

    # a request at twice the training size: the APPM bins doubled
    B, (H, W) = 8, LARGE_HW
    _fresh()
    pipe = build_serving_pipeline(cfg, device='cuda', seed=0)
    rgb, depth = (torch.from_numpy(a).cuda() for a in frames(B, H, W))
    cm = pipe.model.context_module
    seen = []
    handle = cm.register_forward_hook(lambda m, i, o: seen.append(
        [tuple(t.shape[-2:]) for t in o[1]]))
    out = pipe(rgb, depth)
    handle.remove()
    check_outputs(out, B, H, W, 40)
    h_ctx, w_ctx = H // 32, W // 32
    mh = int(h_ctx / cm.input_size[0] + 0.5)
    mw = int(w_ctx / cm.input_size[1] + 0.5)
    want_bins = [(b * mh, b * mw) for b in cm.bins]
    if (mh, mw) != (2, 2) or seen[0] != want_bins:
        fail(f'r50_appm at {H} x {W}: branches {seen[0]}, expected '
             f'{want_bins} (multiplier {mh}, {mw})')
    # rows 1 and 2 at this request's shapes: against their plain
    # versions, and timed (the card's time alone, `stream_ms`; the plain
    # version between events), row 1 beside its bound
    with _capture(_serving_targets(False)) as calls:
        pipe(rgb, depth)
    check_bench_shapes('serving_r50_appm_960', calls, result)
    timing = {}
    for row, (fn, plain, _, _, forced) in _bench_rows().items():
        if row in calls:
            a, kw = calls[row][0]
            kw = dict(kw, **forced)
            timing[row] = dict(
                shape=list(a[0].shape),
                stream_ms=stream_ms(lambda: fn(*a, **kw)),
                plain_ms=cuda_ms(lambda: plain(*a, **kw)))
    timing['finisher4x']['bound_ms'], timing['finisher4x']['bound_by'] = \
        _finisher_bound(calls['finisher4x'][0][0][0])
    # row 2's bound by phase 2's formula: the offsets, the mask and the
    # ids moved once, 6 operations a foreground pixel and valid centre
    off, _, ok, fg = calls['grouping'][0][0][:4]
    n_px = off[0, 0].numel()
    timing['grouping']['bound_ms'], timing['grouping']['bound_by'] = bound(
        off.numel() * off.element_size() + off.shape[0] * n_px * (1 + 4)
        + ok.numel() * 9,
        6 * int((fg.reshape(fg.shape[0], -1).sum(1) * ok.sum(1)).sum()))
    del calls
    # the peak of the requests alone, not of the plain versions above
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(LARGE_REQUESTS):
        out = pipe(rgb, depth)
    int(out['panoptic'][0, 0, 0])
    fps = B * LARGE_REQUESTS / (time.perf_counter() - t0)
    _check_launches(kernels, _serving_want(kernels, *SERVING_KERNELS),
                    LARGE_REQUESTS, 'r50_appm_960')
    result['serving_r50_appm_960'] = dict(
        batch=B, size=[H, W], appm_bins=seen[0], frames_per_s=fps,
        peak_mem_gb=_peak_gb(), kernels=timing, card=card)
    print(json.dumps({'phase': 'serving_r50_appm_960',
                      **result['serving_r50_appm_960']}), flush=True)
    del pipe, rgb, depth, out

    # one training step of the same model at B=8
    _fresh()
    pipe = build_train_pipeline(dataclasses.replace(
        emsanet_train_config(), **R50_APPM), device='cuda', seed=0)
    batch = build_train_batch(B, 480, 640, seed=0, device='cuda',
                              rgbd=False)
    state = pipe.create_train_state()
    gen = torch.Generator(device='cuda').manual_seed(1)
    step_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, losses = pipe.train_step(state, batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    losses = {k: float(v) for k, v in losses.items()}
    if not all(np.isfinite(v) for v in losses.values()):
        fail(f'train_r50_appm: losses not finite {losses}')
    result['train_r50_appm'] = dict(
        batch=B, step_ms=step_ms, frames_per_s=B * 1e3 / step_ms[-1],
        total_loss=losses['total_loss'], peak_mem_gb=_peak_gb(), card=card)
    print(json.dumps({'phase': 'train_r50_appm',
                      **result['train_r50_appm']}), flush=True)
    del pipe, batch, state

    # one request a round of each variant, its kernel calls checked
    from nicr_mtsa_tpu_torch.postprocessing import semantic as sem_post
    for name, fields in SURFACE_VARIANTS.items():
        cfg = dataclasses.replace(emsanet_bench_config(), **fields)
        deferred = cfg.defer_semantic_prediction_upsampling == 'all'
        row = 'finisher4x' if deferred else 'semantic_reduce'
        targets = _serving_targets(False)
        if not deferred:
            del targets['finisher4x']
            targets['semantic_reduce'] = (sem_post, 'semantic_argmax_score',
                                          _first_calls())
        extra = (('dense_visual_embedding',) if name == 'embedding'
                 else ())
        found = {}

        def embedding(out):
            e = out['dense_visual_embedding_output']
            found['embedding_shape'] = list(e.shape)
            if tuple(e.shape) != (8, 512, 480, 640) or \
                    not bool(torch.isfinite(e).all()):
                fail(f'{name}: embedding {tuple(e.shape)} or not finite')

        _fresh()
        paths[f'serve_{name}'], calls, _ = serve_exact(
            cfg, SURFACE_REQUESTS, _serving_want(kernels, row, 'grouping'),
            kernels, card, result, f'surface_{name}', targets=targets,
            extra_output_tasks=extra,
            check_out=embedding if extra else None)
        check_bench_shapes(f'surface_{name}', calls, result)
        result[f'surface_{name}'].update(found)
        del calls
    return paths


# --- phases 35-38: the outputs of the eval path, the host extras and the
# examples ------------------------------------------------------------------

# phase 35: a fused eval step with the dense panoptic scores and the
# debug branches launches the bench's eval kernels and one grouping more
# (debug branch i-2's all-foreground segmentation)
OUTPUTS_EVAL_KERNELS = dict(EVAL_KERNELS, grouping=3)
SCORE_KEYS = tuple(f'panoptic_segmentation_deeplab_{k}_score'
                   for k in ('semantic', 'instance', 'panoptic'))
# the example images every helper of phase 35's eager step stores
EXAMPLE_KEYS = (
    'semantic_example_batch_idx_0_0', 'semantic_example_batch_score_0_0',
    'instance_center_heatmap_example_batch_0_0',
    'instance_offset_example_batch_0_0',
    'instance_predicted_centers_example_batch_0_0',
    'instance_instance_example_batch_0_0', 'orientation_example_batch_0_0',
    'panoptic_example_batch_deeplab_0_0',
    'panoptic_example_batch_deeplab_semantic_0_0',
    'panoptic_example_batch_deeplab_instance_0_0',
    *(f'panoptic_example_batch_deeplab_{k}_score_0_0'
      for k in ('semantic', 'instance', 'panoptic')))
# phase 36: the ground truth of the deferred head's full-resolution keys
DEFERRED_GT_HW = (960, 1280)
DEFERRED_VARIANTS = {'defer4x': ('all', 'finisher4x'),
                     'no_defer4x': (True, 'finisher2x')}
# phase 37: the class the fixture frames' mapper folds into void, the
# embeddings' width and seed
MAPPED_CLASS = 4
DVE_DIM = 512
CKPT_STEPS, CKPT_KEEP = 3, 2


def _fixture_batch(compose, B=8):
    """B fixture `valid` frames (cycled) through `compose`, collated on
    the host."""
    from nicr_mtsa_tpu_torch.data import get_dataset, mt_collate
    ds = get_dataset(FIXTURE, split='valid')
    return mt_collate([compose(ds[i % len(ds)]) for i in range(B)])


def _write_examples(examples, key):
    """Each example image written by `write_png` under
    chiprun_out/examples/<key>/ and read back equal."""
    from nicr_mtsa_tpu_torch.data.png import read_png, write_png
    out = os.path.join('chiprun_out', 'examples', key)
    os.makedirs(out, exist_ok=True)
    for name, img in examples.items():
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
            fail(f'{key}: example {name} is {img.dtype} {img.shape}')
        path = os.path.join(out, f'{name}.png')
        write_png(path, img)
        if not np.array_equal(read_png(path), img):
            fail(f'{key}: example {name} read back differs')
    return out


def eval_outputs(args, kernels, card, result):
    """Phase 35 (see the module's docstring). Returns the launches of
    its fused and eager eval paths."""
    from nicr_mtsa_tpu_torch.data import move_batch_to_device
    from nicr_mtsa_tpu_torch.data.fullres import APPLIED_PREPROCESSING_KEY
    from nicr_mtsa_tpu_torch.pipeline import (build_eval_pipeline,
                                              emsanet_bench_config)
    from nicr_mtsa_tpu_torch.testing import build_eval_batch
    opts = dict(compute_scores=True, debug=True, store_examples=True)
    paths, B = {}, 8
    pipe = build_eval_pipeline(device='cuda', seed=0, **opts)
    _fresh()
    eb = build_eval_batch(B, (480, 640), (512, 512), 40, IS_THING, seed=0,
                          segment_table_size=128, device='cuda')
    step = pipe.make_fused_eval_step(eb.static_batch, output_keys=SCORE_KEYS)
    preds, losses, states = step(eb.batch, pipe.empty_metric_states())
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            preds, losses, states = step(eb.batch, states)
        int(states['semantic'][0, 0])
        rounds.append(B * args.steps / (time.perf_counter() - t0))
    paths['eval_outputs'] = _check_launches(
        kernels, OUTPUTS_EVAL_KERNELS, 3 * args.steps, 'eval_outputs')
    score_range = {}
    for k in SCORE_KEYS:
        s = preds[k]
        lo, hi = float(s.min()), float(s.max())
        if tuple(s.shape) != (B, 480, 640) or \
                not bool(torch.isfinite(s).all()) or lo < 0 or hi > 1:
            fail(f'eval_outputs: {k} {tuple(s.shape)} in [{lo}, {hi}]')
        score_range[k] = (lo, hi)
    bad = [k for k, v in losses.items() if not bool(torch.isfinite(v))]
    if bad:
        fail(f'eval_outputs: losses not finite: {bad}')
    pipe.load_metric_states(states)
    _, _, logs = pipe.validation_epoch_end()
    metrics = {k: float(logs[k]) for k in EVAL_LOG_KEYS}
    _metrics_in_range(metrics, 'eval_outputs')
    fps = float(np.median(rounds))
    result['eval_outputs'] = dict(
        batch=B, steps_per_round=args.steps, rounds_frames_per_s=rounds,
        frames_per_s=fps, card=card, score_range=score_range,
        beside_phase_5=result.get('eval', {}).get('frames_per_s'),
        peak_mem_gb=_peak_gb(), metrics=metrics,
        launches_per_step={k: c / (3 * args.steps)
                           for k, c in paths['eval_outputs'].items() if c})
    print(json.dumps({'phase': 'eval_outputs', **result['eval_outputs']}),
          flush=True)
    del pipe, step, eb, states, preds
    _outputs_card_vs_cpu(result, opts)

    # the eager step on the fixture's frames (their per-sample dicts),
    # every helper storing its example images
    _fresh()
    ds_is_thing = _fixture()[1]
    pipe = build_eval_pipeline(
        emsanet_bench_config(n_classes=len(ds_is_thing), defer=False),
        device='cuda', seed=0, is_thing=ds_is_thing, **opts)
    host = _fixture_batch(_dataset_compose((False,) + ds_is_thing), B)
    batch = dict(move_batch_to_device(host, 'cuda'),
                 **{APPLIED_PREPROCESSING_KEY:
                    host[APPLIED_PREPROCESSING_KEY]})
    kernels.reset_launch_counts()
    examples = _eager_equals_fused(pipe, batch, tuple(pipe.task_helpers),
                                   'eval_outputs_eager')
    # the fused and the eager postprocessing of one batch
    paths['eval_outputs_eager'] = _check_launches(
        kernels, OUTPUTS_EVAL_KERNELS, 2, 'eval_outputs_eager')
    if sorted(examples) != sorted(EXAMPLE_KEYS):
        fail(f'eval_outputs_eager: examples {sorted(examples)}')
    out = _write_examples(examples, 'eval_outputs')
    result['eval_outputs'].update(examples=len(examples), examples_dir=out)
    print(json.dumps({'phase': 'eval_outputs_eager', 'states': 'equal',
                      'examples': len(examples), 'written_to': out}),
          flush=True)
    return paths


def _outputs_card_vs_cpu(result, opts):
    """The f32 eval model's raw outputs (B=2) postprocessed with the
    scores and the debug branches on the card and, copied, on the CPU:
    the panoptic ids and the all-foreground segmentation agree on at
    least PANOPTIC_MATCH_MIN of the pixels, the three score maps within
    rtol 1e-5 where the ids agree."""
    from nicr_mtsa_tpu_torch.pipeline import (build_eval_pipeline,
                                              emsanet_bench_config)
    from nicr_mtsa_tpu_torch.testing import build_eval_batch
    key = 'eval_outputs_card_vs_cpu'
    pipe = build_eval_pipeline(
        emsanet_bench_config(dtype='float32', defer=False), device='cuda',
        seed=0, **opts)
    eb = build_eval_batch(2, (480, 640), (512, 512), 40, IS_THING, seed=1,
                          device='cuda')
    batch = dict(eb.batch, **eb.static_batch)
    maps = ('panoptic_segmentation_deeplab',
            'instance_segmentation_all_foreground')
    keys = frozenset(SCORE_KEYS + maps)
    with torch.inference_mode():
        raw = pipe.model(pipe.model_inputs(batch))
        card_out = pipe.postprocess_outputs(raw, batch, keys)
        cpu_out = pipe.postprocess_outputs(
            {k: _to_cpu(v) for k, v in raw.items()},
            {k: _to_cpu(v) for k, v in batch.items()}, keys)
    found = {}
    for k in maps:
        found[f'{k}_agree'] = float(
            (card_out[k].cpu() == cpu_out[k]).float().mean())
        if found[f'{k}_agree'] < PANOPTIC_MATCH_MIN:
            fail(f'{key}: {k} agrees on {found[f"{k}_agree"]}')
    agree = card_out[maps[0]].cpu() == cpu_out[maps[0]]
    for k in SCORE_KEYS:
        a, b = card_out[k].cpu()[agree], cpu_out[k][agree]
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
            fail(f'{key}: {k} differs by {float((a - b).abs().max())}')
        found[f'{k}_max_abs_diff'] = float((a - b).abs().max())
    result[key] = found
    print(json.dumps({'phase': key, **found}), flush=True)


def deferred_fullres(args, kernels, card, result):
    """Phase 36 (see the module's docstring). Returns the launches of
    each variant's postprocessing."""
    from nicr_mtsa_tpu_torch.data.fullres import resize_provenance
    from nicr_mtsa_tpu_torch.models.upsampling import (
        apply_deferred_upsampling_exact)
    from nicr_mtsa_tpu_torch.ops.cuda import resize_reduce as rr
    from nicr_mtsa_tpu_torch.pipeline import (build_serving_pipeline,
                                              emsanet_bench_config)
    from nicr_mtsa_tpu_torch.postprocessing import SemanticPostprocessing
    paths, B = {}, 8
    keys = frozenset(('semantic_segmentation_idx',
                      'semantic_segmentation_score',
                      'semantic_segmentation_idx_fullres',
                      'semantic_segmentation_score_fullres'))
    for variant, (defer, finisher) in DEFERRED_VARIANTS.items():
        key = f'deferred_fullres_{variant}'
        pipe = build_serving_pipeline(emsanet_bench_config(defer=defer),
                                      device='cuda', seed=0)
        _fresh()
        batch = dict(resize_provenance(480, 640),
                     semantic_fullres=torch.zeros(
                         (B,) + DEFERRED_GT_HW, dtype=torch.int32,
                         device='cuda'))
        rgb, depth = (torch.from_numpy(a).cuda() for a in frames(B))
        post = SemanticPostprocessing()
        with torch.inference_mode():
            pred = pipe.model(pipe.preprocess(rgb, depth),
                              outputs=('semantic',))['semantic']
            post.postprocess(pred, batch, keys=keys)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = post.postprocess(pred, batch, keys=keys)
            torch.cuda.synchronize()
            post_ms = (time.perf_counter() - t0) * 1e3
            paths[key] = _check_launches(
                kernels, {finisher: 1, 'resize_reduce': 1}, 1, key)
            exact = apply_deferred_upsampling_exact(pred[0])
            if exact.dtype != torch.bfloat16:
                fail(f'{key}: the exact logits are {exact.dtype}')
            top2 = exact.topk(2, dim=1).values
            ties = int((top2[:, 0] == top2[:, 1]).sum())
            n_diff = int((exact.argmax(dim=1)
                          != out['semantic_segmentation_idx']).sum())
            if n_diff:
                fail(f'{key}: the finisher idx differs from the argmax of '
                     f'the exact logits at {n_diff} pixels')
            crop = (slice(0, 480), slice(0, 640))
            row = _check_loop_resize(
                rr, ((exact, crop) + DEFERRED_GT_HW, {}), phase=key,
                name='resize_reduce_deferred_fullres')
            full = rr.crop_resize_argmax_score(exact, crop, *DEFERRED_GT_HW)
            if not torch.equal(full[0],
                               out['semantic_segmentation_idx_fullres']):
                fail(f'{key}: the full-resolution idx is not row 5 on the '
                     f'exact logits')
        result[key] = dict(tie_pixels=ties, tie_share=ties / exact[:, 0]
                           .numel(), postprocess_ms=post_ms, card=card,
                           peak_mem_gb=_peak_gb(), row5=row,
                           launches={k: c for k, c in paths[key].items()
                                     if c})
        print(json.dumps({'phase': key, **{k: v for k, v in result[
            key].items() if k != 'row5'}}), flush=True)
        del pipe, pred, out, exact, top2, full
    return paths


def _hflip(stack):
    return stack[:, ::-1]


def _segment_embeddings(sample, **kwargs):
    """Seeded synthetic DVE inputs for a sample: an image embedding and
    one embedding a panoptic id (void left out), D = DVE_DIM."""
    ids = [int(i) for i in np.unique(sample['panoptic']) if i != 0]
    rng = np.random.default_rng(sum(ids) % 2 ** 32)
    sample['image_embedding'] = rng.normal(size=DVE_DIM).astype(np.float32)
    sample['panoptic_embedding'] = {
        i: rng.normal(size=DVE_DIM).astype(np.float32) for i in ids}
    return sample


def dve_host(args, kernels, card, result):
    """Phase 37 (see the module's docstring). Returns the launches of
    the DVE eval's fused and eager postprocessing."""
    from nicr_mtsa_tpu_torch.data import get_dataset, move_batch_to_device
    from nicr_mtsa_tpu_torch.data import preprocessing as p
    from nicr_mtsa_tpu_torch.data.fullres import APPLIED_PREPROCESSING_KEY
    from nicr_mtsa_tpu_torch.pipeline import (build_eval_pipeline,
                                              emsaformer_eval_config)
    from nicr_mtsa_tpu_torch.tasks.dense_visual_embedding import (
        pad_embedding_luts)
    from nicr_mtsa_tpu_torch.testing import dve_tables
    key, B = 'dve_host', 8
    ds = get_dataset(FIXTURE, split='valid')
    is_thing = ds.config.semantic_label_list_without_void.classes_is_thing
    n = len(is_thing)
    cfg = dataclasses.replace(emsaformer_eval_config(), semantic_n_classes=n)
    _, text, visual_mean = dve_tables(n, DVE_DIM)
    pipe = build_eval_pipeline(cfg, device='cuda', seed=0, is_thing=is_thing,
                               dve_tables=(text, visual_mean))
    _fresh()

    # the host transforms on the recorded frames
    frame = ds[0]
    for kind, n_crops in (('five', 5), ('ten', 10)):
        s = p.TransformWrapper(lambda x: x, final_crop=(kind, 64, 96))(
            {k: v.copy() if isinstance(v, np.ndarray) else v
             for k, v in frame.items()})
        if s['semantic'].shape != (n_crops, 64, 96) or not np.array_equal(
                s['semantic'][0], frame['semantic'][:64, :96]):
            fail(f'{key}: {kind}-crop gives {s["semantic"].shape}')
    base = _dataset_compose((False,) + is_thing).transforms
    compose = p.Compose(
        [p.SemanticClassMapper((MAPPED_CLASS,), new_label=0),
         p.TransformWrapper(_hflip)] + base[:7]
        + [_segment_embeddings, p.DenseVisualEmbeddingTargetGenerator()]
        + base[7:])
    t0 = time.perf_counter()
    host = _fixture_batch(compose, B)
    host_ms = (time.perf_counter() - t0) * 1e3 / B
    mapped = sum(int(e.get('mapped_pixels', {}).get(MAPPED_CLASS, 0))
                 for entries in host[APPLIED_PREPROCESSING_KEY]
                 for e in entries)
    if not mapped or (host['semantic_fullres'] == MAPPED_CLASS).any():
        fail(f'{key}: class {MAPPED_CLASS} was not mapped ({mapped} px)')
    luts = list(host['dense_visual_embedding_lut'])
    if not all(np.allclose(np.linalg.norm(t, axis=1), 1.0, rtol=1e-5)
               for t in luts):
        fail(f'{key}: LUT rows not unit length')
    host['dense_visual_embedding_lut'] = pad_embedding_luts(luts, DVE_DIM)
    batch = dict(move_batch_to_device(host, 'cuda'),
                 **{APPLIED_PREPROCESSING_KEY:
                    host[APPLIED_PREPROCESSING_KEY]})
    valid = float((batch['dense_visual_embedding_indices'] != 0)
                  .float().mean())
    if not valid:
        fail(f'{key}: no pixel has a DVE target')
    kernels.reset_launch_counts()
    _eager_equals_fused(pipe, batch, tuple(pipe.task_helpers), key)
    launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
    with torch.inference_mode():
        raw = pipe.model(pipe.model_inputs(batch))
        _, losses, states = pipe.evaluate_outputs(
            raw, batch, pipe.empty_metric_states())
    dve_loss = float(losses['dense_visual_embedding_total_loss'])
    if not np.isfinite(dve_loss):
        fail(f'{key}: DVE loss {dve_loss}')
    found = dict(host_ms_a_sample=host_ms, mapped_pixels=mapped,
                 dve_valid_share=valid, dve_loss=dve_loss,
                 peak_mem_gb=_peak_gb(), card=card)
    del pipe, raw, batch
    found.update(_step_checkpoints(key))
    result[key] = found
    print(json.dumps({'phase': key, 'states': 'eager equal fused',
                      **found}), flush=True)
    return {key: launches}


def _step_checkpoints(key):
    """`emsanet_train_config()`'s train state (B=8) saved by a
    `StepCheckpointManager` after each of CKPT_STEPS steps with
    `max_to_keep=CKPT_KEEP`, restored into a pipeline of another seed:
    the next step bit-equal under deterministic algorithms."""
    import tempfile
    from nicr_mtsa_tpu_torch.parallel import StepCheckpointManager
    from nicr_mtsa_tpu_torch.pipeline import (build_train_pipeline,
                                              emsanet_train_config)
    from nicr_mtsa_tpu_torch.testing import build_train_batch
    _fresh()
    cfg = emsanet_train_config()
    batch = build_train_batch(8, 480, 640, seed=0, device='cuda', rgbd=False)
    live = build_train_pipeline(cfg, device='cuda', seed=0)
    state = live.create_train_state()
    save_ms = []
    with tempfile.TemporaryDirectory() as tmp, _deterministic(True):
        mgr = StepCheckpointManager(tmp, max_to_keep=CKPT_KEEP)
        for i in range(CKPT_STEPS):
            g = torch.Generator('cuda').manual_seed(i)
            state, _ = live.train_step(state, batch, g)
            t0 = time.perf_counter()
            mgr.save(int(state['step']), state, extra={'step': i})
            save_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        mgr.wait_until_finished()
        wait_ms = (time.perf_counter() - t0) * 1e3
        kept = sorted(int(f.split('.')[0][5:]) for f in os.listdir(tmp))
        if kept != list(range(CKPT_STEPS - CKPT_KEEP + 1, CKPT_STEPS + 1)):
            fail(f'{key}: kept steps {kept}')
        mb = os.path.getsize(os.path.join(tmp, f'step_{CKPT_STEPS}.pt')) / 1e6
        other = build_train_pipeline(cfg, device='cuda', seed=1)
        t0 = time.perf_counter()
        resumed, extra = mgr.restore(target=other.create_train_state())
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
    if extra != {'step': CKPT_STEPS - 1}:
        fail(f'{key}: extra {extra}')
    _train_state_equal(state, resumed, f'{key} restored')
    g = torch.Generator('cuda').manual_seed(CKPT_STEPS)
    twin = torch.Generator('cuda').manual_seed(CKPT_STEPS)
    with _deterministic(True):
        state, la = live.train_step(state, batch, g)
        resumed, lb = other.train_step(resumed, batch, twin)
    bad = [k for k in la if not torch.equal(la[k], lb[k])]
    if bad:
        fail(f'{key}: losses {bad} differ after the resume')
    _train_state_equal(state, resumed, f'{key} resumed step')
    return dict(checkpoint_mb=mb, save_ms=save_ms, wait_ms=wait_ms,
                load_ms=load_ms, kept_steps=kept)


def examples_on_card(args, card, result):
    """Phase 38 (see the module's docstring)."""
    import tempfile
    from nicr_mtsa_tpu_torch.data.png import read_png
    key, found = 'examples', {}
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in (
                ('infer_panoptic', ['--out', tmp]),
                ('eval_dataset', ['--dataset', FIXTURE])):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, '-m',
                 f'nicr_mtsa_tpu_torch.examples.{name}', *argv], cwd=root,
                capture_output=True, text=True, timeout=600)
            found[f'{name}_seconds'] = time.perf_counter() - t0
            if res.returncode != 0:
                fail(f'{key}: {name} exited {res.returncode}: '
                     f'{res.stderr[-2000:]}')
            found[f'{name}_stdout'] = res.stdout
        for png in ('panoptic.png', 'semantic.png', 'depth.png'):
            img = read_png(os.path.join(tmp, png))
            if img.shape != (128, 160, 3) or img.dtype != np.uint8:
                fail(f'{key}: {png} decodes to {img.dtype} {img.shape}')
    metrics = {}
    for line in found['eval_dataset_stdout'].splitlines():
        if line.startswith('  ') and ':' in line:
            k, v = line.split(':')
            metrics[k.strip()] = float(v)
    for k in ('semantic_miou', 'panoptic_all_deeplab_pq',
              'instance_all_deeplab_pq', 'scene_acc'):
        if k not in metrics or not np.isfinite(metrics[k]):
            fail(f'{key}: eval_dataset printed {k} = {metrics.get(k)}')
    _metrics_in_range(metrics, key)
    found.update(metrics=metrics, card=card)
    found['infer_panoptic_stdout'] = found['infer_panoptic_stdout'][-1500:]
    del found['eval_dataset_stdout']
    result[key] = found
    print(json.dumps({'phase': key, **{k: v for k, v in found.items()
                                        if not k.endswith('stdout')}}),
          flush=True)



# phase 39: a seeded torchvision-layout ResNet-34 (basic blocks) grafted
# into both encoders of `emsanet-bench` with basic blocks, and the
# ImageNet classifier on that backbone: B=8 at 224 x 224, f32, its
# logits card vs CPU within CLASSIFIER_TOL of the largest |logit|
PRETRAINED_SEED = 39
CLASSIFIER_B, CLASSIFIER_HW, CLASSIFIER_CLASSES = 8, (224, 224), 1000
CLASSIFIER_TOL = 1e-4
# phase 40: Swin-T v1 from a seeded torchvision-layout state dict, B=8 at
# 224 x 224, f32; its launches of a forward (the sub-block once a block;
# the LayerNorm of the patch embed, two a block, three mergings, the
# last norm; every other wrapper none), and the stage outputs card vs
# CPU within SWIN_STAGE_TOL of each stage's max |out| (12 stacked
# blocks, each kernel call held to 1e-4 by phase 7's rule)
PRETRAINED_SWIN_KERNELS = {'window_attention_block': 12, 'layernorm': 29}
SWIN_STAGE_TOL = 1e-3
# phase 41: recorded frames with surface normals at twice the model's
# size (phase 32's), NORMAL_LOOP_STEPS training steps at LOOP_B and one
# validation step
NORMAL_LOOP_FRAMES = {'train': 24, 'valid': 8}
NORMAL_LOOP_STEPS = 3
# the planted fault (image 0's normal targets negated) must move the
# validation's normal loss by this share of it at least, and by 100
# times its rerun spread: the frames' normals are smooth fields
# (`_smooth_normals`), so the move follows how far the barely trained
# predictions lean along them (on an H100 at 700 W 5.9e-3 and 2.4e-2
# of the loss in two runs, the spread 0 in both; on the CPU at
# 96 x 128, f32, untrained: 0.18)
NORMAL_FAULT_MIN = 1e-3
# ... and the normal helper's loss on the same batch with the
# predictions set to the targets at every scale must be 0 (it reads
# each image's targets at the right scale and sign), image 0's targets
# negated at least NORMAL_ORACLE_MIN: then that image alone contributes
# 2 |n|_1 / 3 a valid pixel (the L1 is a mean over the 3 channels;
# |n|_1 is 1 to sqrt(3)), over LOOP_B images' valid pixels, 1/12 to
# 1/7 of one (0.124 on an H100, 0.123 on the CPU at 96 x 128)
NORMAL_ORACLE_MIN = 0.05


def _named_tensors(module):
    out = dict(module.named_parameters())
    out.update(module.named_buffers())
    return out


def _pretrained_files(tmp):
    """The seeded ResNet-34 (basic blocks) in torchvision's layout, with
    its `fc` head, `num_batches_tracked` buffers and a `module.`-prefixed
    copy of one weight (other values; the mapping reads no such key),
    saved as `<tmp>/pretrained/resnet34.pth` (read through
    $MTSA_PRETRAINED_DIR) and `<tmp>/depth.pth` (through
    `checkpoint_path`). Returns (the state dict, the directory, the
    file)."""
    from nicr_mtsa_tpu_torch.testing.torchvision_state import (
        resnet_state_dict)
    sd = resnet_state_dict((3, 4, 6, 3), seed=PRETRAINED_SEED)
    sd['module.layer1.0.conv1.weight'] = -sd['layer1.0.conv1.weight']
    directory = os.path.join(tmp, 'pretrained')
    os.makedirs(directory)
    path = os.path.join(tmp, 'depth.pth')
    torch.save(sd, os.path.join(directory, 'resnet34.pth'))
    torch.save(sd, path)
    return sd, directory, path


def _graft(rgb, depth, sd, gates):
    """A `prepare` for serve_exact / card_vs_cpu: grafts the two loaded
    backbones into the pipeline's model; every grafted tensor must equal
    the loaded one bit for bit, the depth stem the checkpoint's kernel
    summed over its input channels, every other tensor keep its value.
    Appends each graft's counts to `gates`."""
    from nicr_mtsa_tpu_torch.utils.pretrained import merge_backbone_variables

    def prepare(pipe):
        model = pipe.model
        before = {k: v.detach().clone()
                  for k, v in _named_tensors(model).items()}
        for where, state in (('backbone_rgb', rgb),
                             ('backbone_depth', depth)):
            merge_backbone_variables(model, state, ('encoder', where))
        after = _named_tensors(model)
        grafted = set()
        for where, state in (('backbone_rgb', rgb),
                             ('backbone_depth', depth)):
            for k, v in state.items():
                name = f'encoder.{where}.{k}'
                if not torch.equal(after[name].detach().cpu(), v):
                    fail(f'pretrained: {name} is not the checkpoint tensor')
                grafted.add(name)
        stem = after['encoder.backbone_depth.conv1.weight'].detach().cpu()
        if not torch.equal(stem, sd['conv1.weight'].sum(1, keepdim=True)):
            fail('pretrained: the depth stem is not the summed RGB kernel')
        moved = [k for k, v in before.items()
                 if k not in grafted and not torch.equal(after[k], v)]
        if moved:
            fail(f'pretrained: tensors outside the graft changed: '
                 f'{moved[:5]}')
        gates.append(dict(device=str(pipe.device), grafted=len(grafted),
                          kept=len(before) - len(grafted)))
    return prepare


def _imagenet_classifier(rgb):
    """The ImageNet classifier on the grafted ResNet-34, f32, on the
    card and on the CPU: logits within CLASSIFIER_TOL of the largest
    |logit|, the card's forward timed."""
    from nicr_mtsa_tpu_torch.models.backbones import get_backbone
    from nicr_mtsa_tpu_torch.models.backbones.pretraining import (
        ImageNetClassifier)
    from nicr_mtsa_tpu_torch.utils.pretrained import merge_backbone_variables
    g = torch.Generator().manual_seed(PRETRAINED_SEED)
    cpu = ImageNetClassifier(
        get_backbone('resnet34', resnet_block='basicblock', generator=g),
        CLASSIFIER_CLASSES, generator=g).eval()
    merge_backbone_variables(cpu, rgb, ('backbone',))
    with torch.no_grad():
        cpu.fc.bias.normal_(0.0, 0.1, generator=g)
    card = ImageNetClassifier(
        get_backbone('resnet34', resnet_block='basicblock'),
        CLASSIFIER_CLASSES).eval()
    card.load_state_dict(cpu.state_dict())
    card = card.cuda()
    H, W = CLASSIFIER_HW
    x = torch.randn(CLASSIFIER_B, 3, H, W, generator=g)
    with torch.no_grad():
        want = cpu(x)
        xc = x.cuda()
        got = card(xc).cpu()
        ms = cuda_ms(lambda: card(xc))
    if tuple(got.shape) != (CLASSIFIER_B, CLASSIFIER_CLASSES) or \
            not bool(torch.isfinite(got).all()):
        fail(f'imagenet classifier: logits {tuple(got.shape)} or not finite')
    err = float((got - want).abs().max() / want.abs().max())
    top1 = float((got.argmax(1) == want.argmax(1)).float().mean())
    if not err <= CLASSIFIER_TOL:
        fail(f'imagenet classifier: card vs CPU {err} x max |logit| > '
             f'{CLASSIFIER_TOL}')
    return dict(batch=CLASSIFIER_B, hw=list(CLASSIFIER_HW),
                n_classes=CLASSIFIER_CLASSES, max_err_share=err,
                top1_agreement=top1, ms=ms,
                max_abs_logit=float(want.abs().max()))


def pretrained(args, kernels, card, result):
    """Phase 39 (see the module's docstring). Returns the launches of its
    serving path."""
    import tempfile
    from nicr_mtsa_tpu_torch.pipeline import emsanet_bench_config
    from nicr_mtsa_tpu_torch.utils.device import resolve_device
    from nicr_mtsa_tpu_torch.utils.pretrained import load_pretrained_backbone
    resolve_device('cuda')          # without a card this raises first
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        sd, directory, path = _pretrained_files(tmp)
        saved = os.environ.get('MTSA_PRETRAINED_DIR')
        os.environ['MTSA_PRETRAINED_DIR'] = directory
        try:
            rgb = load_pretrained_backbone('resnet34', 3)
        finally:
            if saved is None:
                del os.environ['MTSA_PRETRAINED_DIR']
            else:
                os.environ['MTSA_PRETRAINED_DIR'] = saved
        depth = load_pretrained_backbone('resnet34', 1, checkpoint_path=path)
    if torch.equal(rgb['layer1_block0.conv1.weight'],
                   sd['module.layer1.0.conv1.weight']):
        fail('pretrained: the module.-prefixed copy was read')
    gates = []
    prepare = _graft(rgb, depth, sd, gates)
    cfg = dataclasses.replace(emsanet_bench_config(),
                              resnet_block='basicblock')
    launches = serve_exact(
        cfg, args.requests, dict.fromkeys(SERVING_KERNELS, 1), kernels,
        card, result, 'serving_pretrained', prepare=prepare)[0]
    beside = {k: result[k]['frames_per_s']
              for k in ('serving', 'serving_pretrained') if k in result}
    print(json.dumps({'phase': 'serving_pretrained_beside_phase_3',
                      'frames_per_s': beside, 'card': card}), flush=True)
    card_vs_cpu(result, dataclasses.replace(cfg, dtype='float32'),
                'pretrained_card_vs_cpu', frame_seed=9, prepare=prepare)
    classifier = _imagenet_classifier(rgb)
    out = dict(graft=gates, classifier=classifier, card=card,
               frames_per_s_beside_phase_3=beside,
               seconds=time.perf_counter() - t_start)
    result['pretrained'] = out
    print(json.dumps({'phase': 'pretrained', **out}), flush=True)
    # serve_exact held every other wrapper at 0 launches
    full = dict.fromkeys(kernels.KERNELS, 0)
    full.update(launches)
    return {'serving_pretrained': full}


def _swin_stages(bb, x):
    outs, y = [], x
    for i in range(bb.n_stages):
        y = bb.forward_stage(i, y)
        outs.append(y)
    return outs


def pretrained_swin(args, kernels, card, result):
    """Phase 40 (see the module's docstring). Returns the launches of its
    forward."""
    import tempfile
    from nicr_mtsa_tpu_torch.models.backbones import get_backbone
    from nicr_mtsa_tpu_torch.testing.torchvision_state import swin_state_dict
    from nicr_mtsa_tpu_torch.utils.pretrained import (
        load_pretrained_backbone, merge_backbone_variables)
    from nicr_mtsa_tpu_torch.utils.device import resolve_device
    resolve_device('cuda')          # without a card this raises first
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'swin_t.pth')
        torch.save(swin_state_dict(seed=PRETRAINED_SEED + 1,
                                   prefix='_orig_mod.'), path)
        state = load_pretrained_backbone('swin-t', 3, checkpoint_path=path)
    cpu = get_backbone('swin-t', stochastic_depth=0.0).eval()
    merge_backbone_variables(cpu, state, path=())
    bb = get_backbone('swin-t', stochastic_depth=0.0).eval()
    bb.load_state_dict(cpu.state_dict())
    bb = bb.cuda()
    H, W = CLASSIFIER_HW
    x = torch.randn(CLASSIFIER_B, 3, H, W,
                    generator=torch.Generator().manual_seed(40))
    xc = x.cuda()
    targets = {k: v for k, v in _serving_targets(swin=True).items()
               if k in PRETRAINED_SWIN_KERNELS}
    with torch.no_grad():
        _swin_stages(bb, xc)                     # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with _capture(targets) as calls:
            got = [o.cpu() for o in _swin_stages(bb, xc)]
        launches = _check_launches(kernels, PRETRAINED_SWIN_KERNELS, 1,
                                   'pretrained_swin')
        want = _swin_stages(cpu, x)
        ms = cuda_ms(lambda: _swin_stages(bb, xc))
    errs = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            fail(f'pretrained_swin: stage {i} {tuple(g.shape)} or not '
                 f'finite')
        errs.append(_rel_err(g, w))
        if not errs[-1] <= SWIN_STAGE_TOL:
            fail(f'pretrained_swin: stage {i} card vs CPU {errs[-1]} x max '
                 f'|out| > {SWIN_STAGE_TOL}')
    checked = check_bench_shapes('pretrained_swin', calls, result)
    out = dict(batch=CLASSIFIER_B, hw=list(CLASSIFIER_HW),
               stage_err_share=errs, forward_ms=ms, card=card,
               launches={k: c for k, c in launches.items() if c},
               kernel_calls_checked=sorted(checked),
               seconds=time.perf_counter() - t_start)
    result['pretrained_swin'] = out
    print(json.dumps({'phase': 'pretrained_swin', **out}), flush=True)
    return {'pretrained_swin': launches}


def _smooth_normals(rng, H, W):
    """(H, W, 3) f32 unit normals of one frame: a seeded direction near
    the camera's axis (z > 0: the visible surfaces of a frame face the
    camera), tilted linearly across the image as a curved surface's,
    with NORMAL_INVALID_SHARE of the pixels all zero. A field, not
    noise: the predictions of even an untrained model lean to one
    direction over an image, so negating the field moves its L1 term by
    a share of order one."""
    from nicr_mtsa_tpu_torch.testing.batch import NORMAL_INVALID_SHARE
    base = np.array([*(0.4 * rng.normal(size=2)), 1.0])
    tilt = 0.3 * rng.normal(size=(2, 3))
    n = (base / np.linalg.norm(base)
         + np.linspace(-1.0, 1.0, H)[:, None, None] * tilt[0]
         + np.linspace(-1.0, 1.0, W)[None, :, None] * tilt[1])
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    n[rng.random((H, W)) < NORMAL_INVALID_SHARE] = 0.0
    return n


def _normal_frames_write(root):
    """NORMAL_LOOP_FRAMES frames of the port's SyntheticRGBDDataset at
    twice the model's size in each axis (as phase 32's), each with a
    seeded smooth normal field (`_smooth_normals`; f32, stored as .npy
    beside the PNG maps), as a directory dataset."""
    from nicr_mtsa_tpu_torch.data import (DatasetConfig, SemanticLabel,
                                          SemanticLabelList,
                                          write_directory_dataset)
    from nicr_mtsa_tpu_torch.examples.train_synthetic import IS_THING
    from nicr_mtsa_tpu_torch.testing import SyntheticRGBDDataset
    H, W = 2 * LOOP_HW[0], 2 * LOOP_HW[1]
    synth = SyntheticRGBDDataset(n_samples=sum(NORMAL_LOOP_FRAMES.values()),
                                 height=H, width=W,
                                 n_classes_with_void=len(IS_THING))
    config = DatasetConfig(
        SemanticLabelList([SemanticLabel('void')] + [
            SemanticLabel(f'class{i}', is_thing=t, use_orientation=t)
            for i, t in enumerate(IS_THING) if i]),
        scene_label_list=tuple(f'scene{i}' for i in range(1, 6)))
    start = 0
    for split, n in NORMAL_LOOP_FRAMES.items():
        samples = []
        for i in range(start, start + n):
            s = synth.raw(i)
            s['normal'] = _smooth_normals(np.random.default_rng(4100 + i),
                                          H, W)
            samples.append(s)
        write_directory_dataset(root, split, samples, config)
        start += n


def _negate_normals(batch, b=0):
    """The batch with image `b`'s normal targets negated, at every
    scale."""
    out = dict(batch)
    for key, value in batch.items():
        if key == 'normal':
            t = value.clone()
            t[b] = -t[b]
            out[key] = t
        elif key.startswith('_down_') and 'normal' in value:
            out[key] = _negate_normals(value, b)
    return out


def _normal_oracle_loss(pipe, batch, targets):
    """The normal helper's total loss on `targets` (a batch) with the
    predictions set to `batch`'s own normal targets at every scale."""
    side = [v['normal'] for k, v in batch.items()
            if k.startswith('_down_') and 'normal' in v]
    post = {'normal_output': batch['normal'], 'normal_side_outputs': side}
    return float(pipe.task_helpers['normal'].compute_losses(
        targets, post)['normal_total_loss'])


def train_normals_frames(args, kernels, card, result):
    """Phase 41 (see the module's docstring). Returns the launches of its
    validation step."""
    import tempfile
    from nicr_mtsa_tpu_torch.data import DataLoader, get_dataset
    from nicr_mtsa_tpu_torch.data.dataset import DEFAULT_SAMPLE_KEYS
    from nicr_mtsa_tpu_torch.examples.train_synthetic import (
        IS_THING, SCENE_N_CLASSES, make_pipeline, train_epoch,
        train_preprocessing, validate)
    from nicr_mtsa_tpu_torch.models.multi_task import build_model
    from nicr_mtsa_tpu_torch.pipeline import emsanet_train_config
    t_start = time.perf_counter()
    cfg = _with_normals(dataclasses.replace(
        emsanet_train_config(LOOP_HW, 'bfloat16',
                             n_classes=len(IS_THING) - 1),
        scene_n_classes=SCENE_N_CLASSES))
    # the model first: without a card this raises before any work
    pipe = make_pipeline(build_model(cfg, device='cuda', seed=0,
                                     train=True), cfg)
    watch = _LoopWatch(pipe)
    state = pipe.create_train_state()
    keys = DEFAULT_SAMPLE_KEYS + ('normal',)
    _fresh()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, 'synthetic')
        t0 = time.perf_counter()
        _normal_frames_write(root)
        write_s = time.perf_counter() - t0
        train_ds = get_dataset(root, 'train', sample_keys=keys,
                               preprocessor=train_preprocessing(
                                   *LOOP_HW, normals=True))
        valid_ds = get_dataset(root, 'valid', sample_keys=keys,
                               preprocessor=_dataset_compose(
                                   IS_THING, *LOOP_HW, normals=True))
        train_loader = DataLoader(train_ds, batch_size=LOOP_B,
                                  num_workers=2, drop_last=True, seed=0)
        valid_loader = DataLoader(valid_ds, batch_size=LOOP_B,
                                  num_workers=2)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = train_epoch(watch, state, train_loader, 0, 'cuda')
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        if len(watch.losses) != NORMAL_LOOP_STEPS:
            fail(f'train_normals_frames: {len(watch.losses)} steps, '
                 f'expected {NORMAL_LOOP_STEPS}')
        if any(fn.launches for fn in kernels.KERNELS.values()):
            fail('train_normals_frames: a training step launched a kernel '
                 'wrapper')
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        validate(watch, valid_loader, 'cuda')
        torch.cuda.synchronize()
        valid_s = time.perf_counter() - t0
        launches = _check_launches(kernels, LOOP_VALID_KERNELS,
                                   len(watch.batches),
                                   'train_normals_frames validation')
    _, _, logs = pipe.validation_epoch_end()
    recorded = [{k: float(v) for k, v in losses.items()}
                for losses in watch.losses]
    bad = [(i, k) for i, r in enumerate(recorded) for k, v in r.items()
           if not np.isfinite(v)]
    bad += [k for k, v in watch.valid_losses.items()
            if not bool(torch.isfinite(v))]
    if bad:
        fail(f'train_normals_frames: losses not finite: {bad[:5]}')
    normal_keys = sorted(k for k in recorded[-1] if k.startswith('normal_'))
    if 'normal_total_loss' not in normal_keys or not any(
            k.startswith('normal_loss_down_') for k in normal_keys):
        fail(f'train_normals_frames: normal losses {normal_keys}')
    rmse = float(logs['normal_rmse'])
    if not 0.0 < rmse <= 2.0:
        fail(f'train_normals_frames: normal_rmse {rmse} not in (0, 2]')
    # a planted fault in the targets: image 0's normals negated must move
    # the normal loss by more than NORMAL_FAULT_MIN of it and 100 times
    # what the clean batch's loss moves between two runs
    batch = watch.batches[-1]
    loss = {}
    for name, b in (('clean', batch), ('clean_again', batch),
                    ('negated', _negate_normals(batch))):
        loss[name] = float(pipe.validation_step(b)[1]['normal_total_loss'])
    pipe.validation_epoch_end()
    noise = abs(loss['clean_again'] - loss['clean'])
    moved = abs(loss['negated'] - loss['clean'])
    if not moved > max(100 * noise, NORMAL_FAULT_MIN * abs(loss['clean'])):
        fail(f'train_normals_frames: negated normal targets moved the loss '
             f'by {moved} only: {loss}')
    oracle = {'clean': _normal_oracle_loss(pipe, batch, batch),
              'negated': _normal_oracle_loss(pipe, batch,
                                             _negate_normals(batch))}
    if not (oracle['clean'] == 0.0
            and oracle['negated'] >= NORMAL_ORACLE_MIN):
        fail(f'train_normals_frames: the normal loss of predictions equal '
             f'to the targets is {oracle}')
    out = dict(batch=LOOP_B, frames=dict(NORMAL_LOOP_FRAMES),
               model_hw=list(LOOP_HW),
               frame_hw=[2 * LOOP_HW[0], 2 * LOOP_HW[1]], steps=len(recorded),
               write_s=write_s, train_s=train_s, valid_s=valid_s,
               train_frames_per_s=LOOP_B * len(recorded) / train_s,
               normal_losses_last={k: recorded[-1][k] for k in normal_keys},
               normal_rmse=rmse, planted_fault_loss=loss,
               planted_fault_share=moved / abs(loss['clean']),
               oracle_loss=oracle,
               launches_per_validation_step={
                   k: c for k, c in launches.items() if c},
               peak_mem_gb=_peak_gb(), card=card,
               seconds=time.perf_counter() - t_start)
    result['train_normals_frames'] = out
    print(json.dumps({'phase': 'train_normals_frames', **out}), flush=True)
    del pipe, watch, state, batch
    _fresh()
    return {'train_normals_frames': launches}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--requests', type=int, default=10,
                    help='EMSANet requests per timed round (3 rounds), '
                         'for each of its two serving variants and the '
                         'stream of host frames')
    ap.add_argument('--swin-requests', type=int, default=5,
                    help='Swin requests per timed round (3 rounds), for '
                         'each of its two serving variants')
    ap.add_argument('--steps', type=int, default=5,
                    help='eval steps per timed round (3 rounds), for '
                         'the synthetic and the dataset batch, and '
                         'batches per round of the dataset host path')
    ap.add_argument('--swin-steps', type=int, default=3,
                    help='Swin eval steps per timed round (3 rounds)')
    ap.add_argument('--train-steps', type=int, default=3,
                    help='training steps per timed round (3 rounds), for '
                         'each of the two families')
    ap.add_argument('--profile', action='store_true',
                    help='also trace 3 requests of each serving path, '
                         '3 eval steps and 3 training steps of each '
                         'family, 3 dataset batches through the host path, '
                         '3 streamed requests and 3 training and 3 '
                         'validation steps of the training loop with '
                         'torch.profiler')
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false')
    card = card_line()
    print(card, flush=True)
    t_start = time.perf_counter()

    from nicr_mtsa_tpu_torch.ops import cuda as kernels
    from nicr_mtsa_tpu_torch.ops.cuda import (_build, finisher2x, finisher4x,
                                              grouping, intersection,
                                              layernorm, resize_reduce,
                                              semantic_reduce,
                                              window_attention,
                                              window_attention_core,
                                              window_attention_qkv)
    from nicr_mtsa_tpu_torch.pipeline import (emsaformer_bench_config,
                                              emsanet_bench_config,
                                              emsanet_train_config)
    build_s = kernels.build_all()
    print(json.dumps({'phase': 'build', 'seconds': build_s}), flush=True)
    from nicr_mtsa_tpu_torch import native
    t0 = time.perf_counter()
    try:
        native_lib = str(native.build())
        native.load()
    except RuntimeError as e:
        fail(f'the native preprocessing library did not build: {e}')
    native_s = time.perf_counter() - t0
    print(json.dumps({'phase': 'build_native', 'seconds': native_s,
                      'library': os.path.basename(native_lib)}), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    report = {}
    result = {'card': card, 'torch': torch.__version__,
              'cuda': torch.version.cuda, 'build_s': build_s,
              'build_native_s': native_s,
              'ptxas': dict(_build.BUILD_LOGS)}
    kernel_resources(_build, result)
    check_finisher(finisher4x, report, _build)
    check_grouping(grouping, report, _build)
    check_semantic_reduce(semantic_reduce, report, _build)
    check_resize_reduce(resize_reduce, report, _build)
    result['resize_reduce_f32'] = report['resize_reduce_f32']
    check_intersection(intersection, report, _build)
    data_s = {'build_native': native_s}
    t0 = time.perf_counter()
    check_dataset_kernels(resize_reduce, semantic_reduce, intersection,
                          result, _build)
    data_s['kernel_dataset'] = time.perf_counter() - t0
    check_ties()
    launches = serve_exact(
        emsanet_bench_config(), args.requests,
        dict.fromkeys(SERVING_KERNELS, 1), kernels, card, result, 'serving',
        args.profile)[0]
    card_vs_cpu(result, emsanet_bench_config(dtype='float32'),
                'card_vs_cpu', frame_seed=3)
    eval_launches, pipe, eval_maps = evaluate(args, kernels, card, result)
    check_intersection_eval(intersection, eval_maps)
    del eval_maps
    eval_card_vs_cpu(pipe, result)
    del pipe
    check_window_attention(window_attention, report, result)
    check_layernorm(layernorm, report, _build)
    check_finisher_bilinear(finisher4x, report, _build)
    swin_launches = serve_exact(
        emsaformer_bench_config(), args.swin_requests, SWIN_KERNELS, kernels,
        card, result, 'serving_swin', args.profile)[0]
    card_vs_cpu(result, emsaformer_bench_config(dtype='float32'),
                'swin_card_vs_cpu', frame_seed=4)
    check_window_attention_core(window_attention_core, report)
    train_launches = train(args, kernels, card, result, 'train_swin')[0]
    train_card_vs_cpu(result)
    check_finisher2x(finisher2x, report, _build)
    defer2x_launches = serve_exact(
        emsanet_bench_config(defer=True), args.requests, DEFER2X_KERNELS,
        kernels, card, result, 'serving_defer2x', args.profile)[0]
    card_vs_cpu(result, emsanet_bench_config(dtype='float32', defer=True),
                'defer2x_card_vs_cpu', frame_seed=5)
    check_window_attention_qkv(window_attention_qkv, report)
    qkv_launches = serve_exact(
        emsaformer_bench_config(attn_backend='qkv'), args.swin_requests,
        QKV_KERNELS, kernels, card, result, 'serving_qkv', args.profile)[0]
    card_vs_cpu(result, emsaformer_bench_config(dtype='float32',
                                                attn_backend='qkv'),
                'qkv_card_vs_cpu', frame_seed=6)
    train(args, kernels, card, result, 'train_emsanet',
          emsanet_train_config(),
          dict.fromkeys(kernels.KERNELS, EMSANET_TRAIN_LAUNCHES))
    train_card_vs_cpu(result, cfg=emsanet_train_config(TRAIN_CPU_HW,
                                                       'float64'),
                      faults=EMSANET_TRAIN_FAULTS,
                      key='emsanet_train_card_vs_cpu',
                      f32_cfg=emsanet_train_config(TRAIN_CPU_HW, 'float32'))
    evaluate_swin(args, kernels, card, result)
    swin_eval_card_vs_cpu(result)
    t0 = time.perf_counter()
    path_launches = {
        'eval_dataset': evaluate_dataset(args, kernels, card, result)}
    data_s['eval_dataset'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eval_dataset_card_vs_cpu(result)
    data_s['eval_dataset_card_vs_cpu'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_launches['serve_stream'] = serve_stream(args, kernels, card, result)
    data_s['serve_stream'] = time.perf_counter() - t0
    # the seconds the host data path's phases add to the script
    result['data_path_seconds'] = dict(data_s, total=sum(data_s.values()))
    print(json.dumps({'phase': 'data_path_seconds',
                      **result['data_path_seconds']}), flush=True)
    bench_s = bench_sizes(args, kernels, card, result)
    t0 = time.perf_counter()
    path_launches['train_loop'] = train_loop(args, kernels, card, result)
    result['train_loop_seconds'] = time.perf_counter() - t0
    print(json.dumps({'phase': 'train_loop_seconds',
                      'seconds': result['train_loop_seconds']}), flush=True)
    t0 = time.perf_counter()
    path_launches.update(normals(args, kernels, card, result))
    path_launches.update(model_surface(args, kernels, card, result))
    result['surface_seconds'] = time.perf_counter() - t0
    print(json.dumps({'phase': 'surface_seconds',
                      'seconds': result['surface_seconds']}), flush=True)
    t0 = time.perf_counter()
    path_launches.update(eval_outputs(args, kernels, card, result))
    path_launches.update(deferred_fullres(args, kernels, card, result))
    path_launches.update(dve_host(args, kernels, card, result))
    examples_on_card(args, card, result)
    result['outputs_seconds'] = time.perf_counter() - t0
    print(json.dumps({'phase': 'outputs_seconds',
                      'seconds': result['outputs_seconds']}), flush=True)
    t0 = time.perf_counter()
    path_launches.update(pretrained(args, kernels, card, result))
    path_launches.update(pretrained_swin(args, kernels, card, result))
    path_launches.update(train_normals_frames(args, kernels, card, result))
    result['pretrained_seconds'] = time.perf_counter() - t0
    print(json.dumps({'phase': 'pretrained_seconds',
                      'seconds': result['pretrained_seconds'], **{
                          k: result[k]['seconds'] for k in (
                              'pretrained', 'pretrained_swin',
                              'train_normals_frames')}}), flush=True)
    # the seconds the phases at the bench's batch sizes add to the script
    result['bench_size_seconds'] = dict(bench_s, total=sum(bench_s.values()))
    print(json.dumps({'phase': 'bench_size_seconds',
                      **result['bench_size_seconds'],
                      'data_path_seconds': result['data_path_seconds'][
                          'total']}), flush=True)

    # each kernel's launches from the run of its own path (the grouping
    # from the EMSANet serving run)
    launches.update({n: eval_launches[n] for n in EVAL_KERNELS})
    launches.update({n: swin_launches[n] for n in SWIN_KERNELS
                     if n not in launches})
    core = [n for n in TRAIN_KERNELS if n.startswith('window_attention_core')]
    launches.update({n: train_launches[n] for n in core})
    launches['finisher2x'] = defer2x_launches['finisher2x']
    launches['window_attention_qkv'] = qkv_launches['window_attention_qkv']
    names = (*SERVING_KERNELS, *EVAL_KERNELS,
             *(n for n in SWIN_KERNELS if n not in SERVING_KERNELS), *core,
             'finisher2x', 'window_attention_qkv')
    if sorted(names) != sorted(kernels.KERNELS):
        fail(f'the kernels line lists {sorted(names)}, the port has '
             f'{sorted(kernels.KERNELS)}')
    # and the launches each kernel made in the runs of the data paths
    line = {'kernels': [dict(report[n], launches=launches[n], paths={
        p: c[n] for p, c in path_launches.items()}) for n in names]}
    result['kernels'] = line['kernels']
    result['seconds'] = time.perf_counter() - t_start
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'chip_smoke.json'), 'w') as f:
        json.dump(result, f, indent=1)
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
